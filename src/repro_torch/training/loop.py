"""Training loop, the port of the JAX package's ``training/loop.py``:

- checkpoint/restart (atomic, integrity-checked, ``training.checkpoint``),
  elastic across meshes: a checkpoint holds every tensor whole, by name,
  and a restore cuts it for whatever mesh the new ``Trainer`` has;
- preemption: SIGTERM during ``run`` sets a flag, and the next step
  checkpoints and returns;
- a straggler watchdog: an EWMA of the step time flags outliers, through
  an injectable hook;
- deterministic resume of the data stream (step-addressable batches, the
  data state in the checkpoint's ``extra``).

A ``Trainer`` trains on a mesh (``launch.mesh``) as the JAX ``Trainer``
does under ``Strategy("fsdp")`` or ``Strategy("tp")``, with one
controller; one device is the (1, 1) mesh of that device, the same code.
``MeshState`` holds each parameter and each optimizer moment as its
shards (``sharding.position_slices``), each on the device of its first
mesh position, and a step runs each data replica (a distinct slice of the
batch's rows, ``sharding.batch_specs``) in turn. A replica gathers the
parameters from their shards onto its device (under tp: each model
shard's slice onto that shard's device, ``transformer.build_shards``),
runs the forward and the backward on its rows, and its gradients reach
the shards as a rank-ordered reduce-scatter, summed in fp32
(``collectives.reduce_scatter``; a shard with one contributor, as on one
device, takes its gradient as it is); its gathered copy is freed before
the next replica runs. The masked NLL of a replica's rows is divided by
the global batch's count, so the replicas' losses add up to the
single-device loss; GSPMD does not change what a step computes, and
neither does the mesh here, up to the order of fp32 sums.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import signal
import time
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.analysis import roofline as R
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import MODEL_AXIS, Mesh, make_local_mesh
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.optimizer import OptConfig, apply_updates, init_opt_state

__all__ = ["TrainConfig", "MeshState", "make_train_step", "Trainer"]


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: str = "build/ckpt"
    ckpt_every: int = 50
    log_every: int = 10
    keep: int = 3
    straggler_factor: float = 3.0
    seed: int = 0


class MeshState:
    """A model's parameters laid out on ``mesh`` by ``strategy``'s specs.

    For each parameter: ``keys[name]``, its distinct slices in the order of
    the first position holding each (``sharding.position_slices``);
    ``shards[name]``, one tensor a slice, on that first position's device
    (positions that hold the same slice read it there: one controller);
    ``model_dim[name]``, the dimension the model axis cuts (tp only).
    ``tp`` > 1 runs the tensor-parallel forms, refused where
    ``transformer.check_tp_layout`` refuses them. The shards own their
    memory: the state dict they are cut from is not changed by training.
    ``copy=False`` hands the state dict over: a slice that is a whole
    tensor already on its device is then taken as it is, not copied (a
    one-device trainer's own weights)."""

    def __init__(self, cfg: ModelConfig, mesh: Mesh, strategy: str, state_dict: dict[str, torch.Tensor],
                 *, copy: bool = True):
        if mesh.devices is None:
            raise ValueError(f"mesh {mesh.shape} is a descriptor without devices")
        self.cfg, self.mesh = cfg, mesh
        like = T.skeleton(cfg).state_dict()
        if set(state_dict) != set(like):
            raise ValueError(f"{cfg.name}: state dict keys differ from the model's: missing "
                             f"{sorted(set(like) - set(state_dict))}, unexpected {sorted(set(state_dict) - set(like))}")
        state_dict = {name: t.detach().to(like[name].dtype) for name, t in state_dict.items()}
        self.st = sharding.Strategy(mesh, strategy)
        self.tp = self.st.tp_size
        if self.tp > 1:
            self.specs = T.check_tp_layout(cfg, self.st, state_dict)
        else:
            self.specs = sharding.param_specs(self.st, state_dict)
        self.devices = [torch.device(d) for d in mesh.devices.flat]
        self.coords = sharding.positions(mesh)
        self.shapes = {name: tuple(t.shape) for name, t in state_dict.items()}
        self.keys: dict[str, list] = {}
        self._slots: dict[str, list[int]] = {}
        self.shards: dict[str, list[torch.Tensor]] = {}
        self.model_dim = {name: sharding.model_dim(self.st, spec) if self.tp > 1 else None
                          for name, spec in self.specs.items()}
        for name, t in state_dict.items():
            slices = sharding.position_slices(mesh, self.specs[name], t.shape)
            first = {}
            for p, sl in enumerate(slices):
                first.setdefault(sl, p)
            keys = list(first)
            index = {k: i for i, k in enumerate(keys)}
            self.keys[name] = keys
            self._slots[name] = [index[sl] for sl in slices]
            self.shards[name] = [self._own(sharding.take(t, k), t.shape, self.devices[first[k]], copy) for k in keys]
        self._models: dict = {}

    @staticmethod
    def _own(part: torch.Tensor, shape, device: torch.device, copy: bool) -> torch.Tensor:
        """``part`` (a slice of a tensor of ``shape``) on ``device`` in memory
        of its own: copied, unless ``copy`` is False and ``part`` is the
        whole tensor, on ``device``."""
        moved = part.to(device)
        if moved is not part or (not copy and part.shape == shape):
            return moved
        return part.clone()

    @property
    def n_params(self) -> int:
        """The model's parameter count (whole tensors, each counted once)."""
        return sum(math.prod(shape) for shape in self.shapes.values())

    # ------------------------------------------------------------------
    def cut(self, name: str, full: torch.Tensor) -> list[torch.Tensor]:
        """``full`` (a whole tensor of parameter ``name``'s shape) cut into
        ``name``'s slices, each on its shard's device."""
        return [sharding.take(full, k).to(t.device, copy=True) for k, t in zip(self.keys[name], self.shards[name])]

    def unshard(self, values: dict[str, list[torch.Tensor]], device: str | torch.device = "cpu") -> dict:
        """Whole tensors on ``device`` from one list of slices a parameter
        (the shards, or moments laid out as them): copies, which training
        does not change."""
        per_position = [{} for _ in self.devices]
        for name, slices in values.items():
            moved = [t.detach().to(device, copy=True) for t in slices]
            index = {k: i for i, k in enumerate(self.keys[name])}
            sls = sharding.position_slices(self.mesh, self.specs[name], self.shapes[name])
            for p, sl in enumerate(sls):
                per_position[p][name] = moved[index[sl]]
        return sharding.unshard_state_dict(self.st, per_position, self.specs)

    def state_dict(self, device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
        return self.unshard(self.shards, device)

    def _region(self, name: str, m: int | None) -> tuple[tuple[int, int], ...]:
        """What a replica computes with: the whole tensor, or model shard
        ``m``'s slice along the model axis."""
        region = [(0, n) for n in self.shapes[name]]
        d = self.model_dim[name]
        if m is not None and d is not None:
            n = self.shapes[name][d] // self.tp
            region[d] = (m * n, (m + 1) * n)
        return tuple(region)

    def _parts(self, name: str, m: int | None) -> tuple[list[int], int | None]:
        """The slices inside ``_region(name, m)``, in order along the one
        dimension that tells them apart (None when there is one slice)."""
        region = self._region(name, m)
        inside = [i for i, k in enumerate(self.keys[name])
                  if all(a >= lo and b <= hi for (a, b), (lo, hi) in zip(k, region))]
        if len(inside) == 1:
            return inside, None
        dims = [d for d in range(len(region)) if len({self.keys[name][i][d] for i in inside}) > 1]
        if len(dims) != 1:
            raise ValueError(f"{name}: slices {[self.keys[name][i] for i in inside]} differ in dims {dims}")
        return sorted(inside, key=lambda i: self.keys[name][i][dims[0]]), dims[0]

    def gather(self, name: str, m: int | None, device: torch.device) -> torch.Tensor:
        """``_region(name, m)`` on ``device``, from its shards (an all-gather
        over the data axes, counted as one with the region's bytes; the
        shard itself where it is the whole region on that device)."""
        idx, d = self._parts(name, m)

        def run():
            parts = [self.shards[name][i].to(device) for i in idx]
            return parts[0] if d is None else torch.cat(parts, dim=d)

        nbytes = math.prod(b - a for a, b in self._region(name, m)) * self.shards[name][0].element_size()
        return R.collective("all-gather" if d is not None else None, nbytes, run)

    def accumulate(self, acc: dict, name: str, m: int | None, grad: torch.Tensor, replicas: int = 1,
                   keep: set[int] | None = None) -> None:
        """Add the gradient of ``_region(name, m)`` to the gradients of the
        shards it covers (``acc[name]``, one entry a slice, None until a
        first term; fp32 from a second term on): the reduce-scatter over
        the data axes, and under tp the sum over model shards of a tensor
        they all hold. ``replicas``: how many data replicas add into the
        slices; where more than one position does, this position's part
        is counted as a collective of the gradient's bytes (an all-reduce
        where the region is one slice). ``keep``: the slices to add into
        (the others are other positions' part of the reduce-scatter; all
        by default)."""
        idx, d = self._parts(name, m)
        sizes = [1] if d is None else [self.keys[name][i][d][1] - self.keys[name][i][d][0] for i in idx]
        adders = replicas * (self.tp if m is not None and self.model_dim[name] is None else 1)
        kind = None if adders == 1 else "reduce-scatter" if d is not None else "all-reduce"
        nbytes = math.prod(b - a for a, b in self._region(name, m)) * grad.element_size()
        starts = list(itertools.accumulate([0] + sizes[:-1]))
        sel = [j for j, i in enumerate(idx) if keep is None or i in keep]

        def run():
            if keep is None:
                return C.reduce_scatter([grad], d, sizes, [self.shards[name][i].device for i in idx],
                                        out=[acc[name][i] for i in idx])
            return [C.reduce_scatter([grad if d is None else grad.narrow(d, starts[j], sizes[j])], None, [1],
                                     [self.shards[name][idx[j]].device], out=[acc[name][idx[j]]])[0] for j in sel]

        for j, t in zip(sel, R.collective(kind, nbytes, run)):
            acc[name][idx[j]] = t

    # ------------------------------------------------------------------
    def replicas(self, n_rows: int) -> list[tuple[tuple[int, int], list[int]]]:
        """The batch's distinct row slices (``sharding.batch_specs``) in rank
        order, each with the positions that compute it: its first
        position, and under tp the positions of each model shard beside
        it."""
        spec = sharding.batch_specs(self.st, {"labels": np.zeros((n_rows, 1), np.int32)})["labels"]
        rows = [sl[0] for sl in sharding.position_slices(self.mesh, spec, (n_rows, 1))]
        out = []
        for p, r in enumerate(rows):
            if r in (x for x, _ in out):
                continue
            if self.tp > 1:
                want = [dict(self.coords[p], **{MODEL_AXIS: m}) for m in range(self.tp)]
                out.append((r, [self.coords.index(c) for c in want]))
            else:
                out.append((r, [p]))
        return out

    def model_for(self, cfg: ModelConfig, replica: int, positions: list[int], *, trainable: bool = True):
        """The replica's model of ``cfg`` (the state's, or its MoE routing
        share) with its gathered parameters as leaves (trainable unless
        ``trainable=False``, the sharded inference entry points'): an
        ``LM``, or a ``ShardedLM`` under tp (built once, its parameters
        reassigned each step), and the (model shard, name, parameter) of
        each leaf."""
        devs = [self.devices[p] for p in positions]
        key = (replica, cfg)
        if self.tp > 1:
            parts = [{name: self.gather(name, m, dev) for name in self.shapes} for m, dev in enumerate(devs)]
            model = self._models.get(key)
            if model is None:
                model = self._models[key] = T.build_shards(cfg, devs, parts, trainable=trainable)
            else:
                for shard, part in zip(model.shards, parts):
                    T.assign(shard, part, trainable=trainable)
            leaves = [(m, name, shard.get_parameter(name)) for m, shard in enumerate(model.shards) for name in parts[m]]
        else:
            tensors = {name: self.gather(name, None, devs[0]) for name in self.shapes}
            model = self._models.get(key)
            if model is None:
                model = self._models[key] = T.skeleton(cfg)
            T.assign(model, tensors, trainable=trainable)
            leaves = [(None, name, model.get_parameter(name)) for name in tensors]
        return model, leaves

    def slots(self, position: int) -> dict[str, int]:
        """Which of each parameter's slices mesh position ``position``
        holds (an index into ``keys[name]`` and ``shards[name]``)."""
        return {name: self._slots[name][position] for name in self.keys}

    def replica_of(self, position: int, n_rows: int) -> int:
        """The index (in ``replicas(n_rows)``) of the replica that mesh
        position ``position`` computes."""
        spec = sharding.batch_specs(self.st, {"labels": np.zeros((n_rows, 1), np.int32)})["labels"]
        rows = sharding.position_slices(self.mesh, spec, (n_rows, 1))[position][0]
        return [r for r, _ in self.replicas(n_rows)].index(rows)

    @R.uncounted
    def release(self, cfg: ModelConfig, replica: int) -> None:
        """Drop the replica's gathered copy (its parameters back on meta,
        placeholders a counted step does not count)."""
        model = self._models[(replica, cfg)]
        for shard in model.shards if self.tp > 1 else [model]:
            T.assign(shard, {n: torch.empty(p.shape, device="meta") for n, p in shard.named_parameters()})


def _global_count(labels: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The global batch's count of ``labels >= 0``: each replica's count,
    summed in rank order on ``device`` (at least 1)."""
    return C.reduce_scalars([(lab >= 0).sum() for lab in labels], "sum", device).clamp(min=1).float()


def _rows(batch: dict, r: tuple[int, int], device: torch.device) -> dict:
    """Rows [r[0], r[1]) of every batch leaf (numpy or tensors) on ``device``."""
    return {k: torch.as_tensor(v)[r[0] : r[1]].to(device) for k, v in batch.items()}


def _loss_and_grads(model_cfg: ModelConfig, state: MeshState, batch: dict, acc: dict,
                    only: int | None = None) -> dict:
    """One global batch on ``state``'s mesh: every replica's forward and
    backward in turn, the gradients added into ``acc`` (fp32, one entry a
    shard). Returns the step's loss, nll and lb_loss on the first
    position's device. ``only=i`` runs replica i alone, the program of its
    positions that the dry-run counts (``launch.dryrun``): its gradients'
    reduce-scatters are still counted as the whole mesh's, and the loss is
    its rows' share."""
    n_rows = len(batch["labels"])
    reps = state.replicas(n_rows)
    n_reps = len(reps)
    if only is not None:
        reps = [reps[only]]
    first = state.devices[reps[0][1][0]]
    cfg = model_cfg
    if cfg.moe_num_experts:
        s = batch["labels"].shape[1]
        groups = moe.routing_groups(cfg, n_rows * s)
        if groups % n_reps:
            raise ValueError(
                f"{cfg.name}: {groups} MoE routing group(s) of the global batch do not split over "
                f"{n_reps} data replicas, so a replica cannot route its share of them; "
                f"{sharding.REFUSED['experts']}"
            )
        cfg = cfg.replace(moe_routing_groups=groups // n_reps)
    parts = [_rows(batch, r, state.devices[ps[0]]) for r, ps in reps]
    if only is not None:  # the slices the replica's positions hold: their part of each reduce-scatter
        keep = {name: {state.slots(p)[name] for p in reps[0][1]} for name in state.keys}
    count = _global_count([p["labels"] for p in parts], first)
    losses, nlls, lbs = [], [], []
    for i, ((r, ps), part) in enumerate(zip(reps, parts)):
        model, leaves = state.model_for(cfg, i, ps)
        with record_function("train_forward"):
            _, aux = T.forward_train(cfg, model, part, count=count.to(state.devices[ps[0]]))
            loss = aux["nll"] + 0.01 * (aux["lb_loss"] / n_reps)
        with record_function("train_backward"):
            grads = torch.autograd.grad(loss, [p for _, _, p in leaves], allow_unused=True)
        for (m, name, _), g in zip(leaves, grads):
            if g is not None:
                state.accumulate(acc, name, m, g, n_reps, None if only is None else keep[name])
        losses.append(loss.detach())
        nlls.append(aux["nll"].detach())
        lbs.append(aux["lb_loss"].detach())
        del model, leaves, grads
        state.release(cfg, i)
    return {"loss": C.reduce_scalars(losses, "sum", first), "nll": C.reduce_scalars(nlls, "sum", first),
            "lb_loss": C.reduce_scalars(lbs, "sum", first) / n_reps}


def make_train_step(
    model_cfg: ModelConfig, opt_cfg: OptConfig, *, microbatches: int = 1
) -> Callable:
    """``train_step(state, opt_state, batch) -> metrics``: one AdamW step
    on the shards of ``state`` (a ``MeshState``; one device is a (1, 1)
    mesh) and on ``opt_state`` (``init_opt_state(opt_cfg, state.shards)``),
    in place; ``batch`` is numpy or tensors, cut into each replica's rows
    (module docstring). The metrics are ``loss``, ``nll``, ``lb_loss``,
    ``grad_norm`` (device scalars) and ``lr``. Every parameter gets a
    gradient: zeros where the loss does not reach it.

    ``train_step(..., replica=i)`` runs the program of replica i's
    positions alone, which the dry-run counts (``launch.dryrun``): its
    forward and backward, and one ``apply_updates`` over the slices each
    of its positions holds, a replicated slice once a position as on a
    mesh of devices. It is a count, not a step: the state after it is not
    a training step's.

    ``microbatches = k > 1`` accumulates gradients over k sequential
    slices of the batch's rows, summed in fp32 and divided by k (so are
    the loss and its parts), bounding live activations to one slice. A
    batch whose row count is not a multiple of k raises ``ValueError``,
    as the JAX package's reshape into k slices does.
    The forward, the backward and the update run inside the profiler
    ranges ``train_forward``, ``train_backward`` and ``optimizer``.
    """

    def slices(batch):
        k = microbatches
        n = len(batch["labels"])
        if n % k:
            raise ValueError(f"a batch of {n} rows does not split into {k} microbatches")
        rows = n // k
        return [{key: a[i * rows : (i + 1) * rows] for key, a in batch.items()} for i in range(k)]

    def train_step(state: MeshState, opt_state, batch, replica: int | None = None):
        acc = {name: [None] * len(keys) for name, keys in state.keys.items()}
        msum = None
        mbs = slices(batch)
        for mb in mbs:
            m = _loss_and_grads(model_cfg, state, mb, acc, only=replica)
            msum = m if msum is None else {key: msum[key] + m[key] for key in m}
        k = microbatches
        metrics = {key: v / k for key, v in msum.items()}
        params, opt = state.shards, opt_state
        if replica is not None:  # the slices of each of the replica's positions
            slots = [state.slots(p) for p in state.replicas(len(mbs[0]["labels"]))[replica][1]]

            def held(tree):
                return {name: [tree[name][slot[name]] for slot in slots] for name in tree}

            params, acc = held(params), held(acc)
            opt = {key: v if key == "step" else held(v) for key, v in opt_state.items()}
        # a parameter the loss does not reach (the token table of a model
        # that reads embeddings through an untied head) gets zeros, as
        # under JAX's grad: AdamW still decays it and its moments
        grads = {name: [torch.zeros(t.shape, dtype=torch.float32, device=t.device) if g is None
                        else g / k if k > 1 else g for g, t in zip(acc[name], params[name])]
                 for name in acc}
        with record_function("optimizer"):
            return {**metrics, **apply_updates(opt_cfg, params, grads, opt, model_cfg)}

    return train_step


class Trainer:
    """Trains ``model_cfg`` on ``data``: restores the newest checkpoint in
    ``train_cfg.ckpt_dir``, or starts from ``params`` (a state dict, e.g.
    ``bridge.params_from_jax``) when given, else from ``train_cfg.seed``.

    It trains on ``mesh`` (``launch.mesh.make_local_mesh``; its devices
    name where the shards go, so ``device`` must then be None) as the JAX
    ``Trainer`` does on that mesh under ``strategy`` ("fsdp", its default,
    or "tp"). ``mesh=None`` is the (1, 1) mesh of ``device`` (the card
    unless it says otherwise). ``model`` is the ``MeshState``, ``params``
    its shards by name (a list a parameter), and the optimizer moments are
    laid out as they are. A checkpoint holds the whole tensors, so it
    resumes on one device or on any mesh."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        opt_cfg: OptConfig,
        data,
        train_cfg: TrainConfig = TrainConfig(),
        *,
        device: str | torch.device | None = None,
        mesh: Mesh | None = None,
        strategy: str = "fsdp",
        straggler_hook: Callable[[int, float, float], None] | None = None,
        params: dict[str, torch.Tensor] | None = None,
    ):
        if mesh is None:
            mesh = make_local_mesh(devices=[T.resolve_device(device)])
        elif device is not None:
            raise ValueError("a mesh Trainer takes its devices from the mesh; pass device=None")
        if mesh.devices is None:
            raise ValueError(f"mesh {mesh.shape} is a descriptor without devices")
        self.model_cfg, self.opt_cfg = model_cfg, opt_cfg
        self.data, self.cfg = data, train_cfg
        self.mesh = mesh
        self.step = 0
        self._preempted = False
        self._straggler_hook = straggler_hook
        self.straggler_events = 0
        self._ewma: float | None = None
        self._step_fn = make_train_step(model_cfg, opt_cfg)
        last = ckpt_lib.latest_step(train_cfg.ckpt_dir)
        tree = extra = None
        if last is not None:
            tree, extra = ckpt_lib.restore(train_cfg.ckpt_dir, self._template())
            sd = tree["params"]
        elif params is not None:
            sd = params
        else:
            sd = T.init_model(model_cfg, seed=train_cfg.seed, device=mesh.devices.flat[0]).state_dict()
        # the trainer's own weights (drawn or restored) are handed over;
        # a caller's are copied
        self.model = MeshState(model_cfg, mesh, strategy, sd, copy=sd is params)
        del sd
        self.params = self.model.shards
        self.opt = init_opt_state(opt_cfg, self.params)
        if tree is not None:
            for key, moments in self.opt.items():
                if key != "step":
                    for name in moments:
                        moments[name] = self.model.cut(name, tree["opt"][key][name])
            self.opt["step"] = tree["opt"]["step"]
            self.step = int(extra.get("step", last))
            print(f"[trainer] restored step {self.step} from {train_cfg.ckpt_dir}")

    # ------------------------------------------------------------------
    def _template(self) -> dict:
        """The checkpoint's shapes, from a model on the meta device."""
        shapes = T.skeleton(self.model_cfg).state_dict()
        keys = ("mu", "nu") + (("ef",) if self.opt_cfg.compress_grads else ())
        return {"params": shapes, "opt": {"step": 0, **{k: shapes for k in keys}}}

    def state(self) -> dict:
        """The checkpointed tree: {"params": ..., "opt": ...}, every tensor
        whole, unsharded on the host."""
        opt = {k: v if k == "step" else self.model.unshard(v) for k, v in self.opt.items()}
        return {"params": self.model.state_dict(), "opt": opt}

    def _on_preempt(self, signum, frame):
        self._preempted = True

    def checkpoint(self):
        ckpt_lib.save(
            self.cfg.ckpt_dir,
            self.step,
            self.state(),
            extra={"step": self.step, "data": self.data.state()},
            keep=self.cfg.keep,
        )

    def run(self, steps: int | None = None) -> list[dict]:
        """Take ``steps`` steps (default ``train_cfg.steps``). SIGTERM is
        caught only while this runs; the previous handler comes back after."""
        steps = steps if steps is not None else self.cfg.steps
        history = []
        previous = signal.signal(signal.SIGTERM, self._on_preempt)
        try:
            for _ in range(steps):
                if self._preempted:
                    print("[trainer] preemption signal: checkpoint + exit")
                    self.checkpoint()
                    break
                batch = self.data.batch(self.step)
                t0 = time.perf_counter()
                metrics = self._step_fn(self.model, self.opt, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                self._watch(dt)
                self.step += 1
                metrics["step"] = self.step
                metrics["step_time_s"] = dt
                history.append(metrics)
                if self.step % self.cfg.log_every == 0:
                    print(
                        f"[trainer] step {self.step} loss={metrics['loss']:.4f} "
                        f"lr={metrics['lr']:.2e} {dt * 1e3:.0f}ms"
                    )
                if self.step % self.cfg.ckpt_every == 0:
                    self.checkpoint()
        finally:
            signal.signal(signal.SIGTERM, previous)
        return history

    def _watch(self, dt: float):
        """Straggler watchdog: EWMA of step time; flag outliers."""
        if self._ewma is None:
            self._ewma = dt
            return
        if dt > self.cfg.straggler_factor * self._ewma:
            self.straggler_events += 1
            if self._straggler_hook:
                self._straggler_hook(self.step, dt, self._ewma)
            else:
                print(
                    f"[trainer] straggler: step took {dt:.3f}s vs "
                    f"EWMA {self._ewma:.3f}s"
                )
        self._ewma = 0.9 * self._ewma + 0.1 * dt
