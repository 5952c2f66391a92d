"""Training loop on one device, the port of the JAX package's
``training/loop.py`` without its mesh:

- checkpoint/restart (atomic, integrity-checked, ``training.checkpoint``);
- preemption: SIGTERM during ``run`` sets a flag, and the next step
  checkpoints and returns;
- a straggler watchdog: an EWMA of the step time flags outliers, through
  an injectable hook;
- deterministic resume of the data stream (step-addressable batches, the
  data state in the checkpoint's ``extra``).
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.optimizer import OptConfig, apply_updates, init_opt_state

__all__ = ["TrainConfig", "make_train_step", "Trainer"]


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: str = "build/ckpt"
    ckpt_every: int = 50
    log_every: int = 10
    keep: int = 3
    straggler_factor: float = 3.0
    seed: int = 0


def make_train_step(
    model_cfg: ModelConfig, opt_cfg: OptConfig, *, microbatches: int = 1
) -> Callable:
    """``train_step(model, opt_state, batch) -> metrics``: one AdamW step
    on ``model``'s parameters and ``opt_state``, in place. The metrics are
    ``loss``, ``nll``, ``lb_loss``, ``grad_norm`` (device scalars) and
    ``lr``. Every parameter gets a gradient: zeros where the loss does not
    reach it.

    ``microbatches = k > 1`` accumulates gradients over k sequential
    slices of the batch's rows, summed in fp32 and divided by k (so are
    the loss and its parts), bounding live activations to one slice. A
    batch whose row count is not a multiple of k raises ``ValueError``,
    as the JAX package's reshape into k slices does.
    The forward, the backward and the update run inside the profiler
    ranges ``train_forward``, ``train_backward`` and ``optimizer``.
    """

    def loss_and_grads(params, model, mb):
        with record_function("train_forward"):
            loss, aux = T.forward_train(model_cfg, model, mb)
        with record_function("train_backward"):
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        # a parameter the loss does not reach (the token table of a model
        # that reads embeddings through an untied head) gets zeros, as
        # under JAX's grad: AdamW still decays it and its moments
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params.values(), grads)]
        return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}, grads

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        if microbatches == 1:
            metrics, g = loss_and_grads(params, model, batch)
            grads = dict(zip(params, g))
        else:
            k = microbatches
            n = len(batch["labels"])
            if n % k:
                raise ValueError(f"a batch of {n} rows does not split into {k} microbatches")
            rows = n // k
            gsum = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()}
            msum = None
            for i in range(k):
                mb = {key: a[i * rows : (i + 1) * rows] for key, a in batch.items()}
                m, g = loss_and_grads(params, model, mb)
                for s, x in zip(gsum.values(), g):
                    s += x.float()
                msum = m if msum is None else {key: msum[key] + m[key] for key in m}
            grads = {n: s / k for n, s in gsum.items()}
            metrics = {key: v / k for key, v in msum.items()}
        with record_function("optimizer"):
            return {**metrics, **apply_updates(opt_cfg, params, grads, opt_state, model_cfg)}

    return train_step


class Trainer:
    """Trains ``model_cfg`` on ``data`` on one device (the card unless
    ``device`` says otherwise): restores the newest checkpoint in
    ``train_cfg.ckpt_dir``, or starts from ``params`` (a state dict, e.g.
    ``bridge.params_from_jax``) when given, else from ``train_cfg.seed``."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        opt_cfg: OptConfig,
        data,
        train_cfg: TrainConfig = TrainConfig(),
        *,
        device: str | torch.device | None = None,
        straggler_hook: Callable[[int, float, float], None] | None = None,
        params: dict[str, torch.Tensor] | None = None,
    ):
        self.model_cfg, self.opt_cfg = model_cfg, opt_cfg
        self.data, self.cfg = data, train_cfg
        self.device = T.resolve_device(device)
        self.step = 0
        self._preempted = False
        self._straggler_hook = straggler_hook
        self.straggler_events = 0
        self._ewma: float | None = None
        self.model = T.init_model(model_cfg, seed=train_cfg.seed, device=self.device, params=params)
        self.params = dict(self.model.named_parameters())
        self.opt = init_opt_state(opt_cfg, self.params)
        self._step_fn = make_train_step(model_cfg, opt_cfg)
        last = ckpt_lib.latest_step(train_cfg.ckpt_dir)
        if last is not None:
            tree, extra = ckpt_lib.restore(train_cfg.ckpt_dir, self.state())
            with torch.no_grad():
                for name, p in self.params.items():
                    p.copy_(tree["params"][name])
                for key, moments in self.opt.items():
                    if key != "step":
                        for name, t in moments.items():
                            t.copy_(tree["opt"][key][name])
            self.opt["step"] = tree["opt"]["step"]
            self.step = int(extra.get("step", last))
            print(f"[trainer] restored step {self.step} from {train_cfg.ckpt_dir}")

    # ------------------------------------------------------------------
    def state(self) -> dict:
        """The checkpointed tree: {"params": ..., "opt": ...}."""
        return {"params": self.params, "opt": self.opt}

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
                batch = {
                    k: torch.as_tensor(v, device=self.device)
                    for k, v in self.data.batch(self.step).items()
                }
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
