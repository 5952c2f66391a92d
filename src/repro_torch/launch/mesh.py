"""Device meshes of the port, the twin of the JAX package's ``launch/mesh.py``.

A ``Mesh`` names its axes, gives their sizes, and may hold an array of
torch devices, one for each position. One device may stand at several
positions: on a machine with one card, ``make_tp_mesh(4)`` puts all four
shards of a tensor-parallel engine on that card. The port has one
controller: an engine on a ``(1, tp)`` mesh holds ``tp`` shards of the
model and of the KV pools, each on the device of its position, and joins
them with ``distributed.collectives`` (the JAX package runs one GSPMD
program over its mesh). ``distinct_devices`` says how many devices really
hold the mesh, so a run of four shards on one card is never reported as a
run on four cards. A mesh without devices (``make_production_mesh``) is a
descriptor for the sharding rules only.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "MODEL_AXIS",
    "Mesh",
    "make_production_mesh",
    "make_local_mesh",
    "make_tp_mesh",
    "fsdp_axes",
    "batch_axes",
]

MODEL_AXIS = "model"


class Mesh:
    """Axis names, their sizes (``shape``, a name -> size dict as the JAX
    mesh's) and, optionally, a device for each position (``devices``, an
    object array of ``torch.device`` of that shape)."""

    def __init__(self, axis_names, shape, devices=None):
        self.axis_names = tuple(axis_names)
        sizes = tuple(int(n) for n in shape)
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"axes {self.axis_names} and shape {sizes} differ in length")
        self.shape = dict(zip(self.axis_names, sizes))
        self.devices = None
        if devices is not None:
            flat = [torch.device(d) for d in devices]
            if len(flat) != self.size:
                raise ValueError(f"a mesh of shape {sizes} needs {self.size} devices, got {len(flat)}")
            arr = np.empty(len(flat), dtype=object)
            arr[:] = flat
            self.devices = arr.reshape(sizes)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values()), dtype=np.int64))

    @property
    def distinct_devices(self) -> int:
        """How many different devices hold the mesh (0 for a descriptor)."""
        if self.devices is None:
            return 0
        return len({str(d) for d in self.devices.flat})

    def model_devices(self) -> list[torch.device]:
        """The devices along the model axis of a mesh whose other axes have
        size 1: shard r of a tensor-parallel engine lives on entry r."""
        if self.devices is None:
            raise ValueError(f"mesh {self.shape} is a descriptor without devices")
        others = {a: n for a, n in self.shape.items() if a != MODEL_AXIS and n != 1}
        if others:
            raise ValueError(
                f"an engine takes a (1, tp) mesh; axes {others} are not 1 (data parallelism "
                "in serving is replica routing, serving.router)"
            )
        return list(self.devices.reshape(-1))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 positions a pod; 2 pods = 512 with ``multi_pod``. A
    descriptor (no devices): the sharding rules read it, and a launcher
    that needs its devices refuses on a machine that has fewer."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def _cards() -> list[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was asked for (the default) but torch.cuda.is_available() "
            "is False; pass devices=['cpu', ...] to run the plain versions on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_local_mesh(data: int | None = None, model: int = 1, devices=None) -> Mesh:
    """A ``(data, model)`` mesh over ``devices`` (default: every card)."""
    devs = list(devices) if devices is not None else _cards()
    if data is None:
        data = len(devs) // model
    if data * model > len(devs) or data < 1:
        raise ValueError(f"a ({data}, {model}) mesh needs {max(data, 1) * model} devices, have {len(devs)}")
    return Mesh(("data", "model"), (data, model), devs[: data * model])


def make_tp_mesh(tp: int, devices=None) -> Mesh:
    """A ``(1, tp)`` mesh: the serving engine's tensor-parallel mesh over
    the first ``tp`` of ``devices``. ``devices=None`` means the card ``tp``
    times (as ``ReplicaRouter``'s default is the card ``replicas`` times);
    an explicit list shorter than ``tp`` raises, as the JAX function does
    when the machine has too few devices."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if devices is None:
        devs = [_cards()[0]] * tp
    else:
        devs = list(devices)
        if len(devs) < tp:
            raise ValueError(f"tp={tp} needs {tp} devices, have {len(devs)}")
    return Mesh(("data", "model"), (1, tp), devs[:tp])


def fsdp_axes(mesh: Mesh) -> tuple[str, ...]:
    """Axes parameters and optimizer state are additionally sharded over
    (ZeRO-3): the pod axis (if present) plus the data axis."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    return fsdp_axes(mesh)
