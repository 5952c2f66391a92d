"""Runtime dispatch guards for the serving hot path, the port of the JAX
package's ``analysis/guards.py``.

The two invariants that matter for steady-state decode throughput:

  1. **Zero kernel-library builds per decode step after warm-up.** Eager
     PyTorch compiles nothing; the port's counterpart of a backend compile
     is the build (``nvcc``) or load (``ctypes``) of a kernel library
     (``kernels._build.events_total``). One appearing mid-traffic means a
     kernel reached the path only after warm-up.
  2. **Zero *implicit* device->host syncs per decode step.** The one
     sanctioned sync a step is the explicit batched fetch of the
     next-token row through :func:`device_get`; anything else
     (``.item()``, ``int()``/``bool()`` of a tensor, ``np.asarray``, a
     blocking copy) makes the host wait for the card once per call.

:class:`DispatchGuard` enforces both as a context manager:

  * Builds and loads are counted through ``compile_events_total``.
  * Implicit syncs are intercepted by patching the host-conversion entry
    points of ``torch.Tensor`` (``item``, ``tolist``, ``numpy``,
    ``__bool__``, ``__int__``, ``__float__``, ``__index__``,
    ``__array__``) for the life of the context, as the JAX guard patches
    ``ArrayImpl``. On a CPU-only run every tensor is the "device" and
    trips; with the card in use only tensors on the card do (a CPU tensor
    is then host memory, as a numpy array is to the JAX guard).
  * On the card the guard also arms ``torch.cuda.set_sync_debug_mode``,
    which plays the part of JAX's transfer guard: it catches the syncs
    that never reach a ``Tensor`` method (a blocking copy to or from the
    host, ``nonzero``, a boolean mask). With ``raise_on_sync`` the mode is
    "error" and the guard turns the error into :class:`HostSyncError`;
    otherwise it is "warn" and each warning counts as one implicit sync.
  * :func:`device_get` is the sanctioned explicit channel (and
    :func:`wait` the sanctioned wait on an event): it lowers the sync
    debug mode and suspends the patches for its own copy, and counts one
    explicit sync a call. :func:`device_put` is the host->device
    counterpart, an asynchronous copy that never waits on the stream.

Not thread-safe: the patches and the sync debug mode are process-global
while a guard is active. The engine is single-threaded; tests and
benchmarks use one guard at a time.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import sys
import traceback
import warnings
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = [
    "hot_path",
    "is_hot_path",
    "HostSyncError",
    "RecompileError",
    "GuardReport",
    "DispatchGuard",
    "compile_events_total",
    "device_get",
    "device_put",
    "wait",
]

# the messages of ``torch.cuda.set_sync_debug_mode``'s error and warning
_SYNC_MESSAGE = "called a synchronizing CUDA operation"


def hot_path(fn: Callable) -> Callable:
    """Marker decorator: ``fn`` is on the serving hot path. Returns ``fn``
    unchanged with a ``__hot_path__`` attribute: a stray ``.item()`` in it
    is a throughput bug, and :class:`DispatchGuard` is how a test proves
    there is none."""
    fn.__hot_path__ = True
    return fn


def is_hot_path(fn: Callable) -> bool:
    return bool(getattr(fn, "__hot_path__", False))


class HostSyncError(RuntimeError):
    """An implicit device->host sync fired inside a DispatchGuard."""


class RecompileError(RuntimeError):
    """A kernel-library build or load fired inside a DispatchGuard that
    forbids them."""


def compile_events_total() -> int:
    """Process-lifetime count of kernel-library builds and loads."""
    return _build.events_total()


_SYNC_METHODS = (
    "__array__",
    "__bool__",
    "__int__",
    "__float__",
    "__index__",
    "item",
    "tolist",
    "numpy",
)

# the guard in its context, if any (guards are process-global)
_active: "DispatchGuard | None" = None


def _cuda_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def _explicit():
    """Suspend the active guard for a sanctioned sync: the patches pass
    through and the sync debug mode is off."""
    g = _active
    if g is None:
        yield
        return
    was, g._in_explicit = g._in_explicit, True
    mode = torch.cuda.get_sync_debug_mode() if g._armed else None
    if mode:
        torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if mode:
            torch.cuda.set_sync_debug_mode(mode)
        g._in_explicit = was


def _to_host(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def device_get(tree: Any) -> Any:
    """The sanctioned explicit device->host channel: every tensor of
    ``tree`` (a tensor, or a dict, list or tuple of them) as a numpy
    array, in one call that counts as one explicit sync of the active
    guard."""
    if _active is not None:
        _active.explicit_syncs += 1
    with _explicit():
        return _to_host(tree)


def wait(event: "torch.cuda.Event") -> None:
    """The sanctioned wait on a recorded event (a swap-out's copy to
    host), counted as one explicit sync of the active guard."""
    if _active is not None:
        _active.explicit_syncs += 1
    with _explicit():
        event.synchronize()


def device_put(array: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """Host->device copy that never waits on the stream: the host array
    is staged before the call returns (pageable memory) and the copy runs
    behind the work already queued. On the CPU it is ``torch.from_numpy``
    (shared memory, as ``.to("cpu")`` gives)."""
    return torch.from_numpy(np.ascontiguousarray(array)).to(device, non_blocking=True)


@dataclasses.dataclass
class GuardReport:
    steps: int = 0
    compiles: int = 0
    implicit_syncs: int = 0
    explicit_syncs: int = 0


class DispatchGuard:
    """Context manager asserting steady-state dispatch hygiene.

    Inside the context:
      * implicit host syncs raise :class:`HostSyncError` at once (naming
        the entry point), unless ``raise_on_sync`` is False, in which
        case they are only counted;
      * :func:`device_get` and :func:`wait` are allowed and counted as
        explicit syncs;
      * kernel-library builds and loads are counted; if ``max_compiles``
        is not None and the count exceeds it, ``__exit__`` raises
        :class:`RecompileError`.

    ``sites`` counts the implicit syncs by where they came from: the
    Tensor method and the line that called it, or the line of a sync the
    debug mode caught.

    ``transfer_guard`` arms ``torch.cuda.set_sync_debug_mode`` when CUDA
    is in use (it has no effect on a CPU-only run).

    Typical use around a steady-state decode loop::

        with DispatchGuard(max_compiles=0) as g:
            while engine.scheduler.active():
                engine.step()
        assert g.compiles == 0 and g.implicit_syncs == 0
    """

    def __init__(
        self,
        *,
        max_compiles: int | None = 0,
        raise_on_sync: bool = True,
        transfer_guard: bool = True,
        metrics=None,
    ) -> None:
        """``metrics``: optional ``repro_torch.obs.MetricsRegistry``. On
        exit the guarded region's counts land in
        ``repro_guard_compiles_total`` / ``_implicit_syncs_total`` /
        ``_explicit_syncs_total``."""
        self.max_compiles = max_compiles
        self.raise_on_sync = raise_on_sync
        self.transfer_guard = transfer_guard
        self.metrics = metrics
        self.implicit_syncs = 0
        self.explicit_syncs = 0
        # where the implicit syncs came from: "Tensor.item at file:line" or
        # "file:line" of a sync the debug mode caught -> count
        self.sites: collections.Counter = collections.Counter()
        self._compiles_at_enter = 0
        self._compiles_at_exit: int | None = None
        self._saved: dict[str, Any] = {}
        self._on_card = False
        self._armed = False
        self._mode_before = 0
        self._warnings: contextlib.ExitStack | None = None
        self._caught: list | None = None
        self._in_explicit = False

    # -- counters ----------------------------------------------------------

    @property
    def compiles(self) -> int:
        end = self._compiles_at_exit if self._compiles_at_exit is not None else compile_events_total()
        return end - self._compiles_at_enter

    def report(self, steps: int = 0) -> GuardReport:
        return GuardReport(
            steps=steps,
            compiles=self.compiles,
            implicit_syncs=self.implicit_syncs,
            explicit_syncs=self.explicit_syncs,
        )

    # -- interception ------------------------------------------------------

    def _trip(self, name: str) -> None:
        self.implicit_syncs += 1
        caller = sys._getframe(2)  # the code that called the Tensor method
        self.sites[f"Tensor.{name} at {caller.f_code.co_filename}:{caller.f_lineno}"] += 1
        if self.raise_on_sync:
            raise HostSyncError(
                f"implicit device->host sync via Tensor.{name} inside a "
                "DispatchGuard. Hot-path code must batch host reads through "
                "one explicit guards.device_get per step."
            )

    def _make_patch(self, name: str, orig: Callable) -> Callable:
        guard = self

        def patched(tensor_self, *args: Any, **kwargs: Any):
            # with the card in use a CPU tensor is host memory, as a numpy
            # array is to the JAX guard: converting it waits for nothing
            if guard._in_explicit or (guard._on_card and tensor_self.device.type == "cpu"):
                return orig(tensor_self, *args, **kwargs)
            guard._trip(name)
            # counted once: the sync itself must not also count through
            # the sync debug mode
            with _explicit():
                return orig(tensor_self, *args, **kwargs)

        patched.__name__ = name
        return patched

    def __enter__(self) -> "DispatchGuard":
        global _active
        if _active is not None:
            raise RuntimeError("DispatchGuard is not reentrant")
        _active = self
        self._compiles_at_exit = None
        self.implicit_syncs = 0
        self.explicit_syncs = 0
        self.sites = collections.Counter()
        cls = torch.Tensor
        self._saved = {}
        for name in _SYNC_METHODS:
            # own=None: the method lives on the C base class, restored by
            # deleting the override
            self._saved[name] = cls.__dict__.get(name)
            setattr(cls, name, self._make_patch(name, getattr(cls, name)))
        self._on_card = _cuda_in_use()
        self._armed = self.transfer_guard and self._on_card
        if self._armed:
            if not self.raise_on_sync:
                self._warnings = contextlib.ExitStack()
                self._caught = self._warnings.enter_context(warnings.catch_warnings(record=True))
                warnings.simplefilter("always")
            self._mode_before = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error" if self.raise_on_sync else "warn")
        # last: nothing of the guard's own setup counts against the region
        self._compiles_at_enter = compile_events_total()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        global _active
        cls = torch.Tensor
        for name, own in self._saved.items():
            if own is None:
                delattr(cls, name)
            else:
                setattr(cls, name, own)
        self._saved = {}
        if self._armed:
            torch.cuda.set_sync_debug_mode(self._mode_before)
            self._armed = False
        if self._warnings is not None:
            self._warnings.close()
            self._warnings = None
            for w in self._caught:
                if _SYNC_MESSAGE in str(w.message):
                    self.implicit_syncs += 1
                    self.sites[f"{w.filename}:{w.lineno}"] += 1
                else:  # not ours: show it as it would have been
                    warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
            self._caught = None
        # the sync debug mode's error: a sync that reached no Tensor method
        # (a blocking copy, nonzero, a boolean mask)
        mode_error = (
            isinstance(exc, RuntimeError)
            and not isinstance(exc, HostSyncError)
            and _SYNC_MESSAGE in str(exc)
        )
        if mode_error:
            self.implicit_syncs += 1
            where = traceback.extract_tb(tb)[-1]
            self.sites[f"{where.filename}:{where.lineno}"] += 1
        self._compiles_at_exit = compile_events_total()
        _active = None
        if self.metrics is not None:
            self.metrics.counter(
                "repro_guard_compiles_total",
                "Kernel-library builds and loads inside DispatchGuard regions",
            ).inc(self.compiles)
            self.metrics.counter(
                "repro_guard_implicit_syncs_total",
                "Implicit device->host syncs inside DispatchGuard regions",
            ).inc(self.implicit_syncs)
            self.metrics.counter(
                "repro_guard_explicit_syncs_total",
                "Sanctioned guards.device_get calls and waits inside DispatchGuard regions",
            ).inc(self.explicit_syncs)
        if mode_error:
            raise HostSyncError(
                f"implicit device->host sync inside a DispatchGuard ({exc}). Hot-path code "
                "must batch host reads through one explicit guards.device_get per step."
            ) from exc
        if exc_type is not None:
            return False
        if self.max_compiles is not None and self.compiles > self.max_compiles:
            raise RecompileError(
                f"{self.compiles} kernel-library build(s) or load(s) fired inside a "
                f"DispatchGuard (max_compiles={self.max_compiles}). One after warm-up "
                "means a kernel reached the dispatch path only now."
            )
        return False
