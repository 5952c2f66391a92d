"""Runtime guards, the port of the JAX package's ``analysis/guards.py``.

Only ``compile_events_total`` is ported so far. The JAX package counts
XLA backend compiles through a ``jax.monitoring`` listener; eager PyTorch
compiles nothing, and the port's counterpart of a compile is the build or
load of a kernel library (``kernels._build``). After warm-up it reads the
same on every step, the JAX package's invariant; on the CPU, where no
kernel library is built, it stays 0. The dispatch guard and ``hot_path``
wait for ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

from repro_torch.kernels import _build

__all__ = ["compile_events_total"]


def compile_events_total() -> int:
    """Process-lifetime count of kernel-library builds and loads."""
    return _build.events_total()
