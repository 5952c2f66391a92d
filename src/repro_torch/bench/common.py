"""What the port's benchmarks share: a timer that reads the device's clock
on the card and the host's on the CPU, a device-only trace of one call,
and the card's name and power limit."""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable

import torch

__all__ = ["time_ms", "device_trace", "card_line"]


def time_ms(fn: Callable, device: torch.device, *, warmup: int = 2, iters: int = 5) -> float:
    """Median milliseconds of one call of fn after ``warmup`` calls: CUDA
    events around each call on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            ts.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(ts)
    pairs = []
    torch.cuda.synchronize()
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def device_trace(fn: Callable) -> dict:
    """Wall time, device busy time and share, and the top device kernels
    of one call of fn, traced on the device only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
    window = t0.elapsed_time(t1)
    rows = sorted((e for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA),
                  key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in rows) / 1e3
    return {
        "window_ms": window,
        "device_busy_ms": busy if busy else None,
        "device_idle_share": 1.0 - busy / window if busy else None,
        "top": [[e.key[:80], dev_us(e) / 1e3, e.count] for e in rows[:8] if dev_us(e) > 0],
    }


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
