"""Host-memory page swap: preempt a running sequence without losing it,
the port of the JAX package's ``serving/swap.py``.

``SwapManager`` moves a victim sequence's KV pages out of the device pool
into host memory, so the scheduler can hand its slot and pages to a
higher-priority request, and restores them bit for bit when the victim
resumes. Three rules keep it cheap and correct with the prefix cache:

- **Shared pages are never copied.** A page mapped into another slot
  (refcount > 1) stays on the device. The manager pins the victim's
  shared prefix (``kv.incref``) so those pages survive until resume, and
  releases the pin once the resumed slot holds its own reference.
- **Indexed pages park.** A victim's private pages that the prefix cache
  still indexes are copied to host and parked (``free_slot``'s ``keep``
  hook), so they stay evictable headroom for the preemptor; if they are
  still there at resume, the engine's radix re-match maps them back in
  and their host copy is dropped.
- **The device-to-host copy is asynchronous.** ``swap_out`` gathers the
  victim's private pages into a staging tensor on the current stream
  (advanced indexing makes a new tensor), copies it into pinned host
  memory with ``non_blocking=True`` and records a CUDA event, then frees
  the slot. The staging gather is what makes it safe to hand the freed
  pages to the next prefill: that prefill is queued after the gather on
  the same stream, and the copy reads the staging tensor, not the pool.
  The engine calls ``finalize`` after the next decode step, which waits
  on the event (by then, at worst a short wait) and drops the staging
  tensor. On the CPU the gathered tensor is the host copy.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.analysis import guards
from repro_torch.analysis.guards import hot_path
from repro_torch.obs import MetricsRegistry
from repro_torch.serving.kv_cache import PagedKVCache

__all__ = ["SwapManager", "SwapRecord", "SwapStats"]


@dataclasses.dataclass
class SwapRecord:
    """Everything needed to restore one swapped-out sequence."""

    # the victim's shared logical-prefix pages, kept live by one pin each
    # until resume (released by ``swap_in``/``discard``)
    pin_pages: list[int]
    # host-copied logical pages [len(pin_pages), n_logical)
    n_host: int
    # per layer group {"k", "v"}: (count, n_host, page, Hk, D) host tensors
    host: list | None
    # the device staging tensors and the copy's event, until ``finalize``
    staging: list | None = None
    event: "torch.cuda.Event | None" = None
    pending: bool = False

    @property
    def n_logical(self) -> int:
        return len(self.pin_pages) + self.n_host


class SwapStats:
    """View over the engine's metrics registry (``repro_torch.obs``), with
    the JAX package's metric names. ``out_s`` and ``in_s``, host wall
    seconds in ``swap_out`` + ``finalize`` and in ``swap_in``, are plain
    floats beside it: the JAX package has no such metric."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry if registry is not None else MetricsRegistry()
        self.registry = reg
        self._swap_outs = reg.counter(
            "repro_swap_outs_total", "sequences swapped out to host"
        )
        self._swap_ins = reg.counter(
            "repro_swap_ins_total", "sequences swapped back in"
        )
        self._out_pages = reg.counter(
            "repro_swap_out_pages_total", "pages copied device->host"
        )
        self._in_pages = reg.counter(
            "repro_swap_in_pages_total", "pages copied host->device"
        )
        self._out_bytes = reg.counter(
            "repro_swap_out_bytes_total", "bytes copied device->host"
        )
        self._in_bytes = reg.counter(
            "repro_swap_in_bytes_total", "bytes copied host->device"
        )
        # shared pages spared the copy
        self._pinned_pages = reg.counter(
            "repro_swap_pinned_pages_total",
            "shared pages pinned in place of a copy",
        )
        self.out_s = 0.0
        self.in_s = 0.0

    swap_outs = property(lambda self: self._swap_outs.value)
    swap_ins = property(lambda self: self._swap_ins.value)
    out_pages = property(lambda self: self._out_pages.value)
    in_pages = property(lambda self: self._in_pages.value)
    out_bytes = property(lambda self: self._out_bytes.value)
    in_bytes = property(lambda self: self._in_bytes.value)
    pinned_pages = property(lambda self: self._pinned_pages.value)

    def record_out(self, pages: int, bytes_: int, pinned: int) -> None:
        self._swap_outs.inc()
        self._out_pages.inc(pages)
        self._out_bytes.inc(bytes_)
        self._pinned_pages.inc(pinned)

    def record_in(self, pages: int, bytes_: int) -> None:
        self._in_pages.inc(pages)
        self._in_bytes.inc(bytes_)

    def record_swap_in(self) -> None:
        self._swap_ins.inc()

    def snapshot(self) -> dict:
        return {
            "swap_outs": self.swap_outs,
            "swap_ins": self.swap_ins,
            "out_pages": self.out_pages,
            "in_pages": self.in_pages,
            "out_bytes": self.out_bytes,
            "in_bytes": self.in_bytes,
            "pinned_pages": self.pinned_pages,
        }


class SwapManager:
    def __init__(
        self,
        kv: PagedKVCache,
        *,
        page_in_tree: Callable[[int], bool] | None = None,
        metrics: MetricsRegistry | None = None,
    ):
        """``page_in_tree``: the prefix cache's membership probe (None when
        the cache is off), used as ``free_slot``'s keep hook; ``metrics``:
        the engine's shared registry (the stats view binds to it)."""
        self.kv = kv
        self.page_in_tree = page_in_tree
        self.stats = SwapStats(metrics)
        # bytes one page occupies across every layer pool
        self.page_bytes = sum(
            buf[:, 0].numel() * buf.element_size()
            for pool in kv.buffers
            for buf in pool.values()
        )

    # ---- out ---------------------------------------------------------
    def swap_out(self, slot: int, *, max_pin: int | None = None) -> SwapRecord:
        """Evacuate ``slot``: pin its shared logical-prefix pages (no
        copy), stage every other owned page for an asynchronous copy to
        host, and free the slot. ``max_pin`` caps how many leading pages
        may be pinned instead of copied (the engine passes the radix match
        cap, ``(plen - 1) // page``, so resume's re-match always covers
        the pinned prefix). Call ``finalize`` after the next decode step."""
        t0 = time.perf_counter()
        kv = self.kv
        owned = kv.owned_pages(slot)
        if not owned:
            raise ValueError(f"slot {slot} owns no pages (nothing to swap)")
        n_pin = 0
        cap = len(owned) if max_pin is None else min(max_pin, len(owned))
        while n_pin < cap and kv.refcount(owned[n_pin]) > 1:
            n_pin += 1
        pin_pages, host_pages = owned[:n_pin], owned[n_pin:]
        record = SwapRecord(pin_pages=pin_pages, n_host=len(host_pages), host=None)
        if host_pages:
            idx = guards.device_put(np.asarray(host_pages, np.int64), kv.device)
            staging = [
                {name: buf[:, idx] for name, buf in pool.items()}
                for pool in kv.buffers
            ]
            if kv.device.type == "cuda":
                record.host = [
                    {
                        name: torch.empty(
                            t.shape, dtype=t.dtype, pin_memory=True
                        ).copy_(t, non_blocking=True)
                        for name, t in pool.items()
                    }
                    for pool in staging
                ]
                record.event = torch.cuda.Event()
                record.event.record()
                record.staging = staging
                record.pending = True
            else:
                record.host = staging
        for p in pin_pages:
            kv.incref(p)  # survives until swap_in/discard releases it
        kv.free_slot(slot, keep=self.page_in_tree)
        self.stats.record_out(
            len(host_pages), len(host_pages) * self.page_bytes, n_pin
        )
        self.stats.out_s += time.perf_counter() - t0
        return record

    @hot_path
    def finalize(self, record: SwapRecord) -> None:
        """Wait for the copy to host and drop the device staging tensors.
        The copy has been running behind the decode step since
        ``swap_out``; the wait is the sanctioned one (``guards.wait``),
        as the JAX package's ``finalize`` lands it with ``device_get``."""
        if not record.pending:
            return
        t0 = time.perf_counter()
        guards.wait(record.event)
        record.staging = None
        record.event = None
        record.pending = False
        self.stats.out_s += time.perf_counter() - t0

    # ---- in ----------------------------------------------------------
    def swap_in(self, record: SwapRecord, slot: int, *, n_resident: int) -> None:
        """Restore a swapped sequence into ``slot``. The engine has mapped
        logical pages [0, n_resident) (the pinned prefix plus whatever the
        radix re-match recovered beyond it) and allocated fresh pages for
        [n_resident, n_logical); this copies the host pages the re-match
        did not cover into those fresh pages and releases the record's
        pins (each pinned page is now held by the slot's own reference).
        The upload from pinned memory is asynchronous; the host block is
        not reused before the copy is done (PyTorch's pinned allocator
        records the copy's stream)."""
        t0 = time.perf_counter()
        kv = self.kv
        n_pin = len(record.pin_pages)
        if n_resident < n_pin:
            raise ValueError(
                f"resume re-match covered {n_resident} pages but "
                f"{n_pin} were pinned; pinned pages stay matchable"
            )
        if kv.pages_owned(slot) < record.n_logical:
            raise ValueError(
                f"slot {slot} owns {kv.pages_owned(slot)} pages; "
                f"restore needs {record.n_logical}"
            )
        if record.n_host:
            self.finalize(record)
            # host row j holds logical page n_pin + j
            rows = [j for j in range(record.n_host) if n_pin + j >= n_resident]
            if rows:
                # the whole record goes up from pinned memory (the rows the
                # re-match covered are dropped on the device)
                dst = guards.device_put(
                    kv.page_table[slot, [n_pin + j for j in rows]].astype(np.int64), kv.device
                )
                sel = guards.device_put(np.asarray(rows, np.int64), kv.device)
                for pool, hpool in zip(kv.buffers, record.host):
                    for name, buf in pool.items():
                        up = hpool[name].to(buf.device, non_blocking=True)
                        buf[:, dst] = up[:, sel]
            self.stats.record_in(len(rows), len(rows) * self.page_bytes)
        for p in record.pin_pages:
            kv.unpin(p)
        record.host = None
        self.stats.record_swap_in()
        self.stats.in_s += time.perf_counter() - t0

    def discard(self, record: SwapRecord) -> None:
        """Abandon a swapped sequence: release the pins and drop the host
        copy."""
        self.finalize(record)
        for p in record.pin_pages:
            self.kv.unpin(p)
        record.pin_pages = []
        record.host = None
