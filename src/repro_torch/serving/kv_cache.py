"""Block-paged KV cache: page size == the attention block size.

Sizing pages in units of ``cfg.attn_block`` makes the pixelfly sparse
decode schedule a page-id computation: each token reads only the
O(b·log n) pages its schedule visits.

The pools (``buffers``, one ``{"k", "v"}`` per layer group, built by
``transformer.init_paged_cache``) live on the model's device; the page
table, free list and refcounts are host-side numpy/Python, updated between
steps, as in the JAX package's ``serving/kv_cache.py``. On a ``(1, tp)``
mesh (``mesh=``) ``buffers`` holds one such list a shard, each pool
``(count, n_pages, page, Hk / tp, D)`` on its shard's device, as
``distributed.sharding.cache_specs(layout="paged")`` lays the pool out:
the page axes stay whole on every shard, so the one host page table
addresses every shard's pool, and a page copy (copy on write, swap) acts
on every shard (``pools``). Physical page 0 is
the shared trash page: idle slots and unallocated table entries point at
it, and every read masks it by logical position.

Pages are refcounted so the prefix cache (``serving.prefix``) can map one
physical page into several slots' tables; every paged read goes through
the page table, so sharing costs nothing at read time. Every page is in
exactly one of three states:

  free    on ``_free`` (refcount 0), allocatable;
  live    refcount >= 1, mapped into that many slots (or transiently
          pinned by an admission plan, see ``incref``/``unpin``);
  parked  refcount 0 but kept in ``_cached``: its content is still
          indexed by the prefix cache, reusable by a future hit and
          evictable back to the free list at any time
          (``release_cached``).

A slot never writes into a page it does not own alone: ``cow_page`` gives
it a fresh page holding an in-place device copy of the shared one.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.analysis import guards
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.models import transformer as T

__all__ = ["PagedKVCache"]


class PagedKVCache:
    def __init__(
        self,
        cfg: ModelConfig,
        max_slots: int,
        max_len: int,
        *,
        n_pages: int = 0,
        device: str | torch.device | None = None,
        mesh=None,
    ):
        """``n_pages=0`` sizes the pool worst-case (every slot full). A
        smaller pool oversubscribes the cache; the engine budgets each
        sequence's lifetime pages at admission so ``alloc_upto`` never runs
        dry mid-decode. ``mesh``: a ``(1, tp)`` mesh with tp > 1, one pool
        a shard (module docstring); ``device`` is then its first device."""
        page = cfg.attn_block
        if max_len % page:
            raise ValueError(
                f"max_len {max_len} must be a multiple of the page size "
                f"(attn_block={page})"
            )
        self.cfg = cfg
        self.page = page
        self.max_slots = max_slots
        self.pages_per_seq = max_len // page
        self.max_len = max_len
        worst = max_slots * self.pages_per_seq + 1  # +1: the trash page
        self.n_pages = n_pages or worst
        if not self.pages_per_seq + 1 <= self.n_pages <= worst:
            raise ValueError(
                f"n_pages {self.n_pages} must be in "
                f"[{self.pages_per_seq + 1}, {worst}] (one full slot + "
                "trash .. every slot full + trash)"
            )
        self.device = T.resolve_device(device)
        self.mesh = mesh
        if mesh is None:
            self.buffers = T.init_paged_cache(cfg, self.n_pages, page, device=self.device)
        else:
            self.buffers = _shard_pools(cfg, mesh, self.n_pages, page)
        self.page_table = np.zeros((max_slots, self.pages_per_seq), np.int32)
        # device mirror of the page table, uploaded lazily and kept until a
        # table mutation invalidates it
        self._table_dev: torch.Tensor | None = None
        self._free: list[int] = list(range(self.n_pages - 1, 0, -1))
        self._owned: dict[int, list[int]] = {}
        # slot references per physical page; the trash page is never
        # refcounted and never leaves index 0
        self._ref = np.zeros((self.n_pages,), np.int32)
        # parked pages: refcount 0, content still indexed by the prefix
        # cache; out of the free list but reclaimable at any time
        self._cached: set[int] = set()

    # ---- allocation --------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def cached_pages(self) -> int:
        """Parked (refcount-0, prefix-cache-indexed) pages."""
        return len(self._cached)

    def pages_for_len(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page)

    def pages_owned(self, slot: int) -> int:
        return len(self._owned.get(slot, []))

    def owned_pages(self, slot: int) -> list[int]:
        """The slot's physical pages in logical order (a copy: the swap
        manager snapshots it before freeing the slot)."""
        return list(self._owned.get(slot, []))

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def is_cached(self, page: int) -> bool:
        return page in self._cached

    def alloc_upto(self, slot: int, pos: int) -> None:
        """Ensure logical pages [0, pos // page] of ``slot`` are backed.

        Atomic: on pool exhaustion every page this call allocated is
        rolled back before raising."""
        need = pos // self.page + 1
        if need > self.pages_per_seq:
            raise ValueError(
                f"position {pos} exceeds slot capacity {self.max_len}"
            )
        owned = self._owned.setdefault(slot, [])
        if len(owned) < need:
            self._table_dev = None
        added: list[int] = []
        while len(owned) < need:
            if not self._free:
                for p in reversed(added):
                    owned.pop()
                    self.page_table[slot, len(owned)] = 0
                    self._ref[p] = 0
                    self._free.append(p)
                if not owned:
                    del self._owned[slot]
                raise RuntimeError("KV cache out of pages")
            p = self._free.pop()
            self._ref[p] = 1
            self.page_table[slot, len(owned)] = p
            owned.append(p)
            added.append(p)

    def _drop_ref(self, page: int, keep: Callable[[int], bool] | None) -> None:
        """One reference less; at refcount 0 the page is parked if
        ``keep(page)`` claims it, else freed."""
        self._ref[page] -= 1
        if self._ref[page] == 0:
            if keep is not None and keep(page):
                self._cached.add(page)
            else:
                self._free.append(page)

    def free_slot(
        self, slot: int, *, keep: Callable[[int], bool] | None = None
    ) -> None:
        """Drop the slot's references. A page whose refcount hits zero
        returns to the free list, unless ``keep(page)`` claims it: then it
        is parked (kept on the device for the prefix cache, reclaimable
        by ``release_cached``)."""
        for p in self._owned.pop(slot, []):
            self._drop_ref(p, keep)
        self.page_table[slot, :] = 0
        self._table_dev = None

    # ---- sharing (prefix cache) --------------------------------------
    def incref(self, page: int) -> None:
        """Pin a live page (one more reference, no slot mapping yet)."""
        if page == 0 or self._ref[page] < 1:
            raise ValueError(f"page {page} is not live (cannot incref)")
        self._ref[page] += 1

    def take_cached(self, page: int) -> None:
        """Pin a parked page: refcount 0 -> 1, out of the parked set. The
        caller must ``adopt`` it into a slot or ``unpin`` it."""
        self._cached.remove(page)
        self._ref[page] = 1

    def unpin(self, page: int) -> None:
        """Drop a pin taken by ``incref``/``take_cached`` without a slot
        mapping (an abandoned admission plan). A pin dropping to refcount
        0 parks the page again: pins only come from indexed pages."""
        if self._ref[page] < 1:
            raise ValueError(f"page {page} has no reference to unpin")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._cached.add(page)

    def adopt(self, slot: int, pages: list[int]) -> None:
        """Map already-pinned pages as the slot's first logical pages.
        Refcounts are unchanged: each pin becomes the slot's reference.
        Must run before any ``alloc_upto`` on the slot."""
        owned = self._owned.setdefault(slot, [])
        if owned:
            raise ValueError(f"slot {slot} already owns pages")
        for i, p in enumerate(pages):
            self.page_table[slot, i] = p
            owned.append(int(p))
        self._table_dev = None

    def release_cached(self, page: int) -> None:
        """Evict a parked page back to the free list (the prefix cache's
        LRU eviction; its index entry goes too)."""
        self._cached.remove(page)
        self._free.append(page)

    def cow_page(
        self,
        slot: int,
        logical: int,
        *,
        keep: Callable[[int], bool] | None = None,
    ) -> int:
        """Copy-on-write: give ``slot`` a private copy of its logical page
        ``logical``, a fresh page that receives an in-place device copy of
        the shared page in every layer's k and v pool, and drop the slot's
        reference on the shared one (``keep`` as in ``free_slot``).
        Returns the new physical page."""
        owned = self._owned[slot]
        src = owned[logical]
        if not self._free:
            raise RuntimeError("KV cache out of pages")
        dst = self._free.pop()
        self._ref[dst] = 1
        for pool in self.pools():
            for buf in pool.values():
                buf[:, dst].copy_(buf[:, src])
        self._drop_ref(src, keep)
        owned[logical] = dst
        self.page_table[slot, logical] = dst
        self._table_dev = None
        return dst

    # ---- views -------------------------------------------------------
    def pools(self) -> list[dict[str, torch.Tensor]]:
        """Every ``{"k", "v"}`` pool, of every layer group and (on a mesh)
        every shard, in a fixed order."""
        if self.mesh is None:
            return list(self.buffers)
        return [pool for shard in self.buffers for pool in shard]

    def device_table(self) -> torch.Tensor:
        """The full page table on the device, cached across steps until a
        table mutation invalidates it."""
        if self._table_dev is None:
            self._table_dev = guards.device_put(self.page_table.copy(), self.device)
        return self._table_dev

    def table_row(self, slot: int, n_pages: int) -> np.ndarray:
        return self.page_table[slot, :n_pages].copy()

    def bucket_row(self, slot: int, plen: int, n_pages: int) -> np.ndarray:
        """Prefill page row for a bucket of ``n_pages``: the slot's
        ``pages_for_len(plen)`` pages followed by trash-page zeros, so the
        bucket-padding keys scatter to the trash page."""
        return self.suffix_row(slot, 0, plen, n_pages)

    def suffix_row(
        self, slot: int, n_prefix_pages: int, plen: int, n_pages: int
    ) -> np.ndarray:
        """Prefill page row for the part of a prompt after its first
        ``n_prefix_pages`` pages (the uncached suffix of a prefix hit,
        page-aligned because hits cover whole pages): the slot's logical
        pages [n_prefix_pages, pages_for_len(plen)) followed by trash
        zeros, so suffix token i scatters into entry i // page."""
        need = self.pages_for_len(plen) - n_prefix_pages
        if need > n_pages:
            raise ValueError(
                f"prompt needs {need} pages, bucket has {n_pages}"
            )
        row = np.zeros(n_pages, np.int32)
        row[:need] = self.page_table[
            slot, n_prefix_pages : n_prefix_pages + need
        ]
        return row

    def memory_bytes(self) -> int:
        return sum(
            b.numel() * b.element_size()
            for pool in self.pools()
            for b in pool.values()
        )


def _shard_pools(cfg: ModelConfig, mesh, n_pages: int, page: int) -> list[list[dict[str, torch.Tensor]]]:
    """One list of zero pools a shard of ``mesh``: the full pools' shapes
    (``init_paged_cache`` on the meta device) with the dimension that
    ``cache_specs(layout="paged")`` puts on the model axis divided by tp,
    on each shard's device: the kv heads, or ``head_dim`` where the mesh
    does not divide the kv heads (each shard then holds every page's slice
    of each head, and copy on write and swap move those slices). What
    ``sharding.check_tp`` refuses in serving is refused first."""
    st = sharding.Strategy(mesh, "tp")
    sharding.check_tp(cfg, st.tp_size)
    full = T.init_paged_cache(cfg, n_pages, page, device="meta")
    specs = sharding.cache_specs(st, full, layout="paged")
    out = []
    for dev in mesh.model_devices():
        shard = []
        for pool, spec in zip(full, specs):
            bufs = {}
            for name, t in pool.items():
                shape = list(t.shape)
                d = sharding.model_dim(st, spec[name])
                if d is not None:
                    shape[d] //= st.tp_size
                bufs[name] = torch.zeros(shape, dtype=t.dtype, device=dev)
            shard.append(bufs)
        out.append(shard)
    return out
