"""Block-paged KV cache: page size == the attention block size.

Sizing pages in units of ``cfg.attn_block`` makes the pixelfly sparse
decode schedule a page-id computation: each token reads only the
O(b·log n) pages its schedule visits.

The pools (``buffers``, one ``{"k", "v"}`` per layer group, built by
``transformer.init_paged_cache``) live on the model's device; the page
table, free list and refcounts are host-side numpy/Python, updated between
steps, as in the JAX package's ``serving/kv_cache.py``. Physical page 0 is
the shared trash page: idle slots and unallocated table entries point at
it, and every read masks it by logical position. The port has no prefix
cache yet, so every live page has exactly one owner.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
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
    ):
        """``n_pages=0`` sizes the pool worst-case (every slot full). A
        smaller pool oversubscribes the cache; the engine budgets each
        sequence's lifetime pages at admission so ``alloc_upto`` never runs
        dry mid-decode."""
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
        self.buffers = T.init_paged_cache(
            cfg, self.n_pages, page, device=self.device
        )
        self.page_table = np.zeros((max_slots, self.pages_per_seq), np.int32)
        # device mirror of the page table, uploaded lazily and kept until a
        # table mutation invalidates it
        self._table_dev: torch.Tensor | None = None
        self._free: list[int] = list(range(self.n_pages - 1, 0, -1))
        self._owned: dict[int, list[int]] = {}
        # slot references per physical page; the trash page is never
        # refcounted and never leaves index 0
        self._ref = np.zeros((self.n_pages,), np.int32)

    # ---- allocation --------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_for_len(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page)

    def pages_owned(self, slot: int) -> int:
        return len(self._owned.get(slot, []))

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

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

    def free_slot(self, slot: int) -> None:
        """Drop the slot's references; pages at refcount 0 are free again."""
        for p in self._owned.pop(slot, []):
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
        self.page_table[slot, :] = 0
        self._table_dev = None

    # ---- views -------------------------------------------------------
    def device_table(self) -> torch.Tensor:
        """The full page table on the device, cached across steps until a
        table mutation invalidates it."""
        if self._table_dev is None:
            self._table_dev = torch.from_numpy(self.page_table.copy()).to(self.device)
        return self._table_dev

    def bucket_row(self, slot: int, plen: int, n_pages: int) -> np.ndarray:
        """Prefill page row for a bucket of ``n_pages``: the slot's
        ``pages_for_len(plen)`` pages followed by trash-page zeros, so the
        bucket-padding keys scatter to the trash page."""
        return self.suffix_row(slot, 0, plen, n_pages)

    def suffix_row(
        self, slot: int, n_prefix_pages: int, plen: int, n_pages: int
    ) -> np.ndarray:
        """Prefill page row for the part of a prompt after its first
        ``n_prefix_pages`` pages: the slot's logical pages
        [n_prefix_pages, pages_for_len(plen)) followed by trash zeros."""
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
            for pool in self.buffers
            for b in pool.values()
        )
