"""Prefix cache: a radix tree of page-sized token blocks over the paged
pool, the port of the JAX package's ``serving/prefix.py``.

Pages are sized to ``attn_block`` and every paged read goes through the
page table, so two slots can point at the same physical page for free;
the tree is the matcher and allocator that makes that safe.

- **Keying**: a trie over full token blocks, one node per cache page. A
  node's edge key is the raw bytes of its ``page``-token block, so a path
  from the root spells a prompt prefix in page units and maps it to the
  physical pages that already hold its K/V: one dict hop per page.
- **Lifetime**: the tree holds no references. A node's page is either
  live (mapped into >= 1 slots) or parked (refcount 0, kept in
  ``kv._cached``). ``ensure_free`` evicts least-recently-used parked
  leaves back to the free list whenever the allocator needs pages, so the
  cache never blocks admission. (A parked node's descendants are parked
  too: a live child's slot would hold the whole path, so evicting leaves
  first always makes progress.)
- **Insertion** registers a request's full prompt blocks after its
  prefill's host fetch, never before: two identical prompts admitted in
  one prefill call must not read pages that call is still writing. A
  block already indexed keeps its page; the newcomer's duplicate page
  stays private to its slot and is freed, not parked, when the slot dies.

The matcher caps a hit at ``plen - 1`` tokens, so at least one suffix
token is always prefilled: the last prompt token's logits emit the first
output token.
"""

from __future__ import annotations

import heapq

import numpy as np

from repro_torch.serving.kv_cache import PagedKVCache

__all__ = ["PrefixCache", "PrefixStats"]


class _Node:
    __slots__ = ("page", "parent", "key", "children", "tick")

    def __init__(self, page: int, parent: "_Node | None", key: bytes):
        self.page = page
        self.parent = parent
        self.key = key  # this node's edge key in parent.children
        self.children: dict[bytes, _Node] = {}
        self.tick = 0


class PrefixStats:
    """Tree-side counters (plain ints); the engine's stats hold the
    per-admission hit numbers."""

    def __init__(self):
        self.inserted_pages = 0
        self.evicted_pages = 0

    def snapshot(self) -> dict:
        return {
            "inserted_pages": self.inserted_pages,
            "evicted_pages": self.evicted_pages,
        }


class PrefixCache:
    def __init__(self, kv: PagedKVCache):
        self.kv = kv
        self._root = _Node(page=-1, parent=None, key=b"")
        self._by_page: dict[int, _Node] = {}
        self._tick = 0
        self.stats = PrefixStats()

    # ---- keying ------------------------------------------------------
    def _block_key(self, prompt: np.ndarray, i: int) -> bytes:
        page = self.kv.page
        return np.ascontiguousarray(
            prompt[i * page : (i + 1) * page], dtype=np.int32
        ).tobytes()

    @property
    def nodes(self) -> int:
        return len(self._by_page)

    def page_in_tree(self, page: int) -> bool:
        """The ``keep`` hook for ``kv.free_slot``/``kv.cow_page``: a
        zero-ref page the tree still indexes is parked, not freed."""
        return page in self._by_page

    # ---- matching ----------------------------------------------------
    def match(self, prompt: np.ndarray) -> list[int]:
        """Longest indexed full-block prefix of ``prompt`` -> physical
        pages, LRU-touched. Capped at ``plen - 1`` tokens so at least one
        suffix token remains to prefill."""
        n_full = (len(prompt) - 1) // self.kv.page
        node, pages = self._root, []
        for i in range(n_full):
            child = node.children.get(self._block_key(prompt, i))
            if child is None:
                break
            node = child
            pages.append(child.page)
        self._tick += 1
        while node is not self._root:  # refresh the whole hit path
            node.tick = self._tick
            node = node.parent
        return pages

    # ---- insertion ---------------------------------------------------
    def insert(self, prompt: np.ndarray, pages: np.ndarray) -> int:
        """Index the prompt's full token blocks under their physical
        ``pages`` (the slot's page-table row). Existing nodes keep their
        mapping. Returns the number of newly indexed pages."""
        n_full = len(prompt) // self.kv.page
        self._tick += 1
        node, new = self._root, 0
        for i in range(n_full):
            key = self._block_key(prompt, i)
            child = node.children.get(key)
            if child is None:
                child = _Node(page=int(pages[i]), parent=node, key=key)
                node.children[key] = child
                self._by_page[child.page] = child
                new += 1
            child.tick = self._tick
            node = child
        self.stats.inserted_pages += new
        return new

    # ---- eviction ----------------------------------------------------
    def evictable_pages(self) -> int:
        """Parked pages are reclaimable at any time: the admission budget
        may count them as free."""
        return self.kv.cached_pages

    def ensure_free(self, n: int) -> bool:
        """Evict LRU parked leaves until the free list holds ``n`` pages
        (True) or nothing evictable remains (False). One pass collects the
        parked leaves into a tick-ordered heap; a dropped leaf may turn
        its parent into a parked leaf, which is pushed as it appears."""
        if self.kv.free_pages >= n:
            return True
        heap = [
            (node.tick, page)
            for page in self.kv._cached
            if (node := self._by_page.get(page)) is not None
            and not node.children
        ]
        heapq.heapify(heap)
        while self.kv.free_pages < n:
            if not heap:
                return False
            _, page = heapq.heappop(heap)
            node = self._by_page[page]
            parent = node.parent
            self._drop(node)
            if (
                parent is not self._root
                and not parent.children
                and self.kv.is_cached(parent.page)
            ):
                heapq.heappush(heap, (parent.tick, parent.page))
        return True

    def _drop(self, node: _Node) -> None:
        assert not node.children
        del node.parent.children[node.key]
        del self._by_page[node.page]
        self.kv.release_cached(node.page)
        self.stats.evicted_pages += 1
