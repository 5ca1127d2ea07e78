"""Paged KV-cache bookkeeping: block allocator, page plans, radix reuse
(a copy of the JAX package's ``models/paging.py``; pure Python, no
tensors).

The paged layout replaces the engine's dense per-sequence KV ring with a
fixed arena of ``n_pages`` blocks of ``page_size`` token slots each, plus
one extra *trash* page (physical index ``n_pages``) that absorbs zombie
writes from finished/released rows.  Every pool row owns a page table of
``max_blocks + 1`` physical page ids: entry ``b`` maps logical token
positions ``[b * page_size, (b+1) * page_size)``; the trailing entry is
always the trash page, so a cursor clamped past the row's last block
lands there by construction (see ``gqa_decode_paged``).

Everything in this module is HOST-side bookkeeping, driven by the
engine's single worker thread (no locks, mirroring ``SlotPool`` /
``GroupLedger``):

  * ``PagePool`` -- free-list allocator over the arena with per-page
    refcounts.  Pages are shared (prefix reuse), so free is ``decref``;
    a page returns to the free list only at refcount zero.
  * ``RadixCache`` -- a radix (block-granular trie) over prompt token
    prefixes: a full ``page_size``-token block maps to the physical page
    holding its KVs.  Matching a prefix yields pages that can be mapped
    straight into a new row's table instead of re-prefilled; nodes are
    LRU-evicted (leaves first) when the allocator runs dry.
  * ``plan_admission`` -- the all-or-nothing page plan for one row:
    radix match capped to leave >= 1 prompt token to recompute (the
    admission needs last-token logits), fresh pages for the remainder,
    eviction under pressure, and ``None`` -- clean backpressure, never a
    crash -- when the arena cannot hold the row.

Device-side counterparts (arena init, page-table scatter and decode,
suffix prefill into pages) live in ``models/serve.py``,
``models/attention.py``, ``rl/rollout.py`` and
``kernels/paged_attention.py``.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple


def paged_blocks(total_len: int, page_size: int) -> int:
    """Logical blocks covering positions ``[0, total_len)``."""
    assert page_size > 0, f"page_size must be positive, got {page_size}"
    return -(-total_len // page_size)


def paged_clamp(total_len: int, page_size: int) -> int:
    """Cursor clamp for a paged pool: at ``max_blocks * page_size`` the
    block index ``pos // page_size`` selects the table's trailing trash
    entry, so zombie KV writes can never touch an allocatable page."""
    return paged_blocks(total_len, page_size) * page_size


class PagePool:
    """Free-list allocator over ``n_pages`` refcounted KV blocks.

    The physical arena holds ``n_pages + 1`` entries; index ``n_pages``
    is the trash page and is never allocated.  ``alloc`` hands out a
    page at refcount 1; ``incref``/``decref`` track sharing (radix tree
    residency and per-row holds each count as one ref); a page is only
    reusable once every holder released it -- the no-leak / no-double-
    free invariants the tests pin down.
    """

    def __init__(self, n_pages: int):
        assert n_pages > 0, f"need at least one page, got {n_pages}"
        self.n_pages = n_pages
        self._refs = [0] * n_pages
        self._free = list(range(n_pages - 1, -1, -1))     # pop() -> page 0

    @property
    def trash_page(self) -> int:
        return self.n_pages

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs[page]

    def alloc(self) -> Optional[int]:
        """One free page at refcount 1, or None when the arena is dry."""
        if not self._free:
            return None
        page = self._free.pop()
        assert self._refs[page] == 0, f"page {page} on free list with refs"
        self._refs[page] = 1
        return page

    def alloc_many(self, n: int) -> Optional[List[int]]:
        """All-or-nothing: ``n`` pages or None (no partial grab -- a
        half-admitted row would deadlock the waiting queue)."""
        if n > len(self._free):
            return None
        return [self.alloc() for _ in range(n)]

    def incref(self, page: int) -> None:
        assert self._refs[page] > 0, \
            f"incref on unallocated page {page} (use-after-free)"
        self._refs[page] += 1

    def decref(self, page: int) -> bool:
        """Release one hold; True when the page just became free."""
        assert self._refs[page] > 0, f"double free of page {page}"
        self._refs[page] -= 1
        if self._refs[page] == 0:
            self._free.append(page)
            return True
        return False

    def assert_no_leaks(self) -> None:
        assert self.pages_in_use == 0, \
            f"{self.pages_in_use} pages leaked (refs " \
            f"{[(p, r) for p, r in enumerate(self._refs) if r]})"


class _RadixNode:
    __slots__ = ("key", "page", "children", "parent", "stamp")

    def __init__(self, key, page, parent):
        self.key = key                    # tuple of page_size tokens
        self.page = page                  # physical page holding the KVs
        self.children: Dict[tuple, "_RadixNode"] = {}
        self.parent = parent
        self.stamp = 0                    # LRU clock at last touch


class RadixCache:
    """Block-granular radix tree over prompt token prefixes.

    A node at depth ``d`` caches the KV page for prompt block ``d-1``
    (tokens ``[(d-1) * P, d * P)``) of every prompt sharing that path.
    The tree holds one ref per resident page; each row matching a
    prefix takes its own refs on top, so eviction can never free a page
    a live row still reads.  Eviction is LRU over *leaves* (an interior
    page is a prefix of a cached longer path and must outlive it).
    """

    def __init__(self, pool: PagePool, page_size: int):
        self.pool = pool
        self.page_size = page_size
        self.root = _RadixNode(None, None, None)
        self._clock = 0
        self._nodes = 0

    def __len__(self) -> int:
        return self._nodes

    def _blocks(self, tokens: Sequence[int]):
        P = self.page_size
        n = len(tokens) // P
        return [tuple(tokens[i * P:(i + 1) * P]) for i in range(n)]

    def match(self, tokens: Sequence[int], *,
              max_tokens: Optional[int] = None) -> List[int]:
        """Pages of the longest cached block-aligned prefix of
        ``tokens`` (capped at ``max_tokens``), LRU-touched.  No refs are
        taken -- use ``acquire`` for a row that will read the pages."""
        cap = len(tokens) if max_tokens is None else min(max_tokens,
                                                         len(tokens))
        self._clock += 1
        node, pages = self.root, []
        for key in self._blocks(tokens[:cap]):
            child = node.children.get(key)
            if child is None:
                break
            child.stamp = self._clock
            pages.append(child.page)
            node = child
        return pages

    def acquire(self, tokens: Sequence[int], *,
                max_tokens: Optional[int] = None) -> List[int]:
        """``match`` + one ref per matched page (the row's hold,
        released by ``PagePool.decref`` at harvest)."""
        pages = self.match(tokens, max_tokens=max_tokens)
        for p in pages:
            self.pool.incref(p)
        return pages

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Publish the full blocks of ``tokens`` (their KVs must already
        sit in ``pages``, the row's table) into the tree; existing nodes
        keep their page (first writer wins -- both copies hold identical
        KVs).  Each newly-resident page gains the tree's ref.  Returns
        blocks newly inserted."""
        self._clock += 1
        node, added = self.root, 0
        for b, key in enumerate(self._blocks(tokens)):
            child = node.children.get(key)
            if child is None:
                child = _RadixNode(key, pages[b], node)
                node.children[key] = child
                self.pool.incref(pages[b])
                self._nodes += 1
                added += 1
            child.stamp = self._clock
            node = child
        return added

    def _evictable(self):
        """Leaves whose page only the tree holds, LRU-first."""
        out = []

        def walk(node):
            for child in node.children.values():
                if child.children:
                    walk(child)
                elif self.pool.refcount(child.page) == 1:
                    out.append(child)

        walk(self.root)
        out.sort(key=lambda n: n.stamp)
        return out

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` pages by dropping LRU unreferenced
        leaves (dropping a leaf may expose its parent); returns pages
        actually freed."""
        freed = 0
        while freed < n_pages:
            victims = self._evictable()
            if not victims:
                break
            for node in victims:
                if freed >= n_pages:
                    break
                del node.parent.children[node.key]
                self._nodes -= 1
                if self.pool.decref(node.page):
                    freed += 1
        return freed

    def clear(self) -> None:
        """Drop every cached prefix (engine abort/rebuild)."""

        def walk(node):
            for child in node.children.values():
                walk(child)
                self.pool.decref(child.page)
            node.children.clear()

        walk(self.root)
        self._nodes = 0


class PagePlan(NamedTuple):
    """One row's admission plan: ``table`` maps logical block -> physical
    page for all ``max_blocks`` blocks (no trailing trash entry -- the
    device helper appends it); ``n_cached`` prompt tokens come from the
    radix cache (block-aligned, always < prompt length); the row holds
    one ref on every page in ``table``."""
    table: Tuple[int, ...]
    n_cached: int


def plan_admission(pool: PagePool, radix: Optional[RadixCache],
                   prompt: Sequence[int], max_blocks: int,
                   page_size: int) -> Optional[PagePlan]:
    """All-or-nothing page plan for admitting one row.

    The radix match is capped at ``len(prompt) - 1`` tokens so at least
    one prompt token is always recomputed -- admission must produce the
    last-token logits.  On shortage the radix evicts LRU unreferenced
    prefixes; if the arena still cannot hold the row, every ref taken
    here is rolled back and None is returned: admission backpressure,
    handled by the engine as "try again after a harvest".
    """
    cached = radix.acquire(prompt, max_tokens=len(prompt) - 1) \
        if radix is not None else []
    need = max_blocks - len(cached)
    assert need > 0, "cap leaves at least the last block to recompute"
    if pool.free_count < need and radix is not None:
        radix.evict(need - pool.free_count)
    fresh = pool.alloc_many(need)
    if fresh is None:
        for p in cached:
            pool.decref(p)
        return None
    return PagePlan(table=tuple(cached) + tuple(fresh),
                    n_cached=len(cached) * page_size)


def release_plan(pool: PagePool, plan: PagePlan) -> None:
    """Drop the row's hold on every page of its table (harvest/abort).
    Pages resident in the radix tree survive on the tree's ref."""
    for p in plan.table:
        pool.decref(p)
