"""Paged KV-cache bookkeeping: page pool, radix prefix index, admission plans.

Everything here is host-side and device-free. The device side stores KV in
fixed-size *pages* — one page is ``page_size`` token positions across every
attention cache leaf of the model — and each slot owns a *page table* mapping
its logical pages (position ``p`` lives in logical page ``p // page_size``)
to physical page ids. Three pieces:

- :class:`PagePool` — physical page allocator: LIFO free list plus per-page
  refcounts. Page 0 is reserved as a scratch page (masked/free decode lanes
  scatter there harmlessly) and is never allocated.
- :class:`RadixPrefixIndex` — a radix trie over *full-page token chunks*.
  A node corresponds to one published (full, immutable) page; its key is the
  exact ``page_size``-token chunk that page holds, so walking the trie with a
  prompt yields the longest shared prefix in page units plus, at the first
  divergent page, a token-granular partial match that the engine serves via
  copy-on-write. The index itself holds one reference on every published
  page; unreferenced-elsewhere leaves are evictable LRU.
- :func:`plan_admission` / :func:`publish_prefix` / :func:`release_pages` —
  the admission-time page lifecycle, factored out of the engine so property
  tests drive the exact code the engine runs.

Sharing invariant (checked by ``tests/test_pages.py``): a page is published
only once it is full, and a plan only ever writes into its ``new_pages``
(positions ``>= reuse_len``), so published pages are never written again —
copy-on-write duplicates the divergence page instead.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class PagePool:
    """Fixed-size physical page allocator with refcounts.

    ``num_pages`` counts all pages including the reserved scratch page 0;
    ``capacity`` (= num_pages - 1) pages are allocatable. ``alloc`` hands out
    pages with refcount 1; ``retain``/``release`` adjust refcounts and a page
    returns to the free list exactly when its count hits zero.
    """

    def __init__(self, num_pages: int, page_size: int):
        assert num_pages >= 2 and page_size >= 1
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO free list: low ids first out (page 0 excluded — scratch)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self.refs: List[int] = [1] + [0] * (num_pages - 1)  # refs[0] permanent
        self.peak_used = 0

    @property
    def capacity(self) -> int:
        return self.num_pages - 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        return self.capacity - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages (refcount 1 each); None if insufficient."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for pid in out:
            assert self.refs[pid] == 0
            self.refs[pid] = 1
        self.peak_used = max(self.peak_used, self.used)
        return out

    def retain(self, pid: int) -> None:
        assert 0 < pid < self.num_pages and self.refs[pid] > 0, pid
        self.refs[pid] += 1

    def release(self, pid: int) -> None:
        assert 0 < pid < self.num_pages and self.refs[pid] > 0, pid
        self.refs[pid] -= 1
        if self.refs[pid] == 0:
            self._free.append(pid)

    def check(self) -> None:
        """Structural invariants (test hook): the free list is duplicate-free,
        holds exactly the zero-ref pages, and free + live == capacity."""
        assert len(set(self._free)) == len(self._free), "double-free"
        assert 0 not in self._free, "scratch page leaked into the free list"
        zero_ref = {p for p in range(1, self.num_pages) if self.refs[p] == 0}
        assert set(self._free) == zero_ref, (sorted(self._free), sorted(zero_ref))
        assert all(r >= 0 for r in self.refs)
        assert self.free_count + self.used == self.capacity


@dataclass
class _Node:
    """One published page: ``chunk`` is the exact page_size-token content."""

    chunk: Tuple[int, ...]
    page: int
    parent: Optional["_Node"]
    children: Dict[Tuple[int, ...], "_Node"] = field(default_factory=dict)
    last_used: int = 0


class RadixPrefixIndex:
    """Radix trie mapping token prefixes → published page chains.

    The index holds one pool reference per published page; :meth:`evict`
    drops least-recently-matched *leaf* pages whose only remaining reference
    is the index's own (i.e. no live slot aliases them).
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self._root = _Node(chunk=(), page=0, parent=None)
        self._clock = 0
        self.num_pages = 0  # published pages currently indexed

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, tokens) -> Tuple[List[int], Optional[Tuple[int, int]]]:
        """Longest-prefix lookup over ``tokens``.

        Returns ``(full_pages, partial)``: the page ids whose chunks fully
        match consecutive prompt chunks, and — if the next (possibly short)
        chunk agrees with some child on ``d > 0`` leading tokens — a
        ``(page_id, d)`` partial match for copy-on-write. Matched nodes are
        LRU-touched. No references are taken; the caller retains.
        """
        tokens = [int(t) for t in tokens]
        ps = self.page_size
        now = self._tick()
        node, full = self._root, []
        i = 0
        while i + ps <= len(tokens):
            chunk = tuple(tokens[i : i + ps])
            child = node.children.get(chunk)
            if child is None:
                break
            child.last_used = now
            full.append(child.page)
            node, i = child, i + ps
        # token-granular partial match at the divergence page. The winner is
        # canonical — longest agreement, then lowest page id — NOT the dict
        # iteration (= publish) order: two runs that published equally-deep
        # divergence pages in a different order must still plan identical
        # COW sources, or replayed admissions stop being reproducible.
        rest = tuple(tokens[i:])
        best: Optional[Tuple[int, int]] = None
        best_node: Optional[_Node] = None
        if rest:
            for chunk, child in node.children.items():
                d = 0
                while d < len(rest) and chunk[d] == rest[d]:
                    d += 1
                if d > 0 and (
                    best is None or d > best[1] or (d == best[1] and child.page < best[0])
                ):
                    best = (child.page, d)
                    best_node = child
            if best_node is not None:
                best_node.last_used = now
        return full, best

    def insert(self, tokens, pages: List[int]) -> int:
        """Publish the first ``len(pages)`` full chunks of ``tokens`` with
        their page ids. Existing nodes keep their page (first publisher
        wins); each newly created node retains its page on behalf of the
        index. Returns the number of newly indexed pages."""
        tokens = [int(t) for t in tokens]
        ps = self.page_size
        assert len(tokens) >= len(pages) * ps
        now = self._tick()
        node, added = self._root, 0
        for j, pid in enumerate(pages):
            chunk = tuple(tokens[j * ps : (j + 1) * ps])
            child = node.children.get(chunk)
            if child is None:
                child = _Node(chunk=chunk, page=pid, parent=node, last_used=now)
                node.children[chunk] = child
                self.pool.retain(pid)
                self.num_pages += 1
                added += 1
            else:
                child.last_used = now
            node = child
        return added

    def _leaves(self) -> List[_Node]:
        out, stack = [], list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def evict(self, need: int) -> int:
        """Drop LRU evictable leaves until ``need`` pages were freed (or no
        candidate remains). Evictable = leaf node whose page's only reference
        is the index's own. Returns pages actually freed."""
        freed = 0
        while freed < need:
            candidates = [n for n in self._leaves() if self.pool.refs[n.page] == 1]
            if not candidates:
                break
            victim = min(candidates, key=lambda n: n.last_used)
            del victim.parent.children[victim.chunk]
            self.pool.release(victim.page)
            self.num_pages -= 1
            freed += 1
        return freed


# ---------------------------------------------------------------------------
# admission-time page lifecycle
# ---------------------------------------------------------------------------


@dataclass
class AdmissionPlan:
    """Page assignment for one admitted request.

    ``pages = shared + new_pages`` in logical order. ``reuse_len`` prompt
    positions are served from published KV (``len(shared)`` full pages, plus
    ``reuse_len % page_size`` tokens inside ``new_pages[0]`` after the engine
    copies ``cow_src`` into it). Prefill computes positions
    ``[reuse_len, len(prompt))``; decode then writes from ``len(prompt)`` on —
    all inside ``new_pages``, never inside ``shared``.
    """

    reuse_len: int
    shared: List[int]
    cow_src: Optional[int]
    new_pages: List[int]

    @property
    def pages(self) -> List[int]:
        return self.shared + self.new_pages


def plan_admission(
    pool: PagePool,
    index: Optional[RadixPrefixIndex],
    prompt,
    total_len: int,
    *,
    share: bool = True,
) -> Optional[AdmissionPlan]:
    """Plan pages for a request needing ``total_len`` positions (prompt +
    decode budget). Matches the prompt against ``index`` (when sharing),
    retains the shared pages, allocates the rest (evicting LRU published
    pages on pressure), and returns None — nothing retained/allocated — if
    the pool cannot cover it.

    Reuse is capped at ``len(prompt) - 1``: the last prompt token is always
    recomputed so its logits exist to sample the first output token.

    A shared plan pins its matched pages before evicting, and a pinned page
    (refcount 2: index + pin) is unevictable — so on a small pool the very
    prefix hit that should save work can instead wedge admission: nothing
    else holds pages, yet the plan cannot free any. When that happens the
    planner retries **unshared**, which pins nothing and may evict the whole
    index; admission now fails only if the pool genuinely cannot hold
    ``ceil(total_len / page_size)`` pages after full eviction.
    """
    plan = _plan_once(pool, index, prompt, total_len, share=share)
    if plan is None and share and index is not None:
        plan = _plan_once(pool, index, prompt, total_len, share=False)
    return plan


def _plan_once(
    pool: PagePool,
    index: Optional[RadixPrefixIndex],
    prompt,
    total_len: int,
    *,
    share: bool,
) -> Optional[AdmissionPlan]:
    ps = pool.page_size
    n_logical = -(-total_len // ps)  # ceil
    prompt = [int(t) for t in prompt]
    assert 0 < len(prompt) <= total_len

    shared: List[int] = []
    cow_src: Optional[int] = None
    reuse_len = 0
    if share and index is not None and len(prompt) > 1:
        full, partial = index.match(prompt[: len(prompt) - 1])
        shared = list(full)
        reuse_len = len(shared) * ps
        if partial is not None:
            cow_src, d = partial
            reuse_len += d

    n_new = n_logical - len(shared)
    assert n_new >= 1  # reuse_len < len(prompt) <= total_len forces this
    # pin the matched pages BEFORE any eviction: a shared (or COW-source)
    # page whose only reference is the index's would otherwise be evictable
    # by the very eviction pass run to make room for this plan
    pinned = shared + ([cow_src] if cow_src is not None else [])
    for pid in pinned:
        pool.retain(pid)
    if pool.free_count < n_new:
        if index is not None:
            index.evict(n_new - pool.free_count)
        if pool.free_count < n_new:
            for pid in pinned:
                pool.release(pid)
            return None
    new_pages = pool.alloc(n_new)
    assert new_pages is not None
    if cow_src is not None:
        # the COW source is only read once, synchronously at admission (the
        # engine copies it into new_pages[0] before any further pool op)
        pool.release(cow_src)
    return AdmissionPlan(
        reuse_len=reuse_len, shared=shared, cow_src=cow_src, new_pages=new_pages
    )


def publish_prefix(
    index: Optional[RadixPrefixIndex], prompt, pages: List[int]
) -> int:
    """Publish a finished prefill's *full* prompt pages (the trailing partial
    page stays private: decode keeps writing into it). Returns newly indexed
    page count."""
    if index is None:
        return 0
    n_full = len(prompt) // index.page_size
    return index.insert(prompt, pages[:n_full])


def release_pages(pool: PagePool, pages: List[int]) -> None:
    """Drop one reference per page (request finished). Published pages stay
    alive under the index's reference; private pages return to the pool."""
    for pid in pages:
        pool.release(pid)


# ---------------------------------------------------------------------------
# cross-pool page streaming (disaggregated serving)
# ---------------------------------------------------------------------------
# The disaggregated engine runs prefill and decode against *separate* pools
# (one per submesh). A finished prefill is handed over as a PageExport — the
# host manifest travelling with the device-side gathered page block — and
# adopted into the decode pool through import_pages, which re-establishes
# refcounts locally and returns the src→dst physical-id remap the scatter
# needs. Page ids are pool-local and never cross the seam unremapped.


@dataclass
class PageExport:
    """Host manifest of one finished prefill, the streaming unit.

    ``pages`` are the *source-pool* physical ids of the prompt's logical
    pages, in logical order — meaningless in any other pool until
    :func:`import_pages` remaps them. ``first_token`` is the request's first
    generated token, sampled from the final prompt logits on the prefill
    side, so the decode side never needs prefill logits."""

    prompt: List[int]
    pages: List[int]
    page_size: int
    first_token: int


def export_pages(plan: AdmissionPlan, prompt, *, page_size: int,
                 first_token: int) -> PageExport:
    """Snapshot a finished prefill's prompt pages for streaming. Host-only:
    takes no references — the exporting engine keeps its plan live until the
    device block has been gathered (the gather is enqueued before any later
    write to these pages, so releasing right after is safe)."""
    prompt = [int(t) for t in prompt]
    n_prompt = -(-len(prompt) // page_size)
    assert len(plan.pages) >= n_prompt
    return PageExport(
        prompt=prompt,
        pages=list(plan.pages[:n_prompt]),
        page_size=page_size,
        first_token=int(first_token),
    )


@dataclass
class PageImport:
    """Destination-pool placement for one :class:`PageExport`.

    ``plan.pages`` hold the request's logical pages in the *destination*
    pool (adopted prefix pages first, then freshly allocated ones);
    ``remap`` maps each streamed source id to its destination id — source
    pages whose content is already resident (adopted via the destination's
    radix index) are absent from it, and the scatter routes their lanes to
    the scratch page."""

    plan: AdmissionPlan
    remap: Dict[int, int]
    adopted: int  # full prompt pages deduped against the destination index


def import_pages(
    pool: PagePool,
    index: Optional[RadixPrefixIndex],
    export: PageExport,
    total_len: int,
    *,
    share: bool = True,
) -> Optional[PageImport]:
    """Adopt a streamed prefill into this pool: match the prompt's *full*
    pages against the local radix index (a hit means identical KV is already
    resident — those pages are retained, not re-streamed), allocate
    destination pages for everything else (LRU-evicting on pressure), and
    return the placement. None — nothing retained/allocated — if the pool
    cannot cover ``total_len`` positions.

    Unlike :func:`plan_admission` there is no ``len(prompt) - 1`` reuse cap
    (the first token is already sampled; no logits are recomputed) and no
    copy-on-write (partial-page divergence is served by the streamed bytes
    themselves). The same pin-then-evict order applies, with the same
    unshared retry when pinned adoptions wedge eviction."""
    ps = export.page_size
    assert pool.page_size == ps, (pool.page_size, ps)
    prompt = export.prompt
    n_logical = -(-total_len // ps)
    n_prompt = len(export.pages)
    assert 0 < len(prompt) <= total_len and n_logical >= n_prompt

    shared: List[int] = []
    if share and index is not None:
        n_full = len(prompt) // ps
        full, _ = index.match(prompt[: n_full * ps])
        # full-page adoption only: decode writes from len(prompt) on, which
        # never lands inside the first len(prompt) // ps pages, so adopted
        # pages stay immutable; a partial last prompt page *will* be written
        # and must come from the stream into a private page
        shared = list(full)
    for pid in shared:
        pool.retain(pid)

    n_new = n_logical - len(shared)
    if pool.free_count < n_new:
        if index is not None:
            index.evict(n_new - pool.free_count)
        if pool.free_count < n_new:
            for pid in shared:
                pool.release(pid)
            if share and index is not None and shared:
                return import_pages(pool, index, export, total_len, share=False)
            return None
    new_pages = pool.alloc(n_new)
    assert new_pages is not None
    plan = AdmissionPlan(
        reuse_len=len(shared) * ps, shared=shared, cow_src=None,
        new_pages=new_pages,
    )
    remap = {
        src: plan.pages[j]
        for j, src in enumerate(export.pages)
        if j >= len(shared)
    }
    return PageImport(plan=plan, remap=remap, adopted=len(shared))
