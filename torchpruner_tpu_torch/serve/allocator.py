"""Bucketed KV-cache allocation for the serving slot array.

Counterpart of ``torchpruner_tpu/serve/allocator.py``, copied (host
bookkeeping only, no device handle): the same bucket ladder, slot
leases, pages and prefix trie, so both engines prefill at the same
lengths and share the same pages.

The physical cache is one static ``(n_slots, max_len, H, Dh)`` buffer
per attention layer (generate.init_cache) — static shapes are the TPU
contract, so admission control happens in HOST bookkeeping, not device
reallocation.  This module owns that bookkeeping:

- **Lane-aligned buckets** — page and prefill-bucket sizes come from
  the same 8-sublane / 128-lane alignment ladder ``prune_by_scores``
  rounds kept widths to (core.pruner.bucket_drop, SURVEY.md §7): a
  bounded, hardware-shaped set of compiled prefill lengths means a
  bounded total compile bill, exactly the recompilation-economics
  argument made for prune schedules.
- **Pages** — each slot's ``max_len`` positions are divided into pages
  of ``page_len`` tokens.  A request is admitted only when a free slot
  has enough pages for ``prompt + max_new``; the engine draws down a
  shared page budget so obs can report KV residency
  (``serve_kv_pages_in_use``) and an operator can cap it below
  ``n_slots * pages_per_slot`` (over-subscription guard for mixed
  long/short traffic).
- **Recycling without retrace** — freeing a slot is a host-side list
  append; the device buffer is NOT zeroed.  Stale K/V from the previous
  occupant is harmless by construction: a position ``t`` of a slot's
  cache only becomes attendable once that slot's decode position
  reaches ``t``, and the decode step writes position ``t`` before
  reading it (generate._decode_attention masks ``t > pos``).  The
  ragged-parity tests pin this by poisoning the cache and checking
  bit-identical logits.
- **Prefix sharing** (``prefix_pages > 0``) — a radix trie over
  page-sized token chunks (:class:`PrefixTrie`) indexes a pool of
  published K/V pages.  At admission the prompt's leading WHOLE pages
  are matched against the trie and mapped (copied) into the slot's
  rows instead of re-prefilled; matched trie nodes are PINNED
  (refcounted) for the request's lifetime, and eviction is LRU over
  unpinned leaf nodes only — a pinned node refuses eviction.  The map
  is a copy, never an alias: decode writes land in the slot's private
  rows, so the pool page stays canonical (the "copy-on-write" page is
  materialized at admission time, which is what keeps sharing inside
  the static-shape contract — no page-indirect addressing in the
  compiled programs).  Published K/V are canonical because every
  producer computes them with the SAME chunk-aligned prefill programs
  at the same absolute positions with row-invariant ops (engine), so a
  mapped page is bit-identical to what a private re-prefill would have
  written — the sharing-on/off parity contract.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

#: the TPU tiling ladder shared with core.pruner.bucket_drop: vector
#: lanes are 128 wide, sublanes 8 deep — multiples tile the MXU/VPU
#: cleanly and bound the distinct-shape set
SUBLANE = 8
LANE = 128


def aligned_len(n: int) -> int:
    """Round ``n`` up the lane-alignment ladder: to a multiple of 8
    below 128, to a multiple of 128 above — the same rounding direction
    (up = conservative) as ``bucket_drop``'s kept-width rule."""
    if n <= 0:
        return SUBLANE
    if n <= LANE:
        return -(-n // SUBLANE) * SUBLANE
    return -(-n // LANE) * LANE


def prefill_buckets(max_prompt: int) -> List[int]:
    """The bucketed prefill-length ladder up to ``max_prompt``: every
    aligned length {8, 16, .., 128, 256, ..} — one compiled prefill
    program per bucket actually used, never one per prompt length.
    The LAST bucket is ``max_prompt`` itself (possibly unaligned):
    prefill caches insert into the serving cache's ``max_len`` rows, so
    a bucket may never exceed the physical slot length."""
    out, n = [], SUBLANE
    while n < max_prompt:
        out.append(n)
        n = aligned_len(n + 1)
    out.append(max_prompt)
    return out


def bucket_for(n: int, buckets: List[int]) -> int:
    """Smallest bucket holding ``n`` tokens."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds the largest prefill "
                     f"bucket {buckets[-1]}")


class PrefixNode:
    """One radix-trie node: an edge label of whole page chunks plus the
    physical pool page holding each chunk's K/V.  ``refcount`` counts
    active requests whose admission match pinned this node; a pinned
    node refuses eviction (its pages may be re-mapped any step)."""

    __slots__ = ("label", "pages", "children", "parent", "refcount",
                 "last_used")

    def __init__(self, label: Tuple[int, ...] = (),
                 pages: Optional[List[int]] = None,
                 parent: Optional["PrefixNode"] = None):
        self.label = tuple(label)
        self.pages: List[int] = list(pages or [])
        #: first-page-chunk -> child
        self.children: Dict[Tuple[int, ...], "PrefixNode"] = {}
        self.parent = parent
        self.refcount = 0
        self.last_used = 0


@dataclass
class PrefixMatch:
    """A pinned admission match: ``tokens`` leading prompt tokens
    (a multiple of ``page_len``) are resident in pool ``pages`` (prompt
    order).  Hold until the request leaves its slot, then release via
    the allocator (unpins the node path exactly once)."""

    tokens: int
    pages: List[int]
    nodes: List[PrefixNode] = field(repr=False)
    #: uncapped resident whole-page tokens (>= ``tokens``) — the delta
    #: is the copy-on-write region the engine re-prefills privately
    available: int = 0
    released: bool = field(default=False, repr=False)


class PrefixTrie:
    """Radix trie over page-sized token chunks (host bookkeeping only —
    it never touches device memory; physical pages are just ints the
    engine's copy programs consume).  Edges are runs of whole page
    chunks; divergence or partial overlap mid-edge SPLITS the edge at a
    page boundary, so every match/insert boundary stays page-aligned."""

    def __init__(self, page_len: int):
        if page_len <= 0:
            raise ValueError(f"page_len must be > 0, got {page_len}")
        self.page_len = int(page_len)
        self.root = PrefixNode()
        self._clock = 0

    # -- helpers -------------------------------------------------------------

    def _chunks(self, ids: Sequence[int],
                n_tokens: int) -> List[Tuple[int, ...]]:
        L = self.page_len
        ids = [int(t) for t in ids[: (n_tokens // L) * L]]
        return [tuple(ids[i:i + L]) for i in range(0, len(ids), L)]

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def nodes(self) -> Iterator[PrefixNode]:
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root:
                yield n
            stack.extend(n.children.values())

    @property
    def total_pages(self) -> int:
        return sum(len(n.pages) for n in self.nodes())

    @property
    def shared_pages(self) -> int:
        """Pages on nodes pinned by at least one active request — the
        ``serve_kv_pages_shared`` gauge."""
        return sum(len(n.pages) for n in self.nodes() if n.refcount > 0)

    def _split(self, node: PrefixNode, k_pages: int) -> PrefixNode:
        """Split ``node``'s edge after its first ``k_pages`` chunks:
        a new intermediate node takes the prefix (inheriting the pins —
        every path that pinned the deep node passed through the prefix),
        ``node`` keeps the remainder and its subtree."""
        L = self.page_len
        if not (0 < k_pages < len(node.pages)):
            raise ValueError(f"split point {k_pages} out of range for an "
                             f"edge of {len(node.pages)} page(s)")
        parent = node.parent
        mid = PrefixNode(label=node.label[:k_pages * L],
                         pages=node.pages[:k_pages], parent=parent)
        mid.refcount = node.refcount
        mid.last_used = node.last_used
        node.label = node.label[k_pages * L:]
        node.pages = node.pages[k_pages:]
        node.parent = mid
        mid.children[node.label[:L]] = node
        parent.children[mid.label[:L]] = mid
        return mid

    # -- the three verbs -----------------------------------------------------

    def match(self, ids: Sequence[int], max_tokens: Optional[int] = None
              ) -> Tuple[int, List[int], List[PrefixNode]]:
        """Longest whole-page prefix of ``ids`` (capped at
        ``max_tokens``) resident in the trie: returns ``(tokens, pool
        pages in prompt order, node path)``.  Partial overlap with an
        edge splits it at the last matched page so the path can be
        pinned exactly.  Bumps LRU recency; does NOT pin — callers pin
        via :meth:`pin` once they commit to the mapping."""
        n = len(ids) if max_tokens is None else min(len(ids), max_tokens)
        chunks = self._chunks(ids, n)
        node, i = self.root, 0
        pages: List[int] = []
        path: List[PrefixNode] = []
        now = self._tick()
        while i < len(chunks):
            child = node.children.get(chunks[i])
            if child is None:
                break
            want = chunks[i:i + len(child.pages)]
            have = self._chunks(child.label, len(child.label))
            k = 0
            while k < len(have) and k < len(want) and have[k] == want[k]:
                k += 1
            if k == 0:
                break
            if k < len(child.pages):
                child = self._split(child, k)
            child.last_used = now
            pages.extend(child.pages)
            path.append(child)
            i += k
            node = child
            if k < len(have):
                break
        return len(pages) * self.page_len, pages, path

    def pin(self, nodes: Sequence[PrefixNode]) -> None:
        for n in nodes:
            n.refcount += 1

    def unpin(self, nodes: Sequence[PrefixNode]) -> None:
        for n in nodes:
            if n.refcount <= 0:
                raise RuntimeError(
                    "prefix refcount underflow: unpin without a "
                    "matching pin (double release?)")
            n.refcount -= 1

    def insert(self, ids: Sequence[int], n_tokens: int,
               acquire) -> List[Tuple[int, int]]:
        """Publish the first ``n_tokens`` (rounded DOWN to whole pages)
        of ``ids``: walk the trie, split at any mid-edge divergence, and
        append the novel tail as one compressed edge, calling
        ``acquire(protect_nodes) -> Optional[page_id]`` per new chunk
        (the allocator's pool free-list / LRU eviction hook — the
        current path is passed so eviction can never free a node the
        insert is extending).  Returns ``[(page_index_in_prompt,
        pool_page_id), ...]`` for the chunks the caller must copy into
        the pool; an exhausted pool truncates the publication."""
        chunks = self._chunks(ids, n_tokens)
        node, i = self.root, 0
        now = self._tick()
        while i < len(chunks):
            child = node.children.get(chunks[i])
            if child is None:
                break
            want = chunks[i:i + len(child.pages)]
            have = self._chunks(child.label, len(child.label))
            k = 0
            while k < len(have) and k < len(want) and have[k] == want[k]:
                k += 1
            if k == 0:
                break
            if k < len(child.pages):
                child = self._split(child, k)
            child.last_used = now
            i += k
            node = child
            if k < len(have):
                break
        out: List[Tuple[int, int]] = []
        if i >= len(chunks):
            return out
        L = self.page_len
        fresh = PrefixNode(parent=node)
        protect = [fresh, node] + [a for a in _ancestors(node)]
        for j in range(i, len(chunks)):
            pg = acquire(protect)
            if pg is None:
                break
            fresh.label += chunks[j]
            fresh.pages.append(pg)
            out.append((j, pg))
        if not fresh.pages:
            return out
        fresh.last_used = now
        node.children[fresh.label[:L]] = fresh
        return out

    def evict_lru(self, protect: Sequence[PrefixNode] = ()
                  ) -> List[int]:
        """Free the least-recently-used UNPINNED leaf edge's pages.
        Returns the freed pool page ids — empty when every leaf is
        pinned (the evict-while-shared refusal) or the trie is empty."""
        protect_ids = {id(p) for p in protect}
        victim: Optional[PrefixNode] = None
        for n in self.nodes():
            if n.children or n.refcount > 0 or id(n) in protect_ids:
                continue
            if victim is None or n.last_used < victim.last_used:
                victim = n
        if victim is None:
            return []
        del victim.parent.children[victim.label[:self.page_len]]
        pages, victim.pages = victim.pages, []
        return pages

    def reset(self) -> List[int]:
        """Drop every node (checkpoint hot-swap: pooled K/V computed
        under the old weights is invalid) and return all pages."""
        pages = [p for n in self.nodes() for p in n.pages]
        self.root = PrefixNode()
        return pages


def _ancestors(node: PrefixNode) -> Iterator[PrefixNode]:
    while node is not None and node.parent is not None:
        yield node
        node = node.parent


@dataclass
class SlotLease:
    """One admitted request's residency: which slot, how many pages."""

    slot: int
    pages: int
    request_id: int
    #: pinned prefix-pool mapping (sharing enabled + admission hit) —
    #: released with the slot
    prefix_match: Optional[PrefixMatch] = None
    #: QoS tenant charged for these pages (per-tenant quota accounting)
    tenant: Optional[str] = None


@dataclass
class KVCacheAllocator:
    """Slot + page bookkeeping over the static serving cache (see
    module docstring).  Pure host state — O(n_slots) lists, no device
    handles — so the scheduler can consult it at every step boundary
    for free."""

    n_slots: int
    max_len: int
    page_len: int = 0
    #: optional global page budget (< n_slots * pages_per_slot caps
    #: total KV residency below the physical buffer)
    page_budget: int = 0
    #: prefix-sharing pool size in pages (0 = sharing off); the engine
    #: sizes its device pool buffers from this
    prefix_pages: int = 0
    _free_slots: List[int] = field(default_factory=list)
    _leases: Dict[int, SlotLease] = field(default_factory=dict)
    pages_in_use: int = 0
    total_evictions: int = 0
    # -- prefix-sharing counters (host truth; the engine mirrors them
    # into obs so sharing-off runs emit NO serve_prefix_* scalars) ----
    prefix_hits: int = 0
    prefix_misses: int = 0
    prefix_hit_tokens: int = 0
    prefix_published_pages: int = 0
    prefix_evictions: int = 0
    #: publications truncated because every pool page was pinned/full
    prefix_pool_exhausted: int = 0

    def __post_init__(self):
        if self.page_len <= 0:
            # default page: one lane-aligned chunk, capped at the slot
            self.page_len = min(aligned_len(min(self.max_len, LANE)),
                                self.max_len)
        self.page_len = min(self.page_len, self.max_len)
        self._free_slots = list(range(self.n_slots))[::-1]  # pop() -> 0 first
        if self.page_budget <= 0:
            self.page_budget = self.n_slots * self.pages_per_slot
        self._trie = PrefixTrie(self.page_len)
        self._free_prefix = list(range(self.prefix_pages))[::-1]
        #: tenant -> pages currently leased (QoS quota accounting)
        self._tenant_pages: Dict[str, int] = {}

    @property
    def pages_per_slot(self) -> int:
        return -(-self.max_len // self.page_len)

    def pages_needed(self, total_len: int) -> int:
        return -(-total_len // self.page_len)

    def can_admit(self, total_len: int) -> bool:
        if total_len > self.max_len:
            return False
        need = self.pages_needed(total_len)
        return bool(self._free_slots) and \
            self.pages_in_use + need <= self.page_budget

    def tenant_pages(self, tenant: Optional[str]) -> int:
        """Pages currently leased to ``tenant`` (0 for None/unknown)."""
        if tenant is None:
            return 0
        return self._tenant_pages.get(tenant, 0)

    def exceeds_quota(self, tenant: Optional[str], total_len: int,
                      quota: int) -> bool:
        """Would leasing ``total_len`` push ``tenant`` past its KV-page
        ``quota``?  The quota is the QoS table's per-tenant ceiling
        (``quota <= 0`` disables).  Distinct from :meth:`can_admit`
        (transient global pressure → WAIT): an over-quota admission is
        the tenant's own footprint → SHED, so it never head-of-line
        blocks the other tenants."""
        if tenant is None or quota <= 0:
            return False
        return self.tenant_pages(tenant) \
            + self.pages_needed(total_len) > quota

    def allocate(self, request_id: int, total_len: int,
                 tenant: Optional[str] = None) -> Optional[SlotLease]:
        """Lease a slot (+ pages) for a request of ``total_len``
        resident positions, or ``None`` when nothing fits.  The slot's
        device buffer is untouched — see the recycling note above.
        ``tenant`` charges the pages to a QoS tenant's quota account."""
        if not self.can_admit(total_len):
            return None
        slot = self._free_slots.pop()
        lease = SlotLease(slot=slot, pages=self.pages_needed(total_len),
                          request_id=request_id, tenant=tenant)
        self._leases[slot] = lease
        self.pages_in_use += lease.pages
        if tenant is not None:
            self._tenant_pages[tenant] = \
                self._tenant_pages.get(tenant, 0) + lease.pages
        return lease

    def release(self, slot: int) -> None:
        """Return a slot's pages to the pool (eviction / completion) —
        no retrace, no device write; the next occupant's prefill and
        the overwrite-before-read decode order make stale K/V
        unobservable.  A pinned prefix match is unpinned here, so the
        trie's refcounts track slot residency exactly."""
        lease = self._leases.pop(slot, None)
        if lease is None:
            return
        if lease.prefix_match is not None:
            self.release_prefix(lease.prefix_match)
            lease.prefix_match = None
        self.pages_in_use -= lease.pages
        if lease.tenant is not None:
            left = self._tenant_pages.get(lease.tenant, 0) - lease.pages
            if left > 0:
                self._tenant_pages[lease.tenant] = left
            else:
                self._tenant_pages.pop(lease.tenant, None)
        self._free_slots.append(slot)
        self.total_evictions += 1

    def lease_of(self, slot: int) -> Optional[SlotLease]:
        return self._leases.get(slot)

    @property
    def active_slots(self) -> int:
        return self.n_slots - len(self._free_slots)

    # -- prefix sharing ------------------------------------------------------

    @property
    def prefix_enabled(self) -> bool:
        return self.prefix_pages > 0

    @property
    def shared_pages(self) -> int:
        """Pool pages pinned by at least one resident request."""
        return self._trie.shared_pages if self.prefix_enabled else 0

    @property
    def prefix_pool_used(self) -> int:
        return self.prefix_pages - len(self._free_prefix)

    def match_prefix(self, prompt_ids,
                     max_tokens: Optional[int] = None
                     ) -> Optional[PrefixMatch]:
        """Match (and PIN) the prompt's longest resident whole-page
        prefix.  ``max_tokens`` caps the match — the engine passes
        ``len(prompt) - 1`` so at least one real position is always
        prefilled (the first token's logits must be computed).  Returns
        ``None`` on a miss; a hit must be released exactly once via
        :meth:`release_prefix` (or implicitly by :meth:`release`)."""
        if not self.prefix_enabled:
            return None
        # uncapped probe first: the capped match below may refuse
        # resident pages at the write boundary — that delta is the COW
        # region the engine accounts for
        available, _, _ = self._trie.match(prompt_ids, None)
        tokens, pages, nodes = self._trie.match(prompt_ids, max_tokens)
        if tokens <= 0:
            self.prefix_misses += 1
            return None
        self._trie.pin(nodes)
        self.prefix_hits += 1
        self.prefix_hit_tokens += tokens
        return PrefixMatch(tokens=tokens, pages=pages, nodes=nodes,
                           available=max(available, tokens))

    def release_prefix(self, match: PrefixMatch) -> None:
        """Unpin a match's node chain (idempotent per match object —
        the refcount-never-negative property).  The chain is walked via
        CURRENT parent pointers, not the match-time path: a later
        match/insert may have split a pinned edge, and the split's mid
        node inherited this pin (``PrefixTrie._split``) — releasing the
        stale path would leak that pin and leave the mid's pages
        permanently unevictable."""
        if match.released:
            return
        match.released = True
        self._trie.unpin(list(_ancestors(match.nodes[-1])))

    def publish_prefix(self, prompt_ids,
                       n_tokens: int) -> List[Tuple[int, int]]:
        """Index the first ``n_tokens`` (whole pages) of a freshly
        prefilled prompt, acquiring pool pages from the free list or by
        LRU-evicting unpinned edges.  Returns the ``(page_index,
        pool_page)`` copies the engine must perform."""
        if not self.prefix_enabled:
            return []
        plan = self._trie.insert(prompt_ids, n_tokens, self._acquire_page)
        self.prefix_published_pages += len(plan)
        return plan

    def _acquire_page(self, protect) -> Optional[int]:
        if self._free_prefix:
            return self._free_prefix.pop()
        freed = self._trie.evict_lru(protect)
        if not freed:
            self.prefix_pool_exhausted += 1
            return None
        self.prefix_evictions += len(freed)
        self._free_prefix.extend(freed)
        return self._free_prefix.pop()

    def reset_prefix(self) -> None:
        """Invalidate the whole pool (checkpoint hot-swap: pooled K/V
        belongs to the old weights).  Pins survive on the MATCH objects
        of in-flight requests, but the swap only lands on an empty slot
        array, so by construction nothing is pinned here."""
        if not self.prefix_enabled:
            return
        self._free_prefix.extend(self._trie.reset())
