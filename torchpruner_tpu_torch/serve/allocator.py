"""Bucketed KV-cache allocation for the serving slot array.

Counterpart of ``torchpruner_tpu/serve/allocator.py``: the buckets,
slot leases and pages, copied with the same bucket ladder so both
engines prefill at the same lengths.  The prefix-page pool and its
radix trie are not ported yet.

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
  has enough pages for ``prompt + max_new``, drawn from a shared page
  budget that an operator can cap below ``n_slots * pages_per_slot``
  (over-subscription guard for mixed long/short traffic).
- **Recycling without retrace** — freeing a slot is a host-side list
  append; the device buffer is NOT zeroed.  Stale K/V from the previous
  occupant is harmless by construction: a position ``t`` of a slot's
  cache only becomes attendable once that slot's decode position
  reaches ``t``, and the decode step writes position ``t`` before
  reading it (generate._decode_attention masks ``t > pos``).  The
  ragged-parity tests pin this by poisoning the cache and checking
  bit-identical logits.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

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


@dataclass
class SlotLease:
    """One admitted request's residency: which slot, how many pages."""

    slot: int
    pages: int
    request_id: int
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
    _free_slots: List[int] = field(default_factory=list)
    _leases: Dict[int, SlotLease] = field(default_factory=dict)
    pages_in_use: int = 0
    total_evictions: int = 0

    def __post_init__(self):
        if self.page_len <= 0:
            # default page: one lane-aligned chunk, capped at the slot
            self.page_len = min(aligned_len(min(self.max_len, LANE)),
                                self.max_len)
        self.page_len = min(self.page_len, self.max_len)
        self._free_slots = list(range(self.n_slots))[::-1]  # pop() -> 0 first
        if self.page_budget <= 0:
            self.page_budget = self.n_slots * self.pages_per_slot
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
        unobservable."""
        lease = self._leases.pop(slot, None)
        if lease is None:
            return
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
