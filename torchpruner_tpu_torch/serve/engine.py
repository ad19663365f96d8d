"""The continuous-batching inference engine — counterpart of
``torchpruner_tpu/serve/engine.py``.

One :class:`ServeEngine` owns a fixed ``n_slots``-wide slot array, one
``(n_slots, max_len, H, Dh)`` KV cache per attention layer, and these
step functions:

- **decode** — one step advances every slot one token at its own
  position (``generate.make_slot_decode_step``) with per-slot sampling;
  admissions and evictions at step boundaries only change host-side slot
  tables.  On CUDA each step launches the decode-attention kernel once
  per layer and the dequant kernel for every quantized projection.
- **prefill** — per prompt bucket (allocator ladder), a whole-prompt
  forward fills a bucket-length B=1 cache, takes the last REAL
  position's logits and samples the first token.  End padding needs no
  masking: padded positions only write K/V at ``t >= prompt_len``, and
  decode overwrites position ``t`` before it first becomes attendable.
- **insert** — the bucket-length prefill cache is copied into the slot's
  rows of the serving cache.

**Serve v2** (``prefill_chunk > 0`` and/or ``prefix_pages > 0``):

- **chunked prefill** — a prompt prefills in fixed chunks INTERLEAVED
  with decode steps, under a per-step prefill-token cap (scheduler), so
  a long prompt cannot stall the slot array.  A chunk runs the slot's
  rows of the serving cache in place (a B=1 view) at its absolute
  position.  Chunks sit on a global grid of the chunk width, which
  divides ``max_len``, so every write is in bounds; a prefix hit that
  ends mid-chunk (pages narrower than the chunk) first runs one shorter
  chunk up to the grid.  A position's K/V does not depend on the chunk
  it was computed in (every row op is batch-invariant), so two requests
  sharing a prefix compute it identically — what makes published
  prefix pages canonical.  The JAX engine asks for ``chunk | page_len``
  instead: its compiled programs are not row-invariant.  While a slot
  is mid-prefill its decode write row is parked on ``max_len - 1``
  (never attendable before decode overwrites it) and its step outputs
  are discarded.  On CUDA each chunk's projections go
  through the dequant kernel at M = chunk rows.
- **prefix pages** — admission-time prefix hits copy pool pages into
  the slot's rows; completion publishes the prompt's whole pages into
  the pool.  The map is a COPY (copy-on-write materialized at
  admission): decode writes stay in the slot's private rows and the
  pool page stays canonical.

**Hot-swap**: ``request_swap(ckpt_dir)`` stages a digest-verified
checkpoint on a BACKGROUND thread: the restore and the host-to-device
copies run on that thread's own CUDA stream, which is synchronized
before the staged program set is handed over, so in-flight requests
keep decoding meanwhile.  Once staged, admissions pause, in-flight
requests finish on the old weights (their KV holds old-weight K/V), and
traffic switches at the first empty-slot-array step boundary; the
prefix pool (old-weight K/V) is reset and the new program set brings
its own KV cache at its own widths.

**Drain** (SIGTERM): the engine polls a
:class:`~torchpruner_tpu_torch.resilience.guards.PreemptionHandler` at
step boundaries — preemption stops admissions, finishes in-flight
requests, snapshots the still-queued ones to ``serve_queue_snapshot.json``
(atomic) and returns.

``--verify`` replays every request alone through ``generate`` against
the program set that served it and asks for the same tokens, bit for
bit.  That holds because every row's computation is batch-invariant
(``ops/fixed_order.py``, the kernels' fixed reduction orders) and
independent of the prompt bucket, the chunk width and the cache length
beyond the row's own positions.

MoE models decode through the same walk (``generate._decode_seq``: the
MoE rule on the fixed-order path); ``--verify`` holds for the dense
dispatch, whose every row op is batch-invariant (the sparse dispatch's
capacity depends on the tokens in the step, so a dropped pair depends on
the batch).

Telemetry, at the JAX engine's call sites and under its names: spans
``serve_prefill``, ``serve_prefill_chunk``, ``serve_prefix_map`` /
``serve_prefix_publish`` and ``serve_swap_compile``; the ``serve_*`` and
``tenant_*`` counters and histograms (and, the port's own,
``tenant_<name>_token_seconds``: a tenant's per-token latency, which the
fleet's scenario drill reports per tenant); request-trace stages (admission →
prefill → first_token → decode → complete); ``obs.profile_step`` after
every decode step and ``obs.profile_tick`` / ``obs.timeseries_tick`` in
the loop, which drive the capture windows; ``record_serve`` ledger
records of swaps and summaries.  Every call is a no-op without an obs
session.  The chaos module's ``slow_steps_ms`` (``resilience/chaos.py``,
the "slow replica" fault) stalls every decode step, as in the JAX
engine; without chaos configured the hook is one module-global check.
Left for a later slice (the JAX engine has it): the cost-model twin.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from torchpruner_tpu_torch import obs
from torchpruner_tpu_torch.generate import (
    _attn_layers,
    _decode_seq,
    check_params_device,
    init_cache,
    sample_row,
)
from torchpruner_tpu_torch.obs import reqtrace
from torchpruner_tpu_torch.resilience import chaos as _chaos
from torchpruner_tpu_torch.serve.allocator import (
    KVCacheAllocator,
    bucket_for,
    prefill_buckets,
)
from torchpruner_tpu_torch.serve.request import DONE, DRAINED, Request
from torchpruner_tpu_torch.serve.scheduler import Scheduler
from torchpruner_tpu_torch.utils.device import resolve_device
from torchpruner_tpu_torch.utils.dtypes import to_dtype

SNAPSHOT_FILENAME = "serve_queue_snapshot.json"
#: how long an idle engine loop sleeps before it polls again
_IDLE_WAIT_S = 5e-4


def vocab_of(model) -> int:
    """The model's token-id space (its Embedding layer's vocab)."""
    from torchpruner_tpu_torch.core import layers as L

    for spec in model.layers:
        if isinstance(spec, L.Embedding):
            return int(spec.vocab_size)
    return 256


def kernel_launches() -> Dict[str, int]:
    """The launch counts of the two kernels on the serving path."""
    from torchpruner_tpu_torch.ops import decode_attention as DA
    from torchpruner_tpu_torch.ops import fused_matmul as FM

    return {"decode_attention": DA.decode_attention.launches,
            "dequant_matmul": FM.dequant_matmul.launches}


def sample_tokens(logits: torch.Tensor, gens: List[Optional[torch.Generator]],
                  temp: np.ndarray, top_k: np.ndarray,
                  top_p: np.ndarray) -> np.ndarray:
    """Per-slot sampling: greedy (exact argmax — the bit-parity contract)
    where ``temp == 0``, else a draw from the slot's generator at ``temp``
    truncated to ``top_k`` (``<= 0`` disables) and the ``top_p`` nucleus
    (``>= 1`` disables) — the same :func:`generate.sample_row` a solo
    replay uses, so a replay with the same seed emits the same tokens."""
    out = torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int64)
    for b in np.nonzero(temp > 0)[0]:
        out[b] = sample_row(
            logits[b], gens[b], float(temp[b]),
            int(top_k[b]) if top_k[b] > 0 else None,
            float(top_p[b]) if top_p[b] < 1.0 else None)
    return out


def _sample_one(logits_row: torch.Tensor, gen, temp: float, top_k: int,
                top_p: float) -> int:
    return int(sample_tokens(
        logits_row[None], [gen], np.asarray([temp], np.float32),
        np.asarray([top_k]), np.asarray([top_p]))[0])


def make_serve_step(model):
    """One continuous-batching decode step with per-slot sampling —
    ``(params, cache, tok (B,), pos (B,), gens, temp, top_k, top_p) ->
    next_tok (B,)`` numpy; the cache is updated in place."""

    @torch.no_grad()
    def step(params, cache, tok, pos, gens, temp, top_k, top_p):
        x, _ = _decode_seq(model.layers, params, cache, tok[:, None], pos)
        return sample_tokens(x[:, 0], gens, temp, top_k, top_p)

    return step


def make_prefill(model, bucket: int, cache_dtype, device):
    """Bucketed-length prefill — ``(params, prompt (1, bucket), true_len,
    gen, temp, top_k, top_p) -> (first_tok, bucket_cache)``."""

    @torch.no_grad()
    def prefill(params, prompt, true_len, gen, temp, top_k, top_p):
        cache = init_cache(model, 1, bucket, cache_dtype, device=device)
        x, cache = _decode_seq(model.layers, params, cache, prompt, 0)
        # the last REAL position
        return _sample_one(x[0, true_len - 1], gen, temp, top_k,
                           top_p), cache

    return prefill


def make_insert():
    """Copy a bucket-length B=1 prefill cache into one slot's rows of the
    serving cache (the prefill -> decode hand-off), in place."""

    @torch.no_grad()
    def insert(big, small, slot: int):
        for key, entry in small.items():
            for name, buf in entry.items():
                big[key][name][slot, :buf.shape[1]] = buf[0].to(
                    big[key][name].dtype)
        return big

    return insert


def default_prefill_chunk(max_len: int) -> int:
    """The largest ladder chunk width dividing the slot length —
    divisibility keeps every chunk write in bounds and every chunk
    boundary globally aligned across requests (the prefix-page
    canonicality requirement); a chunk wider than a page realigns after
    a hit by its first chunk ending on the grid."""
    for c in (64, 32, 16, 8):
        if max_len % c == 0:
            return c
    return int(max_len)


def make_chunk_prefill(model):
    """One prefill chunk in place — ``(params, big_cache, toks (1,
    chunk), slot, pos0) -> chunk logits (chunk, V)``.  The slot's rows of
    the serving cache are a B=1 view; the chunk runs ``_decode_seq`` at
    absolute ``pos0`` (causal within the block, masked against
    everything beyond) and writes its K/V there.  Padded tail positions
    write junk K/V at ``t >= prompt_len`` that decode overwrites before
    it is ever attendable, the same argument as bucket end-padding."""

    @torch.no_grad()
    def chunk(params, big, toks, slot: int, pos0: int):
        rows = {key: {name: buf[slot:slot + 1]
                      for name, buf in entry.items()}
                for key, entry in big.items()}
        x, _ = _decode_seq(model.layers, params, rows, toks, pos0)
        return x[0]

    return chunk


def make_page_copy(page_len: int):
    """The pair moving one K/V page between the serving cache and the
    prefix pool, in place: ``map_page(big, pool, page, slot, start)``
    (admission hit: a pool page copied into the slot's rows — the
    copy-on-write materialization) and ``publish_page(pool, big, slot,
    start, page)`` (completion: a freshly prefilled whole page published
    for future requests)."""

    @torch.no_grad()
    def map_page(big, pool, page: int, slot: int, start: int):
        for key, entry in big.items():
            for name, buf in entry.items():
                buf[slot, start:start + page_len] = pool[key][name][page]
        return big

    @torch.no_grad()
    def publish_page(pool, big, slot: int, start: int, page: int):
        for key, entry in pool.items():
            for name, buf in entry.items():
                buf[page] = big[key][name][slot, start:start + page_len]
        return pool

    return map_page, publish_page


def make_sample_at():
    """Sample the FIRST token from a chunk's logits block at the prompt's
    last real position — the sampling :func:`make_prefill` does, so a
    chunked prefill emits the bit-identical first token for the same
    seed."""

    def sample_at(logits, idx: int, gen, temp, top_k, top_p) -> int:
        return _sample_one(logits[idx], gen, temp, top_k, top_p)

    return sample_at


class _Programs:
    """One checkpoint's serving surface: model + params + serving cache +
    the step functions (and, with serve v2 on, the chunk and page-copy
    functions and the device page pool).  Swappable as a unit."""

    def __init__(self, model, params, *, n_slots: int, max_len: int,
                 cache_dtype, device, meta: Optional[dict] = None,
                 page_len: int = 0, prefix_pages: int = 0,
                 prefill_chunk: int = 0):
        self.model, self.params, self.meta = model, params, dict(meta or {})
        self.n_slots, self.max_len = n_slots, max_len
        self.cache_dtype, self.device = cache_dtype, device
        self.cache = init_cache(model, n_slots, max_len, cache_dtype,
                                device=device)
        self.decode = make_serve_step(model)
        self.insert = make_insert()
        self.buckets = prefill_buckets(max_len)
        self._prefills: Dict[int, Any] = {}
        self.prefill_chunk = int(prefill_chunk)
        self.prefix_pages = int(prefix_pages)
        self.page_len = int(page_len)
        self.chunk_prefill = (make_chunk_prefill(model)
                              if self.prefill_chunk else None)
        self.sample_at = make_sample_at() if self.prefill_chunk else None
        if self.prefix_pages:
            # the same layer keying as the cache, pages on the lead axis
            self.prefix_pool = init_cache(model, self.prefix_pages,
                                          self.page_len, cache_dtype,
                                          device=device)
            self.map_page, self.publish_page = make_page_copy(
                self.page_len)
        else:
            self.prefix_pool = None

    def prefill_for(self, bucket: int):
        fn = self._prefills.get(bucket)
        if fn is None:
            fn = self._prefills[bucket] = make_prefill(
                self.model, bucket, self.cache_dtype, self.device)
        return fn


def _decode_kernel_active(model, max_len: int, cache_dtype, device) -> bool:
    from torchpruner_tpu_torch.ops import decode_attention as _da

    head_dim = next((int(spec.head_dim)
                     for _, spec in _attn_layers(model.layers)), 0)
    return bool(head_dim and _da.kernel_active(max_len, head_dim,
                                               cache_dtype, device))


class ServeEngine:
    """Continuous-batching serving over one model/params bundle on
    ``device`` (``None`` = ``cuda``; ``params`` must already live there).
    See the module docstring.

    ``retain_results=False`` (the long-running HTTP server) stops the
    engine from keeping completed requests (and, across a hot-swap, the
    old program set their ``served_by`` pins); batch front ends keep
    them for verification and percentiles.  ``queue_bound`` sheds
    submissions landing on a full queue; ``qos`` is the scheduler's
    multi-tenant table (serve.qos).

    Serve v2 knobs (all default OFF): ``prefix_pages`` sizes the shared
    prefix-page pool (> 0 enables prefix sharing and, if
    ``prefill_chunk`` is unset, picks the widest ladder chunk dividing
    the slot length); ``prefill_chunk`` enables chunked
    prefill; ``prefill_token_cap`` bounds prefill work per engine step
    (floored at one chunk so progress is guaranteed)."""

    def __init__(self, model, params, *, n_slots: int = 4,
                 max_len: int = 256, cache_dtype=None, device=None,
                 page_len: int = 0,
                 run_dir: Optional[str] = None,
                 checkpoint_meta: Optional[dict] = None,
                 retain_results: bool = True, queue_bound: int = 0,
                 prefix_pages: int = 0, prefill_chunk: int = 0,
                 prefill_token_cap: int = 0, qos=None):
        if getattr(model, "input_dtype", None) != "int32":
            raise ValueError(
                "ServeEngine serves token-sequence (LM) models; "
                f"got input_dtype={getattr(model, 'input_dtype', None)!r}")
        self.device = resolve_device(device)
        check_params_device(params, self.device)
        cache_dtype = torch.float32 if cache_dtype is None \
            else to_dtype(cache_dtype)
        allocator = KVCacheAllocator(
            n_slots, max_len, page_len=page_len, prefix_pages=prefix_pages)
        if prefix_pages and not prefill_chunk:
            # sharing REQUIRES chunking: mapped pages are canonical only
            # when every producer prefilled at the same global chunk
            # alignment
            prefill_chunk = default_prefill_chunk(max_len)
        if prefill_chunk and max_len % prefill_chunk:
            raise ValueError(
                f"prefill_chunk {prefill_chunk} must divide max_len "
                f"{max_len} (in-bounds chunk writes on the chunk grid)")
        self.prefill_chunk = int(prefill_chunk)
        self.prefill_token_cap = int(prefill_token_cap)
        self._prefix_pages = int(prefix_pages)
        self.programs = _Programs(
            model, params, n_slots=n_slots, max_len=max_len,
            cache_dtype=cache_dtype, device=self.device,
            meta=checkpoint_meta, page_len=allocator.page_len,
            prefix_pages=prefix_pages, prefill_chunk=self.prefill_chunk)
        #: whether decode steps launch the decode-attention kernel
        self.decode_kernel = _decode_kernel_active(
            model, max_len, cache_dtype, self.device)
        obs.gauge_set(
            "serve_decode_kernel_active", float(self.decode_kernel),
            help="1 when the decode-attention kernel serves this "
                 "engine's cache geometry")
        self.scheduler = Scheduler(
            allocator, queue_bound=queue_bound,
            prefill_token_cap=prefill_token_cap, qos=qos)
        # preemption (qos) may only reclaim slots whose prefill is not
        # mid-flight
        self.scheduler.preempt_guard = self._slot_preemptible
        self.run_dir = run_dir
        self.n_slots, self.max_len = n_slots, max_len
        # host slot tables (the continuous-batching state each decode
        # step is parameterized by)
        self._pos = np.zeros(n_slots, np.int32)
        self._tok = np.zeros(n_slots, np.int64)
        self._temp = np.zeros(n_slots, np.float32)
        self._topk = np.zeros(n_slots, np.int32)
        self._topp = np.ones(n_slots, np.float32)
        self._eos = np.full(n_slots, -1, np.int64)
        self._last_token_s = np.zeros(n_slots, np.float64)
        self._gens: List[Optional[torch.Generator]] = [None] * n_slots
        self.steps = 0
        #: loop-iteration clock (advances while idle too), which
        #: step-indexed open-loop schedules pump against
        self.ticks = 0
        self.gen_tokens = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._pending_swap: Optional[str] = None
        self._staged: Optional[_Programs] = None
        self._swap_error: Optional[BaseException] = None
        self._swap_thread: Optional[threading.Thread] = None
        #: two POST /swap handlers must not both pass the staging check
        self._swap_lock = threading.Lock()
        self.swaps_total = 0
        #: one record per completed swap (the JAX package ledgers these)
        self.swap_log: List[dict] = []
        #: slot -> in-progress chunked-prefill state (insertion order =
        #: round-robin order)
        self._prefilling: Dict[int, dict] = {}
        #: lifetime prompt tokens actually computed (chunk real tokens /
        #: whole-bucket prompt lengths; prefix hits skip theirs)
        self.prefill_tokens_total = 0
        #: the largest per-step prefill-token spend observed
        self.max_prefill_tokens_step = 0
        self.drained: List[Request] = []
        self.retain_results = retain_results
        self.completed_count = 0
        self._results: List[Request] = []
        self._window_tokens0 = 0
        self._launches0 = kernel_launches()
        #: optional live SLO monitor (serve.slo.SLOMonitor)
        self.slo = None
        #: the preemption handler of the CURRENT run()
        self._preemption = None

    @property
    def slo(self):
        return self._slo

    @slo.setter
    def slo(self, monitor):
        # the scheduler's queue-age hook follows the monitor
        self._slo = monitor
        self.scheduler.on_queue_wait = (
            monitor.on_queue if monitor is not None else None)

    @property
    def model(self):
        return self.programs.model

    @property
    def params(self):
        return self.programs.params

    def submit(self, request: Request,
               arrival_s: Optional[float] = None) -> Request:
        """Queue a request (thread-safe, host-only: HTTP handler threads
        call it)."""
        if request.total_len > self.max_len:
            raise ValueError(
                f"request needs {request.total_len} cache positions "
                f"(prompt {request.prompt_ids.size} + max_new "
                f"{request.max_new}) > engine max_len {self.max_len}")
        request.sampling.validate(0)
        return self.scheduler.submit(request, arrival_s=arrival_s)

    # -- the step-boundary machine -----------------------------------------

    def _slot_preemptible(self, slot: int) -> bool:
        return slot not in self._prefilling

    def _start_decoding(self, req: Request, tok: int, gen,
                        now: float) -> None:
        """Slot tables after a request's first token: next write position
        is the prompt length."""
        slot, s = req.slot, req.sampling
        req.first_token_s = now
        req.served_by = self.programs
        req.tokens.append(tok)
        self.gen_tokens += 1
        if req.ttft_s is not None:
            obs.observe("serve_ttft_seconds", req.ttft_s,
                        help="request arrival -> first token")
            reqtrace.stage(req.trace_id, "first_token", request=req.id,
                           ttft_s=round(req.ttft_s, 6))
            if self.slo is not None:
                self.slo.on_ttft(req.ttft_s)
        self._pos[slot] = int(req.prompt_ids.size)
        self._tok[slot] = tok
        self._temp[slot] = s.temperature
        self._topk[slot] = s.top_k or 0
        self._topp[slot] = 1.0 if s.top_p is None else s.top_p
        self._eos[slot] = -1 if req.eos_id is None else req.eos_id
        self._last_token_s[slot] = now
        self._gens[slot] = gen

    def _prefill(self, req: Request) -> None:
        P = self.programs
        n = int(req.prompt_ids.size)
        bucket = bucket_for(n, P.buckets)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :n] = req.prompt_ids
        s = req.sampling
        t_adm = time.perf_counter()
        if req.admitted_s is not None:
            # admission stage: slot granted -> this request's prefill
            # starting (a batch admission serializes prefills)
            reqtrace.stage(req.trace_id, "admission",
                           dur_s=max(0.0, t_adm - req.admitted_s),
                           request=req.id)
        gen = torch.Generator().manual_seed(int(s.seed))
        with obs.span("serve_prefill", request=req.id, bucket=bucket):
            tok, small = P.prefill_for(bucket)(
                P.params, torch.as_tensor(padded, device=self.device), n,
                gen, s.temperature, s.top_k or 0,
                1.0 if s.top_p is None else s.top_p)
            P.insert(P.cache, small, req.slot)
        now = time.perf_counter()
        req.prefill_s = now - t_adm
        req.prefilled_tokens = n
        self.prefill_tokens_total += n
        obs.inc("serve_prefill_tokens_total", n=n,
                help="prompt tokens actually prefilled (chunked real "
                     "tokens or whole-bucket prompt lengths; prefix "
                     "hits skip theirs)")
        reqtrace.stage(req.trace_id, "prefill", dur_s=req.prefill_s,
                       request=req.id, bucket=bucket)
        self._start_decoding(req, tok, gen, now)
        if len(req.tokens) >= req.max_new or tok == self._eos[req.slot]:
            self._finish(req)

    # -- serve v2: prefix sharing + chunked prefill --------------------------

    def _begin_prefill(self, req: Request) -> None:
        """Admission under chunked prefill: match + map the prompt's
        shared prefix pages (pinning the trie path), then queue the
        suffix for chunk-by-chunk prefilling interleaved with decode
        steps.  The match is capped at ``prompt_len - 1`` so at least one
        real position is always computed (the first token's logits live
        there)."""
        P = self.programs
        alloc = self.scheduler.allocator
        slot = req.slot
        n = int(req.prompt_ids.size)
        t_adm = time.perf_counter()
        if req.admitted_s is not None:
            reqtrace.stage(req.trace_id, "admission",
                           dur_s=max(0.0, t_adm - req.admitted_s),
                           request=req.id)
        pos0 = 0
        match = alloc.match_prefix(req.prompt_ids, max_tokens=n - 1)
        if match is not None:
            Lp = alloc.page_len
            with obs.span("serve_prefix_map", request=req.id,
                          pages=len(match.pages)):
                for i, pg in enumerate(match.pages):
                    P.map_page(P.cache, P.prefix_pool, pg, slot, i * Lp)
            pos0 = match.tokens
            alloc.lease_of(slot).prefix_match = match
            req.prefix_hit_tokens = pos0
            obs.inc("serve_prefix_hits_total",
                    help="admissions whose prompt matched resident "
                         "prefix pages")
            obs.inc("serve_prefix_hit_tokens_total", n=pos0,
                    help="prompt tokens served by mapping shared "
                         "prefix pages instead of re-prefilling")
            # pages the trie held but the cap refused: the copy-on-write
            # boundary, privately re-prefilled
            cow = -(-(min(getattr(match, "available", pos0), n)
                      - pos0) // Lp)
            if cow > 0:
                obs.inc("serve_prefix_cow_pages_total", n=cow,
                        help="resident pages re-prefilled privately at "
                             "the divergence/write boundary (COW)")
            reqtrace.stage(req.trace_id, "prefix_hit", request=req.id,
                           tokens=pos0)
        elif alloc.prefix_enabled:
            obs.inc("serve_prefix_misses_total",
                    help="admissions with no resident prefix page")
        # park the slot's decode write row on max_len - 1: never
        # attendable before decode overwrites it (the final decode
        # step's pos is at most total_len - 2), and this slot's step
        # outputs are discarded; greedy, so it draws from no generator
        self._pos[slot] = self.max_len - 1
        self._tok[slot] = 0
        self._temp[slot] = 0.0
        self._topk[slot] = 0
        self._topp[slot] = 1.0
        self._gens[slot] = None
        self._prefilling[slot] = {
            "req": req, "pos": pos0, "start": pos0, "t0": t_adm}

    def _advance_prefills(self) -> bool:
        """One engine step's prefill work: round-robin one chunk per
        mid-prefill slot while the scheduler's per-step token budget
        lasts.  Chunk work (padded width) is what the budget meters."""
        chunk = self.prefill_chunk
        budget = self.scheduler.prefill_budget(chunk)
        spent = 0
        progressed = False
        for slot in list(self._prefilling):
            if spent + chunk > budget:
                break
            st = self._prefilling.get(slot)
            if st is None:
                continue
            self._prefill_one_chunk(slot, st)
            spent += chunk
            progressed = True
            if slot in self._prefilling:  # not finished: rotate to back
                self._prefilling[slot] = self._prefilling.pop(slot)
        if spent:
            self.max_prefill_tokens_step = max(
                self.max_prefill_tokens_step, spent)
        return progressed

    def _prefill_one_chunk(self, slot: int, st: dict) -> None:
        P = self.programs
        req: Request = st["req"]
        n = int(req.prompt_ids.size)
        pos = st["pos"]
        # a prefix hit that ends mid-chunk (a page narrower than the
        # chunk) runs one shorter chunk back onto the chunk grid, so
        # every later chunk write stays inside max_len
        c = self.prefill_chunk - pos % self.prefill_chunk
        m = min(c, n - pos)
        toks = np.zeros((1, c), np.int64)
        toks[0, :m] = req.prompt_ids[pos:pos + m]
        with obs.span("serve_prefill_chunk", request=req.id, chunk=c):
            logits = P.chunk_prefill(
                P.params, P.cache,
                torch.as_tensor(toks, device=self.device), slot, pos)
        st["pos"] = pos + m
        self.prefill_tokens_total += m
        obs.inc("serve_prefill_tokens_total", n=m,
                help="prompt tokens actually prefilled (chunked real "
                     "tokens or whole-bucket prompt lengths; prefix "
                     "hits skip theirs)")
        obs.inc("serve_prefill_chunks_total",
                help="chunk-prefill program applications")
        if st["pos"] >= n:
            self._finish_prefill(slot, st, logits, pos)

    def _finish_prefill(self, slot: int, st: dict, logits,
                        last_chunk_pos: int) -> None:
        P = self.programs
        alloc = self.scheduler.allocator
        req: Request = st["req"]
        s = req.sampling
        n = int(req.prompt_ids.size)
        gen = torch.Generator().manual_seed(int(s.seed))
        tok = P.sample_at(logits, n - 1 - last_chunk_pos, gen,
                          s.temperature, s.top_k or 0,
                          1.0 if s.top_p is None else s.top_p)
        now = time.perf_counter()
        req.prefill_s = now - st["t0"]
        req.prefilled_tokens = n - st["start"]
        reqtrace.stage(req.trace_id, "prefill", dur_s=req.prefill_s,
                       request=req.id, chunk=self.prefill_chunk,
                       hit_tokens=st["start"])
        self._start_decoding(req, tok, gen, now)
        if alloc.prefix_enabled:
            ev0, full0 = alloc.prefix_evictions, \
                alloc.prefix_pool_exhausted
            plan = alloc.publish_prefix(req.prompt_ids, n)
            if plan:
                Lp = alloc.page_len
                with obs.span("serve_prefix_publish", request=req.id,
                              pages=len(plan)):
                    for pi, pg in plan:
                        P.publish_page(P.prefix_pool, P.cache, slot,
                                       pi * Lp, pg)
                obs.inc("serve_prefix_published_pages_total",
                        n=len(plan),
                        help="whole prompt pages published into the "
                             "shared pool")
            if alloc.prefix_evictions > ev0:
                obs.inc("serve_prefix_evicted_pages_total",
                        n=alloc.prefix_evictions - ev0,
                        help="pool pages reclaimed by refcount-aware "
                             "LRU eviction")
            if alloc.prefix_pool_exhausted > full0:
                obs.inc("serve_prefix_pool_exhausted_total",
                        n=alloc.prefix_pool_exhausted - full0,
                        help="publications truncated with every pool "
                             "page pinned (evict-while-shared refusal)")
        del self._prefilling[slot]
        if len(req.tokens) >= req.max_new or tok == self._eos[slot]:
            self._finish(req)

    def _finish(self, req: Request) -> None:
        self.completed_count += 1
        if self.retain_results:
            self._results.append(req)
        # the freed slot decodes junk until its next admission: greedy,
        # so it draws from no generator
        self._gens[req.slot] = None
        self._temp[req.slot] = 0.0
        self.scheduler.evict(req, state=DONE)
        if req.tenant:
            # per-tenant SLO breakdown inputs (obs report groups the
            # tenant_* scalars into one table per tenant)
            obs.inc(f"tenant_{req.tenant}_completed_total",
                    help="this tenant's completed requests")
            if req.ttft_s is not None:
                obs.observe(f"tenant_{req.tenant}_ttft_seconds",
                            req.ttft_s,
                            help="this tenant's arrival -> first token")
        if req.first_token_s is not None and req.done_s is not None:
            reqtrace.stage(req.trace_id, "decode",
                           dur_s=max(0.0,
                                     req.done_s - req.first_token_s),
                           request=req.id, tokens=len(req.tokens))
        if req.trace_id:
            reqtrace.stage(req.trace_id, "complete", request=req.id)
            e2e = (req.done_s - req.arrival_s
                   if req.done_s is not None and req.arrival_s is not None
                   else None)
            reqtrace.finish(
                req.trace_id, outcome="complete",
                ttft_s=(round(req.ttft_s, 6)
                        if req.ttft_s is not None else None),
                # the local e2e (submit -> done): the sampled recorder's
                # slowest-K rank key
                e2e_s=(round(e2e, 6) if e2e is not None else None),
                tokens=len(req.tokens))

    def _decode_once(self) -> None:
        if _chaos.active():
            _chaos.maybe_slow_step()  # the "slow replica" fault
        P = self.programs
        t0 = time.perf_counter()
        # inactive slots decode junk under a clamped position; their
        # results are discarded and their cache rows are stale-safe
        pos = np.minimum(self._pos, self.max_len - 1)
        nxt = P.decode(
            P.params, P.cache, torch.as_tensor(self._tok, device=self.device),
            torch.as_tensor(pos, device=self.device), self._gens,
            self._temp, self._topk, self._topp)
        now = time.perf_counter()
        self.steps += 1
        obs.inc("serve_decode_steps_total",
                help="batched continuous-batching decode steps")
        # capture-cadence hook only — decode steps stay out of the
        # train step telemetry (obs.profile)
        obs.profile_step(now - t0)
        for slot, req in list(self.scheduler.running.items()):
            if slot in self._prefilling:
                continue  # mid-chunked-prefill: junk at its parked row
            tok = int(nxt[slot])
            req.tokens.append(tok)
            self.gen_tokens += 1
            gap = now - self._last_token_s[slot]
            req.token_gaps_s.append(gap)
            obs.observe("serve_token_seconds", gap,
                        help="per-token latency (gap between a "
                             "request's successive tokens)")
            if req.tenant:
                obs.observe(f"tenant_{req.tenant}_token_seconds", gap,
                            help="this tenant's per-token latency")
            if self.slo is not None:
                self.slo.on_token(gap)
            self._last_token_s[slot] = now
            self._pos[slot] += 1
            self._tok[slot] = tok
            if len(req.tokens) >= req.max_new or tok == self._eos[slot]:
                self._finish(req)

    def step(self, admit: bool = True) -> bool:
        """One engine iteration: (boundary) admit + prefill, one round of
        prefill chunks, then one batched decode step.  Returns whether
        any work happened."""
        if self._t_first is None:
            self._t_first = time.perf_counter()
        did = False
        if admit:
            for req in self.scheduler.admit():
                if self.prefill_chunk:
                    self._begin_prefill(req)
                else:
                    self._prefill(req)
                did = True
        if self._prefilling:
            did = self._advance_prefills() or did
        if any(s not in self._prefilling for s in self.scheduler.running):
            self._decode_once()
            did = True
        if did:
            self._t_last = time.perf_counter()
        return did

    # -- hot-swap -----------------------------------------------------------

    def request_swap(self, checkpoint_dir: str) -> None:
        """Stage a checkpoint for a step-boundary swap (see the module
        docstring).  Starts the staging thread and returns: safe to call
        from any thread (it makes no CUDA call itself).  The switch
        happens inside :meth:`run`, or via :meth:`maybe_swap` between
        manual :meth:`step` calls."""
        with self._swap_lock:
            if self._pending_swap is not None:
                raise RuntimeError(
                    f"a swap to {self._pending_swap!r} is already staging")
            self._pending_swap = checkpoint_dir
        self._swap_thread = threading.Thread(
            target=self._stage_swap, args=(checkpoint_dir,), daemon=True)
        self._swap_thread.start()

    def _stage_swap(self, path: str) -> None:
        """Background staging: restore, host-to-device copies and the new
        KV cache on this thread's own CUDA stream, synchronized before
        the program set is handed over."""
        try:
            from torchpruner_tpu_torch.checkpoint import restore_checkpoint

            stream = (torch.cuda.Stream(device=self.device)
                      if self.device.type == "cuda" else None)
            ctx = (torch.cuda.stream(stream) if stream is not None
                   else contextlib.nullcontext())
            with ctx, obs.span("serve_swap_compile", checkpoint=path):
                model, params, _state, _opt, meta = restore_checkpoint(
                    path, device=self.device)
                staged = _Programs(
                    model, params, n_slots=self.n_slots,
                    max_len=self.max_len,
                    cache_dtype=self.programs.cache_dtype,
                    device=self.device,
                    meta={**(meta or {}), "checkpoint": path},
                    page_len=self.scheduler.allocator.page_len,
                    prefix_pages=self._prefix_pages,
                    prefill_chunk=self.prefill_chunk)
            if stream is not None:
                stream.synchronize()
            with self._swap_lock:  # handed to the loop thread
                self._staged = staged
        except Exception as e:  # surfaced at the next step boundary
            self._swap_error = e
            with self._swap_lock:
                self._pending_swap = None

    def maybe_swap(self) -> bool:
        """Advance the swap state machine at a step boundary: report a
        failed staging, or switch once the staged programs are ready AND
        the slot array is empty.  Returns True when the switch happened
        this call."""
        if self._swap_error is not None:
            err, self._swap_error = self._swap_error, None
            obs.inc("serve_swap_errors_total",
                    help="hot-swap stagings that failed (bad/corrupt "
                         "checkpoint); serving continues on the old one")
            print(f"[serve] hot-swap failed, keeping current checkpoint: "
                  f"{type(err).__name__}: {err}", file=sys.stderr,
                  flush=True)
        if self._staged is not None and not self.scheduler.running:
            old, new = self.programs, self._staged
            if self.device.type == "cuda":
                # the old set's buffers may be freed from here on: every
                # launch that reads them must have retired
                torch.cuda.current_stream(self.device).synchronize()
            self.programs = new
            # under the lock request_swap tests it with: a request made
            # on an HTTP thread sees the staging state whole
            with self._swap_lock:
                self._staged, self._pending_swap = None, None
            self.swaps_total += 1
            self.decode_kernel = _decode_kernel_active(
                new.model, self.max_len, new.cache_dtype, self.device)
            # pooled prefix K/V was computed under the OLD weights (the
            # slot array is empty here, so nothing is pinned)
            self.scheduler.allocator.reset_prefix()
            self.swap_log.append({
                "old_digest": (old.meta or {}).get("digest"),
                "new_digest": (new.meta or {}).get("digest"),
                "checkpoint": (new.meta or {}).get("checkpoint"),
                "widths": new.model.widths(), "at_step": self.steps})
            obs.inc("serve_swaps_total",
                    help="checkpoint hot-swaps completed")
            obs.record_serve(kind="hot_swap", **self.swap_log[-1])
            return True
        return False

    # -- health -------------------------------------------------------------

    def health_state(self) -> str:
        """Readiness, distinct from liveness: ``ready`` | ``draining``
        (SIGTERM landed / drain begun) | ``staging_swap`` (a checkpoint
        swap is staging) | ``slo_breach`` (a rolling p99 is over its
        threshold).  ``/healthz`` answers 503 for every state but
        ``ready``."""
        if self.scheduler.closed or (
                self._preemption is not None
                and self._preemption.requested):
            return "draining"
        if self._pending_swap is not None:
            return "staging_swap"
        if self.slo is not None and self.slo.in_breach_any():
            return "slo_breach"
        return "ready"

    # -- drain / loop -------------------------------------------------------

    def _snapshot_queue(self, extra: Optional[List[Request]] = None) -> None:
        self.scheduler.close()  # later submissions bounce
        queued = self.scheduler.drain_queue() + list(extra or [])
        for req in queued:
            req.state = DRAINED
            req._event.set()
            if req.trace_id:
                reqtrace.finish(req.trace_id, outcome="drained")
        self.drained.extend(queued)
        if queued:
            obs.inc("serve_drained_total", n=len(queued),
                    help="queued requests snapshotted at drain")
        if self.run_dir:
            from torchpruner_tpu_torch.resilience.manifest import (
                atomic_write_json,
            )

            os.makedirs(self.run_dir, exist_ok=True)
            atomic_write_json(
                os.path.join(self.run_dir, SNAPSHOT_FILENAME),
                {"drained_at": time.time(),
                 "requests": [r.snapshot() for r in queued]})

    def run(self, traffic=None, *, preemption=None,
            stop_event=None) -> dict:
        """The engine loop: pump open-loop traffic, honor preemption
        (drain in-flight, snapshot the queue, exit cleanly), advance the
        hot-swap state machine, and step.  Returns :meth:`summary`,
        whose throughput window covers THIS run."""
        self._t_first = None
        self._t_last = None
        self._window_tokens0 = self.gen_tokens
        self._launches0 = kernel_launches()
        self._preemption = preemption
        draining = False
        while True:
            self.ticks += 1
            if traffic is not None and not draining:
                traffic.pump(self)
            want_stop = (
                (preemption is not None and preemption.requested)
                or (stop_event is not None and stop_event.is_set()))
            if want_stop and not draining:
                draining = True
                # everything not yet in flight — queued requests AND the
                # traffic's not-yet-submitted arrivals — goes into the
                # resubmission snapshot; in-flight work keeps running
                extra = traffic.drain() if traffic is not None and \
                    hasattr(traffic, "drain") else []
                self._snapshot_queue(extra)
            if not draining:
                self.maybe_swap()
            # admissions keep flowing while a swap stages; they stop
            # once the staged programs are ready (drain-then-switch)
            did = self.step(admit=not draining and self._staged is None)
            if self.slo is not None:
                self.slo.maybe_check(self.steps)
            # on-demand capture windows (POST /profile) open and close
            # even while the slot array idles between requests
            obs.profile_tick()
            # windowed time series: the run loop is the engine's clock
            obs.timeseries_tick()
            if not self.scheduler.has_work():
                if draining:
                    break
                if self._pending_swap is not None:
                    # an outstanding swap is work: stay until it lands
                    time.sleep(_IDLE_WAIT_S)
                    continue
                if traffic is not None and traffic.exhausted:
                    break
                if traffic is None and stop_event is None:
                    break
                if not did:
                    time.sleep(_IDLE_WAIT_S)
        if draining:
            obs.inc("serve_preempt_drains_total",
                    help="preemption drains completed")
        return self.summary()

    # -- reporting ----------------------------------------------------------

    def results(self) -> List[Request]:
        return list(self._results)

    def summary(self) -> dict:
        """Headline serving stats.  Counts (requests, admits, evictions,
        swaps) are engine LIFETIME; the throughput window (``gen_tokens``,
        ``wall_s``, ``sustained_gen_tok_s``) and ``kernel_launches`` cover
        the most recent :meth:`run`; latency percentiles come from
        retained results (``None`` with ``retain_results=False``)."""
        done = [r for r in self._results if r.state == DONE]
        wall = ((self._t_last - self._t_first)
                if self._t_first is not None and self._t_last is not None
                else 0.0)
        window_tokens = self.gen_tokens - self._window_tokens0
        ttfts = [r.ttft_s for r in done if r.ttft_s is not None]
        gaps = [g for r in done for g in r.token_gaps_s]

        def pct(xs, q):
            return float(np.percentile(xs, q)) * 1e3 if xs else None

        now = kernel_launches()
        out = {
            "requests_completed": self.completed_count,
            "requests_drained": len(self.drained),
            "decode_steps": self.steps,
            "gen_tokens": window_tokens,
            "wall_s": wall,
            "sustained_gen_tok_s": (window_tokens / wall
                                    if wall > 0 else None),
            "ttft_p50_ms": pct(ttfts, 50),
            "ttft_p99_ms": pct(ttfts, 99),
            "token_p50_ms": pct(gaps, 50),
            "token_p99_ms": pct(gaps, 99),
            "admits": self.scheduler.admitted_total,
            "evictions": self.scheduler.allocator.total_evictions,
            "preemptions": self.scheduler.preempted_total,
            "swaps": self.swaps_total,
            "decode_kernel": self.decode_kernel,
            "prefilled_tokens": self.prefill_tokens_total,
            "device": str(self.device),
            "kernel_launches": {k: now[k] - self._launches0[k]
                                for k in now},
        }
        if self.prefill_chunk:
            out["prefill_chunk"] = self.prefill_chunk
            out["max_prefill_tokens_step"] = self.max_prefill_tokens_step
            out["prefill_token_cap"] = (
                self.scheduler.prefill_budget(self.prefill_chunk)
                if self.prefill_token_cap else 0)
        alloc = self.scheduler.allocator
        if alloc.prefix_enabled:
            hit, computed = alloc.prefix_hit_tokens, \
                self.prefill_tokens_total
            out.update({
                "prefix_hits": alloc.prefix_hits,
                "prefix_misses": alloc.prefix_misses,
                "prefix_hit_tokens": hit,
                # fraction of prompt tokens served from the pool
                "prefix_hit_rate": round(hit / (hit + computed), 4)
                if hit + computed else 0.0,
                "prefix_pool_pages": alloc.prefix_pages,
                "prefix_evictions": alloc.prefix_evictions,
            })
        if self.scheduler.rejected:
            out["rejected"] = dict(self.scheduler.rejected)
        if out["sustained_gen_tok_s"] is not None:
            obs.gauge_set("serve_gen_tokens_per_s",
                          out["sustained_gen_tok_s"],
                          help="sustained generated tokens per second")
        obs.record_serve(
            kind="summary",
            checkpoint_digest=(self.programs.meta or {}).get("digest"),
            **out)
        return out
