"""The continuous-batching inference engine — counterpart of
``torchpruner_tpu/serve/engine.py``.

One :class:`ServeEngine` owns a fixed ``n_slots``-wide slot array, one
``(n_slots, max_len, H, Dh)`` KV cache per attention layer, and three
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

``--verify`` replays every request alone through ``generate`` and asks
for the same tokens, bit for bit.  That holds because every row's
computation is batch-invariant (``ops/fixed_order.py``, the kernels'
fixed reduction orders) and independent of the prompt bucket and the
cache length beyond the row's own positions.

Left for later slices (the JAX engine has them): chunked prefill, prefix
pages, checkpoint hot-swap, SIGTERM drain, SLO monitoring, the
cost-model twin and the telemetry plane.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from torchpruner_tpu_torch.generate import (
    _attn_layers,
    _decode_seq,
    check_params_device,
    init_cache,
    sample_row,
)
from torchpruner_tpu_torch.serve.allocator import (
    KVCacheAllocator,
    bucket_for,
    prefill_buckets,
)
from torchpruner_tpu_torch.serve.request import DONE, Request
from torchpruner_tpu_torch.serve.scheduler import Scheduler
from torchpruner_tpu_torch.utils.device import resolve_device
from torchpruner_tpu_torch.utils.dtypes import to_dtype


def vocab_of(model) -> int:
    """The model's token-id space (its Embedding layer's vocab)."""
    from torchpruner_tpu_torch.core import layers as L

    for spec in model.layers:
        if isinstance(spec, L.Embedding):
            return int(spec.vocab_size)
    return 256


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
        logits = x[0, true_len - 1][None]  # the last REAL position
        tok = sample_tokens(logits, [gen], np.asarray([temp], np.float32),
                            np.asarray([top_k]), np.asarray([top_p]))[0]
        return int(tok), cache

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


class _Programs:
    """One checkpoint's serving surface: model + params + serving cache +
    the three step functions."""

    def __init__(self, model, params, *, n_slots: int, max_len: int,
                 cache_dtype, device):
        self.model, self.params = model, params
        self.n_slots, self.max_len = n_slots, max_len
        self.cache_dtype, self.device = cache_dtype, device
        self.cache = init_cache(model, n_slots, max_len, cache_dtype,
                                device=device)
        self.decode = make_serve_step(model)
        self.insert = make_insert()
        self.buckets = prefill_buckets(max_len)
        self._prefills: Dict[int, Any] = {}

    def prefill_for(self, bucket: int):
        fn = self._prefills.get(bucket)
        if fn is None:
            fn = self._prefills[bucket] = make_prefill(
                self.model, bucket, self.cache_dtype, self.device)
        return fn


class ServeEngine:
    """Continuous-batching serving over one model/params bundle on
    ``device`` (``None`` = ``cuda``; ``params`` must already live there).
    ``qos`` is the scheduler's multi-tenant table (serve.qos; ``None`` =
    one FIFO).  See the module docstring."""

    def __init__(self, model, params, *, n_slots: int = 4,
                 max_len: int = 256, cache_dtype=None, device=None,
                 qos=None):
        if getattr(model, "input_dtype", None) != "int32":
            raise ValueError(
                "ServeEngine serves token-sequence (LM) models; "
                f"got input_dtype={getattr(model, 'input_dtype', None)!r}")
        self.device = resolve_device(device)
        check_params_device(params, self.device)
        cache_dtype = torch.float32 if cache_dtype is None \
            else to_dtype(cache_dtype)
        allocator = KVCacheAllocator(n_slots, max_len)
        self.programs = _Programs(
            model, params, n_slots=n_slots, max_len=max_len,
            cache_dtype=cache_dtype, device=self.device)
        from torchpruner_tpu_torch.ops import decode_attention as _da

        head_dim = next((int(spec.head_dim)
                         for _, spec in _attn_layers(model.layers)), 0)
        #: whether decode steps launch the decode-attention kernel
        self.decode_kernel = bool(head_dim and _da.kernel_active(
            max_len, head_dim, cache_dtype, self.device))
        self.scheduler = Scheduler(allocator, qos=qos)
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
        self.prefill_tokens_total = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._window_tokens0 = 0
        self.completed_count = 0
        self._results: List[Request] = []

    @property
    def model(self):
        return self.programs.model

    @property
    def params(self):
        return self.programs.params

    def submit(self, request: Request,
               arrival_s: Optional[float] = None) -> Request:
        if request.total_len > self.max_len:
            raise ValueError(
                f"request needs {request.total_len} cache positions "
                f"(prompt {request.prompt_ids.size} + max_new "
                f"{request.max_new}) > engine max_len {self.max_len}")
        request.sampling.validate(0)
        return self.scheduler.submit(request, arrival_s=arrival_s)

    # -- the step-boundary machine -----------------------------------------

    def _prefill(self, req: Request) -> None:
        P = self.programs
        slot = req.slot
        n = int(req.prompt_ids.size)
        bucket = bucket_for(n, P.buckets)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :n] = req.prompt_ids
        s = req.sampling
        t_adm = time.perf_counter()
        gen = torch.Generator().manual_seed(int(s.seed))
        tok, small = P.prefill_for(bucket)(
            P.params, torch.as_tensor(padded, device=self.device), n, gen,
            s.temperature, s.top_k or 0,
            1.0 if s.top_p is None else s.top_p)
        P.insert(P.cache, small, slot)
        now = time.perf_counter()
        req.first_token_s = now
        req.prefill_s = now - t_adm
        req.tokens.append(tok)
        self.gen_tokens += 1
        req.prefilled_tokens = n
        self.prefill_tokens_total += n
        self._pos[slot] = n  # next write position
        self._tok[slot] = tok
        self._temp[slot] = s.temperature
        self._topk[slot] = s.top_k or 0
        self._topp[slot] = 1.0 if s.top_p is None else s.top_p
        self._eos[slot] = -1 if req.eos_id is None else req.eos_id
        self._last_token_s[slot] = now
        self._gens[slot] = gen
        if len(req.tokens) >= req.max_new or tok == self._eos[slot]:
            self._finish(req)

    def _finish(self, req: Request) -> None:
        self.completed_count += 1
        self._results.append(req)
        # the freed slot decodes junk until its next admission: greedy,
        # so it draws from no generator
        self._gens[req.slot] = None
        self._temp[req.slot] = 0.0
        self.scheduler.evict(req, state=DONE)

    def _decode_once(self) -> None:
        P = self.programs
        # inactive slots decode junk under a clamped position; their
        # results are discarded and their cache rows are stale-safe
        pos = np.minimum(self._pos, self.max_len - 1)
        nxt = P.decode(
            P.params, P.cache, torch.as_tensor(self._tok, device=self.device),
            torch.as_tensor(pos, device=self.device), self._gens,
            self._temp, self._topk, self._topp)
        now = time.perf_counter()
        self.steps += 1
        for slot, req in list(self.scheduler.running.items()):
            tok = int(nxt[slot])
            req.tokens.append(tok)
            self.gen_tokens += 1
            req.token_gaps_s.append(now - self._last_token_s[slot])
            self._last_token_s[slot] = now
            self._pos[slot] += 1
            self._tok[slot] = tok
            if len(req.tokens) >= req.max_new or tok == self._eos[slot]:
                self._finish(req)

    def step(self, admit: bool = True) -> bool:
        """One engine iteration: (boundary) admit + prefill, then one
        batched decode step.  Returns whether any work happened."""
        if self._t_first is None:
            self._t_first = time.perf_counter()
        did = False
        if admit:
            for req in self.scheduler.admit():
                self._prefill(req)
                did = True
        if self.scheduler.running:
            self._decode_once()
            did = True
        if did:
            self._t_last = time.perf_counter()
        return did

    def run(self, traffic=None, *, idle_wait_s: float = 5e-4) -> dict:
        """The engine loop: pump open-loop traffic and step until the
        work (and the traffic) is exhausted.  Returns :meth:`summary`,
        whose throughput window covers THIS run."""
        self._t_first = None
        self._t_last = None
        self._window_tokens0 = self.gen_tokens
        while True:
            self.ticks += 1
            if traffic is not None:
                traffic.pump(self)
            did = self.step()
            if not self.scheduler.has_work() and (
                    traffic is None or traffic.exhausted):
                break
            if not did:
                time.sleep(idle_wait_s)
        return self.summary()

    # -- reporting ----------------------------------------------------------

    def results(self) -> List[Request]:
        return list(self._results)

    def summary(self) -> dict:
        """Headline serving stats: lifetime counts, and throughput /
        latency percentiles over the most recent :meth:`run`."""
        done = [r for r in self._results if r.state == DONE]
        wall = ((self._t_last - self._t_first)
                if self._t_first is not None and self._t_last is not None
                else 0.0)
        window_tokens = self.gen_tokens - self._window_tokens0
        ttfts = [r.ttft_s for r in done if r.ttft_s is not None]
        gaps = [g for r in done for g in r.token_gaps_s]

        def pct(xs, q):
            return float(np.percentile(xs, q)) * 1e3 if xs else None

        return {
            "requests_completed": self.completed_count,
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
            "decode_kernel": self.decode_kernel,
            "prefilled_tokens": self.prefill_tokens_total,
            "device": str(self.device),
        }
