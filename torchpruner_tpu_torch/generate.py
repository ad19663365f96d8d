"""Autoregressive decoding with a KV cache — counterpart of
``torchpruner_tpu/generate.py``.

- The cache is a fixed ``(B, max_len, H, Dh)`` buffer per attention
  layer, K/V stored expanded to the query-head count.  The port writes
  each token block into it IN PLACE (the JAX package returns a new
  buffer); attention masks positions past ``pos`` instead of slicing.
- Prefill runs the whole prompt in one forward (causal within the
  block); generation is a host loop of single-token steps, each of which
  launches the decode-attention kernel on CUDA.
- Position-independent layers run through ``core.layers.apply_layer``,
  so decode tracks pruning (pruned widths decode at the pruned shapes).

Sampling: greedy is an exact ``argmax`` (ties go to the first index, as
``jnp.argmax``); temperature sampling draws from a ``torch.Generator``
on the host, one row at a time, so a request replayed alone with the
same generator seed draws the same tokens as inside the serving engine.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from torchpruner_tpu_torch.core import layers as L
from torchpruner_tpu_torch.core.segment import SegmentedModel
from torchpruner_tpu_torch.ops.decode_attention import decode_attention
from torchpruner_tpu_torch.ops.fixed_order import matmul_rows
from torchpruner_tpu_torch.ops.quant import QTensor, oscale, qdot, wval
from torchpruner_tpu_torch.utils.device import resolve_device
from torchpruner_tpu_torch.utils.dtypes import to_dtype

Pos = Union[int, torch.Tensor]


def _attn_layers(layers, prefix=()):
    """Yield (path, spec) for every attention layer, recursing residuals."""
    for spec in layers:
        path = prefix + (spec.name,)
        if isinstance(spec, L.MultiHeadAttention):
            yield path, spec
        elif isinstance(spec, L.Residual):
            yield from _attn_layers(spec.body, path)
            yield from _attn_layers(spec.shortcut, path)


def init_cache(model: SegmentedModel, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> Dict[str, Any]:
    """Zeroed KV buffers for every attention layer, ``(batch, max_len,
    H, Dh)`` each — K/V cached expanded to the query-head count."""
    dev = resolve_device(device)
    dtype = to_dtype(dtype)
    cache: Dict[str, Any] = {}
    for path, spec in _attn_layers(model.layers):
        shape = (batch, max_len, spec.num_heads, spec.head_dim)
        cache["/".join(path)] = {
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
        }
    return cache


def _write_block(buf: torch.Tensor, blk: torch.Tensor, pos: Pos) -> None:
    """Write ``blk (B, s, H, Dh)`` into ``buf`` at ``pos`` (int) or at each
    row's own position (``(B,)`` tensor), in place."""
    s = blk.shape[1]
    blk = blk.to(buf.dtype)
    if isinstance(pos, torch.Tensor) and pos.dim() > 0:
        rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
        cols = pos.to(device=buf.device, dtype=torch.long)[:, None] + \
            torch.arange(s, device=buf.device)[None, :]
        buf[rows, cols] = blk
    else:
        p = int(pos)
        buf[:, p:p + s] = blk


def _decode_attention(spec, params, entry, x, pos: Pos):
    """Attention for a token block ``x (B, s, d)`` against the cache:
    the block's K/V are written at ``pos..pos+s-1`` (per row for a
    ``(B,)`` ``pos``) and attention is causal within the block.  Returns
    ``(y, entry)``; ``entry``'s buffers are updated in place."""
    q = oscale(qdot(x, params["wq"]), params["wq"])
    k = oscale(qdot(x, params["wk"]), params["wk"])
    v = oscale(qdot(x, params["wv"]), params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if spec.rope:
        q = L._rope(q, spec.rope_theta, offset=pos)
        k = L._rope(k, spec.rope_theta, offset=pos)
    if spec.kv_heads != spec.num_heads or spec.kv_group is not None:
        idx = torch.tensor(spec.head_kv_index(), device=k.device)
        k = k.index_select(2, idx)
        v = v.index_select(2, idx)
    _write_block(entry["k"], k, pos)
    _write_block(entry["v"], v, pos)
    ctx = decode_attention(q, entry["k"], entry["v"], pos)
    B, s, H, Dh = ctx.shape
    # the output projection contracts two axes (H, Dh): it consumes the
    # widened weight like the JAX einsum, through the batch-invariant
    # fixed-row product
    wo = wval(params["wo"], ctx.dtype)
    y = matmul_rows(ctx.reshape(B, s, H * Dh), wo.reshape(H * Dh, -1))
    y = oscale(y, params["wo"])
    if "bo" in params:
        y = y + params["bo"]
    return y, entry


def _decode_seq(layers, params, cache, x, pos: Pos, prefix=()):
    """A token block (s = 1 decode step, s = S prompt prefill) through a
    layer sequence in decode mode; returns ``(y, cache)``."""
    for spec in layers:
        path = prefix + (spec.name,)
        key = "/".join(path)
        p = params.get(spec.name, {}) if params else {}
        if isinstance(spec, L.MultiHeadAttention):
            x, cache[key] = _decode_attention(spec, p, cache[key], x, pos)
        elif isinstance(spec, L.Residual):
            y, cache = _decode_seq(spec.body, p, cache, x, pos, path)
            if spec.shortcut:
                sc, cache = _decode_seq(spec.shortcut, p, cache, x, pos,
                                        path)
            else:
                sc = x
            x = y + sc
        else:
            x, _ = L.apply_layer(spec, p, {}, x, fixed_order=True)
    return x, cache


def make_decode_step(model: SegmentedModel):
    """``(params, cache, tok (B, 1), pos int) -> (logits (B, vocab),
    cache)`` — the single-token decode step."""

    @torch.no_grad()
    def step(params, cache, tok, pos):
        x, cache = _decode_seq(model.layers, params, cache, tok, pos)
        return x[:, 0], cache

    return step


def make_slot_decode_step(model: SegmentedModel):
    """``(params, cache, tok (B, 1), pos (B,)) -> (logits (B, vocab),
    cache)`` — the continuous-batching decode step: every slot advances
    one token at its own position.  Each row's logits equal decoding
    that sequence alone, bit for bit: attention reads only positions
    ``<= pos[b]`` of row ``b`` and every other op is batch-invariant."""
    return make_decode_step(model)


def params_device(params) -> Optional[torch.device]:
    """The device of the first tensor in a params tree."""
    if isinstance(params, torch.Tensor):
        return params.device
    if isinstance(params, QTensor):
        return params.device
    if isinstance(params, dict):
        for v in params.values():
            d = params_device(v)
            if d is not None:
                return d
    return None


def check_params_device(params, device: torch.device) -> None:
    got = params_device(params)
    if got is not None and got.type != device.type:
        raise ValueError(f"params live on {got}, the call asked for "
                         f"{device}")


def _truncate_logits(logits: torch.Tensor, top_k: Optional[int],
                     top_p: Optional[float]) -> torch.Tensor:
    """Mask logits outside the top-k set / the top-p nucleus to the
    dtype's minimum."""
    neg = torch.finfo(logits.dtype).min
    if top_k is not None and top_k < logits.shape[-1]:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits >= kth, logits, neg)
    if top_p is not None and top_p < 1.0:
        sorted_ = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_, dim=-1)
        csum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with mass >= top_p: a token stays if
        # the mass BEFORE it is < top_p
        keep_sorted = (csum - probs) < top_p
        thresh = torch.where(keep_sorted, sorted_,
                             torch.full_like(sorted_, float("inf"))
                             ).amin(dim=-1, keepdim=True)
        logits = torch.where(logits >= thresh, logits, neg)
    return logits


def sample_row(logits: torch.Tensor, gen: torch.Generator,
               temperature: float, top_k: Optional[int],
               top_p: Optional[float]) -> int:
    """One token from one row of logits: temperature FIRST (the nucleus
    must reflect the distribution sampled from), then top-k / top-p,
    then a categorical draw on the host from ``gen``."""
    row = logits.detach().float().cpu() / float(temperature)
    trunc = _truncate_logits(row, top_k, top_p)
    probs = torch.softmax(trunc.double(), dim=-1)
    return int(torch.multinomial(probs, 1, generator=gen))


def _sample(logits: torch.Tensor, gen: torch.Generator, temperature: float,
            top_k: Optional[int], top_p: Optional[float]) -> torch.Tensor:
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    toks = [sample_row(logits[b], gen, temperature, top_k, top_p)
            for b in range(logits.shape[0])]
    return torch.tensor(toks, device=logits.device)


def generate(
    model: SegmentedModel,
    params,
    prompt: Union[np.ndarray, Sequence, torch.Tensor],
    n_new: int,
    *,
    max_len: Optional[int] = None,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    rng: Optional[torch.Generator] = None,
    cache_dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """Sample ``n_new`` tokens after ``prompt`` (B, S): returns
    ``(B, n_new)`` int64 on ``device`` (``None`` = ``cuda``; ``params``
    must already live there).  Greedy at ``temperature=0``, else softmax
    sampling from ``rng`` (a CPU ``torch.Generator``; seed 0 when
    omitted), optionally truncated to ``top_k`` / the ``top_p``
    nucleus."""
    dev = resolve_device(device)
    check_params_device(params, dev)
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                             device=dev)
    B, S = prompt.shape
    total = S + n_new
    max_len = max_len or total
    if max_len < total:
        raise ValueError(f"max_len {max_len} < prompt + n_new = {total}")
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not (0.0 < top_p <= 1.0):
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    gen = rng if rng is not None else torch.Generator().manual_seed(0)
    cache = init_cache(model, B, max_len, cache_dtype, device=dev)
    toks: List[torch.Tensor] = []
    with torch.no_grad():
        x, cache = _decode_seq(model.layers, params, cache, prompt, 0)
        logits = x[:, -1]
        for i in range(n_new):
            tok = _sample(logits, gen, temperature, top_k, top_p)
            toks.append(tok)
            if i + 1 < n_new:  # the last token needs no further step
                x, cache = _decode_seq(model.layers, params, cache,
                                       tok[:, None], S + i)
                logits = x[:, 0]
    return torch.stack(toks, dim=1)
