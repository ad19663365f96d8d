"""Layer specifications and their init/apply rules.

Counterpart of ``torchpruner_tpu/core/layers.py``: the same frozen spec
dataclasses with the same field names, and the same parameter layouts
(Dense ``w (in, out)``; attention ``wq (d, H, Dh)``, ``wk``/``wv
(d, KV, Dh)``, ``wo (H, Dh, d_out)``; GatedDense ``wg``/``wu (in,
features)``; Embedding ``emb (vocab, features)``; PosEmbed ``emb
(max_len, features)``; ClsToken ``tok (features,)``; Conv ``w`` HWIO
``(kh, kw, in, out)``, permuted to OIHW only inside its apply rule;
norm ``scale``/``bias``).  Parameters are nested dicts of tensors, one
level per composite block.  BatchNorm's running statistics ``mean`` /
``var`` are the one mutable state, a tree of the same shape beside the
params; every apply rule returns ``(y, state)``.

Activations are channels-last: ``(B, S, d)`` sequences and ``(B, H, W,
C)`` images.  Two evaluation orders, chosen per call by the
``fixed_order`` argument of :func:`apply_layer`:

- ``fixed_order=True`` (the KV-cache path of ``generate`` and
  ``serve``): plain products and row reductions run on fixed-size row
  chunks (``ops/fixed_order.py``), so a row's result does not depend on
  the batch it shares — what the serve ``--verify`` bit identity rests
  on;
- ``fixed_order=False`` (the full-sequence path of
  ``SegmentedModel.apply``: scoring, training, evaluation): plain
  products and reductions on the whole tensor.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from torchpruner_tpu_torch.ops.blocksparse import BlockSparseWeight
from torchpruner_tpu_torch.ops.fixed_order import per_rows
from torchpruner_tpu_torch.ops.quant import QTensor, oscale, qdot, wval
from torchpruner_tpu_torch.utils.device import resolve_device

# ---------------------------------------------------------------------------
# Layer specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Dense:
    """Fully-connected layer. Prunable (out units = features)."""

    name: str
    features: int
    use_bias: bool = True


@dataclass(frozen=True)
class Conv:
    """2-D convolution, NHWC/HWIO. Prunable (out units = channels).
    ``padding`` is XLA's: ``"SAME"`` (output ``ceil(in / stride)``, the
    odd pad row or column at the high end) or ``"VALID"``."""

    name: str
    features: int
    kernel_size: Tuple[int, int] = (3, 3)
    strides: Tuple[int, int] = (1, 1)
    padding: str = "SAME"
    use_bias: bool = True


@dataclass(frozen=True)
class BatchNorm:
    """Batch normalization over the last axis, with functional running
    statistics: ``new_running = decay * running + (1 - decay) *
    batch_stat``, the batch variance biased in both (``jnp.var``)."""

    name: str
    decay: float = 0.9
    eps: float = 1e-5


@dataclass(frozen=True)
class LayerNorm:
    """Layer normalization over the last axis (transformer blocks)."""

    name: str
    eps: float = 1e-5
    use_bias: bool = True


@dataclass(frozen=True)
class RMSNorm:
    """RMS normalization over the last axis (Llama-family blocks)."""

    name: str
    eps: float = 1e-6


#: activation functions, matching the JAX package's registry (``gelu`` is
#: jax.nn.gelu's default tanh approximation)
ACTIVATION_FNS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "relu6": F.relu6,
    "leaky_relu": F.leaky_relu,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "identity": lambda x: x,
}


@dataclass(frozen=True)
class Activation:
    name: str
    fn: str = "relu"

    def __post_init__(self):
        if self.fn not in ACTIVATION_FNS:
            raise ValueError(f"unknown activation {self.fn!r}")


@dataclass(frozen=True)
class Pool:
    """2-D max/avg pooling on NHWC; ``padding`` is XLA's (``"SAME"`` pads
    the odd row or column high; max pads with -inf, avg divides by the
    count of valid elements)."""

    name: str
    kind: str = "max"
    window: Tuple[int, int] = (2, 2)
    strides: Optional[Tuple[int, int]] = None  # None = window
    padding: str = "VALID"


@dataclass(frozen=True)
class GlobalPool:
    """Global pooling / token selection: ``"avg"`` (NHWC -> (B, C)),
    ``"seq_mean"`` ((B, S, D) -> (B, D) mean over the sequence) or
    ``"cls"`` ((B, S, D) -> (B, D) first-token select)."""

    name: str
    kind: str = "avg"


@dataclass(frozen=True)
class Flatten:
    """Flatten the non-batch axes row-major: ``(B, H, W, C) -> (B,
    H*W*C)``, so channel ``c`` lands at ``{p * C + c}`` (the fan-out map
    of a pruned conv channel into a Dense consumer)."""

    name: str


@dataclass(frozen=True)
class Reshape:
    """Reshape non-batch dims to ``shape`` (one ``-1`` allowed), e.g. the
    ViT patch grid to a token sequence ``(B, h, w, C) -> (B, h*w, C)``."""

    name: str
    shape: Tuple[int, ...]


@dataclass(frozen=True)
class Dropout:
    """Dropout. ``rate`` is the drop probability; rescaled on pruning so
    the expected number of active units is preserved."""

    name: str
    rate: float = 0.5


@dataclass(frozen=True)
class Embedding:
    """Token embedding lookup: int tokens ``(..., S)`` -> ``(..., S, d)``."""

    name: str
    vocab_size: int
    features: int


@dataclass(frozen=True)
class PosEmbed:
    """Learned positional embedding added to a ``(B, S, d)`` sequence."""

    name: str
    max_len: int


@dataclass(frozen=True)
class ClsToken:
    """Prepend a learned classification token: ``(B, S, d) -> (B, S+1,
    d)`` (pair with ``GlobalPool(..., "cls")`` at the head)."""

    name: str


@dataclass(frozen=True)
class MultiHeadAttention:
    """Multi-head (optionally grouped-query) self-attention on ``(B, S, d)``.

    Prunable: the unit is the query head; its unit site is the
    pre-output-projection head context, exposed to taps in ``(B, S, Dh,
    H)`` layout (head axis last).  ``impl``: ``"auto"``/``"flash"`` (the
    flash kernels on CUDA, their plain version on the CPU) or ``"xla"``
    (the plain einsum core)."""

    name: str
    num_heads: int
    head_dim: int
    num_kv_heads: Optional[int] = None  # None -> num_heads
    out_features: Optional[int] = None  # None -> input width
    causal: bool = False
    rope: bool = False
    rope_theta: float = 10000.0
    use_bias: bool = False
    impl: str = "auto"
    #: per-query-head KV-head assignment (set by head pruning); None =
    #: uniform grouping h -> h // (H / KV)
    kv_group: Optional[Tuple[int, ...]] = None

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads if self.num_kv_heads is not None \
            else self.num_heads

    def head_kv_index(self) -> Tuple[int, ...]:
        """KV head consumed by each query head."""
        if self.kv_group is not None:
            return self.kv_group
        rep = self.num_heads // self.kv_heads
        return tuple(h // rep for h in range(self.num_heads))


@dataclass(frozen=True)
class GatedDense:
    """Gated linear unit ``act(x @ wg) * (x @ wu)`` (SwiGLU with
    ``fn="silu"``).  Prunable (out units = features)."""

    name: str
    features: int
    fn: str = "silu"
    use_bias: bool = False

    def __post_init__(self):
        if self.fn not in ACTIVATION_FNS:
            raise ValueError(f"unknown activation {self.fn!r}")


@dataclass(frozen=True)
class Residual:
    """Residual block: ``y = body(x) + shortcut(x)`` (identity shortcut
    when ``shortcut`` is empty); children addressed ``"res/child"``."""

    name: str
    body: Tuple[Any, ...]
    shortcut: Tuple[Any, ...] = ()

    def __post_init__(self):
        names = [l.name for l in self.body] + [l.name for l in self.shortcut]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate child names in Residual {self.name!r}")


LayerSpec = Any
#: can be out-pruned (the JAX package's set, restricted to the port's specs)
PRUNABLE_TYPES = (Dense, Conv, GatedDense, MultiHeadAttention)
#: in-pruned alongside a producer
ATTACHABLE_TYPES = (BatchNorm, Dropout, LayerNorm, RMSNorm)
COMPOSITE_TYPES = (Residual,)

# ---------------------------------------------------------------------------
# Shapes and init
# ---------------------------------------------------------------------------


def _reshape_target(shape: Tuple[int, ...], in_shape: Tuple[int, ...]
                    ) -> Tuple[int, ...]:
    size = math.prod(in_shape)
    if shape.count(-1) > 1:
        raise ValueError(f"Reshape allows one -1, got {shape}")
    if -1 in shape:
        known = math.prod(d for d in shape if d != -1)
        if size % known:
            raise ValueError(f"cannot reshape {in_shape} to {shape}")
        return tuple(size // known if d == -1 else d for d in shape)
    return tuple(shape)


def _conv_out_hw(hw, spec: Conv) -> Tuple[int, int]:
    (h, w), (sh, sw) = hw, spec.strides
    if spec.padding == "SAME":
        return -(-h // sh), -(-w // sw)
    kh, kw = spec.kernel_size
    return (h - kh) // sh + 1, (w - kw) // sw + 1


def out_shape(spec: LayerSpec, in_shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Per-layer output shape (batch dim excluded)."""
    if isinstance(spec, (Dense, GatedDense)):
        return tuple(in_shape[:-1]) + (spec.features,)
    if isinstance(spec, Conv):
        return _conv_out_hw(in_shape[:2], spec) + (spec.features,)
    if isinstance(spec, Pool):
        (h, w), (sh, sw) = in_shape[:2], spec.strides or spec.window
        if spec.padding == "SAME":
            return (-(-h // sh), -(-w // sw)) + tuple(in_shape[2:])
        kh, kw = spec.window
        return ((h - kh) // sh + 1, (w - kw) // sw + 1) + tuple(in_shape[2:])
    if isinstance(spec, Flatten):
        return (math.prod(in_shape),)
    if isinstance(spec, Reshape):
        return _reshape_target(spec.shape, in_shape)
    if isinstance(spec, ClsToken):
        return (in_shape[0] + 1,) + tuple(in_shape[1:])
    if isinstance(spec, Embedding):
        return tuple(in_shape) + (spec.features,)
    if isinstance(spec, GlobalPool):
        return (in_shape[-1],)
    if isinstance(spec, MultiHeadAttention):
        d_out = spec.out_features if spec.out_features is not None \
            else in_shape[-1]
        return tuple(in_shape[:-1]) + (d_out,)
    if isinstance(spec, Residual):
        return seq_out_shape(spec.body, in_shape)
    return tuple(in_shape)


def seq_out_shape(layers, in_shape: Tuple[int, ...]) -> Tuple[int, ...]:
    shape = tuple(in_shape)
    for spec in layers:
        shape = out_shape(spec, shape)
    return shape


def seq_shapes(layers, in_shape: Tuple[int, ...]):
    """Per-layer ``(in_shape, out_shape)`` for a sequential pipeline."""
    out = []
    shape = tuple(in_shape)
    for spec in layers:
        o = out_shape(spec, shape)
        out.append((shape, o))
        shape = o
    return tuple(out)


def unit_site_shape(spec: LayerSpec, in_shape: Tuple[int, ...]
                    ) -> Tuple[int, ...]:
    """Per-example shape of the activation at a layer's unit site — the
    tensor taps act on, unit axis last: the output, except attention's
    head context ``(S, Dh, H)``."""
    if isinstance(spec, MultiHeadAttention):
        return (in_shape[0], spec.head_dim, spec.num_heads)
    return out_shape(spec, in_shape)


def param_shapes(spec: LayerSpec, in_shape: Tuple[int, ...]
                 ) -> Dict[str, Any]:
    """``{param name: shape}`` for one layer (nested for composites) —
    what :func:`init_layer` fills; also lets a builder create the tree
    leaf by leaf without materializing it first."""
    if isinstance(spec, Dense):
        out = {"w": (in_shape[-1], spec.features)}
        if spec.use_bias:
            out["b"] = (spec.features,)
        return out
    if isinstance(spec, Conv):
        if len(in_shape) != 3:
            raise ValueError(f"Conv {spec.name!r} expects HWC input, got "
                             f"shape {in_shape}")
        kh, kw = spec.kernel_size
        out = {"w": (kh, kw, in_shape[-1], spec.features)}
        if spec.use_bias:
            out["b"] = (spec.features,)
        return out
    if isinstance(spec, ClsToken):
        return {"tok": (in_shape[-1],)}
    if isinstance(spec, BatchNorm):
        return {"scale": (in_shape[-1],), "bias": (in_shape[-1],)}
    if isinstance(spec, LayerNorm):
        out = {"scale": (in_shape[-1],)}
        if spec.use_bias:
            out["bias"] = (in_shape[-1],)
        return out
    if isinstance(spec, RMSNorm):
        return {"scale": (in_shape[-1],)}
    if isinstance(spec, Embedding):
        return {"emb": (spec.vocab_size, spec.features)}
    if isinstance(spec, PosEmbed):
        if in_shape[0] > spec.max_len:
            raise ValueError(
                f"PosEmbed {spec.name!r}: sequence {in_shape[0]} exceeds "
                f"max_len {spec.max_len}")
        return {"emb": (spec.max_len, in_shape[-1])}
    if isinstance(spec, MultiHeadAttention):
        d = in_shape[-1]
        H, KV, Dh = spec.num_heads, spec.kv_heads, spec.head_dim
        if H % KV:
            raise ValueError(f"MHA {spec.name!r}: num_heads {H} not "
                             f"divisible by num_kv_heads {KV}")
        d_out = spec.out_features if spec.out_features is not None else d
        out = {"wq": (d, H, Dh), "wk": (d, KV, Dh), "wv": (d, KV, Dh),
               "wo": (H, Dh, d_out)}
        if spec.use_bias:
            out.update(bq=(H, Dh), bk=(KV, Dh), bv=(KV, Dh), bo=(d_out,))
        return out
    if isinstance(spec, GatedDense):
        out = {"wg": (in_shape[-1], spec.features),
               "wu": (in_shape[-1], spec.features)}
        if spec.use_bias:
            out.update(bg=(spec.features,), bu=(spec.features,))
        return out
    if isinstance(spec, Residual):
        out: Dict[str, Any] = {}
        for branch in (spec.body, spec.shortcut):
            shape = tuple(in_shape)
            for child in branch:
                p = param_shapes(child, shape)
                if p:
                    out[child.name] = p
                shape = out_shape(child, shape)
        return out
    if isinstance(spec, (Activation, Pool, GlobalPool, Flatten, Dropout,
                         Reshape)):
        return {}
    raise TypeError(f"unknown layer spec {type(spec)}")


def state_shapes(spec: LayerSpec, in_shape: Tuple[int, ...]
                 ) -> Dict[str, Any]:
    """``{state name: shape}`` for one layer (nested for composites):
    BatchNorm's running ``mean`` / ``var``, empty elsewhere."""
    if isinstance(spec, BatchNorm):
        return {"mean": (in_shape[-1],), "var": (in_shape[-1],)}
    if isinstance(spec, Residual):
        out: Dict[str, Any] = {}
        for branch in (spec.body, spec.shortcut):
            shape = tuple(in_shape)
            for child in branch:
                s = state_shapes(child, shape)
                if s:
                    out[child.name] = s
                shape = out_shape(child, shape)
        return out
    return {}


def init_state(spec: LayerSpec, in_shape: Tuple[int, ...],
               dtype=torch.float32, device=None) -> Dict[str, Any]:
    """One layer's initial state: running ``mean`` 0 and ``var`` 1."""
    device = resolve_device(device)

    def fill(name, shape):
        if isinstance(shape, dict):
            return {k: fill(k, v) for k, v in shape.items()}
        value = 1.0 if name == "var" else 0.0
        return torch.full(shape, value, dtype=dtype, device=device)

    return {k: fill(k, v) for k, v in state_shapes(spec, in_shape).items()}


def init_layer(spec: LayerSpec, gen: torch.Generator,
               in_shape: Tuple[int, ...], dtype=torch.float32,
               device=None):
    """Initialize one layer: ``(params, out_shape)``.  The JAX package's
    scales (Kaiming normal for Dense/GatedDense/Conv, ``0.02`` normal
    embeddings and CLS token, ``1/sqrt(fan)`` attention), drawn from
    ``gen`` on the generator's device and moved to ``device`` (``None``
    = ``cuda``; raises without a GPU unless ``device="cpu"``)."""
    device = resolve_device(device)

    def normal(shape, std):
        t = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * std
        return t.to(device=device, dtype=dtype)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    shapes = param_shapes(spec, in_shape)
    if isinstance(spec, Residual):
        params: Dict[str, Any] = {}
        for branch in (spec.body, spec.shortcut):
            shape = tuple(in_shape)
            for child in branch:
                p, shape = init_layer(child, gen, shape, dtype, device)
                if p:
                    params[child.name] = p
        return params, out_shape(spec, in_shape)
    params = {}
    for pname, shp in shapes.items():
        if pname == "scale":
            params[pname] = torch.ones(shp, dtype=dtype, device=device)
        elif pname.startswith("b"):
            params[pname] = zeros(shp)
        elif isinstance(spec, (Embedding, PosEmbed, ClsToken)):
            params[pname] = normal(shp, 0.02)
        elif isinstance(spec, Conv):  # Kaiming normal over kh * kw * in
            params[pname] = normal(shp, math.sqrt(2.0 / math.prod(shp[:3])))
        elif isinstance(spec, MultiHeadAttention):
            fan = shp[0] if pname != "wo" else shp[0] * shp[1]
            params[pname] = normal(shp, 1.0 / math.sqrt(fan))
        else:  # Dense / GatedDense: Kaiming normal
            params[pname] = normal(shp, math.sqrt(2.0 / shp[0]))
    return params, out_shape(spec, in_shape)


# ---------------------------------------------------------------------------
# Taps — attribution instrumentation addressed by site path
# ---------------------------------------------------------------------------


def parse_path(name) -> Tuple[str, ...]:
    """``"block/child"`` -> ``("block", "child")``; tuples pass through."""
    if isinstance(name, tuple):
        return name
    return tuple(name.split("/"))


class Taps:
    """Per-call instrumentation: unit masking, additive perturbation and
    activation capture at named sites (paths).  ``multi_capture``
    records every listed site into ``captures`` in one forward."""

    __slots__ = ("unit_mask", "perturb", "capture", "captured",
                 "multi_capture", "captures")

    def __init__(self, unit_mask=None, perturb=None, capture=None,
                 multi_capture=()):
        self.unit_mask = (None if unit_mask is None
                          else (parse_path(unit_mask[0]), unit_mask[1]))
        self.perturb = (None if perturb is None
                        else (parse_path(perturb[0]), perturb[1]))
        self.capture = None if capture is None else parse_path(capture)
        self.captured = None
        self.multi_capture = frozenset(parse_path(p) for p in multi_capture)
        self.captures: Dict[str, torch.Tensor] = {}

    def empty(self) -> bool:
        return (self.unit_mask is None and self.perturb is None
                and self.capture is None and not self.multi_capture)

    def at_site(self, path: Tuple[str, ...], y: torch.Tensor):
        """Apply mask/perturb and record capture if ``path`` is a tap
        site.  ``y`` must have the unit axis last.  A unit mask is one
        ``(n,)`` vector for every row, or one ``(rows, n)`` row per
        example, broadcast over the site's middle axes."""
        if self.unit_mask is not None and self.unit_mask[0] == path:
            mask = self.unit_mask[1]
            if mask.ndim == 2:
                mask = mask.reshape((mask.shape[0],) + (1,) * (y.ndim - 2)
                                    + (mask.shape[1],))
            y = y * mask
        if self.perturb is not None and self.perturb[0] == path:
            y = y + self.perturb[1]
        if self.capture == path:
            self.captured = y
        if path in self.multi_capture:
            self.captures["/".join(path)] = y
        return y


# ---------------------------------------------------------------------------
# apply rules: (spec, params, state, x, train, rng, taps, path) -> (y, state)
# ---------------------------------------------------------------------------


def apply_seq(layers, params, state, x, *, train: bool = False,
              rng: Optional[torch.Generator] = None,
              taps: Optional[Taps] = None, prefix: Tuple[str, ...] = (),
              fixed_order: bool = False):
    """Run a sequential pipeline of layers, applying output-site taps
    after every non-attention layer (attention taps its own head site).
    ``rng`` feeds every train-mode Dropout in order.  Returns ``(y,
    new_state)``: ``state`` with the entries train mode rewrote."""
    state = state if state is not None else {}
    new_state = dict(state)
    for spec in layers:
        p = params.get(spec.name, {}) if params else {}
        s = state.get(spec.name, {})
        path = prefix + (spec.name,)
        x, s2 = apply_layer(spec, p, s, x, train=train, rng=rng, taps=taps,
                            path=path, fixed_order=fixed_order)
        if (taps is not None and not taps.empty()
                and not isinstance(spec, MultiHeadAttention)):
            x = taps.at_site(path, x)
        if s2 is not s and s2:
            new_state[spec.name] = s2
    return x, new_state


def _rope(x: torch.Tensor, theta: float, offset=0) -> torch.Tensor:
    """Rotary position embedding on ``(B, S, H, Dh)``.  ``offset`` shifts
    the absolute positions: an int for every row, or a ``(B,)`` tensor
    giving each row its own shift (the continuous-batching slot array)."""
    S, Dh = x.shape[1], x.shape[-1]
    half = Dh // 2
    dev = x.device
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=dev) / half)
    if isinstance(offset, torch.Tensor) and offset.dim() > 0:
        pos = (offset.to(device=dev, dtype=torch.float32)[:, None]
               + torch.arange(S, dtype=torch.float32, device=dev)[None, :])
        ang = pos[..., None] * freqs                     # (B, S, half)
        cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
        sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    else:
        pos = float(offset) + torch.arange(S, dtype=torch.float32,
                                           device=dev)
        ang = pos[:, None] * freqs[None, :]              # (S, half)
        cos = torch.cos(ang)[None, :, None, :].to(x.dtype)
        sin = torch.sin(ang)[None, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


#: The JAX package's ``impl="auto"`` takes its flash kernel only at
#: S >= 4096 (``FLASH_AUTO_MIN_S``), a crossover measured on a TPU v5e.
#: It is not carried over: on CUDA ``"auto"`` always takes the flash
#: kernels.  Where the H100's own crossover against a plain core lies is
#: open (ROADMAP).


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, impl: str = "auto") -> torch.Tensor:
    """Scaled-dot-product attention on ``(B, S, H, Dh)`` tensors (K/V
    already expanded to H heads).  ``"auto"``/``"flash"``:
    :func:`~torchpruner_tpu_torch.ops.flash_attention.flash_attention`
    (the CUDA kernels on the card, the plain version on the CPU);
    ``"xla"``: the JAX package's plain einsum core."""
    if impl in ("auto", "flash"):
        from torchpruner_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal)
    if impl != "xla":
        raise ValueError(f"attention impl {impl!r} is not ported "
                         f"(use 'auto', 'flash' or 'xla')")
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bshk,bthk->bhst", q, k) * scale
    if causal:
        S = q.shape[1]
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits,
                             torch.finfo(logits.dtype).min)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bthk->bshk", w, v)


def _dot(x: torch.Tensor, w, fixed_order: bool) -> torch.Tensor:
    """``x ·₀ w`` (x's trailing axis against w's leading one): through
    :func:`~torchpruner_tpu_torch.ops.quant.qdot` on the fixed-order path
    or for a quantized or block-sparse weight, else one plain product on
    the whole tensor (operand dtypes promote as in ``jnp.matmul``)."""
    if fixed_order or isinstance(w, (QTensor, BlockSparseWeight)):
        return qdot(x, w)
    dt = torch.promote_types(x.dtype, w.dtype)
    y = x.to(dt) @ w.to(dt).reshape(w.shape[0], -1)
    return y.reshape(tuple(x.shape[:-1]) + tuple(w.shape[1:]))


def _row_mean(v: torch.Tensor, fixed_order: bool) -> torch.Tensor:
    if fixed_order:
        return per_rows(lambda c: c.mean(dim=-1, keepdim=True), v)
    return v.mean(dim=-1, keepdim=True)


def apply_layer(spec: LayerSpec, params, state, x: torch.Tensor, *,
                train: bool = False, rng: Optional[torch.Generator] = None,
                taps: Optional[Taps] = None, path: Tuple[str, ...] = (),
                fixed_order: bool = False):
    """Apply one layer; returns ``(y, state)``.  ``fixed_order`` selects
    the batch-invariant evaluation order (module docstring).  Matmul
    weights may be :class:`~torchpruner_tpu_torch.ops.quant.QTensor`
    leaves: the product consumes the integer payload and the
    per-output-channel scale is applied to the output."""
    if isinstance(spec, Dense):
        y = oscale(_dot(x, params["w"], fixed_order), params["w"])
        if "b" in params:
            y = y + params["b"]
        return y, state
    if isinstance(spec, Conv):
        return _conv(spec, params, x), state
    if isinstance(spec, Pool):
        return _pool(spec, x), state
    if isinstance(spec, Flatten):
        return x.reshape(x.shape[0], -1), state
    if isinstance(spec, Reshape):
        return x.reshape((x.shape[0],)
                         + _reshape_target(spec.shape, x.shape[1:])), state
    if isinstance(spec, ClsToken):
        tok = params["tok"].to(x.dtype).expand(x.shape[0], 1, x.shape[-1])
        return torch.cat([tok, x], dim=1), state
    # norms compute in f32 whatever the activation dtype and cast back —
    # the JAX package's mixed-precision policy (a bf16 running-stat EMA
    # would round small increments to zero)
    if isinstance(spec, BatchNorm):
        return _batch_norm(spec, params, state, x, train)
    if isinstance(spec, LayerNorm):
        xf = x.float()
        mean = _row_mean(xf, fixed_order)
        var = _row_mean((xf - mean).square(), fixed_order)  # population
        y = (xf - mean) * torch.rsqrt(var + spec.eps) \
            * params["scale"].float()
        if "bias" in params:
            y = y + params["bias"].float()
        return y.to(x.dtype), state
    if isinstance(spec, RMSNorm):
        xf = x.float()
        ms = _row_mean(xf.square(), fixed_order)
        y = xf * torch.rsqrt(ms + spec.eps) * params["scale"].float()
        return y.to(x.dtype), state
    if isinstance(spec, Activation):
        return ACTIVATION_FNS[spec.fn](x), state
    if isinstance(spec, GlobalPool):
        if spec.kind == "avg":
            return x.mean(dim=tuple(range(1, x.ndim - 1))), state
        if spec.kind == "seq_mean":
            return x.mean(dim=1), state
        if spec.kind == "cls":
            return x[:, 0], state
        raise ValueError(f"unknown global pool kind {spec.kind!r}")
    if isinstance(spec, Dropout):
        if not train or spec.rate == 0.0:
            return x, state
        if rng is None:
            raise ValueError(f"Dropout {spec.name!r} needs an rng in "
                             f"train mode")
        keep = 1.0 - spec.rate
        mask = torch.rand(x.shape, generator=rng, device=rng.device
                          ).to(x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x)), state
    if isinstance(spec, Embedding):
        return params["emb"][x.long()], state
    if isinstance(spec, PosEmbed):
        return x + params["emb"][:x.shape[-2]], state
    if isinstance(spec, MultiHeadAttention):
        return _attention(spec, params, x, taps, path, fixed_order), state
    if isinstance(spec, GatedDense):
        g = oscale(_dot(x, params["wg"], fixed_order), params["wg"])
        u = oscale(_dot(x, params["wu"], fixed_order), params["wu"])
        if "bg" in params:
            g = g + params["bg"]
            u = u + params["bu"]
        return ACTIVATION_FNS[spec.fn](g) * u, state
    if isinstance(spec, Residual):
        y, new_state = apply_seq(spec.body, params, state, x, train=train,
                                 rng=rng, taps=taps, prefix=path,
                                 fixed_order=fixed_order)
        if not spec.shortcut:
            return y + x, new_state
        sc, sc_state = apply_seq(spec.shortcut, params, state, x,
                                 train=train, rng=rng, taps=taps,
                                 prefix=path, fixed_order=fixed_order)
        for child in spec.shortcut:
            if child.name in sc_state:
                new_state[child.name] = sc_state[child.name]
        return y + sc, new_state
    raise TypeError(f"unknown layer spec {type(spec)}")


def _batch_norm(spec: BatchNorm, params, state, x: torch.Tensor,
                train: bool):
    """Train mode normalizes by the batch's mean and biased variance and
    returns the updated running statistics (detached: they carry no
    gradient); eval mode uses the running statistics."""
    xf = x.float()
    if train:
        axes = tuple(range(x.ndim - 1))
        mean = xf.mean(dim=axes)
        var = xf.var(dim=axes, correction=0)
        d = spec.decay
        new_state = {
            "mean": (d * state["mean"].float() + (1 - d) * mean).detach(),
            "var": (d * state["var"].float() + (1 - d) * var).detach()}
    else:
        mean, var = state["mean"].float(), state["var"].float()
        new_state = state
    y = (xf - mean) * torch.rsqrt(var + spec.eps) \
        * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype), new_state


def _pool(spec: Pool, x: torch.Tensor) -> torch.Tensor:
    """NHWC pooling through ``F.max_pool2d`` / ``F.avg_pool2d`` on the
    NCHW view, with XLA's SAME pads explicit: -inf for max; for avg a
    window sum divided by the count of valid elements it covers."""
    window = tuple(spec.window)
    strides = tuple(spec.strides or spec.window)
    xc = x.permute(0, 3, 1, 2)
    if spec.padding not in ("SAME", "VALID"):
        raise ValueError(f"unknown pool padding {spec.padding!r}")
    pads = (0, 0, 0, 0)
    if spec.padding == "SAME":
        (h_lo, h_hi), (w_lo, w_hi) = (
            same_pads(n, k, s)
            for n, k, s in zip(xc.shape[2:], window, strides))
        pads = (w_lo, w_hi, h_lo, h_hi)
    if spec.kind == "max":
        if any(pads):
            xc = F.pad(xc, pads, value=-math.inf)
        y = F.max_pool2d(xc, window, strides)
    elif spec.kind == "avg":
        if not any(pads):
            y = F.avg_pool2d(xc, window, strides)
        else:
            total = F.avg_pool2d(F.pad(xc, pads), window, strides,
                                 divisor_override=1)
            ones = F.pad(torch.ones((1, 1) + tuple(xc.shape[2:]),
                                    dtype=x.dtype, device=x.device), pads)
            y = total / F.avg_pool2d(ones, window, strides,
                                     divisor_override=1)
    else:
        raise ValueError(f"unknown pool kind {spec.kind!r}")
    return y.permute(0, 2, 3, 1)


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis, ``(low, high)``: the
    output is ``ceil(size / stride)`` and an odd total pad puts its extra
    row at the high end (``padding="same"`` of torch takes no stride)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(spec: Conv, params, x: torch.Tensor) -> torch.Tensor:
    """NHWC x HWIO through ``F.conv2d`` (cuDNN on the card): the input
    viewed as NCHW (channels-last in memory), the weight permuted to
    OIHW here only, explicit SAME pads."""
    w = params["w"]
    dt = torch.promote_types(x.dtype, w.dtype)
    xc = x.to(dt).permute(0, 3, 1, 2)
    if spec.padding == "SAME":
        (h_lo, h_hi), (w_lo, w_hi) = (
            same_pads(n, k, s) for n, k, s in
            zip(xc.shape[2:], spec.kernel_size, spec.strides))
        xc = F.pad(xc, (w_lo, w_hi, h_lo, h_hi))
    elif spec.padding != "VALID":
        raise ValueError(f"unknown conv padding {spec.padding!r}")
    y = F.conv2d(xc, w.to(dt).permute(3, 2, 0, 1), stride=spec.strides)
    y = y.permute(0, 2, 3, 1)
    if "b" in params:
        y = y + params["b"]
    return y


def _attention(spec: MultiHeadAttention, params, x, taps, path,
               fixed_order):
    """The full-sequence attention rule: projections, RoPE, the GQA
    expansion, the attention core, the head-site taps, the output
    projection."""
    q = oscale(_dot(x, params["wq"], fixed_order), params["wq"])
    k = oscale(_dot(x, params["wk"], fixed_order), params["wk"])
    v = oscale(_dot(x, params["wv"], fixed_order), params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if spec.rope:
        q = _rope(q, spec.rope_theta)
        k = _rope(k, spec.rope_theta)
    if spec.kv_heads != spec.num_heads or spec.kv_group is not None:
        idx = torch.tensor(spec.head_kv_index(), device=k.device)
        k = k.index_select(2, idx)
        v = v.index_select(2, idx)
    ctx = attention_core(q, k, v, causal=spec.causal, impl=spec.impl)
    if taps is not None and not taps.empty():
        # head unit site: (B, S, Dh, H) — head axis last
        ctx = taps.at_site(path, ctx.movedim(2, 3)).movedim(3, 2)
    # the output projection contracts two axes (H, Dh): it consumes the
    # widened weight, as the JAX einsum does
    B, S, H, Dh = ctx.shape
    wo = wval(params["wo"], ctx.dtype)
    y = oscale(_dot(ctx.reshape(B, S, H * Dh), wo.reshape(H * Dh, -1),
                    fixed_order), params["wo"])
    if "bo" in params:
        y = y + params["bo"]
    return y


# ---------------------------------------------------------------------------
# Prunable-unit helpers
# ---------------------------------------------------------------------------


def n_units(spec: LayerSpec) -> int:
    """Number of prunable output units of a prunable layer."""
    if isinstance(spec, (Dense, Conv, GatedDense)):
        return spec.features
    if isinstance(spec, MultiHeadAttention):
        return spec.num_heads
    raise TypeError(f"{type(spec).__name__} has no prunable units")


def with_features(spec: LayerSpec, features: int) -> LayerSpec:
    """Return a copy of a prunable spec with a new unit count."""
    if isinstance(spec, (Dense, Conv, GatedDense)):
        return dataclasses.replace(spec, features=features)
    if isinstance(spec, MultiHeadAttention):
        if spec.kv_group is not None:
            raise ValueError(
                f"MHA {spec.name!r} has an irregular kv_group; resize it "
                "with pruned_spec(spec, keep) so the grouping stays valid")
        kv = features if spec.kv_heads == spec.num_heads \
            else spec.num_kv_heads
        return dataclasses.replace(spec, num_heads=features, num_kv_heads=kv)
    raise TypeError(f"{type(spec).__name__} has no feature count")


def pruned_spec(spec: LayerSpec, keep) -> LayerSpec:
    """The spec after keeping exactly the units ``keep`` (sorted
    indices); for GQA attention the surviving heads' KV groups are
    recorded in ``kv_group``."""
    keep = list(keep)
    if isinstance(spec, MultiHeadAttention):
        if spec.kv_heads == spec.num_heads and spec.kv_group is None:
            return dataclasses.replace(
                spec, num_heads=len(keep),
                num_kv_heads=len(keep) if spec.num_kv_heads is not None
                else None)
        group = spec.head_kv_index()
        return dataclasses.replace(spec, num_heads=len(keep),
                                   kv_group=tuple(group[h] for h in keep))
    return with_features(spec, len(keep))
