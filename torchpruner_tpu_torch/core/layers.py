"""Layer specifications and their init/apply rules — the subset the Llama
family needs for serving.

Counterpart of ``torchpruner_tpu/core/layers.py``: the same frozen spec
dataclasses with the same field names, and the same parameter layouts
(Dense ``w (in, out)``; attention ``wq (d, H, Dh)``, ``wk``/``wv
(d, KV, Dh)``, ``wo (H, Dh, d_out)``; GatedDense ``wg``/``wu (in,
features)``; Embedding ``emb (vocab, features)``; norm ``scale``).
Parameters are nested dicts of tensors, one level per composite block.

Activations are channels-last ``(B, S, d)``.  Row reductions (RMSNorm)
and plain products run on fixed-size row chunks (``ops/fixed_order.py``)
so a row's result does not depend on the batch it shares.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from torchpruner_tpu_torch.ops.fixed_order import per_rows
from torchpruner_tpu_torch.ops.quant import oscale, qdot
from torchpruner_tpu_torch.utils.device import resolve_device

# ---------------------------------------------------------------------------
# Layer specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Dense:
    """Fully-connected layer (out units = features)."""

    name: str
    features: int
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
class Embedding:
    """Token embedding lookup: int tokens ``(..., S)`` -> ``(..., S, d)``."""

    name: str
    vocab_size: int
    features: int


@dataclass(frozen=True)
class MultiHeadAttention:
    """Multi-head (optionally grouped-query) self-attention on ``(B, S, d)``;
    the same fields as the JAX spec.  In the port it runs through the
    KV-cache path (``generate._decode_attention``)."""

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
    ``fn="silu"``)."""

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
COMPOSITE_TYPES = (Residual,)

# ---------------------------------------------------------------------------
# Shapes and init
# ---------------------------------------------------------------------------


def out_shape(spec: LayerSpec, in_shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Per-layer output shape (batch dim excluded)."""
    if isinstance(spec, (Dense, GatedDense)):
        return tuple(in_shape[:-1]) + (spec.features,)
    if isinstance(spec, Embedding):
        return tuple(in_shape) + (spec.features,)
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
    if isinstance(spec, RMSNorm):
        return {"scale": (in_shape[-1],)}
    if isinstance(spec, Embedding):
        return {"emb": (spec.vocab_size, spec.features)}
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
    if isinstance(spec, Activation):
        return {}
    raise TypeError(f"unknown layer spec {type(spec)}")


def init_layer(spec: LayerSpec, gen: torch.Generator,
               in_shape: Tuple[int, ...], dtype=torch.float32,
               device=None):
    """Initialize one layer: ``(params, out_shape)``.  The JAX package's
    scales (Kaiming normal for Dense/GatedDense, ``0.02`` normal
    embeddings, ``1/sqrt(fan)`` attention), drawn from ``gen`` on the
    generator's device and moved to ``device`` (``None`` = ``cuda``;
    raises without a GPU unless ``device="cpu"``)."""
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
        elif isinstance(spec, Embedding):
            params[pname] = normal(shp, 0.02)
        elif isinstance(spec, MultiHeadAttention):
            fan = shp[0] if pname != "wo" else shp[0] * shp[1]
            params[pname] = normal(shp, 1.0 / math.sqrt(fan))
        else:  # Dense / GatedDense: Kaiming normal
            params[pname] = normal(shp, math.sqrt(2.0 / shp[0]))
    return params, out_shape(spec, in_shape)


# ---------------------------------------------------------------------------
# apply rules (eval mode)
# ---------------------------------------------------------------------------


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


def apply_layer(spec: LayerSpec, params, x: torch.Tensor) -> torch.Tensor:
    """Apply one position-independent layer in eval mode.  Matmul weights
    may be :class:`~torchpruner_tpu_torch.ops.quant.QTensor` leaves: the
    product consumes the integer payload and the per-output-channel
    scale is applied to the output."""
    if isinstance(spec, Dense):
        y = oscale(qdot(x, params["w"]), params["w"])
        if "b" in params:
            y = y + params["b"]
        return y
    if isinstance(spec, RMSNorm):
        # f32 internally whatever the activation dtype, cast back — the
        # JAX package's mixed-precision policy
        xf = x.float()
        ms = per_rows(lambda c: c.square().mean(dim=-1, keepdim=True), xf)
        y = xf * torch.rsqrt(ms + spec.eps) * params["scale"].float()
        return y.to(x.dtype)
    if isinstance(spec, Activation):
        return ACTIVATION_FNS[spec.fn](x)
    if isinstance(spec, Embedding):
        return params["emb"][x]
    if isinstance(spec, GatedDense):
        g = oscale(qdot(x, params["wg"]), params["wg"])
        u = oscale(qdot(x, params["wu"]), params["wu"])
        if "bg" in params:
            g = g + params["bg"]
            u = u + params["bu"]
        return ACTIVATION_FNS[spec.fn](g) * u
    if isinstance(spec, MultiHeadAttention):
        raise NotImplementedError(
            "attention runs through the KV-cache path "
            "(generate._decode_attention) in the port")
    raise TypeError(f"unknown layer spec {type(spec)}")
