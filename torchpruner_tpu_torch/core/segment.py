"""SegmentedModel — an immutable, ordered pipeline of layer specs.

Counterpart of ``torchpruner_tpu/core/segment.py``.  Any contiguous
segment of the pipeline is itself a function: ``model.apply(...,
from_layer=a, to_layer=b)`` runs the segment after ``a`` up to and
including ``b``.  Nested layers (inside a ``Residual``) are addressed by
``"block/child"`` paths wherever a layer name is accepted for
instrumentation; segment boundaries stay at the top level.  Params are
nested dicts ``{layer_name: {param_name: tensor}}`` with the JAX
package's names and layouts, and the state (BatchNorm running
statistics) a tree of the same shape; the numbers of :func:`init_model`
come from a ``torch.Generator`` and are not JAX's.

``apply`` is the full-sequence path (scoring, training, evaluation): its
products and reductions run on whole tensors, not on the fixed row
chunks of the KV-cache path (``core/layers.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from torchpruner_tpu_torch.core import layers as L
from torchpruner_tpu_torch.utils.device import resolve_device
from torchpruner_tpu_torch.utils.dtypes import to_dtype


@dataclass(frozen=True)
class SegmentedModel:
    """An ordered pipeline of layer specs with named layers.
    ``input_shape`` excludes the batch dimension; ``input_dtype`` names
    the element type of inputs (``"int32"`` token ids for LMs)."""

    layers: Tuple[L.LayerSpec, ...]
    input_shape: Tuple[int, ...]
    input_dtype: str = "float32"

    def __post_init__(self):
        names = [l.name for l in self.layers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate layer names in {names}")

    # -- introspection ------------------------------------------------------

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(l.name for l in self.layers)

    def layer(self, name: str) -> L.LayerSpec:
        """Resolve a (possibly nested, ``"block/child"``) layer path."""
        spec = None
        layers = self.layers
        for part in L.parse_path(name):
            spec = next((l for l in layers if l.name == part), None)
            if spec is None:
                raise KeyError(name)
            layers = (spec.body + spec.shortcut
                      if isinstance(spec, L.Residual) else ())
        return spec

    def index(self, name: str) -> int:
        """Top-level index of a layer (segment boundaries are top-level)."""
        for i, l in enumerate(self.layers):
            if l.name == name:
                return i
        raise KeyError(name)

    def top_level_of(self, name: str) -> str:
        """The top-level layer containing (or equal to) ``name``."""
        top = L.parse_path(name)[0]
        self.index(top)  # raises KeyError if absent
        return top

    @functools.cached_property
    def shapes(self) -> Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...]:
        """Per-layer ``(in_shape, out_shape)`` (batch dim excluded)."""
        return L.seq_shapes(self.layers, self.input_shape)

    def out_shape(self, name: Optional[str] = None) -> Tuple[int, ...]:
        """Output shape (batch excluded) of layer ``name`` (default: last)."""
        if name is None:
            return self.shapes[-1][1]
        return self._resolve_shapes(L.parse_path(name))[1]

    def in_shape(self, name: str) -> Tuple[int, ...]:
        """Input shape (batch excluded) of (possibly nested) layer ``name``."""
        return self._resolve_shapes(L.parse_path(name))[0]

    def site_shape(self, name: str) -> Tuple[int, ...]:
        """Per-example shape of the activation at ``name``'s unit site
        (unit axis last; attention: the head context ``(S, Dh, H)``)."""
        inp, _ = self._resolve_shapes(L.parse_path(name))
        return L.unit_site_shape(self.layer(name), inp)

    def _resolve_shapes(self, path: Tuple[str, ...]):
        """(in_shape, out_shape) of the layer at ``path``."""
        layers = self.layers
        in_shape = tuple(self.input_shape)
        for depth, part in enumerate(path):
            found = None
            for spec, (i_shape, o_shape) in zip(
                    layers, L.seq_shapes(layers, in_shape)):
                if spec.name == part:
                    found = (spec, i_shape, o_shape)
                    break
            if found is None:
                raise KeyError("/".join(path))
            spec, i_shape, o_shape = found
            if depth == len(path) - 1:
                return i_shape, o_shape
            if not isinstance(spec, L.Residual):
                raise KeyError("/".join(path))
            nxt = path[depth + 1]
            layers = spec.body if any(l.name == nxt for l in spec.body) \
                else spec.shortcut
            in_shape = i_shape
        raise KeyError("/".join(path))

    # -- init / apply ---------------------------------------------------------

    def param_shapes(self) -> Dict[str, Any]:
        """``{layer: {param: shape}}`` for the whole model."""
        out: Dict[str, Any] = {}
        shape = tuple(self.input_shape)
        for spec in self.layers:
            p = L.param_shapes(spec, shape)
            if p:
                out[spec.name] = p
            shape = L.out_shape(spec, shape)
        return out

    def init(self, gen: torch.Generator, dtype=torch.float32,
             device=None) -> Dict[str, Any]:
        """Params drawn from ``gen``, placed on ``device`` (``None`` =
        ``cuda``; raises without a GPU unless ``device="cpu"``)."""
        device = resolve_device(device)
        params: Dict[str, Any] = {}
        shape = tuple(self.input_shape)
        for spec in self.layers:
            p, shape = L.init_layer(spec, gen, shape, to_dtype(dtype),
                                    device)
            if p:
                params[spec.name] = p
        return params

    def init_state(self, dtype=torch.float32, device=None
                   ) -> Dict[str, Any]:
        """The initial state tree (running ``mean`` 0, ``var`` 1) on
        ``device``; empty for a model without BatchNorm."""
        device = resolve_device(device)
        state: Dict[str, Any] = {}
        for spec, (in_shape, _) in zip(self.layers, self.shapes):
            s = L.init_state(spec, in_shape, to_dtype(dtype), device)
            if s:
                state[spec.name] = s
        return state

    def example_input(self, batch: int = 2, seed: int = 0, device=None):
        """A random batch with the model's input shape and dtype (token
        ids below the embedding's vocabulary for int models)."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        shape = (batch,) + tuple(self.input_shape)
        if self.input_dtype.startswith("int"):
            vocab = next((l.vocab_size for l in self.layers
                          if isinstance(l, L.Embedding)), 2)
            x = torch.randint(0, vocab, shape, generator=gen,
                              dtype=torch.int32)
        else:
            x = torch.randn(shape, generator=gen)
        return x.to(dev)

    def apply(self, params, x, *, state=None, train: bool = False,
              rng: Optional[torch.Generator] = None,
              from_layer: Optional[str] = None,
              to_layer: Optional[str] = None,
              unit_mask: Optional[Tuple[str, Any]] = None,
              perturb: Optional[Tuple[str, Any]] = None,
              capture: Optional[str] = None,
              captures: Optional[Sequence[str]] = None):
        """Run the segment after ``from_layer`` through ``to_layer``
        inclusive (``x`` is then ``from_layer``'s output).

        - ``unit_mask=(site, vec)`` multiplies the activation at ``site``
          by ``vec`` along the last (unit) axis;
        - ``perturb=(site, delta)`` adds ``delta`` at the site —
          differentiate w.r.t. ``delta`` at zero for activation-gradient
          attributions;
        - ``capture=site`` additionally returns the activation there;
        - ``captures=(site, ...)`` additionally returns ``{site:
          activation}`` for every listed site from one forward;
        - ``rng`` feeds train-mode Dropout.

        Returns ``(y, state)``, then the captured activation, then the
        captures dict, when requested."""
        state = state if state is not None else {}
        start = 0 if from_layer is None else self.index(from_layer) + 1
        stop = len(self.layers) if to_layer is None \
            else self.index(to_layer) + 1
        if (start >= stop and from_layer is not None
                and to_layer is not None
                and not start == stop == len(self.layers)):
            raise ValueError(
                f"empty segment: from {from_layer!r} to {to_layer!r}")
        taps = None
        if (unit_mask is not None or perturb is not None
                or capture is not None or captures):
            taps = L.Taps(unit_mask=unit_mask, perturb=perturb,
                          capture=capture,
                          multi_capture=tuple(captures) if captures else ())
        y, new_state = L.apply_seq(self.layers[start:stop], params, state, x,
                                   train=train, rng=rng, taps=taps,
                                   fixed_order=False)
        out = (y, dict(new_state))
        if capture is not None:
            out = out + (taps.captured,)
        if captures:
            out = out + (taps.captures,)
        return out

    # -- pruning-adjacent helpers ---------------------------------------------

    def replace_layer(self, name: str, new_spec: L.LayerSpec
                      ) -> "SegmentedModel":
        """Replace the (possibly nested) layer at path ``name``."""
        new_layers = _replace_in(self.layers, L.parse_path(name), new_spec)
        return SegmentedModel(new_layers, self.input_shape, self.input_dtype)

    def widths(self) -> Dict[str, int]:
        """Current unit count of every prunable layer (nested paths
        included)."""
        out: Dict[str, int] = {}

        def walk(layers, prefix):
            for l in layers:
                path = prefix + (l.name,)
                if isinstance(l, L.Residual):
                    walk(l.body, path)
                    walk(l.shortcut, path)
                elif isinstance(l, L.PRUNABLE_TYPES):
                    out["/".join(path)] = L.n_units(l)

        walk(self.layers, ())
        return out


def _replace_in(layers: Tuple[L.LayerSpec, ...], path, new_spec):
    out = []
    head, rest = path[0], path[1:]
    found = False
    for l in layers:
        if l.name != head:
            out.append(l)
            continue
        found = True
        if not rest:
            out.append(new_spec)
            continue
        if not isinstance(l, L.Residual):
            raise KeyError("/".join(path))
        if any(c.name == rest[0] for c in l.body):
            l = dataclasses.replace(l, body=_replace_in(l.body, rest,
                                                        new_spec))
        else:
            l = dataclasses.replace(l, shortcut=_replace_in(l.shortcut, rest,
                                                            new_spec))
        out.append(l)
    if not found:
        raise KeyError("/".join(path))
    return tuple(out)


def init_model(model: SegmentedModel, seed: int = 0, dtype=torch.float32,
               device=None):
    """Seeded ``(params, state)`` on ``device`` (``None`` = ``cuda``;
    raises without a GPU unless ``device="cpu"``).  Params are drawn from
    a CPU ``torch.Generator``, so the numbers do not depend on the
    device; ``state`` holds BatchNorm's running ``mean`` 0 and ``var``
    1 (empty without BatchNorm)."""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    return (model.init(gen, dtype=dtype, device=dev),
            model.init_state(dtype=dtype, device=dev))


@functools.lru_cache(maxsize=512)
def segment_fn(model: SegmentedModel, from_layer: Optional[str] = None,
               to_layer: Optional[str] = None, train: bool = False):
    """A cached closure for a model segment: ``fn(params, state, x) ->
    (y, state)``."""

    def fn(params, state, x):
        return model.apply(params, x, state=state, train=train,
                           from_layer=from_layer, to_layer=to_layer)

    return fn


@functools.lru_cache(maxsize=128)
def capture_fn(model: SegmentedModel, sites: Tuple[str, ...],
               train: bool = False):
    """A cached multi-site capture closure: ``fn(params, state, x) ->
    {site: activation}`` from one forward, which stops at the deepest
    top-level layer holding a site."""
    if not sites:
        raise ValueError("capture_fn needs at least one site")
    stop = max(model.index(model.top_level_of(s)) for s in sites)
    to_layer = model.layers[stop].name

    def fn(params, state, x):
        _, _, caps = model.apply(params, x, state=state, train=train,
                                 to_layer=to_layer, captures=sites)
        return caps

    return fn
