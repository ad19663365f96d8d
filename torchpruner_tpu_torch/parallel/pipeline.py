"""Pipeline parallelism — microbatched stage execution over local
devices; counterpart of ``torchpruner_tpu/parallel/pipeline.py``.

A :class:`SegmentedModel` is a pipeline of segments, so stage
partitioning is native: split the top-level layers into ``n_stages``
contiguous spans balanced by parameter count, hold each span's params on
its own device, and stream microbatches through.  One process drives
every stage; the devices may repeat (two stages on one card).

``train_step`` issues each stage's forwards and backwards in **1F1B
order** (PipeDream-flush: Narayanan et al., 2019): stage ``s`` runs
``n_stages - 1 - s`` warm-up forwards, then alternates one forward with
one backward, then drains, so at most ``n_stages - s`` activation
residuals (autograd graphs) are live at a stage instead of
``n_microbatches``.  A forward keeps its stage's autograd graph; the
backward is ``torch.autograd.grad`` of the stage output with the
downstream activation gradient, which gives the parameter gradients
(summed over microbatches on the stage's device) and the input's
gradient for the upstream stage.  The loss accumulates on the last
stage's device and is read once a step.

Mutable state (BatchNorm running statistics) is threaded through the
microbatches at each stage: microbatch ``k + 1``'s forward sees the state
microbatch ``k`` produced, as sequential microbatches on one device do;
every microbatch's forward uses the pre-step params, as in GPipe.

For uniform transformer stacks across processes,
:mod:`~torchpruner_tpu_torch.parallel.pp_spmd` is the collective-based
formulation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchpruner_tpu_torch.core import layers as L
from torchpruner_tpu_torch.core.segment import SegmentedModel, init_model
from torchpruner_tpu_torch.train.loop import to_device
from torchpruner_tpu_torch.train.optim import apply_updates
from torchpruner_tpu_torch.utils.tree import tree_leaves, tree_map


def _layer_param_count(spec, in_shape) -> int:
    """Static per-layer parameter count (no tensors)."""
    total = 0
    if isinstance(spec, L.Residual):
        for branch in (spec.body, spec.shortcut):
            shape = tuple(in_shape)
            for child in branch:
                total += _layer_param_count(child, shape)
                shape = L.out_shape(child, shape)
        return total
    d = in_shape[-1] if in_shape else 0
    if isinstance(spec, L.Dense):
        return d * spec.features + (spec.features if spec.use_bias else 0)
    if isinstance(spec, L.Conv):
        kh, kw = spec.kernel_size
        return kh * kw * d * spec.features + (
            spec.features if spec.use_bias else 0)
    if isinstance(spec, L.BatchNorm):
        return 2 * d
    if isinstance(spec, L.LayerNorm):
        return d * (2 if spec.use_bias else 1)
    if isinstance(spec, L.RMSNorm):
        return d
    if isinstance(spec, L.Embedding):
        return spec.vocab_size * spec.features
    if isinstance(spec, L.PosEmbed):
        return spec.max_len * d
    if isinstance(spec, L.ClsToken):
        return d
    if isinstance(spec, L.MultiHeadAttention):
        H, KV, Dh = spec.num_heads, spec.kv_heads, spec.head_dim
        d_out = spec.out_features if spec.out_features is not None else d
        n = d * H * Dh + 2 * d * KV * Dh + H * Dh * d_out
        if spec.use_bias:
            n += H * Dh + 2 * KV * Dh + d_out
        return n
    if isinstance(spec, L.GatedDense):
        return 2 * d * spec.features + (
            2 * spec.features if spec.use_bias else 0)
    if isinstance(spec, L.MoE):
        E, F = spec.n_experts, spec.ffn_dim
        return d * E + 3 * E * d * F
    return 0


def balance_stages(model: SegmentedModel, n_stages: int
                   ) -> List[Tuple[int, int]]:
    """Split top-level layer indices into ``n_stages`` contiguous spans
    ``[(start, stop), ...]`` with roughly equal parameter counts (greedy:
    cut when the running count passes the ideal per-stage share)."""
    if not (1 <= n_stages <= len(model.layers)):
        raise ValueError(
            f"n_stages {n_stages} out of range [1, {len(model.layers)}]")
    counts = [_layer_param_count(spec, shp[0])
              for spec, shp in zip(model.layers, model.shapes)]
    total = sum(counts)
    spans: List[Tuple[int, int]] = []
    start, acc = 0, 0
    remaining = n_stages
    for i, c in enumerate(counts):
        acc += c
        layers_left = len(counts) - i - 1
        if (remaining > 1 and acc >= total / n_stages
                and layers_left >= remaining - 1):
            spans.append((start, i + 1))
            start, acc = i + 1, 0
            remaining -= 1
    spans.append((start, len(counts)))
    while len(spans) < n_stages:  # degenerate: pad with empty-param spans
        s, e = spans[-1]
        if e - s < 2:
            raise ValueError(f"cannot split {model.names} into {n_stages}")
        spans[-1] = (s, e - 1)
        spans.append((e - 1, e))
    return spans


def _split_tree(tree: Dict[str, Any], names: Sequence[str]
                ) -> Dict[str, Any]:
    return {k: tree[k] for k in names if k in tree}


def _to(tree, dev):
    return tree_map(lambda t: t.to(dev) if isinstance(t, torch.Tensor)
                    else t, tree)


@dataclass
class PipelineParallel:
    """Microbatched pipeline executor over local devices:
    ``stage_params[i]`` / ``stage_state[i]`` live on ``devices[i]``."""

    model: SegmentedModel
    spans: List[Tuple[int, int]]
    devices: List[Any]
    stage_params: List[Dict[str, Any]]
    stage_state: List[Dict[str, Any]]
    loss_fn: Optional[Callable] = None
    tx: Any = None
    opt_state: Any = None
    n_microbatches: int = 4
    #: filled by ``train_step``: per-stage peak live residuals and the
    #: issued op sequences, the evidence of the 1F1B schedule
    #: (``max_live_residuals[s] <= n_stages - s``)
    last_step_stats: Optional[Dict[str, Any]] = field(default=None,
                                                      repr=False)

    @classmethod
    def create(cls, model: SegmentedModel, n_stages: int, *,
               loss_fn: Optional[Callable] = None, tx=None,
               devices: Optional[Sequence] = None, seed: int = 0,
               n_microbatches: int = 4, params=None, state=None
               ) -> "PipelineParallel":
        """``devices``: torch devices, one a stage (a device may repeat);
        by default every CUDA card.  ``params`` / ``state`` are adopted,
        else drawn from ``seed``."""
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        if len(devices) < n_stages:
            raise ValueError(f"{n_stages} stages need {n_stages} devices, "
                             f"have {len(devices)}")
        devices = devices[:n_stages]
        if params is None:
            params, state = init_model(model, seed, device=devices[0])
        state = state if state is not None else {}
        spans = balance_stages(model, n_stages)
        stage_params, stage_state = [], []
        for (s, e), dev in zip(spans, devices):
            names = [l.name for l in model.layers[s:e]]
            stage_params.append(_to(_split_tree(params, names), dev))
            stage_state.append(_to(_split_tree(state, names), dev))
        opt_state = None
        if tx is not None:
            opt_state = [tx.init(p) for p in stage_params]
        return cls(model=model, spans=spans, devices=devices,
                   stage_params=stage_params, stage_state=stage_state,
                   loss_fn=loss_fn, tx=tx, opt_state=opt_state,
                   n_microbatches=n_microbatches)

    def _stage(self, i: int, params, state, x, train: bool):
        s, e = self.spans[i]
        frm = None if s == 0 else self.model.layers[s - 1].name
        return self.model.apply(params, x, state=state, train=train,
                                from_layer=frm,
                                to_layer=self.model.layers[e - 1].name)

    # -- inference -----------------------------------------------------------

    @torch.no_grad()
    def forward(self, x) -> torch.Tensor:
        """Pipelined eval forward; microbatches stream through the
        stages.  Returns the outputs on the last stage's device."""
        outs = []
        for mb in _microbatches(x, self.n_microbatches):
            z = to_device(mb, self.devices[0])
            for i in range(len(self.spans)):
                z = z.to(self.devices[i])
                z, _ = self._stage(i, self.stage_params[i],
                                   self.stage_state[i], z, False)
            outs.append(z)
        return torch.cat(outs, dim=0)

    # -- training ------------------------------------------------------------

    def train_step(self, x, y) -> float:
        """One 1F1B pipeline step (module docstring): per-stage
        gradients summed over the microbatches, one optimizer update a
        stage, and one device-to-host read (the loss)."""
        if self.tx is None or self.loss_fn is None:
            raise ValueError("train_step needs tx= and loss_fn= at create()")
        S = len(self.spans)
        M = self.n_microbatches
        mbs_x = _microbatches(x, M)
        mbs_y = _microbatches(y, M)
        sched = _1f1b_schedule(S, M)

        leaves = [list(tree_leaves(p)) for p in self.stage_params]
        grads: List[Any] = [None] * S
        cur_state = list(self.stage_state)
        # (stage, mb) -> (stage input, stage output, param leaves)
        graphs: Dict[Tuple[int, int], Any] = {}
        outs: Dict[Tuple[int, int], torch.Tensor] = {}
        pending_g: Dict[Tuple[int, int], torch.Tensor] = {}
        live = [0] * S
        max_live = [0] * S
        issued: List[List[Tuple[str, int]]] = [[] for _ in range(S)]
        loss_acc = None
        ptr = [0] * S
        issued_f = [set() for _ in range(S)]
        while any(ptr[s] < len(sched[s]) for s in range(S)):
            progress = False
            for s in range(S):
                if ptr[s] >= len(sched[s]):
                    continue
                op, k = sched[s][ptr[s]]
                if op == "F":
                    if s > 0 and k not in issued_f[s - 1]:
                        continue  # upstream activation not issued yet
                    if s == 0:
                        z_in = to_device(mbs_x[k], self.devices[0])
                    else:
                        z_in = outs.pop((s - 1, k)).to(self.devices[s])
                        z_in = z_in.detach().requires_grad_()
                    p = [t.detach().requires_grad_() for t in leaves[s]]
                    it = iter(p)
                    params = tree_map(lambda _t: next(it),
                                      self.stage_params[s])
                    with torch.enable_grad():
                        z_out, ns = self._stage(s, params, cur_state[s],
                                                z_in, True)
                    cur_state[s] = ns
                    graphs[(s, k)] = (z_in, z_out, p)
                    outs[(s, k)] = z_out.detach()
                    live[s] += 1
                    max_live[s] = max(max_live[s], live[s])
                    issued_f[s].add(k)
                else:
                    if k not in issued_f[s] or (
                            s < S - 1 and (s, k) not in pending_g):
                        continue  # downstream backward not issued yet
                    z_in, z_out, p = graphs.pop((s, k))
                    if s == S - 1:
                        outs.pop((S - 1, k))
                        yb = to_device(mbs_y[k], self.devices[-1])
                        with torch.enable_grad():
                            lval = self.loss_fn(z_out, yb).mean()
                        loss_acc = lval.detach() if loss_acc is None \
                            else loss_acc + lval.detach()
                        out, g = lval, None
                    else:
                        out = z_out
                        g = pending_g.pop((s, k)).to(self.devices[s])
                    wrt = p + ([z_in] if s > 0 else [])
                    got = torch.autograd.grad(out, wrt, g,
                                              allow_unused=True)
                    live[s] -= 1
                    dp = [torch.zeros_like(t) if d is None else d
                          for t, d in zip(p, got)]
                    grads[s] = dp if grads[s] is None else [
                        a + b for a, b in zip(grads[s], dp)]
                    if s > 0:
                        pending_g[(s - 1, k)] = got[-1]
                issued[s].append((op, k))
                ptr[s] += 1
                progress = True
            if not progress:
                raise RuntimeError("1F1B schedule deadlocked (bug)")

        inv = 1.0 / M
        with torch.no_grad():
            for i in range(S):
                it = iter(g * inv for g in grads[i])
                gi = tree_map(lambda _t: next(it), self.stage_params[i])
                updates, self.opt_state[i] = self.tx.update(
                    gi, self.opt_state[i], self.stage_params[i])
                self.stage_params[i] = apply_updates(self.stage_params[i],
                                                     updates)
        self.stage_state = cur_state
        self.last_step_stats = {"schedule": "1f1b",
                                "max_live_residuals": max_live,
                                "issued": issued, "host_syncs": 1}
        return float(loss_acc) * inv  # the single device-to-host read

    # -- utilities -----------------------------------------------------------

    def gather_params(self) -> Dict[str, Any]:
        """The stages' params merged into one tree (on the host)."""
        out: Dict[str, Any] = {}
        for p in self.stage_params:
            out.update(_to(p, "cpu"))
        return out

    def gather_state(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for s in self.stage_state:
            out.update(_to(s, "cpu"))
        return out


def _1f1b_schedule(n_stages: int, n_microbatches: int
                   ) -> List[List[Tuple[str, int]]]:
    """Per-stage op sequences for non-interleaved 1F1B
    (PipeDream-flush): stage ``s`` runs ``min(n_stages - 1 - s, M)``
    warm-up forwards, then alternates forward / backward until all ``M``
    forwards are issued, then drains the remaining backwards."""
    per_stage: List[List[Tuple[str, int]]] = []
    for s in range(n_stages):
        warmup = min(n_stages - 1 - s, n_microbatches)
        seq: List[Tuple[str, int]] = [("F", k) for k in range(warmup)]
        f_next, b_next = warmup, 0
        while b_next < n_microbatches:
            if f_next < n_microbatches:
                seq.append(("F", f_next))
                f_next += 1
            seq.append(("B", b_next))
            b_next += 1
        per_stage.append(seq)
    return per_stage


def _microbatches(x, n: int):
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    b = x.shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible by {n} microbatches")
    size = b // n
    return [x[i * size:(i + 1) * size] for i in range(n)]
