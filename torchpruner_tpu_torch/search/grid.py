"""Campaign grids: what a sparsity-search campaign runs.
(A copy of ``torchpruner_tpu/search/grid.py``, imports renamed.)

A *campaign* is a set of prune-retrain *trials* over one base experiment
config — per-layer prune fractions × attribution method × schedule
(finetune epochs / LR), per "Adaptive Activation-based Structured
Pruning"'s searched sparsity ratios and JaxPruner's sparsity-config
sweep axis (PAPERS.md).  A :class:`CampaignSpec` comes from a named
preset (:data:`CAMPAIGNS`) or a JSON config file, and resolves into an
ordered list of :class:`TrialSpec`, each a deterministic set of
``ExperimentConfig`` field overrides on the base.

Determinism is the load-bearing property: trial ids, the enumeration
order, and the spec digest are pure functions of the spec, so a resumed
campaign re-derives the identical trial set (the driver refuses a
campaign dir whose recorded digest disagrees) and the chaos drill can
assert an interrupted-then-resumed campaign's frontier is identical to
an uninterrupted one.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

#: ExperimentConfig fields a trial may override — the campaign's search
#: vocabulary.  Everything else (model, dataset, run_dir, chaos, ...)
#: belongs to the base config or the driver; an unknown override is a
#: loud config error, not a silently ignored knob.
TRIAL_FIELDS = (
    "method", "method_kwargs", "reduction", "policy", "fraction",
    "layer_fractions", "bucket", "target_filter", "prune_order",
    "finetune_epochs", "lr", "lr_schedule", "momentum", "weight_decay",
    "optimizer", "batch_size", "accum_steps", "score_examples",
    "score_dtype", "compute_dtype", "seed",
)


@dataclass(frozen=True)
class TrialSpec:
    """One trial: a deterministic id plus config overrides on the base."""

    trial_id: str
    overrides: Dict[str, Any]

    def label(self) -> str:
        bits = []
        for k in ("method", "fraction", "layer_fractions",
                  "finetune_epochs", "lr"):
            if k in self.overrides:
                bits.append(f"{k}={self.overrides[k]}")
        return ", ".join(bits) or "(base config)"


@dataclass
class CampaignSpec:
    """The campaign: base config + trial grid + search policy knobs."""

    name: str = "campaign"
    #: preset name or ExperimentConfig JSON path the trials override
    base: str = "mnist_mlp_shapley"
    smoke: bool = False
    #: overrides applied to EVERY trial (before per-trial overrides)
    common: Dict[str, Any] = field(default_factory=dict)
    #: cartesian grid: ExperimentConfig field -> list of values
    axes: Dict[str, List[Any]] = field(default_factory=dict)
    #: explicit extra trials: override dicts (optional "id" names them)
    trials: List[Dict[str, Any]] = field(default_factory=list)
    #: concurrent worker processes (CLI --jobs overrides)
    jobs: int = 2
    #: early-stop policy: a running trial whose every partial
    #: accuracy-at-FLOPs point is Pareto-dominated by the completed
    #: frontier past ``margin`` (absolute accuracy) is cancelled at its
    #: next checkpoint boundary; ``min_rounds`` partial points must
    #: exist before the rule may fire (a trial with no committed round
    #: is never judged)
    early_stop: Dict[str, Any] = field(
        default_factory=lambda: {"margin": 0.1, "min_rounds": 1})
    #: the frontier filter's accuracy near-tie margin (a completed point
    #: is flagged dominated only when beaten by MORE than this) —
    #: deliberately smaller than the early-stop confidence margin: the
    #: filter labels an artifact, the stop cancels live work
    frontier_margin: float = 0.02
    #: frontier FLOPs buckets as fractions of the DENSE model's forward
    #: FLOPs — the ``frontier_best_acc_flops_le_<pct>pct`` gate scalars
    flops_buckets: List[float] = field(
        default_factory=lambda: [0.25, 0.5, 0.75, 1.0])
    #: pre-pricing cost gate: exclude a candidate whose predicted trial
    #: wall exceeds this many seconds (None = off)
    max_trial_predicted_s: Optional[float] = None
    #: relative twin of the absolute gate: exclude a candidate whose
    #: predicted trial wall exceeds this multiple of the candidate-set
    #: MEDIAN (None = off) — robust across hosts whose absolute
    #: cost-model constants differ
    max_trial_cost_ratio: Optional[float] = None
    #: per-chip HBM headroom fraction for the watermark gate (the same
    #: 0.85 the planner uses)
    hbm_headroom: float = 0.85
    #: CUDA devices per worker process (each worker slot gets its own
    #: ``CUDA_VISIBLE_DEVICES`` slice); 0 = inherit
    trial_devices: int = 0
    #: mid-retrain checkpoint cadence handed to every trial (optimizer
    #: steps; 0 = round/epoch boundaries only — early-stop still lands
    #: at retrain-epoch boundaries via the preemption poll)
    checkpoint_every_steps: int = 0
    #: worker attempts per trial before it is marked failed (a crashed
    #: attempt resumes cursor-exact from the trial's RunManifest)
    max_attempts: int = 3

    # -- construction ------------------------------------------------------

    @classmethod
    def from_any(cls, spec) -> "CampaignSpec":
        """Named campaign preset, JSON file path, dict, or CampaignSpec."""
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            if spec in CAMPAIGNS:
                return CAMPAIGNS[spec]()
            if os.path.exists(spec):
                with open(spec) as f:
                    spec = json.load(f)
            else:
                raise KeyError(
                    f"unknown campaign {spec!r}: not a preset "
                    f"({sorted(CAMPAIGNS)}) and not a config file path")
        if not isinstance(spec, dict):
            raise TypeError(f"cannot build a CampaignSpec from {spec!r}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(spec) - known
        if unknown:
            raise ValueError(f"unknown campaign keys: {sorted(unknown)}")
        return cls(**spec)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def digest(self) -> str:
        """Content digest of the search-relevant spec — the identity a
        resumed campaign must match (``jobs``/``trial_devices`` are
        execution knobs, not search identity: a resume may legitimately
        run wider or narrower)."""
        d = self.to_dict()
        for k in ("jobs", "trial_devices", "max_attempts"):
            d.pop(k, None)
        blob = json.dumps(d, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()

    @property
    def campaign_id(self) -> str:
        return f"{self.name}-{self.digest()[:8]}"

    # -- enumeration -------------------------------------------------------

    def enumerate_trials(self) -> List[TrialSpec]:
        """The deterministic trial list: the axes' cartesian product (in
        axis-insertion order) followed by the explicit ``trials``.
        Duplicate override sets collapse to the first occurrence."""
        out: List[TrialSpec] = []
        seen = set()

        def add(overrides: Dict[str, Any], tid: Optional[str] = None):
            overrides = {**self.common, **overrides}
            unknown = set(overrides) - set(TRIAL_FIELDS)
            if unknown:
                raise ValueError(
                    f"trial overrides {sorted(unknown)} are not in the "
                    f"campaign search vocabulary (TRIAL_FIELDS); put "
                    f"base-config fields in the base preset/config")
            key = json.dumps(overrides, sort_keys=True, default=str)
            if key in seen:
                return
            seen.add(key)
            out.append(TrialSpec(
                trial_id=tid or f"t{len(out):02d}_{_slug(overrides)}",
                overrides=overrides))

        axes = {k: list(v) for k, v in self.axes.items()}
        if axes:
            for combo in itertools.product(*axes.values()):
                add(dict(zip(axes.keys(), combo)))
        for t in self.trials:
            t = dict(t)
            tid = t.pop("id", None)
            add(t, tid=f"t{len(out):02d}_{tid}" if tid else None)
        if not out:
            raise ValueError(
                f"campaign {self.name!r} enumerates no trials — give it "
                f"axes and/or explicit trials")
        ids = [t.trial_id for t in out]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate trial ids: {sorted(ids)}")
        return out

    # -- materialization ---------------------------------------------------

    def base_config(self):
        """The resolved base ExperimentConfig (preset or JSON path).
        Campaign trials run the prune-retrain loop — that is the
        experiment whose rounds carry the accuracy/FLOPs points the
        frontier is made of — so the base's ``experiment`` is forced."""
        from torchpruner_tpu_torch.utils.config import ExperimentConfig

        if self.base.endswith(".json"):
            cfg = ExperimentConfig.from_json(self.base)
        else:
            from torchpruner_tpu_torch.experiments.presets import get_preset

            cfg = get_preset(self.base, smoke=self.smoke)
        if cfg.experiment != "prune_retrain":
            cfg = dataclasses.replace(cfg, experiment="prune_retrain")
        return cfg

    def trial_config(self, trial: TrialSpec, trial_dir: str):
        """``trial`` as a runnable, resumable ExperimentConfig rooted in
        ``trial_dir`` (RunManifest + checkpoints + CSV log live there;
        the trial's obs dir is ``<trial_dir>/obs``)."""
        cfg = self.base_config()
        over = dict(trial.overrides)
        for key in ("target_filter",):  # JSON lists -> config tuples
            if key in over:
                over[key] = tuple(over[key])
        cfg = dataclasses.replace(cfg, **over)
        return dataclasses.replace(
            cfg,
            name=f"{self.name}:{trial.trial_id}",
            run_dir=trial_dir,
            checkpoint_every_steps=self.checkpoint_every_steps,
            log_path=os.path.join(trial_dir, "log.csv"),
        )


#: slug abbreviations for the common axes (anything else contributes a
#: short stable hash so distinct override sets never collide on id)
_SLUG_KEYS = {"method": "", "fraction": "f", "finetune_epochs": "ft",
              "lr": "lr", "bucket": "b", "seed": "s"}


def _slug(overrides: Dict[str, Any]) -> str:
    bits, rest = [], {}
    for k in sorted(overrides):
        v = overrides[k]
        if k in _SLUG_KEYS:
            v = str(v).replace(".", "p").replace("/", "_")
            bits.append(f"{_SLUG_KEYS[k]}{v}")
        elif v not in ({}, (), [], None):
            rest[k] = v
    if rest:
        blob = json.dumps(rest, sort_keys=True, default=str)
        bits.append(hashlib.sha256(blob.encode()).hexdigest()[:6])
    return "_".join(bits)[:48] or "base"


# ---------------------------------------------------------------------------
# campaign presets
# ---------------------------------------------------------------------------


def digits_smoke() -> CampaignSpec:
    """The CI/smoke campaign: the untrained-digits MLP recipe searched
    over method × fraction × schedule — 9 candidates, of which the
    cost-model pre-pricing excludes one BY NAME (a 512-epoch schedule,
    caught by the relative predicted-cost gate before any trial
    runs), one diverging-LR trial is Pareto-dominated mid-run and
    early-stopped at a checkpoint boundary, and the rest land on the
    accuracy-vs-FLOPs frontier.  Runs end to end on one CPU in ~a
    minute; deterministic by seed, so the chaos drill can assert an
    interrupted campaign reproduces the identical frontier."""
    return CampaignSpec(
        name="digits_smoke",
        base="mnist_mlp_shapley",
        smoke=True,
        common={"policy": "fraction", "finetune_epochs": 1, "lr": 0.05,
                "method_kwargs": {}},
        axes={
            "method": ["weight_norm", "random"],
            "fraction": [0.25, 0.5, 0.75],
        },
        trials=[
            # per-layer fractions: the first hidden layer pruned gently,
            # the second hard — the per-layer-ratio search axis
            {"id": "layerwise", "method": "weight_norm", "fraction": 0.5,
             "layer_fractions": {"fc1": 0.25, "fc2": 0.625}},
            # a diverging schedule: same sparsity as the healthy
            # fraction=0.5 trials but LR far past stable — its partial
            # accuracy collapses to chance, so the completed frontier
            # dominates it by a wide margin and the driver cancels it
            # mid-retrain (4 epochs/round keeps it alive long enough to
            # be judged)
            {"id": "doomed_lr", "method": "random", "fraction": 0.5,
             "finetune_epochs": 4, "lr": 3.0},
            # the pre-pricing victim: a 512-epoch retrain schedule whose
            # predicted wall is ~512x the grid median — excluded by the
            # cost gate before any trial runs
            {"id": "over_budget", "method": "weight_norm",
             "fraction": 0.5, "finetune_epochs": 512},
        ],
        jobs=2,
        early_stop={"margin": 0.15, "min_rounds": 1},
        flops_buckets=[0.25, 0.5, 0.75, 1.0],
        max_trial_cost_ratio=16.0,
    )


CAMPAIGNS: Dict[str, Callable[[], CampaignSpec]] = {
    "digits_smoke": digits_smoke,
}


def campaign_names() -> tuple:
    return tuple(CAMPAIGNS)
