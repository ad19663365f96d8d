"""Experiment configuration — counterpart of
``torchpruner_tpu/utils/config.py``: the same dataclass, field for field,
JSON round-trippable, so a config file runs in either package.

The port runs every field.  :meth:`ExperimentConfig.unported` names the
settings of a config that the port cannot honour (none today), with the
ROADMAP item that ports each; the drivers raise ``NotImplementedError``
on any of them instead of ignoring it.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple


@dataclass
class ExperimentConfig:
    name: str = "experiment"
    model: str = "mnist_fc"          # model-zoo entry point name
    dataset: str = "synthetic"       # data module entry
    n_classes: int = 10
    loss: str = "cross_entropy"      # cross_entropy|lm_cross_entropy|nll|mse
    experiment: str = "prune_retrain"  # see __post_init__ for the set
    #: restrict pruning to targets containing any of these substrings
    #: (e.g. ["_ffn/", "_mlp/"] for FFN-channel-only pruning); empty = all
    target_filter: Tuple[str, ...] = ()

    # attribution
    method: str = "shapley"          # random|weight_norm|apoz|sensitivity|taylor|shapley
    method_kwargs: Dict[str, Any] = field(default_factory=dict)
    reduction: str = "mean"          # mean|sum|none|mean+2std
    find_best_evaluation_layer: bool = True
    #: one-pass sweep capture (robustness experiments): ONE compiled
    #: program computes every eval site's activation per batch and all
    #: methods/runs/ablation walks share it (O(L²)→O(L) prefix work;
    #: attributions.base.ActivationCache).  Disable to A/B the engine or
    #: to trade the cached activations' device memory back for compute.
    capture: bool = True

    # pruning schedule
    policy: str = "negative"         # negative|fraction
    fraction: float = 0.5
    #: per-layer prune-fraction overrides (substring match against the
    #: target name, like target_filter; FIRST match wins in insertion
    #: order).  A matching target prunes by the fraction policy at the
    #: mapped fraction regardless of ``policy``; non-matching targets
    #: keep ``policy``/``fraction``.  The sparsity-search campaign's
    #: per-layer-ratio axis (search/grid.py)
    layer_fractions: Dict[str, float] = field(default_factory=dict)
    bucket: int = 1                  # round kept widths up to a multiple
                                     # (8/128 = TPU sublane/lane alignment;
                                     # bounds recompile diversity)
    prune_order: str = "reverse"     # outermost layer first (reference recipe)
    score_examples: int = 1000       # val examples used for scoring

    # fine-tune / training loop
    finetune_epochs: int = 0
    epochs: int = 0                  # from-scratch training length ("train")
    batch_size: int = 64
    eval_batch_size: int = 250
    lr: float = 0.01
    #: "sgd" (reference recipe, momentum/weight_decay below), "adam", or
    #: "adamw" (decoupled weight_decay)
    optimizer: str = "sgd"
    momentum: float = 0.0
    weight_decay: float = 0.0
    #: constant | multistep | cosine | warmup_cosine.  "multistep" is the
    #: reference's MultiStepLR (cifar10.py:94-99: milestones in epochs,
    #: lr *= gamma at each); cosine variants cover the transformer configs.
    lr_schedule: str = "constant"
    lr_milestones: Tuple[int, ...] = (30, 60, 90, 120, 150)
    lr_gamma: float = 0.5
    lr_warmup_epochs: int = 0

    # distribution
    mesh: Dict[str, int] = field(default_factory=dict)  # e.g. {"data": 4, "model": 2}
    #: parameter partitioning over the mesh: "fsdp" or "tp" (pruning-
    #: graph-derived tensor parallelism); used when mesh is non-empty
    partition: str = "fsdp"
    #: ZeRO-style cross-replica weight-update sharding (composes with
    #: either partition): optimizer state lives sharded over the DATA
    #: axis, gradients reduce-scatter, the update applies to the local
    #: 1/N shard, params all-gather for the next forward — frees
    #: ~(1 - 1/data) of optimizer HBM per chip for larger batches.
    #: Requires a mesh with a "data" axis.  CLI: --zero
    zero: bool = False

    #: float32 | bfloat16 — bf16 runs the fwd/bwd at MXU rate with f32
    #: master params/updates (mixed precision, the TPU-native default for
    #: large models; see train.loop.make_train_step)
    compute_dtype: str = "float32"
    #: float32 | bfloat16 — dtype of the ATTRIBUTION scoring forwards,
    #: independent of the training dtype (bf16 scoring shifts rankings at
    #: bf16 noise level; opt in separately)
    score_dtype: str = "float32"
    #: checkpoint composite blocks during training (recompute-in-backward;
    #: the activation-memory lever for deep transformer stacks)
    remat: bool = False
    #: >1 = gradient accumulation: the batch scans through this many
    #: microbatches inside one jitted step (peak activation memory divides
    #: by the factor; same update as the full batch)
    accum_steps: int = 1
    #: >0 adds that multiple of the MoE load-balancing auxiliary loss
    #: (Switch-style; no-op for models without MoE layers)
    moe_aux_weight: float = 0.0
    #: simulated pruning: the prune loop MASKS the dropped slices (same
    #: policy, same plan) instead of re-instantiating — zero recompiles
    #: across the whole sweep; incompatible with finetune_epochs (chain
    #: core.masking.masked_update into a custom loop for that)
    simulate: bool = False

    # data pipeline / checkpointing
    augment: bool = False            # flip + pad/crop image augmentation
    prefetch: bool = True            # native background batch assembly
    #: batches kept device-resident ahead of the step (async device_put
    #: overlaps host->device transfer with compute); 0 disables
    device_prefetch: int = 2
    checkpoint_path: str = ""        # save/resume training checkpoints here
    checkpoint_every_epochs: int = 0  # 0 = only at the end

    # resilience (resilience/; CLI --resume / --chaos)
    #: resumable-run directory: manifest.json (pipeline position) +
    #: digest-verified ckpt-* checkpoints.  Non-empty = the run is
    #: preemption-safe: SIGTERM/SIGKILL mid-run, then re-run with the
    #: same run_dir (CLI ``--resume DIR``) restarts mid-round
    run_dir: str = ""
    #: mid-epoch checkpoint cadence in OPTIMIZER STEPS (train runs; for
    #: prune_retrain it additionally checkpoints after every retrain
    #: epoch).  0 = round/epoch boundaries only.  CLI --checkpoint-every
    checkpoint_every_steps: int = 0
    #: the non-finite step guard: NaN/Inf loss-or-grad steps are skipped
    #: (params, state and optimizer state held), counted
    #: (``resilience_nan_skips_total``), and after ``max_bad_steps``
    #: consecutive skips the run rolls back to the last checkpoint with
    #: the LR scaled by ``lr_backoff``.  Reading the guard flag is one
    #: host read a step — off by default
    guard_nonfinite: bool = False
    #: consecutive non-finite steps before rollback (guard_nonfinite)
    max_bad_steps: int = 3
    #: LR multiplier applied at each rollback (0 < lr_backoff <= 1)
    lr_backoff: float = 0.5
    #: rollback-recovery budget per run (NaN streaks; OOM retries have
    #: their own implicit cap at accum_steps == batch_size)
    max_rollbacks: int = 3
    #: deterministic fault injection (resilience.chaos knob dict, e.g.
    #: {"nan_at_step": 5, "kill_at_step": 12}); {} = chaos off.  Also
    #: settable via CLI --chaos / TORCHPRUNER_CHAOS env
    chaos: Dict[str, Any] = field(default_factory=dict)

    #: opt-in runtime telemetry: the train step also computes the global
    #: gradient norm, recorded as an obs gauge (one extra fused reduction
    #: in the compiled step; off by default — see torchpruner_tpu.obs)
    obs_grad_norm: bool = False

    seed: int = 0
    log_path: str = "logs/experiment.csv"
    #: when set, the robustness sweep writes its figures here (per-layer
    #: curves + the AUC summary; utils/plotting)
    plot_dir: str = ""
    #: when set, the robustness sweep dumps its full results (per-layer ×
    #: method curves, scores, AUCs) as JSON here — the durable artifact
    #: the reference keeps as a pickle (VGG notebook cell 8)
    results_path: str = ""

    def __post_init__(self):
        if self.experiment not in (
            "prune_retrain", "robustness", "train", "train_robustness"
        ):
            raise ValueError(
                f"unknown experiment {self.experiment!r} "
                "(use 'prune_retrain', 'robustness', 'train' or "
                "'train_robustness')"
            )
        if self.optimizer not in ("sgd", "adam", "adamw"):
            raise ValueError(
                f"unknown optimizer {self.optimizer!r} "
                "(use 'sgd', 'adam' or 'adamw')"
            )
        # reject silently-ignored combinations up front: momentum is an
        # sgd concept, and plain adam has no decay term (adamw does)
        if self.optimizer != "sgd" and self.momentum:
            raise ValueError(
                f"momentum is only meaningful with optimizer='sgd' "
                f"(got {self.optimizer!r})"
            )
        if self.optimizer == "adam" and self.weight_decay:
            raise ValueError(
                "optimizer='adam' ignores weight_decay — use 'adamw' "
                "for decoupled decay"
            )
        if self.lr_schedule not in (
            "constant", "multistep", "cosine", "warmup_cosine"
        ):
            raise ValueError(
                f"unknown lr_schedule {self.lr_schedule!r} (use 'constant', "
                "'multistep', 'cosine' or 'warmup_cosine')"
            )
        if self.partition not in ("fsdp", "tp"):
            raise ValueError(
                f"unknown partition {self.partition!r} (use 'fsdp' or 'tp')"
            )
        if self.zero and "data" not in (self.mesh or {}):
            raise ValueError(
                "zero=True shards the weight update over the mesh's "
                "'data' axis — set mesh={'data': N, ...} (N > 1) too"
            )
        for k, v in (self.layer_fractions or {}).items():
            if not 0.0 <= float(v) < 1.0:
                raise ValueError(
                    f"layer_fractions[{k!r}] = {v} is outside [0, 1) — "
                    "a fraction of 1 would empty the layer"
                )
        for fld in ("compute_dtype", "score_dtype"):
            if getattr(self, fld) not in ("float32", "bfloat16"):
                raise ValueError(
                    f"unknown {fld} {getattr(self, fld)!r} "
                    "(use 'float32' or 'bfloat16')"
                )
        if not 0.0 < self.lr_backoff <= 1.0:
            raise ValueError(
                f"lr_backoff must be in (0, 1], got {self.lr_backoff}"
            )
        if self.max_bad_steps < 1:
            raise ValueError(
                f"max_bad_steps must be >= 1, got {self.max_bad_steps}"
            )
        if self.checkpoint_every_steps < 0 or self.max_rollbacks < 0:
            raise ValueError(
                "checkpoint_every_steps and max_rollbacks must be >= 0"
            )
        if self.chaos:
            # fail at config time, not at injection time mid-run
            from torchpruner_tpu_torch.resilience.chaos import ChaosConfig

            ChaosConfig.from_any(self.chaos)
        if self.simulate and self.finetune_epochs:
            raise ValueError(
                "simulate=True masks parameters without pinning them in "
                "the optimizer, so fine-tuning would regrow them — chain "
                "core.masking.masked_update into a custom loop instead"
            )

    def unported(self):
        """``[(setting, ROADMAP item)]`` for every setting of this config
        that the port does not run yet (empty when it runs them all)."""
        return [(f"{name}={getattr(self, name)!r}", item)
                for name, default, item in _UNPORTED
                if getattr(self, name) != default]

    def to_json(self, path: str):
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def from_json(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        for key in ("target_filter", "lr_milestones"):  # JSON has no tuples
            if key in raw:
                raw[key] = tuple(raw[key])
        return cls(**raw)


#: (field, default, ROADMAP item) of the settings the port does not run
_UNPORTED: Tuple[Tuple[str, Any, str], ...] = ()
