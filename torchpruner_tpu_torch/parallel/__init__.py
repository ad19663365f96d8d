"""Distribution layer on ``torch.distributed`` — counterpart of
``torchpruner_tpu/parallel/``: device meshes, placement rules, the
per-rank memory plan, data-parallel attribution scoring and DP x FSDP /
TP training with ZeRO weight-update sharding.

The JAX package lets XLA insert the collectives from named shardings;
here one process per device (``torchrun``) holds its pieces and the
collectives are explicit (``parallel/collectives.py``).  Sequence
parallelism: ``ring`` and ``ulysses`` attention and the ``sp`` trainer
over a ``data x seq`` mesh; pipeline parallelism: ``pipeline`` (stages
over local devices in one process, 1F1B) and ``pp_spmd`` (one process a
stage, activations shifted over the ``pp`` group).
"""

from torchpruner_tpu_torch.parallel.mesh import (
    initialize_distributed,
    make_hybrid_mesh,
    make_mesh,
    mesh_axes,
)
from torchpruner_tpu_torch.parallel.sharding import (
    batch_sharding,
    fsdp_sharding,
    replicate,
    shard_batch,
    shard_params,
    tp_sharding,
    tp_specs,
    zero_update_sharding,
    zero_update_spec,
)
from torchpruner_tpu_torch.parallel.memory import (
    HBM_BYTES,
    MemoryBudget,
    training_memory,
)
from torchpruner_tpu_torch.parallel.scoring import DistributedScorer
from torchpruner_tpu_torch.parallel.train import ShardedTrainer
from torchpruner_tpu_torch.parallel.ring import (
    ring_attention,
    ring_attention_local,
)
from torchpruner_tpu_torch.parallel.ulysses import (
    choose_sp_strategy,
    sequence_parallel_attention,
    ulysses_attention,
    ulysses_attention_local,
)
from torchpruner_tpu_torch.parallel.pipeline import (
    PipelineParallel,
    balance_stages,
)
from torchpruner_tpu_torch.parallel.pp_spmd import (
    pp_spmd_apply,
    pp_spmd_train_step,
    split_pipeline,
    stack_block_params,
    stage_params,
)
from torchpruner_tpu_torch.parallel.sp import SPTrainer, sp_model

__all__ = [
    "initialize_distributed",
    "make_hybrid_mesh",
    "make_mesh",
    "mesh_axes",
    "batch_sharding",
    "fsdp_sharding",
    "replicate",
    "shard_batch",
    "shard_params",
    "tp_sharding",
    "tp_specs",
    "zero_update_sharding",
    "zero_update_spec",
    "DistributedScorer",
    "HBM_BYTES",
    "MemoryBudget",
    "training_memory",
    "ShardedTrainer",
    "ring_attention",
    "ring_attention_local",
    "choose_sp_strategy",
    "sequence_parallel_attention",
    "ulysses_attention",
    "ulysses_attention_local",
    "PipelineParallel",
    "pp_spmd_apply",
    "pp_spmd_train_step",
    "split_pipeline",
    "stack_block_params",
    "stage_params",
    "balance_stages",
    "SPTrainer",
    "sp_model",
]
