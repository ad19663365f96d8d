"""Distribution layer on ``torch.distributed`` — counterpart of
``torchpruner_tpu/parallel/``: device meshes, placement rules, the
per-rank memory plan, data-parallel attribution scoring and DP x FSDP /
TP training with ZeRO weight-update sharding.

The JAX package lets XLA insert the collectives from named shardings;
here one process per device (``torchrun``) holds its pieces and the
collectives are explicit (``parallel/collectives.py``).  Sequence and
pipeline parallelism (``sp``, ``ring``, ``ulysses``, ``pipeline``,
``pp_spmd``) are not ported yet (ROADMAP A7b).
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
]
