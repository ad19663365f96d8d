"""The presets and model registry that ``serve`` resolves — counterpart of
the ``PRESETS`` table in ``torchpruner_tpu/experiments/presets.py`` and
``MODEL_REGISTRY`` in ``torchpruner_tpu/experiments/prune_retrain.py``,
reduced to the entries whose model the port serves.  A preset names the
model it prunes; ``--smoke`` swaps in the miniature variant with the same
block structure."""

from __future__ import annotations

from typing import Callable, Dict

from torchpruner_tpu_torch.models import llama3_8b, llama_tiny, mfu_llama

#: model name -> builder
MODEL_REGISTRY: Dict[str, Callable] = {
    "llama3_8b": llama3_8b,
    "llama_tiny": llama_tiny,
    "mfu_llama": mfu_llama,
}

#: preset -> (model, smoke model)
PRESETS: Dict[str, tuple] = {
    "llama3_ffn_taylor": ("llama3_8b", "llama_tiny"),
}


def preset_model(name: str, smoke: bool = False) -> str:
    """The model a preset (or a bare registry name) serves."""
    if name in PRESETS:
        full, small = PRESETS[name]
        return small if smoke else full
    if name in MODEL_REGISTRY:
        return name
    raise KeyError(f"unknown preset/model {name!r}; presets: "
                   f"{list(PRESETS)}; models: {list(MODEL_REGISTRY)}")
