"""Model families of the port (the Llama family serves in this slice)."""

from torchpruner_tpu_torch.models.llama import (  # noqa: F401
    llama,
    llama3_8b,
    llama_tiny,
    mfu_llama,
)
