"""Model families of the port: Llama (serving, causal training) and BERT
(the GLUE Sensitivity-pruning preset)."""

from torchpruner_tpu_torch.models.bert import (  # noqa: F401
    bert,
    bert_base,
    bert_tiny,
)
from torchpruner_tpu_torch.models.llama import (  # noqa: F401
    llama,
    llama3_8b,
    llama_tiny,
    mfu_llama,
)
