"""Model families of the port: Llama (serving, causal training), BERT
(the GLUE Sensitivity-pruning preset), the fully-connected nets and ViT
(the Shapley presets), and the analytic ``max_model`` fixture."""

from torchpruner_tpu_torch.models.analytic import (  # noqa: F401
    max_model,
    max_model_batches,
)
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
from torchpruner_tpu_torch.models.mlp import (  # noqa: F401
    cifar10_fc,
    digits_fc,
    digits_fc_tiny,
    fc_net,
    mnist_fc,
)
from torchpruner_tpu_torch.models.vit import (  # noqa: F401
    vit,
    vit_b16,
    vit_tiny,
)
