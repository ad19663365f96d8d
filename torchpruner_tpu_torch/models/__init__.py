"""Model families of the port: Llama (serving, causal training) and its
Mixtral-style MoE variant (expert pruning, MoE serving), BERT
(the GLUE Sensitivity-pruning preset), the fully-connected nets and ViT
(the Shapley presets), VGG16-bn (the layerwise-robustness sweep), the
convnets and ResNets (BatchNorm conv families), and the analytic
``max_model`` fixture."""

from torchpruner_tpu_torch.models.analytic import (  # noqa: F401
    max_model,
    max_model_batches,
)
from torchpruner_tpu_torch.models.bert import (  # noqa: F401
    bert,
    bert_base,
    bert_tiny,
)
from torchpruner_tpu_torch.models.convnet import (  # noqa: F401
    digits_convnet,
    fmnist_convnet,
)
from torchpruner_tpu_torch.models.llama import (  # noqa: F401
    llama,
    llama3_8b,
    llama_moe,
    llama_moe_tiny,
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
from torchpruner_tpu_torch.models.resnet import (  # noqa: F401
    resnet18,
    resnet20_cifar,
    resnet50,
)
from torchpruner_tpu_torch.models.vgg import (  # noqa: F401
    vgg16_bn,
    vgg16_bn_tiny,
)
