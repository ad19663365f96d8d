"""Named experiment presets and the model registry — counterpart of
``torchpruner_tpu/experiments/presets.py`` (the full preset table, the
same configs field for field) and of ``MODEL_REGISTRY`` in
``torchpruner_tpu/experiments/prune_retrain.py`` (every entry,
with the same default datasets).
``smoke=True`` swaps in the miniature
model/dataset variants with the identical block structure.  A preset
whose settings the port does not run yet still resolves here; the
driver raises on it (``ExperimentConfig.unported``).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from torchpruner_tpu_torch.models import (
    bert_base,
    bert_tiny,
    cifar10_fc,
    digits_convnet,
    digits_fc,
    digits_fc_tiny,
    fmnist_convnet,
    llama3_8b,
    llama_tiny,
    mfu_llama,
    mnist_fc,
    resnet20_cifar,
    resnet50,
    vgg16_bn,
    vgg16_bn_tiny,
    vit_b16,
    vit_tiny,
)
from torchpruner_tpu_torch.utils.config import ExperimentConfig

#: model name -> (builder, default dataset)
MODEL_REGISTRY: Dict[str, Tuple[Callable, str]] = {
    "mnist_fc": (mnist_fc, "mnist_flat"),
    "cifar10_fc": (cifar10_fc, "cifar10_flat"),
    "digits_fc": (digits_fc, "digits_flat"),
    "digits_fc_tiny": (digits_fc_tiny, "digits_flat"),
    "digits_convnet": (digits_convnet, "digits"),
    "fmnist_convnet": (fmnist_convnet, "fashion_mnist"),
    "vgg16_bn": (vgg16_bn, "cifar10"),
    "vgg16_bn_tiny": (vgg16_bn_tiny, "cifar10"),
    "resnet50": (resnet50, "imagenet"),
    "resnet20_cifar": (resnet20_cifar, "cifar10"),
    "vit_b16": (vit_b16, "imagenet"),
    "vit_tiny": (vit_tiny, "tiny_images16"),
    "bert_base": (bert_base, "glue_sst2"),
    "bert_tiny": (bert_tiny, "glue_tiny"),
    "llama3_8b": (llama3_8b, "lm_corpus"),
    "llama_tiny": (llama_tiny, "lm_tiny"),
    "mfu_llama": (mfu_llama, "lm_mfu"),
}


def mnist_mlp_shapley(smoke: bool = False) -> ExperimentConfig:
    """Config 0: the reference's "Pruning Untrained Networks" MNIST MLP —
    784-2024-2024-10 FC net, Shapley attribution on both hidden layers,
    all-negative-attribution prune, short fine-tune.  The smoke variant
    runs the identical recipe on the 64-64-64-10 digits MLP in seconds on
    one CPU — the obs quick-lane smoke target (tests/test_obs.py)."""
    return ExperimentConfig(
        name="mnist_mlp_shapley",
        model="digits_fc_tiny" if smoke else "mnist_fc",
        dataset="digits_flat" if smoke else "mnist_flat",
        method="shapley",
        method_kwargs={"sv_samples": 2 if smoke else 5},
        policy="negative",
        finetune_epochs=1,
        score_examples=32 if smoke else 1000,
        batch_size=32 if smoke else 64,
        eval_batch_size=64 if smoke else 250,
        lr=0.05 if smoke else 0.01,
    )


def vgg16_layerwise(smoke: bool = False) -> ExperimentConfig:
    """Config 1 — the reference's own recipe: CIFAR-10 VGG16 layerwise
    pruning (VGG notebook; SURVEY.md §2.8)."""
    return ExperimentConfig(
        name="vgg16_layerwise",
        model="vgg16_bn_tiny" if smoke else "vgg16_bn",
        dataset="cifar10",
        experiment="robustness",
        method="shapley" if smoke else "all",
        method_kwargs={"sv_samples": 5},
        score_examples=64 if smoke else 1000,
        eval_batch_size=64 if smoke else 250,
        score_dtype="float32" if smoke else "bfloat16",  # MXU-rate sweep
        results_path="" if smoke else "logs/vgg16_sweep_results.json",
    )


def vgg16_digits32_layerwise(smoke: bool = False) -> ExperimentConfig:
    """Config 1b — the same two-phase recipe (pretrain → full layerwise
    sweep) runnable END TO END in this environment: digits32 is REAL
    image data (sklearn digit scans at CIFAR-10 geometry), so the sweep
    scores a genuinely trained full-width VGG16-bn without the CIFAR-10
    distribution files.  One command, no checkpoint hand-off."""
    return ExperimentConfig(
        name="vgg16_digits32_layerwise",
        model="vgg16_bn_tiny" if smoke else "vgg16_bn",
        dataset="digits32",
        experiment="train_robustness",
        epochs=1 if smoke else 12,
        batch_size=64 if smoke else 128,
        optimizer="adam",
        lr=1e-3,
        lr_schedule="constant",
        compute_dtype="float32" if smoke else "bfloat16",
        method="shapley" if smoke else "all",
        method_kwargs={"sv_samples": 5},
        score_examples=64 if smoke else 300,
        eval_batch_size=64 if smoke else 300,
        score_dtype="float32" if smoke else "bfloat16",
        results_path="" if smoke else "logs/vgg16_digits32_sweep.json",
    )


def resnet50_taylor(smoke: bool = False) -> ExperimentConfig:
    """Config 2: ResNet-50 / ImageNet structured filter pruning, Taylor
    criterion."""
    return ExperimentConfig(
        name="resnet50_taylor",
        model="resnet20_cifar" if smoke else "resnet50",
        dataset="cifar10" if smoke else "imagenet",
        n_classes=10 if smoke else 1000,
        method="taylor",
        policy="fraction",
        fraction=0.25,
        finetune_epochs=0 if smoke else 1,
        score_examples=64 if smoke else 1000,
        eval_batch_size=64 if smoke else 250,
        lr=0.01,
        momentum=0.9,
    )


def bert_glue_sensitivity(smoke: bool = False) -> ExperimentConfig:
    """Config 3: BERT-base Linear-layer pruning on GLUE, Sensitivity
    criterion — targets the per-block FFN hidden Linears."""
    return ExperimentConfig(
        name="bert_glue_sensitivity",
        model="bert_tiny" if smoke else "bert_base",
        dataset="glue_tiny" if smoke else "glue_sst2",
        n_classes=2,
        method="sensitivity",
        policy="fraction",
        fraction=0.3,
        target_filter=("_mlp/",),
        score_examples=64 if smoke else 1000,
        batch_size=16 if smoke else 32,
        eval_batch_size=64 if smoke else 128,
        lr=3e-3,
        compute_dtype="float32" if smoke else "bfloat16",
    )


def vit_head_mlp_shapley(smoke: bool = False) -> ExperimentConfig:
    """Config 4: ViT-B/16 attention-head + MLP pruning, Shapley
    (sv_samples=5)."""
    return ExperimentConfig(
        name="vit_head_mlp_shapley",
        model="vit_tiny" if smoke else "vit_b16",
        dataset="tiny_images16" if smoke else "imagenet",
        n_classes=10 if smoke else 1000,
        method="shapley",
        method_kwargs={"sv_samples": 5},
        policy="negative",
        target_filter=("_attn/", "_mlp/"),
        score_examples=64 if smoke else 1000,
        eval_batch_size=64 if smoke else 128,
    )


def llama3_ffn_taylor(smoke: bool = False) -> ExperimentConfig:
    """Config 5: Llama-3-8B FFN channel pruning + fine-tune (pjit FSDP).
    Attribution on LM loss; FFN GatedDense channels only; the full-size run
    shards over a ``{"data": 8, "model": 8}`` mesh (v5p-64-shaped)."""
    return ExperimentConfig(
        name="llama3_ffn_taylor",
        model="llama_tiny" if smoke else "llama3_8b",
        dataset="lm_tiny" if smoke else "lm_corpus",
        loss="lm_cross_entropy",
        method="taylor",
        policy="fraction",
        fraction=0.25,
        target_filter=("_ffn/",),
        finetune_epochs=0 if smoke else 1,
        score_examples=32 if smoke else 512,
        batch_size=8 if smoke else 16,
        eval_batch_size=16 if smoke else 32,
        lr=1e-4,
        mesh={} if smoke else {"data": 8, "model": 8},
        # TPU-native at 8B scale: bf16 fwd/bwd (f32 masters) and
        # recompute-in-backward blocks so S=2048 activations fit HBM
        compute_dtype="float32" if smoke else "bfloat16",
        remat=not smoke,
    )


PRESETS: Dict[str, Callable[..., ExperimentConfig]] = {
    "mnist_mlp_shapley": mnist_mlp_shapley,
    "vgg16_layerwise": vgg16_layerwise,
    "vgg16_digits32_layerwise": vgg16_digits32_layerwise,
    "resnet50_taylor": resnet50_taylor,
    "bert_glue_sensitivity": bert_glue_sensitivity,
    "vit_head_mlp_shapley": vit_head_mlp_shapley,
    "llama3_ffn_taylor": llama3_ffn_taylor,
}


def preset_names() -> tuple:
    """Every shipped preset name — the sweep surface CI lints
    (``--lint <name>`` must report zero errors for each) and the CLI
    lists."""
    return tuple(PRESETS)


def get_preset(name: str, smoke: bool = False) -> ExperimentConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; known: {list(PRESETS)}")
    return PRESETS[name](smoke=smoke)


def preset_model(name: str, smoke: bool = False) -> str:
    """The model a preset (or a bare registry name) names."""
    if name in PRESETS:
        return get_preset(name, smoke=smoke).model
    if name in MODEL_REGISTRY:
        return name
    raise KeyError(f"unknown preset/model {name!r}; presets: "
                   f"{list(PRESETS)}; models: {list(MODEL_REGISTRY)}")
