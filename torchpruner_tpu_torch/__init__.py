"""torchpruner_tpu_torch — the PyTorch/CUDA port of torchpruner_tpu.

The JAX package (``torchpruner_tpu``) is the reference; this package
mirrors its module layout and parameter-tree names so each counterpart
is easy to find.  It imports ``torch`` and never ``jax`` or
``torchpruner_tpu``.

Serving: the Llama model family, int4/int8 weight-only quantization,
KV-cache decoding (``generate``) and the continuous-batching engine
(``serve``: chunked prefill, prefix pages, hot-swap, drain, the stdin
and HTTP front ends).  The prune loop: the full-sequence forward with
attribution taps (``core/``), the model families, the pruning graph and
surgery, the attribution metrics, the trainer with its functional
optimizers, mask-based pruning, the train and robustness drivers and
the ``--preset``/``--config`` CLI.  Checkpoints (``checkpoint.py``) in
the JAX package's format.  The TPU kernels on those paths are rewritten by hand for Hopper
(``ops/fused_matmul.py``, ``ops/decode_attention.py``,
``ops/flash_attention.py``; CUDA sources under ``csrc/``).

Importing the package builds nothing and touches no device: kernels are
compiled at their first launch, and every entry point runs on ``cuda``
unless the caller asks for the CPU.
"""

__all__ = ["ActivationCache", "nan_cascade_oracle"]


def __getattr__(name):
    # the exports load on first use, so importing the package stays light
    if name == "ActivationCache":
        from torchpruner_tpu_torch.attributions.base import ActivationCache

        return ActivationCache
    if name == "nan_cascade_oracle":
        from torchpruner_tpu_torch.core.graph import nan_cascade_oracle

        return nan_cascade_oracle
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
