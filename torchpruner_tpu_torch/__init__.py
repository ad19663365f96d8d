"""torchpruner_tpu_torch — the PyTorch/CUDA port of torchpruner_tpu.

The JAX package (``torchpruner_tpu``) is the reference; this package
mirrors its module layout and parameter-tree names so each counterpart
is easy to find.  It imports ``torch`` and never ``jax`` or
``torchpruner_tpu``.

Two slices are ported so far.  Serving: the Llama model family,
int4/int8 weight-only quantization, KV-cache decoding (``generate``) and
the continuous-batching engine (``serve``).  The prune loop: the
full-sequence forward with attribution taps (``core/``), BERT, the
pruning graph and surgery, the APoZ/Sensitivity/Taylor metrics, the
trainer with its functional optimizers, and the ``--preset``/``--config``
driver.  The TPU kernels on those paths are rewritten by hand for Hopper
(``ops/fused_matmul.py``, ``ops/decode_attention.py``,
``ops/flash_attention.py``; CUDA sources under ``csrc/``).

Importing the package builds nothing and touches no device: kernels are
compiled at their first launch, and every entry point runs on ``cuda``
unless the caller asks for the CPU.
"""

__all__: list = []
