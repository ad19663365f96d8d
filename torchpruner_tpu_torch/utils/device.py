"""Device selection for the port's entry points.

Every entry point runs on ``cuda`` unless the caller asks for the CPU
(``device="cpu"`` / ``--cpu``).  Without a GPU and without that request
it raises: the port never drops to the CPU on its own, so a result can
never be mistaken for a GPU result."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``; ``"cpu"`` is honoured only when asked.
    Raises ``RuntimeError`` when CUDA is wanted but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --cpu) "
            "to run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def strict_fp32_matmul() -> None:
    """Full-float32 matrix products on the card (no TF32), the precision
    the JAX reference computes in: set by every entry point that runs on
    CUDA so float32 models compare like with like."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
