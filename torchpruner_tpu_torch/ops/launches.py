"""The port's kernel wrappers grouped by the kernel bodies they launch,
and their launch counts — what a profiler window's device events are
held against.

Every wrapper adds one to its ``launches`` count where it launches one
kernel of ``csrc/*.cu``, and only on a CUDA tensor.  The wrappers of a
group launch the same bodies (named by their base kernel name,
``obs.profile.kernels.base_kernel_name``), so over any stretch of a run
a group's body events in a profiler trace should equal the growth of
its wrappers' counts.
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

#: group -> (its wrappers as ``module:function`` under ``ops``, the base
#: names of the kernel bodies they launch)
GROUPS: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    "dequant_matmul": (("fused_matmul:dequant_matmul",), ("dq_mma",)),
    "decode_attention": (("decode_attention:decode_attention",),
                         ("decode_split",)),
    "flash_fwd": (("flash_attention:flash_fwd",),
                  ("fwd_wgmma", "fwd_tf32x3")),
    "flash_dq": (("flash_attention:flash_dq",), ("dq_wgmma", "dq_tf32x3")),
    "flash_dkv": (("flash_attention:flash_dkv",),
                  ("dkv_wgmma", "dkv_tf32x3")),
    "blocksparse": (("blocksparse:blocksparse_fwd",
                     "blocksparse:blocksparse_dx",
                     "blocksparse:blocksparse_dw"),
                    ("bs_kernel", "bs_tf32x3", "bs_wgmma")),
}

#: kernel body base name -> its group
BODY_GROUP: Dict[str, str] = {b: g for g, (_, bodies) in GROUPS.items()
                              for b in bodies}


def counts() -> Dict[str, int]:
    """Each group's launches so far (its wrappers' counts summed)."""
    out = {}
    for group, (wrappers, _) in GROUPS.items():
        n = 0
        for w in wrappers:
            mod, fn = w.split(":")
            n += getattr(importlib.import_module(
                f"torchpruner_tpu_torch.ops.{mod}"), fn).launches
        out[group] = n
    return out
