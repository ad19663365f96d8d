"""Kernel-level continuous profiling (the obs layer's microscope) —
counterpart of ``torchpruner_tpu/obs/profile/``.

The spans/metrics stack says *which phase* a run spent its wall-clock
in; this package says *which kernels* — per-kernel step-time attribution
from programmatic ``torch.profiler`` capture windows, roofline-
positioned, memory-tracked, and gateable:

- :mod:`~torchpruner_tpu_torch.obs.profile.capture` — capture windows on a
  step cadence / on demand (``ContinuousProfiler``);
- :mod:`~torchpruner_tpu_torch.obs.profile.kernels` — trace → ranked
  per-kernel table (ms/step, % of step, launch count, roofline
  position) + ``kernel_*`` gate scalars + ``profile.json``;
- :mod:`~torchpruner_tpu_torch.obs.profile.hbm` — allocation watermark per
  span phase with a fragmentation estimate.

Drivers enable it with ``obs.configure(obs_dir, profile_every=N)``
(CLI ``--profile-every``), read it with
``python -m torchpruner_tpu_torch obs profile <dir>``, and gate it with the
``kernel_<name>_ms`` scalars in ``obs diff --gate`` — which is how a
kernel regression fails CI even when the total step time stays green.
"""

from torchpruner_tpu_torch.obs.profile.capture import (
    ContinuousProfiler,
    OneShotCapture,
    scan_windows,
)
from torchpruner_tpu_torch.obs.profile.hbm import HbmSampler
from torchpruner_tpu_torch.obs.profile.kernels import (
    base_kernel_name,
    build_profile,
    format_profile,
    kernel_gauges,
    kernel_scalar_name,
    kernel_table,
    load_profile,
    top_rows,
)

__all__ = [
    "ContinuousProfiler", "HbmSampler", "OneShotCapture", "scan_windows",
    "base_kernel_name", "build_profile", "format_profile",
    "kernel_gauges", "kernel_scalar_name", "kernel_table",
    "load_profile", "top_rows",
]
