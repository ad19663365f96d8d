"""Attribution metrics of the port (Random, WeightNorm, APoZ,
Sensitivity, Taylor, Shapley) and the one-pass ``ActivationCache`` a
sweep shares between them (install on ``metric.capture_cache``;
``experiments.robustness.layerwise_robustness`` does)."""

from torchpruner_tpu_torch.attributions.activation import (  # noqa: F401
    APoZAttributionMetric,
    SensitivityAttributionMetric,
    TaylorAttributionMetric,
)
from torchpruner_tpu_torch.attributions.base import (  # noqa: F401
    ActivationCache,
    AttributionMetric,
)
from torchpruner_tpu_torch.attributions.shapley import (  # noqa: F401
    ShapleyAttributionMetric,
)
from torchpruner_tpu_torch.attributions.simple import (  # noqa: F401
    RandomAttributionMetric,
    WeightNormAttributionMetric,
)
