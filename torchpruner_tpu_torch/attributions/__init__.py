"""Attribution metrics of the port (Random, WeightNorm, APoZ,
Sensitivity, Taylor, Shapley)."""

from torchpruner_tpu_torch.attributions.activation import (  # noqa: F401
    APoZAttributionMetric,
    SensitivityAttributionMetric,
    TaylorAttributionMetric,
)
from torchpruner_tpu_torch.attributions.base import (  # noqa: F401
    AttributionMetric,
)
from torchpruner_tpu_torch.attributions.shapley import (  # noqa: F401
    ShapleyAttributionMetric,
)
from torchpruner_tpu_torch.attributions.simple import (  # noqa: F401
    RandomAttributionMetric,
    WeightNormAttributionMetric,
)
