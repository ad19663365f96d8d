"""Attribution metrics of the port (APoZ, Sensitivity, Taylor)."""

from torchpruner_tpu_torch.attributions.activation import (  # noqa: F401
    APoZAttributionMetric,
    SensitivityAttributionMetric,
    TaylorAttributionMetric,
)
from torchpruner_tpu_torch.attributions.base import (  # noqa: F401
    AttributionMetric,
)
