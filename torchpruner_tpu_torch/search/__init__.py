"""Pareto sparsity-search campaigns — the port of
``torchpruner_tpu/search/``.

``search/`` turns the one-experiment prune-retrain loop into a
*campaign*: a grid of trials (per-layer prune fractions × attribution
method × schedule) pre-priced statically, scheduled concurrently across
worker processes on the preemption-safe resume machinery, early-stopped
when Pareto-dominated, and distilled into an accuracy-vs-FLOPs
``frontier.json`` with full provenance per point.

- :mod:`~torchpruner_tpu_torch.search.grid` — campaign specs and trial
  enumeration (``CampaignSpec``, named presets);
- :mod:`~torchpruner_tpu_torch.search.pricing` — staged pre-pricing
  gates (config validity → predicted memory → predicted trial cost);
- :mod:`~torchpruner_tpu_torch.search.frontier` — dominance rules, the
  frontier artifact, its digest, gauges, and rendering;
- :mod:`~torchpruner_tpu_torch.search.driver` — the campaign driver,
  worker entry point, and ``python -m torchpruner_tpu_torch search``.
"""

from torchpruner_tpu_torch.search.frontier import (
    build_frontier,
    curve_dominated,
    dominates,
    format_frontier,
    frontier_digest,
    pareto_flags,
)
from torchpruner_tpu_torch.search.grid import (
    CAMPAIGNS,
    CampaignSpec,
    TrialSpec,
    campaign_names,
)

__all__ = [
    "CAMPAIGNS", "CampaignSpec", "TrialSpec", "campaign_names",
    "build_frontier", "curve_dominated", "dominates", "format_frontier",
    "frontier_digest", "pareto_flags",
]
