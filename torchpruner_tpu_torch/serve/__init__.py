"""``torchpruner_tpu_torch.serve`` — continuous-batching inference on the
pruned decode path, counterpart of ``torchpruner_tpu.serve``:

- :class:`~.request.Request` / :class:`~.request.Sampling` — one
  generation job with per-request sampling;
- :class:`~.allocator.KVCacheAllocator` / :class:`~.allocator.PrefixTrie`
  — slot, page and prefix-page bookkeeping over the static serving cache;
- :class:`~.scheduler.Scheduler` — admission / eviction at decode-step
  boundaries, QoS (:mod:`.qos`), the queue bound and the drain;
- :class:`~.engine.ServeEngine` — bucketed or chunked prefill, prefix
  pages, the shared slot-array decode, checkpoint hot-swap, SIGTERM
  drain;
- :mod:`.traffic` — open-loop Poisson / step-staggered synthetic and
  shared-prefix workloads;
- :class:`~.slo.SLOMonitor` — rolling p99 SLO gates and burn rates;
- ``python -m torchpruner_tpu_torch serve <preset>`` — the endpoint
  (:mod:`.frontend`): synthetic, stdin or HTTP traffic.
"""

from torchpruner_tpu_torch.serve.allocator import (
    KVCacheAllocator,
    PrefixTrie,
    aligned_len,
    bucket_for,
    prefill_buckets,
)
from torchpruner_tpu_torch.serve.engine import (
    ServeEngine,
    sample_tokens,
    vocab_of,
)
from torchpruner_tpu_torch.serve.qos import (
    QoS,
    TenantPolicy,
    TokenBucket,
)
from torchpruner_tpu_torch.serve.request import (
    Request,
    Sampling,
    request_from_dict,
)
from torchpruner_tpu_torch.serve.scheduler import Scheduler
from torchpruner_tpu_torch.serve.slo import SLOMonitor
from torchpruner_tpu_torch.serve.traffic import (
    OpenLoopTraffic,
    open_loop,
    poisson_arrivals,
    shared_prefix_requests,
    staggered_arrivals,
    synthetic_requests,
)

__all__ = [
    "Request", "Sampling", "KVCacheAllocator", "PrefixTrie", "Scheduler",
    "ServeEngine", "OpenLoopTraffic", "open_loop", "poisson_arrivals",
    "staggered_arrivals", "synthetic_requests", "shared_prefix_requests",
    "aligned_len", "bucket_for", "prefill_buckets", "sample_tokens",
    "vocab_of", "SLOMonitor", "request_from_dict",
    "QoS", "TenantPolicy", "TokenBucket",
]
