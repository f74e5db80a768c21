"""Host-side serving surface over the port's index (counterpart of
``repro.serving``).

Two levels:

* `QueryServer.query` / `QueryServer.query_many` — synchronous, typed
  (`QueryResult`), instrumented single-index serving;
* `ServingFrontend` / `FrontendServer` — the async front door: bounded
  admission queue with explicit backpressure, per-tenant token-bucket
  quotas, and deadline-aware dynamic batching into fused ``query_many``
  dispatches, plus the stdlib HTTP/JSON endpoint.

`repro_torch.serving.loadgen` drives offered-load sweeps against either
level.  `ShardedSinnamonIndex` / `TieredShardedSinnamonIndex`
(`repro_torch.serving.sharded`) serve S corpus shards from one process;
`QueryServer` and the front door serve them unchanged.
"""

from repro_torch.serving import loadgen
from repro_torch.serving.frontend import (
    DeadlineExceeded,
    DeviceStuck,
    FrontendServer,
    Rejected,
    ServingFrontend,
    TenantQuota,
)
from repro_torch.serving.results import QueryResult, new_trace_id
from repro_torch.serving.serve import QueryServer
from repro_torch.serving.sharded import (
    ShardedSinnamonIndex,
    TieredShardedSinnamonIndex,
)

__all__ = [
    "DeadlineExceeded",
    "DeviceStuck",
    "FrontendServer",
    "QueryResult",
    "QueryServer",
    "Rejected",
    "ServingFrontend",
    "ShardedSinnamonIndex",
    "TenantQuota",
    "TieredShardedSinnamonIndex",
    "loadgen",
    "new_trace_id",
]
