"""Streaming ingestion and continuous queries.

Counterpart of ``presto_tpu/stream/``: micro-batch appends land on the
memory connector through :class:`StreamWriter` with incremental stats and
per-append version epochs (``connectors/memory.py``), and
:class:`ContinuousQuery` subscriptions registered through the server
re-execute a prepared plan template whenever a referenced table's epoch
advances (or on an interval tick). Refreshes are same-template
re-executions, so they ride the template batch gate and the fair
scheduler's tenant quotas.

Freshness contract: a delivered result reflects at least the epoch
snapshot taken when its refresh fired (plan fingerprints fold live table
versions, and delivery asserts it: ``subscription.stale_blocked`` stays
0).
"""

from presto_tpu_torch.stream.subscriptions import (
    ContinuousQuery,
    SubscriptionManager,
    SubscriptionResult,
)
from presto_tpu_torch.stream.writer import AppendResult, StreamWriter

__all__ = [
    "AppendResult",
    "ContinuousQuery",
    "StreamWriter",
    "SubscriptionManager",
    "SubscriptionResult",
]
