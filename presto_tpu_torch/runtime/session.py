"""Session: the client-facing query surface (parse -> analyze -> plan ->
execute).

Counterpart of ``presto_tpu/runtime/session.py`` for plain queries:
``Session(catalogs, properties=...)``, ``plan``, ``explain`` and ``sql``.
``sql`` returns a ``QueryResult`` (names plus numpy arrays; the JAX
package returns a pandas DataFrame, and the port imports no pandas).
Queries run on ``device`` ("cuda" unless the caller asks for the CPU).
DDL, prepared statements, EXPLAIN ANALYZE, the system catalog, caches,
tracing, lifecycle control and the distributed executor are not ported.
"""

from __future__ import annotations

import os
from typing import Mapping

from presto_tpu_torch.batch import QueryResult
from presto_tpu_torch.devices import resolve_device
from presto_tpu_torch.exec.local_planner import LocalExecutor
from presto_tpu_torch.plan.catalog import Catalog
from presto_tpu_torch.plan.nodes import PlanNode, plan_tree_str
from presto_tpu_torch.plan.prune import prune
from presto_tpu_torch.runtime.errors import NotSupported
from presto_tpu_torch.runtime.properties import effective, validate_properties
from presto_tpu_torch.sql import ast as A
from presto_tpu_torch.sql.analyzer import Analyzer
from presto_tpu_torch.sql.parser import parse


class Session:
    def __init__(self, connectors: Mapping[str, object], properties=None, device="cuda"):
        self.catalog = Catalog(dict(connectors))
        self.analyzer = Analyzer(self.catalog)
        self.properties = validate_properties(dict(properties or {}))
        self.device = resolve_device(device)

    def prop(self, name: str):
        """Effective value of a session property (override or default)."""
        return effective(self.properties, name)

    def plan(self, sql: str) -> PlanNode:
        stmt = parse(sql)
        if not isinstance(stmt, (A.Query, A.SetQuery)):
            raise NotSupported(f"{type(stmt).__name__} statements are not ported yet")
        return prune(self.analyzer.analyze(stmt))

    def explain(self, sql: str) -> str:
        """The pruned plan with its planned join and aggregation
        strategies (``strategy=sketch(approx)`` where ``approx_join``
        would probe a Bloom sketch)."""
        return plan_tree_str(self.plan(sql), catalog=self.catalog,
                             approx_join=self.prop("approx_join"))

    def executor(self) -> LocalExecutor:
        """A fresh executor configured from the session properties."""
        narrow = self.prop("narrow_storage")
        if narrow is not None:
            # connectors and the leaf-route matcher read the switch
            # (spi.narrow_enabled); mirror the property there, as the JAX
            # package does (process-wide)
            os.environ["PRESTO_TPU_NARROW"] = "1" if narrow else "0"
        return LocalExecutor(self.catalog, pallas_join_enabled=self.prop("pallas_join"),
                             approx_join=self.prop("approx_join"),
                             runtime_join_filters=self.prop("runtime_join_filters"),
                             device=self.device)

    def explain_analyze(self, sql: str) -> str:
        """EXPLAIN ANALYZE (the plan annotated with each node's actuals)
        needs the JAX package's stats recorder, which is not ported."""
        raise NotSupported("EXPLAIN ANALYZE is not ported yet")

    def sql(self, sql: str) -> QueryResult:
        """Execute one query and return its rows (``QueryResult.approximate``
        says whether a semi join probed the Bloom sketch)."""
        return self.executor().run(self.plan(sql))
