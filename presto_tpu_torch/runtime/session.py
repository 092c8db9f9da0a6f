"""Session: the client-facing query surface (parse -> analyze -> plan ->
execute).

Counterpart of ``presto_tpu/runtime/session.py`` for a local run:
``Session(catalogs, properties=...)``, ``plan``, ``explain``,
``explain_analyze``, ``sql``, ``execute``, ``prepare`` and
``execute_prepared``. ``sql`` returns a ``QueryResult`` (names plus numpy
arrays; the JAX package returns a pandas DataFrame, and the port imports
no pandas) and also answers CREATE TABLE AS / INSERT INTO / DROP TABLE
against the session's writable ``memory`` catalog (a one-row ``rows`` or
``dropped`` result) and PREPARE / EXECUTE ... USING / DEALLOCATE PREPARE.
Under ``plan_templates`` (default on) ``sql`` and ``explain`` run and
render the statement's plan template (``plan/templates.py``): literals as
``?N`` slots, with EXPLAIN's ``params=[...]`` line binding them.
``execute`` and ``explain_analyze`` run with a stats recorder
(``runtime/stats.py``). Queries run on ``device`` ("cuda" unless the
caller asks for the CPU).

Observability, as in the JAX package: every tracked query is traced
when ``trace_enabled`` (the default) into ``traces`` (``export_trace``
writes Chrome trace JSON), its metric moves are attributed to its
``QueryInfo`` (``metrics``, ``join_strategy``, ``filter_selectivity``;
moves after the run under ``post_run.``), and ``query_created`` /
``query_failed`` / ``query_completed`` go to the event listeners, the
history ring (``history``) among them. ``query_retries`` re-runs a
failed query from the top. ``export_metrics`` renders the process
registry as OpenMetrics text.

Every query runs through the lifecycle (``runtime/lifecycle.
QueryManager.run_plan``, ``query_manager``): admission against the
session's memory pool (``pool()``), the deadline (``query_max_run_time``)
and cancel scope (``cancel(query_id)`` from any thread), fragment
retries (``retry_count``) and the OOM ladder (``oom_ladder_max``); joins
and aggregations over ``join_build_budget_bytes`` run out of core.
``QueryInfo`` records the error code, the ladder's ``oom_rung`` and
``rung_history``, the fragment retries and the device peak.

The cache tier, as in the JAX package (``cache/``): a repeated
deterministic query is answered from the session's versioned result
cache (``result_cache``, ``QueryInfo.cache_hit``, the ``query_cached``
event) and DDL drops the entries that read the table; operator steps are
shared across queries through the process-wide executable cache and
multi-key join bounds through the stats cache; each finished recorded
run's estimate-vs-actual rows go into the plan-stats history
(``plan_stats``, ``export_plan_stats`` / ``import_plan_stats``), which
steers recurring plans: the aggregation bypass, the spill tier's hot
partition and the adaptive controller (``adaptive``, ``plan/
adaptive.py``). Concurrent identical queries coalesce onto one execution
(``QueryInfo.coalesced``); a plan template seen before sets
``QueryInfo.template_hit``. The flight recorder (``flight``,
``export_flight_record``) keeps post-mortems; an SLO tracker and a
health monitor can be attached as ``slo`` and ``health``. Every session
registers the ``system`` catalog (``connectors/system.py``).

Under ``batched_dispatch`` (the serving layer's default) a bound
template runs through the template batch gate (``server/batcher.py``):
concurrent bindings of one template fuse into one batched dispatch
(``QueryInfo.batched``, ``batch_size``), or fall back to the serialized
template slot with the reason counted. The serving front-end attributes
each query to its tenant (:data:`CURRENT_TENANT`) and request trace
(:data:`REQUEST_TRACE`).

``Session(..., mesh=make_mesh(...))`` runs every query on the
distributed executor (``exec/distributed.py``) over the mesh's shards;
``explain_distributed`` renders the plan's fragments and exchanges
(``plan/fragmenter.py``) for local and mesh sessions alike. The mesh
folds into every plan fingerprint, so a local and a mesh session share
no cached result or step.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
import uuid
from collections import OrderedDict
from contextvars import ContextVar
from typing import Mapping, Optional

import numpy as np

from presto_tpu_torch.batch import Batch, Dictionary, QueryResult
from presto_tpu_torch.cache.exec_cache import EXEC_CACHE
from presto_tpu_torch.cache.fingerprint import (
    plan_fingerprint,
    plan_is_deterministic,
    table_versions,
    try_fingerprint,
)
from presto_tpu_torch.cache.plan_stats import PlanStatsStore
from presto_tpu_torch.cache.result_cache import ResultCache
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.system import SystemConnector
from presto_tpu_torch.devices import resolve_device
from presto_tpu_torch.exec.local_planner import LocalExecutor, default_join_build_budget
from presto_tpu_torch.plan.adaptive import AdaptiveController
from presto_tpu_torch.plan.catalog import Catalog
from presto_tpu_torch.plan.nodes import PlanNode, plan_tree_str
from presto_tpu_torch.plan.prune import prune
from presto_tpu_torch.plan.templates import (
    PreparedStatement,
    device_params,
    logical_values,
    parameterize_plan,
)
from presto_tpu_torch.runtime import trace
from presto_tpu_torch.runtime.errors import NotSupported, UserError, error_code, is_retryable
from presto_tpu_torch.runtime.events import EventDispatcher, QueryHistoryBuffer
from presto_tpu_torch.runtime.flight import FlightRecorder
from presto_tpu_torch.runtime.lifecycle import QueryManager
from presto_tpu_torch.runtime.memory import MemoryPool, global_pool
from presto_tpu_torch.runtime.metrics import (
    REGISTRY,
    QueryMetricsDelta,
    install_delta,
    to_openmetrics,
    uninstall_delta,
)
from presto_tpu_torch.runtime.properties import (
    SESSION_PROPERTIES,
    effective,
    validate_properties,
)
from presto_tpu_torch.runtime.stats import NodeIds, QueryInfo, StatsRecorder, render_analyzed_plan
from presto_tpu_torch.runtime.trace import TraceRecorder, TraceStore, export_chrome_trace
from presto_tpu_torch.sql import ast as A
from presto_tpu_torch.sql.analyzer import Analyzer
from presto_tpu_torch.sql.parser import parse
from presto_tpu_torch.types import BIGINT, varchar

_query_seq = itertools.count(1)

#: request-scoped tenant identity, set by the serving front-end
#: (``server/frontend.py``) around each tenant's execution, so QueryInfo
#: attribution works through one shared session. Falls back to the
#: ``tenant`` session property, then "".
CURRENT_TENANT: ContextVar[Optional[str]] = ContextVar(
    "presto_tpu_torch_current_tenant", default=None)

#: request-scoped trace context, set by the serving front-end around a
#: submitted query and by the subscription manager around each refresh:
#: a dict {"token": the trace token of the query's recorder,
#: "subscription_id": the continuous query's id ("" ad hoc),
#: "force_trace": record spans even with ``trace_enabled`` off,
#: "query_id": written back by ``_run_tracked`` so the caller can stitch
#: its own spans onto the query's recorder afterwards}
REQUEST_TRACE: ContextVar[Optional[dict]] = ContextVar(
    "presto_tpu_torch_request_trace", default=None)

_DDL = (A.CreateTableAs, A.InsertInto, A.DropTable)
_PREPARED = (A.Prepare, A.ExecuteStmt, A.Deallocate)


def _no_recorder():
    return None


@contextlib.contextmanager
def _profile_to(path: str, device):
    """Run the block under ``torch.profiler`` and write its Chrome trace
    to ``path`` (the directory is made if missing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # one profiler a query, one cycle: acc_events keeps torch from
    # warning that a new cycle clears the last one's events
    with profile(activities=activities, acc_events=True) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)


def _ast_literal_value(node):
    """EXECUTE ... USING argument -> logical Python value (literals only:
    parameters are values, not expressions)."""
    if isinstance(node, A.NumberLit):
        return float(node.text) if "." in node.text else int(node.text)
    if isinstance(node, A.StringLit):
        return node.value
    if isinstance(node, (A.DateLit, A.TimestampLit)):
        return node.value  # ISO strings; DataType.to_physical parses
    if isinstance(node, A.UnaryOp) and node.op == "-":
        return -_ast_literal_value(node.operand)
    raise UserError("EXECUTE ... USING arguments must be literals")


def _one_row(name: str, value) -> QueryResult:
    """A one-row, one-column result on the host: a BIGINT count or a
    VARCHAR name (the DDL and PREPARE summaries)."""
    if isinstance(value, str):
        batch = Batch.from_numpy({name: np.zeros(1, np.int32)}, {name: varchar()},
                                 dictionaries={name: Dictionary([value])}, device="cpu")
    else:
        batch = Batch.from_numpy({name: np.array([value], np.int64)}, {name: BIGINT},
                                 device="cpu")
    return QueryResult([name], [batch])


def device_checked(device, props: dict) -> dict:
    """Refuse a ``pallas_strings`` route ``device`` cannot take. The
    string predicates on byte columns always run the CUDA kernels on the
    card and their plain versions on the CPU, so the switch picks no
    code: off on a CUDA session is refused (ROADMAP C25); on a CPU
    session every setting answers through the plain version, the CPU's
    one route, as the JAX package answers through its kernel in
    interpret mode there."""
    pallas = props.get("pallas_strings")
    if pallas is False and device.type == "cuda":
        raise NotSupported("pallas_strings=false would run the plain string "
                           "predicates on the card; the port always launches its "
                           "CUDA string kernels there")
    return props


class Session:
    def __init__(self, connectors: Mapping[str, object], properties=None, device="cuda",
                 trace_token: Optional[str] = None, memory_pool: Optional[MemoryPool] = None,
                 mesh=None):
        """``trace_token`` tags every query's trace (and, under
        ``profile_annotations``, each span's profiler annotation).
        ``memory_pool`` shares an explicit ``runtime.memory.MemoryPool``
        across sessions (default: the process-wide pool, or a private one
        when ``memory_pool_bytes`` is set). ``mesh`` (``parallel/mesh.
        make_mesh``) runs queries distributed over its shards; its devices
        are of the session's device type."""
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise UserError(f"a {self.device.type} session cannot run on a mesh of "
                            f"{mesh.device_type} devices")
        #: the worker mesh (None: single-device execution)
        self.mesh = mesh
        conns = dict(connectors)
        conns.setdefault("system", SystemConnector(self))
        # the writable catalog: CREATE TABLE AS / INSERT INTO land here
        conns.setdefault("memory", MemoryConnector(device=self.device))
        self.catalog = Catalog(conns)
        self.analyzer = Analyzer(self.catalog)
        self.properties = device_checked(self.device, validate_properties(dict(properties or {})))
        self.trace_token = trace_token
        self.events = EventDispatcher()
        #: every tracked query's QueryInfo, in order
        self.query_history: list[QueryInfo] = []
        #: ring of recent completed QueryInfos (a built-in listener)
        self.history = QueryHistoryBuffer(self.prop("query_history_limit"))
        self.events.add(self.history)
        #: ring of recent span traces (``export_trace``); populated when
        #: ``trace_enabled``
        self.traces = TraceStore()
        #: the flight recorder's ring of post-mortems
        self.flight = FlightRecorder(self.prop("flight_recorder_limit"))
        #: prepared statements (PREPARE name FROM ... / Session.prepare)
        self._prepared: dict[str, PreparedStatement] = {}
        #: the query lifecycle: admission, deadlines, cancellation,
        #: fragment retries, the OOM ladder, the in-flight coalescer
        self.query_manager = QueryManager(self)
        #: the versioned result cache, per session (sessions own private
        #: memory catalogs); DDL drops entries through the catalog
        self.result_cache = ResultCache(self.prop("result_cache_max_bytes"))
        self.catalog.add_invalidation_listener(self.result_cache.invalidate_table)
        #: estimate-vs-actual history by plan fingerprint
        self.plan_stats = PlanStatsStore(self.prop("plan_stats_limit"))
        self.catalog.add_invalidation_listener(self.plan_stats.invalidate_table)
        #: the adaptive controller (its decision ring: system.adaptive)
        self.adaptive = AdaptiveController()
        #: the server's tenant registry, the tenant SLO tracker
        #: (``runtime/health.SloTracker``) and the health watchdog
        #: (``runtime/health.HealthMonitor``): None until attached
        self.tenants = None
        self.slo = None
        self.health = None
        #: plan templates this session has run (``template_hit``), LRU
        self._seen_templates: "OrderedDict[str, None]" = OrderedDict()
        self._seen_templates_limit = 4096
        self._tmpl_lock = threading.Lock()
        #: an explicit shared pool, else a private one built here (not
        #: lazily: concurrent first queries must see one pool)
        self._memory_pool = memory_pool
        cap = self.prop("memory_pool_bytes")
        self._private_pool = None if cap is None else MemoryPool(cap, name="session")
        # every memory-connector write (CTAS, INSERT, DROP) bumps the
        # catalog version, also a direct write through the Python API
        mem = conns["memory"]
        self._mem_ddl_hooked = hasattr(mem, "add_ddl_listener")
        if self._mem_ddl_hooked:
            mem.add_ddl_listener(self.catalog.invalidate)

    def prop(self, name: str):
        """Effective value of a session property (override or default)."""
        return effective(self.properties, name)

    def set_property(self, name: str, value) -> None:
        """Set one session property (typed and validated; unknown names
        are errors; None restores the default). A changed history limit
        resizes the ring, a changed ``memory_pool_bytes`` rebuilds the
        private pool here, so concurrent queries see one pool."""
        checked = device_checked(self.device, validate_properties({name: value}))
        if value is None:
            self.properties.pop(name, None)
        else:
            self.properties.update(checked)
        if name == "query_history_limit":
            self.history.resize(self.prop(name))
        if name == "plan_stats_limit":
            self.plan_stats.resize(self.prop(name))
        if name == "flight_recorder_limit":
            self.flight.resize(self.prop(name))
        if name == "memory_pool_bytes":
            cap = self.prop(name)
            self._private_pool = None if cap is None else MemoryPool(cap, name="session")

    def show_session(self) -> "list[tuple[str, object, str]]":
        """(name, effective value, description) rows, SHOW SESSION, in
        the JAX package's order."""
        return [(d.name, self.prop(d.name), d.description)
                for d in SESSION_PROPERTIES.values()]

    def _mirror_switches(self) -> None:
        """Connectors and the leaf-route matcher read the process-wide
        narrowing switch (``spi.narrow_enabled``): mirror
        ``narrow_storage`` there, as the JAX package does."""
        narrow = self.prop("narrow_storage")
        if narrow is not None:
            # presto-lint: ignore[PT401] -- deliberate documented mirror: the property IS the process-wide env switch (properties.py documents it); tests restore via the conftest guard
            os.environ["PRESTO_TPU_NARROW"] = "1" if narrow else "0"

    def _profiled(self, info):
        """``torch.profiler`` over one query when ``profile_dir`` is set
        (CPU and, on a CUDA session, CUDA activities): its Chrome trace
        goes to ``<profile_dir>/<query id>.json``, the device-side
        timeline beside EXPLAIN ANALYZE's host-side node stats."""
        d = self.prop("profile_dir")
        if not d:
            return contextlib.nullcontext()
        return _profile_to(os.path.join(d, f"{info.query_id}.json"), self.device)

    def add_event_listener(self, listener):
        """Register an event listener (``runtime/events.EventListener``)."""
        self.events.add(listener)

    def pool(self) -> MemoryPool:
        """The memory pool this session's queries reserve from: the
        explicit shared pool, else the private ``memory_pool_bytes`` one,
        else the process-wide pool (``runtime.memory.global_pool``)."""
        if self._memory_pool is not None:
            return self._memory_pool
        if self._private_pool is not None:
            return self._private_pool
        return global_pool()

    def cancel(self, query_id: str, reason: str = "cancelled") -> bool:
        """Cooperatively cancel a live query by ``QueryInfo.query_id``
        (from any thread): its next checkpoint (fragment dispatch, driver
        push, scan split, spill transfer slot) raises ``QueryCancelled``
        and the ordinary ``finally`` paths release its pool and host-spill
        reservations. False for an unknown, finished or already cancelled
        id."""
        return self.query_manager.cancel(query_id, reason)

    def join_build_budget(self) -> int:
        """``join_build_budget_bytes``, else a quarter of this session's
        device budget."""
        budget = self.prop("join_build_budget_bytes")
        return default_join_build_budget(self.device) if budget is None else budget

    def executor(self):
        """A fresh executor configured from the session properties: the
        distributed executor on a mesh session, else the local one."""
        # the executable cache is process-wide: only an explicit setting
        # resizes it
        if "exec_cache_max_entries" in self.properties:
            EXEC_CACHE.set_max_entries(self.prop("exec_cache_max_entries"))
        self._mirror_switches()
        if self.mesh is not None:
            from presto_tpu_torch.exec.distributed import DistributedExecutor

            return DistributedExecutor(
                self.catalog, self.mesh,
                broadcast_limit=self.prop("broadcast_join_row_limit"),
                gather_limit=self.prop("gather_row_limit"),
                direct_group_limit=self.prop("direct_group_limit"),
                join_build_budget=self.join_build_budget(),
                spill_host_budget=self.prop("spill_host_budget_bytes"))
        return LocalExecutor(self.catalog, pallas_join_enabled=self.prop("pallas_join"),
                             direct_group_limit=self.prop("direct_group_limit"),
                             agg_bypass=bool(self.prop("partial_agg_bypass")),
                             approx_join=self.prop("approx_join"),
                             runtime_join_filters=self.prop("runtime_join_filters"),
                             device=self.device, join_build_budget=self.join_build_budget(),
                             spill_host_budget=self.prop("spill_host_budget_bytes"),
                             scan_sample_fraction=self.prop("approx_scan_fraction"))

    # ---- planning ---------------------------------------------------------
    def plan(self, sql: str) -> PlanNode:
        """The pruned plan of a query, never parameterized."""
        stmt = parse(sql)
        if isinstance(stmt, _DDL):
            raise UserError("DDL statements execute via Session.sql(), not plan()/explain()")
        logical = self.analyzer.analyze(stmt)
        if self.analyzer.param_types:
            # an unbindable plan is refused at plan time
            raise UserError("query contains ? parameters; PREPARE it and EXECUTE "
                            "... USING (or Session.prepare/execute)")
        return prune(logical)

    def _plan_binding(self, stmt, parameterize: bool = True):
        """Analyze, prune and (under ``plan_templates``) parameterize one
        statement: ``(plan, bound)``, ``bound`` the slot-ordered (dtype,
        logical value) binding of the statement's own literals. The
        session's ``narrow_storage`` is mirrored first: which literals
        stay baked depends on the leaf-route matcher, which reads it (the
        JAX package mirrors it only when it builds the executor, after
        this: ROADMAP C16)."""
        self._mirror_switches()
        plan = prune(self.analyzer.analyze(stmt))
        if self.analyzer.param_types:
            raise UserError("query contains ? parameters; PREPARE it and EXECUTE "
                            "... USING (or Session.prepare/execute)")
        if not (parameterize and self.prop("plan_templates")):
            return plan, ()
        plan, slots = parameterize_plan(plan, self.catalog)
        return plan, tuple((s.dtype, s.value) for s in slots)

    def explain(self, sql: str) -> str:
        """The plan with its planned join and aggregation strategies
        (``strategy=sketch(approx)`` where ``approx_join`` would probe a
        Bloom sketch). Under ``plan_templates`` the plan is its template,
        followed by a ``params=[...]`` line binding each slot to this
        statement's literal."""
        stmt = parse(sql)
        if isinstance(stmt, _DDL + _PREPARED):
            raise UserError("DDL statements execute via Session.sql(), not plan()/explain()")
        plan, bound = self._plan_binding(stmt)
        hints = self._plan_hints(plan)
        out = plan_tree_str(plan, catalog=self.catalog, approx_join=self.prop("approx_join"),
                            join_build_budget=self.join_build_budget(), plan_hints=hints,
                            adaptive=self._explain_adaptive(plan, hints),
                            agg_bypass=bool(self.prop("partial_agg_bypass")))
        if bound:
            rendered = ", ".join(f"?{i}={dt}:{v!r}" for i, (dt, v) in enumerate(bound))
            out += f"params=[{rendered}]\n"
        return out

    def explain_distributed(self, sql: str) -> str:
        """The plan's fragments and exchanges (EXPLAIN (TYPE DISTRIBUTED)),
        with the property values this session's executor would run with.
        A fragment header carries the exchange skew the plan-stats history
        observed when this plan's fingerprint has recurred."""
        from presto_tpu_torch.plan.fragmenter import fragment_plan

        ex = self.executor()
        plan = self.plan(sql)
        fp = fragment_plan(plan, self.catalog,
                           getattr(ex, "broadcast_limit", self.prop("broadcast_join_row_limit")),
                           getattr(ex, "join_build_budget", self.prop("join_build_budget_bytes")))
        skew = {nid: rec.get("skew", 0.0) for nid, rec in self._plan_hints(plan).items()
                if rec.get("skew", 0.0) > 1.0}
        return fp.render(skew_history=skew or None)

    # ---- running ----------------------------------------------------------
    def sql(self, sql: str) -> QueryResult:
        """Execute one statement and return its rows (``QueryResult.
        approximate`` says whether a semi join probed the Bloom sketch).
        CREATE TABLE AS / INSERT INTO return a one-row ``rows`` result,
        DROP TABLE a ``dropped`` one; PREPARE / DEALLOCATE PREPARE a
        ``prepared`` / ``deallocated`` one, EXECUTE the prepared query's
        rows."""
        t0 = time.perf_counter()
        stmt = parse(sql)
        if isinstance(stmt, A.Prepare):
            self._prepared[stmt.name] = self._prepare_ast(stmt.name, sql, stmt.statement)
            return _one_row("prepared", stmt.name)
        if isinstance(stmt, A.ExecuteStmt):
            res, _info = self.execute_prepared(
                stmt.name, [_ast_literal_value(a) for a in stmt.args],
                planning_s=time.perf_counter() - t0)
            return res
        if isinstance(stmt, A.Deallocate):
            if self._prepared.pop(stmt.name, None) is None:
                raise UserError(f"prepared statement not found: {stmt.name}")
            return _one_row("deallocated", stmt.name)
        if isinstance(stmt, _DDL):
            return self._run_ddl(sql, stmt)
        want = bool(self.prop("collect_node_stats"))
        plan, bound = self._plan_binding(stmt, parameterize=not want)
        res, _info = self._run_with_retries(sql, plan, StatsRecorder if want else _no_recorder,
                                            planning_s=time.perf_counter() - t0, bound=bound)
        return res

    def execute(self, sql, params=None):
        """Execute returning ``(QueryResult, QueryInfo)``, with a stats
        recorder. With a ``PreparedStatement`` handle (or a registered
        name) plus ``params``, runs the prepared template with those
        bindings."""
        if isinstance(sql, PreparedStatement) or params is not None:
            return self.execute_prepared(sql, params or ())
        t0 = time.perf_counter()
        plan = self.plan(sql)
        return self._run_with_retries(sql, plan, StatsRecorder,
                                      planning_s=time.perf_counter() - t0)

    def explain_analyze(self, sql: str) -> str:
        """Execute with a stats recorder and render the plan annotated
        with each node's actuals, plus the exchange and cache span
        roll-ups of the query's trace."""
        recorder = StatsRecorder()
        t0 = time.perf_counter()
        plan = self.plan(sql)
        _res, info = self._run_tracked(sql, plan, recorder,
                                       planning_s=time.perf_counter() - t0)
        rendered = render_analyzed_plan(plan, recorder,
                                        tracer=self.traces.for_query(info.query_id))
        if info.cache_hit:
            return "result cache: HIT (no execution)\n" + rendered
        return rendered

    def _run_with_retries(self, sql: str, plan: PlanNode, make_recorder,
                          planning_s: float = 0.0, bound=()):
        """No mid-query recovery: a failed attempt fails the query, and
        recovery is re-running it from the top (``query_retries``). Each
        attempt is tracked as its own query with a fresh recorder, so a
        failed attempt's stats never leak into the retry's QueryInfo."""
        retries = self.prop("query_retries")
        for attempt in range(retries + 1):
            try:
                return self._run_tracked(sql, plan, make_recorder(),
                                         planning_s=planning_s, bound=bound)
            except Exception:
                if attempt == retries:
                    raise
                REGISTRY.counter("query.retried").add()

    def _run_tracked(self, sql: str, plan: PlanNode, recorder, planning_s: float = 0.0,
                     bound=()):
        """Track one execution attempt as a ``QueryInfo``: its span trace
        (when ``trace_enabled``), its events and its metric attribution.
        ``bound`` is the plan template's (dtype, value) binding. A
        request's trace context (:data:`REQUEST_TRACE`) overrides the
        session's trace token and carries the subscription id; its
        ``query_id`` is written back."""
        rctx = REQUEST_TRACE.get()
        info = QueryInfo(query_id=f"q_{next(_query_seq)}_{uuid.uuid4().hex[:8]}",
                         sql=sql, state="QUEUED", created_at=time.time(),
                         created_mono=time.monotonic(), planning_s=planning_s,
                         trace_token=(rctx.get("token") if rctx else None) or self.trace_token,
                         tenant=CURRENT_TENANT.get() or self.prop("tenant") or "",
                         subscription_id=rctx.get("subscription_id", "") if rctx else "")
        if rctx is not None:
            rctx["query_id"] = info.query_id
        tracer = token = None
        if self.prop("trace_enabled") or (rctx is not None and rctx.get("force_trace")):
            tracer = TraceRecorder(info.query_id, info.trace_token,
                                   max_spans=self.prop("trace_max_spans"),
                                   annotate=bool(self.prop("profile_annotations")))
            token = trace.install(tracer)
        # the cancel scope covers the whole tracked execution, so a cancel
        # reaches the query before run_plan installs it
        self.query_manager.open_scope(info.query_id)
        try:
            with trace.span("query", "query", {"query_id": info.query_id}):
                return self._run_tracked_inner(plan, recorder, info, bound)
        finally:
            self.query_manager.close_scope(info.query_id)
            if tracer is not None:
                trace.uninstall(token)
                self.traces.add(tracer)

    def _run_tracked_inner(self, plan: PlanNode, recorder, info: QueryInfo, bound):
        self.query_history.append(info)
        REGISTRY.counter("query.started").add()
        self.events.query_created(info)
        info.state = "RUNNING"
        info.started_at = time.time()
        info.started_mono = time.monotonic()
        if recorder is not None:
            recorder.attach_plan(plan)
        # two fingerprints: the plan TEMPLATE's (Param slots hash by slot,
        # never by value) is the template identity; the BINDING's (the
        # template and this query's literal values) keys the result cache,
        # the plan stats and the coalescer
        admissible = ResultCache.admissible(plan, self.catalog)
        cache_ok = bool(self.prop("result_cache_enabled")) and admissible
        templates_on = bool(self.prop("plan_templates")) and recorder is None
        base_fp = None
        if cache_ok or templates_on:
            base_fp = plan_fingerprint(plan, self.catalog, self.properties, self.mesh)
        fp = None
        if base_fp is not None:
            fp = try_fingerprint(("binding", base_fp, logical_values(bound))) if bound else base_fp
        if templates_on and base_fp is not None:
            with self._tmpl_lock:
                info.template_hit = base_fp in self._seen_templates
                self._seen_templates[base_fp] = None
                self._seen_templates.move_to_end(base_fp)
                while len(self._seen_templates) > self._seen_templates_limit:
                    self._seen_templates.popitem(last=False)
            REGISTRY.counter("prepare.template_hit" if info.template_hit
                             else "prepare.template_miss").add()
        # ---- the versioned result cache -------------------------------
        if cache_ok and fp is not None:
            with trace.span("result_cache:lookup", "cache") as sp, \
                    REGISTRY.histogram("cache.result_lookup_s").time():
                hit = self.result_cache.get_entry(fp, self.catalog)
                if sp is not None:
                    sp.args["hit"] = hit is not None
            if hit is not None:
                cached, entry = hit
                info.state = "FINISHED"
                info.cache_hit = True
                # the flag the populating run recorded
                info.approximate = entry.approximate
                info.output_rows = len(cached)
                info.finished_at = time.time()
                info.finished_mono = time.monotonic()
                REGISTRY.counter("query.completed").add()
                self.events.query_cached(info)
                self.events.query_completed(info)
                return cached, info
        # plan-stats history of a recurring fingerprint (runs >= 2)
        hints = self._plan_hints(plan, fp)
        if recorder is not None:
            # after the cache lookup: a hit runs nothing to estimate
            with trace.span("plan_estimates", "stats"):
                recorder.attach_estimates(plan, self.catalog,
                                          approx_join=self.prop("approx_join"),
                                          join_build_budget=self.join_build_budget(),
                                          plan_hints=hints,
                                          agg_bypass=bool(self.prop("partial_agg_bypass")))
        # ---- in-flight coalescing: gated as result-cache admission is
        entry = None
        if templates_on and admissible and fp is not None:
            wait_s = self.prop("query_max_run_time") or self.prop("admission_queue_timeout_s")
            lead, payload = self.query_manager.coalescer.lead_or_wait(fp, wait_s)
            if lead:
                entry = payload
            elif payload is not None:
                info.state = "FINISHED"
                info.coalesced = True
                info.output_rows = len(payload)
                info.approximate = payload.approximate
                info.finished_at = time.time()
                info.finished_mono = time.monotonic()
                REGISTRY.counter("prepare.coalesced").add()
                REGISTRY.counter("query.completed").add()
                self.events.query_completed(info)
                return payload, info
            # else the leader failed or the wait timed out: run ourselves
        try:
            executor = self.executor()
            executor.recorder = recorder
            executor.plan_hints = hints
            if self.mesh is not None:
                executor.agg_bypass = bool(self.prop("partial_agg_bypass"))
            executor.adaptive = self._adaptive_decisions(plan, fp, hints, executor)
            executor.params = device_params(bound, self.device) if bound else ()
            # moves after the run (query.completed / query.failed, the
            # result-cache populate, the plan-stats record, the completion
            # events) land in an explicit ``post_run.`` bucket
            post = QueryMetricsDelta()
        except BaseException:
            # a failure before the publishing finally below still retires
            # the in-flight entry
            if entry is not None:
                self.query_manager.coalescer.publish(fp, entry, None)
            raise
        published = None  # the leader's result, for its followers
        try:
            # cross-query batched dispatch (server/batcher.py): the
            # bindings queued on this template fuse into one batched
            # dispatch when the template allows; else the serialized
            # template slot, through the same per-template executor lock
            gate_on = (entry is not None and bool(bound) and base_fp is not None
                       and bool(self.prop("batched_dispatch")))
            if gate_on and not getattr(executor, "supports_batched_dispatch", False):
                # an executor that cannot batch: loud, then the classic path
                REGISTRY.counter("batch.fallback").add()
                REGISTRY.counter("batch.fallback.distributed").add()
                gate_on = False
            if gate_on:
                with self._profiled(info):
                    res = self._run_template_batched(executor, plan, info, recorder, base_fp,
                                                     bound)
            else:
                # same-template serialization: leaders with a binding
                # queue behind one slot per template
                slot_cm = (self.query_manager.coalescer.template_slot(base_fp)
                           if entry is not None and bound and base_fp is not None
                           else contextlib.nullcontext())
                with self._profiled(info), slot_cm:
                    res = self.query_manager.run_plan(executor, plan, info, recorder)
            published = res
            token = install_delta(post)
            try:
                info.state = "FINISHED"
                info.output_rows = len(res)
                info.approximate = res.approximate
                REGISTRY.counter("query.completed").add()
                if cache_ok and fp is not None:
                    with trace.span("result_cache:populate", "cache"):
                        self.result_cache.put(fp, res, table_versions(plan, self.catalog),
                                              max_bytes=self.prop("result_cache_max_bytes"),
                                              approximate=info.approximate)
            finally:
                uninstall_delta(token)
        except Exception as e:
            info.state = "FAILED"
            info.error = f"{type(e).__name__}: {e}"
            info.error_code = error_code(e)
            info.retryable = is_retryable(e)
            token = install_delta(post)
            try:
                REGISTRY.counter("query.failed").add()
                self.events.query_failed(info)
            finally:
                uninstall_delta(token)
            raise
        finally:
            if entry is not None:
                # wake identical-query followers with the result (or, on
                # failure, with nothing: each then runs itself)
                self.query_manager.coalescer.publish(fp, entry, published)
            info.finished_at = time.time()
            info.finished_mono = time.monotonic()
            token = install_delta(post)
            try:
                if recorder is not None:
                    recorder.finalize(plan)
                    info.node_stats = [s.to_dict() for s in recorder.nodes.values()]
                    if info.state == "FINISHED":
                        self._record_plan_stats(plan, info, recorder, fp)
                # applied adaptive decisions go into the decision ring,
                # failed runs' too
                ev = getattr(executor, "adaptive_events", None)
                if ev:
                    self.adaptive.note_applied(getattr(executor, "adaptive_fp", None) or fp or "",
                                               info.query_id, ev)
                self.events.query_completed(info)
            finally:
                uninstall_delta(token)
            for k, v in post.snapshot().items():
                if v:
                    info.metrics["post_run." + k] = v
        return res, info

    def _run_template_batched(self, executor, plan, info, recorder, base_fp, bound):
        """Run one bound template through the batch gate
        (``server/batcher.TemplateBatchGate``): enqueue the binding, then
        either get served by a concurrent leader's batched dispatch, or
        lead: drain the queued bindings into one batched dispatch when
        the template is batchable (``batch.dispatched``), else run
        serially under the template executor lock with the reason
        counted. The wait is bounded like the coalescer's; on timeout the
        query runs itself unserialized (correct, just unbatched)."""
        gate = self.query_manager.batch_gate
        wait_s = self.prop("query_max_run_time") or self.prop("admission_queue_timeout_s")
        max_batch = int(self.prop("batch_max_size"))
        member = gate.enqueue(base_fp, bound)
        # lane provenance: the leader's dispatch stamps one batch:lane
        # span per member, carrying this origin
        member.origin = info.trace_token or info.query_id
        deadline = None if wait_s is None else time.monotonic() + float(wait_s)
        gate_t0 = time.perf_counter()
        scope = self.query_manager.scope_of(info.query_id)
        while True:
            if scope is not None:
                # the gate's cancel checkpoint: a cancelled waiter
                # abandons its lane on the way out
                try:
                    scope.check("batch-gate-wait")
                except BaseException:
                    gate.abandon(base_fp, member)
                    raise
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            role, payload = gate.lead_or_wait(base_fp, member, remaining, max_batch=max_batch)
            if role != "retry":
                trace.add_complete("batch:gate_wait", "driver", gate_t0,
                                   time.perf_counter() - gate_t0, {"verdict": role})
            if role == "serve":
                # a leader's batched dispatch computed this binding
                info.batched = True
                info.batch_size = int(member.batch_size)
                REGISTRY.counter("batch.served").add()
                return payload
            if role == "timeout":
                REGISTRY.counter("batch.gate_timeout").add()
                return self.query_manager.run_plan(executor, plan, info, recorder)
            if role == "retry":
                if deadline is not None and time.monotonic() >= deadline:
                    gate.abandon(base_fp, member)
                    REGISTRY.counter("batch.gate_timeout").add()
                    return self.query_manager.run_plan(executor, plan, info, recorder)
                continue
            # lead: this thread holds the template executor lock
            members = payload
            try:
                runner = executor
                if len(members) > 1:
                    reason = gate.template_reason(base_fp, plan, self.catalog)
                    if reason is None:
                        from presto_tpu_torch.server.batcher import BatchRunner

                        runner = BatchRunner(executor, gate, members, member,
                                             template_key=base_fp)
                    else:
                        REGISTRY.counter("batch.fallback").add()
                        REGISTRY.counter(f"batch.fallback.{reason}").add()
                res = self.query_manager.run_plan(runner, plan, info, recorder)
                if runner is not executor:
                    info.batched = bool(runner.dispatched_batch)
                    if info.batched:
                        info.batch_size = int(runner.batch_size)
                return res
            finally:
                gate.finish_lead(base_fp, member, members)

    # ---- plan-stats history and adaptivity ----------------------------------
    def _plan_hints(self, plan, fp=None) -> dict:
        """Plan-stats history for this plan, keyed by the live plan
        nodes (``{id(node): estimate-vs-actual record}``) when its
        fingerprint has recurred (``runs >= 2``), else empty. Record
        node ids are the recorder's pre-order ids, so a fresh pre-order
        walk of the shape-identical plan maps them back. Advisory: a
        failure here never fails a query."""
        try:
            if len(self.plan_stats) == 0:
                return {}
            if fp is None:
                if not plan_is_deterministic(plan, self.catalog):
                    return {}
                fp = plan_fingerprint(plan, self.catalog, self.properties, self.mesh)
            entry = self.plan_stats.get(fp, self.catalog)
            if entry is None or entry.runs < 2:
                return {}
            ids = NodeIds()
            ids.assign(plan)
            by_id = {}

            def walk(n):
                by_id[ids.of(n)] = n
                for c in n.children:
                    walk(c)

            walk(plan)
            # fresh copies with the recurrence count: consumers never
            # mutate the store's records
            return {id(by_id[r["node_id"]]): {**r, "runs": entry.runs}
                    for r in entry.records if r["node_id"] in by_id}
        except Exception:  # noqa: BLE001 -- advisory only
            return {}

    def _adaptive_decisions(self, plan, fp, hints, executor, for_render: bool = False) -> dict:
        """The adaptive controller's decision pass for one query (or an
        EXPLAIN render). The ``adaptive_execution`` property, a missing
        fingerprint or any internal failure yields no decisions."""
        try:
            if not hints or not bool(self.prop("adaptive_execution")):
                return {}
            if not fp:
                if not plan_is_deterministic(plan, self.catalog):
                    return {}
                fp = plan_fingerprint(plan, self.catalog, self.properties, self.mesh)
            if not for_render:
                executor.adaptive_fp = fp
            return self.adaptive.decide(
                plan, hints, self.catalog, fingerprint=fp, nworkers=getattr(executor, "nworkers", 1),
                salt_max=int(self.prop("adaptive_salt_max")), for_render=for_render,
                recording=bool(self.prop("flight_record_successes")))
        except Exception:  # noqa: BLE001 -- adaptivity never fails a query
            return {}

    def _explain_adaptive(self, plan, hints) -> dict:
        """Would-be adaptive decisions for EXPLAIN (no logging, no
        stickiness, no stand-down guards)."""
        try:
            if not hints or not plan_is_deterministic(plan, self.catalog):
                return {}
            fp = plan_fingerprint(plan, self.catalog, self.properties, self.mesh)
            return self._adaptive_decisions(plan, fp, hints, self.executor(), for_render=True)
        except Exception:  # noqa: BLE001 -- EXPLAIN renders partial plans
            return {}

    def _record_plan_stats(self, plan, info, recorder, fp) -> None:
        """Put the run's estimate-vs-actual records into the history
        under the plan's fingerprint. Volatile plans are never recorded.
        Best-effort: a recording failure never fails a finished query."""
        try:
            if not recorder.estimates:
                return
            if fp is None:
                if not plan_is_deterministic(plan, self.catalog):
                    return
                fp = plan_fingerprint(plan, self.catalog, self.properties, self.mesh)
            with trace.span("plan_stats:record", "stats"):
                self.plan_stats.put(fp, info.query_id, table_versions(plan, self.catalog),
                                    recorder.estimate_vs_actual())
        except Exception:  # noqa: BLE001 -- observability never fails a query
            REGISTRY.counter("plan_stats.record_errors").add()

    # ---- prepared statements -----------------------------------------------
    def _prepare_ast(self, name: str, sql: str, stmt) -> PreparedStatement:
        if not isinstance(stmt, (A.Query, A.SetQuery)):
            raise UserError("only queries can be prepared")
        self._mirror_switches()
        plan = prune(self.analyzer.analyze(stmt))
        user = tuple(sorted(self.analyzer.param_types.items()))
        auto = ()
        if self.prop("plan_templates"):
            plan, auto = parameterize_plan(plan, self.catalog, start_slot=len(user))
        return PreparedStatement(name, sql, plan, user, auto)

    def prepare(self, sql: str, name: Optional[str] = None) -> PreparedStatement:
        """Prepare a query into a plan-template handle: explicit ``?``
        placeholders and eligible literals become typed slots, and every
        ``execute(handle, params)`` binding runs the handle's one plan."""
        handle = self._prepare_ast(name or f"stmt_{len(self._prepared)}", sql, parse(sql))
        self._prepared[handle.name] = handle
        return handle

    def execute_prepared(self, handle, params=(), planning_s: float = 0.0):
        """Execute a prepared handle (or its registered name) with
        positional ``?`` bindings; returns ``(QueryResult, QueryInfo)``."""
        if not isinstance(handle, PreparedStatement):
            h = self._prepared.get(handle)
            if h is None:
                raise UserError(f"prepared statement not found: {handle}")
            handle = h
        bound = handle.bind(list(params))
        return self._run_with_retries(handle.sql, handle.plan, _no_recorder,
                                      planning_s=planning_s, bound=bound)

    # ---- DDL ----------------------------------------------------------------
    def _owning_catalog(self, table: str):
        for cname, conn in self.catalog.connectors.items():
            if table in conn.tables():
                return cname
        return None

    def _run_ddl(self, sql: str, stmt) -> QueryResult:
        """CREATE TABLE AS / INSERT INTO / DROP TABLE against the memory
        catalog, all-or-nothing per statement. A target name must not
        shadow a table of a read-only catalog: name resolution prefers
        the user connectors, so a shadowed memory table would be
        unreachable."""
        mem = self.catalog.connector("memory")
        owner = self._owning_catalog(stmt.name)
        if isinstance(stmt, A.DropTable):
            if owner == "memory":
                mem.drop_table(stmt.name)
            elif owner is not None:
                raise UserError(f"cannot drop {stmt.name}: it belongs to the read-only "
                                f"{owner!r} catalog")
            elif not stmt.if_exists:
                raise UserError(f"table not found in memory catalog: {stmt.name}")
            if not self._mem_ddl_hooked:
                self.catalog.invalidate(stmt.name)
            return _one_row("dropped", stmt.name)
        # existence checks before running the query
        if isinstance(stmt, A.CreateTableAs) and owner is not None:
            raise UserError(f"table already exists in catalog {owner!r}: {stmt.name}")
        if isinstance(stmt, A.InsertInto):
            if owner is None:
                raise UserError(f"table not found: {stmt.name}")
            if owner != "memory":
                raise UserError(f"cannot insert into {stmt.name}: the {owner!r} catalog "
                                "is read-only")
        t0 = time.perf_counter()
        plan, bound = self._plan_binding(stmt.query)
        res, _info = self._run_with_retries(sql, plan, _no_recorder,
                                            planning_s=time.perf_counter() - t0, bound=bound)
        if isinstance(stmt, A.CreateTableAs):
            rows = mem.create_table(stmt.name, res)
        else:
            rows = mem.insert(stmt.name, res)
        if not self._mem_ddl_hooked:
            self.catalog.invalidate(stmt.name)
        return _one_row("rows", rows)

    # ---- observability exports ---------------------------------------------
    def export_metrics(self, path: Optional[str] = None) -> str:
        """The process metrics registry as OpenMetrics/Prometheus text
        (``runtime.metrics.to_openmetrics``), plus the live gauges the
        registry cannot carry: the memory pool's occupancy, the
        executable cache's entries, the flight recorder's depth, and the
        devices', SLO tracker's and health monitor's gauges where they
        apply. Returns the text; with ``path``, also writes it there."""
        snap = self.pool().snapshot()
        gauges = {
            "memory_pool_capacity_bytes": snap["capacity_bytes"],
            "memory_pool_reserved_bytes": snap["reserved_bytes"],
            "memory_pool_occupancy": (snap["reserved_bytes"] / snap["capacity_bytes"]
                                      if snap["capacity_bytes"] else 0.0),
            "exec_cache_entries": len(EXEC_CACHE),
            "flight_recorder_depth": len(self.flight),
        }
        if self.prop("device_telemetry"):
            try:
                from presto_tpu_torch.runtime import devices

                gauges.update(devices.gauges())
            except Exception:  # noqa: BLE001 -- a gauge never fails the scrape
                pass
        for layer in (self.slo, self.health):
            if layer is not None:
                try:
                    gauges.update(layer.gauges())
                except Exception:  # noqa: BLE001
                    pass
        text = to_openmetrics(gauges=gauges)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    def export_flight_record(self, path: Optional[str] = None,
                             query_id: Optional[str] = None) -> str:
        """Flight-recorder post-mortems as JSON: one record with
        ``query_id``, else the whole ring (newest last). Returns the
        text; with ``path``, also writes it there."""
        text = self.flight.to_json(query_id)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    def export_plan_stats(self, path: Optional[str] = None) -> str:
        """The plan-stats history as JSON (a restarted session imports it
        with :meth:`import_plan_stats`). Returns the text; with ``path``,
        also writes it there."""
        text = self.plan_stats.to_json()
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    def import_plan_stats(self, path: str) -> int:
        """Merge an exported plan-stats history, returning the number of
        entries imported; entries recorded against table versions that
        have moved since are skipped, an unknown format is refused."""
        with open(path) as f:
            text = f.read()
        try:
            return self.plan_stats.load_json(text, catalog=self.catalog)
        except ValueError as e:
            raise UserError(str(e)) from e

    def export_trace(self, path: str, query_id: Optional[str] = None) -> str:
        """Write retained span traces as Chrome ``trace_event`` JSON (load
        in Perfetto / chrome://tracing). ``query_id`` narrows the export
        to one query; the default exports every retained trace, one pid
        per query. Returns ``path``."""
        if query_id is None:
            recorders = self.traces.recorders()
        else:
            rec = self.traces.for_query(query_id)
            if rec is None:
                raise UserError(f"no retained trace for query {query_id!r} "
                                "(trace_enabled off, or evicted)")
            recorders = [rec]
        if not recorders:
            raise UserError("no traces retained (is trace_enabled set to false?)")
        return export_chrome_trace(path, recorders)
