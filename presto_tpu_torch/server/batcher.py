"""Cross-query batched dispatch: N same-template bindings, one scan.

Counterpart of ``presto_tpu/server/batcher.py``. Concurrent
same-template different-literal queries (plan templates thread every
literal as a runtime slot, ``plan/templates.py``) differ only in their
slot values, so one leader can scan the template's table once and
compute every queued binding's result from those batches.

The contract is the JAX package's: one scan per batch, shared by every
lane; each lane's result bit-identical to that binding's serial run; the
same ``batch.*`` counters and ``batch:lane`` spans. The means differ:
the JAX package stacks the bindings on a leading axis and runs one
``jax.vmap`` of the traced template. Here the lanes run in a loop: the
lowered template replays the very operator steps the serial executor
dispatches (``FilterProjectOperator``'s step, ``GlobalAggregationOperator``
and ``TopNOperator`` / ``OrderByOperator``) once per lane, over the one
list of scanned batches, each lane under its own ``expr.param_scope``.
``torch.func.vmap`` cannot pass through the executor's host reads (live
counts, compaction) or its CUDA kernels, and a loop of the same steps is
what makes each lane equal to its serial run by construction. Templates
outside the whitelist (``plan/templates.unbatchable_reason``) fall back to
the serialized template slot, counted under ``batch.fallback.<reason>``;
a failing batched dispatch falls back the same way
(``batch.fallback.error``): batching multiplies work, never failures.

Two pieces:

- :func:`run_batched`: lower a whitelisted template once (cached in the
  process executable cache under the template fingerprint and the
  catalog's identity), scan once, run every lane, split per binding.
- :class:`TemplateBatchGate`: the meeting point. Concurrent bindings
  enqueue per template; whoever takes the template's executor lock
  drains the queue (bounded by ``batch_max_size``) and leads one batched
  dispatch, serving every drained member. Unserved members re-contend.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.runtime import trace
from presto_tpu_torch.runtime.metrics import REGISTRY

_UNSET = object()


# ---------------------------------------------------------------------------
# the lane runner
# ---------------------------------------------------------------------------


def _lower(node: N.PlanNode, catalog):
    """Lower a whitelisted plan node to ``fn(batches, device) -> [Batch]``
    built from the operators the serial executor runs, with a fresh
    breaker state per call (``device``: where an empty state lives). Callers vetted the plan with
    ``plan.templates.unbatchable_reason``: an unexpected node here is an
    internal error, not a fallback."""
    from presto_tpu_torch.exec.operators import (
        AggSpec,
        FilterProjectOperator,
        GlobalAggregationOperator,
        OrderByOperator,
        SortKey,
        TopNOperator,
    )
    from presto_tpu_torch.runtime.errors import InternalError

    if isinstance(node, N.TableScan):
        pred = (FilterProjectOperator(node.predicate, None)
                if node.predicate is not None else None)
        if pred is None:
            return lambda bs, device: list(bs)
        return lambda bs, device: [pred.apply(b) for b in bs]
    if isinstance(node, (N.Filter, N.Project)):
        child = _lower(node.child, catalog)
        op = (FilterProjectOperator(node.predicate, None) if isinstance(node, N.Filter)
              else FilterProjectOperator(None, dict(node.exprs)))
        return lambda bs, device: [op.apply(b) for b in child(bs, device)]
    if isinstance(node, N.Aggregate):
        from presto_tpu_torch.plan.bounds import agg_value_bits

        child = _lower(node.child, catalog)
        aggs = [AggSpec(a.kind, a.input, a.name, a.dtype, value_bits=b)
                for a, b in zip(node.aggs, agg_value_bits(node, catalog))]

        def agg_fn(bs, device):
            op = GlobalAggregationOperator(aggs, device=device)
            for b in child(bs, device):
                op.process(b)
            return op.finish()

        return agg_fn
    if isinstance(node, (N.TopN, N.Sort)):
        child = _lower(node.child, catalog)
        keys = [SortKey(k.expr, k.descending, k.nulls_first) for k in node.keys]

        def sort_fn(bs, device):
            op = TopNOperator(keys, node.count) if isinstance(node, N.TopN) \
                else OrderByOperator(keys)
            for b in child(bs, device):
                op.process(b)
            return op.finish()

        return sort_fn
    raise InternalError(
        f"unbatchable node reached the batched runner: {type(node).__name__}")


def _find_scan(node: N.PlanNode) -> N.TableScan:
    if isinstance(node, N.TableScan):
        return node
    return _find_scan(node.children[0])


def _build_batched(plan: N.Output, catalog):
    """Lower ``plan`` once: ``(scan, lane, names, catalog)``. ``scan``
    reads fresh batches per dispatch (data is never cached: the cache
    entry holds only the lowered operators); ``lane`` computes one
    binding's output batches from them. The catalog rides in the tuple
    to pin its identity for the cache key (see :func:`run_batched`)."""
    scan = _find_scan(plan.child)
    conn = catalog.connector(scan.connector)
    src_cols = [s for _, s in scan.columns]
    rename = {s: n for n, s in scan.columns}
    root = _lower(plan.child, catalog)
    sources, names = list(plan.sources), list(plan.names)
    out_rename = dict(zip(sources, names))

    def lane(batches, device):
        return [b.select(sources).rename(out_rename) for b in root(batches, device)]

    def scan_batches(executor):
        from presto_tpu_torch.runtime.faults import fault_point
        from presto_tpu_torch.runtime.lifecycle import check_deadline
        from presto_tpu_torch.spi import batch_capacity

        # the serial scan's split choice (a sampled scan samples alike)
        splits = executor.sampled_splits(list(conn.splits(scan.table)))
        cap = batch_capacity(max(s.row_hint for s in splits))
        out = []
        for split in splits:
            fault_point("scan")
            check_deadline("scan")
            out.append(conn.scan(split, src_cols, cap).rename(rename))
        return out

    return scan_batches, lane, names, catalog


def run_batched(catalog, plan: N.Output, bounds: Sequence[tuple],
                template_key: Optional[str] = None, executor=None):
    """Execute one whitelisted template for every binding in ``bounds``
    (slot-ordered ``(dtype, logical value)`` tuples) over ONE scan of its
    table; returns one ``QueryResult`` per binding, in order. The lowered
    template is cached in the process executable cache under the template
    fingerprint and the live catalog's identity: the entry captures the
    connector and catalog-derived bounds, and two same-schema catalogs
    over different data must not share it (the cached tuple pins the
    catalog, so its id cannot be recycled while the entry lives).
    ``executor`` (default: a plain one on the catalog's device) supplies
    the device and the split sampling."""
    from presto_tpu_torch.batch import QueryResult
    from presto_tpu_torch.cache.exec_cache import EXEC_CACHE
    from presto_tpu_torch.exec.local_planner import LocalExecutor, live_count
    from presto_tpu_torch.expr import param_scope
    from presto_tpu_torch.plan.templates import device_params
    from presto_tpu_torch.runtime.lifecycle import run_fragment

    if executor is None:
        conn = catalog.connector(_find_scan(plan.child).connector)
        executor = LocalExecutor(catalog, device=getattr(conn, "device", "cuda"))
    key = (EXEC_CACHE.key_of("batched_dispatch", template_key, str(id(catalog)))
           if template_key else None)
    scan_batches, lane, names, _catalog_pin = EXEC_CACHE.get_or_build(
        key, lambda: _build_batched(plan, catalog))
    device = executor.device
    per = [device_params(b, device) for b in bounds]
    executor.used_approx = False
    scans = scan_batches(executor)

    def lanes():
        outs = []
        for params in per:
            with param_scope(params):
                outs.append(lane(scans, device))
        return outs

    outs = run_fragment("fragment:batched_dispatch", lanes)
    return [QueryResult(names, [b for b in out if live_count(b) > 0],
                        approximate=executor.used_approx)
            for out in outs]


# ---------------------------------------------------------------------------
# the batch gate
# ---------------------------------------------------------------------------


class _BatchMember:
    """One query waiting at a template's batch gate."""

    __slots__ = ("bound", "event", "result", "served", "abandoned",
                 "origin", "batch_size")

    def __init__(self, bound: tuple):
        self.bound = bound
        self.event = threading.Event()
        self.result = None
        self.served = False
        self.abandoned = False
        #: trace provenance of the enqueuing submission (its trace
        #: token or query id, stamped by the session): the leader's
        #: batch:lane spans carry it, so every lane links back to the
        #: query that enqueued it
        self.origin = ""
        #: lanes in the dispatch that served this member (stamped by
        #: the leader; 0 until served) — QueryInfo.batch_size's source
        #: for served members
        self.batch_size = 0


class TemplateBatchGate:
    """Per-template meeting point for concurrent bindings.

    Protocol (driven by ``Session._run_template_batched``): a query
    ``enqueue``s its binding, then loops on ``lead_or_wait``:

    - ``("serve", result)`` — a leader's batched dispatch computed this
      binding's result; done.
    - ``("lead", members)`` — this query holds the template's executor
      lock and drained ``members`` (itself included, up to
      ``max_batch``). It must run them (batched when the template
      allows, else serially for itself) and call ``finish_lead`` in a
      finally.
    - ``("retry", None)`` — woken without a result (leader fell back
      or served others); contend again.
    - ``("timeout", None)`` — patience exhausted; the caller executes
      itself unserialized (correct, just uncoalesced — counted).

    The executor lock doubles as the template serializer: an
    unbatchable template runs one execution at a time.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._templates: dict[str, dict] = {}

    # ---- membership ------------------------------------------------------
    def enqueue(self, template_key: str, bound: tuple) -> _BatchMember:
        m = _BatchMember(tuple(bound))
        with self._lock:
            t = self._templates.get(template_key)
            if t is None:
                t = self._templates[template_key] = {
                    "exec": threading.Lock(), "queue": [], "refs": 0,
                    "reason": _UNSET,
                }
            t["queue"].append(m)
            t["refs"] += 1
        return m

    def _drop_locked(self, template_key: str, n: int = 1) -> None:
        t = self._templates.get(template_key)
        if t is None:
            return
        t["refs"] -= n
        if t["refs"] <= 0:
            self._templates.pop(template_key, None)

    def lead_or_wait(self, template_key: str, member: _BatchMember,
                     timeout_s: Optional[float], max_batch: int = 8):
        with self._lock:
            t = self._templates.get(template_key)
            if t is None:
                # defensive: a refcount invariant slip must degrade to
                # an unserialized (still correct) serial run, never a
                # KeyError out of the session
                return "timeout", None
            if member.served:
                self._drop_locked(template_key)
                return "serve", member.result
            if t["exec"].acquire(blocking=False):
                q = t["queue"]
                # drain everything waiting (bounded): every member
                # fused here is a scan the engine never pays again
                size = min(len(q), max(1, max_batch))
                others = [m for m in q if m is not member][: size - 1]
                members = [member] + others
                for m in members:
                    q.remove(m)
                return "lead", members
        served = member.event.wait(timeout_s)
        with self._lock:
            t = self._templates.get(template_key)
            if t is None:
                return "timeout", None
            member.event.clear()
            if member.served:
                self._drop_locked(template_key)
                return "serve", member.result
            if not served:
                member.abandoned = True
                if member in t["queue"]:
                    t["queue"].remove(member)
                self._drop_locked(template_key)
                return "timeout", None
        return "retry", None

    def abandon(self, template_key: str, member: _BatchMember) -> None:
        """A member's thread is leaving WITHOUT a leader's verdict
        (e.g. its overall gate deadline expired on a retry wake): mark
        it so a leader never wastes a lane on it, dequeue it, and drop
        its ref — the exact bookkeeping the in-gate timeout branch
        does. Idempotent."""
        with self._lock:
            t = self._templates.get(template_key)
            if t is None or member.abandoned:
                return
            member.abandoned = True
            if member in t["queue"]:
                t["queue"].remove(member)
            self._drop_locked(template_key)

    def serve(self, member: _BatchMember, result) -> bool:
        """Leader-side result delivery; returns False when the member
        gave up waiting (its thread runs serially; the frame drops)."""
        with self._lock:
            if member.abandoned:
                return False
            member.result = result
            member.served = True
        member.event.set()
        return True

    def finish_lead(self, template_key: str, leader: _BatchMember,
                    members: "list[_BatchMember]") -> None:
        """Release the template executor lock; members the leader could
        not serve re-queue at the FRONT (they were first in line) and
        every waiter wakes to contend for the lock."""
        with self._lock:
            t = self._templates.get(template_key)
            if t is None:  # refs can't hit 0 while the leader is live
                return
            requeue = [m for m in members
                       if m is not leader and not m.served
                       and not m.abandoned]
            t["queue"][:0] = requeue
            # ONLY the leader's ref drops here: served members' own
            # threads drop theirs on pickup, and abandoned members
            # already dropped theirs in the timeout branch — dropping
            # them again would pop the template out from under members
            # still queued (stranding them with a held exec lock)
            self._drop_locked(template_key)
            t = self._templates.get(template_key)
            if t is not None:
                t["exec"].release()
                for m in t["queue"]:
                    m.event.set()

    # ---- batchability ----------------------------------------------------
    def template_reason(self, template_key: str, plan, catalog):
        """Memoized ``plan.templates.unbatchable_reason`` per template
        (None = batchable). The walk — including the leaf-route matcher
        probe — runs once per template, not per burst."""
        with self._lock:
            t = self._templates.get(template_key)
            cached = t["reason"] if t is not None else _UNSET
        if cached is not _UNSET:
            return cached
        from presto_tpu_torch.plan.templates import unbatchable_reason

        reason = unbatchable_reason(plan, catalog)
        with self._lock:
            t = self._templates.get(template_key)
            if t is not None:
                t["reason"] = reason
        return reason

    def queue_depth(self, template_key: str) -> int:
        """Current queued member count for one template (tests)."""
        with self._lock:
            t = self._templates.get(template_key)
            return 0 if t is None else len(t["queue"])


class BatchRunner:
    """Executor adapter the batch leader hands to ``run_plan``: its
    ``run`` executes ONE batched dispatch for every drained member, serves
    the others and returns the leader's own result. Any failure in the
    batched path falls back to the wrapped executor's serial ``run``
    (``batch.fallback.error``); unserved members re-contend at the gate.
    Every other attribute (catalog, params, the OOM ladder's hooks, the
    approximate flag) delegates to the real executor."""

    def __init__(self, executor, gate: TemplateBatchGate,
                 members: "list[_BatchMember]", me: _BatchMember,
                 template_key: Optional[str] = None):
        self._executor = executor
        self._gate = gate
        self._members = members
        self._me = me
        self._template_key = template_key
        self._attempted = False
        self.dispatched_batch = False
        #: lanes in the dispatched batch (0 until a batch dispatches)
        self.batch_size = 0
        #: the admission multiplier (``runtime/lifecycle.admit``): the
        #: leader's reservation covers every fused lane's state
        self.admission_scale = len(members)

    def run(self, plan):
        if self._attempted:
            # an OOM-ladder (or retry) re-entry after a fallback: stay serial
            return self._executor.run(plan)
        self._attempted = True
        # admission may have granted fewer lanes than were drained: run
        # the covered prefix (the leader is members[0]) and let
        # finish_lead re-queue the rest
        granted = self.__dict__.get("admission_scale_granted")
        batch = self._members
        if granted is not None and granted < len(batch):
            REGISTRY.counter("batch.trimmed").add()
            batch = batch[: max(1, int(granted))]
        t0 = time.perf_counter()
        try:
            results = run_batched(self._executor.catalog, plan, [m.bound for m in batch],
                                  template_key=self._template_key, executor=self._executor)
        except Exception:  # noqa: BLE001 -- batching never fails a query
            REGISTRY.counter("batch.fallback").add()
            REGISTRY.counter("batch.fallback.error").add()
            return self._executor.run(plan)
        dur = time.perf_counter() - t0
        self.dispatched_batch = True
        self.batch_size = len(batch)
        REGISTRY.counter("batch.dispatched").add()
        REGISTRY.counter("batch.queries").add(len(batch))
        REGISTRY.histogram("batch.size").add(len(batch))
        out = None
        for i, (m, res) in enumerate(zip(batch, results)):
            # lane provenance on the leader's trace: each lane names the
            # submission (trace token or query id) whose binding it ran
            trace.add_complete("batch:lane", "driver", t0, dur,
                               {"lane": i, "origin": m.origin, "batch_size": len(batch)})
            if m is self._me:
                out = res
            else:
                m.batch_size = len(batch)
                self._gate.serve(m, res)
        return out

    def __getattr__(self, name):
        return getattr(self.__dict__["_executor"], name)
