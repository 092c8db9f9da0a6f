"""Adaptive execution: the feedback controller that turns plan-stats
history into plan decisions.

Counterpart of ``presto_tpu/plan/adaptive.py``. Decision kinds, one
controller:

- ``salt``: skew-salted repartitioning of a recurring repartition join
  whose history shows a hot exchange destination. It needs more than one
  worker and a repartition join, which the port's mesh sessions do not
  run yet (ROADMAP C26).
- ``join_flip`` / ``bucket``: history-corrected sizing at the local
  executor's static-estimate strategy points. A build (or aggregate)
  whose recorded actuals contradict the planner's estimate by at least
  ``MISEST_FACTOR`` has its byte estimate recomputed from measured rows,
  which flips grouped execution back to in memory when the build fits
  (and the other way), and sizes grouped bucket counts from actuals.
- ``route``: a fused-route join whose build fell back at run time
  (``join.pallas_fallback``: its advisory stats lied) stops re-attempting
  the fused route for that fingerprint.

Every decision passes the compile-budget gate: its predicted cost (the
executable ledger's cheapest cold-minus-warm wall for the step kind the
decision re-specializes) must not exceed its predicted win at the
fingerprint's recurrence. The port's walls hold no compile
(``cache/exec_cache.py``), so its gate admits decisions the JAX
package's refuses (ROADMAP C20).

Guards: history steers only at ``runs >= 2`` (``Session._plan_hints``);
decisions stand down while a fault injector is active or while the
flight recorder captures successes (``adaptive.stand_down``); a decision
is sticky per (fingerprint, node, kind), so its own effect on the next
run's telemetry cannot flip it back. Applied and refused decisions land
in a bounded ring (``system.adaptive``), in ``adaptive.*`` counters and
on the executor's ``adaptive_events`` (flight records carry them).
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Optional

from presto_tpu_torch.runtime.metrics import REGISTRY
from presto_tpu_torch.runtime.stats import MISEST_FACTOR

#: minimum recorded exchange skew (max/mean) that triggers salting
SKEW_THRESHOLD = 2.0

#: decision-ring retention (``system.adaptive`` depth)
RING_LIMIT = 256

#: predicted future recurrence per observed run: a fingerprint seen R
#: times is priced as if it will arrive ~8R more times. The budget
#: gate compares ONE cold compile against the per-run win over that
#: horizon — so a hot serving template re-specializes after a couple
#: of observations, while a one-off test query (milliseconds of wall)
#: never buys a multi-second recompile
RECURRENCE_HORIZON = 8


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def salt_factor(skew: float, nworkers: int, salt_max: int) -> int:
    """S for a measured skew ratio: the hot destination held ~``skew``x
    its fair share, so spreading it over ``ceil(skew)`` partitions
    (rounded up to a power of two for stable cache keys) restores
    balance. Clamped to the mesh size and the session's
    ``adaptive_salt_max`` — replication cost grows linearly in S."""
    s = _next_pow2(max(2, -(-int(skew) // 1)))
    return max(2, min(s, nworkers, salt_max))


@dataclass
class AdaptiveDecision:
    """One steering decision for one plan node of one fingerprint."""

    kind: str  # "salt" | "join_flip" | "bucket" | "route"
    node_id: int
    #: salt partition count (kind == "salt")
    salt: int = 0
    #: hot destination the salt spreads (kind == "salt")
    hot_partition: int = -1
    #: history-corrected byte estimate (join_flip / bucket)
    est_bytes: int = -1
    #: human-readable trigger for logs/EXPLAIN
    trigger: str = ""

    def to_event(self, applied: bool = True) -> dict:
        return {
            "kind": self.kind,
            "node_id": self.node_id,
            "salt": self.salt,
            "hot_partition": self.hot_partition,
            "est_bytes": self.est_bytes,
            "trigger": self.trigger,
            "applied": bool(applied),
        }


def predicted_compile_cost(kind_prefix: str) -> float:
    """Cheapest measured cold-minus-warm wall over the executable-cache
    entries of one step kind: the ledger's estimate of what one new
    specialization's first run pays. The minimum, so a one-off worst
    case does not raise the bar for the life of the process. 0.0 while
    the ledger holds no entry of that kind (with nothing measured there
    is nothing to predict, and refusing forever would stall
    adaptivity)."""
    from presto_tpu_torch.cache.exec_cache import EXEC_CACHE

    best = 0.0
    for row in EXEC_CACHE.stats_rows():
        if row.get("kind") != kind_prefix:
            continue
        cold = float(row.get("cold_call_s", 0.0) or 0.0)
        warm = float(row.get("warm_call_s", 0.0) or 0.0)
        if cold > warm > 0.0:
            delta = cold - warm
            best = delta if best == 0.0 else min(best, delta)
    return best


#: executable-cache step kind whose ledger prices each decision kind
#: (the nearest measured proxy for the re-specialized step's first run)
_COST_KIND = {
    "salt": "dist_repart_join",
    "join_flip": "join_build",
    "bucket": "global_agg",
    "route": "join_build",
}


class AdaptiveController:
    """Per-Session feedback controller: plan-stats history in,
    per-node :class:`AdaptiveDecision` maps out, with sticky replay,
    compile-budget admission, and a decision log."""

    def __init__(self):
        #: sticky decisions keyed (fingerprint, node_id) — survive the
        #: telemetry they erase (see module docstring, oscillation)
        self._sticky: dict[tuple, AdaptiveDecision] = {}
        #: (fingerprint, node_id) pairs the budget gate refused — a
        #: refusal is sticky too (re-pricing every run would flap)
        self._refused: set = set()
        #: bounded decision log (``system.adaptive`` rows)
        self.ring: collections.deque = collections.deque(maxlen=RING_LIMIT)

    # ---- decision pass ------------------------------------------------
    def decide(self, plan, hints: dict, catalog, fingerprint: str,
               nworkers: int = 1, salt_max: int = 8,
               for_render: bool = False, recording: bool = False) -> dict:
        """One decision pass: {id(live node) -> {kind ->
        AdaptiveDecision}} for the executor (the ``plan_hints`` wiring
        shape; a node can carry several independent kinds — a salted
        repartition join may also have its Pallas route disabled).
        ``hints`` is ``Session._plan_hints`` output — present only when
        the fingerprint has recurred (runs >= 2), so the corridor's
        gate is inherited. ``for_render`` computes WOULD-BE decisions
        for EXPLAIN without logging or consulting the runtime
        stand-down guards (EXPLAIN shows the steady-state plan).
        ``recording`` marks an active repro/success-capture recorder
        (``flight_record_successes``) — those runs observe the
        baseline plan only."""
        if not hints:
            return {}
        if not for_render:
            from presto_tpu_torch.runtime import faults

            if faults.active() is not None or recording:
                REGISTRY.counter("adaptive.stand_down").add()
                return {}
        from presto_tpu_torch.plan import nodes as N
        from presto_tpu_torch.runtime.memory import node_row_bytes

        out: dict = {}

        def bytes_for(node, rows: int) -> int:
            try:
                return max(0, int(rows)) * max(1, node_row_bytes(
                    node, catalog))
            except Exception:  # noqa: BLE001 — stats gaps never block
                return -1

        def admit(node, dec: AdaptiveDecision, runs: int,
                  wall_s: float, win_frac: float) -> None:
            """Budget-gate one candidate, then stick + log it."""
            skey = (fingerprint, dec.node_id, dec.kind)
            prior = self._sticky.get(skey)
            if prior is not None:
                out.setdefault(id(node), {})[dec.kind] = prior
                return
            if skey in self._refused:
                return
            if not for_render:
                cost = predicted_compile_cost(_COST_KIND[dec.kind])
                win = (max(0.0, wall_s) * win_frac
                       * max(1, runs) * RECURRENCE_HORIZON)
                if cost > 0.0 and cost > win:
                    self._refused.add(skey)
                    REGISTRY.counter(
                        "adaptive.compile_budget_refused").add()
                    self._log(fingerprint, dec, applied=False,
                              query_id="", note=(
                                  f"cost {cost:.3f}s > win {win:.3f}s"))
                    return
                self._sticky[skey] = dec
            out.setdefault(id(node), {})[dec.kind] = dec

        def replayed(node, kind: str, node_id: int) -> bool:
            """Sticky-first: an ADMITTED decision replays even after
            its own effect erased the trigger from the history (a
            salted run records ~1x skew; a corrected estimate records
            no misestimate). Without this the decision would oscillate
            on/off every other run."""
            prior = self._sticky.get((fingerprint, node_id, kind))
            if prior is None:
                return False
            out.setdefault(id(node), {})[kind] = prior
            return True

        def walk(node):
            rec = hints.get(id(node))
            if isinstance(node, (N.Join, N.SemiJoin)):
                if rec is not None:
                    runs = int(rec.get("runs", 0))
                    wall = float(rec.get("wall_s", 0.0))
                    skew = float(rec.get("skew", 0.0))
                    hot = int(rec.get("hot_partition", -1))
                    nid = int(rec.get("node_id", -1))
                    if not replayed(node, "salt", nid) and (
                            isinstance(node, N.Join) and nworkers > 1
                            and node.kind != "full"
                            and skew >= SKEW_THRESHOLD and hot >= 0):
                        s = salt_factor(skew, nworkers, salt_max)
                        admit(node, AdaptiveDecision(
                            "salt", nid, salt=s,
                            hot_partition=hot,
                            trigger=f"skew {skew:.1f}x hot={hot}",
                        ), runs, wall, win_frac=1.0 - 1.0 / s)
                    if not replayed(node, "route", nid) and \
                            rec.get("route_fallback"):
                        admit(node, AdaptiveDecision(
                            "route", nid,
                            trigger="pallas route fell back (lying stats)",
                        ), runs, wall, win_frac=0.5)
                # build-size correction reads the BUILD CHILD's actuals
                brec = hints.get(id(node.right))
                if brec is not None:
                    bid = int(brec.get("node_id", -1))
                    if not replayed(node, "join_flip", bid) and (
                            float(brec.get("misest", 0.0)) >= MISEST_FACTOR
                            and int(brec.get("actual_rows", -1)) >= 0):
                        eb = bytes_for(node.right, brec["actual_rows"])
                        if eb >= 0:
                            admit(node, AdaptiveDecision(
                                "join_flip", bid, est_bytes=eb,
                                trigger=(
                                    f"build est {brec.get('est_rows')} vs "
                                    f"actual {brec.get('actual_rows')}"),
                            ), int(brec.get("runs", 0)),
                                float(brec.get("wall_s", 0.0)),
                                win_frac=0.5)
            elif isinstance(node, N.Aggregate):
                if rec is not None:
                    nid = int(rec.get("node_id", -1))
                    if not replayed(node, "bucket", nid) and (
                            float(rec.get("misest", 0.0)) >= MISEST_FACTOR
                            and int(rec.get("actual_rows", -1)) >= 0):
                        eb = bytes_for(node, rec["actual_rows"])
                        if eb >= 0:
                            admit(node, AdaptiveDecision(
                                "bucket", nid, est_bytes=eb,
                                trigger=(
                                    f"agg est {rec.get('est_rows')} vs "
                                    f"actual {rec.get('actual_rows')}"),
                            ), int(rec.get("runs", 0)),
                                float(rec.get("wall_s", 0.0)),
                                win_frac=0.5)
            for c in node.children:
                walk(c)

        try:
            walk(plan)
        except Exception:  # noqa: BLE001 — adaptivity never fails a query
            return {}
        return out

    # ---- decision log -------------------------------------------------
    def _log(self, fingerprint: str, dec: AdaptiveDecision,
             applied: bool, query_id: str, note: str = "") -> None:
        ev = dec.to_event(applied)
        ev.update({
            "fingerprint": fingerprint,
            "query_id": query_id,
            "trigger": (f"{dec.trigger}; {note}" if note else dec.trigger),
            "created_at": time.time(),
        })
        self.ring.append(ev)

    def note_applied(self, fingerprint: str, query_id: str,
                     events: list) -> None:
        """Stitch an executor's applied-decision events into the ring
        (the ``system.adaptive`` / flight-record path)."""
        for ev in events:
            ev = dict(ev)
            ev.setdefault("fingerprint", fingerprint)
            ev.setdefault("query_id", query_id)
            ev.setdefault("created_at", time.time())
            self.ring.append(ev)

    def rows(self) -> list:
        """Decision-log rows, oldest first (``system.adaptive``)."""
        return list(self.ring)

    def clear(self) -> None:
        self._sticky.clear()
        self._refused.clear()
        self.ring.clear()
