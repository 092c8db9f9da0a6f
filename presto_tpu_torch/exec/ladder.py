"""The adaptive OOM degradation ladder: executor state.

Counterpart of ``presto_tpu/exec/ladder.py``. The lifecycle
(``runtime/lifecycle.QueryManager._run_with_oom_ladder``) catches a
runtime ``DeviceOutOfMemory``, calls :meth:`OomLadderMixin.degrade_for_oom`
and re-runs the plan on the same device; the executor consults
:attr:`oom_rung` at every out-of-core strategy point
(``exec/spill.plan_spill``). Rung semantics:

- rung 0: trust the stats estimates; estimates over the budget plan a
  hybrid spill up front (the K hottest build partitions device-resident,
  cold ones streamed from host);
- rung 1: the estimate lied: re-plan every join into hybrid with a
  shrunk resident set and doubled partition count, and drop the fused
  leaf route, the partial-aggregation bypass and the runtime join
  filters;
- rung 2: shrink the resident share again, double buckets again, and
  halve probe-chunk rows;
- rung k >= 3: fully grouped, nothing resident, bucket counts scaled by
  2^k (capped), probe chunks floored.

Aggregations whose estimate fits the budget have no spill state to
re-plan onto, so for them a rung is a plain re-run.
"""

from __future__ import annotations

#: past this rung every ladder knob is at its floor/cap (nbuckets
#: reaches the 1<<12 cap from 2 and probe chunks their 1<<10 floor at
#: rung 12), so degrading further cannot change the plan
OOM_RUNG_CAP = 12


class OomLadderMixin:
    """Ladder state and knob scaling of the executor."""

    #: current ladder rung; class default 0, bumped per instance
    oom_rung: int = 0

    def degrade_for_oom(self) -> bool:
        """Step one rung down the ladder; returns False when no further
        degradation is possible: past OOM_RUNG_CAP a re-run would execute
        the identical plan (the per-query budget below the cap is
        ``oom_ladder_max``, enforced by the lifecycle)."""
        if self.oom_rung >= OOM_RUNG_CAP:
            return False
        self.oom_rung += 1
        return True

    def _oom_factor(self) -> int:
        """Knob multiplier of the current rung (1 at rungs 0 and 1 —
        rung 1 only re-plans the spill mode; 2^(k-1) from rung 2 on)."""
        return 1 << (self.oom_rung - 1) if self.oom_rung > 1 else 1

    def _grouped_nbuckets(self, est_bytes: int) -> int:
        """Bucket count of a grouped (spilled) execution:
        ceil(estimate / budget), at least 2, scaled by the current
        ladder rung (capped)."""
        n = max(2, int(-(-est_bytes // max(self.join_build_budget, 1))))
        return min(n * self._oom_factor(), 1 << 12)

    def _oom_probe_chunk(self, probe_chunk: int) -> int:
        """Probe-chunk rows under the current rung (floored)."""
        return max(probe_chunk // self._oom_factor(), 1 << 10)

    # ---- planned spill tier (exec/spill.py) ------------------------------
    def _spill_decision(self, node, est_bytes: int):
        """The plan-time out-of-core choice for one join build / agg
        state: ``exec/spill.plan_spill`` over the byte estimate, the
        build budget, the current ladder rung and, when this plan's
        fingerprint has recurred with a measured hot partition, that
        partition as the resident set's seed."""
        from presto_tpu_torch.exec.spill import plan_spill

        hot = None
        hint = getattr(self, "plan_hints", None)
        hint = hint.get(id(node)) if hint else None
        if hint is not None and int(hint.get("hot_partition", -1)) >= 0:
            hot = int(hint["hot_partition"])
        return plan_spill(est_bytes, self.join_build_budget, hot_partition=hot,
                          oom_rung=self.oom_rung)

    def _note_spill(self, node, decision, resident=None,
                    streamed: int = 0, host_bytes: int = 0) -> None:
        """Record one executed spill decision: the ``spill.*`` counters and
        histogram, ``NodeStats.spill_*`` (EXPLAIN ANALYZE) and the
        ``spill_events`` summary the lifecycle appends to the query's
        rung history."""
        from presto_tpu_torch.runtime.metrics import REGISTRY

        res = len(decision.resident if resident is None else resident)
        REGISTRY.counter(f"spill.planned_{decision.mode}").add()
        if res:
            REGISTRY.counter("spill.partitions_resident").add(res)
        if streamed:
            REGISTRY.counter("spill.partitions_streamed").add(streamed)
        if decision.nbuckets:
            REGISTRY.histogram("spill.resident_fraction").add(
                res / decision.nbuckets)
        recorder = getattr(self, "recorder", None)
        if recorder is not None:
            try:
                recorder.record_spill(node, decision.mode,
                                      decision.nbuckets, res,
                                      int(host_bytes))
            except Exception:  # noqa: BLE001 — telemetry never raises
                pass
        events = getattr(self, "spill_events", None)
        if events is not None:
            from presto_tpu_torch.runtime.devices import headroom_bytes

            try:
                headroom = headroom_bytes()
            except Exception:  # noqa: BLE001 — telemetry never raises
                headroom = None
            events.append({
                "node": type(node).__name__,
                "mode": decision.mode,
                "partitions": int(decision.nbuckets),
                "resident": int(res),
                "streamed": int(streamed),
                "est_bytes": int(decision.est_bytes),
                "budget_bytes": int(decision.budget),
                "host_bytes": int(host_bytes),
                "oom_rung": int(self.oom_rung),
                # live device headroom at decision time (-1 where no
                # allocator stats are reported): whether the spill
                # fired under real device-memory pressure
                "device_headroom_bytes": (-1 if headroom is None
                                          else int(headroom)),
            })

    # ---- adaptive execution (plan/adaptive.py) ---------------------------
    #: decision kind -> counter family
    _ADAPTIVE_COUNTER = {
        "salt": "adaptive.salted",
        "join_flip": "adaptive.join_flip",
        "bucket": "adaptive.bucket_override",
        "route": "adaptive.route_disabled",
    }

    def _adaptive_decision(self, node, kind: str):
        """This node's adaptive decision of one kind, or None. The session
        wires ``adaptive`` per query ({id(live node) -> {kind ->
        decision}})."""
        decisions = getattr(self, "adaptive", None)
        if not decisions:
            return None
        per_node = decisions.get(id(node))
        return per_node.get(kind) if per_node else None

    def _note_adaptive(self, node, dec, action: str = "") -> None:
        """Record one applied adaptive decision: its ``adaptive.*``
        counter and the ``adaptive_events`` summary the flight recorder
        captures and the session stitches into ``system.adaptive``."""
        from presto_tpu_torch.runtime.metrics import REGISTRY

        REGISTRY.counter(self._ADAPTIVE_COUNTER[dec.kind]).add()
        events = getattr(self, "adaptive_events", None)
        if events is not None:
            ev = dec.to_event(applied=True)
            ev["node"] = type(node).__name__
            if action:
                ev["action"] = action
            events.append(ev)

    def _note_route_fallback(self, node) -> None:
        """A planner-chosen fused route fell back at run time: mark the
        node's stats, so the fingerprint's history carries it."""
        recorder = getattr(self, "recorder", None)
        if recorder is None:
            return
        try:
            recorder.record_route_fallback(node)
        except Exception:  # noqa: BLE001 -- telemetry never raises
            pass
