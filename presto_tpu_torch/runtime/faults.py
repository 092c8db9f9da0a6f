"""Deterministic fault injection: the testable half of robustness.

Counterpart of ``presto_tpu/runtime/faults.py``, whole. Engine code
calls ``fault_point(site)`` at its host-side hook points (connector
scans, aggregation and join-build dispatches) right before it hands the
device work, and an installed :class:`FaultInjector` decides,
deterministically, whether that call raises.

Determinism rules (tests must replay exactly):

- ``times=N`` faults fire on the first N matching calls, then go
  silent (the shape retry tests need: "fail twice, then succeed").
- ``probability=p`` faults draw from the injector's OWN seeded
  ``random.Random`` stream, in call order; same seed + same call
  sequence = same fault sequence, as in the JAX package.
- Sites are dot-separated names (``"step.agg"``); a spec for a prefix
  (``"step"``) matches every descendant site.

Hook points are no-ops (one module attribute read) when no injector is
installed, so production paths pay nothing. ``SITES`` lists the JAX
package's sites; the port reaches all but the ``exchange.*`` ones, which
come with the distributed tier: ``scan``, ``aggregation``, ``step.agg``,
``step.join_build``, and since the lifecycle and the out-of-core tier
``step.grouped_join``, ``step.spill_transfer``, ``step.spill_partition``
and ``step.cancel_checkpoint`` (every deadline check).
"""

from __future__ import annotations

import random
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from presto_tpu_torch.runtime.errors import TransientFailure

#: canonical hook-point sites (descendants are fair game too)
SITES = (
    "scan",  # connector scan loops (both execution tiers)
    "exchange.aggregate",  # partial->all_to_all->final agg step
    "exchange.join",  # repartition-join all_to_all step
    "exchange.gather",  # replicate/broadcast all_gather
    "exchange.window",  # partitioned-window shuffle
    "exchange.sort",  # range-partition sort shuffle
    "aggregation",  # aggregation dispatch (local + distributed)
    "step.join_build",  # in-memory join build materialization/dispatch
    "step.grouped_join",  # grouped (bucketed) join bucket passes
    "step.agg",  # grouped-aggregation step dispatch
    "step.spill_transfer",  # host->device cold-partition transfer submits
    "step.spill_partition",  # recursive re-partition of an oversized bucket
    "step.cancel_checkpoint",  # cooperative cancel/deadline checkpoints
)


class BackendOom(torch.OutOfMemoryError):
    """Backend-SHAPED out-of-memory for the ``oom`` fault kind: NOT a
    taxonomy error. It subclasses ``torch.OutOfMemoryError`` with the
    CUDA caching allocator's words, as the card raises it at a launch
    when device memory runs out, so a handler of the real error is
    exercised on the CPU, where a real allocator OOM is impractical to
    stage. (``torch.OutOfMemoryError`` exists, and is raisable, on a
    CPU-only torch too.)"""

    def __init__(self, message: str = ""):
        super().__init__(
            "CUDA out of memory. Tried to allocate device buffer"
            + (f" ({message})" if message else " (injected)")
        )


@dataclass
class FaultSpec:
    """One armed fault: where it fires, what it raises, how often."""

    site: str
    error: type = TransientFailure
    #: fire on the first N matching calls (None = every matching call);
    #: with ``per_site`` the bound applies to each CONCRETE site a
    #: prefix spec matches, not to the spec as a whole
    times: int | None = 1
    probability: float = 1.0
    message: str = ""
    per_site: bool = False
    fired: int = 0
    fired_by_site: dict = field(default_factory=dict)

    def matches(self, site: str) -> bool:
        return site == self.site or site.startswith(self.site + ".")

    def exhausted(self, site: str) -> bool:
        if self.times is None:
            return False
        if self.per_site:
            return self.fired_by_site.get(site, 0) >= self.times
        return self.fired >= self.times

    def record_fire(self, site: str) -> None:
        self.fired += 1
        self.fired_by_site[site] = self.fired_by_site.get(site, 0) + 1


@dataclass
class FaultInjector:
    """Seedable registry of armed faults (install via :func:`injected`
    or :func:`install`)."""

    seed: int = 0
    specs: list[FaultSpec] = field(default_factory=list)

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def inject(
        self,
        site: str,
        error: type = TransientFailure,
        times: int | None = 1,
        probability: float = 1.0,
        message: str = "",
        per_site: bool = False,
    ) -> FaultSpec:
        """Arm a fault at ``site`` (or any descendant ``site.*``)."""
        spec = FaultSpec(site, error, times, probability, message, per_site)
        self.specs.append(spec)
        return spec

    def inject_oom(
        self,
        site: str = "step",
        times: int | None = 1,
        probability: float = 1.0,
        per_site: bool = True,
    ) -> FaultSpec:
        """The ``oom`` fault kind: a backend-shaped out-of-memory
        (:class:`BackendOom`, a ``torch.OutOfMemoryError``) at step
        dispatch sites, with deterministic PER-SITE fire counts by
        default ("the in-memory build OOMs twice, then succeeds" is one
        spec)."""
        return self.inject(site, error=BackendOom, times=times,
                           probability=probability, per_site=per_site)

    def fired(self, site: str | None = None) -> int:
        """Total fires, optionally restricted to one armed site."""
        return sum(
            s.fired for s in self.specs if site is None or s.site == site
        )

    def fired_at(self, site: str) -> int:
        """Fires recorded at one CONCRETE site, across every spec
        (prefix specs included)."""
        return sum(s.fired_by_site.get(site, 0) for s in self.specs)

    def check(self, site: str) -> None:
        """Raise the first armed fault matching ``site`` (hook-point
        body; engine code calls :func:`fault_point` instead)."""
        for spec in self.specs:
            if not spec.matches(site):
                continue
            if spec.exhausted(site):
                continue
            if spec.probability < 1.0 and (
                self._rng.random() >= spec.probability
            ):
                continue
            spec.record_fire(site)
            msg = spec.message or (
                f"injected fault at {site!r} (fire #{spec.fired})"
            )
            raise spec.error(msg)


#: the installed injector; None (the default) makes every hook a no-op
_ACTIVE: FaultInjector | None = None


def install(injector: FaultInjector | None) -> None:
    """Install (or, with None, clear) the process-wide injector."""
    global _ACTIVE
    _ACTIVE = injector


def active() -> FaultInjector | None:
    return _ACTIVE


@contextmanager
def injected(injector: FaultInjector):
    """Scoped install — the test-suite idiom."""
    prev = _ACTIVE
    install(injector)
    try:
        yield injector
    finally:
        install(prev)


def fault_point(site: str) -> None:
    """Engine hook point: raises iff an installed injector says so."""
    if _ACTIVE is not None:
        _ACTIVE.check(site)
