"""Typed error taxonomy.

Counterpart of ``presto_tpu/runtime/errors.py``: every failure carries a
typed error code and a retry class. ``UserError`` subclasses
``ValueError`` and the resource classes subclass ``RuntimeError`` so
callers catching the stdlib types keep working. ``is_backend_oom``
recognizes what the card raises when device memory runs out: the CUDA
caching allocator's ``torch.OutOfMemoryError`` ("CUDA out of memory.
Tried to allocate ..."), a ``RuntimeError`` "CUDA error: out of memory"
from a raw allocation, and ``MemoryError``.
"""

from __future__ import annotations

import torch


class PrestoError(Exception):
    """Base of the taxonomy: a typed error code plus a retry class."""

    error_code: str = "GENERIC_INTERNAL_ERROR"
    retryable: bool = False

    def __init__(self, message: str, *, retryable: bool | None = None):
        super().__init__(message)
        if retryable is not None:
            self.retryable = retryable


class UserError(PrestoError, ValueError):
    """The query (or its input) is at fault. Never retryable."""

    error_code = "USER_ERROR"
    retryable = False


class ResourceExhausted(PrestoError, RuntimeError):
    """The work needs more of a bounded resource than the engine grants
    (a kernel's slot limit, a capacity bucket). Not retryable."""

    error_code = "RESOURCE_EXHAUSTED"
    retryable = False


class DeviceOutOfMemory(ResourceExhausted):
    """A backend out-of-memory mid-dispatch: a plan-time estimate was
    wrong and the static spill decision under-provisioned. Not retryable
    as-is (replaying the same step allocates the same buffers) but
    recoverable: the lifecycle's OOM ladder (``oom_ladder_max``) re-plans
    the query with more buckets and smaller probe chunks and re-runs it
    on the same device."""

    error_code = "DEVICE_OUT_OF_MEMORY"
    retryable = False


class SpillBudgetExceeded(ResourceExhausted):
    """The host-side spill store (``exec/grouped.HostSpill``) would grow
    past ``spill_host_budget_bytes``. Not retryable and not
    ladder-eligible: more buckets do not shrink the total spilled
    bytes."""

    error_code = "SPILL_BUDGET_EXCEEDED"
    retryable = False


class SpillPartitionOverflow(ResourceExhausted):
    """A cold spill partition still exceeds the per-unit byte budget
    after ``MAX_SPILL_RECURSION`` recursive re-partitionings: its rows
    share one hash residue at every doubled modulus (one key's duplicate
    run), so splitting cannot help."""

    error_code = "SPILL_PARTITION_OVERFLOW"
    retryable = False


class ExceededTimeLimit(PrestoError, RuntimeError):
    """The per-query wall-clock deadline (``query_max_run_time``)
    expired. Not retryable within the query."""

    error_code = "EXCEEDED_TIME_LIMIT"
    retryable = False


class ServerOverloaded(ResourceExhausted):
    """The serving tier shed this submission at admission. Retryable:
    the demand is a property of the moment, not the query. Carries
    ``retry_after_s``, a monotone function of queue depth."""

    error_code = "SERVER_OVERLOADED"
    retryable = True

    def __init__(self, message: str, *, retry_after_s: float = 1.0,
                 retryable: bool | None = None):
        super().__init__(message, retryable=retryable)
        self.retry_after_s = float(retry_after_s)


class QueryCancelled(PrestoError, RuntimeError):
    """The query's ``CancelScope`` was flipped (``Session.cancel``) and a
    cooperative checkpoint observed it. Not retryable: cancellation is a
    decision, not a failure. Reservations release through the same
    ``finally`` paths as any other typed failure."""

    error_code = "QUERY_CANCELLED"
    retryable = False


class InternalError(PrestoError, RuntimeError):
    """An engine invariant broke: ineligible kernel arguments, a kernel
    build or launch failure. Not retryable by default."""

    error_code = "GENERIC_INTERNAL_ERROR"
    retryable = False


class NotSupported(PrestoError, NotImplementedError):
    """A construct the port does not cover yet (an SQL form, a plan
    node, a join or aggregation shape outside the ported slices). The
    message names the construct. ``NotImplementedError`` ancestry keeps
    callers catching the stdlib type working."""

    error_code = "NOT_SUPPORTED"
    retryable = False


class TransientFailure(PrestoError, RuntimeError):
    """A plausibly-transient fault: an injected fault, a lost device,
    a flaky interconnect step. Retryable: the query-level retry loop
    (``query_retries``) re-runs the query from the top."""

    error_code = "TRANSIENT_FAILURE"
    retryable = True


def is_retryable(exc: BaseException) -> bool:
    """Retry class of any exception: taxonomy errors carry their own
    flag; foreign exceptions are conservatively non-retryable (the
    query-level ``query_retries`` still re-runs them: that knob
    predates the taxonomy and deliberately retries everything)."""
    return bool(getattr(exc, "retryable", False))


def is_backend_oom(exc: BaseException) -> bool:
    """Does ``exc`` look like a backend out-of-memory? The CUDA caching
    allocator's ``torch.OutOfMemoryError`` (the fault injector's
    ``BackendOom`` is one), an "out of memory" message (a raw
    allocation's "CUDA error: out of memory"), and stdlib
    ``MemoryError``. A taxonomy error is never re-classified: an
    admission rejection mentioning bytes must not turn into a
    recoverable device OOM. A sticky launch failure ("an illegal memory
    access was encountered") is not an OOM."""
    if isinstance(exc, PrestoError):
        return False
    if isinstance(exc, (MemoryError, torch.OutOfMemoryError)):
        return True
    return "out of memory" in str(exc).lower()


def error_code(exc: BaseException) -> str:
    """Stable code for any exception (foreign ones are classified by
    their stdlib ancestry)."""
    code = getattr(exc, "error_code", None)
    if code is not None:
        return code
    if isinstance(exc, NotImplementedError):
        return "NOT_SUPPORTED"
    if isinstance(exc, ValueError):
        return "USER_ERROR"
    if isinstance(exc, TimeoutError):
        return "EXCEEDED_TIME_LIMIT"
    if isinstance(exc, MemoryError):
        return "RESOURCE_EXHAUSTED"
    return "GENERIC_INTERNAL_ERROR"
