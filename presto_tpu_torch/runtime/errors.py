"""Typed error taxonomy (the subset the ported slices raise).

Counterpart of ``presto_tpu/runtime/errors.py``: every failure carries a
typed error code and a retry class. ``UserError`` subclasses
``ValueError`` and the resource classes subclass ``RuntimeError`` so
callers catching the stdlib types keep working.
"""

from __future__ import annotations


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
