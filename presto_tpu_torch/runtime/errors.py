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

