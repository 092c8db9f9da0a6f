"""Serving layer: multi-tenant front-end, fairness scheduler and
cross-query batched dispatch.

Counterpart of ``presto_tpu/server/``, three cooperating pieces over the
``Session`` / ``QueryManager`` substrate:

- :mod:`presto_tpu_torch.server.scheduler`: weighted-fair admission with
  per-tenant quotas in front of the memory pool's strict FIFO;
- :mod:`presto_tpu_torch.server.batcher`: concurrent same-template
  different-literal queries share one scan and one batched dispatch;
- :mod:`presto_tpu_torch.server.frontend`: the HTTP/JSON surface
  (``/v1/statement``, ``/v1/prepared``, ``/v1/subscribe``, ``/metrics``)
  and the in-process ``ServerClient``.

Imports are lazy (PEP 562): the lifecycle imports the batcher from every
``QueryManager`` without pulling the HTTP front-end in.
"""

from __future__ import annotations

_EXPORTS = {
    "TenantSpec": "presto_tpu_torch.server.scheduler",
    "FairScheduler": "presto_tpu_torch.server.scheduler",
    "TemplateBatchGate": "presto_tpu_torch.server.batcher",
    "run_batched": "presto_tpu_torch.server.batcher",
    "QueryServer": "presto_tpu_torch.server.frontend",
    "ServerClient": "presto_tpu_torch.server.frontend",
    "HttpFrontend": "presto_tpu_torch.server.frontend",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
