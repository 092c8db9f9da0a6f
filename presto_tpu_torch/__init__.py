"""presto_tpu_torch — the PyTorch/CUDA port of the presto_tpu SQL engine.

The JAX package ``presto_tpu`` is the reference; this package mirrors its
module layout (``types``, ``batch``, ``spi``, ``connectors.tpch``,
``connectors.ssb``, ``expr``, ``sql``, ``plan``, ``ops``, ``exec``,
``runtime``, ``workloads``) so each counterpart is found under the same
name. It
imports torch and numpy only. ``runtime.session.Session.sql`` is the SQL
entry point. Every TPU (Pallas)
kernel on a ported path has a hand-written CUDA C++ counterpart under
``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on a CPU tensor each kernel wrapper computes its plain
PyTorch version instead.
"""

from presto_tpu_torch.devices import resolve_device

__all__ = ["resolve_device"]
