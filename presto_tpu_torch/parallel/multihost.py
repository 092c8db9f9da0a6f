"""Multi-host bootstrap: the cluster-membership tier, for one process.

Counterpart of ``presto_tpu/parallel/multihost.py``. The JAX package
forms a cluster with ``jax.distributed``: every host runs the same
single-controller program and ``jax.devices()`` then lists the global
device set. A single PyTorch controller addresses only its own host's
cards, so the port runs one process: :func:`num_hosts` is 1,
:func:`global_dcn_mesh` is ``make_mesh()`` (as the JAX package's is with
one process), and :func:`initialize` with more than one process raises
``NotSupported`` (ROADMAP C27).
"""

from __future__ import annotations

from presto_tpu_torch.parallel.mesh import make_dcn_mesh, make_mesh
from presto_tpu_torch.runtime.errors import NotSupported


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, local_device_ids=None):
    """Join the cluster. One process is the whole cluster; more cannot
    be driven by this single controller."""
    if num_processes is not None and num_processes > 1:
        raise NotSupported(
            f"multihost.initialize(num_processes={num_processes}): a single PyTorch "
            "controller cannot address another host's devices; run one process")


def num_hosts() -> int:
    return 1


def global_dcn_mesh(per_host: int | None = None, device="cuda"):
    """The cluster-wide mesh: with one process the flat mesh over this
    host's devices."""
    hosts = num_hosts()
    if hosts <= 1:
        return make_mesh(device=device)
    return make_dcn_mesh(hosts, per_host, device=device)
