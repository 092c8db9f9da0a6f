"""Device mesh setup: the worker set.

Counterpart of ``presto_tpu/parallel/mesh.py``. The JAX package's cluster
is a ``jax.sharding.Mesh`` driven by one controller; here a :class:`Mesh`
is an ordered list of ``torch.device`` shards and its axis names, driven
the same way by one Python process. One axis ``"workers"`` plays the
role of Presto's worker set: scan splits are data-parallel across it,
hash-partitioned exchanges are all-to-alls along it
(``parallel/exchange.py``), broadcasts are all-gathers.

``make_dcn_mesh`` builds the 2-D ``("dcn", "ici")`` shape; every
collective runs over the combined axes, so the executor's steps are the
same on either shape.

A device may appear more than once: ``make_mesh(4, devices=["cuda:0"] *
4)`` runs four shards on one card, the counterpart of the JAX package's
virtual devices on one host, and ``device="cpu"`` gives ``n`` logical CPU
shards. Nothing picks the CPU unless the caller asks for it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from presto_tpu_torch.runtime.errors import UserError

WORKERS = "workers"
DCN = "dcn"
ICI = "ici"


class Mesh:
    """An ordered worker set: ``devices[i]`` holds shard ``i``; ``shape``
    lays the shards out over ``axis_names`` (row-major)."""

    __slots__ = ("devices", "axis_names", "shape")

    def __init__(self, devices: Sequence, axis_names: Sequence[str],
                 shape: Sequence[int] | None = None):
        self.devices = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in (shape or (len(self.devices),)))
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not match axes {self.axis_names}")
        n = 1
        for s in self.shape:
            n *= s
        if n != len(self.devices):
            raise ValueError(f"mesh shape {self.shape} needs {n} devices, got {len(self.devices)}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        """The one device type every shard lives on."""
        return self.devices[0].type

    def __repr__(self) -> str:
        return f"Mesh({dict(zip(self.axis_names, self.shape))}, {[str(d) for d in self.devices]})"


def _devices(n: int | None, devices, device) -> list[torch.device]:
    if devices is not None:
        devs = [torch.device(d) for d in devices]
    elif torch.device(device).type == "cpu":
        devs = [torch.device("cpu")] * (1 if n is None else n)
    else:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devs = [torch.device("cuda", i) for i in range(count)]
    if n is not None:
        if len(devs) < n:
            raise UserError(f"need {n} devices, have {len(devs)}")
        devs = devs[:n]
    if not devs:
        raise UserError("need 1 devices, have 0")
    if len({d.type for d in devs}) > 1:
        raise UserError(f"a mesh's devices share one type, got {sorted({d.type for d in devs})}")
    return devs


def make_mesh(n_devices: int | None = None, devices=None, device="cuda") -> Mesh:
    """A 1-D ``("workers",)`` mesh over the first ``n_devices`` visible
    CUDA devices (all of them when None), or over the listed ``devices``
    (repeats allowed), or over ``n_devices`` CPU shards when
    ``device="cpu"``."""
    return Mesh(_devices(n_devices, devices, device), (WORKERS,))


def make_dcn_mesh(n_hosts: int, per_host: int | None = None, devices=None,
                  device="cuda") -> Mesh:
    """2-D mesh: an outer ``dcn`` axis across hosts and an inner ``ici``
    axis within one, shards host-major. One process addresses one host's
    devices, so the rows are consecutive runs of the device list."""
    devs = _devices(None, devices, device) if devices is not None or per_host is None \
        else _devices(n_hosts * per_host, None, device)
    if per_host is None:
        if len(devs) % n_hosts:
            raise UserError(f"{len(devs)} devices not divisible by {n_hosts}")
        per_host = len(devs) // n_hosts
    need = n_hosts * per_host
    if len(devs) < need:
        raise UserError(f"need {need} devices, have {len(devs)}")
    return Mesh(devs[:need], (DCN, ICI), (n_hosts, per_host))


def worker_axes(mesh: Mesh) -> tuple[str, ...]:
    """The axis names playing the worker-set role for this mesh shape;
    collectives run over the whole tuple."""
    return tuple(mesh.axis_names)


# ---------------------------------------------------------------------------
# The sharded layout
# ---------------------------------------------------------------------------
#
# A row-sharded batch keeps one tensor per column on the mesh's first
# device, shard-major: shard ``i`` is the row range
# ``[i * cap, (i + 1) * cap)``, where ``cap`` is the batch's capacity over
# the mesh size. A per-shard step reads its shard as a view, run on the
# shard's own device (a peer copy when that is another card; nothing
# when every shard shares one device), and the shards' outputs are
# joined back in shard order, which is also what an all-gather returns.


def _valid_like(c, live_src, live_dst, fn):
    """A column's validity under a row transform: the shared-live
    identity (a NULL-free column's validity IS the live tensor) and
    "no mask" both survive it."""
    if c.valid is None:
        return None
    if c.valid is live_src:
        return live_dst
    return fn(c.valid)


def shard_view(batch, i: int, n: int, device=None):
    """Rows of shard ``i`` of ``n`` (on ``device`` when given)."""
    from presto_tpu_torch.batch import Batch, Column

    cap = batch.capacity // n
    lo, hi = i * cap, (i + 1) * cap

    def take(t):
        t = t[lo:hi]
        return t if device is None else t.to(device, non_blocking=True)

    live = take(batch.live)
    cols = {name: Column(take(c.data), _valid_like(c, batch.live, live, take), c.dtype,
                         c.dictionary)
            for name, c in batch.columns.items()}
    return Batch(cols, live)


def shards_of(batch, mesh: Mesh) -> list:
    """Each shard of a row-sharded batch, on its own device."""
    n = mesh.size
    return [shard_view(batch, i, n, mesh.devices[i]) for i in range(n)]


def join_shards(parts: list, mesh: Mesh):
    """Per-shard batches (equal schemas) joined in shard order on the
    mesh's first device: the global row-sharded batch."""
    from presto_tpu_torch.batch import Batch, Column

    home = mesh.devices[0]
    parts = [p if p.device == home else p.to(home) for p in parts]
    if len(parts) == 1:
        return parts[0]
    live = torch.cat([p.live for p in parts])
    cols = {}
    first = parts[0]
    for name in first.names:
        cs = [p[name] for p in parts]
        if all(c.valid is None for c in cs):
            valid = None
        elif all(c.valid is p.live for c, p in zip(cs, parts)):
            valid = live
        else:
            valid = torch.cat([p.live.new_ones(p.capacity) if c.valid is None else c.valid
                               for c, p in zip(cs, parts)])
        dic = next((c.dictionary for c in cs if c.dictionary is not None), None)
        cols[name] = Column(torch.cat([c.data for c in cs]), valid, first[name].dtype, dic)
    return Batch(cols, live)
