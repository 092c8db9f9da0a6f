"""The port's exchange (``presto_tpu_torch/parallel/exchange.py``) against
the JAX package's collectives on its virtual CPU mesh.

The JAX package's shuffle tests (``tests/test_distributed.py``) ported:
the single-round round trip and its overflow flag, the zipfian
multi-round drain at a small fixed quota, the receive-overflow flag and
the broadcast. Beyond their multiset checks, every received batch here
equals the JAX package's row for row (the row order of every unordered
distributed result rests on it), the multi-round exchange's round count
and global per-destination totals are the JAX package's, and the host
reads the round flag once before the first round and once after each.
Also: the wire-byte formulas, ``skew_ratio``, and
``workloads.q1_distributed_step`` against the JAX package's
(``tests/test_parallel.py::test_q1_distributed_matches_single``).
"""

import jax

jax.config.update("jax_platforms", "cpu")

from functools import partial  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec as JSpec  # noqa: E402

from presto_tpu.batch import Batch as JBatch  # noqa: E402
from presto_tpu.ops.hashing import partition_ids as jpartition_ids  # noqa: E402
from presto_tpu.parallel import exchange as JX  # noqa: E402
from presto_tpu.parallel.mesh import make_mesh as jmesh  # noqa: E402
from presto_tpu.parallel.mesh import row_sharding, shard_map  # noqa: E402
from presto_tpu.types import BIGINT, DOUBLE  # noqa: E402
from presto_tpu_torch.ops.hashing import partition_ids  # noqa: E402
from presto_tpu_torch.parallel import exchange as PX  # noqa: E402
from presto_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from torch_bridge import assert_same, port_batch  # noqa: E402

N = 4  # shards


@pytest.fixture(scope="module")
def meshes():
    return jmesh(N), make_mesh(N, device="cpu")


def _batch(rng, cap, dead=17, hot=None):
    k = rng.integers(0, 1000, cap, dtype=np.int64)
    if hot is not None:
        k = np.where(rng.random(cap) < hot, 7, k).astype(np.int64)
    v = rng.normal(size=cap)
    return JBatch.from_numpy({"k": k, "v": v}, {"k": BIGINT, "v": DOUBLE}, count=cap - dead)


def _same_batch(pb, jb, what=""):
    assert_same(pb.live, jb.live, f"{what} live")
    for name in jb.names:
        assert_same(pb[name].data, jb[name].data, f"{what} {name}")


def _jax_multiround(mesh, quota, recv_cap, b, pids):
    axes = ("workers",)

    @partial(shard_map, mesh=mesh, in_specs=(JSpec(axes), JSpec(axes)),
             out_specs=(JSpec(axes), JSpec(), JSpec(), JSpec()), check_vma=False)
    def step(batch, p):
        out, ovf, rnd, dest = JX.exchange_multiround(batch, p, N, quota, recv_cap, axes=axes,
                                                     with_rounds=True, with_stats=True)
        return out, JX.any_flag(ovf, axes), rnd, dest

    return jax.jit(step)(jax.device_put(b, row_sharding(mesh)),
                         jax.device_put(pids, row_sharding(mesh)))


def test_shuffle_roundtrip_equals_reference(meshes, rng):
    jm, pm = meshes
    b = _batch(rng, N * 512)
    pids = jpartition_ids([b["k"].data], N)
    jout, jovf = JX.make_shuffle_step(jm, N, quota=256)(
        jax.device_put(b, row_sharding(jm)), jax.device_put(pids, row_sharding(jm)))
    pb = port_batch(b)
    ppids = partition_ids([pb["k"].data], N)
    assert_same(ppids, pids, "pids")
    pout, povf = PX.make_shuffle_step(pm, N, quota=256)(pb, ppids)
    assert not bool(povf) and not bool(jovf)
    _same_batch(pout, jout, "received")
    # every live row on the shard owning its partition
    live = pout.live.numpy()
    owner = partition_ids([pout["k"].data], N).numpy()
    shard = np.arange(pout.capacity) // (pout.capacity // N)
    assert (owner[live] == shard[live]).all()


def test_shuffle_overflow_flag(meshes, rng):
    _jm, pm = meshes
    pb = port_batch(_batch(rng, N * 512))
    zeros = torch.zeros(N * 512, dtype=torch.int32)
    _out, ovf = PX.make_shuffle_step(pm, N, quota=16)(pb, zeros)
    assert bool(ovf)


@pytest.mark.parametrize("quota,recv_cap", [(64, 4096), (64, 1024), (32, 8192)])
def test_multiround_drains_zipfian_skew_like_reference(meshes, rng, quota, recv_cap):
    """~70% of the rows share one hot key: the hot shard receives far more
    than P * quota rows a round, and the exchange drains it in extra
    rounds at the fixed quota, as the JAX package's does: the same rows
    in the same slots, the same round count and per-destination totals."""
    jm, pm = meshes
    b = _batch(rng, N * 1024, dead=9, hot=0.7)
    pids = jpartition_ids([b["k"].data], N)
    jout, jovf, jrnd, jdest = _jax_multiround(jm, quota, recv_cap, b, pids)
    pb = port_batch(b)
    reads = PX.flag_reads
    pout, povf, prnd, pdest = PX.exchange_multiround(
        pb, partition_ids([pb["k"].data], N), N, quota, recv_cap, with_rounds=True,
        with_stats=True)
    assert bool(povf) == bool(jovf)
    assert prnd == int(jrnd) and prnd > 1
    assert PX.flag_reads - reads == prnd + 1
    assert_same(pdest, jdest, "destination totals")
    _same_batch(pout, jout, "received")
    if not bool(povf):
        assert int(pout.live.sum()) == int(np.asarray(b.live).sum())


def test_multiround_receive_overflow_flag(meshes, rng):
    """Overflow means true placement skew: a shard owning more rows than
    ``recv_cap`` trips the flag."""
    jm, pm = meshes
    b = _batch(rng, N * 512)
    zeros = np.zeros(N * 512, np.int32)
    jout, jovf, jrnd, _ = _jax_multiround(jm, 64, 256, b, jax.numpy.asarray(zeros))
    pout, povf = PX.make_multiround_shuffle_step(pm, N, quota=64, recv_cap=256)(
        port_batch(b), torch.from_numpy(zeros))
    assert bool(povf) and bool(jovf)
    _same_batch(pout, jout, "received")


def test_broadcast_replicates_all_rows(meshes, rng):
    jm, pm = meshes
    b = _batch(rng, N * 64)
    jout = JX.make_broadcast_step(jm)(jax.device_put(b, row_sharding(jm)))
    pout = PX.make_broadcast_step(pm)(port_batch(b))
    assert pout.capacity == N * 64
    _same_batch(pout, jout, "broadcast")


@pytest.mark.parametrize("args", [(17, 4, 64, 1), (9, 8, 256, 3), (1, 1, 16, 0)])
def test_wire_bytes_equal_reference(args):
    assert PX.a2a_wire_bytes(*args) == JX.a2a_wire_bytes(*args)
    row_bytes, parts, quota, _ = args
    assert PX.gather_wire_bytes(row_bytes, quota * parts, parts) == \
        JX.gather_wire_bytes(row_bytes, quota * parts, parts)


@pytest.mark.parametrize("counts", [[5, 5, 5, 5], [20, 0, 0, 0], [0, 0], [3, 1, 0, 8, 2], []])
def test_skew_ratio_equals_reference(counts):
    assert PX.skew_ratio(np.asarray(counts, np.int64)) == JX.skew_ratio(np.asarray(counts,
                                                                                   np.int64))


def test_any_flag_combines_shards():
    assert bool(PX.any_flag([torch.tensor(False), torch.tensor(True)]))
    assert not bool(PX.any_flag(torch.zeros(4, dtype=torch.bool)))


def test_q1_distributed_matches_single_and_reference(meshes):
    from presto_tpu.connectors.tpch import TpchConnector as JT
    from presto_tpu.workloads import q1_batch as jq1_batch
    from presto_tpu.workloads import q1_distributed_step as jq1_dist
    from presto_tpu_torch.workloads import q1_distributed_step, q1_fused_step

    jm, pm = meshes
    jb = jq1_batch(JT(sf=0.01), capacity=1 << 17)
    want = jq1_dist(jm)(jax.device_put(jb, row_sharding(jm)))
    pb = port_batch(jb)
    got = q1_distributed_step(pm)(pb)
    single = q1_fused_step(pb)
    for k in want:
        assert_same(got[k], want[k], k)
        assert_same(single[k], want[k], k)
