"""TPC-H Q1 in the port against the JAX package.

``cuda_q1.q1_step_plain`` (the Q1 kernel's plain version, which
``q1_step`` computes on a CPU batch) against the Pallas ``q1_step`` in
interpret mode, mirroring ``tests/test_pallas_q1.py``; the port's
``q1_fused_step`` against the JAX one; and ``q1_pipeline`` at sf 0.01,
column by column. Exact: int64 values and dtypes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import presto_tpu.workloads as JW
import presto_tpu_torch.workloads as PW
from presto_tpu.batch import Batch as JBatch
from presto_tpu.batch import Column as JColumn
from presto_tpu.connectors.tpch import TpchConnector as JConnector
from presto_tpu.ops import pallas_q1
from presto_tpu.types import DATE, decimal, varchar
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.ops import cuda_q1
from presto_tpu_torch.runtime.errors import InternalError
from torch_bridge import assert_same, port_batch

CAP = 1 << 16
SUMS = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge", "sum_disc",
        "count_order", "present")


def _narrow_batch(rng, cap=CAP, rows=None):
    """The JAX test's narrow Q1 batch, with validity SHARED with live (as
    scan batches have it), so it is eligible in both packages."""
    rows = cap if rows is None else rows
    dec2 = decimal(12, 2)
    mk = {
        "l_shipdate": (np.int16, 9000, 11500, DATE),  # straddles the cutoff
        "l_returnflag": (np.int8, 0, 3, varchar()),
        "l_linestatus": (np.int8, 0, 2, varchar()),
        "l_quantity": (np.int16, 100, 5001, dec2),
        "l_extendedprice": (np.int32, 90000, 10_500_000, dec2),
        "l_discount": (np.int8, 0, 11, dec2),
        "l_tax": (np.int8, 0, 9, dec2),
    }
    live_np = np.zeros(cap, np.bool_)
    live_np[:rows] = True
    live = jnp.asarray(live_np)
    cols = {name: JColumn(jnp.asarray(rng.integers(lo, hi, cap).astype(dt)), live,
                          typ.with_physical(dt))
            for name, (dt, lo, hi, typ) in mk.items()}
    return JBatch(cols, live)


def _with(jb, name, row, value):
    cols = dict(jb.columns)
    for n, v in ((name, value), ("l_shipdate", 9100)):  # under the cutoff
        data = np.array(cols[n].data)
        data[row] = v
        cols[n] = JColumn(jnp.asarray(data), jb.live, cols[n].dtype)
    return JBatch(cols, jb.live)


def _assert_state(got, want, keys=SUMS):
    for k in keys:
        assert_same(got[k], want[k], k)
    assert_same(got["value_overflow"], want["value_overflow"], "value_overflow")


@pytest.mark.parametrize("rows", [CAP, CAP - 1371])
def test_plain_matches_pallas_kernel(rows):
    jb = _narrow_batch(np.random.default_rng(7), rows=rows)
    want = pallas_q1.q1_step(jb, interpret=True)
    got = cuda_q1.q1_step_plain(port_batch(jb))
    _assert_state(got, want)
    assert not bool(got["value_overflow"])


@pytest.mark.parametrize("name,row,value", [
    ("l_discount", 11, -56),  # dp = ep*156 could wrap int32 on the TPU
    ("l_extendedprice", 7, 1 << 25),  # beyond the 24-bit declared bound
    ("l_returnflag", 3, 5),  # gid = 10: outside every group
], ids=["discount-range", "declared-bits", "group-domain"])
def test_overflow_guard_fires_like_pallas_kernel(name, row, value):
    jb = _with(_narrow_batch(np.random.default_rng(7)), name, row, value)
    want = pallas_q1.q1_step(jb, interpret=True)
    got = cuda_q1.q1_step_plain(port_batch(jb))
    assert bool(want["value_overflow"]) and bool(got["value_overflow"])


def test_eligibility():
    jb = _narrow_batch(np.random.default_rng(0))
    pb = port_batch(jb)
    assert pallas_q1.supported(jb) and cuda_q1.supported(pb)
    canonical = pb.with_live(pb.live)
    for c in canonical.columns.values():
        c.data = c.data.to(torch.int64)
    assert not cuda_q1.supported(canonical)  # int64 columns
    own_mask = port_batch(jb)
    own_mask["l_tax"].valid = own_mask.live.clone()  # NULLs possible
    assert not cuda_q1.supported(own_mask)
    with pytest.raises(InternalError):
        cuda_q1.q1_step(own_mask)
    # unlike the TPU kernel, any capacity is eligible (no block alignment)
    assert pallas_q1._block_rows(CAP + 3) is None
    assert cuda_q1.supported(port_batch(_narrow_batch(np.random.default_rng(1), CAP + 3)))


def test_q1_step_computes_plain_on_cpu():
    pb = port_batch(_narrow_batch(np.random.default_rng(2)))
    before = cuda_q1.launches
    _assert_state(cuda_q1.q1_step(pb), cuda_q1.q1_step_plain(pb))
    assert cuda_q1.launches == before


@pytest.mark.parametrize("form", ["narrow", "ragged", "canonical"])
def test_fused_step_matches_reference(form):
    jb = _narrow_batch(np.random.default_rng(4), rows=CAP - 999 if form == "ragged" else None)
    if form == "canonical":
        cols = {n: JColumn(c.data.astype(jnp.int64), c.valid, c.dtype.canonical())
                for n, c in jb.columns.items()}
        jb = JBatch(cols, jb.live)
    want = jax.jit(JW.q1_fused_step)(jb)
    got = PW.q1_fused_step(port_batch(jb))
    _assert_state(got, want)


@pytest.fixture(scope="module")
def sf_001():
    return TpchConnector(sf=0.01, device="cpu"), JConnector(sf=0.01)


def test_fused_step_on_connector_batch(sf_001):
    port, ref = sf_001
    _assert_state(PW.q1_fused_step(PW.q1_batch(port)),
                  jax.jit(JW.q1_fused_step)(JW.q1_batch(ref)))


def test_combine_states_matches_reference(sf_001):
    port, ref = sf_001
    pb, jb = PW.q1_batch(port), JW.q1_batch(ref)
    p = PW.q1_fused_step(pb)
    j = JW.q1_fused_step(jb)
    _assert_state(PW.combine_q1_states(p, p), JW.combine_q1_states(j, j))


@pytest.fixture(scope="module")
def pipeline_results(sf_001):
    port, ref = sf_001
    pout = PW.q1_pipeline(port).run()
    jout = JW.q1_pipeline(ref).run()
    assert len(pout) == len(jout) == 1
    return pout[0], jout[0]


@pytest.mark.parametrize("column", ["l_returnflag", "l_linestatus", "sum_qty",
                                    "sum_base_price", "sum_disc_price", "sum_charge",
                                    "count_order"])
def test_pipeline_matches_reference(pipeline_results, column):
    got, want = pipeline_results
    assert got.names == want.names
    assert_same(got[column].data, want[column].data, column)
    assert_same(got[column].valid, want[column].valid, column)
    assert str(got[column].dtype) == str(want[column].dtype)


def test_pipeline_groups_match_reference(pipeline_results):
    got, want = pipeline_results
    assert_same(got.live, want.live, "live")
    for k in ("l_returnflag", "l_linestatus"):
        assert list(got[k].dictionary.values) == list(want[k].dictionary.values)
