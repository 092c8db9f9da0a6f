"""The port's leaf-aggregation step (``ops/cuda_agg``) against the JAX
package's ``ops/pallas_agg``.

- ``agg_step_plain`` (what ``agg_step`` computes on a CPU batch, and what
  ``chip_smoke.py`` holds the CUDA kernel to on the card) against the
  Pallas ``_pallas_step`` in interpret mode at capacity 2^16, on the
  specs the Pallas kernel takes (sum-only, bits <= 31, at most 8 groups
  here);
- against the XLA twin ``_xla_step`` on every case of
  ``chip_smoke.leaf_cases`` (up to 512 groups, min/max, bits above 31,
  one-sided and unsatisfiable filters, negative coefficients, an int64
  column, guard and bit-bound violations) at capacities 4096 and 3001;
- ``combine_states``, ``null_violation`` and the kernel's limits.
Exact: int64 values, dtypes and the ``value_overflow`` flag.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import presto_tpu.ops.pallas_agg as JA
from presto_tpu.batch import Batch as JBatch
from presto_tpu.batch import Column as JColumn
from presto_tpu.types import BIGINT as JBIGINT
from presto_tpu_torch.ops import cuda_agg
from presto_tpu_torch.runtime.errors import InternalError
from torch_bridge import assert_same

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


def jax_spec(spec):
    """The JAX package's LeafAggSpec with the same fields."""
    def term(t):
        return None if t is None else JA.Term(t.col, t.c0, t.c1)

    return JA.LeafAggSpec(
        cols=spec.cols, filters=spec.filters, keys=spec.keys, groups=spec.groups,
        values=tuple(JA.ValueAgg(v.op, term(v.a), term(v.b), v.bits) for v in spec.values),
        guards=spec.guards)


def jax_batch(spec, cols, live):
    """A JAX batch of the case: NULL-free columns sharing ``live``."""
    lv = jnp.asarray(live)
    return JBatch({n: JColumn(jnp.asarray(c), lv, JBIGINT) for n, c in zip(spec.cols, cols)}, lv)


def cases(cap, live_rows=None, seed=11):
    return chip_smoke.leaf_cases(np.random.default_rng(seed), cap, live_rows)


def case_ids(cap):
    return [name for name, *_ in cases(cap)]


def assert_states_equal(got: dict, want: dict, flag_only: bool = False):
    assert set(got) == set(want)
    assert_same(got["value_overflow"], want["value_overflow"], "value_overflow")
    if flag_only:
        return
    for k in want:
        assert_same(got[k], want[k], k)


#: sum-only cases within the Pallas kernel's reach (bits <= 31, columns
#: of at most 32 bits, at most 8 groups in interpret mode)
PALLAS_CASES = ["keyless Q6 shape", "keyless SSB Q1.1 shape", "6 groups, sums",
                "unsatisfiable filter", "guard value column", "guard key column",
                "bits violation"]


@pytest.mark.parametrize("name", PALLAS_CASES)
def test_plain_equals_pallas_kernel_in_interpret_mode(name):
    cap = 1 << 16
    (spec, cols, live), = [(s, c, lv) for n, s, c, lv in cases(cap, cap - 1371) if n == name]
    want = JA._pallas_step(jax_spec(spec), jax_batch(spec, cols, live), interpret=True)
    got = cuda_agg.agg_step_plain(spec, chip_smoke.leaf_batch(spec, cols, live, "cpu"))
    assert_states_equal(got, want)
    assert bool(got["value_overflow"]) == name.startswith(("guard", "bits"))


@pytest.mark.parametrize("cap,live_rows", [(4096, None), (3001, 2900)])
@pytest.mark.parametrize("name", case_ids(64))
def test_plain_equals_xla_twin(name, cap, live_rows):
    """Every case, exact. Where a declared bit bound is violated the XLA
    twin sums truncated 7-bit lanes and the port exact int64 (ROADMAP
    C1): there only the flag is compared."""
    (spec, cols, live), = [(s, c, lv) for n, s, c, lv in cases(cap, live_rows) if n == name]
    want = JA._xla_step(jax_spec(spec), jax_batch(spec, cols, live))
    b = chip_smoke.leaf_batch(spec, cols, live, "cpu")
    got = cuda_agg.agg_step_plain(spec, b)
    assert_states_equal(got, want, flag_only=name == "bits violation")
    # on a CPU batch agg_step is its plain version, and launches nothing
    launches = cuda_agg.launches
    assert_states_equal(cuda_agg.agg_step(spec, b), got)
    assert cuda_agg.launches == launches
    assert bool(got["value_overflow"]) == name.startswith(("guard", "bits"))


def test_kernel_takes_specs_the_reference_sends_to_its_twin():
    """ROADMAP C8 (deliberate divergence): the CUDA kernel takes min/max
    values, bits above 31 and any capacity — all three send a spec to the
    JAX package's XLA twin instead of its Pallas kernel. Results are
    equal (the twin and the port's plain version agree exactly)."""
    rng = np.random.default_rng(5)
    for name, spec, cols, live in chip_smoke.leaf_cases(rng, 3001):
        if name not in ("512 groups, sum/min/max", "wide coefficients, bits > 31",
                        "keyless Q6 shape"):
            continue
        jb = jax_batch(spec, cols, live)
        assert not JA.kernel_supported(jax_spec(spec), jb)
        assert cuda_agg.supported(spec)
        want = JA._xla_step(jax_spec(spec), jb)
        got = cuda_agg.agg_step_plain(spec, chip_smoke.leaf_batch(spec, cols, live, "cpu"))
        assert_states_equal(got, want)


def test_state_keys_and_limits():
    spec = cases(64)[3][1]  # 512 groups, sum/min/max
    assert cuda_agg.state_keys(spec) == JA.state_keys(jax_spec(spec))
    assert cuda_agg.MAX_GROUPS == JA.MAX_GROUPS == spec.groups
    assert cuda_agg.supported(spec)
    wide = cuda_agg.LeafAggSpec(tuple(f"c{i}" for i in range(33)), (), (), 1, (), ())
    assert not cuda_agg.supported(wide)


def test_combine_states_equals_reference():
    name, spec, cols, live = cases(4096)[3]  # 512 groups, sum/min/max
    half = len(live) // 2
    parts = []
    for sl in (slice(0, half), slice(half, None)):
        parts.append((cuda_agg.agg_step_plain(
            spec, chip_smoke.leaf_batch(spec, [c[sl] for c in cols], live[sl], "cpu")),
            JA._xla_step(jax_spec(spec), jax_batch(spec, [c[sl] for c in cols], live[sl]))))
    got = cuda_agg.combine_states(spec, parts[0][0], parts[1][0])
    want = JA.combine_states(jax_spec(spec), parts[0][1], parts[1][1])
    assert_states_equal(got, want)
    # and split-combined equals one pass over the whole batch
    whole = cuda_agg.agg_step_plain(spec, chip_smoke.leaf_batch(spec, cols, live, "cpu"))
    assert_states_equal(got, whole)


@pytest.mark.parametrize("nulls", [False, True])
def test_null_violation_equals_reference(nulls):
    rng = np.random.default_rng(2)
    cap = 2048
    live = rng.random(cap) < 0.9
    valid = np.ones(cap, np.bool_)
    if nulls:
        valid[np.flatnonzero(live)[7]] = False
    else:
        valid[~live] = False  # NULLs only in dead rows
    data = rng.integers(0, 100, cap).astype(np.int32)
    jb = JBatch({"a": JColumn(jnp.asarray(data), jnp.asarray(live), JBIGINT),
                 "b": JColumn(jnp.asarray(data), jnp.asarray(valid), JBIGINT)}, jnp.asarray(live))
    lt = torch.from_numpy(live)
    from presto_tpu_torch.batch import Batch, Column
    from presto_tpu_torch.types import BIGINT

    pb = Batch({"a": Column(torch.from_numpy(data), lt, BIGINT),
                "b": Column(torch.from_numpy(data), torch.from_numpy(valid), BIGINT)}, lt)
    assert_same(cuda_agg.null_violation(pb), JA.null_violation(jb))
    assert bool(cuda_agg.null_violation(pb)) == nulls


def test_wrapper_refuses_a_device_without_a_kernel():
    name, spec, cols, live = cases(64)[0]
    b = chip_smoke.leaf_batch(spec, cols, live, "meta")
    with pytest.raises(InternalError, match="no kernel"):
        cuda_agg.agg_step(spec, b)
