"""The port's 64-bit key hashing (``presto_tpu_torch/ops/hashing.py``:
``mix64``, ``hash_columns``, ``partition_ids``, ``bucket_ids``) against
``presto_tpu.ops.hashing``, bit for bit.

Bucket ids decide which host spill unit a row lands in, and so the order
of a grouped join's output: the port holds the unsigned 64-bit values in
int64 (wrapping products, logical shifts, the modulus of the unsigned
value) and must agree with the JAX package's uint64 arithmetic on every
integer width, negatives and the int64 extremes included, at partition
counts 1, 3, 7, 64 and 2^31 - 1.
"""

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from presto_tpu.ops import hashing as J  # noqa: E402
from presto_tpu_torch.ops import hashing as P  # noqa: E402
from torch_bridge import assert_same  # noqa: E402

DTYPES = (np.int8, np.int16, np.int32, np.int64)
MODULI = (1, 3, 7, 64, (1 << 31) - 1)
N = 64  # one array length: the JAX side compiles each op once


def column(rng, dtype) -> np.ndarray:
    """N values of ``dtype`` over its whole range, both extremes, 0 and -1."""
    info = np.iinfo(dtype)
    a = rng.integers(info.min, info.max, N, dtype=dtype, endpoint=True)
    a[:4] = [info.min, info.max, 0, -1]
    return a


def j_ids(fn, cols, n):
    return np.asarray(getattr(J, fn)([jnp.asarray(c) for c in cols], n))


def p_ids(fn, cols, n):
    return getattr(P, fn)([torch.from_numpy(c) for c in cols], n)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_mix64_and_hash_columns_bit_equal(dtype):
    rng = np.random.default_rng(7)
    a, b = column(rng, dtype), column(rng, np.int64)
    assert_same(P.mix64(torch.from_numpy(a)), np.asarray(J.mix64(jnp.asarray(a))).view(np.int64),
                "mix64")
    for cols in ([a], [a, b], [b, a]):
        want = np.asarray(J.hash_columns([jnp.asarray(c) for c in cols])).view(np.int64)
        assert_same(P.hash_columns([torch.from_numpy(c) for c in cols]), want, "hash_columns")


@pytest.mark.parametrize("n", MODULI)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("fn", ["partition_ids", "bucket_ids"])
def test_ids_bit_equal(fn, dtype, n):
    rng = np.random.default_rng(11)
    a, b = column(rng, dtype), column(rng, np.int32)
    for cols in ([a], [a, b]):
        got = p_ids(fn, cols, n)
        assert_same(got, j_ids(fn, cols, n), f"{fn} {np.dtype(dtype).name} mod {n}")
        assert int(got.min()) >= 0 and int(got.max()) < n


@settings(max_examples=40, deadline=None)
@given(dtype=st.sampled_from(DTYPES), n=st.sampled_from(MODULI), seed=st.integers(0, 2**32 - 1),
       ncols=st.integers(1, 3))
def test_ids_bit_equal_hypothesis(dtype, n, seed, ncols):
    rng = np.random.default_rng(seed)
    cols = [column(rng, dtype if i == 0 else DTYPES[(seed + i) % 4]) for i in range(ncols)]
    for fn in ("partition_ids", "bucket_ids"):
        assert_same(p_ids(fn, cols, n), j_ids(fn, cols, n), f"{fn} mod {n}")


def test_bool_column_zero_extends():
    """A bool key widens to 0 / 1, as ``astype(uint64)`` does."""
    a = np.tile(np.array([True, False]), N // 2)
    assert_same(p_ids("bucket_ids", [a], 7), j_ids("bucket_ids", [a], 7), "bool key")


def test_modulus_out_of_range_refused():
    with pytest.raises(ValueError, match="modulus"):
        P.partition_ids([torch.zeros(4, dtype=torch.int64)], 0)
    with pytest.raises(ValueError, match="modulus"):
        P.bucket_ids([torch.zeros(4, dtype=torch.int64)], 1 << 31)
