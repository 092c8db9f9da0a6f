"""The exchange's row packing (``presto_tpu_torch/ops/partition.py``:
``partition_layout``, ``destination_counts``, ``scatter_to_buffer``) and
row compaction (``ops/compact.py``: ``compact_indices``,
``compact_mask_overflow``) against the JAX package's ``jnp`` versions,
value for value and dtype for dtype: a row's slot decides which shard
receives it and where, and so the row order of every distributed result.

Cases cover several capacities, partition counts and quotas, with and
without quota overflow, all-dead and all-live rows, and BYTES rows.
"""

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from presto_tpu.ops import compact as JC  # noqa: E402
from presto_tpu.ops import partition as JP  # noqa: E402
from presto_tpu_torch.ops import compact as PC  # noqa: E402
from presto_tpu_torch.ops import partition as PP  # noqa: E402
from torch_bridge import assert_same  # noqa: E402

#: (capacity, partitions, quota, live fraction): quota at and below the
#: balanced share, so some cases overflow and some do not
LAYOUTS = [
    (16, 2, 16, 1.0),
    (64, 4, 8, 0.7),
    (64, 4, 64, 0.7),
    (129, 3, 16, 0.5),
    (1000, 8, 64, 0.9),
    (1000, 8, 256, 0.9),
    (4096, 5, 512, 0.3),
    (32, 4, 4, 0.0),
]


def _inputs(cap, parts, frac, seed):
    rng = np.random.default_rng(seed)
    pids = rng.integers(0, parts, cap, dtype=np.int32)
    live = rng.random(cap) < frac
    return pids, live


@pytest.mark.parametrize("cap,parts,quota,frac", LAYOUTS)
def test_partition_layout_equals_reference(cap, parts, quota, frac):
    pids, live = _inputs(cap, parts, frac, cap + parts + quota)
    want = JP.partition_layout(jnp.asarray(pids), jnp.asarray(live), parts, quota)
    got = PP.partition_layout(torch.from_numpy(pids), torch.from_numpy(live), parts, quota)
    for g, w, what in zip(got, want, ("slot", "counts", "overflow")):
        assert_same(g, w, what)


@pytest.mark.parametrize("cap,parts,quota,frac", LAYOUTS)
def test_destination_counts_and_scatter_equal_reference(cap, parts, quota, frac):
    pids, live = _inputs(cap, parts, frac, 7 * cap + parts)
    rng = np.random.default_rng(cap)
    vals = rng.integers(-(1 << 40), 1 << 40, cap)
    rows = rng.integers(0, 255, (cap, 5), dtype=np.uint8)
    assert_same(PP.destination_counts(torch.from_numpy(pids), torch.from_numpy(live), parts),
                JP.destination_counts(jnp.asarray(pids), jnp.asarray(live), parts), "counts")
    jslot, _, _ = JP.partition_layout(jnp.asarray(pids), jnp.asarray(live), parts, quota)
    pslot, _, _ = PP.partition_layout(torch.from_numpy(pids), torch.from_numpy(live), parts, quota)
    for values, fill in ((vals, 0), (vals, -7), (live, False), (rows, 0)):
        assert_same(PP.scatter_to_buffer(torch.from_numpy(values), pslot, parts, quota, fill),
                    JP.scatter_to_buffer(jnp.asarray(values), jslot, parts, quota, fill),
                    f"scatter {values.dtype}")


@pytest.mark.parametrize("cap,out_cap,frac", [(16, 16, 1.0), (64, 16, 0.1), (64, 16, 0.9),
                                              (1000, 128, 0.2), (1000, 64, 0.0),
                                              (257, 512, 0.6)])
def test_compact_indices_equal_reference(cap, out_cap, frac):
    mask = np.random.default_rng(cap + out_cap).random(cap) < frac
    jidx, jn, jovf = JC.compact_indices(jnp.asarray(mask), out_cap)
    pidx, pn, povf = PC.compact_indices(torch.from_numpy(mask), out_cap)
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    assert int(pn) == int(jn) and bool(povf) == bool(jovf)
    assert bool(PC.compact_mask_overflow(torch.from_numpy(mask), out_cap)) == \
        bool(JC.compact_mask_overflow(jnp.asarray(mask), out_cap))
