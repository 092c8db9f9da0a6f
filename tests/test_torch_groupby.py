"""The port's grouping against the JAX package's.

``fused_lane_sums_plain`` (the lane-sums kernel's plain version, which
``fused_lane_sums`` computes on CPU tensors) against the Pallas
``fused_lane_sums`` in interpret mode at capacity 2^16, and the port's
``fused_small_sums`` against the JAX one on both of its routes. Covers
negative values, a bound violation, a shared mask object and a dead
tail. Exact: int64 values and dtypes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import presto_tpu.ops.groupby as JG
import presto_tpu.ops.pallas_groupby as JPG
import presto_tpu_torch.ops.groupby as PG
from presto_tpu_torch.ops import cuda_groupby
from presto_tpu_torch.runtime.errors import ResourceExhausted
from torch_bridge import assert_same

CAP = 1 << 16
G = 6


def _data(case: str, seed: int = 3):
    """Group ids, two values and two contribution masks. ``cap N`` cases
    have N rows (the CUDA kernel's tile edges: tiles of 2048 rows, 16 rows
    a thread); the others CAP."""
    cap = int(case.split()[1]) if case.startswith("cap ") else CAP
    rng = np.random.default_rng(seed)
    g = rng.integers(0, G + 1, cap).astype(np.int32)  # 6 groups + trash
    lo = -(2**30) if case != "non-negative" else 0
    v1 = rng.integers(lo, 2**30, cap).astype(np.int64)
    v2 = rng.integers(-5000, 5000, cap).astype(np.int64)
    live = rng.random(cap) < 0.9
    if case == "dead tail":
        live[cap - 1371:] = False
        g[cap - 1371:] = G
    if case == "all dead":
        live[:] = False
        g[:] = G
    c2 = (rng.random(cap) < 0.8) & live
    if case == "bound violation":
        v2[17] = 1 << 20  # beyond the declared 13 bits
        c2[17] = True
        live[17] = True
    return g, [v1, v2], [live, c2]


CASES = ["negative values", "non-negative", "dead tail", "bound violation"]
#: the CUDA kernel's tile edges and a batch with every row dead
EDGE_CASES = ["cap 1", "cap 15", "cap 17", "cap 2047", "cap 2049", "all dead"]


@pytest.mark.parametrize("case", CASES + ["all dead", "no values"])
def test_lane_sums_plain_matches_pallas_kernel(case):
    """``no values``: counts only (the shape of Q4's and q_like_phone's
    aggregations), no value column."""
    g, values, contribs = _data(case)
    zeroed = [np.where(c, v, 0).astype(np.int32) for v, c in zip(values, contribs)]
    bits = [31, 13]
    if case == "no values":
        zeroed, bits = [], []
    want = JPG.fused_lane_sums([jnp.asarray(z) for z in zeroed], bits,
                               [jnp.asarray(c) for c in contribs], jnp.asarray(g), G)
    got = cuda_groupby.fused_lane_sums_plain(
        [torch.from_numpy(z) for z in zeroed], bits,
        [torch.from_numpy(c) for c in contribs], torch.from_numpy(g), G)
    assert bool(got[2]) == bool(want[2]) == (case == "bound violation")
    if case != "bound violation":  # the Pallas lanes truncate past the bound
        for a, b in zip(got[0], want[0]):
            assert_same(a, b)
    for a, b in zip(got[1], want[1]):
        assert_same(a, b)


def test_lane_sums_wrapper_computes_plain_on_cpu():
    g, values, contribs = _data("negative values")
    zeroed = [torch.from_numpy(np.where(c, v, 0).astype(np.int32))
              for v, c in zip(values, contribs)]
    masks = [torch.from_numpy(c) for c in contribs]
    before = cuda_groupby.launches
    got = cuda_groupby.fused_lane_sums(zeroed, [31, 13], masks, torch.from_numpy(g), G)
    want = cuda_groupby.fused_lane_sums_plain(zeroed, [31, 13], masks, torch.from_numpy(g), G)
    assert cuda_groupby.launches == before  # no kernel on the CPU
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)


def test_lane_sums_limits():
    g = torch.zeros(8, dtype=torch.int32)
    v = [torch.zeros(8, dtype=torch.int32)]
    with pytest.raises(ResourceExhausted):
        cuda_groupby.fused_lane_sums(v * 2, [3, 3], [torch.ones(8, dtype=torch.bool)] * 3,
                                     g, cuda_groupby.SLOT_LIMIT // 4)
    assert cuda_groupby.supported(4, 5, 6)
    assert cuda_groupby.supported(16, 16, 32)  # the slot limit is >= 1024
    assert not cuda_groupby.supported(17, 1, 6)


def test_lane_sums_instance_choice():
    """The wrapper's choice among the kernel's instances, on CPU tensors:
    staged when every column starts 16-byte aligned and a ring of 2
    stages fits beside the table (compiled for the main path's shapes,
    per-thread tables up to PRIVATE_SLOTS slots, shared copies past
    them), else direct."""
    rng = np.random.default_rng(4)

    def args(k, m, groups, cap=4096):
        vals = [torch.from_numpy(rng.integers(-9, 9, cap).astype(np.int32)) for _ in range(k)]
        masks = [torch.from_numpy(rng.random(cap) < 0.5) for _ in range(m)]
        gids = torch.from_numpy(rng.integers(0, groups + 1, cap).astype(np.int32))
        return vals, masks, gids, groups

    want = {(4, 5, 6): "staged_k4m5", (0, 1, 5): "staged_k0m1", (0, 2, 5): "staged",
            (2, 3, 12): "staged", (1, 0, 1): "staged", (4, 5, 64): "staged_shared",
            (16, 16, 32): "direct", (16, 16, 1): "direct"}
    for (k, m, groups), inst in want.items():
        vals, masks, gids, _ = args(k, m, groups)
        assert cuda_groupby.instance(vals, masks, gids, groups) == inst, (k, m, groups)
        assert (cuda_groupby.ring_stages(k, m, groups) >= 2) == (inst != "direct")
    assert set(want.values()) == set(cuda_groupby.INSTANCES)
    assert cuda_groupby.ring_stages(4, 5, 6) == 3  # the Q1 pipeline's ring
    # a column that starts one element into its buffer takes the direct one
    vals, masks, gids, _ = args(4, 5, 6)
    buf = torch.zeros(4097, dtype=torch.int32)
    buf[1:] = vals[2]
    view = [vals[0], vals[1], buf[1:], vals[3]]
    assert view[2].data_ptr() % 16 != 0
    assert cuda_groupby.instance(view, masks, gids, 6) == "direct"
    got = cuda_groupby.fused_lane_sums(view, [31] * 4, masks, gids, 6)
    want_sums = cuda_groupby.fused_lane_sums_plain(vals, [31] * 4, masks, gids, 6)
    for a, b in zip(got[0] + got[1], want_sums[0] + want_sums[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("route", ["einsum", "pallas"])
@pytest.mark.parametrize("case", CASES + ["shared mask"] + EDGE_CASES)
def test_fused_small_sums_matches_reference(route, case, monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_PALLAS", "1" if route == "pallas" else "0")
    g, values, contribs = _data(case)
    if case == "shared mask":
        contribs = [contribs[0], contribs[0]]  # one object, counted once
    extra_j = (contribs[0],)
    want = JG.fused_small_sums([jnp.asarray(v) for v in values], [31, 13],
                               [jnp.asarray(c) for c in contribs], jnp.asarray(g), G,
                               extra_count_masks=())
    # identity matters for the dedup: rebuild the same sharing in torch
    tmap = {}
    pc = [tmap.setdefault(id(c), torch.from_numpy(c)) for c in contribs]
    got = PG.fused_small_sums([torch.from_numpy(v) for v in values], [31, 13], pc,
                              torch.from_numpy(g), G,
                              extra_count_masks=tuple(tmap[id(c)] for c in extra_j))
    assert bool(got[3]) == bool(want[3]) == (case == "bound violation")
    if case != "bound violation":
        for a, b in zip(got[0], want[0]):
            assert_same(a, b)
    for a, b in zip(got[1], want[1]):
        assert_same(a, b)
    assert_same(got[2][0], got[1][0])  # the extra mask is contribs[0]


def test_wide_value_overflow_trips_before_cast():
    # an int64 value beyond 31 bits would WRAP in the int32 cast; the
    # declared-bound guard must trip on the original dtype
    g = torch.zeros(CAP, dtype=torch.int32)
    v = torch.full((CAP,), (1 << 32) + 100, dtype=torch.int64)
    live = torch.ones(CAP, dtype=torch.bool)
    *_, oflow = PG.fused_small_sums([v], [31], [live], g, G)
    *_, joflow = JG.fused_small_sums([jnp.asarray(v.numpy())], [31],
                                     [jnp.asarray(live.numpy())], jnp.asarray(g.numpy()), G)
    assert bool(oflow) and bool(joflow)


def test_generic_route_for_wide_bounds():
    g, values, contribs = _data("negative values")
    assert not PG.kernel_route([torch.from_numpy(values[0])], [40], 1, G)
    want = JG.fused_small_sums([jnp.asarray(values[0])], [40], [jnp.asarray(contribs[0])],
                               jnp.asarray(g), G)
    got = PG.fused_small_sums([torch.from_numpy(values[0])], [40],
                              [torch.from_numpy(contribs[0])], torch.from_numpy(g), G)
    assert_same(got[0][0], want[0][0])
    assert_same(got[1][0], want[1][0])
    assert bool(got[3]) == bool(want[3]) is False


def test_group_ids_direct_matches_reference_with_clip():
    rng = np.random.default_rng(5)
    rf = rng.integers(-1, 4, CAP).astype(np.int8)  # out-of-domain codes clip
    ls = rng.integers(0, 2, CAP).astype(np.int8)
    live = rng.random(CAP) < 0.7
    want = JG.group_ids_direct([jnp.asarray(rf), jnp.asarray(ls)], (0, 0), (2, 1),
                               jnp.asarray(live), G)
    got = PG.group_ids_direct([torch.from_numpy(rf), torch.from_numpy(ls)], (0, 0), (2, 1),
                              torch.from_numpy(live), G)
    assert_same(got[0], want[0])
    assert_same(got[1], want[1])


@pytest.mark.parametrize("kind", ["sum", "count", "min", "max"])
def test_segment_agg_matches_reference(kind):
    rng = np.random.default_rng(9)
    vals = rng.integers(-(2**40), 2**40, CAP).astype(np.int64)
    g = rng.integers(0, G, CAP).astype(np.int32)
    contrib = rng.random(CAP) < 0.5
    contrib[g == 5] = False  # a group without contributing rows: identity
    want = JG.segment_agg(jnp.asarray(vals), jnp.asarray(contrib), jnp.asarray(g), G, kind)
    got = PG.segment_agg(torch.from_numpy(vals), torch.from_numpy(contrib),
                         torch.from_numpy(g), G, kind)
    assert_same(got, want)


@pytest.mark.parametrize("max_groups", [64, 4096])
def test_group_ids_sort_matches_reference(max_groups):
    """Sort-based gids over two keys (one a validity flag, as the sort
    aggregation feeds them), dead rows, and a capacity that overflows."""
    rng = np.random.default_rng(13)
    k1 = rng.integers(0, 2, CAP).astype(np.int8)
    k2 = rng.integers(-300, 300, CAP).astype(np.int64)
    live = rng.random(CAP) < 0.8
    want = JG.group_ids_sort([jnp.asarray(k1), jnp.asarray(k2)], jnp.asarray(live), max_groups)
    got = PG.group_ids_sort([torch.from_numpy(k1), torch.from_numpy(k2)],
                            torch.from_numpy(live), max_groups)
    assert_same(got[0], want[0], "gids")
    assert_same(got[1], want[1], "rep_idx")
    assert int(got[2]) == int(want[2]) and bool(got[3]) == bool(want[3]) == (max_groups == 64)


@pytest.mark.parametrize("nulls_first", [False, True])
def test_sort_indices_matches_reference(nulls_first):
    """Stable multi-key order with DESC, NULL placement and dead rows:
    ties keep their input order (TopN's tie rule)."""
    from presto_tpu.ops import sort as JS
    from presto_tpu_torch.ops import sort as PS

    rng = np.random.default_rng(14)
    a = rng.integers(-5, 5, CAP).astype(np.int64)
    b = rng.integers(0, 3, CAP).astype(np.int32)
    va = rng.random(CAP) < 0.9
    live = rng.random(CAP) < 0.85
    want = JS.sort_indices([jnp.asarray(a), jnp.asarray(b)], [True, False], jnp.asarray(live),
                           nulls_first=[nulls_first, False], valids=[jnp.asarray(va), None])
    got = PS.sort_indices([torch.from_numpy(a), torch.from_numpy(b)], [True, False],
                          torch.from_numpy(live), nulls_first=[nulls_first, False],
                          valids=[torch.from_numpy(va), None])
    assert_same(got, want)
