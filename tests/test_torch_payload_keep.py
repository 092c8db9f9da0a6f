"""The fused payload probe of inner and left joins against the JAX
package, exactly.

- ``ops/cuda_join``: ``payload_keep_plain`` (which the CUDA kernel is held
  to on the card) equals the operator's old composition written out here
  (probe live = live && valid, the probe, each value ``.to`` its build
  column's storage type, the inner join's ``live & matched``) and the
  same composition around the JAX package's ``payload_probe`` run in
  interpret mode: int8/int16/int32 keys, 1-4 and 16 value columns,
  output types int8/int16/int32/int64 (int32 table values over their
  whole range, so the narrowing truncates), NULL keys planted and no
  validity at all, dead rows, keys outside the domain, inner and left;
  ``payload_probe`` equals ``payload_keep`` with int32 outputs and no
  validity; the wrappers compute the plain version on CPU tensors and
  count no launch.
- the wrapper's instance choice on CPU tensors: aligned tensors take a
  vector instance, a view one element into its buffer a scalar one; a
  table of at most ``STAGED_SLOTS`` slots a staged one.
- ``exec/joins``: ``LookupJoinOperator`` on the payload route makes one
  ``payload_keep`` call per probe batch and keeps the JAX operator's
  rows, validity, types and live mask, the key's validity being the
  batch's live mask, a mask of its own or absent.
Tolerance: exact everywhere (boolean and integer data).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.batch import Batch as JBatch
from presto_tpu.batch import Column as JColumn
from presto_tpu.exec import joins as JJ
from presto_tpu.exec.pipeline import BatchSource as JBatchSource
from presto_tpu.exec.pipeline import Pipeline as JPipeline
from presto_tpu.expr import col as jcol
from presto_tpu.ops import pallas_join
from presto_tpu.types import INTEGER as JINTEGER
from presto_tpu.types import narrow_physical as jnarrow
from presto_tpu_torch.batch import Batch as PBatch
from presto_tpu_torch.batch import Column as PColumn
from presto_tpu_torch.exec import joins as PJ
from presto_tpu_torch.expr import col as pcol
from presto_tpu_torch.ops import cuda_join
from presto_tpu_torch.runtime.errors import InternalError
from torch_bridge import assert_same, port_batch, port_type, to_numpy

CAP = 2048  # a multiple of the Pallas probe block
# (key dtype, key_min, key_max) of the payload tables
DOMAINS = {"int8": (-60, 90), "int16": (-500, 400), "int32": ((1 << 31) - 400, (1 << 31) - 1)}
OUT_TYPES = ("int8", "int16", "int32", "int64")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(dtype: str, nval: int, seed: int, cap: int = CAP):
    """(port tables, the JAX package's tables of the same build, keys,
    live, validity with NULLs planted) from seeded numpy: unique build
    keys over part of the domain with int32 values over their whole
    range; probe keys across and past the domain, the edge keys live and
    some of them NULL."""
    rng = np.random.default_rng(seed)
    kmin, kmax = DOMAINS[dtype]
    info = np.iinfo(dtype)
    bk = (rng.permutation(kmax - kmin + 1)[:40] + kmin).astype(dtype)
    blive = np.ones(bk.shape[0], bool)
    vals = [rng.integers(-(1 << 31), 1 << 31, bk.shape[0]).astype(np.int32)
            for _ in range(nval)]
    tables, oob = cuda_join.build_payload_tables(_t(bk), _t(blive), kmin, kmax,
                                                 [_t(v) for v in vals])
    jtables, _ = pallas_join.build_payload_tables(jnp.asarray(bk), jnp.asarray(blive), kmin,
                                                  kmax, [jnp.asarray(v) for v in vals])
    assert not bool(oob)
    keys = rng.integers(max(info.min, kmin - 300), min(info.max, kmax + 300), cap,
                        endpoint=True)
    keys[6: cap // 3] = rng.choice(bk, cap // 3 - 6)  # a third hit the build
    edges = [e for e in (kmin, kmax, kmin - 1, kmax + 1, info.min, info.max)
             if info.min <= e <= info.max]
    keys[: len(edges)] = edges
    live = rng.random(cap) < 0.85
    live[:6] = True
    valid = rng.random(cap) < 0.9
    valid[1:6:2] = False  # NULL keys among the live edge keys
    return tables, jtables, keys.astype(dtype), live, valid


def _composed(probe, live, valid, out_types, inner: bool):
    """The operator's composition before the fused probe: probe on live &
    valid (all valid without a validity), each value cast to its
    column's type, the inner join's new live mask."""
    plive = live & (np.ones_like(live) if valid is None else valid)
    matched, values = probe(plive)
    matched = to_numpy(matched)
    values = [to_numpy(v).astype(t) for v, t in zip(values, out_types)]
    return matched, values, (live & matched if inner else live)


def _assert_keep(got, want, what: str):
    (gm, gv, gl), (wm, wv, wl) = got, want
    assert_same(gm, wm, f"{what}: matched")
    assert len(gv) == len(wv)
    for j, (g, w) in enumerate(zip(gv, wv)):
        assert_same(g, w, f"{what}: value {j}")
    assert_same(gl, wl, f"{what}: live")


CASES = [(dt, nval, nulls) for dt in ("int8", "int16", "int32")
         for nval in (1, 2, 3, 4, 16) for nulls in (True, False)]


@pytest.mark.parametrize("dtype,nval,nulls", CASES)
def test_keep_plain_equals_the_composition_and_the_pallas_probe(dtype, nval, nulls):
    seed = 5 + 3 * nval + len(dtype) + 11 * nulls
    tables, jtables, keys, live, valid = _inputs(dtype, nval, seed)
    kmin, kmax = DOMAINS[dtype]
    v = valid if nulls else None
    # every output type over the columns, starting at a different one per case
    out_types = [OUT_TYPES[(seed + j) % 4] for j in range(nval)]
    dtypes = [getattr(torch, t) for t in out_types]

    def port(plive):
        return cuda_join.payload_probe_plain(tables, kmin, kmax, _t(keys), _t(plive))

    def ref(plive):
        return pallas_join.payload_probe(jtables, kmin, kmax, jnp.asarray(keys),
                                         jnp.asarray(plive), interpret=True)

    jref = ref(live & (np.ones_like(live) if v is None else v))  # one interpret-mode run
    for inner in (True, False):
        what = f"{dtype} nval {nval} nulls={nulls} {'inner' if inner else 'left'}"
        got = cuda_join.payload_keep_plain(tables, kmin, kmax, _t(keys), _t(live),
                                           None if v is None else _t(v), dtypes, inner)
        _assert_keep(got, _composed(port, live, v, out_types, inner), f"{what}: composition")
        _assert_keep(got, _composed(lambda _: jref, live, v, out_types, inner),
                     f"{what}: the Pallas probe")
        m = to_numpy(got[0])
        assert not m[~live].any(), f"{what}: a dead row matched"
        if v is not None:
            assert not m[~v].any(), f"{what}: a NULL key matched"
        assert 0 < m.sum() < live.sum(), f"{what}: the keys must both hit and miss"
        if not inner:
            assert got[2] is not None and to_numpy(got[2]).tolist() == live.tolist()


@pytest.mark.parametrize("dtype", ["int8", "int16", "int32"])
def test_wrappers_compute_the_plain_version_on_the_cpu(dtype):
    tables, _, keys, live, valid = _inputs(dtype, 3, 21)
    kmin, kmax = DOMAINS[dtype]
    k, lv, vd = _t(keys), _t(live), _t(valid)
    before = (cuda_join.payload_launches,
              {n: dict(c) for n, c in cuda_join.launches_by_instance.items()},
              {n: dict(c) for n, c in cuda_join.launches_by_shape.items()})
    dtypes = [torch.int8, torch.int64, torch.int16]
    for v in (None, vd):
        for inner in (False, True):
            got = cuda_join.payload_keep(tables, kmin, kmax, k, lv, v, dtypes, inner)
            _assert_keep(got, cuda_join.payload_keep_plain(tables, kmin, kmax, k, lv, v,
                                                           dtypes, inner), f"inner={inner}")
            if not inner:
                assert got[2] is lv  # a left join keeps the live mask it was given
    # the JAX-contract entry is the keep entry with int32 values and no validity
    pm, pv = cuda_join.payload_probe(tables, kmin, kmax, k, lv)
    km, kv, _ = cuda_join.payload_keep(tables, kmin, kmax, k, lv, None, [torch.int32] * 3,
                                       False)
    _assert_keep((pm, pv, lv), (km, kv, lv), "payload_probe")
    wm, wv = cuda_join.payload_probe_plain(tables, kmin, kmax, k, lv)
    _assert_keep((pm, pv, lv), (wm, wv, lv), "payload_probe_plain")
    assert (cuda_join.payload_launches, cuda_join.launches_by_instance,
            cuda_join.launches_by_shape) == before


def test_keep_refuses_bad_outputs_and_validity():
    tables, _, keys, live, valid = _inputs("int16", 2, 5)
    kmin, kmax = DOMAINS["int16"]
    k, lv = _t(keys), _t(live)
    for bad in ([torch.int32], [torch.int32, torch.float32], [torch.uint8, torch.int8]):
        with pytest.raises(InternalError, match="output types"):
            cuda_join.payload_keep(tables, kmin, kmax, k, lv, None, bad, True)
    for bad in (_t(valid.astype(np.int8)), _t(valid[:-1])):
        with pytest.raises(InternalError, match="validity"):
            cuda_join.payload_keep(tables, kmin, kmax, k, lv, bad, [torch.int32] * 2, True)


@pytest.mark.parametrize("dtype", ["int8", "int16", "int32"])
def test_instance_choice(dtype):
    """Aligned keys, live and validity take a vector instance at any
    capacity, a view one element into its buffer a scalar one; the
    present and value tables take the staged instances while they hold
    at most STAGED_SLOTS slots of the domain. The plain version does not
    care."""
    tables, _, keys, live, valid = _inputs(dtype, 1, 9)
    kmin, kmax = DOMAINS[dtype]
    k, lv, vd = _t(keys), _t(live), _t(valid)
    r = cuda_join.PAYLOAD_GROUP_ROWS
    assert set(cuda_join.PAYLOAD_INSTANCES) == {"vector_staged", "vector", "scalar_staged",
                                                "scalar"}
    assert 2 * (kmax - kmin + 1) <= cuda_join.STAGED_SLOTS
    for cap in (1, 3, 15, 17, r + 1, CAP):
        assert cuda_join.payload_instance(tables, kmin, kmax, k[:cap], lv[:cap]) == \
            "vector_staged", cap
        assert cuda_join.payload_instance(tables, kmin, kmax, k[:cap], lv[:cap],
                                          vd[:cap]) == "vector_staged", cap
    assert cuda_join.payload_instance(tables, kmin, kmax, k[1:], lv[1:], vd[1:]) == \
        "scalar_staged"
    assert cuda_join.payload_instance(tables, kmin, kmax, k[:-1], lv[:-1], vd[1:]) == \
        "scalar_staged"
    assert cuda_join.payload_instance(tables, kmin, kmax, k[r:], lv[r:], vd[r:]) == \
        "vector_staged"
    # the staging limit counts present + values over the domain
    big = [torch.zeros(cuda_join.STAGED_SLOTS, dtype=torch.int32)] * 2
    assert cuda_join.payload_instance(big, 0, cuda_join.STAGED_SLOTS // 2 - 1, k, lv) == \
        "vector_staged"
    assert cuda_join.payload_instance(big, 0, cuda_join.STAGED_SLOTS // 2, k, lv) == "vector"
    assert cuda_join.payload_instance(big, 0, cuda_join.STAGED_SLOTS // 2, k[1:], lv[1:]) == \
        "scalar"
    dtypes = [torch.int16]
    for inner in (False, True):
        _assert_keep(cuda_join.payload_keep(tables, kmin, kmax, k[1:], lv[1:], vd[1:], dtypes,
                                            inner),
                     [x[1:] if isinstance(x, torch.Tensor) else [y[1:] for y in x]
                      for x in cuda_join.payload_keep_plain(tables, kmin, kmax, k, lv, vd,
                                                            dtypes, inner)],
                     f"views, inner={inner}")


def _operator_pair(jt: str, validity: str, seed: int):
    """A JAX and a port probe operator on the same payload build (three
    build columns stored in int8, int16 and int32), and the same probe
    batch for both, whose key's validity is the batch's live mask
    (``live``), a mask of its own (``own``) or all valid (``none``)."""
    rng = np.random.default_rng(seed)
    key_type = jnarrow(JINTEGER, -80, 460)  # int16 storage, as the connector narrows
    b_types = {"b8": jnarrow(JINTEGER, -100, 100), "b16": jnarrow(JINTEGER, -30000, 30000),
               "b32": JINTEGER}
    bk = rng.choice(np.arange(-40, 400), 300, replace=False)
    pk = rng.integers(-80, 460, 1500)
    types = {"bk": key_type, "pk": key_type, "pval": JINTEGER, **b_types}
    bvals = {"b8": rng.integers(-100, 101, 300), "b16": rng.integers(-30000, 30001, 300),
             "b32": rng.integers(-(1 << 31), 1 << 31, 300)}
    jb = JBatch.from_numpy({"bk": bk, **bvals}, types, capacity=1024)
    jp = JBatch.from_numpy({"pk": pk, "pval": np.arange(1500)}, types, capacity=CAP,
                           valids={"pk": rng.random(1500) < 0.9})
    c = jp["pk"]
    # the JAX package's columns always carry a validity: "none" is all
    # valid there and None in the port
    valid = {"live": jp.live, "own": c.valid, "none": jnp.ones_like(jp.live)}[validity]
    jp = JBatch({**jp.columns, "pk": JColumn(c.data, valid, c.dtype, c.dictionary)}, jp.live)
    outs = tuple(b_types)
    jbuild = JJ.JoinBuildOperator(jcol("bk", key_type), pallas=pallas_join.PallasJoinSpec(
        "payload", -40, 399, payload=outs))
    JPipeline(JBatchSource([jb]), [jbuild]).run()
    jop = JJ.LookupJoinOperator(jbuild, jcol("pk", key_type),
                                [JJ.BuildOutput(o, o) for o in outs], jt)
    pbuild = PJ.JoinBuildOperator(pcol("bk", port_type(key_type)), pallas=cuda_join.PallasJoinSpec(
        "payload", -40, 399, payload=outs))
    pbuild.process(port_batch(jb))
    pbuild.finish()
    pop = PJ.LookupJoinOperator(pbuild, pcol("pk", port_type(key_type)),
                                [PJ.BuildOutput(o, o) for o in outs], jt)
    return jop, pop, jp


OPS = [(jt, validity) for jt in ("inner", "left") for validity in ("live", "own", "none")]


@pytest.mark.parametrize("jt,validity", OPS)
def test_operator_makes_one_keep_call_per_batch(jt, validity):
    jop, pop, jp = _operator_pair(jt, validity, len(jt) + 3 * len(validity))
    (jout,) = JPipeline(JBatchSource([jp]), [jop]).run()
    pb = port_batch(jp)
    if validity == "none":
        c = pb["pk"]
        pb = PBatch({**pb.columns, "pk": PColumn(c.data, None, c.dtype, c.dictionary)}, pb.live)
    original, calls = cuda_join.payload_keep, []

    def spy(*args):
        calls.append(args)
        return original(*args)

    cuda_join.payload_keep = spy
    try:
        (pout,) = pop.process(pb)
    finally:
        cuda_join.payload_keep = original
    assert jop._strategy == pop._strategy == "pallas"
    assert len(calls) == 1
    # (tables, kmin, kmax, keys, live, valid, out_dtypes, inner)
    args = calls[0]
    assert args[3] is pb["pk"].data
    assert args[4] is pb.live  # the batch's live mask, not a composed copy
    if validity == "own":
        assert args[5] is pb["pk"].valid
    else:
        assert args[5] is None  # a validity that IS the live mask adds nothing
    assert args[6] == [torch.int8, torch.int16, torch.int32]
    assert args[7] == (jt == "inner")
    assert_same(pout.live, jout.live, f"{jt} validity={validity}: live")
    assert list(pout.names) == list(jout.names)
    for n in jout.names:
        assert_same(pout[n].data, jout[n].data, f"{n} data")
        if not (n == "pk" and validity == "none"):  # the input's None against all-valid
            assert_same(pout[n].valid, jout[n].valid, f"{n} valid")
        assert pout[n].dtype == port_type(jout[n].dtype), n
    # every value column's validity is the one match mask; the inner
    # join's live mask holds the same values in a tensor of its own
    assert pout["b8"].valid is pout["b16"].valid is pout["b32"].valid
    if jt == "inner":
        assert pout.live is not pout["b8"].valid
        assert_same(pout.live, pout["b8"].valid, "inner live is the match mask")
    else:
        assert pout.live is pb.live
