"""The fused semi/anti live-mask update of the exists and sketch probes
against the JAX package, exactly.

- ``ops/cuda_join``: ``exists_keep_plain`` and ``sketch_keep_plain``
  (which the CUDA kernels' keep and anti modes are held to on the card)
  equal the operator's composition written out here (probe live = live
  && valid, the probe, then ``live & matched`` or ``live & ~matched``)
  and the same composition around the JAX package's ``exists_probe`` /
  ``sketch_probe`` run in interpret mode: int8/int16/int32 keys, semi
  and anti, NULL keys planted and no validity at all, dead rows, keys
  outside the domain; the ``_keep`` wrappers compute the plain version
  on CPU tensors and count no launch; ``exists_probe`` / ``sketch_probe``
  equal the keep mode with no validity.
- the wrappers' instance choice on CPU tensors: aligned tensors take the
  vector instance whatever the ragged tail, a view one element into its
  buffer the scalar one, a view a whole group in the vector one.
- ``exec/joins``: ``LookupJoinOperator`` on the exists and sketch routes
  makes one ``_keep`` call per probe batch, passes no validity when the
  key's validity is the batch's live mask, and keeps the JAX operator's
  rows when the key's validity is the live mask, a separate mask or
  absent.
Tolerance: exact everywhere (boolean data).
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
NBITS = cuda_join.SKETCH_BITS
# (key dtype, key_min, key_max) of the exists tables
DOMAINS = {"int8": (-100, 100), "int16": (-3000, 20000), "int32": (1, 150000)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(kernel: str, dtype: str, seed: int, cap: int = CAP):
    """(table, the same table from the JAX package's ``build_*_table``,
    keys, live, validity with NULLs planted) from seeded numpy: keys
    across and past the domain (exists) or over the whole dtype range
    with a share drawn from the build (sketch); the edge keys live, some
    of them NULL."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    live = rng.random(cap) < 0.85
    live[:6] = True
    valid = rng.random(cap) < 0.9
    valid[1:6:2] = False  # NULL keys among the live edge keys
    if kernel == "exists":
        kmin, kmax = DOMAINS[dtype]
        bk = rng.integers(kmin, kmax, 3000, endpoint=True)
        bk[:2] = [kmin, kmax]
        bk = bk.astype(dtype)
        table, oob = cuda_join.build_exists_table(_t(bk), _t(np.ones(3000, bool)), kmin, kmax)
        jtable, _ = pallas_join.build_exists_table(jnp.asarray(bk), jnp.ones(3000, bool),
                                                   kmin, kmax)
        assert not bool(oob)
        keys = rng.integers(max(info.min, kmin - 2000), min(info.max, kmax + 2000), cap,
                            endpoint=True)
        edges = [e for e in (kmin, kmax, kmin - 1, kmax + 1, info.min, info.max)
                 if info.min <= e <= info.max]
        keys[: len(edges)] = edges
    else:
        bk = rng.integers(info.min, info.max, 3000, endpoint=True).astype(dtype)
        table = cuda_join.build_sketch_table(_t(bk), _t(np.ones(3000, bool)))
        jtable = pallas_join.build_sketch_table(jnp.asarray(bk), jnp.ones(3000, bool), NBITS)
        keys = rng.integers(info.min, info.max, cap, endpoint=True)
        keys[6: cap // 4] = rng.choice(bk, cap // 4 - 6)
        keys[:3] = [info.min, info.max, -1]
    return table, jtable, keys.astype(dtype), live, valid


def _composed(probe, live, valid, anti: bool):
    """The operator's composition before the keep modes: probe on live &
    valid (all valid without a validity), then keep or drop the matches."""
    plive = live & (np.ones_like(live) if valid is None else valid)
    matched = to_numpy(probe(plive))
    return live & (~matched if anti else matched)


CASES = [(kernel, dt, nulls) for kernel in ("exists", "sketch")
         for dt in ("int8", "int16", "int32") for nulls in (True, False)]


@pytest.mark.parametrize("kernel,dtype,nulls", CASES)
def test_keep_plain_equals_the_composition_and_the_pallas_probe(kernel, dtype, nulls):
    table, jtable, keys, live, valid = _inputs(kernel, dtype, 3 + len(dtype) + 7 * nulls)
    v = valid if nulls else None
    for anti in ((False, True) if kernel == "exists" else (False,)):
        if kernel == "exists":
            kmin, kmax = DOMAINS[dtype]
            got = cuda_join.exists_keep_plain(table, kmin, kmax, _t(keys), _t(live),
                                              None if v is None else _t(v), anti)

            def port(plive):
                return cuda_join.exists_probe_plain(table, kmin, kmax, _t(keys), _t(plive))

            def ref(plive):
                return pallas_join.exists_probe(jtable, kmin, kmax, jnp.asarray(keys),
                                                jnp.asarray(plive), interpret=True)
        else:
            got = cuda_join.sketch_keep_plain(table, NBITS, _t(keys), _t(live),
                                              None if v is None else _t(v))

            def port(plive):
                return cuda_join.sketch_probe_plain(table, NBITS, _t(keys), _t(plive))

            def ref(plive):
                return pallas_join.sketch_probe(jtable, NBITS, jnp.asarray(keys),
                                                jnp.asarray(plive), interpret=True)
        what = f"{kernel} {dtype} {'anti' if anti else 'keep'} nulls={nulls}"
        assert_same(got, _composed(port, live, v, anti), f"{what}: the composition")
        assert_same(got, _composed(ref, live, v, anti), f"{what}: the Pallas probe")
        g = to_numpy(got)
        assert not g[~live].any(), f"{what}: a dead row is live"
        if v is not None:
            nulls_live = g[live & ~v]
            assert nulls_live.all() if anti else not nulls_live.any(), \
                f"{what}: NULL keys {'dropped' if anti else 'kept'}"


@pytest.mark.parametrize("kernel", ["exists", "sketch"])
def test_keep_wrappers_compute_the_plain_version_on_the_cpu(kernel):
    table, _, keys, live, valid = _inputs(kernel, "int32", 21)
    k, lv, vd = _t(keys), _t(live), _t(valid)
    before = (cuda_join.exists_launches, cuda_join.sketch_launches,
              {n: dict(c) for n, c in cuda_join.launches_by_instance.items()})
    if kernel == "exists":
        kmin, kmax = DOMAINS["int32"]
        for v in (None, vd):
            for anti in (False, True):
                assert_same(cuda_join.exists_keep(table, kmin, kmax, k, lv, v, anti),
                            cuda_join.exists_keep_plain(table, kmin, kmax, k, lv, v, anti),
                            f"exists_keep anti={anti}")
        assert_same(cuda_join.exists_probe(table, kmin, kmax, k, lv),
                    cuda_join.exists_keep_plain(table, kmin, kmax, k, lv, None, False),
                    "exists_probe is the keep mode without validity")
    else:
        for v in (None, vd):
            assert_same(cuda_join.sketch_keep(table, NBITS, k, lv, v),
                        cuda_join.sketch_keep_plain(table, NBITS, k, lv, v), "sketch_keep")
        assert_same(cuda_join.sketch_probe(table, NBITS, k, lv),
                    cuda_join.sketch_keep_plain(table, NBITS, k, lv, None),
                    "sketch_probe is the keep mode without validity")
    assert (cuda_join.exists_launches, cuda_join.sketch_launches,
            cuda_join.launches_by_instance) == before


def test_keep_wrappers_refuse_a_bad_validity():
    table, _, keys, live, valid = _inputs("exists", "int16", 5)
    kmin, kmax = DOMAINS["int16"]
    k, lv = _t(keys), _t(live)
    for bad in (_t(valid.astype(np.int8)), _t(valid[:-1])):
        with pytest.raises(InternalError, match="validity"):
            cuda_join.exists_keep(table, kmin, kmax, k, lv, bad, False)
        with pytest.raises(InternalError, match="validity"):
            cuda_join.sketch_keep(cuda_join.build_sketch_table(k, lv), NBITS, k, lv, bad)


@pytest.mark.parametrize("dtype", ["int8", "int16", "int32"])
def test_instance_choice(dtype):
    """Aligned keys, live and validity take the vector instance at any
    capacity (the ragged tail is done in the same launch); a view one
    element into its buffer takes the scalar one; a view a whole 16-byte
    group of keys in is aligned again. The plain version does not care."""
    table, _, keys, live, valid = _inputs("exists", dtype, 9)
    kmin, kmax = DOMAINS[dtype]
    k, lv, vd = _t(keys), _t(live), _t(valid)
    r = cuda_join.group_rows(k)
    assert r == 16 // np.dtype(dtype).itemsize
    for cap in (1, 3, 15, 17, r, r + 1, CAP - 1, CAP):
        assert cuda_join.instance(k[:cap], lv[:cap]) == "vector", cap
        assert cuda_join.instance(k[:cap], lv[:cap], vd[:cap]) == "vector", cap
    assert cuda_join.instance(k[1:], lv[1:]) == "scalar"
    assert cuda_join.instance(k[1:], lv[:-1]) == "scalar"
    assert cuda_join.instance(k[:-1], lv[1:]) == "scalar"
    assert cuda_join.instance(k[:-1], lv[:-1], vd[1:]) == "scalar"
    assert cuda_join.instance(k[r:], lv[r:], vd[r:]) == "vector"
    assert set(cuda_join.INSTANCES) == {"vector", "scalar"}
    for anti in (False, True):
        assert_same(cuda_join.exists_keep(table, kmin, kmax, k[1:], lv[1:], vd[1:], anti),
                    cuda_join.exists_keep_plain(table, kmin, kmax, k, lv, vd, anti)[1:],
                    f"views, anti={anti}")


def _operator_pair(jt: str, mode: str, validity: str, seed: int):
    """A JAX and a port probe operator on the same build, and the same
    probe batch for both, whose key's validity is the batch's live mask
    (``live``), a mask of its own (``own``) or all valid (``none``)."""
    rng = np.random.default_rng(seed)
    key_type = jnarrow(JINTEGER, -80, 460)  # int16 storage, as the connector narrows
    bk = rng.integers(-40, 400, 300)
    pk = rng.integers(-80, 460, 1500)
    types = {"bk": key_type, "pk": key_type, "pval": JINTEGER}
    jb = JBatch.from_numpy({"bk": bk}, types, capacity=1024, valids={"bk": rng.random(300) < 0.9})
    jp = JBatch.from_numpy({"pk": pk, "pval": np.arange(1500)}, types, capacity=CAP,
                           valids={"pk": rng.random(1500) < 0.9})
    c = jp["pk"]
    # the JAX package's columns always carry a validity: "none" is all
    # valid there and None in the port (see _port_probe_batch)
    valid = {"live": jp.live, "own": c.valid, "none": jnp.ones_like(jp.live)}[validity]
    jp = JBatch({**jp.columns, "pk": JColumn(c.data, valid, c.dtype, c.dictionary)}, jp.live)
    if mode == "exists":
        jspec = pallas_join.PallasJoinSpec("exists", -40, 399)
        pspec = cuda_join.PallasJoinSpec("exists", -40, 399)
    else:
        jspec = pallas_join.PallasJoinSpec("sketch", nbits=pallas_join.SKETCH_BITS)
        pspec = cuda_join.PallasJoinSpec("sketch", nbits=NBITS)
    jbuild = JJ.JoinBuildOperator(jcol("bk", key_type), pallas=jspec)
    JPipeline(JBatchSource([jb]), [jbuild]).run()
    jop = JJ.LookupJoinOperator(jbuild, jcol("pk", key_type), (), jt)
    t = port_type(key_type)
    pbuild = PJ.JoinBuildOperator(pcol("bk", t), pallas=pspec)
    pbuild.process(port_batch(jb))
    pbuild.finish()
    return jop, PJ.LookupJoinOperator(pbuild, pcol("pk", t), (), jt), jp


OPS = [(jt, mode, validity) for jt, mode in (("semi", "exists"), ("anti", "exists"),
                                             ("inner", "exists"), ("semi", "sketch"))
       for validity in ("live", "own", "none")]


@pytest.mark.parametrize("jt,mode,validity", OPS)
def test_operator_makes_one_keep_call_per_batch(jt, mode, validity):
    jop, pop, jp = _operator_pair(jt, mode, validity, len(jt) + len(mode) + len(validity))
    (jout,) = JPipeline(JBatchSource([jp]), [jop]).run()
    pb = port_batch(jp)
    if validity == "none":
        c = pb["pk"]
        pb = PBatch({**pb.columns, "pk": PColumn(c.data, None, c.dtype, c.dictionary)}, pb.live)
    name = f"{mode}_keep"
    original, calls = getattr(cuda_join, name), []

    def spy(*args):
        calls.append(args)
        return original(*args)

    setattr(cuda_join, name, spy)
    try:
        (pout,) = pop.process(pb)
    finally:
        setattr(cuda_join, name, original)
    assert jop._strategy == pop._strategy == "pallas"
    assert len(calls) == 1
    # exists: (table, kmin, kmax, keys, live, valid, anti);
    # sketch: (table, nbits, keys, live, valid)
    args = calls[0][1:] if mode == "exists" else calls[0]
    assert args[2] is pb["pk"].data
    assert args[3] is pb.live  # the batch's live mask, not a composed copy
    if validity == "own":
        assert args[4] is pb["pk"].valid
    else:
        assert args[4] is None  # a validity that IS the live mask adds nothing
    if mode == "exists":
        assert args[5] == (jt == "anti")
    assert_same(pout.live, jout.live, f"{jt} {mode} validity={validity}")
