"""Time kernels against an earlier commit's, on one card, in turns.

Run from the root of a checkout, with an earlier commit's kernel sources
unpacked under ``local/`` (which ``.gitignore`` lists)::

    mkdir -p local/prev6 local/prev7 local/prev8 local/prev9
    git archive e170780 presto_tpu_torch/csrc | tar -x -C local/prev6
    git archive 17cb3ec presto_tpu_torch/csrc | tar -x -C local/prev7
    git archive 0d9b82d presto_tpu_torch/csrc | tar -x -C local/prev8
    git archive 1bef9e0 presto_tpu_torch/csrc | tar -x -C local/prev9
    python3 -m presto_tpu_torch.tools.compare_previous \
        --leaf-lane local/prev6/presto_tpu_torch/csrc \
        --probes local/prev7/presto_tpu_torch/csrc \
        --payload-like local/prev8/presto_tpu_torch/csrc \
        --prefix local/prev9/presto_tpu_torch/csrc

Any of the options may be given alone. The earlier sources are built
with this checkout's nvcc flags into ``build/`` beside them.

``--leaf-lane``: the leaf-aggregation and lane-sums kernels before their
Hopper redesign. The sources must come from a commit whose
``leaf_agg_launch`` and ``lane_sums_launch`` take no instance argument
(e170780 and before). The inputs are the main path's, taken from the
first call of each kernel in SF1 queries through ``Session.sql``: the
first Q6 and SSB Q1.1 splits and a resident SF1 x10 ``lineitem`` for the
leaf kernel; the first Q1 pipeline, ``q_like_phone`` and Q4 ``orders``
splits for the lane-sums kernel. Each split is taken once more with its
columns copied into views one element into their buffers, which this
checkout reads with its direct instance.

``--probes``: the exists and sketch kernels before their redesign. The
sources must come from a commit whose ``exists_probe_launch`` and
``sketch_probe_launch`` take (keys, key size, live, n, table, ..., out,
stream) and no validity, mode or instance (17cb3ec and before). The
inputs are ``chip_smoke``'s phase-5 probe batches: the first probe split
of Q3 and of Q9 (exists), of ``semi_anti_part``'s anti join (exists),
of Q4 and ``semi`` under ``approx_join`` (sketch), each at SF1 through
``Session.sql``. The earlier kernel gets the probe live mask the
operator of that commit composed (``live & valid``); this checkout's
gets live and validity and returns the new live mask. Each shape is
timed twice: the kernel alone, and every kernel of one whole probe
batch (the earlier commit's composition: the validity fill and ``&``,
the kernel, ``~`` for an anti join, ``&``; this checkout's
``LookupJoinOperator._pallas_probe``). The kernels alone are timed
twice more, from an L2 flushed by reads instead of writes (no dirty
lines to write back) and from a warm L2.

``--payload-like``: the payload and LIKE kernels before their Hopper
redesign. The sources must come from a commit whose
``payload_probe_launch`` takes (keys, key size, live, n, present,
tables, outs, nval, kmin, kmax, matched, stream) and whose
``like_launch`` takes (data, n, width, prog, pat, out, stream)
(0d9b82d and before). The payload inputs are ``chip_smoke``'s phase-5
batches: the first ``lineitem`` probe batch of Q10's and of Q9's nation
join at SF1 through ``Session.sql``. The kernel alone is the JAX
contract (the probe live mask ``live && valid``, int32 values) in both
versions, and again from a clean-flushed and a warm L2; then every
kernel of one whole probe batch: the earlier commit's operator
composition (the validity fill and ``&``, the kernel, a cast per value
column, the inner join's ``live & matched``) against this checkout's
``LookupJoinOperator._pallas_probe`` (one kernel). The LIKE inputs are
the first split of the table each LIKE query of ``chip_smoke``'s phase
8 filters (Q9's ``part``, ``q_like_part``'s SSB ``part``,
``q_like_phone``'s SSB ``customer``) and the whole SF1 ``o_comment``
column, each timed from a dirty-flushed, a clean-flushed and a warm L2.

``--prefix``: the prefix kernel before its Hopper redesign. The sources
must come from a commit whose ``prefix_launch`` takes (data, n, width,
prefix, len, out, stream) with the prefix's bytes in device memory
(1bef9e0 and before). The inputs are ``chip_smoke``'s phase-5 shapes:
the first ``part`` split of the ``starts_with(p_name, 'forest')``
pipeline (the main path) and the whole SF1 ``o_comment`` column with
``chip_smoke.COMMENT_PREFIX``, each timed from a dirty-flushed, a
clean-flushed and a warm L2.

For each input both versions must return the same result, and the
device ms are printed in turns: previous, current, current, previous
(the profiler's trace, cold L2, as ``chip_smoke.device_ms``). The last
line is one JSON object of those times. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.connectors.ssb import SsbConnector
from presto_tpu_torch.connectors.ssb.queries import QUERIES as SSB
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.connectors.tpch.queries import QUERIES
from presto_tpu_torch.exec import leaf_route
from presto_tpu_torch.exec.operators import valid_of
from presto_tpu_torch.expr import evaluate
from presto_tpu_torch.ops import _build, cuda_agg, cuda_groupby, cuda_join, cuda_strings
from presto_tpu_torch.runtime.session import Session
from presto_tpu_torch.workloads import part_name_pipeline, q1_pipeline

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def load_previous(csrc: Path, names) -> dict:
    """The earlier commit's launch entries ``<name>_launch`` of the
    kernel sources ``names``, built from ``csrc`` (one nvcc per source,
    in parallel)."""
    out = csrc.parent / "build"
    out.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
         str(csrc / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in names}
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"previous {name} did not build:\n{text}")
        cs.log_ptxas(f"previous {name}", text)
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    fns = {}
    if "leaf_agg" in libs:
        fns["leaf_agg"] = libs["leaf_agg"].leaf_agg_launch
        fns["leaf_agg"].argtypes = [_P, _P, _I, _P, _P, _I, _I, _P, _LL, _P, _P]
    if "lane_sums" in libs:
        fns["lane_sums"] = libs["lane_sums"].lane_sums_launch
        fns["lane_sums"].argtypes = [_P, _P, _I, _P, _I, _P, _I, _LL, _P, _P]
    if "join_probe" in libs:
        fns["exists"] = libs["join_probe"].exists_probe_launch
        fns["exists"].argtypes = [_P, _I, _P, _LL, _P, _LL, _LL, _P, _P]
        fns["sketch"] = libs["join_probe"].sketch_probe_launch
        fns["sketch"].argtypes = [_P, _I, _P, _LL, _P, _LL, _P, _P]
        fns["payload"] = libs["join_probe"].payload_probe_launch
        fns["payload"].argtypes = [_P, _I, _P, _LL, _P, _P, _P, _I, _LL, _LL, _P, _P]
    if "strings" in libs:
        fns["like"] = libs["strings"].like_launch
        fns["like"].argtypes = [_P, _LL, _I, _P, _P, _P, _P]
        fns["prefix"] = libs["strings"].prefix_launch
        fns["prefix"].argtypes = [_P, _LL, _I, _P, _I, _P, _P]
    for fn in fns.values():
        fn.restype = _I
    return fns


def previous_leaf(fn, spec, b) -> dict:
    """``cuda_agg.agg_step`` through the earlier launch entry ``fn``."""
    cols = [b[c].data for c in spec.cols]
    colp, valp = cuda_agg._kernel_params(spec)
    out = cuda_agg._initial_output(spec, b.device)
    n = max(len(cols), 1)
    ptrs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in cols])
    sizes = (ctypes.c_int * n)(*[t.element_size() for t in cols])
    code = fn(ctypes.addressof(ptrs), ctypes.addressof(sizes), len(cols), ctypes.addressof(colp),
              ctypes.addressof(valp), len(spec.values), spec.groups, b.live.data_ptr(),
              b.capacity, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    cs.check(code == 0, f"previous leaf_agg launch failed ({code})")
    return cuda_agg._unpack(spec, out)


def previous_lane(fn, vals, bits, masks, gids, groups):
    """``cuda_groupby.fused_lane_sums`` through the earlier launch entry."""
    k, m = len(vals), len(masks)
    out = torch.zeros(groups * (k + m) + 1, dtype=torch.int64, device=gids.device)
    vptr = (ctypes.c_void_p * max(k, 1))(*[v.data_ptr() for v in vals])
    vbits = (ctypes.c_int * max(k, 1))(*[int(b) for b in bits])
    mptr = (ctypes.c_void_p * max(m, 1))(*[mk.data_ptr() for mk in masks])
    code = fn(ctypes.addressof(vptr), ctypes.addressof(vbits), k, ctypes.addressof(mptr), m,
              gids.data_ptr(), groups, gids.shape[0], out.data_ptr(),
              torch.cuda.current_stream().cuda_stream)
    cs.check(code == 0, f"previous lane_sums launch failed ({code})")
    return cuda_groupby._unpack(out, k, m, groups)


def first_call(owner, attr: str, run) -> tuple:
    """The arguments of the first call of ``owner.attr`` while ``run()``
    runs."""
    seen = []
    original = getattr(owner, attr)

    def spy(*args):
        if not seen:
            seen.append(args)
        return original(*args)

    setattr(owner, attr, spy)
    try:
        run()
    finally:
        setattr(owner, attr, original)
    cs.check(bool(seen), f"{attr} was never called")
    return seen[0]


def leaf_views(spec, b) -> tuple:
    """(spec, the batch with every spec column a view one element in)."""
    cols = {c: Column(cs.unaligned(b[c].data), b.live, b[c].dtype) for c in spec.cols}
    return spec, Batch(cols, b.live)


def lane_views(vals, bits, masks, gids, groups) -> tuple:
    return ([cs.unaligned(v) for v in vals], bits, [cs.unaligned(mk) for mk in masks],
            cs.unaligned(gids), groups)


def previous_kernel(fns, mode: str, op, keys, plive) -> torch.Tensor:
    """The earlier commit's exists or sketch kernel on the operator
    ``op``'s table: matched bool [cap] = plive && hit."""
    spec, table = op.build.pallas, op.build.pallas_side[0]
    out = torch.empty(keys.shape, dtype=torch.bool, device=keys.device)
    extra = (spec.key_min, spec.key_max) if mode == "exists" else (spec.nbits,)
    code = fns[mode](keys.data_ptr(), keys.element_size(), plive.data_ptr(), keys.shape[0],
                     table.data_ptr(), *extra, out.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
    cs.check(code == 0, f"previous {mode} launch failed ({code})")
    return out


def previous_probe(fns, mode: str, op, batch) -> torch.Tensor:
    """The earlier commit's ``_pallas_probe`` on the exists or sketch
    route: the probe live mask, the kernel, then the keep rule. Returns
    the new live mask."""
    v = evaluate(op.probe_key, batch)
    plive = batch.live & valid_of(v.valid, batch.live)
    matched = previous_kernel(fns, mode, op, v.data, plive)
    keep = ~matched if op.join_type == "anti" else matched
    return batch.live & keep


def probe_inputs(tconn) -> dict:
    """chip_smoke's phase-5 probe batches: {name: (mode, first_probe's
    capture)}, each from one run of its query at SF1."""
    runs = {"Q3 first lineitem split": ("exists", None, QUERIES["q3"], False),
            "Q9 first lineitem split": ("exists", None, QUERIES["q9"], False),
            "semi_anti_part anti join first part split":
                ("exists", True, cs.SEMI_SQL["semi_anti_part"], False),
            "Q4 approx first orders split": ("sketch", None, QUERIES["q4"], True),
            "semi approx first lineitem split": ("sketch", None, cs.SEMI_SQL["semi"], True)}
    out = {}
    for name, (mode, anti, sql, approx) in runs.items():
        session = Session({"tpch": tconn}, properties={"approx_join": approx}, device="cuda")
        with cs.first_probe(mode, anti) as seen:
            session.sql(sql)
        cs.check("args" in seen, f"{name}: no {mode} probe batch")
        out[name] = (mode, seen)
    return out


class CleanFlush:
    """A flush for ``chip_smoke.device_ms`` that evicts L2 by reading
    ``buf`` (larger than L2), leaving clean lines behind."""

    def __init__(self, buf: torch.Tensor):
        self.buf = buf

    def bitwise_not_(self):
        self.buf.sum(dtype=torch.int64)


def compare_probes(prev: dict, tconn, flush) -> dict:
    """The exists and sketch kernels, earlier against current, at the
    phase-5 probe batches: the kernel alone, then one whole probe
    batch."""
    out = {}
    for name, (mode, seen) in probe_inputs(tconn).items():
        op, batch = seen["op"]
        v = evaluate(op.probe_key, batch)
        plive = batch.live & valid_of(v.valid, batch.live)
        keep = getattr(cuda_join, f"{mode}_keep")
        args = seen["args"]
        inst = cuda_join.instance(*(args[3:6] if mode == "exists" else args[2:5]))
        whole_old = lambda op=op, b=batch, m=mode: previous_probe(prev, m, op, b)  # noqa: E731
        whole_new = lambda op=op, b=batch: op._pallas_probe(b).live  # noqa: E731
        cs.check(torch.equal(whole_new(), whole_old()) and torch.equal(keep(*args), whole_old()),
                 f"{name}: current probe differs from previous")
        old = lambda op=op, k=v.data, pl=plive, m=mode: previous_kernel(prev, m, op, k, pl)  # noqa: E731
        new = lambda f=keep, a=args: f(*a)  # noqa: E731
        kernel = f"{mode}_kernel"
        t = [cs.device_ms(f, 50, flush, kernel=kernel) for f in (old, new, new, old)]
        # the kernel alone again from an L2 flushed by reads (clean lines:
        # device_ms's in-place flush leaves 50 MB of dirty lines whose
        # write-back the next reads pay) and from a warm L2 (inputs and
        # table still cached from the call before)
        states = {state: [cs.device_ms(f, 50, fl, kernel=kernel) for f in (old, new, new, old)]
                  for state, fl in (("clean", CleanFlush(flush)), ("warm", None))}
        w = [cs.device_ms(f, 50, flush) for f in (whole_old, whole_new, whole_new, whole_old)]
        # device kernels a batch: the trace's events of 20 batches over 20
        per_batch = [sum(cs.device_kernels(f, 20).values()) / 20 for f in (whole_old, whole_new)]
        out[f"{mode} {name}"] = {"instance": inst, "rows": batch.capacity, "turns_ms": t,
                                 "clean_flush_turns_ms": states["clean"],
                                 "warm_turns_ms": states["warm"],
                                 "probe_turns_ms": w, "probe_kernels": per_batch}
        cs.log(f"  {mode} {name} ({batch.capacity} rows, {inst}): kernel previous {t[0]:.4f}, "
               f"{t[3]:.4f} ms; current {t[1]:.4f}, {t[2]:.4f} ms; whole probe batch previous "
               f"{w[0]:.4f}, {w[3]:.4f} ms; current {w[1]:.4f}, {w[2]:.4f} ms (device ms, in "
               f"turns; kernels in one batch {out[f'{mode} {name}']['probe_kernels']})")
        for state, c in states.items():
            cs.log(f"    kernel from a {state} L2: previous {c[0]:.4f}, {c[3]:.4f} ms; current "
                   f"{c[1]:.4f}, {c[2]:.4f} ms")
    return out


def previous_payload(fns, tables, kmin: int, kmax: int, keys, plive):
    """The earlier commit's payload kernel (the JAX contract): (matched,
    [int32 values])."""
    present, vtabs = tables[0], list(tables[1:])
    matched = torch.empty(keys.shape, dtype=torch.bool, device=keys.device)
    outs = [torch.empty(keys.shape, dtype=torch.int32, device=keys.device) for _ in vtabs]
    tptr = (ctypes.c_void_p * cuda_join.MAX_VALUES)(*[t.data_ptr() for t in vtabs])
    optr = (ctypes.c_void_p * cuda_join.MAX_VALUES)(*[o.data_ptr() for o in outs])
    code = fns["payload"](keys.data_ptr(), keys.element_size(), plive.data_ptr(), keys.shape[0],
                          present.data_ptr(), ctypes.addressof(tptr), ctypes.addressof(optr),
                          len(vtabs), kmin, kmax, matched.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
    cs.check(code == 0, f"previous payload launch failed ({code})")
    return matched, outs


def previous_payload_batch(fns, op, batch) -> Batch:
    """The earlier commit's ``_pallas_probe`` on the payload route: the
    probe live mask, the kernel, each value cast to its build column's
    type, and the inner join's live mask."""
    spec, tables = op.build.pallas, op.build.pallas_side
    v = evaluate(op.probe_key, batch)
    plive = batch.live & valid_of(v.valid, batch.live)
    matched, vals = previous_payload(fns, tables, spec.key_min, spec.key_max, v.data, plive)
    cols = dict(batch.columns)
    for bo, pv in zip(op.build_outputs, vals):
        src = op.build.payload[bo.source]
        cols[bo.name] = Column(pv.to(src.data.dtype), matched, src.dtype, src.dictionary)
    live = batch.live & matched if op.join_type == "inner" else batch.live
    return Batch(cols, live)


def same_batch(got: Batch, want: Batch, what: str) -> None:
    cs.check(torch.equal(got.live, want.live), f"{what}: live differs")
    for name in want.names:
        g, w = got[name], want[name]
        cs.check(torch.equal(g.data, w.data) and g.data.dtype == w.data.dtype,
                 f"{what}: column {name} differs")
        cs.check((g.valid is None) == (w.valid is None)
                 and (g.valid is None or torch.equal(g.valid, w.valid)),
                 f"{what}: validity of {name} differs")


def compare_payload(prev: dict, tconn, flush) -> dict:
    """The payload kernel, earlier against current, at the first probe
    batch of Q10's and Q9's nation joins."""
    out = {}
    for name, sql in (("Q10 first lineitem split", QUERIES["q10"]),
                      ("Q9 first lineitem split", QUERIES["q9"])):
        with cs.first_probe("payload") as seen:
            Session({"tpch": tconn}, device="cuda").sql(sql)
        cs.check("args" in seen, f"{name}: no payload probe batch")
        op, batch = seen["op"]
        tables, kmin, kmax, keys, live, valid = seen["args"][:6]
        plive = live if valid is None else live & valid
        old = lambda a=(tables, kmin, kmax, keys, plive): previous_payload(prev, *a)  # noqa: E731
        new = lambda a=(tables, kmin, kmax, keys, plive): cuda_join.payload_probe(*a)  # noqa: E731
        (om, ov), (nm, nv) = old(), new()
        cs.check(torch.equal(om, nm) and all(torch.equal(a, b) for a, b in zip(ov, nv)),
                 f"{name}: current payload_probe differs from previous")
        whole_old = lambda op=op, b=batch: previous_payload_batch(prev, op, b)  # noqa: E731
        whole_new = lambda op=op, b=batch: op._pallas_probe(b)  # noqa: E731
        same_batch(whole_new(), whole_old(), f"{name}: whole probe batch")
        inst = cuda_join.payload_instance(tables, kmin, kmax, keys, plive)
        t = [cs.device_ms(f, 50, flush, kernel="payload_kernel") for f in (old, new, new, old)]
        states = {state: [cs.device_ms(f, 50, fl, kernel="payload_kernel")
                          for f in (old, new, new, old)]
                  for state, fl in (("clean", CleanFlush(flush)), ("warm", None))}
        w = [cs.device_ms(f, 50, flush) for f in (whole_old, whole_new, whole_new, whole_old)]
        per_batch = [sum(cs.device_kernels(f, 20).values()) / 20 for f in (whole_old, whole_new)]
        out[f"payload {name}"] = {"instance": inst, "rows": batch.capacity, "turns_ms": t,
                                  "clean_flush_turns_ms": states["clean"],
                                  "warm_turns_ms": states["warm"], "probe_turns_ms": w,
                                  "probe_kernels": per_batch,
                                  "valid": valid is not None, "inner": op.join_type == "inner"}
        cs.log(f"  payload {name} ({batch.capacity} rows, {keys.dtype}, {inst}, validity "
               f"{'passed' if valid is not None else 'none'}): kernel previous {t[0]:.4f}, "
               f"{t[3]:.4f} ms; current {t[1]:.4f}, {t[2]:.4f} ms; whole probe batch previous "
               f"{w[0]:.4f}, {w[3]:.4f} ms; current {w[1]:.4f}, {w[2]:.4f} ms (device ms, in "
               f"turns; kernels in one batch {per_batch})")
        for state, c in states.items():
            cs.log(f"    kernel from a {state} L2: previous {c[0]:.4f}, {c[3]:.4f} ms; current "
                   f"{c[1]:.4f}, {c[2]:.4f} ms")
    return out


def previous_like(fns, data, pattern: str) -> torch.Tensor:
    """The earlier commit's LIKE kernel on ``data``."""
    prog, pat = (torch.from_numpy(a).to(data.device)
                 for a in cuda_strings.like_program(pattern))
    out = torch.empty(data.shape[0], dtype=torch.bool, device=data.device)
    code = fns["like"](data.data_ptr(), data.shape[0], data.shape[1], prog.data_ptr(),
                       pat.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    cs.check(code == 0, f"previous like launch failed ({code})")
    return out


def compare_like(prev: dict, tconn, flush) -> dict:
    """The LIKE kernel, earlier against current, at the main path's four
    shapes."""
    sconn = SsbConnector(sf=1, device="cuda")
    inputs = {}
    for name, key, conn, sql in (("Q9 first part split", "tpch", tconn, QUERIES["q9"]),
                                 ("q_like_part first part split", "ssb", sconn,
                                  SSB["q_like_part"]),
                                 ("q_like_phone first customer split", "ssb", sconn,
                                  SSB["q_like_phone"])):
        inputs[name] = first_call(cuda_strings, "like_mask",
                                  lambda c=conn, k=key, q=sql: Session({k: c},
                                                                       device="cuda").sql(q))
    inputs["SF1 o_comment"] = (cs._t(cs.column_rows(tconn, "orders", "o_comment")),
                               "%special%requests%")
    out = {}
    for name, (data, pattern) in inputs.items():
        old = lambda d=data, p=pattern: previous_like(prev, d, p)  # noqa: E731
        new = lambda d=data, p=pattern: cuda_strings.like_mask(d, p)  # noqa: E731
        cs.check(torch.equal(old(), new()), f"{name}: current LIKE differs from previous")
        inst = cuda_strings.like_instance(data, pattern)
        states = {state: [cs.device_ms(f, 50, fl, kernel="like_kernel")
                          for f in (old, new, new, old)]
                  for state, fl in (("dirty", flush), ("clean", CleanFlush(flush)),
                                    ("warm", None))}
        out[f"like {name}"] = {"instance": inst, "rows": data.shape[0], "width": data.shape[1],
                               "pattern": pattern, "turns_ms": states["dirty"],
                               "clean_flush_turns_ms": states["clean"],
                               "warm_turns_ms": states["warm"]}
        for state, c in states.items():
            cs.log(f"  like {name} {pattern!r} [{data.shape[0]}, {data.shape[1]}] ({inst}) from "
                   f"a {state} L2: previous {c[0]:.4f}, {c[3]:.4f} ms; current {c[1]:.4f}, "
                   f"{c[2]:.4f} ms (kernel device ms, in turns)")
    return out


def previous_prefix(fns, data, prefix: str) -> torch.Tensor:
    """The earlier commit's prefix kernel on ``data``."""
    pre = torch.from_numpy(cuda_strings.plain.encode_needle(prefix).copy()).to(data.device)
    out = torch.empty(data.shape[0], dtype=torch.bool, device=data.device)
    code = fns["prefix"](data.data_ptr(), data.shape[0], data.shape[1], pre.data_ptr(),
                         pre.numel(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    cs.check(code == 0, f"previous prefix launch failed ({code})")
    return out


def compare_prefix(prev: dict, tconn, flush) -> dict:
    """The prefix kernel, earlier against current, at phase 5's two
    shapes."""
    inputs = {"starts_with first part split": first_call(
        cuda_strings, "starts_with_mask",
        lambda: cs.pipeline_keys(part_name_pipeline(tconn, "starts_with", "forest"))),
        "SF1 o_comment": (cs._t(cs.column_rows(tconn, "orders", "o_comment")),
                          cs.COMMENT_PREFIX)}
    out = {}
    for name, (data, prefix) in inputs.items():
        old = lambda d=data, p=prefix: previous_prefix(prev, d, p)  # noqa: E731
        new = lambda d=data, p=prefix: cuda_strings.starts_with_mask(d, p)  # noqa: E731
        cs.check(torch.equal(new(), old()), f"{name}: current prefix differs from previous")
        states = {state: [cs.device_ms(f, 50, fl, kernel="prefix_kernel")
                          for f in (old, new, new, old)]
                  for state, fl in (("dirty", flush), ("clean", CleanFlush(flush)),
                                    ("warm", None))}
        out[f"prefix {name}"] = {
            "rows": data.shape[0], "width": data.shape[1], "prefix": prefix,
            "instance": cuda_strings.prefix_instance(prefix),
            "turns_ms": states["dirty"], "clean_flush_turns_ms": states["clean"],
            "warm_turns_ms": states["warm"]}
        for state, c in states.items():
            cs.log(f"  prefix {name} {prefix!r} [{data.shape[0]}, {data.shape[1]}] from a "
                   f"{state} L2: previous {c[0]:.4f}, {c[3]:.4f} ms; current {c[1]:.4f}, "
                   f"{c[2]:.4f} ms (kernel device ms, in turns)")
    return out


def compare_leaf_lane(prev: dict, tconn, flush) -> dict:
    """The leaf-aggregation and lane-sums kernels, earlier against
    current, at the main path's splits and views of them."""
    sconn = SsbConnector(sf=1, device="cuda")

    def sql(conn_key, conn, text, **properties):
        return lambda: Session({conn_key: conn}, properties=properties, device="cuda").sql(text)

    # the sessions of chip_smoke's phases 7 (leaf route, narrow storage on), 8 and 9
    q6 = first_call(leaf_route, "agg_step",
                    sql("tpch", tconn, QUERIES["q6"], narrow_storage=True))
    ssb = first_call(leaf_route, "agg_step", sql("ssb", sconn, SSB["q1_1"], narrow_storage=True))
    li = tconn.table_numpy("lineitem", cs.Q6_COLS)
    want_rev = int(cs.revenue(li["l_extendedprice"], li["l_discount"],
                              cs.q6_mask(li))["revenue"][0])
    session = Session({"tpch": tconn}, properties={"narrow_storage": True}, device="cuda")
    res = cs.resident_q6(session, tconn, want_rev, cs.FACTOR)
    q1 = cs.q1_lane_inputs(tconn, q1_pipeline(tconn).source.capacity)
    phone = first_call(cuda_groupby, "fused_lane_sums", sql("ssb", sconn, SSB["q_like_phone"]))
    q4 = first_call(cuda_groupby, "fused_lane_sums", sql("tpch", tconn, QUERIES["q4"]))

    leaf_inputs = {"Q6 first split": q6, "Q6 first split, views": leaf_views(*q6),
                   "SSB Q1.1 first split": ssb, "SSB Q1.1 first split, views": leaf_views(*ssb),
                   f"resident Q6 SF1 x{cs.FACTOR}": (res["spec"], res["batch"])}
    lane_inputs = {"Q1 pipeline split": q1, "Q1 pipeline split, views": lane_views(*q1),
                   "q_like_phone first split": phone,
                   "q_like_phone first split, views": lane_views(*phone),
                   "Q4 first orders split": q4}
    shapes = [("leaf_agg", name, (lambda a=a: previous_leaf(prev["leaf_agg"], *a)),
               (lambda a=a: cuda_agg.agg_step(*a)), "leaf_", 20,
               cuda_agg.instance(a[0], [a[1][c].data for c in a[0].cols], a[1].live))
              for name, a in leaf_inputs.items()]
    shapes += [("lane_sums", name, (lambda a=a: previous_lane(prev["lane_sums"], *a)),
                (lambda a=a: cuda_groupby.fused_lane_sums(*a)), "lane_sums_kernel", 50,
                cuda_groupby.instance(a[0], a[2], a[3], a[4]))
               for name, a in lane_inputs.items()]
    out = {}
    for kernel, name, old, new, key, runs, inst in shapes:
        got_old, got_new = old(), new()
        if kernel == "lane_sums":
            got_old, got_new = cs.lane_dict(got_old), cs.lane_dict(got_new)
        cs.compare(got_new, got_old, f"{kernel} {name}: current against previous")
        t = [cs.device_ms(f, runs, flush, kernel=key) for f in (old, new, new, old)]
        out[f"{kernel} {name}"] = {"instance": inst, "turns_ms": t}
        cs.log(f"  {kernel} {name} ({inst}): previous {t[0]:.4f}, {t[3]:.4f} ms; current "
               f"{t[1]:.4f}, {t[2]:.4f} ms (kernel device ms, in turns)")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--leaf-lane", type=Path, help="an earlier commit's csrc (e170780)")
    parser.add_argument("--probes", type=Path, help="an earlier commit's csrc (17cb3ec)")
    parser.add_argument("--payload-like", type=Path, help="an earlier commit's csrc (0d9b82d)")
    parser.add_argument("--prefix", type=Path, help="an earlier commit's csrc (1bef9e0)")
    opts = parser.parse_args()
    if not (opts.leaf_lane or opts.probes or opts.payload_like or opts.prefix) \
            or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"card (name, power limit): {smi}")
    _build.build()
    tconn = TpchConnector(sf=1, device="cuda")
    flush = torch.empty(1 << 27, dtype=torch.int8, device="cuda")  # 128 MB > L2
    out, previous = {}, {}
    if opts.leaf_lane:
        previous["leaf_lane"] = str(opts.leaf_lane)
        out.update(compare_leaf_lane(load_previous(opts.leaf_lane, ("leaf_agg", "lane_sums")),
                                     tconn, flush))
    if opts.probes:
        previous["probes"] = str(opts.probes)
        out.update(compare_probes(load_previous(opts.probes, ("join_probe",)), tconn, flush))
    if opts.payload_like:
        previous["payload_like"] = str(opts.payload_like)
        prev = load_previous(opts.payload_like, ("join_probe", "strings"))
        out.update(compare_payload(prev, tconn, flush))
        out.update(compare_like(prev, tconn, flush))
    if opts.prefix:
        previous["prefix"] = str(opts.prefix)
        out.update(compare_prefix(load_previous(opts.prefix, ("strings",)), tconn, flush))
    print(smi)
    print(json.dumps({"card": smi, "previous": previous, "shapes": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
