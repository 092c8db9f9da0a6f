"""Time the leaf-aggregation and lane-sums kernels against an earlier
commit's, on one card, in turns.

Run from the root of a checkout, with an earlier commit's kernel sources
unpacked under ``local/`` (which ``.gitignore`` lists)::

    mkdir -p local/prev
    git archive e170780 presto_tpu_torch/csrc | tar -x -C local/prev
    python3 -m presto_tpu_torch.tools.compare_previous local/prev/presto_tpu_torch/csrc

The earlier sources must come from a commit whose ``leaf_agg_launch``
and ``lane_sums_launch`` take no instance argument (e170780 and before,
the kernels before their Hopper redesign). They are built with this
checkout's nvcc flags into ``build/`` beside them. The inputs are the
main path's, taken from the first call of each kernel in SF1 queries
through ``Session.sql``: the first Q6 and SSB Q1.1 splits and a resident
SF1 x10 ``lineitem`` for the leaf kernel; the first Q1 pipeline,
``q_like_phone`` and Q4 ``orders`` splits for the lane-sums kernel. Each
split is taken once more with its columns copied into views one element
into their buffers, which this checkout reads with its direct instance.
For each input both versions must return the same result, and the
kernel's device ms is printed in turns: previous, current, current,
previous (the profiler's trace, cold L2, as ``chip_smoke.device_ms``).
The last line is one JSON object of those times. Needs one CUDA card.
"""

from __future__ import annotations

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
from presto_tpu_torch.ops import _build, cuda_agg, cuda_groupby
from presto_tpu_torch.runtime.session import Session
from presto_tpu_torch.workloads import q1_pipeline

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def load_previous(csrc: Path) -> dict:
    """The earlier commit's launch entries, built from ``csrc`` (one
    nvcc per source, in parallel)."""
    out = csrc.parent / "build"
    out.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
         str(csrc / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in ("leaf_agg", "lane_sums")}
    fns = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"previous {name} did not build:\n{text}")
        cs.log_ptxas(f"previous {name}", text)
        fns[name] = getattr(ctypes.CDLL(str(out / f"lib{name}.so")), f"{name}_launch")
        fns[name].restype = _I
    fns["leaf_agg"].argtypes = [_P, _P, _I, _P, _P, _I, _I, _P, _LL, _P, _P]
    fns["lane_sums"].argtypes = [_P, _P, _I, _P, _I, _P, _I, _LL, _P, _P]
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


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"card (name, power limit): {smi}")
    _build.build()
    prev = load_previous(Path(sys.argv[1]))

    tconn = TpchConnector(sf=1, device="cuda")
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
    flush = torch.empty(1 << 27, dtype=torch.int8, device="cuda")  # 128 MB > L2
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
    print(smi)
    print(json.dumps({"card": smi, "previous": sys.argv[1], "shapes": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
