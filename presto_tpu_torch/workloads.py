"""Hand-built physical plans for the benchmark workloads.

Counterpart of ``presto_tpu/workloads.py``: the Q1 leaf fragment as one
fused step (``q1_fused_step``) and as an operator pipeline
(``q1_pipeline``), without the SQL front end; the benchmark's resident
Q3 join step (``q3_probe_table`` + ``q3_probe_step``: orders bitmask,
shipdate filter and revenue in one pass, the JAX package's
``bench.py`` ``bench_q3_join`` primary); and the ``part`` name
filter of TPC-H Q20's inner query, ``starts_with(p_name, 'forest')``, as
a scan -> FilterProject pipeline (``part_name_pipeline``): the SQL
analyzer has no ``starts_with``, so this is where the prefix kernel is
reached, as in the JAX package.
"""

from __future__ import annotations

import torch

from presto_tpu_torch.batch import Batch
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.exec.operators import (
    AggSpec,
    DirectStrategy,
    FilterProjectOperator,
    HashAggregationOperator,
)
from presto_tpu_torch.exec.pipeline import Pipeline, ScanSource
from presto_tpu_torch.expr import Call, col, evaluate, evaluate_predicate, lit
from presto_tpu_torch.ops import cuda_join, cuda_q1
from presto_tpu_torch.ops.groupby import fused_small_sums, group_ids_direct
from presto_tpu_torch.runtime.errors import InternalError
from presto_tpu_torch.types import BIGINT, BOOLEAN, DATE, decimal, fixed_bytes, varchar

dec2 = decimal(12, 2)
dec4 = decimal(38, 4)

Q1_COLS = [
    "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
    "l_discount", "l_tax", "l_shipdate",
]
Q1_CUTOFF = "1998-09-02"  # date '1998-12-01' - interval '90' day
Q1_GROUPS = 6  # |returnflag| x |linestatus| = 3 x 2


def q1_exprs():
    one = lit(1, dec2)
    disc_price = Call(
        dec4, "mul",
        (col("l_extendedprice", dec2), Call(dec2, "sub", (one, col("l_discount", dec2)))),
    )
    charge = Call(dec4, "mul", (disc_price, Call(dec2, "add", (one, col("l_tax", dec2)))))
    pred = Call(BOOLEAN, "le", (col("l_shipdate", DATE), lit(Q1_CUTOFF, DATE)))
    return pred, disc_price, charge


# Per-row |value| bit bounds from the TPC-H spec data ranges: quantity
# <= 50.00 (scaled 5e3 -> 13 bits), extendedprice <= ~105k (scaled
# ~1.05e7 -> 24 bits), disc_price/charge at scale 4 (31 bits), discount
# (7 bits, matching the Q1 kernel's [0, 100] guard).
Q1_BITS = {"sum_qty": 13, "sum_base_price": 24, "sum_disc_price": 31,
           "sum_charge": 31, "sum_disc": 7}


def q1_aggs():
    _, disc_price, charge = q1_exprs()
    return [
        AggSpec("sum", col("l_quantity", dec2), "sum_qty", decimal(38, 2),
                value_bits=Q1_BITS["sum_qty"]),
        AggSpec("sum", col("l_extendedprice", dec2), "sum_base_price",
                decimal(38, 2), value_bits=Q1_BITS["sum_base_price"]),
        AggSpec("sum", disc_price, "sum_disc_price", dec4,
                value_bits=Q1_BITS["sum_disc_price"]),
        AggSpec("sum", charge, "sum_charge", dec4,
                value_bits=Q1_BITS["sum_charge"]),
        AggSpec("count_star", None, "count_order", BIGINT),
    ]


def q1_strategy() -> DirectStrategy:
    return DirectStrategy((0, 0), (2, 1), Q1_GROUPS)


def part_name_pipeline(conn: TpchConnector, fn: str = "starts_with",
                       pattern: str = "forest") -> Pipeline:
    """scan part -> FilterProject keeping ``p_partkey`` of the rows where
    ``fn(p_name, pattern)`` holds (``starts_with`` or ``like``), on the
    connector's device."""
    name = col("p_name", fixed_bytes(55))
    pred = Call(BOOLEAN, fn, (name, lit(pattern, varchar())))
    return Pipeline(ScanSource(conn, "part", ["p_partkey", "p_name"]),
                    [FilterProjectOperator(pred, {"p_partkey": col("p_partkey", BIGINT)})])


def q1_pipeline(conn: TpchConnector) -> Pipeline:
    """scan lineitem -> filter -> direct-addressed hash aggregation, on
    the connector's device."""
    pred, _, _ = q1_exprs()
    return Pipeline(
        ScanSource(conn, "lineitem", Q1_COLS),
        [
            FilterProjectOperator(pred, None),
            HashAggregationOperator(
                [("l_returnflag", col("l_returnflag", varchar())),
                 ("l_linestatus", col("l_linestatus", varchar()))],
                q1_aggs(), q1_strategy(), device=conn.device,
            ),
        ],
    )


def q1_fused_step(batch: Batch) -> dict:
    """One fully-fused Q1 partial-aggregation step over a batch.

    Returns a dict of [6] tensors per (returnflag x linestatus) group:
    int64 sums, ``count_order``, bool ``present``, and a bool scalar
    ``value_overflow`` guarding the declared bounds.

    A CUDA batch that passes ``cuda_q1.supported`` runs the whole
    fragment as the Q1 kernel; every other batch takes the generic route
    below (expressions, direct gids, ``fused_small_sums``), as the JAX
    package does off the TPU.
    """
    if batch.device.type == "cuda" and cuda_q1.supported(batch):
        return cuda_q1.q1_step(batch)

    pred, disc_price, charge = q1_exprs()
    live = batch.live & evaluate_predicate(pred, batch)
    gids, _ = group_ids_direct(
        [batch["l_returnflag"].data, batch["l_linestatus"].data],
        (0, 0), (2, 1), live, Q1_GROUPS,
    )
    qty = batch["l_quantity"].data
    ep = batch["l_extendedprice"].data
    disc = batch["l_discount"].data
    dp = evaluate(disc_price, batch).data
    ch = evaluate(charge, batch).data
    names = ["sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
             "sum_disc"]
    sums, counts, _, oflow = fused_small_sums(
        [qty, ep, dp, ch, disc],
        [Q1_BITS[n] for n in names],
        [live] * 5,
        gids,
        Q1_GROUPS,
    )
    out = dict(zip(names, sums))
    out["present"] = counts[0] > 0
    out["count_order"] = counts[0]
    out["value_overflow"] = oflow
    return out


def combine_q1_states(a: dict, b: dict) -> dict:
    bool_keys = ("present", "value_overflow")
    out = {k: a[k] + b[k] for k in a if k not in bool_keys}
    for k in bool_keys:
        out[k] = a[k] | b[k]
    return out


def allreduce_state(state_parts: list) -> dict:
    """All-reduce per-shard leaf states onto the first shard's device:
    booleans OR (a psum of their int32 casts > 0), ``min*`` / ``max*``
    keys take the min / max (a sum of min/max partials with their
    identity fills would be garbage), everything else sums (int64)."""
    home = next(iter(state_parts[0].values())).device
    out = {}
    for key in state_parts[0]:
        xs = [p[key].to(home) for p in state_parts]
        acc = xs[0]
        for x in xs[1:]:
            if acc.dtype == torch.bool:
                acc = acc | x
            elif key.startswith("min"):
                acc = torch.minimum(acc, x)
            elif key.startswith("max"):
                acc = torch.maximum(acc, x)
            else:
                acc = acc + x
        out[key] = acc
    return out


def q1_distributed_step(mesh):
    """The data-parallel Q1 step: a row-sharded batch (``parallel/
    mesh.py`` layout) -> the replicated [6]-group state. Each shard runs
    ``q1_fused_step`` (the Q1 kernel on a CUDA shard) and the partial
    states all-reduce."""
    from presto_tpu_torch.parallel.mesh import shards_of

    def step(batch: Batch) -> dict:
        return allreduce_state([q1_fused_step(b) for b in shards_of(batch, mesh)])

    return step


def q1_batch(conn: TpchConnector, split=None, capacity=None) -> Batch:
    splits = conn.splits("lineitem")
    s = split if split is not None else splits[0]
    return conn.scan(s, Q1_COLS, capacity)


#: the Q3 join's columns on the probe side, in ``q3_probe_step`` order
Q3_COLS = ["l_orderkey", "l_shipdate", "l_extendedprice", "l_discount"]
Q3_CUTOFF = 9204  # date '1995-03-15'
#: o_orderkey's first value: the Q3 bitmask covers [Q3_KEY_MIN, domain]
Q3_KEY_MIN = 1


def q3_domain(sf: float) -> int:
    """The Q3 bitmask's key bound at scale factor ``sf``: o_orderkey is
    in [1, 6M * sf] (the connector's stats), plus one, as the JAX
    package's benchmark sizes it."""
    return int(6_000_000 * sf) + 1


def q3_probe_table(orders_batch: Batch, cutoff: int, domain: int) -> torch.Tensor:
    """The Q3 build: an exists bitmask over [1, domain] of the orders
    with ``o_orderdate < cutoff``, padded to the JAX package's partition
    words (``cuda_join.q3_partitions``). Raises when a live key falls
    outside the domain (the stats would be wrong)."""
    live = orders_batch.live & (orders_batch["o_orderdate"].data.to(torch.int32) < cutoff)
    w, nparts = cuda_join.q3_partitions(domain)
    table, oob = cuda_join.build_exists_table(orders_batch["o_orderkey"].data, live,
                                              Q3_KEY_MIN, domain, pad_words=w * nparts)
    if bool(oob):
        raise InternalError(f"an o_orderkey falls outside [{Q3_KEY_MIN}, {domain}]")
    return table


def q3_probe_step(table: torch.Tensor, key_min: int, domain: int, cutoff: int,
                  lineitem_batch: Batch):
    """One fused Q3 join step over a ``lineitem`` batch of ``Q3_COLS``:
    (matched count, revenue = sum ep * (100 - disc) at scale 4), int64
    0-d tensors. The join-probe kernel on a CUDA batch, its plain
    version on the CPU."""
    b = lineitem_batch
    return cuda_join.q3_probe_step(table, key_min, domain, cutoff,
                                   *[b[c].data for c in Q3_COLS], b.live)
