"""Join operators: build side + lookup probe (unique builds, semi/anti).

Counterpart of ``presto_tpu/exec/joins.py``. ``JoinBuildOperator``
collects the build side and publishes its lookup source at ``finish()``:
the sorted keys (``ops/join.build_lookup``), a dense direct-address table
when the planner's stats bound the key domain, and the fused-probe
tables of ``ops/cuda_join`` when the planner chose that route (the exists
bitmask, the payload tables, or under ``approx_join`` the Bloom sketch).
``LookupJoinOperator`` probes each batch on the best published side:

- ``pallas``: the join-probe kernels (the JAX package's name for the
  route, kept so the plans and counters compare one to one);
- ``dense``: one gather from the dense table;
- ``unique``: a binary search in the sorted keys.

Semi and anti joins (``IN`` / ``EXISTS`` and their negations) keep a
probe row when its key exists (semi) or does not (anti) on the build
side: the membership probes ``ops/join.probe_exists[_dense]``, or the
exists or sketch kernels, whose ``_keep`` wrappers return the new live
mask from one launch per batch; inner and left joins on the payload
tables also take one launch per batch (``payload_keep``: the key's
validity, the values in their storage types and the inner join's live
mask). As in the JAX package, an anti join keeps a probe row whose key
is NULL, a NULL build key matches nothing, and the sketch (false
positives) serves semi joins only, and only on a batch whose capacity
the JAX package's kernel could block (``probe_block``).

Stats are advisory. A live build key outside the planned domain, or a
NULL in a payload column, discards the fused tables at build time
(``join.pallas_fallback``) and the probe takes the next side — counted,
never wrong. Every route gives the same rows. Each probe operator
counts its route once as ``join.strategy.<route>`` in
``runtime.metrics.COUNTERS``, and the fused one also as
``exec.pallas_join_route``.

Inner and left outer joins whose build keys may repeat take the
expansion probe (``ops/join.probe_expand``): one output row per matching
pair, a left join's unmatched probe rows (a NULL key among them)
null-extended, into a static ``out_capacity`` that raises
``CapacityOverflow`` when a batch needs more (the planner doubles it and
probes the batch again). Its strategy counts as ``join.strategy.expand``.

Ported join kinds: inner and left outer joins, and semi and anti joins.
By-value verify pairs, FULL OUTER and RIGHT joins and the runtime Bloom
filters are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.exec.operators import (
    CapacityOverflow,
    CollectingOperator,
    Operator,
    concat_batches,
    valid_of,
)
from presto_tpu_torch.expr import Expr, InputRef, evaluate
from presto_tpu_torch.ops import cuda_join
from presto_tpu_torch.ops.groupby import gather_padded
from presto_tpu_torch.ops.join import (
    I64_MAX,
    build_dense,
    build_lookup,
    probe_exists,
    probe_exists_dense,
    probe_expand,
    probe_unique,
    probe_unique_dense,
)
from presto_tpu_torch.runtime.errors import NotSupported
from presto_tpu_torch.runtime.metrics import COUNTERS
from presto_tpu_torch.spi import batch_capacity


class JoinBuildOperator(CollectingOperator):
    """Collects the build side; ``finish()`` publishes the lookup source
    (sorted keys + payload batch, and the dense and fused sides when
    planned). The probe operator holds a reference to it."""

    def __init__(
        self,
        key: Expr,
        dense_domain: tuple[int, int] | None = None,
        pallas: cuda_join.PallasJoinSpec | None = None,
    ):
        """``dense_domain``: optional (key_min, domain) from planner
        stats — a dense direct-address table is built beside the sorted
        keys; a live key outside it discards the dense side.

        ``pallas``: the planner's fused-probe spec — the lookup tables
        of ``ops/cuda_join`` are built beside the sorted side (a sketch
        spec builds the Bloom words, which never fall back)."""
        super().__init__()
        self.key = key
        self.dense_domain = dense_domain
        self.pallas = pallas
        self.build_side = None
        self.dense_side = None
        self.pallas_side: tuple | None = None
        self.payload: Batch | None = None
        self.key_dict = None

    def _eligible_pallas_spec(self, batch: Batch):
        """The planner's spec is stats-based; storage is only visible
        now. Payload columns must be 1-D integers of at most 32 bits
        (the narrow scan representation) — anything else falls back."""
        spec = self.pallas
        if spec is not None and spec.mode == "payload":
            for c in spec.payload:
                data = batch[c].data if c in batch else None
                if data is None or data.dim() != 1 or not cuda_join.key_dtype_ok(data.dtype):
                    spec = None
                    break
        if spec is None and self.pallas is not None:
            COUNTERS["join.pallas_fallback"] += 1
            self.pallas = None
        return spec

    def finish(self) -> list[Batch]:
        if not self.batches:
            raise NotSupported("an empty join build side is not ported yet")
        batch = concat_batches(self.batches)
        v = evaluate(self.key, batch)
        live = batch.live & valid_of(v.valid, batch.live)
        side = build_lookup(v.data, live, batch_capacity(batch.capacity, minimum=16))
        dd = self.dense_domain
        dense = build_dense(v.data, live, dd[0], dd[1]) if dd else None
        spec = self._eligible_pallas_spec(batch)
        if spec is not None:
            if spec.mode == "exists":
                table, oob = cuda_join.build_exists_table(
                    v.data, live, spec.key_min, spec.key_max)
                tables, bad = (table,), oob
            elif spec.mode == "sketch":
                tables = (cuda_join.build_sketch_table(v.data, live, spec.nbits),)
                bad = False
            else:
                # a live payload NULL has no slot in the value tables:
                # discard the fused side rather than conjure a 0
                cols = [batch[c] for c in spec.payload]
                pnull = torch.stack([(live & ~valid_of(c.valid, live)).any() for c in cols]).any()
                tables, oob = cuda_join.build_payload_tables(
                    v.data, live, spec.key_min, spec.key_max, [c.data for c in cols])
                bad = oob | pnull
            if bool(bad):
                COUNTERS["join.pallas_fallback"] += 1
                self.pallas = None
            else:
                self.pallas_side = tables
        if bool(side.sentinel_hit):
            raise NotSupported(
                f"a join build key equals the reserved int64 sentinel ({I64_MAX}); such "
                "keys are indistinguishable from dead slots and would silently lose "
                "their matches")
        self.build_side = side
        # dictionary provenance for the probe-side guard: dictionary
        # codes are only comparable within ONE dictionary
        self.key_dict = (batch[self.key.name].dictionary
                         if isinstance(self.key, InputRef) and self.key.name in batch
                         else None)
        if dense is not None and not bool(dense.overflow):
            self.dense_side = dense
        self.payload = batch
        return []


@dataclass(frozen=True)
class BuildOutput:
    """One build-side payload column to emit: (source col, output name)."""

    source: str
    name: str


class LookupJoinOperator(Operator):
    """Probe operator. join_type: inner | left | semi | anti (membership,
    duplicate build keys fine).

    - unique=True: FK->PK, each probe row matches at most one build row;
      the output stays aligned with the probe batch. The planner sets it
      only when the build keys are unique.
    - unique=False (inner and left): the expansion probe into
      ``out_capacity`` rows."""

    def __init__(self, build: JoinBuildOperator, probe_key: Expr,
                 build_outputs: Sequence[BuildOutput] = (), join_type: str = "inner",
                 unique: bool = True, out_capacity: int | None = None):
        if join_type not in ("inner", "left", "semi", "anti"):
            raise NotSupported(f"{join_type} joins are not ported yet")
        if not unique and join_type in ("inner", "left") and out_capacity is None:
            raise NotSupported("an expansion join needs an output capacity")
        self.build = build
        self.probe_key = probe_key
        self.build_outputs = list(build_outputs)
        self.join_type = join_type
        self.unique = unique
        self.out_capacity = out_capacity
        self._strategy = None

    def _record_strategy(self, name: str):
        """Count the chosen probe strategy once per operator."""
        if self._strategy is None:
            self._strategy = name
            COUNTERS[f"join.strategy.{name}"] += 1
            if name == "pallas":
                COUNTERS["exec.pallas_join_route"] += 1

    def _pallas_usable(self, batch: Batch) -> bool:
        """Per-batch routing: the build published fused tables, the mode
        serves this join type, AND this batch's key is a narrow integer
        column. The exact kernels take any capacity (ROADMAP C4); the
        sketch keeps the JAX package's capacity-block rule, because it
        changes results: it must approximate exactly the batches the
        JAX package's does."""
        build, spec = self.build, self.build.pallas
        if build.pallas_side is None or spec is None:
            return False
        jt = self.join_type
        if spec.mode == "payload":
            if not (self.unique and jt in ("inner", "left")):
                return False
            if spec.payload != tuple(bo.source for bo in self.build_outputs):
                return False
        elif spec.mode == "exists":
            # existence is duplicate-safe (semi/anti); a no-payload inner
            # join also needs unique build keys (duplicates multiply rows)
            if not (jt in ("semi", "anti")
                    or (self.unique and jt == "inner" and not self.build_outputs)):
                return False
        elif jt != "semi":
            # sketch: a false positive ADDS a semi-join row, but would
            # DROP an anti-join row
            return False
        k = self.probe_key
        if not (isinstance(k, InputRef) and k.name in batch
                and cuda_join.key_dtype_ok(batch[k.name].data.dtype)):
            return False
        return spec.mode != "sketch" or cuda_join.probe_block(batch.capacity) is not None

    def _pallas_probe(self, batch: Batch) -> Batch:
        spec, tables = self.build.pallas, self.build.pallas_side
        v = evaluate(self.probe_key, batch)
        # the kernels fold the key's validity into their launch; a
        # validity that IS the live mask adds nothing (live && live)
        valid = None if v.valid is batch.live else v.valid
        if spec.mode != "payload":
            # the kernel also folds the keep rule in and returns the new
            # live mask
            live = (cuda_join.sketch_keep(tables[0], spec.nbits, v.data, batch.live, valid)
                    if spec.mode == "sketch" else
                    cuda_join.exists_keep(tables[0], spec.key_min, spec.key_max, v.data,
                                          batch.live, valid, self.join_type == "anti"))
            return batch.with_live(live)
        # one launch: the key's validity, each value in its build column's
        # storage type, and the inner join's new live mask (a tensor of
        # its own; a left join keeps batch.live)
        srcs = [self.build.payload[bo.source] for bo in self.build_outputs]
        matched, vals, live = cuda_join.payload_keep(
            tables, spec.key_min, spec.key_max, v.data, batch.live, valid,
            [src.data.dtype for src in srcs], self.join_type == "inner")
        cols = dict(batch.columns)
        for bo, src, pv in zip(self.build_outputs, srcs, vals):
            # payload NULL-freedom was proven at build, so validity is
            # exactly the match mask
            cols[bo.name] = Column(pv, matched, src.dtype, src.dictionary)
        return Batch(cols, live)

    def _check_probe_dict(self, batch: Batch):
        """Joining code spaces of two DIFFERENT dictionaries would be
        silently wrong: refuse."""
        k = self.probe_key
        if not (isinstance(k, InputRef) and k.name in batch):
            return
        pdict, bdict = batch[k.name].dictionary, self.build.key_dict
        if pdict is not None and bdict is not None and pdict is not bdict:
            raise NotSupported("join keys are encoded against different dictionaries; "
                               "codes are not comparable across dictionaries")

    def process(self, batch: Batch) -> list[Batch]:
        build = self.build
        if build.build_side is None:
            raise RuntimeError("build side not finished")
        self._check_probe_dict(batch)
        if self._pallas_usable(batch):
            self._record_strategy("pallas")
            return [self._pallas_probe(batch)]
        if build.pallas_side is not None:
            # the build published fused tables but THIS batch cannot
            # ride them (key storage): degrade loudly
            COUNTERS["join.pallas_fallback"] += 1
        v = evaluate(self.probe_key, batch)
        plive = batch.live & valid_of(v.valid, batch.live)
        if self.join_type in ("semi", "anti"):
            if build.dense_side is not None:
                self._record_strategy("dense")
                exists = probe_exists_dense(build.dense_side, v.data, plive)
            else:
                self._record_strategy("unique")
                exists = probe_exists(build.build_side, v.data, plive)
            keep = exists if self.join_type == "semi" else batch.live & ~exists
            return [batch.with_live(batch.live & keep)]
        if not self.unique:
            self._record_strategy("expand")
            out, overflow = self._expand(batch, v, plive)
            if bool(overflow):
                raise CapacityOverflow("LookupJoin", self.out_capacity)
            return [out]
        if build.dense_side is not None:
            self._record_strategy("dense")
            res = probe_unique_dense(build.dense_side, v.data, plive)
        else:
            self._record_strategy("unique")
            res = probe_unique(build.build_side, v.data, plive)
        cols = dict(batch.columns)
        for bo in self.build_outputs:
            src = build.payload[bo.source]
            data = gather_padded(src.data, res.build_row, 0)
            valid = gather_padded(valid_of(src.valid, build.payload.live), res.build_row, False)
            cols[bo.name] = Column(data, valid & res.matched, src.dtype, src.dictionary)
        live = batch.live & res.matched if self.join_type == "inner" else batch.live
        return [Batch(cols, live)]

    def _expand(self, batch: Batch, v, plive: torch.Tensor):
        """(the expanded batch, overflow): every probe column gathered by
        probe row and every build output by build row, a miss giving an
        invalid value (a left join's null-extended rows)."""
        build = self.build
        res = probe_expand(build.build_side, v.data, plive, self.out_capacity,
                           left=self.join_type == "left", emit_live=batch.live)
        cols = {}
        for name, src in batch.columns.items():
            cols[name] = Column(gather_padded(src.data, res.probe_row, 0),
                                gather_padded(valid_of(src.valid, batch.live), res.probe_row,
                                              False),
                                src.dtype, src.dictionary)
        for bo in self.build_outputs:
            src = build.payload[bo.source]
            cols[bo.name] = Column(gather_padded(src.data, res.build_row, 0),
                                   gather_padded(valid_of(src.valid, build.payload.live),
                                                 res.build_row, False),
                                   src.dtype, src.dictionary)
        return Batch(cols, res.live), res.overflow
