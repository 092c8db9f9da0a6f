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
``runtime.metrics.REGISTRY``, and the fused one also as
``exec.pallas_join_route``. The build runs in a ``step:join_build``
span and each probe batch in a ``step:probe_<join type>`` one.

Inner and left outer joins whose build keys may repeat take the
expansion probe (``ops/join.probe_expand``): one output row per matching
pair, a left join's unmatched probe rows (a NULL key among them)
null-extended, into a static ``out_capacity`` that raises
``CapacityOverflow`` when a batch needs more (the planner doubles it and
probes the batch again). Its strategy counts as ``join.strategy.expand``.

Hash keys (a wide BYTES key's ``bytes_hash``, the multi-key
``hash63_mix``) are not injective, so their joins carry ``verify`` pairs
that the probe re-checks on the original values (PAD SPACE): the unique
probe scans each key's collision run, at most ``VERIFY_CANDIDATES``
wide (a build with a longer run is refused), and the inner expansion
probe drops a pair whose values differ. Such joins never take the fused
route.

FULL OUTER joins probe with LEFT semantics while a matched-flags array
over the build rows accumulates (``process_full``); after the probe
stream, ``full_tail`` emits the never-matched build rows with NULL probe
columns. A RIGHT join reaches here as a LEFT join with its sides swapped.

With ``filter_bits`` the build also publishes the runtime join filter's
products, the live build keys' (min, max) and a two-hash Bloom bitmask
(``filter_minmax``, ``filter_bloom``), which the executor pushes into
the probe-side scan. A key below 2^(62 - pack_bits) that the stats
prove non-negative sorts packed with its row (``key_max``), so the
unique sorted probe takes one gather.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.cache.exec_cache import EXEC_CACHE
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
from presto_tpu_torch.ops.hashing import bloom_build
from presto_tpu_torch.ops.join import (
    I64_MAX,
    UniqueProbe,
    build_dense,
    build_lookup,
    probe_exists,
    probe_exists_dense,
    probe_expand,
    probe_unique,
    probe_unique_dense,
)
from presto_tpu_torch.runtime.errors import InternalError, NotSupported
from presto_tpu_torch.runtime.metrics import REGISTRY
from presto_tpu_torch.runtime.trace import span as trace_span
from presto_tpu_torch.spi import batch_capacity

#: candidate window a verified unique probe scans per probe row: covers
#: collision runs of up to this many equal hashed keys
VERIFY_CANDIDATES = 4


def _pad_sp(d: torch.Tensor) -> torch.Tensor:
    """PAD SPACE for BYTES equality: zero padding compares as spaces."""
    if d.dim() > 1:
        return torch.where(d == 0, torch.full_like(d, 32), d)
    return d


def long_dup_runs_flag(sorted_keys: torch.Tensor) -> torch.Tensor:
    """0-d bool: some non-sentinel key run is longer than
    ``VERIFY_CANDIDATES`` (a verified probe would miss its tail)."""
    k = VERIFY_CANDIDATES
    sk = sorted_keys
    return ((sk[k:] == sk[:-k]) & (sk[k:] != I64_MAX)).any()


def verify_mask(verify, probe_batch: Batch, payload: Batch, build_row: torch.Tensor,
                probe_row: torch.Tensor | None = None, init: torch.Tensor | None = None):
    """AND of the by-value equality checks of the verify pairs: each
    probe value against the build payload's value at ``build_row``
    (PAD SPACE). With ``probe_row`` the probe side is gathered too; the
    fills differ (0 and 1), so a row past either end never compares
    equal."""
    mask = init
    for pe, be in verify:
        pd_ = _pad_sp(evaluate(pe, probe_batch).data)
        if probe_row is not None:
            pd_ = gather_padded(pd_, probe_row, 0)
        bd = gather_padded(_pad_sp(evaluate(be, payload).data), build_row, 1)
        eq = pd_ == bd
        if eq.dim() > 1:
            eq = eq.all(dim=1)
        mask = eq if mask is None else (mask & eq)
    return mask


class JoinBuildOperator(CollectingOperator):
    """Collects the build side; ``finish()`` publishes the lookup source
    (sorted keys + payload batch, and the dense and fused sides when
    planned). The probe operator holds a reference to it."""

    def __init__(
        self,
        key: Expr,
        dense_domain: tuple[int, int] | None = None,
        pallas: cuda_join.PallasJoinSpec | None = None,
        key_max: int | None = None,
        filter_bits: int = 0,
        capacity: int | None = None,
    ):
        """``dense_domain``: optional (key_min, domain) from planner
        stats — a dense direct-address table is built beside the sorted
        keys; a live key outside it discards the dense side.

        ``pallas``: the planner's fused-probe spec — the lookup tables
        of ``ops/cuda_join`` are built beside the sorted side (a sketch
        spec builds the Bloom words, which never fall back).

        ``key_max``: a stats upper bound on a NON-NEGATIVE key; when its
        bits and the capacity's fit 62, the sorted side packs key and
        row into one int64. A live key past the bound refuses the query
        (stale stats) rather than mispack.

        ``filter_bits``: when > 0, the build also publishes the runtime
        join filter's (min, max) and a Bloom bitmask of this many bits.

        ``capacity``: the sorted side's capacity (default: the build
        batch's bucket); the spill tier builds every resident set and
        streamed unit at one shared capacity. A spill unit re-finishes
        the same operator after replacing ``batches`` and clearing
        ``build_side``."""
        super().__init__()
        self.key = key
        self.dense_domain = dense_domain
        self.pallas = pallas
        self.key_max = key_max
        self.filter_bits = filter_bits
        self.capacity = capacity
        self.pack_bits: int | None = None
        self.build_side = None
        self.dense_side = None
        self.pallas_side: tuple | None = None
        #: (min, max) 0-d tensors over the live build keys, and the Bloom
        #: words: the runtime join filter's products
        self.filter_minmax = None
        self.filter_bloom = None
        self.payload: Batch | None = None
        self.key_dict = None
        self._long_dup_runs: bool | None = None

    @property
    def long_dup_runs(self) -> bool:
        """Some sorted-key run is longer than ``VERIFY_CANDIDATES``: a
        verified probe scans a fixed candidate window per probe row, so
        it refuses such a build rather than mis-probe it. Read back once,
        when a verified probe first asks."""
        if self._long_dup_runs is None:
            self._long_dup_runs = bool(long_dup_runs_flag(self.build_side.sorted_keys))
        return self._long_dup_runs

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
            REGISTRY.counter("join.pallas_fallback").add()
            self.pallas = None
        return spec

    def _apply_build(self, spec, tables, bad, filt) -> None:
        """Take the build step's fused tables and runtime-filter
        products."""
        if spec is not None:
            if bool(bad):
                REGISTRY.counter("join.pallas_fallback").add()
                self.pallas = None
            else:
                self.pallas_side = tables
        if filt is not None:
            self.filter_minmax = (filt[0], filt[1])
            self.filter_bloom = filt[2]

    def finish(self) -> list[Batch]:
        if not self.batches:
            raise NotSupported("an empty join build side is not ported yet")
        batch = concat_batches(self.batches)
        if self.key_max is not None and self.key_max >= 0:
            pb = int(batch.capacity).bit_length()
            if int(self.key_max).bit_length() + pb <= 62:
                self.pack_bits = pb
        cap = self.capacity or batch_capacity(batch.capacity, minimum=16)
        spec = self._eligible_pallas_spec(batch)
        # shared across queries: the step bakes in only (key expr,
        # capacity, dense domain, pack bits, fused spec, filter bits),
        # all in the content key
        build = EXEC_CACHE.get_or_build(
            EXEC_CACHE.key_of("join_build", self.key, cap, self.dense_domain, self.pack_bits,
                              spec, self.filter_bits),
            lambda: _join_build_step(self.key, cap, self.dense_domain, self.pack_bits, spec,
                                     self.filter_bits))
        with trace_span("step:join_build", "step", {"capacity": cap}):
            side, dense, tables, bad, filt = build(batch)
            self._apply_build(spec, tables, bad, filt)
        if bool(side.sentinel_hit):
            if self.pack_bits is not None:
                raise NotSupported(
                    "a join build key violated its advisory stats bound "
                    f"(key_max={self.key_max}, pack_bits={self.pack_bits}: "
                    f"packable range is [0, 2^{62 - self.pack_bits})) — "
                    "stale or wrong connector stats")
            raise NotSupported(
                f"a join build key equals the reserved int64 sentinel ({I64_MAX}); such "
                "keys are indistinguishable from dead slots and would silently lose "
                "their matches")
        self.build_side = side
        self._long_dup_runs = None
        # dictionary provenance for the probe-side guard: dictionary
        # codes are only comparable within ONE dictionary
        self.key_dict = (batch[self.key.name].dictionary
                         if isinstance(self.key, InputRef) and self.key.name in batch
                         else None)
        if dense is not None and not bool(dense.overflow):
            self.dense_side = dense
        self.payload = batch
        return []


def _join_build_step(key: Expr, cap: int, dd, pack_bits, spec, fbits: int):
    """The build's device work over the concatenated build batch: (the
    sorted lookup side, the dense table, the fused tables, whether they
    must be discarded, the runtime filter's (min, max, Bloom words))."""

    def step(batch: Batch):
        v = evaluate(key, batch)
        live = batch.live & valid_of(v.valid, batch.live)
        side = build_lookup(v.data, live, cap, pack_bits=pack_bits)
        dense = build_dense(v.data, live, dd[0], dd[1]) if dd else None
        tables, bad = None, False
        if spec is not None:
            if spec.mode == "exists":
                table, bad = cuda_join.build_exists_table(v.data, live, spec.key_min,
                                                          spec.key_max)
                tables = (table,)
            elif spec.mode == "sketch":
                tables = (cuda_join.build_sketch_table(v.data, live, spec.nbits),)
            else:
                # a live payload NULL has no slot in the value tables:
                # discard the fused side rather than conjure a 0
                cols = [batch[c] for c in spec.payload]
                pnull = torch.stack([(live & ~valid_of(c.valid, live)).any() for c in cols]).any()
                tables, oob = cuda_join.build_payload_tables(
                    v.data, live, spec.key_min, spec.key_max, [c.data for c in cols])
                bad = oob | pnull
        filt = None
        if fbits:
            k64 = v.data.to(torch.int64)
            filt = (torch.where(live, k64, torch.full_like(k64, I64_MAX)).min(),
                    torch.where(live, k64, torch.full_like(k64, -I64_MAX - 1)).max(),
                    bloom_build(v.data, live, fbits))
        return side, dense, tables, bad, filt

    return step


@dataclass(frozen=True)
class BuildOutput:
    """One build-side payload column to emit: (source col, output name)."""

    source: str
    name: str


class LookupJoinOperator(Operator):
    """Probe operator. join_type: inner | left | full | semi | anti
    (membership, duplicate build keys fine); a full join probes through
    ``process_full``.

    - unique=True: FK->PK, each probe row matches at most one build row;
      the output stays aligned with the probe batch. The planner sets it
      only when the build keys are unique.
    - unique=False (inner, left and full): the expansion probe into
      ``out_capacity`` rows.

    ``verify``: the (probe expr, build expr) pairs of a hash key, checked
    by value after the probe (unique probes, and inner expansion ones)."""

    def __init__(self, build: JoinBuildOperator, probe_key: Expr,
                 build_outputs: Sequence[BuildOutput] = (), join_type: str = "inner",
                 unique: bool = True, out_capacity: int | None = None,
                 verify: Sequence[tuple[Expr, Expr]] = ()):
        if join_type not in ("inner", "left", "full", "semi", "anti"):
            raise NotSupported(f"{join_type} joins are not ported yet")
        if not unique and join_type in ("inner", "left", "full") and out_capacity is None:
            raise NotSupported("an expansion join needs an output capacity")
        self.build = build
        self.probe_key = probe_key
        self.build_outputs = list(build_outputs)
        self.join_type = join_type
        self.unique = unique
        self.out_capacity = out_capacity
        self.verify = list(verify)
        self._strategy = None
        #: the probe steps, from the executable cache at first use (their
        #: keys name the route the build published)
        self._step = None
        self._pallas_step = None
        self._full_step = None

    def _record_strategy(self, name: str):
        """Count the chosen probe strategy once per operator."""
        if self._strategy is None:
            self._strategy = name
            REGISTRY.counter(f"join.strategy.{name}").add()
            if name == "pallas":
                REGISTRY.counter("exec.pallas_join_route").add()

    def _pallas_usable(self, batch: Batch) -> bool:
        """Per-batch routing: the build published fused tables, the mode
        serves this join type, AND this batch's key is a narrow integer
        column. The exact kernels take any capacity (ROADMAP C4); the
        sketch keeps the JAX package's capacity-block rule, because it
        changes results: it must approximate exactly the batches the
        JAX package's does."""
        build, spec = self.build, self.build.pallas
        if build.pallas_side is None or spec is None or self.verify:
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
            raise NotImplementedError("join keys are encoded against different dictionaries "
                                      "and their provenance was not visible to the planner; "
                                      "codes are not comparable across dictionaries")

    # ---- the executable cache ---------------------------------------------
    # The probe steps are shared across queries under the JAX package's
    # keys (the probe key, the build outputs, the join type and the
    # build's published route); a step reads the finished build side off
    # the operator it is called with, and calls the operator's probe
    # method by name at every call.

    def _ensure_pallas_step(self):
        if self._pallas_step is None:
            self._pallas_step = EXEC_CACHE.get_or_build(
                EXEC_CACHE.key_of("lookup_pallas", self.probe_key, tuple(self.build_outputs),
                                  self.join_type, self.build.pallas),
                lambda: _pallas_step)

    def _ensure_step(self):
        if self._step is not None:
            return
        jt, key, outs = self.join_type, self.probe_key, tuple(self.build_outputs)
        verify, use_dense = tuple(self.verify), self.build.dense_side is not None
        if jt in ("semi", "anti"):
            if verify:
                raise InternalError("hash-key verification needs a unique or inner probe")
            k = EXEC_CACHE.key_of("lookup_semi", key, jt, use_dense)
        elif self.unique:
            if verify and self.build.long_dup_runs:
                raise NotSupported("hash-key collision run exceeds the verified probe's "
                                   f"candidate window ({VERIFY_CANDIDATES})")
            k = EXEC_CACHE.key_of("lookup_unique", key, outs, jt, verify, use_dense,
                                  self.build.pack_bits)
        else:
            if verify and jt != "inner":
                # a LEFT row whose every candidate fails its check would
                # have to become a null-extended row
                raise InternalError("hash-key verification on expansion joins is inner-only")
            k = EXEC_CACHE.key_of("lookup_expand", key, outs, jt, verify, self.out_capacity,
                                  jt == "left")
        self._step = EXEC_CACHE.get_or_build(k, lambda: _probe_step)

    def _ensure_full_step(self):
        if self._full_step is not None:
            return
        key, outs, verify = self.probe_key, tuple(self.build_outputs), tuple(self.verify)
        if self.unique:
            if verify and self.build.long_dup_runs:
                raise NotSupported("hash-key collision run exceeds the verified probe's "
                                   f"candidate window ({VERIFY_CANDIDATES})")
            k = EXEC_CACHE.key_of("lookup_full_unique", key, outs, verify,
                                  self.build.dense_side is not None, self.build.pack_bits)
        else:
            if verify:
                raise InternalError("hash-key verification on an expansion FULL OUTER join")
            k = EXEC_CACHE.key_of("lookup_full_expand", key, outs, self.out_capacity)
        self._full_step = EXEC_CACHE.get_or_build(k, lambda: _full_step)

    def process(self, batch: Batch) -> list[Batch]:
        build = self.build
        if build.build_side is None:
            raise RuntimeError("build side not finished")
        self._check_probe_dict(batch)
        if self._pallas_usable(batch):
            self._ensure_pallas_step()
            self._record_strategy("pallas")
            with trace_span(f"step:probe_{self.join_type}", "step", {"strategy": "pallas"}):
                return [self._pallas_step(self, batch)]
        if build.pallas_side is not None:
            # the build published fused tables but THIS batch cannot
            # ride them (key storage): degrade loudly
            REGISTRY.counter("join.pallas_fallback").add()
        self._ensure_step()
        with trace_span(f"step:probe_{self.join_type}", "step"):
            return [self._step(self, batch)]

    def _probe(self, batch: Batch) -> Batch:
        """One batch through the dense, sorted or expansion probe."""
        build = self.build
        v = evaluate(self.probe_key, batch)
        plive = batch.live & valid_of(v.valid, batch.live)
        if self.join_type in ("semi", "anti"):
            if self.verify:
                # an existence probe has no build row to verify against
                raise InternalError("hash-key verification needs a unique or inner probe")
            if build.dense_side is not None:
                self._record_strategy("dense")
                exists = probe_exists_dense(build.dense_side, v.data, plive)
            else:
                self._record_strategy("unique")
                exists = probe_exists(build.build_side, v.data, plive)
            keep = exists if self.join_type == "semi" else batch.live & ~exists
            return batch.with_live(batch.live & keep)
        if not self.unique:
            if self.verify and self.join_type != "inner":
                # a LEFT row whose every candidate fails its check would
                # have to become a null-extended row
                raise InternalError("hash-key verification on expansion joins is inner-only")
            self._record_strategy("expand")
            out, _flags, overflow = self._expand(batch, v, plive)
            if bool(overflow):
                raise CapacityOverflow("LookupJoin", self.out_capacity)
            return out
        res = self._unique_probe(batch, v, plive)
        out = self._with_build_outputs(batch, res)
        live = batch.live & res.matched if self.join_type == "inner" else batch.live
        return out.with_live(live)

    def _unique_probe(self, batch: Batch, v, plive: torch.Tensor,
                      count: bool = True) -> UniqueProbe:
        """The probe-aligned unique lookup (build row, matched), counting
        its strategy unless ``count`` is off: the dense table, the sorted
        keys (packed when the build packed), or with verify pairs the
        collision-run scan."""
        build = self.build
        if self.verify:
            if build.long_dup_runs:
                raise NotSupported("hash-key collision run exceeds the verified probe's "
                                   f"candidate window ({VERIFY_CANDIDATES})")
            name = "unique"
        else:
            name = "dense" if build.dense_side is not None else "unique"
        if count:
            self._record_strategy(name)
        if self.verify:
            return verified_unique_probe(build.build_side, v, plive, self.verify,
                                         build.payload, batch)
        if build.dense_side is not None:
            return probe_unique_dense(build.dense_side, v.data, plive)
        return probe_unique(build.build_side, v.data, plive, pack_bits=build.pack_bits)

    def _with_build_outputs(self, batch: Batch, res: UniqueProbe) -> Batch:
        """``batch`` with each build output gathered through the unique
        probe's build rows (invalid where nothing matched)."""
        payload = self.build.payload
        cols = dict(batch.columns)
        for bo in self.build_outputs:
            src = payload[bo.source]
            data = gather_padded(src.data, res.build_row, 0)
            valid = gather_padded(valid_of(src.valid, payload.live), res.build_row, False)
            cols[bo.name] = Column(data, valid & res.matched, src.dtype, src.dictionary)
        return Batch(cols, batch.live)

    # ---- FULL OUTER -------------------------------------------------------
    # A full join probes with LEFT semantics while a matched-flags array
    # over the build payload accumulates; after the probe stream,
    # ``full_tail`` emits the never-matched build rows with NULL probe
    # columns. The flags are the caller's, so a replayed stream restarts
    # them and an expansion retry discards a failed attempt's update
    # (setting a flag twice is harmless). No strategy is counted, as in
    # the JAX package.

    def process_full(self, batch: Batch, flags: torch.Tensor):
        """One FULL OUTER probe step: (output batch, new flags). Raises
        ``CapacityOverflow`` on expansion overflow; the caller retries
        the batch with the previous flags."""
        build = self.build
        if build.build_side is None:
            raise RuntimeError("build side not finished")
        self._check_probe_dict(batch)
        self._ensure_full_step()
        with trace_span("step:probe_full", "step"):
            return self._full_step(self, batch, flags)

    def _probe_full(self, batch: Batch, flags: torch.Tensor):
        v = evaluate(self.probe_key, batch)
        plive = batch.live & valid_of(v.valid, batch.live)
        if self.unique:
            res = self._unique_probe(batch, v, plive, count=False)
            # a hash collision is a miss: only verified matches set flags
            flags = _set_flags(flags, torch.where(res.matched, res.build_row,
                                                  torch.full_like(res.build_row,
                                                                  flags.shape[0])))
            return self._with_build_outputs(batch, res), flags
        if self.verify:
            raise InternalError("hash-key verification on an expansion FULL OUTER join")
        out, flags, overflow = self._expand(batch, v, plive, flags)
        if bool(overflow):
            raise CapacityOverflow("LookupJoin", self.out_capacity)
        return out, flags

    def _expand(self, batch: Batch, v, plive: torch.Tensor, flags: torch.Tensor | None = None):
        """(the expanded batch, flags, overflow): every probe column
        gathered by probe row and every build output by build row, a miss
        giving an invalid value (a left or full join's null-extended
        rows); an inner join's pairs checked by value on the verify
        pairs; with ``flags``, every emitted build row set in them."""
        build = self.build
        outer = self.join_type in ("left", "full")
        res = probe_expand(build.build_side, v.data, plive, self.out_capacity,
                           left=outer, emit_live=batch.live)
        live = verify_mask(self.verify, batch, build.payload, res.build_row,
                           probe_row=res.probe_row, init=res.live)
        if flags is not None:
            flags = _set_flags(flags, res.build_row)
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
        return Batch(cols, live), flags, res.overflow


def _pallas_step(op: LookupJoinOperator, batch: Batch) -> Batch:
    return op._pallas_probe(batch)


def _probe_step(op: LookupJoinOperator, batch: Batch) -> Batch:
    return op._probe(batch)


def _full_step(op: LookupJoinOperator, batch: Batch, flags: torch.Tensor):
    return op._probe_full(batch, flags)


def _set_flags(flags: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``flags`` with every row in ``rows`` set; a row past the end (a
    miss) is dropped."""
    n = flags.shape[0]
    out = torch.cat([flags, flags.new_zeros(1)])
    idx = torch.clamp(rows.to(torch.int64), max=n)
    out[idx] = True
    return out[:n]


def verified_unique_probe(side, v, plive: torch.Tensor, verify, payload: Batch,
                          batch: Batch) -> UniqueProbe:
    """Unique probe over hashed keys, verified by value. Distinct build
    values can share one hash, so the hashed keys may repeat though the
    original keys are unique: scan the whole collision run
    (``VERIFY_CANDIDATES`` wide; builds with longer runs are refused)
    and keep the first candidate whose values match."""
    pk = torch.where(plive, v.data.to(torch.int64), torch.full_like(plive, I64_MAX,
                                                                    dtype=torch.int64))
    lo = torch.searchsorted(side.sorted_keys, pk)
    cap = side.row_idx.shape[0]
    best = torch.full_like(pk, cap)
    matched = torch.zeros_like(plive)
    for k in range(VERIFY_CANDIDATES):
        pos = lo + k
        hit = gather_padded(side.sorted_keys, pos, I64_MAX)
        row = gather_padded(side.row_idx, pos, cap)
        ok = (hit == pk) & plive & (pk != I64_MAX)
        ok = verify_mask(verify, batch, payload, row, init=ok)
        best = torch.where(ok & ~matched, row.to(best.dtype), best)
        matched = matched | ok
    return UniqueProbe(torch.where(matched, best, torch.full_like(best, cap)), matched)


def full_init_flags(build: JoinBuildOperator) -> torch.Tensor:
    """Fresh matched-build flags for a FULL OUTER probe pass."""
    return torch.zeros(build.payload.capacity, dtype=torch.bool, device=build.payload.device)


def full_tail_batch(payload: Batch, build_outputs: Sequence[BuildOutput],
                    flags: torch.Tensor, probe_schema: Batch) -> Batch:
    """The never-matched ``payload`` rows (live and not flagged) with NULL
    probe columns; ``probe_schema`` (any probe batch) gives the probe
    side's names, types and dictionaries. The one tail constructor of
    both FULL OUTER paths: the operator-held build of the local and
    broadcast joins, and each shard's received build in the distributed
    repartition step."""
    cap = payload.capacity
    dev = payload.device
    out_names = {bo.name for bo in build_outputs}
    cols = {}
    for name in probe_schema.names:
        if name in out_names:
            continue
        src = probe_schema[name]
        cols[name] = Column(torch.zeros((cap,) + tuple(src.data.shape[1:]),
                                        dtype=src.data.dtype, device=dev),
                            torch.zeros(cap, dtype=torch.bool, device=dev),
                            src.dtype, src.dictionary)
    for bo in build_outputs:
        src = payload[bo.source]
        cols[bo.name] = Column(src.data, src.valid, src.dtype, src.dictionary)
    return Batch(cols, payload.live & ~flags)


def full_tail(build: JoinBuildOperator, build_outputs: Sequence[BuildOutput],
              flags: torch.Tensor, probe_schema: Batch) -> Batch:
    """``full_tail_batch`` over an operator-held build."""
    return full_tail_batch(build.payload, build_outputs, flags, probe_schema)
