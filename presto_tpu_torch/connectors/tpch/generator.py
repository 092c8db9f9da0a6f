"""Deterministic, columnar, chunked TPC-H data generation.

A copy of ``presto_tpu/connectors/tpch/generator.py`` (numpy only; the
port imports nothing of the JAX package). The data must stay
bit-for-bit the JAX package's: ``tests/test_torch_tpch.py`` holds the two
against each other.

Reference parity: the ``io.airlift.tpch`` row generator behind
``presto-tpch`` (``TpchRecordSetProvider`` — data is generated on the
fly, never read from disk) [SURVEY §2.2; reference tree unavailable].
Distributions follow the public TPC-H v3 spec (dbgen *semantics*);
output is deterministic but not byte-identical to dbgen's RNG stream.

Design (TPU-first):

- **Columnar & vectorized**: every column is produced as one NumPy array
  op chain — no per-row Python. Fixed-width BYTES text (comments,
  names, addresses) is built by fancy-indexing padded vocabulary byte
  matrices, so "string generation" is a gather.
- **Chunked & order-independent**: a split is a contiguous key range;
  each (table, chunk, column) gets its own counter-based RNG stream
  (``np.random.Philox``), so any subset of columns/chunks can be
  generated in any order — including in parallel across hosts — with
  identical values. This is the property that lets the same generator
  be the scan source, the oracle fixture, and the multi-host data
  plane.
- Orders and lineitem share order-level streams (line counts, order
  dates), so ``o_totalprice`` is consistent with the lineitem charges
  and foreign keys hold exactly (customer thirds rule, partsupp
  supplier formula).

Word-soup text uses fixed-width word slots (words space-padded to the
slot width) so composition is a pure gather; '%word%word%' LIKE
patterns behave as in dbgen text.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from presto_tpu_torch.connectors.tpch import schema as S

_TABLE_IDS = {t: i for i, t in enumerate(S.TABLES)}


def _rng(seed: int, table: str, chunk: int, stream: int) -> np.random.Generator:
    # Philox takes a 2x64-bit key: pack (seed, table) and (chunk, stream)
    # into the two words — counter-based, so streams are independent.
    return np.random.Generator(
        np.random.Philox(key=[(seed << 4) | _TABLE_IDS[table], (chunk << 8) | stream])
    )


# stream ids per logical quantity (NOT per output column: orders and
# lineitem share order-level streams)
_ST = {
    name: i
    for i, name in enumerate(
        [
            "linecount", "orderdate", "custkey", "priority", "clerk",
            "comment", "quantity", "discount", "tax", "partkey", "suppi",
            "shipdelta", "commitdelta", "receiptdelta", "returnchoice",
            "instruct", "mode", "lcomment", "name", "address", "nation",
            "phone", "acctbal", "segment", "mfgr_brand", "ptype", "size",
            "container", "pcomment", "availqty", "supplycost", "inject",
        ]
    )
}


# ---------------------------------------------------------------------------
# vectorized text helpers
# ---------------------------------------------------------------------------


def _vocab_matrix(words: list[str], slot: int) -> np.ndarray:
    """words -> uint8 [V, slot], space-padded to the slot width."""
    m = np.full((len(words), slot), ord(" "), dtype=np.uint8)
    for i, w in enumerate(words):
        b = w.encode("ascii")[:slot]
        m[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    return m


_COMMENT_SLOT = 11
_COMMENT_VOCAB = _vocab_matrix(S.COMMENT_WORDS, _COMMENT_SLOT)
_COLOR_SLOT = 11
_COLOR_VOCAB = _vocab_matrix(S.COLORS, _COLOR_SLOT)


def _word_soup(rng: np.random.Generator, n: int, width: int, vocab: np.ndarray) -> np.ndarray:
    """Random fixed-slot word text: uint8 [n, width]."""
    slot = vocab.shape[1]
    k = max(1, width // slot)
    idx = rng.integers(0, vocab.shape[0], size=(n, k))
    out = vocab[idx].reshape(n, k * slot)[:, :width]
    return np.ascontiguousarray(out)


def _inject_phrase(text: np.ndarray, rows: np.ndarray, words: list[str]) -> None:
    """Overwrite the leading slots of selected rows with a word sequence."""
    slot = _COMMENT_SLOT
    for j, w in enumerate(words):
        b = w.encode("ascii")[:slot]
        start = j * slot
        if start + slot > text.shape[1]:
            break
        text[rows, start : start + slot] = ord(" ")
        text[rows, start : start + len(b)] = np.frombuffer(b, dtype=np.uint8)


def _keyed_name(prefix: str, keys: np.ndarray, width: int) -> np.ndarray:
    """'Prefix#%09d' names as uint8 [n, width] — pure divmod math."""
    n = len(keys)
    out = np.full((n, width), 0, dtype=np.uint8)
    p = prefix.encode("ascii") + b"#"
    out[:, : len(p)] = np.frombuffer(p, dtype=np.uint8)
    digits = 9
    k = keys.astype(np.int64)
    for d in range(digits):
        col = len(p) + digits - 1 - d
        out[:, col] = ord("0") + (k % 10)
        k //= 10
    return out


def _random_alnum(rng: np.random.Generator, n: int, width: int) -> np.ndarray:
    """Random v-string addresses: length U[10, width], zero-padded."""
    alpha = np.frombuffer(
        b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 ,",
        dtype=np.uint8,
    )
    out = alpha[rng.integers(0, len(alpha), size=(n, width))]
    lens = rng.integers(10, width + 1, size=n)
    mask = np.arange(width)[None, :] >= lens[:, None]
    out[mask] = 0
    return out


def _phone(rng: np.random.Generator, nationkey: np.ndarray) -> np.ndarray:
    """'CC-NNN-NNN-NNNN' (15 bytes), CC = nationkey + 10."""
    n = len(nationkey)
    out = np.full((n, 15), ord("-"), dtype=np.uint8)
    cc = nationkey.astype(np.int64) + 10
    out[:, 0] = ord("0") + cc // 10
    out[:, 1] = ord("0") + cc % 10
    digits = rng.integers(0, 10, size=(n, 10)).astype(np.uint8) + ord("0")
    out[:, 3:6] = digits[:, 0:3]
    out[:, 7:10] = digits[:, 3:6]
    out[:, 11:15] = digits[:, 6:10]
    return out


# ---------------------------------------------------------------------------
# key-space helpers (exact FK relationships)
# ---------------------------------------------------------------------------


def order_index_to_key(idx: np.ndarray) -> np.ndarray:
    """Sparse orderkeys: 8 used out of every 32 (spec 4.2.3)."""
    return (idx >> 3) * 32 + (idx & 7) + 1


def customer_draw_to_key(draw: np.ndarray) -> np.ndarray:
    """Map U[0, 2/3·C) onto custkeys that are not multiples of 3
    (spec: one third of customers have no orders)."""
    return (draw // 2) * 3 + (draw % 2) + 1


def partsupp_suppkey(partkey: np.ndarray, i: np.ndarray, s_count: int) -> np.ndarray:
    """The spec's supplier-of-part formula (4.2.3): exactly
    SUPPLIERS_PER_PART distinct suppliers per part, uniform load.

    At tiny scale factors the spec step (S/4 + (p-1)/S) can hit a value
    where k*step % S == 0 for k < 4 (e.g. S=50, step=25), collapsing
    the four suppliers onto two — impossible at SF>=1 where S>=10000.
    The step is nudged forward until the four offsets are distinct, so
    the (ps_partkey, ps_suppkey) primary key holds at every SF.
    """
    p = partkey.astype(np.int64)
    step = s_count // S.SUPPLIERS_PER_PART + (p - 1) // s_count
    for _ in range(4):
        bad = np.zeros(p.shape, dtype=bool)
        for k in range(1, S.SUPPLIERS_PER_PART):
            bad |= (k * step) % s_count == 0
        if not bad.any():
            break
        step = step + bad
    return (p + i * step) % s_count + 1


def retail_price_cents(partkey: np.ndarray) -> np.ndarray:
    p = partkey.astype(np.int64)
    return 90000 + (p // 10) % 20001 + 100 * (p % 1000)


# ---------------------------------------------------------------------------
# lazy lineitem column builders (dependency-gated column pruning)
# ---------------------------------------------------------------------------
# signature: (gen, r, memo, get, total, nlines, lo, hi, odate) -> np.ndarray
# "internal" entries (leading _) are dependencies, not output columns.

_BUILDERS = {}


def _li(name):
    def deco(fn):
        _BUILDERS[name] = fn
        return fn

    return deco


@_li("_odate")
def _b_odate(g, r, memo, get, total, nlines, lo, hi, odate):
    return np.repeat(odate, nlines)


@_li("l_orderkey")
def _b_okey(g, r, memo, get, total, nlines, lo, hi, odate):
    oidx = np.repeat(np.arange(lo, hi, dtype=np.int64), nlines)
    return order_index_to_key(oidx)


@_li("l_linenumber")
def _b_lineno(g, r, memo, get, total, nlines, lo, hi, odate):
    starts = np.concatenate([[0], np.cumsum(nlines)[:-1]])
    return (
        np.arange(total, dtype=np.int64) - np.repeat(starts, nlines) + 1
    ).astype(np.int32)


@_li("l_quantity_units")
def _b_qty_units(g, r, memo, get, total, nlines, lo, hi, odate):
    return r("quantity").integers(1, 51, size=total, dtype=np.int64)


@_li("l_quantity")
def _b_qty(g, r, memo, get, total, nlines, lo, hi, odate):
    return get("l_quantity_units") * 100


@_li("l_discount")
def _b_disc(g, r, memo, get, total, nlines, lo, hi, odate):
    return r("discount").integers(0, 11, size=total, dtype=np.int64)


@_li("l_tax")
def _b_tax(g, r, memo, get, total, nlines, lo, hi, odate):
    return r("tax").integers(0, 9, size=total, dtype=np.int64)


@_li("l_partkey")
def _b_partkey(g, r, memo, get, total, nlines, lo, hi, odate):
    return r("partkey").integers(1, g.parts + 1, size=total, dtype=np.int64)


@_li("l_suppkey")
def _b_suppkey(g, r, memo, get, total, nlines, lo, hi, odate):
    suppi = r("suppi").integers(0, S.SUPPLIERS_PER_PART, size=total, dtype=np.int64)
    return partsupp_suppkey(get("l_partkey"), suppi, g.suppliers)


@_li("l_extendedprice")
def _b_eprice(g, r, memo, get, total, nlines, lo, hi, odate):
    return get("l_quantity_units") * retail_price_cents(get("l_partkey"))


@_li("l_shipdate")
def _b_shipdate(g, r, memo, get, total, nlines, lo, hi, odate):
    return (get("_odate") + r("shipdelta").integers(1, 122, size=total)).astype(np.int32)


@_li("l_commitdate")
def _b_commitdate(g, r, memo, get, total, nlines, lo, hi, odate):
    return (get("_odate") + r("commitdelta").integers(30, 91, size=total)).astype(np.int32)


@_li("l_receiptdate")
def _b_receiptdate(g, r, memo, get, total, nlines, lo, hi, odate):
    return (get("l_shipdate") + r("receiptdelta").integers(1, 31, size=total)).astype(
        np.int32
    )


@_li("l_returnflag")
def _b_returnflag(g, r, memo, get, total, nlines, lo, hi, odate):
    retchoice = r("returnchoice").integers(0, 2, size=total)
    d = S.DICTS["l_returnflag"]
    return np.where(
        get("l_receiptdate") <= S.CURRENTDATE,
        np.where(retchoice == 0, d.code_of("R"), d.code_of("A")),
        d.code_of("N"),
    ).astype(np.int32)


@_li("l_linestatus")
def _b_linestatus(g, r, memo, get, total, nlines, lo, hi, odate):
    d = S.DICTS["l_linestatus"]
    return np.where(
        get("l_shipdate") > S.CURRENTDATE, d.code_of("O"), d.code_of("F")
    ).astype(np.int32)


@_li("l_shipinstruct")
def _b_instruct(g, r, memo, get, total, nlines, lo, hi, odate):
    return r("instruct").integers(0, len(S.INSTRUCTS), size=total).astype(np.int32)


@_li("l_shipmode")
def _b_mode(g, r, memo, get, total, nlines, lo, hi, odate):
    return r("mode").integers(0, len(S.MODES), size=total).astype(np.int32)


@_li("l_comment")
def _b_lcomment(g, r, memo, get, total, nlines, lo, hi, odate):
    return _word_soup(r("lcomment"), total, 44, _COMMENT_VOCAB)


# ---------------------------------------------------------------------------
# per-table chunk generators -> dict[str, np.ndarray]
# ---------------------------------------------------------------------------


class TpchGenerator:
    """Generates host-side columnar chunks for one scale factor."""

    def __init__(self, sf: float, seed: int = 19920401):
        self.sf = sf
        self.seed = seed
        self.customers = int(150_000 * sf)
        self.orders = int(1_500_000 * sf)
        self.parts = int(200_000 * sf)
        self.suppliers = max(int(10_000 * sf), S.SUPPLIERS_PER_PART)

    # -- orders / lineitem share order-level streams ---------------------

    def _order_level(self, chunk: int, lo: int, hi: int):
        n = hi - lo
        nlines = _rng(self.seed, "orders", chunk, _ST["linecount"]).integers(
            1, 8, size=n
        )
        odate = _rng(self.seed, "orders", chunk, _ST["orderdate"]).integers(
            S.STARTDATE, S.ORDER_MAXDATE + 1, size=n, dtype=np.int64
        )
        return nlines, odate

    def _lineitem_arrays(self, chunk: int, lo: int, hi: int, nlines, odate, need=None):
        """Lineitem physical columns for order index range [lo, hi).

        Lazily computes only the columns in ``need`` (plus their
        dependencies). Every column draws from its own RNG stream, so
        pruning never perturbs the values of other columns.
        """
        total = int(nlines.sum())
        r = lambda s: _rng(self.seed, "lineitem", chunk, _ST[s])
        memo: dict[str, np.ndarray] = {}

        def get(name):
            if name not in memo:
                memo[name] = _BUILDERS[name](self, r, memo, get, total, nlines, lo, hi, odate)
            return memo[name]

        cols = list(S.TABLES["lineitem"]) if need is None else [
            c for c in S.TABLES["lineitem"] if c in need
        ]
        return {c: get(c) for c in cols}

    def lineitem_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        nlines, odate = self._order_level(chunk, lo, hi)
        need = set(columns) if columns is not None else None
        arrays = self._lineitem_arrays(chunk, lo, hi, nlines, odate, need)
        if columns is not None:
            arrays = {c: arrays[c] for c in columns}
        return arrays

    def orders_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        n = hi - lo
        nlines, odate = self._order_level(chunk, lo, hi)
        need = set(columns) if columns is not None else set(S.TABLES["orders"])
        r = lambda s: _rng(self.seed, "orders", chunk, _ST[s])
        arrays: dict[str, np.ndarray] = {}
        if "o_orderkey" in need:
            arrays["o_orderkey"] = order_index_to_key(np.arange(lo, hi, dtype=np.int64))
        if "o_custkey" in need:
            draw = r("custkey").integers(
                0, max(2 * self.customers // 3, 1), size=n, dtype=np.int64
            )
            arrays["o_custkey"] = customer_draw_to_key(draw)
        if "o_totalprice" in need or "o_orderstatus" in need:
            li = self._lineitem_arrays(
                chunk, lo, hi, nlines, odate,
                need={"l_extendedprice", "l_discount", "l_tax", "l_linestatus"},
            )
            ends = np.cumsum(nlines)
            starts = ends - nlines
            if "o_totalprice" in need:
                charge = (
                    li["l_extendedprice"] * (100 - li["l_discount"]) * (100 + li["l_tax"])
                )
                charge = (charge + 5000) // 10000  # back to cents
                csum = np.concatenate([[0], np.cumsum(charge)])
                arrays["o_totalprice"] = csum[ends] - csum[starts]
            if "o_orderstatus" in need:
                dstat = S.DICTS["l_linestatus"]
                isf = (li["l_linestatus"] == dstat.code_of("F")).astype(np.int64)
                csum = np.concatenate([[0], np.cumsum(isf)])
                nf = csum[ends] - csum[starts]
                dos = S.DICTS["o_orderstatus"]
                arrays["o_orderstatus"] = np.where(
                    nf == nlines,
                    dos.code_of("F"),
                    np.where(nf == 0, dos.code_of("O"), dos.code_of("P")),
                ).astype(np.int32)
        if "o_orderdate" in need:
            arrays["o_orderdate"] = odate.astype(np.int32)
        if "o_orderpriority" in need:
            arrays["o_orderpriority"] = (
                r("priority").integers(0, len(S.PRIORITIES), size=n).astype(np.int32)
            )
        if "o_clerk" in need:
            nclerks = max(int(1000 * self.sf), 1)
            arrays["o_clerk"] = _keyed_name(
                "Clerk", r("clerk").integers(1, nclerks + 1, size=n), 15
            )
        if "o_shippriority" in need:
            arrays["o_shippriority"] = np.zeros(n, dtype=np.int32)
        if "o_comment" in need:
            text = _word_soup(r("comment"), n, 79, _COMMENT_VOCAB)
            # Q13's anti-pattern phrase at ~1.5% of orders
            sel = _rng(self.seed, "orders", chunk, _ST["inject"]).random(n) < 0.015
            _inject_phrase(text, np.nonzero(sel)[0], ["special", "packages", "requests"])
            arrays["o_comment"] = text
        if columns is not None:
            arrays = {c: arrays[c] for c in columns}
        return arrays

    # -- flat key-range tables -------------------------------------------

    def customer_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        n = hi - lo
        keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
        r = lambda s: _rng(self.seed, "customer", chunk, _ST[s])
        nat = r("nation").integers(0, 25, size=n, dtype=np.int64)
        arrays = {
            "c_custkey": keys,
            "c_name": _keyed_name("Customer", keys, 18),
            "c_address": _random_alnum(r("address"), n, 40),
            "c_nationkey": nat,
            "c_phone": _phone(r("phone"), nat),
            "c_acctbal": r("acctbal").integers(-99999, 1000000, size=n, dtype=np.int64),
            "c_mktsegment": r("segment").integers(0, len(S.SEGMENTS), size=n).astype(np.int32),
            "c_comment": _word_soup(r("comment"), n, 117, _COMMENT_VOCAB),
        }
        if columns is not None:
            arrays = {c: arrays[c] for c in columns}
        return arrays

    def supplier_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        n = hi - lo
        keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
        r = lambda s: _rng(self.seed, "supplier", chunk, _ST[s])
        nat = r("nation").integers(0, 25, size=n, dtype=np.int64)
        text = _word_soup(r("comment"), n, 101, _COMMENT_VOCAB)
        # Q16's blacklist phrase: ~5 per 10k suppliers
        sel = _rng(self.seed, "supplier", chunk, _ST["inject"]).random(n) < 0.0005
        _inject_phrase(text, np.nonzero(sel)[0], ["Customer", "Complaints"])
        arrays = {
            "s_suppkey": keys,
            "s_name": _keyed_name("Supplier", keys, 18),
            "s_address": _random_alnum(r("address"), n, 40),
            "s_nationkey": nat,
            "s_phone": _phone(r("phone"), nat),
            "s_acctbal": r("acctbal").integers(-99999, 1000000, size=n, dtype=np.int64),
            "s_comment": text,
        }
        if columns is not None:
            arrays = {c: arrays[c] for c in columns}
        return arrays

    def part_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        n = hi - lo
        keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
        r = lambda s: _rng(self.seed, "part", chunk, _ST[s])
        mfgr = r("mfgr_brand").integers(1, 6, size=(n, 2))
        mname = np.full((n, 25), 0, dtype=np.uint8)
        p = b"Manufacturer#"
        mname[:, : len(p)] = np.frombuffer(p, dtype=np.uint8)
        mname[:, len(p)] = ord("0") + mfgr[:, 0].astype(np.uint8)
        brand_code = ((mfgr[:, 0] - 1) * 5 + (mfgr[:, 1] - 1)).astype(np.int64)
        # dictionary is sorted: Brand#11..Brand#55 sorts identically
        # to (m,n) lexicographic order, so codes line up directly.
        names = _word_soup(r("name"), n, 55, _COLOR_VOCAB)
        arrays = {
            "p_partkey": keys,
            "p_name": names,
            "p_mfgr": mname,
            "p_brand": brand_code.astype(np.int32),
            "p_type": r("ptype").integers(0, 150, size=n).astype(np.int32),
            "p_size": r("size").integers(1, 51, size=n).astype(np.int32),
            "p_container": r("container").integers(0, 40, size=n).astype(np.int32),
            "p_retailprice": retail_price_cents(keys),
            "p_comment": _word_soup(r("pcomment"), n, 23, _COMMENT_VOCAB),
        }
        if columns is not None:
            arrays = {c: arrays[c] for c in columns}
        return arrays

    def partsupp_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        """Rows [lo, hi) of partsupp ordered by (partkey, i)."""
        idx = np.arange(lo, hi, dtype=np.int64)
        partkey = idx // S.SUPPLIERS_PER_PART + 1
        i = idx % S.SUPPLIERS_PER_PART
        n = hi - lo
        r = lambda s: _rng(self.seed, "partsupp", chunk, _ST[s])
        arrays = {
            "ps_partkey": partkey,
            "ps_suppkey": partsupp_suppkey(partkey, i, self.suppliers),
            "ps_availqty": r("availqty").integers(1, 10000, size=n).astype(np.int32),
            "ps_supplycost": r("supplycost").integers(100, 100001, size=n, dtype=np.int64),
            "ps_comment": _word_soup(r("comment"), n, 199, _COMMENT_VOCAB),
        }
        if columns is not None:
            arrays = {c: arrays[c] for c in columns}
        return arrays

    def nation_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        names = [n for n, _ in S.NATIONS]
        d = S.DICTS["n_name"]
        r = _rng(self.seed, "nation", 0, _ST["comment"])
        arrays = {
            "n_nationkey": np.arange(25, dtype=np.int64),
            "n_name": d.encode(names),
            "n_regionkey": np.array([rk for _, rk in S.NATIONS], dtype=np.int64),
            "n_comment": _word_soup(r, 25, 120, _COMMENT_VOCAB),
        }
        arrays = {c: v[lo:hi] for c, v in arrays.items()}
        if columns is not None:
            arrays = {c: arrays[c] for c in columns}
        return arrays

    def region_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        d = S.DICTS["r_name"]
        r = _rng(self.seed, "region", 0, _ST["comment"])
        arrays = {
            "r_regionkey": np.arange(5, dtype=np.int64),
            "r_name": d.encode(S.REGIONS),
            "r_comment": _word_soup(r, 5, 120, _COMMENT_VOCAB),
        }
        arrays = {c: v[lo:hi] for c, v in arrays.items()}
        if columns is not None:
            arrays = {c: arrays[c] for c in columns}
        return arrays

    CHUNK_FNS = {
        "lineitem": "lineitem_chunk",
        "orders": "orders_chunk",
        "customer": "customer_chunk",
        "supplier": "supplier_chunk",
        "part": "part_chunk",
        "partsupp": "partsupp_chunk",
        "nation": "nation_chunk",
        "region": "region_chunk",
    }

    def base_rows(self, table: str) -> int:
        """Number of *generation units* (orders for lineitem)."""
        return {
            "lineitem": self.orders,
            "orders": self.orders,
            "customer": self.customers,
            "supplier": self.suppliers,
            "part": self.parts,
            "partsupp": self.parts * S.SUPPLIERS_PER_PART,
            "nation": 25,
            "region": 5,
        }[table]

    def generate(self, table: str, chunk: int, lo: int, hi: int, columns=None):
        return getattr(self, self.CHUNK_FNS[table])(chunk, lo, hi, columns)
