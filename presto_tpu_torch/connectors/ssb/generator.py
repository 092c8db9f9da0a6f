"""Deterministic columnar SSB data generation.

A copy of ``presto_tpu/connectors/ssb/generator.py`` (numpy only; the
port imports nothing of the JAX package); keep the two identical, so
both packages see bit-identical data.

No SSB connector exists in the reference (SURVEY §6 notes this gap —
"plan to write an SSB generator"); domains follow the public SSB spec.
Same counter-based Philox stream architecture as the TPC-H/TPC-DS
generators: any (table, chunk, column) subset regenerates identically.
The date table is pure calendar math (no RNG).
"""

from __future__ import annotations

import numpy as np

from presto_tpu_torch.connectors.ssb import schema as S

_TABLE_IDS = {t: i for i, t in enumerate(S.TABLES)}

_ST = {
    name: i
    for i, name in enumerate(
        ["cust", "part", "supp", "date", "qty", "discount", "price", "tax",
         "priority", "shipmode", "supplycost", "commit", "city", "segment",
         "phone", "address", "mfgr", "cat", "brand", "color", "ptype",
         "size", "container", "name", "lines"]
    )
}


def _rng(seed: int, table: str, chunk: int, stream: int) -> np.random.Generator:
    return np.random.Generator(
        np.random.Philox(key=[(seed << 3) | _TABLE_IDS[table], (chunk << 8) | stream])
    )


def _keyed_name(prefix: str, keys: np.ndarray, width: int) -> np.ndarray:
    n = len(keys)
    out = np.zeros((n, width), dtype=np.uint8)
    p = prefix.encode("ascii") + b"#"
    out[:, : len(p)] = np.frombuffer(p, dtype=np.uint8)
    digits = 9
    k = keys.astype(np.int64)
    for d in range(digits):
        col = len(p) + digits - 1 - d
        out[:, col] = ord("0") + (k % 10)
        k //= 10
    return out


def _word_text(rng, n: int, width: int, words: list[str]) -> np.ndarray:
    """Space-separated word text (variable length, zero-padded) — the
    p_name color-pair shape the LIKE predicates target."""
    slot = max(len(w) for w in words) + 1
    vocab = np.full((len(words), slot), ord(" "), dtype=np.uint8)
    for i, w in enumerate(words):
        b = w.encode("ascii")
        vocab[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    k = max(1, -(-width // slot))
    idx = rng.integers(0, len(words), size=(n, k))
    flat = vocab[idx].reshape(n, k * slot)[:, :width]
    out = np.zeros((n, width), dtype=np.uint8)
    out[:, : flat.shape[1]] = flat
    # trim trailing spaces to zeros (variable logical length)
    for col in range(width - 1, -1, -1):
        blank = (out[:, col:] == ord(" ")) | (out[:, col:] == 0)
        out[blank.all(axis=1), col] = 0
    return out


def _phone(rng, nation_idx: np.ndarray) -> np.ndarray:
    n = len(nation_idx)
    out = np.full((n, 15), ord("-"), dtype=np.uint8)
    cc = nation_idx.astype(np.int64) + 10
    out[:, 0] = ord("0") + cc // 10
    out[:, 1] = ord("0") + cc % 10
    digits = rng.integers(0, 10, size=(n, 10)).astype(np.uint8) + ord("0")
    out[:, 3:6] = digits[:, 0:3]
    out[:, 7:10] = digits[:, 3:6]
    out[:, 11:15] = digits[:, 6:10]
    return out


def _ymd(days: np.ndarray):
    dt = np.datetime64("1970-01-01", "D") + days
    y = dt.astype("datetime64[Y]").astype(int) + 1970
    m = dt.astype("datetime64[M]").astype(int) % 12 + 1
    d = (dt - dt.astype("datetime64[M]").astype("datetime64[D]")).astype(int) + 1
    return y, m, d


def datekey_of(days: np.ndarray) -> np.ndarray:
    y, m, d = _ymd(days)
    return (y * 10000 + m * 100 + d).astype(np.int64)


def date_chunk(lo: int, hi: int, columns=None):
    days = np.arange(S.STARTDATE + lo, S.STARTDATE + hi, dtype=np.int64)
    y, m, d = _ymd(days)
    doy = days - (
        (np.datetime64("1970-01-01", "D") + days).astype("datetime64[Y]")
        .astype("datetime64[D]") - np.datetime64("1970-01-01", "D")
    ).astype(int)
    dow = ((days + 4) % 7).astype(np.int64)  # 0 = Sunday
    dmn = S.DICTS["d_month"]
    month_full = ["January", "February", "March", "April", "May", "June",
                  "July", "August", "September", "October", "November",
                  "December"]
    dday = S.DICTS["d_dayofweek"]
    dym = S.DICTS["d_yearmonth"]
    ym_codes = dym.encode(
        [f"{S.MONTH_NAMES[mm - 1]}{yy}" for yy, mm in zip(y, m)]
    )
    season = np.select(
        [(m == 12), (m >= 9), (m >= 6), (m >= 3)],
        [S.DICTS["d_sellingseason"].code_of("Christmas"),
         S.DICTS["d_sellingseason"].code_of("Fall"),
         S.DICTS["d_sellingseason"].code_of("Summer"),
         S.DICTS["d_sellingseason"].code_of("Easter")],
        default=S.DICTS["d_sellingseason"].code_of("Winter"),
    )
    arrays = {
        "d_datekey": (y * 10000 + m * 100 + d).astype(np.int64),
        "d_date": days.astype(np.int32),
        "d_dayofweek": dday.encode(S.DAY_NAMES)[dow].astype(np.int32),
        "d_month": dmn.encode(month_full)[m - 1].astype(np.int32),
        "d_year": y.astype(np.int32),
        "d_yearmonthnum": (y * 100 + m).astype(np.int32),
        "d_yearmonth": ym_codes.astype(np.int32),
        "d_daynuminweek": (dow + 1).astype(np.int32),
        "d_daynuminmonth": d.astype(np.int32),
        "d_daynuminyear": (doy + 1).astype(np.int32),
        "d_monthnuminyear": m.astype(np.int32),
        "d_weeknuminyear": (doy // 7 + 1).astype(np.int32),
        "d_sellingseason": season.astype(np.int32),
        "d_holidayfl": ((m == 12) & (d == 25)).astype(np.int32),
        "d_weekdayfl": ((dow >= 1) & (dow <= 5)).astype(np.int32),
    }
    if columns is not None:
        arrays = {c: arrays[c] for c in columns}
    return arrays


class SsbGenerator:
    def __init__(self, sf: float, seed: int = 19940607):
        self.sf = sf
        self.seed = seed
        self.counts = {t: S.row_count(t, sf) for t in S.TABLES}

    def customer_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        n = hi - lo
        keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
        r = lambda s: _rng(self.seed, "customer", chunk, _ST[s])
        nat = r("city").integers(0, 25, size=n, dtype=np.int64)
        city_digit = r("address").integers(0, 10, size=n, dtype=np.int64)
        nations = [nm for nm, _ in S.NATIONS]
        city_names = [f"{nations[i][:9]:<9s}{d}" for i, d in zip(nat, city_digit)]
        arrays = {
            "c_custkey": keys,
            "c_name": _keyed_name("Customer", keys, 25),
            "c_address": _word_text(r("name"), n, 25, S.COLORS),
            "c_city": S.DICTS["c_city"].encode(city_names).astype(np.int32),
            "c_nation": S.DICTS["c_nation"].encode([nations[i] for i in nat]).astype(np.int32),
            "c_region": S.DICTS["c_region"].encode(
                [S.REGIONS[S.NATIONS[i][1]] for i in nat]
            ).astype(np.int32),
            "c_phone": _phone(r("phone"), nat),
            "c_mktsegment": r("segment").integers(0, 5, size=n).astype(np.int32),
        }
        if columns is not None:
            arrays = {c: arrays[c] for c in columns}
        return arrays

    def supplier_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        n = hi - lo
        keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
        r = lambda s: _rng(self.seed, "supplier", chunk, _ST[s])
        nat = r("city").integers(0, 25, size=n, dtype=np.int64)
        city_digit = r("address").integers(0, 10, size=n, dtype=np.int64)
        nations = [nm for nm, _ in S.NATIONS]
        city_names = [f"{nations[i][:9]:<9s}{d}" for i, d in zip(nat, city_digit)]
        arrays = {
            "s_suppkey": keys,
            "s_name": _keyed_name("Supplier", keys, 25),
            "s_address": _word_text(r("name"), n, 25, S.COLORS),
            "s_city": S.DICTS["s_city"].encode(city_names).astype(np.int32),
            "s_nation": S.DICTS["s_nation"].encode([nations[i] for i in nat]).astype(np.int32),
            "s_region": S.DICTS["s_region"].encode(
                [S.REGIONS[S.NATIONS[i][1]] for i in nat]
            ).astype(np.int32),
            "s_phone": _phone(r("phone"), nat),
        }
        if columns is not None:
            arrays = {c: arrays[c] for c in columns}
        return arrays

    def part_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        n = hi - lo
        keys = np.arange(lo + 1, hi + 1, dtype=np.int64)
        r = lambda s: _rng(self.seed, "part", chunk, _ST[s])
        m = r("mfgr").integers(1, 6, size=n, dtype=np.int64)
        c = r("cat").integers(1, 6, size=n, dtype=np.int64)
        b = r("brand").integers(1, 41, size=n, dtype=np.int64)
        # dictionary codes: sorted MFGR# strings order == (m, c, b) order
        mfgr_code = m - 1
        cat_code = (m - 1) * 5 + (c - 1)
        brand_code = ((m - 1) * 5 + (c - 1)) * 40 + (b - 1)
        arrays = {
            "p_partkey": keys,
            "p_name": _word_text(r("name"), n, 22, S.COLORS),
            "p_mfgr": mfgr_code.astype(np.int32),
            "p_category": cat_code.astype(np.int32),
            "p_brand1": brand_code.astype(np.int32),
            "p_color": r("color").integers(0, len(S.COLORS), size=n).astype(np.int32),
            "p_type": r("ptype").integers(0, len(S.TYPES), size=n).astype(np.int32),
            "p_size": r("size").integers(1, 51, size=n).astype(np.int32),
            "p_container": r("container").integers(0, len(S.CONTAINERS), size=n).astype(np.int32),
        }
        if columns is not None:
            arrays = {c: arrays[c] for c in columns}
        return arrays

    def lineorder_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        n = hi - lo
        r = lambda s: _rng(self.seed, "lineorder", chunk, _ST[s])
        idx = np.arange(lo, hi, dtype=np.int64)
        days = r("date").integers(S.STARTDATE, S.ENDDATE + 1, size=n)
        qty = r("qty").integers(1, 51, size=n, dtype=np.int64)
        price = r("price").integers(90001, 2000000, size=n, dtype=np.int64)  # cents
        disc = r("discount").integers(0, 11, size=n, dtype=np.int64)
        ext = qty * (price // 100) // 10  # extendedprice in cents
        revenue = ext * (100 - disc) // 100
        supplycost = 6 * (price // 100) // 10
        arrays = {
            "lo_orderkey": idx // 4 + 1,
            "lo_linenumber": (idx % 4 + 1).astype(np.int32),
            "lo_custkey": r("cust").integers(1, self.counts["customer"] + 1, size=n, dtype=np.int64),
            "lo_partkey": r("part").integers(1, self.counts["part"] + 1, size=n, dtype=np.int64),
            "lo_suppkey": r("supp").integers(1, self.counts["supplier"] + 1, size=n, dtype=np.int64),
            "lo_orderdate": datekey_of(days),
            "lo_orderpriority": r("priority").integers(0, 5, size=n).astype(np.int32),
            "lo_shippriority": np.zeros(n, np.int32),
            "lo_quantity": qty * 100,  # decimal(12,2)
            "lo_extendedprice": ext,
            "lo_ordtotalprice": ext * 4,
            "lo_discount": disc * 100,
            "lo_revenue": revenue,
            "lo_supplycost": supplycost,
            "lo_tax": r("tax").integers(0, 9, size=n, dtype=np.int64) * 100,
            "lo_commitdate": datekey_of(
                np.minimum(days + r("commit").integers(30, 91, size=n), S.ENDDATE)
            ),
            "lo_shipmode": r("shipmode").integers(0, len(S.SHIPMODES), size=n).astype(np.int32),
        }
        if columns is not None:
            arrays = {c: arrays[c] for c in columns}
        return arrays

    def base_rows(self, table: str) -> int:
        return self.counts[table]

    def generate(self, table: str, chunk: int, lo: int, hi: int, columns=None):
        if table == "date":
            return date_chunk(lo, hi, columns)
        return getattr(self, f"{table}_chunk")(chunk, lo, hi, columns)
