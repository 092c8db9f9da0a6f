"""Deterministic, columnar, chunked TPC-DS data generation.

A copy of ``presto_tpu/connectors/tpcds/generator.py`` (numpy only; the
port imports nothing of the JAX package); keep the two identical, so
both packages see bit-identical data.

Reference parity: the ``com.teradata.tpcds`` row generator behind
``presto-tpcds`` (data generated on the fly, never read from disk)
[SURVEY §2.2; reference tree unavailable]. Distributions follow the
public TPC-DS v3 spec shapes (dsdgen *semantics*); output is
deterministic but not byte-identical to dsdgen's RNG stream.

Same architecture as the TPC-H generator: every (table, chunk, stream)
gets an independent counter-based Philox stream, so any subset of
columns/chunks generates identically in any order — the generator is
simultaneously the scan source, the oracle fixture, and the multi-host
data plane. The demographics tables are pure index arithmetic (attribute
cross-products, dsdgen-style) and date_dim is pure calendar math — zero
RNG, zero storage.

Fact tables carry NULLs in FK columns (~4%, as dsdgen does) via
``<col>$valid`` companion masks.
"""

from __future__ import annotations

import numpy as np

from presto_tpu_torch.connectors.tpcds import schema as S

# append-only: a table's id is part of its Philox key, so existing
# tables keep their ids (and data) as new tables are added
_TABLE_ORDER = [
    "date_dim", "item", "customer", "customer_address",
    "customer_demographics", "household_demographics", "store", "promotion",
    "store_sales", "catalog_sales", "web_sales",
    "warehouse", "reason", "ship_mode", "income_band", "call_center",
    "web_site", "web_page", "time_dim", "inventory",
    "store_returns", "catalog_returns", "web_returns",
]
_TABLE_IDS = {t: i for i, t in enumerate(_TABLE_ORDER)}
assert set(_TABLE_IDS) == set(S.TABLES), "schema/table-id list out of sync"

_ST = {
    name: i
    for i, name in enumerate(
        [
            "date", "item", "customer", "quantity", "wholesale", "listmul",
            "salesmul", "coupon", "store", "promo", "cdemo", "hdemo", "addr",
            "price", "manufact", "manager", "color", "size", "units", "cat",
            "brand", "name", "desc", "city", "county", "state", "zip", "gmt",
            "employees", "floor", "hours", "market", "birth", "email",
            "channel1", "channel2", "channel3", "channel4", "cost", "null1",
            "null2", "null3", "ticket", "lines",
            # appended post-round-2 (append-only: stream ids are part of
            # the deterministic data contract)
            "salutation", "preferred", "soldtime", "shipdate", "shipmode",
            "warehouse", "callcenter", "shipaddr", "shipcust", "website",
            "webpage", "retflag", "retdate", "retqty", "retreason",
            "retcust", "fee", "sqft", "charcnt", "linkcnt", "wtype",
            "invqty", "null4", "null5",
            # round-5: official-template NULL-FK columns (q76 shape)
            "nulladdr", "nullcust",
        ]
    )
}


def _rng(seed: int, table: str, chunk: int, stream: int) -> np.random.Generator:
    return np.random.Generator(
        np.random.Philox(key=[(seed << 5) | _TABLE_IDS[table], (chunk << 8) | stream])
    )


# ---------------------------------------------------------------------------
# text helpers (shared style with the tpch generator)
# ---------------------------------------------------------------------------


def _vocab_matrix(words: list[str], slot: int) -> np.ndarray:
    m = np.full((len(words), slot), ord(" "), dtype=np.uint8)
    for i, w in enumerate(words):
        b = w.encode("ascii")[:slot]
        m[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    return m


_WORD_SLOT = 11
_WORD_VOCAB = _vocab_matrix(S.COMMENT_WORDS, _WORD_SLOT)


def _word_soup(rng, n: int, width: int, vocab=None) -> np.ndarray:
    vocab = _WORD_VOCAB if vocab is None else vocab
    slot = vocab.shape[1]
    k = max(1, width // slot)
    idx = rng.integers(0, vocab.shape[0], size=(n, k))
    return np.ascontiguousarray(vocab[idx].reshape(n, k * slot)[:, :width])


def _keyed_id(prefix: str, keys: np.ndarray, width: int) -> np.ndarray:
    """dsdgen-style business ids: '<PREFIX><011d>' zero-padded bytes."""
    n = len(keys)
    out = np.zeros((n, width), dtype=np.uint8)
    p = prefix.encode("ascii")
    out[:, : len(p)] = np.frombuffer(p, dtype=np.uint8)
    digits = min(width - len(p), 11)
    k = keys.astype(np.int64)
    for d in range(digits):
        col = len(p) + digits - 1 - d
        out[:, col] = ord("0") + (k % 10)
        k //= 10
    return out


def _zip(rng, n: int) -> np.ndarray:
    out = np.zeros((n, 10), dtype=np.uint8)
    digits = rng.integers(0, 10, size=(n, 5)).astype(np.uint8)
    out[:, :5] = digits + ord("0")
    return out


# ---------------------------------------------------------------------------
# pure-function dimensions
# ---------------------------------------------------------------------------


def date_dim_chunk(lo: int, hi: int, columns=None):
    """Calendar math over day index [lo, hi) from 1900-01-01."""
    idx = np.arange(lo, hi, dtype=np.int64)
    days = idx + S.EPOCH_1900_OFFSET  # days since 1970-01-01
    dt = np.datetime64("1970-01-01", "D") + days
    years = dt.astype("datetime64[Y]")
    months = dt.astype("datetime64[M]")
    y = years.astype(int) + 1970
    moy = (months.astype(int) % 12) + 1
    dom = (dt - months.astype("datetime64[D]")).astype(int) + 1
    dow = ((days + 4) % 7).astype(np.int32)  # 0 = Sunday (1970-01-01 was a Thursday)
    # Sunday-start weeks counted from 1899-12-31 (chunk-independent)
    dname = S.DICTS["d_day_name"]
    day_codes = dname.encode(S.DAY_NAMES)  # indexable by dow
    arrays = {
        "d_date_sk": idx + S.DATE_SK_BASE,
        "d_date_id": _keyed_id("D", idx + S.DATE_SK_BASE, 16),
        "d_date": days.astype(np.int32),
        "d_month_seq": ((y - 1900) * 12 + moy - 1).astype(np.int32),
        "d_week_seq": ((idx + 2) // 7 + 1).astype(np.int32),
        "d_quarter_seq": ((y - 1900) * 4 + (moy - 1) // 3).astype(np.int32),
        "d_year": y.astype(np.int32),
        "d_dow": dow,
        "d_moy": moy.astype(np.int32),
        "d_dom": dom.astype(np.int32),
        "d_qoy": ((moy - 1) // 3 + 1).astype(np.int32),
        "d_day_name": day_codes[dow].astype(np.int32),
    }
    if columns is not None:
        arrays = {c: arrays[c] for c in columns}
    return arrays


def customer_demographics_chunk(lo: int, hi: int, columns=None):
    """Pure cross-product decode of cd_demo_sk (dsdgen semantics)."""
    sk = np.arange(lo + 1, hi + 1, dtype=np.int64)
    i = sk - 1
    dims = [2, 5, 7, S.CD_PURCHASE_BANDS, 4, S.CD_DEP_COUNTS,
            S.CD_DEP_COUNTS, S.CD_DEP_COUNTS]
    parts = []
    for d in dims:
        parts.append((i % d).astype(np.int64))
        i = i // d
    g, m, e, pe, cr, dc, de, dco = parts
    dg = S.DICTS["cd_gender"]
    dm = S.DICTS["cd_marital_status"]
    ded = S.DICTS["cd_education_status"]
    dcr = S.DICTS["cd_credit_rating"]
    arrays = {
        "cd_demo_sk": sk,
        "cd_gender": dg.encode([S.GENDERS[x] for x in range(2)])[g].astype(np.int32),
        "cd_marital_status": dm.encode(S.MARITAL)[m].astype(np.int32),
        "cd_education_status": ded.encode(S.EDUCATION)[e].astype(np.int32),
        "cd_purchase_estimate": ((pe + 1) * 500).astype(np.int32),
        "cd_credit_rating": dcr.encode(S.CREDIT_RATINGS)[cr].astype(np.int32),
        "cd_dep_count": dc.astype(np.int32),
        "cd_dep_employed_count": de.astype(np.int32),
        "cd_dep_college_count": dco.astype(np.int32),
    }
    if columns is not None:
        arrays = {c: arrays[c] for c in columns}
    return arrays


def household_demographics_chunk(lo: int, hi: int, columns=None):
    sk = np.arange(lo + 1, hi + 1, dtype=np.int64)
    i = sk - 1
    dims = [S.HD_INCOME_BANDS, len(S.BUY_POTENTIALS), S.HD_DEP_COUNTS, S.HD_VEHICLES]
    parts = []
    for d in dims:
        parts.append((i % d).astype(np.int64))
        i = i // d
    ib, bp, dc, vc = parts
    dbp = S.DICTS["hd_buy_potential"]
    arrays = {
        "hd_demo_sk": sk,
        "hd_income_band_sk": ib + 1,
        "hd_buy_potential": dbp.encode(S.BUY_POTENTIALS)[bp].astype(np.int32),
        "hd_dep_count": dc.astype(np.int32),
        "hd_vehicle_count": (vc - 1).astype(np.int32),  # -1..4
    }
    if columns is not None:
        arrays = {c: arrays[c] for c in columns}
    return arrays


def time_dim_chunk(lo: int, hi: int, columns=None):
    """Pure clock math over second-of-day [lo, hi)."""
    sk = np.arange(lo, hi, dtype=np.int64)
    h = (sk // 3600).astype(np.int32)
    m = ((sk // 60) % 60).astype(np.int32)
    s = (sk % 60).astype(np.int32)
    d_ampm = S.DICTS["t_am_pm"]
    d_shift = S.DICTS["t_shift"]
    d_sub = S.DICTS["t_sub_shift"]
    d_meal = S.DICTS["t_meal_time"]
    shift = np.select(
        [(h >= 6) & (h < 14), (h >= 14) & (h < 22)],
        [d_shift.code_of("first"), d_shift.code_of("second")],
        d_shift.code_of("third"),
    ).astype(np.int32)
    sub = np.select(
        [(h >= 6) & (h < 12), (h >= 12) & (h < 18), (h >= 18)],
        [d_sub.code_of("morning"), d_sub.code_of("afternoon"),
         d_sub.code_of("evening")],
        d_sub.code_of("night"),
    ).astype(np.int32)
    meal = np.select(
        [(h >= 6) & (h < 9), (h >= 11) & (h < 14), (h >= 17) & (h < 21)],
        [d_meal.code_of("breakfast"), d_meal.code_of("lunch"),
         d_meal.code_of("dinner")],
        d_meal.code_of(""),
    ).astype(np.int32)
    arrays = {
        "t_time_sk": sk,
        "t_time_id": _keyed_id("T", sk, 16),
        "t_time": sk.astype(np.int32),
        "t_hour": h,
        "t_minute": m,
        "t_second": s,
        "t_am_pm": np.where(
            h < 12, d_ampm.code_of("AM"), d_ampm.code_of("PM")
        ).astype(np.int32),
        "t_shift": shift,
        "t_sub_shift": sub,
        "t_meal_time": meal,
    }
    if columns is not None:
        arrays = {c: arrays[c] for c in columns}
    return arrays


def reason_chunk(lo: int, hi: int, columns=None):
    sk = np.arange(lo + 1, hi + 1, dtype=np.int64)
    d = S.DICTS["r_reason_desc"]
    arrays = {
        "r_reason_sk": sk,
        "r_reason_id": _keyed_id("AAAAAAAA", sk, 16),
        "r_reason_desc": d.encode(S.REASONS)[(sk - 1) % len(S.REASONS)].astype(
            np.int32
        ),
    }
    if columns is not None:
        arrays = {c: arrays[c] for c in columns}
    return arrays


def ship_mode_chunk(lo: int, hi: int, columns=None):
    sk = np.arange(lo + 1, hi + 1, dtype=np.int64)
    i = sk - 1
    dt = S.DICTS["sm_type"]
    dc = S.DICTS["sm_code"]
    dca = S.DICTS["sm_carrier"]
    arrays = {
        "sm_ship_mode_sk": sk,
        "sm_ship_mode_id": _keyed_id("AAAAAAAA", sk, 16),
        "sm_type": dt.encode(S.SHIP_MODE_TYPES)[
            i % len(S.SHIP_MODE_TYPES)
        ].astype(np.int32),
        "sm_code": dc.encode(S.SHIP_MODE_CODES)[
            (i // len(S.SHIP_MODE_TYPES)) % len(S.SHIP_MODE_CODES)
        ].astype(np.int32),
        "sm_carrier": dca.encode(S.SHIP_CARRIERS)[
            i % len(S.SHIP_CARRIERS)
        ].astype(np.int32),
    }
    if columns is not None:
        arrays = {c: arrays[c] for c in columns}
    return arrays


def income_band_chunk(lo: int, hi: int, columns=None):
    sk = np.arange(lo + 1, hi + 1, dtype=np.int64)
    arrays = {
        "ib_income_band_sk": sk,
        "ib_lower_bound": ((sk - 1) * 10000 + 1).astype(np.int32),
        "ib_upper_bound": (sk * 10000).astype(np.int32),
    }
    arrays["ib_lower_bound"] = np.where(sk == 1, 0, arrays["ib_lower_bound"]).astype(
        np.int32
    )
    if columns is not None:
        arrays = {c: arrays[c] for c in columns}
    return arrays


# ---------------------------------------------------------------------------
# generator
# ---------------------------------------------------------------------------


class TpcdsGenerator:
    def __init__(self, sf: float, seed: int = 20030115):
        self.sf = sf
        self.seed = seed
        self.counts = {t: S.row_count(t, sf) for t in S.TABLES}

    # -- item -------------------------------------------------------------
    def item_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        n = hi - lo
        sk = np.arange(lo + 1, hi + 1, dtype=np.int64)
        r = lambda s: _rng(self.seed, "item", chunk, _ST[s])
        cat_id = r("cat").integers(1, len(S.CATEGORIES) + 1, size=n, dtype=np.int64)
        class_in_cat = r("size").integers(0, len(S.CLASS_SYLL), size=n, dtype=np.int64)
        class_idx = (cat_id - 1) * len(S.CLASS_SYLL) + class_in_cat
        brand_idx = r("brand").integers(0, len(S.BRANDS), size=n, dtype=np.int64)
        manufact_id = r("manufact").integers(1, 1001, size=n, dtype=np.int64)
        price = r("price").integers(100, 10000, size=n, dtype=np.int64)  # cents
        dcat = S.DICTS["i_category"]
        dcls = S.DICTS["i_class"]
        dbr = S.DICTS["i_brand"]
        arrays = {
            "i_item_sk": sk,
            "i_item_id": _keyed_id("AAAAAAAA", sk, 16),
            "i_item_desc": _word_soup(r("desc"), n, 100),
            "i_current_price": price,
            "i_wholesale_cost": (price * 6) // 10,
            "i_brand_id": (brand_idx + 1001001).astype(np.int32),
            "i_brand": dbr.encode(S.BRANDS)[brand_idx].astype(np.int32),
            "i_class_id": (class_idx + 1).astype(np.int32),
            "i_class": dcls.encode(S.CLASSES)[class_idx].astype(np.int32),
            "i_category_id": cat_id.astype(np.int32),
            "i_category": dcat.encode(S.CATEGORIES)[cat_id - 1].astype(np.int32),
            "i_manufact_id": manufact_id.astype(np.int32),
            "i_manufact": _keyed_id("manufact#", manufact_id, 50),
            "i_size": r("units").integers(0, len(S.ITEM_SIZES), size=n).astype(np.int32),
            "i_color": r("color").integers(0, len(S.ITEM_COLORS), size=n).astype(np.int32),
            "i_units": r("gmt").integers(0, len(S.ITEM_UNITS), size=n).astype(np.int32),
            "i_manager_id": r("manager").integers(1, 101, size=n).astype(np.int32),
            "i_product_name": _word_soup(r("name"), n, 50),
        }
        if columns is not None:
            arrays = {c: arrays[c] for c in columns}
        return arrays

    # -- small dimensions --------------------------------------------------
    def warehouse_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        n = hi - lo
        sk = np.arange(lo + 1, hi + 1, dtype=np.int64)
        r = lambda s: _rng(self.seed, "warehouse", chunk, _ST[s])
        dn = S.DICTS["w_warehouse_name"]
        dci = S.DICTS["w_city"]
        dco = S.DICTS["w_county"]
        dst = S.DICTS["w_state"]
        dctr = S.DICTS["w_country"]
        state = r("state").integers(0, len(S.STATES), size=n, dtype=np.int64)
        arrays = {
            "w_warehouse_sk": sk,
            "w_warehouse_id": _keyed_id("AAAAAAAA", sk, 16),
            "w_warehouse_name": dn.encode(
                [f"Warehouse #{1 + (k - 1) % 30}" for k in sk]
            ).astype(np.int32),
            "w_warehouse_sq_ft": r("sqft").integers(
                50_000, 1_000_001, size=n
            ).astype(np.int32),
            "w_city": dci.encode(S.DICTS["w_city"].values[
                r("city").integers(0, len(dci), size=n)
            ]).astype(np.int32),
            "w_county": dco.encode(S.COUNTIES)[
                r("county").integers(0, len(S.COUNTIES), size=n)
            ].astype(np.int32),
            "w_state": dst.encode(S.STATES)[state].astype(np.int32),
            "w_country": np.full(n, dctr.code_of("United States"), np.int32),
            "w_gmt_offset": (-(5 + (state % 6)) * 100).astype(np.int64),
        }
        if columns is not None:
            arrays = {c: arrays[c] for c in columns}
        return arrays

    def call_center_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        n = hi - lo
        sk = np.arange(lo + 1, hi + 1, dtype=np.int64)
        r = lambda s: _rng(self.seed, "call_center", chunk, _ST[s])
        dn = S.DICTS["cc_name"]
        dco = S.DICTS["cc_county"]
        dst = S.DICTS["cc_state"]
        arrays = {
            "cc_call_center_sk": sk,
            "cc_call_center_id": _keyed_id("AAAAAAAA", sk, 16),
            "cc_name": dn.encode(S.CC_NAMES)[(sk - 1) % len(S.CC_NAMES)].astype(
                np.int32
            ),
            "cc_manager": _word_soup(r("manager"), n, 40),
            "cc_mkt_id": r("market").integers(1, 7, size=n).astype(np.int32),
            "cc_county": dco.encode(S.COUNTIES)[
                r("county").integers(0, len(S.COUNTIES), size=n)
            ].astype(np.int32),
            "cc_state": dst.encode(S.STATES)[
                r("state").integers(0, len(S.STATES), size=n)
            ].astype(np.int32),
        }
        if columns is not None:
            arrays = {c: arrays[c] for c in columns}
        return arrays

    def web_site_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        n = hi - lo
        sk = np.arange(lo + 1, hi + 1, dtype=np.int64)
        r = lambda s: _rng(self.seed, "web_site", chunk, _ST[s])
        dn = S.DICTS["web_name"]
        dc = S.DICTS["web_company_name"]
        arrays = {
            "web_site_sk": sk,
            "web_site_id": _keyed_id("AAAAAAAA", sk, 16),
            "web_name": dn.encode([f"site_{(k - 1) % 30}" for k in sk]).astype(
                np.int32
            ),
            "web_company_name": dc.encode(S.WEB_COMPANY_NAMES)[
                (sk - 1) % len(S.WEB_COMPANY_NAMES)
            ].astype(np.int32),
            "web_manager": _word_soup(r("manager"), n, 40),
        }
        if columns is not None:
            arrays = {c: arrays[c] for c in columns}
        return arrays

    def web_page_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        n = hi - lo
        sk = np.arange(lo + 1, hi + 1, dtype=np.int64)
        r = lambda s: _rng(self.seed, "web_page", chunk, _ST[s])
        dt = S.DICTS["wp_type"]
        arrays = {
            "wp_web_page_sk": sk,
            "wp_web_page_id": _keyed_id("AAAAAAAA", sk, 16),
            "wp_char_count": r("charcnt").integers(
                100, 8001, size=n
            ).astype(np.int32),
            "wp_link_count": r("linkcnt").integers(2, 26, size=n).astype(np.int32),
            "wp_type": dt.encode(S.WEB_PAGE_TYPES)[
                r("wtype").integers(0, len(S.WEB_PAGE_TYPES), size=n)
            ].astype(np.int32),
        }
        if columns is not None:
            arrays = {c: arrays[c] for c in columns}
        return arrays

    def inventory_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        """Index decode over (week, item, warehouse); the cadence is a
        weekly snapshot across the sales span (dsdgen semantics)."""
        idx = np.arange(lo, hi, dtype=np.int64)
        n_wh = self.counts["warehouse"]
        n_it = self.counts["item"]
        wh = idx % n_wh
        it = (idx // n_wh) % n_it
        week = idx // (n_wh * n_it)
        r = lambda s: _rng(self.seed, "inventory", chunk, _ST[s])
        qty = r("invqty").integers(0, 1001, size=len(idx)).astype(np.int32)
        arrays = {
            "inv_date_sk": S.date_to_sk(S.SALES_DATE_LO + week * 7).astype(
                np.int64
            ),
            "inv_item_sk": it + 1,
            "inv_warehouse_sk": wh + 1,
            "inv_quantity_on_hand": qty,
        }
        arrays["inv_quantity_on_hand$valid"] = r("null4").random(len(idx)) >= 0.02
        return _project(arrays, S.TABLES["inventory"], columns)

    # -- customer & address ----------------------------------------------
    def customer_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        n = hi - lo
        sk = np.arange(lo + 1, hi + 1, dtype=np.int64)
        r = lambda s: _rng(self.seed, "customer", chunk, _ST[s])
        dsal = S.DICTS["c_salutation"]
        dpref = S.DICTS["c_preferred_cust_flag"]
        arrays = {
            "c_salutation": dsal.encode(S.SALUTATIONS)[
                r("salutation").integers(0, len(S.SALUTATIONS), size=n)
            ].astype(np.int32),
            "c_preferred_cust_flag": dpref.encode(S.YN)[
                (r("preferred").random(n) < 0.5).astype(np.int64)
            ].astype(np.int32),
            "c_customer_sk": sk,
            "c_customer_id": _keyed_id("AAAAAAAA", sk, 16),
            "c_current_cdemo_sk": r("cdemo").integers(
                1, S.FIXED_ROWS["customer_demographics"] + 1, size=n, dtype=np.int64
            ),
            "c_current_hdemo_sk": r("hdemo").integers(
                1, S.FIXED_ROWS["household_demographics"] + 1, size=n, dtype=np.int64
            ),
            "c_current_addr_sk": r("addr").integers(
                1, self.counts["customer_address"] + 1, size=n, dtype=np.int64
            ),
            "c_first_name": _word_soup(r("name"), n, 20),
            "c_last_name": _word_soup(r("desc"), n, 30),
            "c_birth_year": r("birth").integers(1924, 1993, size=n).astype(np.int32),
            "c_birth_month": r("market").integers(1, 13, size=n).astype(np.int32),
            "c_email_address": _word_soup(r("email"), n, 50),
        }
        if columns is not None:
            arrays = {c: arrays[c] for c in columns}
        return arrays

    def customer_address_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        n = hi - lo
        sk = np.arange(lo + 1, hi + 1, dtype=np.int64)
        r = lambda s: _rng(self.seed, "customer_address", chunk, _ST[s])
        dst = S.DICTS["ca_state"]
        dco = S.DICTS["ca_county"]
        dctr = S.DICTS["ca_country"]
        dloc = S.DICTS["ca_location_type"]
        # gmt offset: one of -10..-5 by state bucket
        state = r("state").integers(0, len(S.STATES), size=n, dtype=np.int64)
        gmt = -(5 + (state % 6)) * 100  # decimal(5,2) cents
        arrays = {
            "ca_address_sk": sk,
            "ca_address_id": _keyed_id("AAAAAAAA", sk, 16),
            "ca_city": _word_soup(r("city"), n, 20),
            "ca_county": dco.encode(S.COUNTIES)[
                r("county").integers(0, len(S.COUNTIES), size=n)
            ].astype(np.int32),
            "ca_state": dst.encode(S.STATES)[state].astype(np.int32),
            "ca_zip": _zip(r("zip"), n),
            "ca_country": np.full(n, dctr.code_of("United States"), np.int32),
            "ca_gmt_offset": gmt.astype(np.int64),
            "ca_location_type": r("addr").integers(0, 3, size=n).astype(np.int32),
        }
        if columns is not None:
            arrays = {c: arrays[c] for c in columns}
        return arrays

    # -- store & promotion -------------------------------------------------
    def store_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        n = hi - lo
        sk = np.arange(lo + 1, hi + 1, dtype=np.int64)
        r = lambda s: _rng(self.seed, "store", chunk, _ST[s])
        dsn = S.DICTS["s_store_name"]
        dcn = S.DICTS["s_company_name"]
        dh = S.DICTS["s_hours"]
        dst = S.DICTS["s_state"]
        dco = S.DICTS["s_county"]
        names = dsn.encode(S.STORE_NAMES)
        state = r("state").integers(0, len(S.STATES), size=n, dtype=np.int64)
        arrays = {
            "s_store_sk": sk,
            "s_store_id": _keyed_id("AAAAAAAA", sk, 16),
            "s_store_name": names[(sk - 1) % len(names)].astype(np.int32),
            "s_number_employees": r("employees").integers(200, 301, size=n).astype(np.int32),
            "s_floor_space": r("floor").integers(5_000_000, 10_000_001, size=n).astype(np.int32),
            "s_hours": dh.encode(S.STORE_HOURS)[
                r("hours").integers(0, len(S.STORE_HOURS), size=n)
            ].astype(np.int32),
            "s_manager": _word_soup(r("manager"), n, 40),
            "s_market_id": r("market").integers(1, 11, size=n).astype(np.int32),
            "s_company_id": np.ones(n, np.int32),
            "s_company_name": np.full(n, dcn.code_of("Unknown"), np.int32),
            "s_city": _word_soup(r("city"), n, 20),
            "s_county": dco.encode(S.COUNTIES)[
                r("county").integers(0, len(S.COUNTIES), size=n)
            ].astype(np.int32),
            "s_state": dst.encode(S.STATES)[state].astype(np.int32),
            "s_zip": _zip(r("zip"), n),
            "s_gmt_offset": (-(5 + (state % 6)) * 100).astype(np.int64),
        }
        if columns is not None:
            arrays = {c: arrays[c] for c in columns}
        return arrays

    def promotion_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        n = hi - lo
        sk = np.arange(lo + 1, hi + 1, dtype=np.int64)
        r = lambda s: _rng(self.seed, "promotion", chunk, _ST[s])
        dyn = S.DICTS["p_channel_dmail"]
        yn = dyn.encode(S.YN)

        def chan(stream):
            # ~87% N / 13% Y, dsdgen-ish channel activation
            return yn[(r(stream).random(n) < 0.13).astype(np.int64)].astype(np.int32)

        start = S.date_to_sk(
            r("date").integers(S.SALES_DATE_LO, S.SALES_DATE_HI - 60, size=n)
        )
        arrays = {
            "p_promo_sk": sk,
            "p_promo_id": _keyed_id("AAAAAAAA", sk, 16),
            "p_start_date_sk": start.astype(np.int64),
            "p_end_date_sk": (start + r("lines").integers(10, 61, size=n)).astype(np.int64),
            "p_item_sk": r("item").integers(1, self.counts["item"] + 1, size=n, dtype=np.int64),
            "p_cost": np.full(n, 100000, np.int64),  # 1000.00 in cents
            "p_response_target": np.ones(n, np.int32),
            "p_promo_name": _word_soup(r("name"), n, 50),
            "p_channel_dmail": chan("channel1"),
            "p_channel_email": chan("channel2"),
            "p_channel_tv": chan("channel3"),
            "p_channel_event": chan("channel4"),
            "p_discount_active": np.full(n, dyn.code_of("N"), np.int32),
        }
        if columns is not None:
            arrays = {c: arrays[c] for c in columns}
        return arrays

    # -- fact channels -----------------------------------------------------
    def _sales_core(self, table: str, prefix: str, chunk: int, lo: int, hi: int):
        """Shared sales-channel math: keys, prices, derived amounts."""
        n = hi - lo
        r = lambda s: _rng(self.seed, table, chunk, _ST[s])
        days = r("date").integers(S.SALES_DATE_LO, S.SALES_DATE_HI + 1, size=n)
        qty = r("quantity").integers(1, 101, size=n, dtype=np.int64)
        wcost = r("wholesale").integers(100, 10001, size=n, dtype=np.int64)  # cents
        listm = r("listmul").integers(100, 201, size=n, dtype=np.int64)  # 1.00-2.00x
        salesm = r("salesmul").integers(0, 101, size=n, dtype=np.int64)  # 0-100% of list
        lprice = (wcost * listm) // 100
        sprice = (lprice * salesm) // 100
        ext_list = lprice * qty
        ext_sales = sprice * qty
        ext_wcost = wcost * qty
        ext_disc = ext_list - ext_sales
        coupon = (ext_sales * (r("coupon").random(n) < 0.1)) // 5  # 20% off, 10% of rows
        net_paid = ext_sales - coupon
        tax = (net_paid * 9) // 200  # 4.5%
        arrays = {
            f"{prefix}_sold_date_sk": S.date_to_sk(days).astype(np.int64),
            f"{prefix}_item_sk": r("item").integers(
                1, self.counts["item"] + 1, size=n, dtype=np.int64
            ),
            f"{prefix}_promo_sk": r("promo").integers(
                1, self.counts["promotion"] + 1, size=n, dtype=np.int64
            ),
            f"{prefix}_quantity": qty.astype(np.int32),
            f"{prefix}_wholesale_cost": wcost,
            f"{prefix}_list_price": lprice,
            f"{prefix}_sales_price": sprice,
            f"{prefix}_ext_discount_amt": ext_disc,
            f"{prefix}_ext_sales_price": ext_sales,
            f"{prefix}_ext_wholesale_cost": ext_wcost,
            f"{prefix}_ext_list_price": ext_list,
            f"{prefix}_coupon_amt": coupon,
            f"{prefix}_net_paid": net_paid,
            f"{prefix}_net_profit": net_paid - ext_wcost,
        }
        # NULLs: ~4% of date/promo FKs (dsdgen leaves FK gaps)
        arrays[f"{prefix}_sold_date_sk$valid"] = r("null1").random(n) >= 0.04
        arrays[f"{prefix}_promo_sk$valid"] = r("null2").random(n) >= 0.04
        return arrays, r, n

    def store_sales_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        arrays, r, n = self._sales_core("store_sales", "ss", chunk, lo, hi)
        arrays["ss_sold_time_sk"] = r("soldtime").integers(
            8 * 3600, 22 * 3600, size=n, dtype=np.int64
        )
        arrays["ss_sold_time_sk$valid"] = r("null4").random(n) >= 0.04
        arrays["ss_customer_sk"] = r("customer").integers(
            1, self.counts["customer"] + 1, size=n, dtype=np.int64
        )
        arrays["ss_cdemo_sk"] = r("cdemo").integers(
            1, S.FIXED_ROWS["customer_demographics"] + 1, size=n, dtype=np.int64
        )
        arrays["ss_cdemo_sk$valid"] = r("null3").random(n) >= 0.04
        arrays["ss_hdemo_sk"] = r("hdemo").integers(
            1, S.FIXED_ROWS["household_demographics"] + 1, size=n, dtype=np.int64
        )
        arrays["ss_addr_sk"] = r("addr").integers(
            1, self.counts["customer_address"] + 1, size=n, dtype=np.int64
        )
        arrays["ss_store_sk"] = r("store").integers(
            1, self.counts["store"] + 1, size=n, dtype=np.int64
        )
        arrays["ss_store_sk$valid"] = r("null5").random(n) >= 0.02
        arrays["ss_ticket_number"] = np.arange(lo + 1, hi + 1, dtype=np.int64)
        net_paid = arrays["ss_net_paid"]
        tax = (net_paid * 9) // 200
        arrays["ss_ext_tax"] = tax
        arrays["ss_net_paid_inc_tax"] = net_paid + tax
        return _project(arrays, S.TABLES["store_sales"], columns)

    def catalog_sales_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        arrays, r, n = self._sales_core("catalog_sales", "cs", chunk, lo, hi)
        bill = r("customer").integers(
            1, self.counts["customer"] + 1, size=n, dtype=np.int64
        )
        arrays["cs_bill_customer_sk"] = bill
        arrays["cs_sold_time_sk"] = r("soldtime").integers(
            0, 86_400, size=n, dtype=np.int64
        )
        arrays["cs_sold_time_sk$valid"] = r("null5").random(n) >= 0.04
        # ~10% of orders ship to a different customer (gift shape)
        other = r("shipcust").integers(
            1, self.counts["customer"] + 1, size=n, dtype=np.int64
        )
        gift = r("retcust").random(n) < 0.1
        arrays["cs_ship_customer_sk"] = np.where(gift, other, bill)
        arrays["cs_ship_addr_sk$valid"] = r("nulladdr").random(n) >= 0.02
        arrays["cs_ship_date_sk"] = arrays["cs_sold_date_sk"] + r(
            "shipdate"
        ).integers(2, 121, size=n)
        arrays["cs_ship_date_sk$valid"] = arrays["cs_sold_date_sk$valid"] & (
            r("null4").random(n) >= 0.02
        )
        arrays["cs_ship_addr_sk"] = r("shipaddr").integers(
            1, self.counts["customer_address"] + 1, size=n, dtype=np.int64
        )
        arrays["cs_call_center_sk"] = r("callcenter").integers(
            1, self.counts["call_center"] + 1, size=n, dtype=np.int64
        )
        arrays["cs_ship_mode_sk"] = r("shipmode").integers(
            1, S.FIXED_ROWS["ship_mode"] + 1, size=n, dtype=np.int64
        )
        arrays["cs_warehouse_sk"] = r("warehouse").integers(
            1, self.counts["warehouse"] + 1, size=n, dtype=np.int64
        )
        arrays["cs_bill_cdemo_sk"] = r("cdemo").integers(
            1, S.FIXED_ROWS["customer_demographics"] + 1, size=n, dtype=np.int64
        )
        arrays["cs_bill_cdemo_sk$valid"] = r("null3").random(n) >= 0.04
        # multi-line orders (~10 lines each, like dsdgen): the official
        # q16/q94/q95 EXISTS shapes ("same order, another warehouse")
        # are vacuous when every row has a unique order number
        arrays["cs_order_number"] = np.arange(lo, hi, dtype=np.int64) // 10 + 1
        return _project(arrays, S.TABLES["catalog_sales"], columns)

    def web_sales_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        arrays, r, n = self._sales_core("web_sales", "ws", chunk, lo, hi)
        bill = r("customer").integers(
            1, self.counts["customer"] + 1, size=n, dtype=np.int64
        )
        arrays["ws_bill_customer_sk"] = bill
        other = r("shipcust").integers(
            1, self.counts["customer"] + 1, size=n, dtype=np.int64
        )
        gift = r("retcust").random(n) < 0.1
        arrays["ws_ship_customer_sk"] = np.where(gift, other, bill)
        arrays["ws_ship_customer_sk$valid"] = r("nullcust").random(n) >= 0.02
        arrays["ws_sold_time_sk"] = r("soldtime").integers(
            0, 86_400, size=n, dtype=np.int64
        )
        arrays["ws_sold_time_sk$valid"] = r("null4").random(n) >= 0.04
        arrays["ws_ship_date_sk"] = arrays["ws_sold_date_sk"] + r(
            "shipdate"
        ).integers(2, 121, size=n)
        arrays["ws_ship_date_sk$valid"] = arrays["ws_sold_date_sk$valid"] & (
            r("null5").random(n) >= 0.02
        )
        arrays["ws_ship_addr_sk"] = r("shipaddr").integers(
            1, self.counts["customer_address"] + 1, size=n, dtype=np.int64
        )
        arrays["ws_web_page_sk"] = r("webpage").integers(
            1, self.counts["web_page"] + 1, size=n, dtype=np.int64
        )
        arrays["ws_web_site_sk"] = r("website").integers(
            1, self.counts["web_site"] + 1, size=n, dtype=np.int64
        )
        arrays["ws_ship_mode_sk"] = r("shipmode").integers(
            1, S.FIXED_ROWS["ship_mode"] + 1, size=n, dtype=np.int64
        )
        arrays["ws_warehouse_sk"] = r("warehouse").integers(
            1, self.counts["warehouse"] + 1, size=n, dtype=np.int64
        )
        arrays["ws_order_number"] = np.arange(lo, hi, dtype=np.int64) // 8 + 1
        return _project(arrays, S.TABLES["web_sales"], columns)

    # -- returns channels --------------------------------------------------
    # A returns table rides its parent sales table's chunk decomposition
    # (the TPC-H orders<->lineitem stream-consistency pattern): chunk c
    # over parent rows [lo, hi) regenerates the parent's linking columns
    # with the SAME (table, chunk) Philox keys, so sr_ticket_number /
    # sr_item_sk etc. join back to real sales rows whatever order the
    # two tables are scanned in.

    def _returns_common(self, table: str, parent_chunk: dict, prefix: str,
                        chunk: int, lo: int, hi: int):
        n = hi - lo
        r = lambda s: _rng(self.seed, table, chunk, _ST[s])
        mask = r("retflag").random(n) < S.RETURN_FRACTION
        idx = np.nonzero(mask)[0]
        qty = parent_chunk[f"{prefix}_quantity"][idx].astype(np.int64)
        price = parent_chunk[f"{prefix}_sales_price"][idx]
        ret_qty = 1 + (r("retqty").integers(0, 1 << 30, size=n)[idx]
                       % np.maximum(qty, 1))
        amt = price * ret_qty
        tax = (amt * 9) // 200
        fee = r("fee").integers(50, 10_001, size=n)[idx]  # 0.50-100.00
        ship_cost = (amt * 3) // 20  # 15% of the returned amount
        refunded = amt // 2
        credit = amt - refunded
        sold = parent_chunk[f"{prefix}_sold_date_sk"][idx]
        sold_valid = parent_chunk[f"{prefix}_sold_date_sk$valid"][idx]
        ret_date = sold + r("retdate").integers(1, 91, size=n)[idx]
        reason = r("retreason").integers(
            1, S.FIXED_ROWS["reason"] + 1, size=n, dtype=np.int64
        )[idx]
        return {
            "idx": idx, "ret_qty": ret_qty.astype(np.int32),
            "amt": amt, "tax": tax, "fee": fee, "ship_cost": ship_cost,
            "refunded": refunded, "credit": credit, "ret_date": ret_date,
            "ret_date_valid": sold_valid, "reason": reason, "r": r,
        }

    def store_returns_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        parent = self.store_sales_chunk(chunk, lo, hi, [
            "ss_sold_date_sk", "ss_item_sk", "ss_customer_sk", "ss_cdemo_sk",
            "ss_hdemo_sk", "ss_addr_sk", "ss_store_sk", "ss_ticket_number",
            "ss_quantity", "ss_sales_price",
        ])
        c = self._returns_common("store_returns", parent, "ss", chunk, lo, hi)
        idx = c["idx"]
        arrays = {
            "sr_returned_date_sk": c["ret_date"],
            "sr_returned_date_sk$valid": c["ret_date_valid"],
            "sr_item_sk": parent["ss_item_sk"][idx],
            "sr_customer_sk": parent["ss_customer_sk"][idx],
            "sr_cdemo_sk": parent["ss_cdemo_sk"][idx],
            "sr_cdemo_sk$valid": parent["ss_cdemo_sk$valid"][idx],
            "sr_hdemo_sk": parent["ss_hdemo_sk"][idx],
            "sr_addr_sk": parent["ss_addr_sk"][idx],
            "sr_store_sk": parent["ss_store_sk"][idx],
            "sr_store_sk$valid": parent["ss_store_sk$valid"][idx],
            "sr_reason_sk": c["reason"],
            "sr_ticket_number": parent["ss_ticket_number"][idx],
            "sr_return_quantity": c["ret_qty"],
            "sr_return_amt": c["amt"],
            "sr_return_tax": c["tax"],
            "sr_fee": c["fee"],
            "sr_return_ship_cost": c["ship_cost"],
            "sr_refunded_cash": c["refunded"],
            "sr_store_credit": c["credit"],
            "sr_net_loss": c["tax"] + c["fee"] + c["ship_cost"],
        }
        return _project(arrays, S.TABLES["store_returns"], columns)

    def catalog_returns_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        parent = self.catalog_sales_chunk(chunk, lo, hi, [
            "cs_sold_date_sk", "cs_item_sk", "cs_bill_customer_sk",
            "cs_ship_customer_sk", "cs_ship_addr_sk", "cs_call_center_sk",
            "cs_order_number", "cs_quantity", "cs_sales_price",
        ])
        c = self._returns_common("catalog_returns", parent, "cs", chunk, lo, hi)
        idx = c["idx"]
        arrays = {
            "cr_returned_date_sk": c["ret_date"],
            "cr_returned_date_sk$valid": c["ret_date_valid"],
            "cr_item_sk": parent["cs_item_sk"][idx],
            "cr_refunded_customer_sk": parent["cs_bill_customer_sk"][idx],
            "cr_returning_customer_sk": parent["cs_ship_customer_sk"][idx],
            "cr_returning_addr_sk": parent["cs_ship_addr_sk"][idx],
            "cr_returning_addr_sk$valid": parent["cs_ship_addr_sk$valid"][idx],
            "cr_call_center_sk": parent["cs_call_center_sk"][idx],
            "cr_reason_sk": c["reason"],
            "cr_order_number": parent["cs_order_number"][idx],
            "cr_return_quantity": c["ret_qty"],
            "cr_return_amount": c["amt"],
            "cr_return_tax": c["tax"],
            "cr_fee": c["fee"],
            "cr_return_ship_cost": c["ship_cost"],
            "cr_refunded_cash": c["refunded"],
            "cr_store_credit": c["credit"],
            "cr_net_loss": c["tax"] + c["fee"] + c["ship_cost"],
        }
        return _project(arrays, S.TABLES["catalog_returns"], columns)

    def web_returns_chunk(self, chunk: int, lo: int, hi: int, columns=None):
        parent = self.web_sales_chunk(chunk, lo, hi, [
            "ws_sold_date_sk", "ws_item_sk", "ws_bill_customer_sk",
            "ws_ship_customer_sk", "ws_ship_addr_sk", "ws_order_number",
            "ws_quantity", "ws_sales_price",
        ])
        c = self._returns_common("web_returns", parent, "ws", chunk, lo, hi)
        idx = c["idx"]
        r = c["r"]
        cdemo = r("cdemo").integers(
            1, S.FIXED_ROWS["customer_demographics"] + 1, size=hi - lo,
            dtype=np.int64,
        )
        cdemo2 = r("retcust").integers(
            1, S.FIXED_ROWS["customer_demographics"] + 1, size=hi - lo,
            dtype=np.int64,
        )
        arrays = {
            "wr_returned_date_sk": c["ret_date"],
            "wr_returned_date_sk$valid": c["ret_date_valid"],
            "wr_item_sk": parent["ws_item_sk"][idx],
            "wr_refunded_customer_sk": parent["ws_bill_customer_sk"][idx],
            "wr_refunded_cdemo_sk": cdemo[idx],
            "wr_refunded_addr_sk": parent["ws_ship_addr_sk"][idx],
            "wr_returning_customer_sk": parent["ws_ship_customer_sk"][idx],
            "wr_returning_customer_sk$valid":
                parent["ws_ship_customer_sk$valid"][idx],
            "wr_returning_cdemo_sk": cdemo2[idx],
            "wr_reason_sk": c["reason"],
            "wr_order_number": parent["ws_order_number"][idx],
            "wr_return_quantity": c["ret_qty"],
            "wr_return_amt": c["amt"],
            "wr_return_tax": c["tax"],
            "wr_fee": c["fee"],
            "wr_return_ship_cost": c["ship_cost"],
            "wr_refunded_cash": c["refunded"],
            "wr_net_loss": c["tax"] + c["fee"] + c["ship_cost"],
        }
        return _project(arrays, S.TABLES["web_returns"], columns)

    # -- dispatch ----------------------------------------------------------
    def base_rows(self, table: str) -> int:
        """Generation units per table: parent sales rows for returns
        (variable output rows per chunk, like TPC-H lineitem)."""
        if table in S.RETURN_PARENT:
            return self.counts[S.RETURN_PARENT[table]]
        return self.counts[table]

    def generate(self, table: str, chunk: int, lo: int, hi: int, columns=None):
        if table == "date_dim":
            return date_dim_chunk(lo, hi, columns)
        if table == "customer_demographics":
            return customer_demographics_chunk(lo, hi, columns)
        if table == "household_demographics":
            return household_demographics_chunk(lo, hi, columns)
        if table == "time_dim":
            return time_dim_chunk(lo, hi, columns)
        if table == "reason":
            return reason_chunk(lo, hi, columns)
        if table == "ship_mode":
            return ship_mode_chunk(lo, hi, columns)
        if table == "income_band":
            return income_band_chunk(lo, hi, columns)
        return getattr(self, f"{table}_chunk")(chunk, lo, hi, columns)


def _project(arrays, schema, columns):
    """Column projection keeping $valid companions of kept columns;
    also restrict to schema order for the no-projection case."""
    if columns is None:
        keep = list(schema)
    else:
        keep = list(columns)
    out = {}
    for c in keep:
        out[c] = arrays[c]
        if c + "$valid" in arrays:
            out[c + "$valid"] = arrays[c + "$valid"]
    return out
