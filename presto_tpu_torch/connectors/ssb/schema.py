"""SSB (Star Schema Benchmark) schema: tables, types, value domains.

A copy of ``presto_tpu/connectors/ssb/schema.py`` (the port imports
nothing of the JAX package); keep the two identical.

The reference ships no SSB connector (tpch/tpcds only) — this is the
planned addition from SURVEY §6 config 5 ("SSB SF1000 with LIKE/substr
predicates as Pallas scalar-UDF kernels"); modeled on the public SSB
spec (O'Neil et al.), dbgen-derived domains. Same connector contract
and encoding rules as the TPC-H/TPC-DS connectors.
"""

from __future__ import annotations

import numpy as np

from presto_tpu_torch.batch import Dictionary
from presto_tpu_torch.spi import ColumnStats
from presto_tpu_torch.types import (
    BIGINT,
    DATE,
    INTEGER,
    DataType,
    decimal,
    fixed_bytes,
    varchar,
)

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]

#: SSB city = nation name truncated/padded to 9 chars + digit 0-9
CITIES = [f"{name[:9]:<9s}{d}" for name, _ in NATIONS for d in range(10)]

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]

MFGRS = [f"MFGR#{m}" for m in range(1, 6)]
CATEGORIES = [f"MFGR#{m}{c}" for m in range(1, 6) for c in range(1, 6)]
BRANDS = [
    f"MFGR#{m}{c}{b:02d}"
    for m in range(1, 6) for c in range(1, 6) for b in range(1, 41)
]

COLORS = (
    "almond antique aquamarine azure beige bisque black blanched blue blush "
    "brown burlywood burnished chartreuse chiffon chocolate coral cornflower "
    "cornsilk cream cyan dark deep dim dodger drab firebrick floral forest "
    "frosted gainsboro ghost goldenrod green grey honeydew hot indian ivory "
    "khaki lace lavender lawn lemon light lime linen magenta maroon medium "
    "metallic midnight mint misty moccasin navajo navy olive orange orchid "
    "pale papaya peach peru pink plum powder puff purple red rose rosy royal "
    "saddle salmon sandy seashell sienna sky slate smoke snow spring steel "
    "tan thistle tomato turquoise violet wheat white yellow"
).split()

TYPES = [
    f"{a} {b} {c}"
    for a in ["ECONOMY", "LARGE", "MEDIUM", "PROMO", "SMALL", "STANDARD"]
    for b in ["ANODIZED", "BRUSHED", "BURNISHED", "PLATED", "POLISHED"]
    for c in ["BRASS", "COPPER", "NICKEL", "STEEL", "TIN"]
]
CONTAINERS = [
    f"{a} {b}"
    for a in ["SM", "LG", "MED", "JUMBO", "WRAP"]
    for b in ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
]

MONTH_NAMES = ["Jan", "Feb", "Mar", "Apr", "May", "Jun",
               "Jul", "Aug", "Sep", "Oct", "Nov", "Dec"]
YEARMONTHS = [f"{m}{y}" for y in range(1992, 1999) for m in MONTH_NAMES]
DAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
             "Friday", "Saturday"]
SEASONS = ["Christmas", "Easter", "Fall", "Summer", "Winter"]

#: date span 1992-01-01 .. 1998-12-31 (days since 1970-01-01)
STARTDATE = 8035
ENDDATE = 10591
DATE_ROWS = ENDDATE - STARTDATE + 1  # 2557

DICTS = {
    "c_city": Dictionary(CITIES),
    "c_nation": Dictionary([n for n, _ in NATIONS]),
    "c_region": Dictionary(REGIONS),
    "c_mktsegment": Dictionary(SEGMENTS),
    "s_city": Dictionary(CITIES),
    "s_nation": Dictionary([n for n, _ in NATIONS]),
    "s_region": Dictionary(REGIONS),
    "p_mfgr": Dictionary(MFGRS),
    "p_category": Dictionary(CATEGORIES),
    "p_brand1": Dictionary(BRANDS),
    "p_color": Dictionary(COLORS),
    "p_type": Dictionary(TYPES),
    "p_container": Dictionary(CONTAINERS),
    "lo_orderpriority": Dictionary(PRIORITIES),
    "lo_shipmode": Dictionary(SHIPMODES),
    "d_yearmonth": Dictionary(YEARMONTHS),
    "d_dayofweek": Dictionary(DAY_NAMES),
    "d_sellingseason": Dictionary(SEASONS),
    "d_month": Dictionary(["April", "August", "December", "February",
                           "January", "July", "June", "March", "May",
                           "November", "October", "September"]),
}

TABLES: dict[str, dict[str, DataType]] = {
    "lineorder": {
        "lo_orderkey": BIGINT,
        "lo_linenumber": INTEGER,
        "lo_custkey": BIGINT,
        "lo_partkey": BIGINT,
        "lo_suppkey": BIGINT,
        "lo_orderdate": BIGINT,  # yyyymmdd FK to date.d_datekey
        "lo_orderpriority": varchar(),
        "lo_shippriority": INTEGER,
        "lo_quantity": decimal(12, 2),
        "lo_extendedprice": decimal(12, 2),
        "lo_ordtotalprice": decimal(12, 2),
        "lo_discount": decimal(12, 2),
        "lo_revenue": decimal(12, 2),
        "lo_supplycost": decimal(12, 2),
        "lo_tax": decimal(12, 2),
        "lo_commitdate": BIGINT,
        "lo_shipmode": varchar(),
    },
    "date": {
        "d_datekey": BIGINT,  # yyyymmdd
        "d_date": DATE,
        "d_dayofweek": varchar(),
        "d_month": varchar(),
        "d_year": INTEGER,
        "d_yearmonthnum": INTEGER,  # yyyymm
        "d_yearmonth": varchar(),  # 'Mar1994'
        "d_daynuminweek": INTEGER,
        "d_daynuminmonth": INTEGER,
        "d_daynuminyear": INTEGER,
        "d_monthnuminyear": INTEGER,
        "d_weeknuminyear": INTEGER,
        "d_sellingseason": varchar(),
        "d_holidayfl": INTEGER,
        "d_weekdayfl": INTEGER,
    },
    "customer": {
        "c_custkey": BIGINT,
        "c_name": fixed_bytes(25),
        "c_address": fixed_bytes(25),
        "c_city": varchar(),
        "c_nation": varchar(),
        "c_region": varchar(),
        "c_phone": fixed_bytes(15),
        "c_mktsegment": varchar(),
    },
    "supplier": {
        "s_suppkey": BIGINT,
        "s_name": fixed_bytes(25),
        "s_address": fixed_bytes(25),
        "s_city": varchar(),
        "s_nation": varchar(),
        "s_region": varchar(),
        "s_phone": fixed_bytes(15),
    },
    "part": {
        "p_partkey": BIGINT,
        "p_name": fixed_bytes(22),
        "p_mfgr": varchar(),
        "p_category": varchar(),
        "p_brand1": varchar(),
        "p_color": varchar(),
        "p_type": varchar(),
        "p_size": INTEGER,
        "p_container": varchar(),
    },
}

UNIQUE_KEYS: dict[str, tuple[tuple[str, ...], ...]] = {
    "lineorder": (("lo_orderkey", "lo_linenumber"),),
    "date": (("d_datekey",), ("d_date",)),
    "customer": (("c_custkey",), ("c_name",)),  # c_name = 'Customer#<key>'
    "supplier": (("s_suppkey",), ("s_name",)),
    "part": (("p_partkey",),),
}

ROWS_PER_SF = {
    "lineorder": 6_000_000,
    "customer": 30_000,
    "supplier": 2_000,
    "part": 200_000,
}


def row_count(table: str, sf: float) -> int:
    if table == "date":
        return DATE_ROWS
    # dimension floors keep the 250-city / 1000-brand domains populated
    # at tiny test scale factors (spec constants assume SF >= 1)
    mins = {"customer": 3000, "supplier": 400, "part": 2000, "lineorder": 1000}
    return max(int(ROWS_PER_SF[table] * sf), mins[table])


def table_dicts(table: str) -> dict[str, Dictionary]:
    return {c: DICTS[c] for c in TABLES[table] if c in DICTS}


def column_stats(table: str, column: str, sf: float) -> "ColumnStats":
    """Exact per-column domains (generator.py formulas; SSB spec). The
    bounds drive both join-key packing widths and narrow physical
    storage, so they must COVER the generator output — from_numpy
    range-checks narrowed columns and fails loudly on violation."""
    n = row_count(table, sf)
    # lineorder keys: idx // 4 + 1 over idx in [0, n)
    lo_maxorder = (row_count("lineorder", sf) - 1) // 4 + 1
    special = {
        ("lineorder", "lo_orderkey"): ColumnStats(lo_maxorder, 1, lo_maxorder),
        ("lineorder", "lo_linenumber"): ColumnStats(4, 1, 4),
        ("lineorder", "lo_custkey"): ColumnStats(
            row_count("customer", sf), 1, row_count("customer", sf)),
        ("lineorder", "lo_partkey"): ColumnStats(
            row_count("part", sf), 1, row_count("part", sf)),
        ("lineorder", "lo_suppkey"): ColumnStats(
            row_count("supplier", sf), 1, row_count("supplier", sf)),
        ("lineorder", "lo_orderdate"): ColumnStats(
            DATE_ROWS, 19920101, 19981231),
        ("lineorder", "lo_commitdate"): ColumnStats(
            DATE_ROWS, 19920101, 19981231),
        ("lineorder", "lo_shippriority"): ColumnStats(1, 0, 0),
        ("lineorder", "lo_quantity"): ColumnStats(50, 1, 50),
        # ext = qty * (price_cents // 100) // 10 with price_cents in
        # [90001, 1999999]: max 50 * 19999 // 10 = 99995 cents
        ("lineorder", "lo_extendedprice"): ColumnStats(900_000, 0.90, 999.95),
        ("lineorder", "lo_ordtotalprice"): ColumnStats(900_000, 3.60, 3999.80),
        # SSB discount/tax are WHOLE numbers (1.00 = "1%"), unlike
        # TPC-H's fractional l_discount: generator stores disc*100
        ("lineorder", "lo_discount"): ColumnStats(11, 0.0, 10.0),
        ("lineorder", "lo_revenue"): ColumnStats(900_000, 0.81, 999.95),
        ("lineorder", "lo_supplycost"): ColumnStats(20_000, 5.40, 119.99),
        ("lineorder", "lo_tax"): ColumnStats(9, 0.0, 8.0),
        ("date", "d_datekey"): ColumnStats(DATE_ROWS, 19920101, 19981231),
        ("date", "d_date"): ColumnStats(DATE_ROWS, STARTDATE, ENDDATE),
        ("date", "d_year"): ColumnStats(7, 1992, 1998),
        ("date", "d_yearmonthnum"): ColumnStats(84, 199201, 199812),
        ("date", "d_daynuminweek"): ColumnStats(7, 1, 7),
        ("date", "d_daynuminmonth"): ColumnStats(31, 1, 31),
        ("date", "d_daynuminyear"): ColumnStats(366, 1, 366),
        ("date", "d_monthnuminyear"): ColumnStats(12, 1, 12),
        ("date", "d_weeknuminyear"): ColumnStats(53, 1, 53),
        ("date", "d_holidayfl"): ColumnStats(2, 0, 1),
        ("date", "d_weekdayfl"): ColumnStats(2, 0, 1),
        ("customer", "c_custkey"): ColumnStats(n, 1, n),
        ("supplier", "s_suppkey"): ColumnStats(n, 1, n),
        ("part", "p_partkey"): ColumnStats(n, 1, n),
        ("part", "p_size"): ColumnStats(50, 1, 50),
    }
    if (table, column) in special:
        return special[(table, column)]
    return ColumnStats(min(n, 1 << 20))
