"""TPC-H schema: tables, types, value domains, and column statistics.

A copy of ``presto_tpu/connectors/tpch/schema.py`` (the port imports
nothing of the JAX package); keep the two identical.

Reference parity: ``presto-tpch`` (``TpchMetadata``, ``TpchSplitManager``,
the ``io.airlift.tpch`` row generator, and the hardcoded column statistics
used by the CBO) [SURVEY §2.2; reference tree unavailable, paths
reconstructed]. Domains/distributions follow the public TPC-H
specification v3 (dbgen *semantics*, not dbgen code — output is
deterministic but not byte-identical to dbgen's RNG stream).

Low-cardinality strings are ordered-dictionary VARCHAR columns; composed
or free-text strings (p_name, comments, addresses) are fixed-width BYTES
columns sized to the spec's maximum lengths, which is what the Pallas
LIKE/substr kernels operate on.
"""

from __future__ import annotations

from dataclasses import dataclass

from presto_tpu_torch.batch import Dictionary
from presto_tpu_torch.types import (
    BIGINT,
    DATE,
    DOUBLE,
    INTEGER,
    DataType,
    decimal,
    fixed_bytes,
    varchar,
)

# ---------------------------------------------------------------------------
# Value domains (TPC-H spec v3 word lists)
# ---------------------------------------------------------------------------

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

# (name, region index)
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
RETURNFLAGS = ["R", "A", "N"]
LINESTATUS = ["O", "F"]
ORDERSTATUS = ["F", "O", "P"]

TYPE_SYLL1 = ["ECONOMY", "LARGE", "MEDIUM", "PROMO", "SMALL", "STANDARD"]
TYPE_SYLL2 = ["ANODIZED", "BRUSHED", "BURNISHED", "PLATED", "POLISHED"]
TYPE_SYLL3 = ["BRASS", "COPPER", "NICKEL", "STEEL", "TIN"]
P_TYPES = [f"{a} {b} {c}" for a in TYPE_SYLL1 for b in TYPE_SYLL2 for c in TYPE_SYLL3]

CONT_SYLL1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONT_SYLL2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
P_CONTAINERS = [f"{a} {b}" for a in CONT_SYLL1 for b in CONT_SYLL2]

P_BRANDS = [f"Brand#{m}{n}" for m in range(1, 6) for n in range(1, 6)]

# P_NAME color word list (92 words, TPC-H spec)
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

# Comment text vocabulary: random word soup with the spec's LIKE-target
# phrases ("special requests", "Customer Complaints") occurring at
# realistic low frequencies via dedicated injection (see generator).
COMMENT_WORDS = (
    "furiously quickly carefully slyly blithely fluffily express final bold "
    "regular unusual pending ironic silent daring even special packages "
    "requests deposits accounts instructions theodolites foxes pinto beans "
    "dependencies excuses platelets asymptotes courts dolphins multipliers "
    "sauternes warhorses frets dinos attainments somas Tiresias patterns "
    "forges braids hockey players frays warthogs sentiments realms pains "
    "grouches escapades sleep wake about above according across after "
    "against along among around at before between into like near of upon "
    "the waters nag integrate boost affix detect cajole"
).split()

# dates: stored as int32 days since 1970-01-01
STARTDATE = 8035  # 1992-01-01
CURRENTDATE = 9298  # 1995-06-17
ENDDATE = 10591  # 1998-12-31
ORDER_MAXDATE = 10591 - 151  # o_orderdate in [1992-01-01, 1998-08-02]

# rows per unit scale factor
ROWS_PER_SF = {
    "customer": 150_000,
    "orders": 1_500_000,
    "lineitem": None,  # derived from orders (1-7 lines each)
    "part": 200_000,
    "partsupp": 800_000,  # 4 per part
    "supplier": 10_000,
    "nation": 25,
    "region": 5,
}

SUPPLIERS_PER_PART = 4

# ---------------------------------------------------------------------------
# Shared dictionaries (one instance per process keeps jit caches warm)
# ---------------------------------------------------------------------------

DICTS = {
    "r_name": Dictionary(REGIONS),
    "n_name": Dictionary([n for n, _ in NATIONS]),
    "c_mktsegment": Dictionary(SEGMENTS),
    "o_orderstatus": Dictionary(ORDERSTATUS),
    "o_orderpriority": Dictionary(PRIORITIES),
    "l_returnflag": Dictionary(RETURNFLAGS),
    "l_linestatus": Dictionary(LINESTATUS),
    "l_shipinstruct": Dictionary(INSTRUCTS),
    "l_shipmode": Dictionary(MODES),
    "p_brand": Dictionary(P_BRANDS),
    "p_type": Dictionary(P_TYPES),
    "p_container": Dictionary(P_CONTAINERS),
}

# ---------------------------------------------------------------------------
# Table schemas
# ---------------------------------------------------------------------------

TABLES: dict[str, dict[str, DataType]] = {
    "region": {
        "r_regionkey": BIGINT,
        "r_name": varchar(),
        "r_comment": fixed_bytes(120),
    },
    "nation": {
        "n_nationkey": BIGINT,
        "n_name": varchar(),
        "n_regionkey": BIGINT,
        "n_comment": fixed_bytes(120),
    },
    "supplier": {
        "s_suppkey": BIGINT,
        "s_name": fixed_bytes(18),
        "s_address": fixed_bytes(40),
        "s_nationkey": BIGINT,
        "s_phone": fixed_bytes(15),
        "s_acctbal": decimal(12, 2),
        "s_comment": fixed_bytes(101),
    },
    "customer": {
        "c_custkey": BIGINT,
        "c_name": fixed_bytes(18),
        "c_address": fixed_bytes(40),
        "c_nationkey": BIGINT,
        "c_phone": fixed_bytes(15),
        "c_acctbal": decimal(12, 2),
        "c_mktsegment": varchar(),
        "c_comment": fixed_bytes(117),
    },
    "part": {
        "p_partkey": BIGINT,
        "p_name": fixed_bytes(55),
        "p_mfgr": fixed_bytes(25),
        "p_brand": varchar(),
        "p_type": varchar(),
        "p_size": INTEGER,
        "p_container": varchar(),
        "p_retailprice": decimal(12, 2),
        "p_comment": fixed_bytes(23),
    },
    "partsupp": {
        "ps_partkey": BIGINT,
        "ps_suppkey": BIGINT,
        "ps_availqty": INTEGER,
        "ps_supplycost": decimal(12, 2),
        "ps_comment": fixed_bytes(199),
    },
    "orders": {
        "o_orderkey": BIGINT,
        "o_custkey": BIGINT,
        "o_orderstatus": varchar(),
        "o_totalprice": decimal(12, 2),
        "o_orderdate": DATE,
        "o_orderpriority": varchar(),
        "o_clerk": fixed_bytes(15),
        "o_shippriority": INTEGER,
        "o_comment": fixed_bytes(79),
    },
    "lineitem": {
        "l_orderkey": BIGINT,
        "l_partkey": BIGINT,
        "l_suppkey": BIGINT,
        "l_linenumber": INTEGER,
        "l_quantity": decimal(12, 2),
        "l_extendedprice": decimal(12, 2),
        "l_discount": decimal(12, 2),
        "l_tax": decimal(12, 2),
        "l_returnflag": varchar(),
        "l_linestatus": varchar(),
        "l_shipdate": DATE,
        "l_commitdate": DATE,
        "l_receiptdate": DATE,
        "l_shipinstruct": varchar(),
        "l_shipmode": varchar(),
        "l_comment": fixed_bytes(44),
    },
}


def table_dicts(table: str) -> dict[str, Dictionary]:
    return {c: DICTS[c] for c in TABLES[table] if c in DICTS}


@dataclass(frozen=True)
class ColumnStats:
    """Connector-provided statistics for the cost-based optimizer
    (reference parity: TpchMetadata's hardcoded stats [SURVEY §2.2])."""

    ndv: float
    min_value: float | None = None
    max_value: float | None = None
    null_fraction: float = 0.0


def row_count(table: str, sf: float) -> int:
    if table == "lineitem":
        # expected ~4.0 lines/order (uniform 1..7)
        return int(ROWS_PER_SF["orders"] * sf * 4)
    base = ROWS_PER_SF[table]
    if table in ("nation", "region"):
        return base
    return int(base * sf)


def column_stats(table: str, column: str, sf: float) -> ColumnStats:
    n = row_count(table, sf)
    keyspace = {
        "customer": 150_000 * sf,
        "orders": 6_000_000 * sf,
        "part": 200_000 * sf,
        "supplier": 10_000 * sf,
    }
    special = {
        ("lineitem", "l_orderkey"): ColumnStats(1_500_000 * sf, 1, 6_000_000 * sf),
        ("lineitem", "l_partkey"): ColumnStats(200_000 * sf, 1, 200_000 * sf),
        ("lineitem", "l_suppkey"): ColumnStats(10_000 * sf, 1, 10_000 * sf),
        ("lineitem", "l_quantity"): ColumnStats(50, 1, 50),
        # money columns: bounds from the generator formulas
        # (retail_price_cents in [90000, 209900]; qty in [1, 50];
        # totalprice <= 7 lines * max charge; balances in cents)
        ("lineitem", "l_extendedprice"): ColumnStats(950_000, 900.0, 104_950.0),
        ("orders", "o_totalprice"): ColumnStats(1_500_000 * sf, 810.0, 800_000.0),
        ("part", "p_retailprice"): ColumnStats(20_000, 900.0, 2_099.0),
        ("partsupp", "ps_supplycost"): ColumnStats(100_000, 1.0, 1_000.01),
        ("customer", "c_acctbal"): ColumnStats(1_000_000, -999.99, 10_000.0),
        ("supplier", "s_acctbal"): ColumnStats(1_000_000, -999.99, 10_000.0),
        ("partsupp", "ps_availqty"): ColumnStats(9_999, 1, 9_999),
        ("lineitem", "l_discount"): ColumnStats(11, 0.0, 0.10),
        ("lineitem", "l_tax"): ColumnStats(9, 0.0, 0.08),
        ("lineitem", "l_shipdate"): ColumnStats(2526, STARTDATE, ENDDATE),
        # commitdate = odate + [30, 90], receiptdate = shipdate + [1, 30]:
        # both inside the [STARTDATE, ENDDATE] calendar (generator.py)
        ("lineitem", "l_commitdate"): ColumnStats(2526, STARTDATE, ENDDATE),
        ("lineitem", "l_receiptdate"): ColumnStats(2526, STARTDATE, ENDDATE),
        ("lineitem", "l_linenumber"): ColumnStats(7, 1, 7),
        ("orders", "o_shippriority"): ColumnStats(1, 0, 0),
        ("lineitem", "l_returnflag"): ColumnStats(3),
        ("lineitem", "l_linestatus"): ColumnStats(2),
        ("lineitem", "l_shipmode"): ColumnStats(7),
        ("lineitem", "l_shipinstruct"): ColumnStats(4),
        ("orders", "o_orderkey"): ColumnStats(1_500_000 * sf, 1, 6_000_000 * sf),
        ("orders", "o_custkey"): ColumnStats(100_000 * sf, 1, 150_000 * sf),
        ("orders", "o_orderdate"): ColumnStats(2406, STARTDATE, ORDER_MAXDATE),
        ("orders", "o_orderstatus"): ColumnStats(3),
        ("orders", "o_orderpriority"): ColumnStats(5),
        ("customer", "c_custkey"): ColumnStats(150_000 * sf, 1, 150_000 * sf),
        ("customer", "c_mktsegment"): ColumnStats(5),
        ("customer", "c_nationkey"): ColumnStats(25, 0, 24),
        ("part", "p_partkey"): ColumnStats(200_000 * sf, 1, 200_000 * sf),
        ("part", "p_brand"): ColumnStats(25),
        ("part", "p_type"): ColumnStats(150),
        ("part", "p_container"): ColumnStats(40),
        ("part", "p_size"): ColumnStats(50, 1, 50),
        ("partsupp", "ps_partkey"): ColumnStats(200_000 * sf, 1, 200_000 * sf),
        ("partsupp", "ps_suppkey"): ColumnStats(10_000 * sf, 1, 10_000 * sf),
        ("supplier", "s_suppkey"): ColumnStats(10_000 * sf, 1, 10_000 * sf),
        ("supplier", "s_nationkey"): ColumnStats(25, 0, 24),
        ("nation", "n_nationkey"): ColumnStats(25, 0, 24),
        ("nation", "n_regionkey"): ColumnStats(5, 0, 4),
        ("region", "r_regionkey"): ColumnStats(5, 0, 4),
    }
    if (table, column) in special:
        return special[(table, column)]
    return ColumnStats(min(n, 1 << 20))
