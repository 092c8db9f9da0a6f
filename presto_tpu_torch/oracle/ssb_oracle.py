"""Independent numpy oracle for the SSB query flights (the H2QueryRunner
role) over ``oracle.frame``; consumes the connector's ``table_logical``
frames. Each function reads line for line against
``presto_tpu.oracle.ssb_oracle``."""

from __future__ import annotations

import numpy as np

from presto_tpu_torch.oracle import frame as fr


def _lo_date(t):
    return t["lineorder"].merge(t["date"], left_on="lo_orderdate",
                                right_on="d_datekey")


def q1_1(t):
    j = _lo_date(t)
    j = j[(j.d_year == 1993) & j.lo_discount.between(1, 3) & (j.lo_quantity < 25)]
    return fr.DataFrame({"revenue": [(j.lo_extendedprice * j.lo_discount).sum()]})


def q1_2(t):
    j = _lo_date(t)
    j = j[(j.d_yearmonthnum == 199401) & j.lo_discount.between(4, 6)
          & j.lo_quantity.between(26, 35)]
    return fr.DataFrame({"revenue": [(j.lo_extendedprice * j.lo_discount).sum()]})


def q1_3(t):
    j = _lo_date(t)
    j = j[(j.d_weeknuminyear == 6) & (j.d_year == 1994)
          & j.lo_discount.between(5, 7) & j.lo_quantity.between(26, 35)]
    return fr.DataFrame({"revenue": [(j.lo_extendedprice * j.lo_discount).sum()]})


def _q2(t, part_pred, region):
    j = _lo_date(t)
    p = t["part"]
    j = j.merge(p[part_pred(p)], left_on="lo_partkey", right_on="p_partkey")
    s = t["supplier"]
    j = j.merge(s[s.s_region == region], left_on="lo_suppkey", right_on="s_suppkey")
    g = j.groupby(["d_year", "p_brand1"], as_index=False).agg(
        revenue=("lo_revenue", "sum")
    )
    g = g.sort_values(["d_year", "p_brand1"], kind="stable").reset_index(drop=True)
    return g[["revenue", "d_year", "p_brand1"]]


def q2_1(t):
    return _q2(t, lambda p: p.p_category == "MFGR#12", "AMERICA")


def q2_2(t):
    return _q2(
        t, lambda p: p.p_brand1.between("MFGR#2221", "MFGR#2228"), "ASIA"
    )


def q2_3(t):
    return _q2(t, lambda p: p.p_brand1 == "MFGR#2239", "EUROPE")


def _q3(t, cpred, spred, dpred, ckey, skey):
    j = _lo_date(t)
    c = t["customer"]
    s = t["supplier"]
    j = j.merge(c[cpred(c)], left_on="lo_custkey", right_on="c_custkey")
    j = j.merge(s[spred(s)], left_on="lo_suppkey", right_on="s_suppkey")
    j = j[dpred(j)]
    g = j.groupby([ckey, skey, "d_year"], as_index=False).agg(
        revenue=("lo_revenue", "sum")
    )
    g = g.sort_values(["d_year", "revenue"], ascending=[True, False],
                      kind="stable").reset_index(drop=True)
    return g[[ckey, skey, "d_year", "revenue"]]


def q3_1(t):
    return _q3(
        t, lambda c: c.c_region == "ASIA", lambda s: s.s_region == "ASIA",
        lambda j: j.d_year.between(1992, 1997), "c_nation", "s_nation",
    )


def q3_2(t):
    return _q3(
        t, lambda c: c.c_nation == "UNITED STATES",
        lambda s: s.s_nation == "UNITED STATES",
        lambda j: j.d_year.between(1992, 1997), "c_city", "s_city",
    )


def q3_3(t):
    cities = ["UNITED KI1", "UNITED KI5"]
    return _q3(
        t, lambda c: c.c_city.isin(cities), lambda s: s.s_city.isin(cities),
        lambda j: j.d_year.between(1992, 1997), "c_city", "s_city",
    )


def q3_4(t):
    cities = ["UNITED KI1", "UNITED KI5"]
    return _q3(
        t, lambda c: c.c_city.isin(cities), lambda s: s.s_city.isin(cities),
        lambda j: j.d_yearmonth == "Dec1997", "c_city", "s_city",
    )


def _q4(t, cpred, spred, ppred, dpred, keys):
    j = _lo_date(t)
    j = j.merge(t["customer"][cpred(t["customer"])],
                left_on="lo_custkey", right_on="c_custkey")
    j = j.merge(t["supplier"][spred(t["supplier"])],
                left_on="lo_suppkey", right_on="s_suppkey")
    j = j.merge(t["part"][ppred(t["part"])],
                left_on="lo_partkey", right_on="p_partkey")
    j = j[dpred(j)].copy()
    j["profit"] = j.lo_revenue - j.lo_supplycost
    g = j.groupby(keys, as_index=False).agg(profit=("profit", "sum"))
    g = g.sort_values(keys, kind="stable").reset_index(drop=True)
    return g[keys + ["profit"]]


def q4_1(t):
    return _q4(
        t, lambda c: c.c_region == "AMERICA", lambda s: s.s_region == "AMERICA",
        lambda p: p.p_mfgr.isin(["MFGR#1", "MFGR#2"]), lambda j: np.ones(len(j), bool),
        ["d_year", "c_nation"],
    )


def q4_2(t):
    return _q4(
        t, lambda c: c.c_region == "AMERICA", lambda s: s.s_region == "AMERICA",
        lambda p: p.p_mfgr.isin(["MFGR#1", "MFGR#2"]),
        lambda j: j.d_year.isin([1997, 1998]),
        ["d_year", "s_nation", "p_category"],
    )


def q4_3(t):
    return _q4(
        t, lambda c: np.ones(len(c), bool),
        lambda s: s.s_nation == "UNITED STATES",
        lambda p: p.p_category == "MFGR#14",
        lambda j: j.d_year.isin([1997, 1998]),
        ["d_year", "s_city", "p_brand1"],
    )


def q_like_part(t):
    p = t["part"]
    j = t["lineorder"].merge(
        p[p.p_name.str.contains("sky")], left_on="lo_partkey", right_on="p_partkey"
    )
    return fr.DataFrame(
        {"cnt": [len(j)], "revenue": [j.lo_revenue.sum()]}
    )


def q_like_phone(t):
    c = t["customer"]
    c = c[c.c_name.str.match(r"Customer.*1$") & (c.c_phone.str[:2] != "33")]
    j = t["lineorder"].merge(c, left_on="lo_custkey", right_on="c_custkey")
    g = j.groupby("c_region", as_index=False).agg(cnt=("lo_orderkey", "size"))
    g["cnt"] = g["cnt"].astype(np.int64)
    return g.sort_values("c_region", kind="stable").reset_index(drop=True)


ORACLES = {
    name: globals()[name]
    for name in ["q1_1", "q1_2", "q1_3", "q2_1", "q2_2", "q2_3",
                 "q3_1", "q3_2", "q3_3", "q3_4", "q4_1", "q4_2", "q4_3",
                 "q_like_part", "q_like_phone"]
}
