"""Independent numpy oracle for the 22 TPC-H queries.

The ``H2QueryRunner`` role: every SQL test runs the same query on an
independent engine and diffs the results. These are hand-written
translations of the query *semantics* (from the public TPC-H spec) over
``oracle.frame``, sharing no code with the engine's planner or kernels;
the inputs are the connector's ``table_logical`` frames. Each function
reads line for line against ``presto_tpu.oracle.tpch_oracle``.
"""

from __future__ import annotations

import numpy as np

from presto_tpu_torch.oracle import frame as fr

D = np.datetime64


def _rev(df):
    return df.l_extendedprice * (1 - df.l_discount)


def q1(t):
    li = t["lineitem"]
    m = li.l_shipdate <= D("1998-09-02")
    d = li[m].copy()
    d["disc_price"] = _rev(d)
    d["charge"] = d.disc_price * (1 + d.l_tax)
    g = d.groupby(["l_returnflag", "l_linestatus"], as_index=False).agg(
        sum_qty=("l_quantity", "sum"),
        sum_base_price=("l_extendedprice", "sum"),
        sum_disc_price=("disc_price", "sum"),
        sum_charge=("charge", "sum"),
        avg_qty=("l_quantity", "mean"),
        avg_price=("l_extendedprice", "mean"),
        avg_disc=("l_discount", "mean"),
        count_order=("l_quantity", "size"),
    )
    return g.sort_values(["l_returnflag", "l_linestatus"]).reset_index(drop=True)


def q2(t):
    p, s, ps, n, r = t["part"], t["supplier"], t["partsupp"], t["nation"], t["region"]
    eu = n.merge(r[r.r_name == "EUROPE"], left_on="n_regionkey", right_on="r_regionkey")
    sup = s.merge(eu, left_on="s_nationkey", right_on="n_nationkey")
    j = ps.merge(sup, left_on="ps_suppkey", right_on="s_suppkey")
    pp = p[(p.p_size == 15) & p.p_type.str.endswith("BRASS")]
    j = j.merge(pp, left_on="ps_partkey", right_on="p_partkey")
    mn = j.groupby("p_partkey")["ps_supplycost"].transform("min")
    j = j[j.ps_supplycost == mn]
    j = j.sort_values(
        ["s_acctbal", "n_name", "s_name", "p_partkey"],
        ascending=[False, True, True, True], kind="stable",
    ).head(100)
    return j[["s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr",
              "s_address", "s_phone", "s_comment"]].reset_index(drop=True)


def q3(t):
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    c = c[c.c_mktsegment == "BUILDING"]
    o = o[o.o_orderdate < D("1995-03-15")]
    li = li[li.l_shipdate > D("1995-03-15")].copy()
    j = li.merge(o.merge(c, left_on="o_custkey", right_on="c_custkey"),
                 left_on="l_orderkey", right_on="o_orderkey")
    j["revenue"] = _rev(j)
    g = j.groupby(["l_orderkey", "o_orderdate", "o_shippriority"], as_index=False)[
        "revenue"
    ].sum()
    g = g.sort_values(["revenue", "o_orderdate"], ascending=[False, True],
                      kind="stable").head(10)
    return g[["l_orderkey", "revenue", "o_orderdate", "o_shippriority"]].reset_index(
        drop=True
    )


def q4(t):
    o, li = t["orders"], t["lineitem"]
    o = o[(o.o_orderdate >= D("1993-07-01")) & (o.o_orderdate < D("1993-10-01"))]
    late = li[li.l_commitdate < li.l_receiptdate].l_orderkey.unique()
    o = o[o.o_orderkey.isin(late)]
    g = o.groupby("o_orderpriority", as_index=False).size()
    g.columns = ["o_orderpriority", "order_count"]
    return g.sort_values("o_orderpriority").reset_index(drop=True)


def q5(t):
    c, o, li, s, n, r = (t["customer"], t["orders"], t["lineitem"],
                         t["supplier"], t["nation"], t["region"])
    asia = n.merge(r[r.r_name == "ASIA"], left_on="n_regionkey",
                   right_on="r_regionkey")
    o = o[(o.o_orderdate >= D("1994-01-01")) & (o.o_orderdate < D("1995-01-01"))]
    j = li.merge(o, left_on="l_orderkey", right_on="o_orderkey")
    j = j.merge(c, left_on="o_custkey", right_on="c_custkey")
    j = j.merge(s, left_on="l_suppkey", right_on="s_suppkey")
    j = j[j.c_nationkey == j.s_nationkey]
    j = j.merge(asia, left_on="s_nationkey", right_on="n_nationkey")
    j["revenue"] = _rev(j)
    g = j.groupby("n_name", as_index=False)["revenue"].sum()
    return g.sort_values("revenue", ascending=False).reset_index(drop=True)


def q6(t):
    li = t["lineitem"]
    m = (
        (li.l_shipdate >= D("1994-01-01")) & (li.l_shipdate < D("1995-01-01"))
        & (li.l_discount >= 0.05 - 1e-9) & (li.l_discount <= 0.07 + 1e-9)
        & (li.l_quantity < 24)
    )
    return fr.DataFrame({"revenue": [(li[m].l_extendedprice * li[m].l_discount).sum()]})


def _q7_shipping(t):
    s, li, o, c, n = (t["supplier"], t["lineitem"], t["orders"], t["customer"],
                      t["nation"])
    j = li.merge(s, left_on="l_suppkey", right_on="s_suppkey")
    j = j.merge(o, left_on="l_orderkey", right_on="o_orderkey")
    j = j.merge(c, left_on="o_custkey", right_on="c_custkey")
    n1 = n[["n_nationkey", "n_name"]].rename(
        columns={"n_nationkey": "sk", "n_name": "supp_nation"})
    n2 = n[["n_nationkey", "n_name"]].rename(
        columns={"n_nationkey": "ck", "n_name": "cust_nation"})
    j = j.merge(n1, left_on="s_nationkey", right_on="sk")
    j = j.merge(n2, left_on="c_nationkey", right_on="ck")
    return j


def q7(t):
    j = _q7_shipping(t)
    m = (
        ((j.supp_nation == "FRANCE") & (j.cust_nation == "GERMANY"))
        | ((j.supp_nation == "GERMANY") & (j.cust_nation == "FRANCE"))
    ) & (j.l_shipdate >= D("1995-01-01")) & (j.l_shipdate <= D("1996-12-31"))
    d = j[m].copy()
    d["l_year"] = d.l_shipdate.dt.year
    d["volume"] = _rev(d)
    g = d.groupby(["supp_nation", "cust_nation", "l_year"], as_index=False)[
        "volume"
    ].sum()
    g = g.rename(columns={"volume": "revenue"})
    return g.sort_values(["supp_nation", "cust_nation", "l_year"]).reset_index(
        drop=True
    )


def q8(t):
    p, s, li, o, c, n, r = (t["part"], t["supplier"], t["lineitem"], t["orders"],
                            t["customer"], t["nation"], t["region"])
    j = li.merge(p[p.p_type == "ECONOMY ANODIZED STEEL"], left_on="l_partkey",
                 right_on="p_partkey")
    j = j.merge(o, left_on="l_orderkey", right_on="o_orderkey")
    j = j[(j.o_orderdate >= D("1995-01-01")) & (j.o_orderdate <= D("1996-12-31"))]
    j = j.merge(c, left_on="o_custkey", right_on="c_custkey")
    am = n.merge(r[r.r_name == "AMERICA"], left_on="n_regionkey",
                 right_on="r_regionkey")
    j = j.merge(am[["n_nationkey"]], left_on="c_nationkey", right_on="n_nationkey")
    n2 = n[["n_nationkey", "n_name"]].rename(
        columns={"n_nationkey": "sk", "n_name": "nation"})
    j = j.merge(s, left_on="l_suppkey", right_on="s_suppkey")
    j = j.merge(n2, left_on="s_nationkey", right_on="sk")
    j["o_year"] = j.o_orderdate.dt.year
    j["volume"] = _rev(j)
    j["brazil"] = j.volume * (j.nation == "BRAZIL")
    g = j.groupby("o_year", as_index=False).agg(
        brazil=("brazil", "sum"), volume=("volume", "sum"))
    g["mkt_share"] = g.brazil / g.volume
    return g[["o_year", "mkt_share"]].sort_values("o_year").reset_index(drop=True)


def q9(t):
    p, s, li, ps, o, n = (t["part"], t["supplier"], t["lineitem"], t["partsupp"],
                          t["orders"], t["nation"])
    pp = p[p.p_name.str.contains("green")]
    j = li.merge(pp[["p_partkey"]], left_on="l_partkey", right_on="p_partkey")
    j = j.merge(ps, left_on=["l_partkey", "l_suppkey"],
                right_on=["ps_partkey", "ps_suppkey"])
    j = j.merge(o[["o_orderkey", "o_orderdate"]], left_on="l_orderkey",
                right_on="o_orderkey")
    j = j.merge(s[["s_suppkey", "s_nationkey"]], left_on="l_suppkey",
                right_on="s_suppkey")
    j = j.merge(n[["n_nationkey", "n_name"]], left_on="s_nationkey",
                right_on="n_nationkey")
    j["o_year"] = j.o_orderdate.dt.year
    j["amount"] = _rev(j) - j.ps_supplycost * j.l_quantity
    g = j.groupby(["n_name", "o_year"], as_index=False)["amount"].sum()
    g = g.rename(columns={"n_name": "nation", "amount": "sum_profit"})
    return g.sort_values(["nation", "o_year"], ascending=[True, False]).reset_index(
        drop=True
    )


def q10(t):
    c, o, li, n = t["customer"], t["orders"], t["lineitem"], t["nation"]
    o = o[(o.o_orderdate >= D("1993-10-01")) & (o.o_orderdate < D("1994-01-01"))]
    li = li[li.l_returnflag == "R"]
    j = li.merge(o, left_on="l_orderkey", right_on="o_orderkey")
    j = j.merge(c, left_on="o_custkey", right_on="c_custkey")
    j = j.merge(n, left_on="c_nationkey", right_on="n_nationkey")
    j["revenue"] = _rev(j)
    g = j.groupby(
        ["c_custkey", "c_name", "c_acctbal", "c_phone", "n_name", "c_address",
         "c_comment"], as_index=False,
    )["revenue"].sum()
    g = g.sort_values("revenue", ascending=False, kind="stable").head(20)
    return g[["c_custkey", "c_name", "revenue", "c_acctbal", "n_name",
              "c_address", "c_phone", "c_comment"]].reset_index(drop=True)


def q11(t):
    ps, s, n = t["partsupp"], t["supplier"], t["nation"]
    de = s.merge(n[n.n_name == "GERMANY"], left_on="s_nationkey",
                 right_on="n_nationkey")
    j = ps.merge(de[["s_suppkey"]], left_on="ps_suppkey", right_on="s_suppkey")
    j["value"] = j.ps_supplycost * j.ps_availqty
    total = j.value.sum() * 0.0001
    g = j.groupby("ps_partkey", as_index=False)["value"].sum()
    g = g[g.value > total]
    return g.sort_values("value", ascending=False).reset_index(drop=True)


def q12(t):
    o, li = t["orders"], t["lineitem"]
    m = (
        li.l_shipmode.isin(["MAIL", "SHIP"])
        & (li.l_commitdate < li.l_receiptdate)
        & (li.l_shipdate < li.l_commitdate)
        & (li.l_receiptdate >= D("1994-01-01"))
        & (li.l_receiptdate < D("1995-01-01"))
    )
    j = li[m].merge(o, left_on="l_orderkey", right_on="o_orderkey")
    hi = j.o_orderpriority.isin(["1-URGENT", "2-HIGH"])
    g = (
        j.assign(hi=hi.astype(int), lo=(~hi).astype(int))
        .groupby("l_shipmode", as_index=False)
        .agg(high_line_count=("hi", "sum"), low_line_count=("lo", "sum"))
    )
    return g.sort_values("l_shipmode").reset_index(drop=True)


def q13(t):
    c, o = t["customer"], t["orders"]
    oo = o[~o.o_comment.str.contains(r"special.*requests", regex=True)]
    cnt = (
        c[["c_custkey"]]
        .merge(oo[["o_custkey", "o_orderkey"]], left_on="c_custkey",
               right_on="o_custkey", how="left")
        .groupby("c_custkey")["o_orderkey"]
        .count()
        .reset_index(name="c_count")
    )
    g = cnt.groupby("c_count", as_index=False).size()
    g.columns = ["c_count", "custdist"]
    return g.sort_values(["custdist", "c_count"], ascending=[False, False]).reset_index(
        drop=True
    )


def q14(t):
    li, p = t["lineitem"], t["part"]
    li = li[(li.l_shipdate >= D("1995-09-01")) & (li.l_shipdate < D("1995-10-01"))]
    j = li.merge(p, left_on="l_partkey", right_on="p_partkey")
    rev = _rev(j)
    promo = rev * j.p_type.str.startswith("PROMO")
    return fr.DataFrame({"promo_revenue": [100.0 * promo.sum() / rev.sum()]})


def q15(t):
    li, s = t["lineitem"], t["supplier"]
    li = li[(li.l_shipdate >= D("1996-01-01")) & (li.l_shipdate < D("1996-04-01"))]
    rev = (
        li.assign(r=_rev(li))
        .groupby("l_suppkey", as_index=False)["r"]
        .sum()
        .rename(columns={"l_suppkey": "supplier_no", "r": "total_revenue"})
    )
    mx = rev.total_revenue.max()
    j = s.merge(rev[rev.total_revenue >= mx - 1e-6], left_on="s_suppkey",
                right_on="supplier_no")
    return j[["s_suppkey", "s_name", "s_address", "s_phone", "total_revenue"]]\
        .sort_values("s_suppkey").reset_index(drop=True)


def q16(t):
    ps, p, s = t["partsupp"], t["part"], t["supplier"]
    bad = s[s.s_comment.str.contains(r"Customer.*Complaints", regex=True)].s_suppkey
    pp = p[
        (p.p_brand != "Brand#45")
        & ~p.p_type.str.startswith("MEDIUM POLISHED")
        & p.p_size.isin([49, 14, 23, 45, 19, 3, 36, 9])
    ]
    j = ps.merge(pp, left_on="ps_partkey", right_on="p_partkey")
    j = j[~j.ps_suppkey.isin(bad)]
    g = j.groupby(["p_brand", "p_type", "p_size"], as_index=False)[
        "ps_suppkey"
    ].nunique()
    g = g.rename(columns={"ps_suppkey": "supplier_cnt"})
    return g.sort_values(
        ["supplier_cnt", "p_brand", "p_type", "p_size"],
        ascending=[False, True, True, True],
    ).reset_index(drop=True)


def q17(t):
    li, p = t["lineitem"], t["part"]
    pp = p[(p.p_brand == "Brand#23") & (p.p_container == "MED BOX")]
    j = li.merge(pp[["p_partkey"]], left_on="l_partkey", right_on="p_partkey")
    avg02 = li.groupby("l_partkey")["l_quantity"].mean() * 0.2
    j = j[j.l_quantity < j.l_partkey.map(avg02)]
    return fr.DataFrame({"avg_yearly": [j.l_extendedprice.sum() / 7.0]})


def q18(t):
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    big = li.groupby("l_orderkey")["l_quantity"].sum()
    big = big[big > 300].index
    j = li[li.l_orderkey.isin(big)].merge(
        o, left_on="l_orderkey", right_on="o_orderkey"
    )
    j = j.merge(c, left_on="o_custkey", right_on="c_custkey")
    g = j.groupby(
        ["c_name", "c_custkey", "o_orderkey", "o_orderdate", "o_totalprice"],
        as_index=False,
    )["l_quantity"].sum()
    g = g.sort_values(["o_totalprice", "o_orderdate"], ascending=[False, True],
                      kind="stable").head(100)
    return g.reset_index(drop=True)


def q19(t):
    li, p = t["lineitem"], t["part"]
    j = li.merge(p, left_on="l_partkey", right_on="p_partkey")
    common = j.l_shipmode.isin(["AIR", "AIR REG"]) & (
        j.l_shipinstruct == "DELIVER IN PERSON"
    )
    b1 = (
        (j.p_brand == "Brand#12")
        & j.p_container.isin(["SM CASE", "SM BOX", "SM PACK", "SM PKG"])
        & (j.l_quantity >= 1) & (j.l_quantity <= 11)
        & (j.p_size >= 1) & (j.p_size <= 5)
    )
    b2 = (
        (j.p_brand == "Brand#23")
        & j.p_container.isin(["MED BAG", "MED BOX", "MED PKG", "MED PACK"])
        & (j.l_quantity >= 10) & (j.l_quantity <= 20)
        & (j.p_size >= 1) & (j.p_size <= 10)
    )
    b3 = (
        (j.p_brand == "Brand#34")
        & j.p_container.isin(["LG CASE", "LG BOX", "LG PACK", "LG PKG"])
        & (j.l_quantity >= 20) & (j.l_quantity <= 30)
        & (j.p_size >= 1) & (j.p_size <= 15)
    )
    m = common & (b1 | b2 | b3)
    return fr.DataFrame({"revenue": [_rev(j[m]).sum()]})


def q20(t):
    s, n, ps, p, li = (t["supplier"], t["nation"], t["partsupp"], t["part"],
                       t["lineitem"])
    forest = p[p.p_name.str.startswith("forest")].p_partkey
    li94 = li[(li.l_shipdate >= D("1994-01-01")) & (li.l_shipdate < D("1995-01-01"))]
    qty = li94.groupby(["l_partkey", "l_suppkey"])["l_quantity"].sum() * 0.5
    pss = ps[ps.ps_partkey.isin(forest)].merge(
        qty.reset_index(name="thresh"), left_on=["ps_partkey", "ps_suppkey"],
        right_on=["l_partkey", "l_suppkey"], how="left")
    good = pss[pss.ps_availqty > pss.thresh].ps_suppkey.unique()
    ca = s.merge(n[n.n_name == "CANADA"], left_on="s_nationkey",
                 right_on="n_nationkey")
    out = ca[ca.s_suppkey.isin(good)]
    return out[["s_name", "s_address"]].sort_values("s_name").reset_index(drop=True)


def q21(t):
    s, li, o, n = t["supplier"], t["lineitem"], t["orders"], t["nation"]
    l1 = li[li.l_receiptdate > li.l_commitdate]
    ok_orders = o[o.o_orderstatus == "F"][["o_orderkey"]]
    j = l1.merge(ok_orders, left_on="l_orderkey", right_on="o_orderkey")
    per_order = li.groupby("l_orderkey", as_index=False).agg(
        min=("l_suppkey", "min"), max=("l_suppkey", "max"))
    late_per_order = l1.groupby("l_orderkey", as_index=False).agg(
        min=("l_suppkey", "min"), max=("l_suppkey", "max"))
    j = j.merge(per_order, on="l_orderkey")
    j = j.merge(late_per_order, on="l_orderkey", suffixes=("", "_late"))
    exists_other = (j["min"] != j.l_suppkey) | (j["max"] != j.l_suppkey)
    not_exists_other_late = (j["min_late"] == j.l_suppkey) & (
        j["max_late"] == j.l_suppkey
    )
    j = j[exists_other & not_exists_other_late]
    sa = s.merge(n[n.n_name == "SAUDI ARABIA"], left_on="s_nationkey",
                 right_on="n_nationkey")
    j = j.merge(sa, left_on="l_suppkey", right_on="s_suppkey")
    g = j.groupby("s_name", as_index=False).size()
    g.columns = ["s_name", "numwait"]
    return g.sort_values(["numwait", "s_name"], ascending=[False, True],
                         kind="stable").head(100).reset_index(drop=True)


def q22(t):
    c, o = t["customer"], t["orders"]
    codes = ["13", "31", "23", "29", "30", "18", "17"]
    cc = c[c.c_phone.str[:2].isin(codes)].copy()
    avg = cc[cc.c_acctbal > 0].c_acctbal.mean()
    cc = cc[cc.c_acctbal > avg]
    cc = cc[~cc.c_custkey.isin(o.o_custkey)]
    cc["cntrycode"] = cc.c_phone.str[:2]
    g = cc.groupby("cntrycode", as_index=False).agg(
        numcust=("c_acctbal", "size"), totacctbal=("c_acctbal", "sum")
    )
    return g.sort_values("cntrycode").reset_index(drop=True)


ORACLES = {f"q{i}": globals()[f"q{i}"] for i in range(1, 23)}
