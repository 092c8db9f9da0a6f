"""Independent numpy oracle for the modeled TPC-DS query subset.

The H2QueryRunner role for TPC-DS: hand-written translations of the
query semantics (from the public TPC-DS spec templates, with the same
documented adaptations as ``connectors.tpcds.queries``) over
``oracle.frame``, sharing no code with the engine's planner or kernels.
Inputs are the connector's ``table_logical`` frames: a NULL foreign key
arrives as None, and inner merges drop it exactly as SQL inner joins do
(the dimension sides never carry NULL keys). Each function reads line
for line against ``presto_tpu.oracle.tpcds_oracle``.
"""

from __future__ import annotations

import numpy as np

from presto_tpu_torch.oracle import frame as fr

D = np.datetime64


def _ss_dd_it(t):
    j = t["store_sales"].merge(
        t["date_dim"], left_on="ss_sold_date_sk", right_on="d_date_sk"
    )
    return j.merge(t["item"], left_on="ss_item_sk", right_on="i_item_sk")


def q3(t):
    j = _ss_dd_it(t)
    j = j[(j.i_manufact_id <= 50) & (j.d_moy == 11)]
    g = j.groupby(["d_year", "i_brand", "i_brand_id"], as_index=False).agg(
        sum_agg=("ss_ext_discount_amt", "sum")
    )
    g = g.sort_values(
        ["d_year", "sum_agg", "i_brand_id"],
        ascending=[True, False, True], kind="stable",
    ).head(100)
    return g[["d_year", "i_brand_id", "i_brand", "sum_agg"]].reset_index(drop=True)


def q7(t):
    cd = t["customer_demographics"]
    cd = cd[
        (cd.cd_gender == "M") & (cd.cd_marital_status == "S")
        & (cd.cd_education_status == "College")
    ]
    p = t["promotion"]
    p = p[(p.p_channel_email == "N") | (p.p_channel_event == "N")]
    j = _ss_dd_it(t)
    j = j[j.d_year == 2000]
    j = j.merge(cd, left_on="ss_cdemo_sk", right_on="cd_demo_sk")
    j = j.merge(p, left_on="ss_promo_sk", right_on="p_promo_sk")
    g = j.groupby("i_item_id", as_index=False).agg(
        agg1=("ss_quantity", "mean"),
        agg2=("ss_list_price", "mean"),
        agg3=("ss_coupon_amt", "mean"),
        agg4=("ss_sales_price", "mean"),
    )
    return g.sort_values("i_item_id", kind="stable").head(100).reset_index(drop=True)


def _revenue_ratio(t, fact, prefix, cats, lo, hi):
    f = t[fact].merge(
        t["date_dim"], left_on=f"{prefix}_sold_date_sk", right_on="d_date_sk"
    )
    f = f.merge(t["item"], left_on=f"{prefix}_item_sk", right_on="i_item_sk")
    f = f[f.i_category.isin(cats) & (f.d_date >= D(lo)) & (f.d_date <= D(hi))]
    g = f.groupby(
        ["i_item_id", "i_item_desc", "i_category", "i_class", "i_current_price"],
        as_index=False,
    ).agg(itemrevenue=(f"{prefix}_ext_sales_price", "sum"))
    g["revenueratio"] = (
        g.itemrevenue * 100 / g.groupby("i_class")["itemrevenue"].transform("sum")
    )
    g = g.sort_values(
        ["i_category", "i_class", "i_item_id", "i_item_desc", "revenueratio"],
        kind="stable",
    )
    return g.reset_index(drop=True)


def q12(t):
    return _revenue_ratio(
        t, "web_sales", "ws", ["Sports", "Books", "Home"],
        "1999-02-22", "1999-04-22",
    ).head(100)


def q19(t):
    j = _ss_dd_it(t)
    j = j[(j.i_manager_id <= 30) & (j.d_moy == 11) & (j.d_year == 1998)]
    j = j.merge(t["customer"], left_on="ss_customer_sk", right_on="c_customer_sk")
    j = j.merge(
        t["customer_address"], left_on="c_current_addr_sk", right_on="ca_address_sk"
    )
    j = j.merge(t["store"], left_on="ss_store_sk", right_on="s_store_sk")
    j = j[j.ca_zip.str[:5] != j.s_zip.str[:5]]
    g = j.groupby(
        ["i_brand", "i_brand_id", "i_manufact_id", "i_manufact"], as_index=False
    ).agg(ext_price=("ss_ext_sales_price", "sum"))
    g = g.sort_values(
        ["ext_price", "i_brand", "i_brand_id", "i_manufact_id", "i_manufact"],
        ascending=[False, True, True, True, True], kind="stable",
    ).head(100)
    return g[
        ["i_brand_id", "i_brand", "i_manufact_id", "i_manufact", "ext_price"]
    ].reset_index(drop=True)


def q20(t):
    return _revenue_ratio(
        t, "catalog_sales", "cs", ["Jewelry", "Music", "Women"],
        "2001-01-12", "2001-03-12",
    ).head(100)


def q26(t):
    cd = t["customer_demographics"]
    cd = cd[
        (cd.cd_gender == "F") & (cd.cd_marital_status == "W")
        & (cd.cd_education_status == "Primary")
    ]
    p = t["promotion"]
    p = p[(p.p_channel_email == "N") | (p.p_channel_event == "N")]
    j = t["catalog_sales"].merge(
        t["date_dim"], left_on="cs_sold_date_sk", right_on="d_date_sk"
    )
    j = j.merge(t["item"], left_on="cs_item_sk", right_on="i_item_sk")
    j = j[j.d_year == 2000]
    j = j.merge(cd, left_on="cs_bill_cdemo_sk", right_on="cd_demo_sk")
    j = j.merge(p, left_on="cs_promo_sk", right_on="p_promo_sk")
    g = j.groupby("i_item_id", as_index=False).agg(
        agg1=("cs_quantity", "mean"),
        agg2=("cs_list_price", "mean"),
        agg3=("cs_coupon_amt", "mean"),
        agg4=("cs_sales_price", "mean"),
    )
    return g.sort_values("i_item_id", kind="stable").head(100).reset_index(drop=True)


def q42(t):
    j = _ss_dd_it(t)
    j = j[(j.i_manager_id <= 20) & (j.d_moy == 11) & (j.d_year == 1998)]
    g = j.groupby(["d_year", "i_category_id", "i_category"], as_index=False).agg(
        total_sales=("ss_ext_sales_price", "sum")
    )
    g = g.sort_values(
        ["total_sales", "d_year", "i_category_id", "i_category"],
        ascending=[False, True, True, True], kind="stable",
    ).head(100)
    return g[["d_year", "i_category_id", "i_category", "total_sales"]].reset_index(
        drop=True
    )


def q52(t):
    j = _ss_dd_it(t)
    j = j[(j.i_manager_id <= 20) & (j.d_moy == 12) & (j.d_year == 1999)]
    g = j.groupby(["d_year", "i_brand", "i_brand_id"], as_index=False).agg(
        ext_price=("ss_ext_sales_price", "sum")
    )
    g = g.sort_values(
        ["d_year", "ext_price", "i_brand_id"],
        ascending=[True, False, True], kind="stable",
    ).head(100)
    return g[["d_year", "i_brand_id", "i_brand", "ext_price"]].reset_index(drop=True)


def q53(t):
    j = _ss_dd_it(t)
    j = j.merge(t["store"], left_on="ss_store_sk", right_on="s_store_sk")
    j = j[
        j.d_month_seq.isin(range(1188, 1200))
        & j.i_category.isin(
            ["Books", "Children", "Electronics", "Home", "Jewelry", "Men"]
        )
    ]
    g = j.groupby(["i_manufact_id", "d_qoy"], as_index=False).agg(
        sum_sales=("ss_sales_price", "sum")
    )
    g["avg_quarterly_sales"] = g.groupby("i_manufact_id")["sum_sales"].transform("mean")
    screen = np.where(
        g.avg_quarterly_sales > 0,
        np.abs(g.sum_sales - g.avg_quarterly_sales) / g.avg_quarterly_sales,
        0.0,
    )
    g = g[screen > 0.05]
    g = g.sort_values(
        ["avg_quarterly_sales", "sum_sales", "i_manufact_id"], kind="stable"
    ).head(100)
    return g[["i_manufact_id", "sum_sales", "avg_quarterly_sales"]].reset_index(
        drop=True
    )


def q55(t):
    j = _ss_dd_it(t)
    j = j[(j.i_manager_id <= 28) & (j.d_moy == 11) & (j.d_year == 1999)]
    g = j.groupby(["i_brand", "i_brand_id"], as_index=False).agg(
        ext_price=("ss_ext_sales_price", "sum")
    )
    g = g.sort_values(
        ["ext_price", "i_brand_id"], ascending=[False, True], kind="stable"
    ).head(100)
    return g[["i_brand_id", "i_brand", "ext_price"]].reset_index(drop=True)


def q89(t):
    j = _ss_dd_it(t)
    j = j.merge(t["store"], left_on="ss_store_sk", right_on="s_store_sk")
    j = j[
        (j.d_year == 1999)
        & j.i_category.isin(["Books", "Electronics", "Sports", "Men", "Music", "Women"])
    ]
    g = j.groupby(
        ["i_category", "i_class", "i_brand", "s_store_name", "s_company_name",
         "d_moy"],
        as_index=False,
    ).agg(sum_sales=("ss_sales_price", "sum"))
    g["avg_monthly_sales"] = g.groupby(
        ["i_category", "i_brand", "s_store_name", "s_company_name"]
    )["sum_sales"].transform("mean")
    screen = np.where(
        g.avg_monthly_sales != 0,
        np.abs(g.sum_sales - g.avg_monthly_sales) / g.avg_monthly_sales,
        0.0,
    )
    g = g[screen > 0.1].copy()
    g["diff"] = g.sum_sales - g.avg_monthly_sales
    g = g.sort_values(
        ["diff", "s_store_name", "i_category", "i_class", "i_brand", "d_moy"],
        kind="stable",
    ).head(100)
    return g[
        ["i_category", "i_class", "i_brand", "s_store_name", "s_company_name",
         "d_moy", "sum_sales", "avg_monthly_sales"]
    ].reset_index(drop=True)


def q98(t):
    g = _revenue_ratio(
        t, "store_sales", "ss", ["Children", "Shoes", "Electronics"],
        "2000-01-29", "2000-03-29",
    )
    return g  # no LIMIT in q98


# -- round-3 breadth (batch 1): returns/inventory/time/ship periphery


def _srt(df, cols, ascending=None):
    return df.sort_values(
        cols, ascending=ascending if ascending is not None else True,
        kind="stable",
    ).reset_index(drop=True)


def q13(t):
    j = t["store_sales"].merge(
        t["store"], left_on="ss_store_sk", right_on="s_store_sk"
    ).merge(t["date_dim"], left_on="ss_sold_date_sk", right_on="d_date_sk")
    j = j[j.d_year == 2001]
    j = j.merge(t["customer_demographics"], left_on="ss_cdemo_sk",
                right_on="cd_demo_sk")
    j = j.merge(t["household_demographics"], left_on="ss_hdemo_sk",
                right_on="hd_demo_sk")
    j = j.merge(t["customer_address"], left_on="ss_addr_sk",
                right_on="ca_address_sk")
    demo = (
        ((j.cd_marital_status == "M") & (j.cd_education_status == "Advanced Degree")
         & j.ss_sales_price.between(50.0, 150.0))
        | ((j.cd_marital_status == "S") & (j.cd_education_status == "College")
           & j.ss_sales_price.between(20.0, 100.0))
        | ((j.cd_marital_status == "W") & (j.cd_education_status == "2 yr Degree")
           & j.ss_sales_price.between(50.0, 200.0))
    )
    geo = (
        (j.ca_state.isin(["TX", "OH", "KY"]) & j.ss_net_profit.between(-5000, 20000))
        | (j.ca_state.isin(["WA", "NE", "GA"]) & j.ss_net_profit.between(-5000, 30000))
        | (j.ca_state.isin(["MT", "MS", "IN"]) & j.ss_net_profit.between(-5000, 25000))
    )
    j = j[demo & geo]
    return fr.DataFrame({
        "a1": [j.ss_quantity.mean()],
        "a2": [j.ss_ext_sales_price.mean()],
        "a3": [j.ss_ext_wholesale_cost.mean()],
        "a4": [j.ss_ext_wholesale_cost.sum()],
    })


def q21(t):
    lo = D("2000-03-11") - np.timedelta64(30, "D")
    hi = D("2000-03-11") + np.timedelta64(30, "D")
    j = t["inventory"].merge(
        t["warehouse"], left_on="inv_warehouse_sk", right_on="w_warehouse_sk"
    ).merge(t["item"], left_on="inv_item_sk", right_on="i_item_sk").merge(
        t["date_dim"], left_on="inv_date_sk", right_on="d_date_sk"
    )
    j = j[(j.d_date >= lo) & (j.d_date <= hi)]
    pivot = D("2000-03-11")
    j = j.assign(
        inv_before=np.where(j.d_date < pivot, j.inv_quantity_on_hand, 0),
        inv_after=np.where(j.d_date >= pivot, j.inv_quantity_on_hand, 0),
    )
    # NULL quantities contribute 0 to both buckets (CASE yields the
    # quantity only when non-null; engine sums skip NULL)
    j["inv_before"] = j["inv_before"].fillna(0)
    j["inv_after"] = j["inv_after"].fillna(0)
    g = j.groupby(["w_warehouse_name", "i_item_id"], as_index=False).agg(
        inv_before=("inv_before", "sum"), inv_after=("inv_after", "sum")
    )
    g = g[g.inv_before > 0]
    g["inv_before"] = g["inv_before"].astype(np.int64)
    g["inv_after"] = g["inv_after"].astype(np.int64)
    return _srt(g, ["w_warehouse_name", "i_item_id"]).head(100)


def _sales_return_catalog(t, d1_years, d2_years, d3_years):
    ss = t["store_sales"].merge(
        t["date_dim"][["d_date_sk", "d_year", "d_qoy"]],
        left_on="ss_sold_date_sk", right_on="d_date_sk",
    )
    ss = ss[ss.d_year.isin(d1_years)]
    j = ss.merge(
        t["store_returns"],
        left_on=["ss_customer_sk", "ss_item_sk", "ss_ticket_number"],
        right_on=["sr_customer_sk", "sr_item_sk", "sr_ticket_number"],
    )
    d2 = t["date_dim"][["d_date_sk", "d_year"]].rename(
        columns={"d_date_sk": "d2_sk", "d_year": "d2_year"}
    )
    j = j.merge(d2, left_on="sr_returned_date_sk", right_on="d2_sk")
    j = j[j.d2_year.isin(d2_years)]
    j = j.merge(
        t["catalog_sales"],
        left_on=["sr_customer_sk", "sr_item_sk"],
        right_on=["cs_bill_customer_sk", "cs_item_sk"],
    )
    d3 = t["date_dim"][["d_date_sk", "d_year"]].rename(
        columns={"d_date_sk": "d3_sk", "d_year": "d3_year"}
    )
    j = j.merge(d3, left_on="cs_sold_date_sk", right_on="d3_sk")
    j = j[j.d3_year.isin(d3_years)]
    j = j.merge(t["store"], left_on="ss_store_sk", right_on="s_store_sk")
    j = j.merge(t["item"], left_on="ss_item_sk", right_on="i_item_sk")
    return j


def q25(t):
    j = _sales_return_catalog(t, [2000], [2000], [2000])
    g = j.groupby(
        ["i_item_id", "i_item_desc", "s_store_id", "s_store_name"],
        as_index=False,
    ).agg(
        store_sales_profit=("ss_net_profit", "sum"),
        store_returns_loss=("sr_net_loss", "sum"),
        catalog_sales_profit=("cs_net_profit", "sum"),
    )
    return _srt(
        g, ["i_item_id", "i_item_desc", "s_store_id", "s_store_name"]
    ).head(100)


def q29(t):
    j = _sales_return_catalog(t, [1999], [1999, 2000], [1999, 2000, 2001])
    g = j.groupby(
        ["i_item_id", "i_item_desc", "s_store_id", "s_store_name"],
        as_index=False,
    ).agg(
        store_sales_quantity=("ss_quantity", "sum"),
        store_returns_quantity=("sr_return_quantity", "sum"),
        catalog_sales_quantity=("cs_quantity", "sum"),
    )
    return _srt(
        g, ["i_item_id", "i_item_desc", "s_store_id", "s_store_name"]
    ).head(100)


def q37(t):
    it = t["item"]
    it = it[it.i_current_price.between(10.0, 60.0) & (it.i_manufact_id <= 300)]
    j = it.merge(t["inventory"], left_on="i_item_sk", right_on="inv_item_sk")
    j = j.merge(t["date_dim"], left_on="inv_date_sk", right_on="d_date_sk")
    j = j[(j.d_date >= D("2000-01-01")) & (j.d_date <= D("2000-03-01"))]
    j = j[j.inv_quantity_on_hand.between(100, 700)]
    j = j.merge(
        t["catalog_sales"][["cs_item_sk"]], left_on="i_item_sk",
        right_on="cs_item_sk",
    )
    g = j.groupby(
        ["i_item_id", "i_item_desc", "i_current_price"], as_index=False
    ).size()[["i_item_id", "i_item_desc", "i_current_price"]]
    return _srt(g, ["i_item_id"]).head(100)


def q43(t):
    st = t["store"]
    st = st[st.s_gmt_offset <= -5]
    j = t["store_sales"].merge(
        t["date_dim"], left_on="ss_sold_date_sk", right_on="d_date_sk"
    )
    j = j[j.d_year == 2000]
    j = j.merge(st, left_on="ss_store_sk", right_on="s_store_sk")
    days = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
            "Saturday"]
    names = ["sun_sales", "mon_sales", "tue_sales", "wed_sales", "thu_sales",
             "fri_sales", "sat_sales"]
    for d, nm in zip(days, names):
        j[nm] = j.ss_sales_price.where(j.d_day_name == d)
    g = j.groupby(["s_store_name", "s_store_id"], as_index=False)[names].sum(
        min_count=1
    )
    return _srt(g, ["s_store_name", "s_store_id"]).head(100)


def _ship_lag(t, fact, prefix, dims):
    f = t[fact]
    lag = f[f"{prefix}_ship_date_sk"] - f[f"{prefix}_sold_date_sk"]
    f = f.assign(
        d30=(lag <= 30).astype(int),
        d60=((lag > 30) & (lag <= 60)).astype(int),
        d90=((lag > 60) & (lag <= 90)).astype(int),
        d120=(lag > 90).astype(int),
    )
    dd = t["date_dim"]
    dd = dd[dd.d_month_seq.between(1200, 1211)]
    j = f.merge(dd, left_on=f"{prefix}_ship_date_sk", right_on="d_date_sk")
    for table, lk, rk in dims:
        j = j.merge(t[table], left_on=lk, right_on=rk)
    return j


def q62(t):
    j = _ship_lag(t, "web_sales", "ws", [
        ("warehouse", "ws_warehouse_sk", "w_warehouse_sk"),
        ("ship_mode", "ws_ship_mode_sk", "sm_ship_mode_sk"),
        ("web_site", "ws_web_site_sk", "web_site_sk"),
    ])
    g = j.groupby(["w_warehouse_name", "sm_type", "web_name"],
                  as_index=False)[["d30", "d60", "d90", "d120"]].sum()
    return _srt(g, ["w_warehouse_name", "sm_type", "web_name"]).head(100)


def q99(t):
    j = _ship_lag(t, "catalog_sales", "cs", [
        ("warehouse", "cs_warehouse_sk", "w_warehouse_sk"),
        ("ship_mode", "cs_ship_mode_sk", "sm_ship_mode_sk"),
        ("call_center", "cs_call_center_sk", "cc_call_center_sk"),
    ])
    g = j.groupby(["w_warehouse_name", "sm_type", "cc_name"],
                  as_index=False)[["d30", "d60", "d90", "d120"]].sum()
    return _srt(g, ["w_warehouse_name", "sm_type", "cc_name"]).head(100)


def q79(t):
    j = t["store_sales"].merge(
        t["date_dim"], left_on="ss_sold_date_sk", right_on="d_date_sk"
    )
    j = j[(j.d_dow == 1) & (j.d_year == 2000)]
    j = j.merge(t["store"], left_on="ss_store_sk", right_on="s_store_sk")
    j = j.merge(t["household_demographics"], left_on="ss_hdemo_sk",
                right_on="hd_demo_sk")
    j = j[(j.hd_dep_count == 6) | (j.hd_vehicle_count > 2)]
    g = j.groupby(
        ["ss_ticket_number", "ss_customer_sk", "ss_addr_sk", "s_city"],
        as_index=False, dropna=False,
    ).agg(amt=("ss_coupon_amt", "sum"), profit=("ss_net_profit", "sum"))
    g = g.merge(t["customer"], left_on="ss_customer_sk",
                right_on="c_customer_sk")
    out = g[["c_last_name", "c_first_name", "s_city", "ss_ticket_number",
             "amt", "profit"]]
    return _srt(
        out, ["c_last_name", "c_first_name", "s_city", "profit",
              "ss_ticket_number"],
    ).head(100)


def q91(t):
    j = t["catalog_returns"].merge(
        t["call_center"], left_on="cr_call_center_sk",
        right_on="cc_call_center_sk",
    ).merge(t["date_dim"], left_on="cr_returned_date_sk", right_on="d_date_sk")
    j = j[j.d_year == 2000]
    j = j.merge(t["customer"], left_on="cr_returning_customer_sk",
                right_on="c_customer_sk")
    j = j.merge(t["customer_demographics"], left_on="c_current_cdemo_sk",
                right_on="cd_demo_sk")
    j = j.merge(t["household_demographics"], left_on="c_current_hdemo_sk",
                right_on="hd_demo_sk")
    j = j[
        ((j.cd_marital_status == "M") & (j.cd_education_status == "Unknown"))
        | ((j.cd_marital_status == "W")
           & (j.cd_education_status == "Advanced Degree"))
    ]
    j = j[j.hd_buy_potential.str.startswith("0-500")]
    g = j.groupby(["cc_call_center_id", "cc_name", "cc_manager"],
                  as_index=False).agg(returns_loss=("cr_net_loss", "sum"))
    return _srt(g, ["returns_loss", "cc_call_center_id"],
                ascending=[False, True]).head(100)


def q93(t):
    re = t["reason"]
    re = re[re.r_reason_desc == "Stopped working"]
    j = t["store_sales"].merge(
        t["store_returns"],
        left_on=["ss_item_sk", "ss_ticket_number"],
        right_on=["sr_item_sk", "sr_ticket_number"],
    )
    j = j.merge(re, left_on="sr_reason_sk", right_on="r_reason_sk")
    act = np.where(
        j.sr_return_quantity.notna(),
        (j.ss_quantity - j.sr_return_quantity) * j.ss_sales_price,
        j.ss_quantity * j.ss_sales_price,
    )
    j = j.assign(act_sales=act)
    g = j.groupby("ss_customer_sk", as_index=False).agg(
        sumsales=("act_sales", "sum")
    )
    return _srt(g, ["sumsales", "ss_customer_sk"]).head(100)


def q96(t):
    j = t["store_sales"].merge(
        t["time_dim"], left_on="ss_sold_time_sk", right_on="t_time_sk"
    ).merge(t["household_demographics"], left_on="ss_hdemo_sk",
            right_on="hd_demo_sk").merge(
        t["store"], left_on="ss_store_sk", right_on="s_store_sk"
    )
    j = j[(j.t_hour == 20) & (j.t_minute >= 30) & (j.hd_dep_count == 7)
          & (j.s_store_name == "ese")]
    return fr.DataFrame({"cnt": [len(j)]})





# -- round-3 breadth (batch 2)


def q15(t):
    j = t["catalog_sales"].merge(
        t["customer"], left_on="cs_bill_customer_sk", right_on="c_customer_sk"
    ).merge(t["customer_address"], left_on="c_current_addr_sk",
            right_on="ca_address_sk").merge(
        t["date_dim"], left_on="cs_sold_date_sk", right_on="d_date_sk"
    )
    j = j[(j.d_qoy == 2) & (j.d_year == 2000)]
    j = j[j.ca_state.isin(["CA", "WA", "GA"]) | (j.cs_sales_price > 70)]
    j = j.assign(zip=j.ca_zip.str[:5])
    g = j.groupby("zip", as_index=False).agg(tot=("cs_sales_price", "sum"))
    return _srt(g, ["zip"]).head(100)


def q45(t):
    j = t["web_sales"].merge(
        t["customer"], left_on="ws_bill_customer_sk", right_on="c_customer_sk"
    ).merge(t["customer_address"], left_on="c_current_addr_sk",
            right_on="ca_address_sk").merge(
        t["date_dim"], left_on="ws_sold_date_sk", right_on="d_date_sk"
    )
    j = j[(j.d_qoy == 2) & (j.d_year == 2000)]
    j = j[j.ca_state.isin(["CA", "WA", "GA"]) | (j.ws_sales_price > 50)]
    j = j.assign(zip=j.ca_zip.str[:5])
    g = j.groupby("zip", as_index=False).agg(tot=("ws_sales_price", "sum"))
    return _srt(g, ["zip"]).head(100)


def q17(t):
    j = _sales_return_catalog(t, [2000], [2000], [2000])
    j = j[j.d_qoy == 1]  # d1 quarter restriction rides the ss-side dates

    def stats(g, col, names):
        cnt = g[col].count()
        ave = g[col].mean()
        sd = g[col].std()
        return {names[0]: cnt, names[1]: ave, names[2]: sd,
                names[3]: sd / ave}

    rows = []
    for key, g in j.groupby(["i_item_id", "i_item_desc", "s_state"]):
        row = dict(zip(["i_item_id", "i_item_desc", "s_state"], key))
        row.update(stats(g, "ss_quantity", [
            "store_sales_quantitycount", "store_sales_quantityave",
            "store_sales_quantitystdev", "store_sales_quantitycov"]))
        row.update(stats(g, "sr_return_quantity", [
            "store_returns_quantitycount", "store_returns_quantityave",
            "store_returns_quantitystdev", "store_returns_quantitycov"]))
        row.update(stats(g, "cs_quantity", [
            "catalog_sales_quantitycount", "catalog_sales_quantityave",
            "catalog_sales_quantitystdev", "catalog_sales_quantitycov"]))
        rows.append(row)
    out = fr.DataFrame(rows)
    return _srt(out, ["i_item_id", "i_item_desc", "s_state"]).head(100)


def _excess_discount(t, fact, prefix, manu_cap):
    f = t[fact].merge(t["date_dim"], left_on=f"{prefix}_sold_date_sk",
                      right_on="d_date_sk")
    f = f[(f.d_date >= D("2000-01-01")) & (f.d_date <= D("2000-12-31"))]
    avg_disc = f.groupby(f"{prefix}_item_sk")[
        f"{prefix}_ext_discount_amt"
    ].mean().rename("avg_disc").reset_index()
    it = t["item"]
    it = it[it.i_manufact_id <= manu_cap]
    j = f.merge(it, left_on=f"{prefix}_item_sk", right_on="i_item_sk")
    j = j.merge(avg_disc, on=f"{prefix}_item_sk")
    j = j[j[f"{prefix}_ext_discount_amt"] > 1.3 * j.avg_disc]
    return fr.DataFrame(
        {"excess_discount_amount": [j[f"{prefix}_ext_discount_amt"].sum()]}
    )


def q32(t):
    return _excess_discount(t, "catalog_sales", "cs", 100)


def q92(t):
    return _excess_discount(t, "web_sales", "ws", 150)


def _bulk_tickets(t, dom_pred, potentials, ratio):
    j = t["store_sales"].merge(
        t["date_dim"], left_on="ss_sold_date_sk", right_on="d_date_sk"
    )
    j = j[j.d_year.isin([1999, 2000, 2001]) & dom_pred(j)]
    j = j.merge(t["store"], left_on="ss_store_sk", right_on="s_store_sk")
    j = j.merge(t["household_demographics"], left_on="ss_hdemo_sk",
                right_on="hd_demo_sk")
    j = j[j.hd_buy_potential.isin(potentials) & (j.hd_vehicle_count > 0)]
    j = j[(j.hd_dep_count / j.hd_vehicle_count) > ratio]
    g = j.groupby(["ss_ticket_number", "ss_customer_sk"],
                  as_index=False).size().rename(columns={"size": "cnt"})
    g = g[g.cnt.between(1, 5)]
    return g.merge(t["customer"], left_on="ss_customer_sk",
                   right_on="c_customer_sk")


def q34(t):
    g = _bulk_tickets(
        t, lambda j: j.d_dom.between(1, 3) | j.d_dom.between(25, 28),
        [">10000", "0-500"], 1.2,
    )
    out = g[["c_last_name", "c_first_name", "c_salutation",
             "c_preferred_cust_flag", "ss_ticket_number", "cnt"]]
    return _srt(
        out,
        ["c_last_name", "c_first_name", "c_salutation",
         "c_preferred_cust_flag", "ss_ticket_number"],
        ascending=[True, True, True, False, True],
    ).head(100)


def q73(t):
    g = _bulk_tickets(
        t, lambda j: j.d_dom.between(1, 2), [">10000", "Unknown"], 1,
    )
    out = g[["c_last_name", "c_first_name", "c_salutation",
             "c_preferred_cust_flag", "ss_ticket_number", "cnt"]]
    return _srt(
        out, ["cnt", "c_last_name", "c_first_name", "ss_ticket_number"],
        ascending=[False, True, True, True],
    ).head(100)


def _city_mismatch(t, dow_filter, hd_filter, aggs):
    j = t["store_sales"].merge(
        t["date_dim"], left_on="ss_sold_date_sk", right_on="d_date_sk"
    )
    j = j[dow_filter(j) & j.d_year.isin([1999, 2000, 2001])]
    j = j.merge(t["store"], left_on="ss_store_sk", right_on="s_store_sk")
    j = j.merge(t["household_demographics"], left_on="ss_hdemo_sk",
                right_on="hd_demo_sk")
    j = j[hd_filter(j)]
    j = j.merge(t["customer_address"], left_on="ss_addr_sk",
                right_on="ca_address_sk")
    g = j.groupby(
        ["ss_ticket_number", "ss_customer_sk", "ss_addr_sk", "ca_city"],
        as_index=False,
    ).agg(**aggs)
    g = g.rename(columns={"ca_city": "bought_city"})
    g = g.merge(t["customer"], left_on="ss_customer_sk",
                right_on="c_customer_sk")
    g = g.merge(
        t["customer_address"].add_prefix("cur_"),
        left_on="c_current_addr_sk", right_on="cur_ca_address_sk",
    )
    return g[g.cur_ca_city != g.bought_city]


def q46(t):
    g = _city_mismatch(
        t, lambda j: j.d_dow.isin([0, 6]),
        lambda j: (j.hd_dep_count == 5) | (j.hd_vehicle_count == 3),
        dict(amt=("ss_coupon_amt", "sum"), profit=("ss_net_profit", "sum")),
    )
    out = g[["c_last_name", "c_first_name", "cur_ca_city", "bought_city",
             "ss_ticket_number", "amt", "profit"]]
    return _srt(out, ["c_last_name", "c_first_name", "cur_ca_city",
                      "bought_city", "ss_ticket_number"]).head(100)


def q68(t):
    g = _city_mismatch(
        t, lambda j: j.d_dom.between(1, 2),
        lambda j: (j.hd_dep_count == 5) | (j.hd_vehicle_count == 3),
        dict(extended_price=("ss_ext_sales_price", "sum"),
             list_price=("ss_ext_list_price", "sum"),
             extended_tax=("ss_ext_tax", "sum")),
    )
    out = g[["c_last_name", "c_first_name", "cur_ca_city", "bought_city",
             "ss_ticket_number", "extended_price", "extended_tax",
             "list_price"]]
    return _srt(out, ["c_last_name", "cur_ca_city", "bought_city",
                      "ss_ticket_number"]).head(100)


def q48(t):
    j = t["store_sales"].merge(
        t["store"], left_on="ss_store_sk", right_on="s_store_sk"
    ).merge(t["date_dim"], left_on="ss_sold_date_sk", right_on="d_date_sk")
    j = j[j.d_year == 2001]
    j = j.merge(t["customer_demographics"], left_on="ss_cdemo_sk",
                right_on="cd_demo_sk")
    j = j.merge(t["customer_address"], left_on="ss_addr_sk",
                right_on="ca_address_sk")
    demo = (
        ((j.cd_marital_status == "M") & (j.cd_education_status == "4 yr Degree")
         & j.ss_sales_price.between(50.0, 150.0))
        | ((j.cd_marital_status == "D") & (j.cd_education_status == "2 yr Degree")
           & j.ss_sales_price.between(10.0, 100.0))
        | ((j.cd_marital_status == "S") & (j.cd_education_status == "College")
           & j.ss_sales_price.between(50.0, 200.0))
    )
    geo = (
        (j.ca_state.isin(["CO", "OH", "TX"]) & j.ss_net_profit.between(0, 22000))
        | (j.ca_state.isin(["OR", "MN", "KY"]) & j.ss_net_profit.between(0, 30000))
        | (j.ca_state.isin(["VA", "CA", "MS"]) & j.ss_net_profit.between(0, 25000))
    )
    j = j[demo & geo & (j.ca_country == "United States")]
    return fr.DataFrame({"total_quantity": [j.ss_quantity.sum()]})


def q65(t):
    f = t["store_sales"].merge(
        t["date_dim"], left_on="ss_sold_date_sk", right_on="d_date_sk"
    )
    f = f[f.d_month_seq.between(1200, 1211)]
    sc = f.groupby(["ss_store_sk", "ss_item_sk"], as_index=False).agg(
        revenue=("ss_sales_price", "sum")
    )
    sb = sc.groupby("ss_store_sk", as_index=False).agg(ave=("revenue", "mean"))
    j = sc.merge(sb, on="ss_store_sk")
    j = j[j.revenue <= 1.0 * j.ave]
    j = j.merge(t["store"], left_on="ss_store_sk", right_on="s_store_sk")
    j = j.merge(t["item"], left_on="ss_item_sk", right_on="i_item_sk")
    out = j[["s_store_name", "i_item_desc", "revenue", "i_current_price",
             "i_wholesale_cost", "i_brand"]]
    return _srt(out, ["s_store_name", "i_item_desc", "revenue"]).head(100)


def q85(t):
    j = t["web_sales"].merge(
        t["web_returns"],
        left_on=["ws_item_sk", "ws_order_number"],
        right_on=["wr_item_sk", "wr_order_number"],
    ).merge(t["web_page"], left_on="ws_web_page_sk", right_on="wp_web_page_sk")
    j = j.merge(t["date_dim"], left_on="ws_sold_date_sk", right_on="d_date_sk")
    j = j[j.d_year == 2000]
    cd1 = t["customer_demographics"].add_prefix("cd1_")
    cd2 = t["customer_demographics"].add_prefix("cd2_")
    j = j.merge(cd1, left_on="wr_refunded_cdemo_sk", right_on="cd1_cd_demo_sk")
    j = j.merge(cd2, left_on="wr_returning_cdemo_sk", right_on="cd2_cd_demo_sk")
    j = j.merge(t["customer_address"], left_on="wr_refunded_addr_sk",
                right_on="ca_address_sk")
    j = j.merge(t["reason"], left_on="wr_reason_sk", right_on="r_reason_sk")
    demo = (
        ((j.cd1_cd_marital_status == "M") & j.ws_sales_price.between(50.0, 150.0))
        | ((j.cd1_cd_marital_status == "S") & j.ws_sales_price.between(10.0, 100.0))
        | ((j.cd1_cd_marital_status == "W") & j.ws_sales_price.between(50.0, 200.0))
    )
    geo = (
        (j.ca_state.isin(["IN", "OH", "NJ"])
         & j.ws_net_profit.between(-10000, 10000))
        | (j.ca_state.isin(["WI", "CT", "KY"])
           & j.ws_net_profit.between(-10000, 20000))
        | (j.ca_state.isin(["LA", "IA", "AR"])
           & j.ws_net_profit.between(-10000, 30000))
    )
    j = j[demo & geo]
    g = j.groupby("r_reason_desc", as_index=False).agg(
        q=("ws_quantity", "mean"), rc=("wr_refunded_cash", "mean"),
        f=("wr_fee", "mean"),
    )
    return _srt(g, ["r_reason_desc"]).head(100)


def _traffic_count(t, hour, half):
    j = t["store_sales"].merge(
        t["time_dim"], left_on="ss_sold_time_sk", right_on="t_time_sk"
    ).merge(t["household_demographics"], left_on="ss_hdemo_sk",
            right_on="hd_demo_sk").merge(
        t["store"], left_on="ss_store_sk", right_on="s_store_sk"
    )
    j = j[(j.t_hour == hour)
          & ((j.t_minute >= 30) if half else (j.t_minute < 30))]
    j = j[
        ((j.hd_dep_count == 4) & (j.hd_vehicle_count <= 6))
        | ((j.hd_dep_count == 2) & (j.hd_vehicle_count <= 4))
        | ((j.hd_dep_count == 0) & (j.hd_vehicle_count <= 2))
    ]
    return len(j[j.s_store_name == "ese"])


def q88(t):
    return fr.DataFrame({
        "h8_30_to_9": [_traffic_count(t, 8, True)],
        "h9_to_9_30": [_traffic_count(t, 9, False)],
        "h9_30_to_10": [_traffic_count(t, 9, True)],
        "h10_to_10_30": [_traffic_count(t, 10, False)],
    })


def q90(t):
    def cnt(lo, hi):
        j = t["web_sales"].merge(
            t["time_dim"], left_on="ws_sold_time_sk", right_on="t_time_sk"
        ).merge(t["web_page"], left_on="ws_web_page_sk",
                right_on="wp_web_page_sk")
        j = j[j.t_hour.between(lo, hi) & j.wp_char_count.between(2000, 6000)]
        return len(j)

    return fr.DataFrame({"am_pm_ratio": [cnt(8, 9) / cnt(19, 20)]})


# -- round-3 breadth (batch 3)


def q1(t):
    ctr = t["store_returns"].merge(
        t["date_dim"], left_on="sr_returned_date_sk", right_on="d_date_sk"
    )
    ctr = ctr[ctr.d_year == 2000]
    ctr = ctr.groupby(["sr_customer_sk", "sr_store_sk"], as_index=False).agg(
        ctr_total_return=("sr_return_amt", "sum")
    )
    ave = ctr.groupby("sr_store_sk")["ctr_total_return"].mean().rename(
        "store_avg"
    ).reset_index()
    j = ctr.merge(ave, on="sr_store_sk")
    j = j[j.ctr_total_return > 1.2 * j.store_avg]
    j = j.merge(t["store"], left_on="sr_store_sk", right_on="s_store_sk")
    j = j.merge(t["customer"], left_on="sr_customer_sk",
                right_on="c_customer_sk")
    out = j[["c_customer_id"]]
    return _srt(out, ["c_customer_id"]).head(100)


def _multi_order_unreturned(t, fact, prefix, returns, rprefix, extra):
    f = t[fact]
    dd = t["date_dim"]
    dd = dd[(dd.d_date >= D("2000-03-01")) & (dd.d_date <= D("2000-06-30"))]
    j = f.merge(dd, left_on=f"{prefix}_ship_date_sk", right_on="d_date_sk")
    j = j.merge(t["customer_address"], left_on=f"{prefix}_ship_addr_sk",
                right_on="ca_address_sk")
    j = extra(j)
    # EXISTS (official): the same order shipped from ANOTHER warehouse —
    # the order has >=2 distinct non-null warehouses and this row's
    # warehouse is non-null
    n_wh = f.groupby(f"{prefix}_order_number")[
        f"{prefix}_warehouse_sk"
    ].nunique().rename("n_wh").reset_index()
    j = j.merge(n_wh, on=f"{prefix}_order_number")
    j = j[(j.n_wh > 1) & j[f"{prefix}_warehouse_sk"].notna()]
    # NOT EXISTS: order never returned
    returned = set(t[returns][f"{rprefix}_order_number"].dropna())
    j = j[~j[f"{prefix}_order_number"].isin(returned)]
    return fr.DataFrame(
        {"order_count": [j[f"{prefix}_order_number"].nunique()]}
    )


def q16(t):
    def extra(j):
        return j.merge(t["call_center"], left_on="cs_call_center_sk",
                       right_on="cc_call_center_sk")

    return _multi_order_unreturned(
        t, "catalog_sales", "cs", "catalog_returns", "cr", extra
    )


def q94(t):
    def extra(j):
        w = t["web_site"]
        w = w[w.web_company_name.str.strip() == "able"]
        return j.merge(w, left_on="ws_web_site_sk", right_on="web_site_sk")

    return _multi_order_unreturned(
        t, "web_sales", "ws", "web_returns", "wr", extra
    )


def _channel_union(t, item_filter, year, group_col):
    it = t["item"]
    wanted = set(it[item_filter(it)][group_col])
    parts = []
    for fact, prefix in (("store_sales", "ss"), ("catalog_sales", "cs"),
                         ("web_sales", "ws")):
        f = t[fact].merge(t["date_dim"], left_on=f"{prefix}_sold_date_sk",
                          right_on="d_date_sk")
        f = f[f.d_year == year]
        f = f.merge(it, left_on=f"{prefix}_item_sk", right_on="i_item_sk")
        f = f[f[group_col].isin(wanted)]
        g = f.groupby(group_col, as_index=False).agg(
            total_sales=(f"{prefix}_ext_sales_price", "sum")
        )
        parts.append(g)
    u = fr.concat(parts, ignore_index=True)
    g = u.groupby(group_col, as_index=False).agg(
        total_sales=("total_sales", "sum")
    )
    return _srt(g, ["total_sales", group_col]).head(100)[
        [group_col, "total_sales"]
    ]


def q33(t):
    return _channel_union(
        t, lambda it: it.i_category.isin(["Books"]), 2000, "i_manufact_id"
    )


def q56(t):
    return _channel_union(
        t, lambda it: it.i_color.isin(["blue", "orchid", "pink"]), 2000,
        "i_item_id",
    )


def q60(t):
    return _channel_union(
        t, lambda it: it.i_category.isin(["Music"]), 1999, "i_item_id"
    )


def q71(t):
    parts = []
    for fact, prefix in (("web_sales", "ws"), ("catalog_sales", "cs"),
                         ("store_sales", "ss")):
        f = t[fact].merge(t["date_dim"], left_on=f"{prefix}_sold_date_sk",
                          right_on="d_date_sk")
        f = f[(f.d_moy == 11) & (f.d_year == 2000)]
        parts.append(fr.DataFrame({
            "ext_price": f[f"{prefix}_ext_sales_price"],
            "sold_item_sk": f[f"{prefix}_item_sk"],
            "time_sk": f[f"{prefix}_sold_time_sk"],
        }))
    u = fr.concat(parts, ignore_index=True)
    it = t["item"]
    it = it[it.i_manager_id <= 20]
    j = u.merge(it, left_on="sold_item_sk", right_on="i_item_sk")
    td = t["time_dim"]
    td = td[td.t_meal_time.isin(["breakfast", "dinner"])]
    j = j.merge(td, left_on="time_sk", right_on="t_time_sk")
    g = j.groupby(["i_brand_id", "i_brand", "t_hour", "t_minute"],
                  as_index=False).agg(ext_price=("ext_price", "sum"))
    g = g.rename(columns={"i_brand_id": "brand_id", "i_brand": "brand"})
    out = _srt(g, ["ext_price", "brand_id", "t_hour", "t_minute"],
               ascending=[False, True, True, True]).head(100)
    return out[["brand_id", "brand", "t_hour", "t_minute", "ext_price"]]


def q76(t):
    parts = []
    for ch, colname, nullcol, fact, prefix in (
            ("store", "ss_store_sk", "ss_store_sk", "store_sales", "ss"),
            ("web", "ws_ship_customer_sk", "ws_ship_customer_sk",
             "web_sales", "ws"),
            ("catalog", "cs_ship_addr_sk", "cs_ship_addr_sk",
             "catalog_sales", "cs")):
        f = t[fact]
        f = f[f[nullcol].isna()]
        f = f.merge(t["date_dim"], left_on=f"{prefix}_sold_date_sk",
                    right_on="d_date_sk")
        f = f.merge(t["item"], left_on=f"{prefix}_item_sk",
                    right_on="i_item_sk")
        parts.append(fr.DataFrame({
            "channel": ch, "col_name": colname, "d_year": f.d_year,
            "d_qoy": f.d_qoy, "i_category": f.i_category,
            "ext_sales_price": f[f"{prefix}_ext_sales_price"],
        }))
    u = fr.concat(parts, ignore_index=True)
    g = u.groupby(["channel", "col_name", "d_year", "d_qoy", "i_category"],
                  as_index=False).agg(
        sales_cnt=("ext_sales_price", "size"),
        sales_amt=("ext_sales_price", "sum"),
    )
    return _srt(g, ["channel", "col_name", "d_year", "d_qoy",
                    "i_category"]).head(100)


def q22(t):
    j = t["inventory"].merge(
        t["date_dim"], left_on="inv_date_sk", right_on="d_date_sk"
    ).merge(t["item"], left_on="inv_item_sk", right_on="i_item_sk")
    j = j[j.d_month_seq.between(1200, 1211)]
    # NULL-able int decodes as an object column; numeric mean needs float
    j = j.assign(inv_quantity_on_hand=fr.to_numeric(j.inv_quantity_on_hand))
    rollup_cols = ["i_product_name", "i_brand", "i_class", "i_category"]
    levels = [rollup_cols[:k] for k in range(len(rollup_cols), -1, -1)]
    parts = []
    for lv in levels:
        if lv:
            g = j.groupby(lv, as_index=False).agg(
                qoh=("inv_quantity_on_hand", "mean")
            )
        else:
            g = fr.DataFrame({"qoh": [j.inv_quantity_on_hand.mean()]})
        for c in rollup_cols:
            if c not in g:
                g[c] = None
        parts.append(g[rollup_cols + ["qoh"]])
    u = fr.concat(parts, ignore_index=True)
    u = u.sort_values(
        ["qoh"] + rollup_cols,
        na_position="last", kind="stable",
    ).reset_index(drop=True)
    return u.head(100)


def _margin_hierarchy(t, fact, prefix, num_col, den_col, asc, date_filter,
                      extra_dims):
    """Rollup(i_category, i_class) metric + rank within parent. The
    metric is sum(num)/sum(den) (den_col None -> just sum(num))."""
    f = t[fact].merge(t["date_dim"], left_on=f"{prefix}_sold_date_sk",
                      right_on="d_date_sk")
    f = date_filter(f)
    for table, lk, rk in extra_dims:
        f = f.merge(t[table], left_on=lk, right_on=rk)
    f = f.merge(t["item"], left_on=f"{prefix}_item_sk", right_on="i_item_sk")

    def metric_frame(g):
        if den_col is None:
            g["m"] = g["num"]
            return g.drop(columns=["num"])
        g["m"] = g["num"] / g["den"]
        return g.drop(columns=["num", "den"])

    levels = [(["i_category", "i_class"], 0), (["i_category"], 1), ([], 2)]
    parts = []
    for lv, loc in levels:
        agg = {"num": (num_col, "sum")}
        if den_col is not None:
            agg["den"] = (den_col, "sum")
        if lv:
            g = f.groupby(lv, as_index=False).agg(**agg)
        else:
            g = fr.DataFrame({k: [f[v[0]].sum()] for k, v in agg.items()})
        g = metric_frame(g)
        for c in ["i_category", "i_class"]:
            if c not in g:
                g[c] = None
        g["lochierarchy"] = loc
        parts.append(g[["m", "i_category", "i_class", "lochierarchy"]])
    u = fr.concat(parts, ignore_index=True)
    u["parent"] = np.where(u.lochierarchy == 0, u.i_category, None)
    u["rank_within_parent"] = (
        u.groupby(["lochierarchy", "parent"], dropna=False)["m"]
        .rank(method="min", ascending=asc).astype(np.int64)
    )
    # ORDER BY lochierarchy desc, parent nulls first, rank, i_class
    # nulls last — composed as stable sorts, least significant first
    u = u.sort_values("i_class", na_position="last", kind="stable")
    u = u.sort_values("rank_within_parent", kind="stable")
    u = u.sort_values("parent", na_position="first", kind="stable")
    u = u.sort_values("lochierarchy", ascending=False, kind="stable")
    return u.drop(columns=["parent"]).reset_index(drop=True)


def q36(t):
    u = _margin_hierarchy(
        t, "store_sales", "ss", "ss_net_profit", "ss_ext_sales_price", True,
        lambda f: f[f.d_year == 2000],
        [("store", "ss_store_sk", "s_store_sk")],
    )
    u = u.rename(columns={"m": "gross_margin"})
    return u[["gross_margin", "i_category", "i_class",
              "lochierarchy", "rank_within_parent"]].head(100)


def q86(t):
    u = _margin_hierarchy(
        t, "web_sales", "ws", "ws_net_paid", None, False,
        lambda f: f[f.d_month_seq.between(1200, 1211)], [],
    )
    u = u.rename(columns={"m": "total_sum"})
    return u[["total_sum", "i_category", "i_class",
              "lochierarchy", "rank_within_parent"]].head(100)




def _channel_customer_days(t, fact, prefix, cust_col):
    f = t[fact].merge(t["date_dim"], left_on=f"{prefix}_sold_date_sk",
                      right_on="d_date_sk")
    f = f[f.d_month_seq.between(1200, 1211)]
    f = f.merge(t["customer"], left_on=cust_col, right_on="c_customer_sk")
    return set(map(tuple, f[["c_last_name", "c_first_name", "d_date"]]
                   .drop_duplicates().itertuples(index=False)))


def q38(t):
    ss = _channel_customer_days(t, "store_sales", "ss", "ss_customer_sk")
    cs = _channel_customer_days(t, "catalog_sales", "cs", "cs_bill_customer_sk")
    ws = _channel_customer_days(t, "web_sales", "ws", "ws_bill_customer_sk")
    return fr.DataFrame({"cnt": [len(ss & cs & ws)]})


def q87(t):
    ss = _channel_customer_days(t, "store_sales", "ss", "ss_customer_sk")
    cs = _channel_customer_days(t, "catalog_sales", "cs", "cs_bill_customer_sk")
    ws = _channel_customer_days(t, "web_sales", "ws", "ws_bill_customer_sk")
    return fr.DataFrame({"cnt": [len(ss - cs - ws)]})


# -- round-3 breadth (batch 4)


def q28(t):
    ss = t["store_sales"]
    bands = [
        ((0, 5), (8, 108), (0, 1000), (7, 57)),
        ((6, 10), (9, 109), (0, 2000), (31, 81)),
        ((11, 15), (14, 114), (0, 3000), (17, 67)),
        ((16, 20), (6, 106), (0, 4000), (30, 80)),
        ((21, 25), (10, 110), (0, 5000), (37, 87)),
        ((26, 30), (17, 117), (0, 6000), (33, 83)),
    ]
    out = {}
    for i, (q, lp, cp, wc) in enumerate(bands, 1):
        f = ss[ss.ss_quantity.between(*q)
               & (ss.ss_list_price.between(*lp)
                  | ss.ss_coupon_amt.between(*cp)
                  | ss.ss_wholesale_cost.between(*wc))]
        out[f"b{i}_cntd"] = [f.ss_list_price.dropna().nunique()]
    return fr.DataFrame(out)


def _returners_above_state_avg(t, returns, cust_col, addr_col, amt_col):
    date_col = [c for c in t[returns].columns
                if c.endswith("returned_date_sk")][0]
    ctr = t[returns].merge(
        t["date_dim"], left_on=date_col, right_on="d_date_sk"
    )
    ctr = ctr[ctr.d_year == 2000]
    ctr = ctr.merge(t["customer_address"], left_on=addr_col,
                    right_on="ca_address_sk")
    # dropna=False: SQL keeps the NULL-customer group (the generator
    # makes wr_returning_customer_sk ~2% NULL), and the per-state
    # average in the subquery includes it
    g = ctr.groupby([cust_col, "ca_state"], as_index=False,
                    dropna=False).agg(
        ctr_total_return=(amt_col, "sum")
    )
    ave = g.groupby("ca_state")["ctr_total_return"].mean().rename(
        "state_avg"
    ).reset_index()
    j = g.merge(ave, on="ca_state")
    j = j[j.ctr_total_return > 1.2 * j.state_avg]
    j = j.merge(t["customer"], left_on=cust_col, right_on="c_customer_sk")
    out = j[["c_customer_id", "c_salutation", "c_first_name", "c_last_name",
             "ctr_total_return"]]
    return _srt(out, ["c_customer_id", "ctr_total_return"]).head(100)


def q30(t):
    return _returners_above_state_avg(
        t, "web_returns", "wr_returning_customer_sk", "wr_refunded_addr_sk",
        "wr_return_amt",
    )


def q81(t):
    return _returners_above_state_avg(
        t, "catalog_returns", "cr_returning_customer_sk",
        "cr_returning_addr_sk", "cr_return_amount",
    )


def q50(t):
    j = t["store_sales"].merge(
        t["store_returns"],
        left_on=["ss_ticket_number", "ss_item_sk", "ss_customer_sk"],
        right_on=["sr_ticket_number", "sr_item_sk", "sr_customer_sk"],
    )
    dd = t["date_dim"]
    dd = dd[(dd.d_year == 2000) & (dd.d_moy == 8)]
    j = j.merge(dd, left_on="sr_returned_date_sk", right_on="d_date_sk")
    j = j.merge(t["store"], left_on="ss_store_sk", right_on="s_store_sk")
    lag = j.sr_returned_date_sk - j.ss_sold_date_sk
    j = j.assign(
        d30=(lag <= 30).astype(int),
        d60=((lag > 30) & (lag <= 60)).astype(int),
        d90=((lag > 60) & (lag <= 90)).astype(int),
        d120=(lag > 90).astype(int),
    )
    g = j.groupby(["s_store_sk", "s_store_name", "s_store_id", "s_state"],
                  as_index=False)[["d30", "d60", "d90", "d120"]].sum()
    g = g.drop(columns=["s_store_sk"])
    return _srt(g, ["s_store_name", "s_store_id", "s_state"]).head(100)


def q61(t):
    def revenue(with_promo):
        f = t["store_sales"].merge(
            t["date_dim"], left_on="ss_sold_date_sk", right_on="d_date_sk"
        )
        f = f[f.d_year == 2000]
        f = f.merge(t["store"], left_on="ss_store_sk", right_on="s_store_sk")
        f = f.merge(t["customer"], left_on="ss_customer_sk",
                    right_on="c_customer_sk")
        f = f.merge(t["customer_address"], left_on="c_current_addr_sk",
                    right_on="ca_address_sk")
        f = f[f.ca_gmt_offset <= -5]
        it = t["item"]
        f = f.merge(it[it.i_category == "Jewelry"], left_on="ss_item_sk",
                    right_on="i_item_sk")
        if with_promo:
            p = t["promotion"]
            p = p[(p.p_channel_dmail == "Y") | (p.p_channel_email == "Y")
                  | (p.p_channel_tv == "Y")]
            f = f.merge(p, left_on="ss_promo_sk", right_on="p_promo_sk")
        return f.ss_ext_sales_price.sum()

    promo = revenue(True)
    total = revenue(False)
    share = (float(promo) / float(total) * 100) if total else np.nan
    return fr.DataFrame({"promotions": [promo], "total": [total],
                         "share": [share]})


def q69(t):
    c = t["customer"].merge(
        t["customer_address"], left_on="c_current_addr_sk",
        right_on="ca_address_sk",
    )
    c = c[c.ca_state.isin(["KY", "GA", "NM", "CA", "TX", "OH"])]
    c = c.merge(t["customer_demographics"], left_on="c_current_cdemo_sk",
                right_on="cd_demo_sk")

    def buyers(fact, prefix, cust_col):
        f = t[fact].merge(t["date_dim"], left_on=f"{prefix}_sold_date_sk",
                          right_on="d_date_sk")
        return set(f[f.d_year == 2001][cust_col].dropna())

    ss = buyers("store_sales", "ss", "ss_customer_sk")
    ws = buyers("web_sales", "ws", "ws_bill_customer_sk")
    cs = buyers("catalog_sales", "cs", "cs_bill_customer_sk")
    c = c[c.c_customer_sk.isin(ss - ws - cs)]
    g = c.groupby(["cd_gender", "cd_marital_status", "cd_education_status",
                   "cd_purchase_estimate"], as_index=False).size()
    g["cnt1"] = g["size"]
    g["cnt2"] = g["size"]
    g = g[["cd_gender", "cd_marital_status", "cd_education_status", "cnt1",
           "cd_purchase_estimate", "cnt2"]]
    return _srt(g, ["cd_gender", "cd_marital_status", "cd_education_status",
                    "cd_purchase_estimate"]).head(100)


# -- round-3 breadth (batch 5)


def q6(t):
    dd = t["date_dim"]
    mseq = dd[(dd.d_year == 2001) & (dd.d_moy == 1)].d_month_seq.unique()
    assert len(mseq) == 1
    it = t["item"]
    cat_avg = it.groupby("i_category")["i_current_price"].mean().rename(
        "cat_avg"
    ).reset_index()
    it = it.merge(cat_avg, on="i_category")
    it = it[it.i_current_price > 1.2 * it.cat_avg]
    j = t["store_sales"].merge(dd[dd.d_month_seq == mseq[0]],
                               left_on="ss_sold_date_sk",
                               right_on="d_date_sk")
    j = j.merge(it, left_on="ss_item_sk", right_on="i_item_sk")
    j = j.merge(t["customer"], left_on="ss_customer_sk",
                right_on="c_customer_sk")
    j = j.merge(t["customer_address"], left_on="c_current_addr_sk",
                right_on="ca_address_sk")
    g = j.groupby("ca_state", dropna=False, as_index=False).size().rename(
        columns={"size": "cnt", "ca_state": "state"}
    )
    g = g[g.cnt >= 1]
    return _srt(g[["state", "cnt"]], ["cnt", "state"]).head(100)


def q9(t):
    ss = t["store_sales"]
    out = {}
    for i, (lo, hi) in enumerate(
        [(1, 20), (21, 40), (41, 60), (61, 80), (81, 100)], 1
    ):
        f = ss[ss.ss_quantity.between(lo, hi)]
        v = (f.ss_ext_discount_amt.mean() if len(f) > 1000
             else f.ss_net_paid.mean())
        out[f"bucket{i}"] = [v]
    return fr.DataFrame(out)


def q59(t):
    j = t["store_sales"].merge(t["date_dim"], left_on="ss_sold_date_sk",
                               right_on="d_date_sk")
    days = [("Sunday", "sun"), ("Monday", "mon"), ("Friday", "fri"),
            ("Saturday", "sat")]
    for d, tag in days:
        j[f"{tag}_sales"] = j.ss_sales_price.where(j.d_day_name == d)
    wss = j.groupby(["d_week_seq", "ss_store_sk"], as_index=False)[
        [f"{tag}_sales" for _, tag in days]
    ].sum(min_count=1)
    # the SQL joins every date_dim DAY row of the week (multiplicity
    # up to 7, split across month boundaries) - mirror it exactly
    dd = t["date_dim"][["d_week_seq", "d_month_seq"]]
    wss = wss.merge(dd, on="d_week_seq")
    wss = wss.merge(t["store"], left_on="ss_store_sk", right_on="s_store_sk")
    y = wss[wss.d_month_seq.between(1200, 1211)]
    x = wss[wss.d_month_seq.between(1212, 1223)]
    m = y.merge(x, left_on=["ss_store_sk"], right_on=["ss_store_sk"],
                suffixes=("1", "2"))
    m = m[m.d_week_seq1 == m.d_week_seq2 - 52]
    out = fr.DataFrame({
        "s_store_name1": m.s_store_name1,
        "d_week_seq1": m.d_week_seq1,
        "sun_r": m.sun_sales1 / m.sun_sales2,
        "mon_r": m.mon_sales1 / m.mon_sales2,
        "fri_r": m.fri_sales1 / m.fri_sales2,
        "sat_r": m.sat_sales1 / m.sat_sales2,
    })
    return _srt(out, ["s_store_name1", "d_week_seq1"]).head(100)


def q63(t):
    j = t["store_sales"].merge(t["date_dim"], left_on="ss_sold_date_sk",
                               right_on="d_date_sk")
    j = j[j.d_month_seq.between(1200, 1211)]
    j = j.merge(t["store"], left_on="ss_store_sk", right_on="s_store_sk")
    it = t["item"]
    sel = (
        (it.i_category.isin(["Books", "Children", "Electronics"])
         & it.i_class.isin(["books-accent", "children-accent",
                            "electronics-accent"]))
        | (it.i_category.isin(["Women", "Music", "Men"])
           & it.i_class.isin(["women-pants", "music-pants", "men-pants"]))
    )
    j = j.merge(it[sel], left_on="ss_item_sk", right_on="i_item_sk")
    g = j.groupby(["i_manager_id", "d_moy"], as_index=False).agg(
        sum_sales=("ss_sales_price", "sum")
    )
    g["avg_monthly_sales"] = g.groupby("i_manager_id")[
        "sum_sales"
    ].transform("mean")
    g = g[np.where(
        g.avg_monthly_sales > 0,
        np.abs(g.sum_sales - g.avg_monthly_sales) / g.avg_monthly_sales,
        0.0,
    ) > 0.1]
    out = g[["i_manager_id", "sum_sales", "avg_monthly_sales"]]
    return _srt(out, ["i_manager_id", "avg_monthly_sales", "sum_sales"]).head(100)


def q82(t):
    it = t["item"]
    it = it[it.i_current_price.between(20.0, 70.0) & (it.i_manufact_id <= 400)]
    j = it.merge(t["inventory"], left_on="i_item_sk", right_on="inv_item_sk")
    j = j.merge(t["date_dim"], left_on="inv_date_sk", right_on="d_date_sk")
    j = j[(j.d_date >= D("2000-05-25")) & (j.d_date <= D("2000-07-24"))]
    j = j[fr.to_numeric(j.inv_quantity_on_hand).between(100, 500)]
    j = j.merge(t["store_sales"][["ss_item_sk"]], left_on="i_item_sk",
                right_on="ss_item_sk")
    g = j.groupby(["i_item_id", "i_item_desc", "i_current_price"],
                  as_index=False).size()[
        ["i_item_id", "i_item_desc", "i_current_price"]
    ]
    return _srt(g, ["i_item_id"]).head(100)


# -- round-3 breadth (batch 6)


def q2(t):
    parts = []
    for fact, prefix in (("web_sales", "ws"), ("catalog_sales", "cs")):
        f = t[fact]
        parts.append(fr.DataFrame({
            "sold_date_sk": f[f"{prefix}_sold_date_sk"],
            "sales_price": f[f"{prefix}_ext_sales_price"],
        }))
    wscs = fr.concat(parts, ignore_index=True)
    j = wscs.merge(t["date_dim"], left_on="sold_date_sk",
                   right_on="d_date_sk")
    for d, tag in (("Sunday", "sun"), ("Monday", "mon"), ("Friday", "fri"),
                   ("Saturday", "sat")):
        j[f"{tag}_sales"] = j.sales_price.where(j.d_day_name == d)
    wswscs = j.groupby("d_week_seq", as_index=False)[
        ["sun_sales", "mon_sales", "fri_sales", "sat_sales"]
    ].sum(min_count=1)
    dd = t["date_dim"][["d_week_seq", "d_year"]]
    wk = wswscs.merge(dd, on="d_week_seq")  # per-day multiplicity
    y = wk[wk.d_year == 2000]
    z = wk[wk.d_year == 2001]
    m = y.merge(z, how="cross", suffixes=("1", "2"))
    m = m[m.d_week_seq1 == m.d_week_seq2 - 53]
    out = fr.DataFrame({
        "d_week_seq1": m.d_week_seq1,
        "r_sun": (m.sun_sales1 / m.sun_sales2).round(2),
        "r_mon": (m.mon_sales1 / m.mon_sales2).round(2),
        "r_fri": (m.fri_sales1 / m.fri_sales2).round(2),
        "r_sat": (m.sat_sales1 / m.sat_sales2).round(2),
    })
    return _srt(out, ["d_week_seq1"]).head(100)


def q31(t):
    def channel(fact, prefix, addr_col, out_col):
        f = t[fact].merge(t["date_dim"], left_on=f"{prefix}_sold_date_sk",
                          right_on="d_date_sk")
        f = f.merge(t["customer_address"], left_on=addr_col,
                    right_on="ca_address_sk")
        return f.groupby(["ca_county", "d_qoy", "d_year"],
                         as_index=False).agg(
            **{out_col: (f"{prefix}_ext_sales_price", "sum")}
        )

    ss = channel("store_sales", "ss", "ss_addr_sk", "store_sales")
    ws = channel("web_sales", "ws", "ws_ship_addr_sk", "web_sales")

    def pick(g, q, col):
        f = g[(g.d_qoy == q) & (g.d_year == 2000)]
        return f[["ca_county", col]].rename(columns={col: f"{col}{q}"})

    m = pick(ss, 1, "store_sales").merge(pick(ss, 2, "store_sales"),
                                         on="ca_county")
    m = m.merge(pick(ws, 1, "web_sales"), on="ca_county")
    m = m.merge(pick(ws, 2, "web_sales"), on="ca_county")
    web_r = np.where(m.web_sales1 > 0, m.web_sales2 / m.web_sales1, np.nan)
    store_r = np.where(m.store_sales1 > 0,
                       m.store_sales2 / m.store_sales1, np.nan)
    keep = web_r > store_r  # NULL comparisons are false
    out = fr.DataFrame({
        "ca_county": m.ca_county[keep], "d_year": 2000,
        "web_q1_q2_increase": web_r[keep],
        "store_q1_q2_increase": store_r[keep],
    })
    return _srt(out, ["ca_county"]).head(100)


def q39(t):
    j = t["inventory"].merge(t["item"], left_on="inv_item_sk",
                             right_on="i_item_sk")
    j = j.merge(t["warehouse"], left_on="inv_warehouse_sk",
                right_on="w_warehouse_sk")
    j = j.merge(t["date_dim"], left_on="inv_date_sk", right_on="d_date_sk")
    j = j[j.d_year == 2000]
    j = j.assign(q=fr.to_numeric(j.inv_quantity_on_hand))
    g = j.groupby(["w_warehouse_sk", "i_item_sk", "d_moy"],
                  as_index=False).agg(stdev=("q", "std"), mean=("q", "mean"))
    g["cov"] = np.where(g["mean"] == 0, np.nan, g.stdev / g["mean"])
    g = g[np.where(g["mean"] == 0, 0.0, g.stdev / g["mean"]) > 0.5]
    a = g[g.d_moy == 1]
    b = g[g.d_moy == 2]
    m = a.merge(b, on=["w_warehouse_sk", "i_item_sk"], suffixes=("1", "2"))
    out = fr.DataFrame({
        "wsk1": m.w_warehouse_sk, "isk1": m.i_item_sk, "moy1": m.d_moy1,
        "mean1": m.mean1, "cov1": m.cov1, "moy2": m.d_moy2,
        "mean2": m.mean2, "cov2": m.cov2,
    })
    return _srt(out, ["wsk1", "isk1", "moy1", "mean1", "cov1"]).head(100)


def q44(t):
    ss = t["store_sales"]
    ss = ss[ss.ss_store_sk == 4]
    base = ss.ss_net_profit.mean()
    g = ss.groupby("ss_item_sk", as_index=False).agg(
        rank_col=("ss_net_profit", "mean")
    )
    g = g[g.rank_col > 0.9 * base]
    g["rnk_asc"] = g.rank_col.rank(method="min", ascending=True).astype(int)
    g["rnk_desc"] = g.rank_col.rank(method="min", ascending=False).astype(int)
    a = g[g.rnk_asc < 11][["ss_item_sk", "rnk_asc"]].rename(
        columns={"rnk_asc": "rnk"}
    )
    d = g[g.rnk_desc < 11][["ss_item_sk", "rnk_desc"]].rename(
        columns={"rnk_desc": "rnk"}
    )
    m = a.merge(d, on="rnk", suffixes=("_a", "_d"))
    it = t["item"][["i_item_sk", "i_product_name"]]
    m = m.merge(it, left_on="ss_item_sk_a", right_on="i_item_sk")
    m = m.rename(columns={"i_product_name": "best_performing"})
    m = m.merge(it, left_on="ss_item_sk_d", right_on="i_item_sk",
                suffixes=("", "_d"))
    m = m.rename(columns={"i_product_name": "worst_performing"})
    out = m[["rnk", "best_performing", "worst_performing"]]
    return _srt(out, ["rnk"]).head(100)


def _q47_like(t, fact, prefix, dim, fkey, pkey, dname, price_col):
    f = t[fact].merge(t["date_dim"], left_on=f"{prefix}_sold_date_sk",
                      right_on="d_date_sk")
    f = f[(f.d_year == 2000) | ((f.d_year == 1999) & (f.d_moy == 12))
          | ((f.d_year == 2001) & (f.d_moy == 1))]
    f = f.merge(t[dim], left_on=fkey, right_on=pkey)
    f = f.merge(t["item"], left_on=f"{prefix}_item_sk", right_on="i_item_sk")
    keys = ["i_category", "i_brand", dname]
    g = f.groupby(keys + ["d_year", "d_moy"], as_index=False).agg(
        sum_sales=(price_col, "sum")
    )
    g["avg_monthly_sales"] = g.groupby(keys + ["d_year"])[
        "sum_sales"
    ].transform("mean")
    g = g.sort_values(keys + ["d_year", "d_moy"], kind="stable")
    g["psum"] = g.groupby(keys)["sum_sales"].shift(1)
    g["nsum"] = g.groupby(keys)["sum_sales"].shift(-1)
    g = g[(g.d_year == 2000) & (g.avg_monthly_sales > 0)]
    g = g[np.abs(g.sum_sales - g.avg_monthly_sales) / g.avg_monthly_sales > 0.1]
    g["delta"] = g.sum_sales - g.avg_monthly_sales
    out = _srt(g, ["delta", "i_category", "i_brand", dname, "d_moy"]).head(100)
    return out[["i_category", "i_brand", dname, "d_year", "d_moy",
                "sum_sales", "avg_monthly_sales", "psum", "nsum"]]


def q47(t):
    return _q47_like(t, "store_sales", "ss", "store", "ss_store_sk",
                     "s_store_sk", "s_store_name", "ss_sales_price")


def q57(t):
    return _q47_like(t, "catalog_sales", "cs", "call_center",
                     "cs_call_center_sk", "cc_call_center_sk", "cc_name",
                     "cs_sales_price")


def q40(t):
    j = t["catalog_sales"].merge(
        t["catalog_returns"][["cr_order_number", "cr_item_sk",
                              "cr_refunded_cash"]],
        left_on=["cs_order_number", "cs_item_sk"],
        right_on=["cr_order_number", "cr_item_sk"], how="left",
    )
    it = t["item"]
    it = it[it.i_current_price.between(10.0, 60.0)]
    j = j.merge(it, left_on="cs_item_sk", right_on="i_item_sk")
    j = j.merge(t["warehouse"], left_on="cs_warehouse_sk",
                right_on="w_warehouse_sk")
    j = j.merge(t["date_dim"], left_on="cs_sold_date_sk",
                right_on="d_date_sk")
    lo = D("2000-03-11") - np.timedelta64(30, "D")
    hi = D("2000-03-11") + np.timedelta64(30, "D")
    j = j[(j.d_date >= lo) & (j.d_date <= hi)]
    net = j.cs_sales_price - j.cr_refunded_cash.fillna(0)
    pivot = D("2000-03-11")
    j = j.assign(
        sales_before=np.where(j.d_date < pivot, net, 0.0),
        sales_after=np.where(j.d_date >= pivot, net, 0.0),
    )
    g = j.groupby(["w_state", "i_item_id"], as_index=False)[
        ["sales_before", "sales_after"]
    ].sum()
    return _srt(g, ["w_state", "i_item_id"]).head(100)


def q18(t):
    cd = t["customer_demographics"]
    cd = cd[(cd.cd_gender == "F") & (cd.cd_education_status == "Unknown")]
    c = t["customer"]
    c = c[c.c_birth_month.isin([1, 2, 6, 8, 9, 12])]
    j = t["catalog_sales"].merge(t["date_dim"], left_on="cs_sold_date_sk",
                                 right_on="d_date_sk")
    j = j[j.d_year == 2001]
    j = j.merge(t["item"], left_on="cs_item_sk", right_on="i_item_sk")
    j = j.merge(cd, left_on="cs_bill_cdemo_sk", right_on="cd_demo_sk")
    j = j.merge(c, left_on="cs_bill_customer_sk", right_on="c_customer_sk")
    j = j.merge(t["customer_address"], left_on="c_current_addr_sk",
                right_on="ca_address_sk")
    aggs = {
        "agg1": "cs_quantity", "agg2": "cs_list_price",
        "agg3": "cs_coupon_amt", "agg4": "cs_sales_price",
        "agg5": "cs_net_profit", "agg6": "c_birth_year",
        "agg7": "cd_dep_count",
    }
    levels = [["i_item_id", "ca_country", "ca_state", "ca_county"],
              ["i_item_id", "ca_country", "ca_state"],
              ["i_item_id", "ca_country"], ["i_item_id"], []]
    parts = []
    for lv in levels:
        if lv:
            g = j.groupby(lv, as_index=False).agg(
                **{k: (v, "mean") for k, v in aggs.items()}
            )
        else:
            g = fr.DataFrame({k: [j[v].mean()] for k, v in aggs.items()})
        for col in ["i_item_id", "ca_country", "ca_state", "ca_county"]:
            if col not in g:
                g[col] = None
        parts.append(g[["i_item_id", "ca_country", "ca_state", "ca_county"]
                       + list(aggs)])
    u = fr.concat(parts, ignore_index=True)
    u = u.sort_values("i_item_id", na_position="last", kind="stable")
    u = u.sort_values("ca_county", na_position="last", kind="stable")
    u = u.sort_values("ca_state", na_position="last", kind="stable")
    u = u.sort_values("ca_country", na_position="last", kind="stable")
    return u.reset_index(drop=True).head(100)


def q5(t):
    lo = D("2000-08-03")
    hi = lo + np.timedelta64(14, "D")
    dd = t["date_dim"]
    dd = dd[(dd.d_date >= lo) & (dd.d_date <= hi)][["d_date_sk"]]

    def channel(sales, s_unit, s_date, s_price, s_profit,
                rets, r_unit, r_date, r_amt, r_loss, dim_keys):
        s = fr.DataFrame({
            "unit_sk": sales[s_unit], "date_sk": sales[s_date],
            "sales_price": sales[s_price], "profit": sales[s_profit],
            "return_amt": 0.0, "net_loss": 0.0,
        })
        r = fr.DataFrame({
            "unit_sk": rets[r_unit], "date_sk": rets[r_date],
            "sales_price": 0.0, "profit": 0.0,
            "return_amt": rets[r_amt], "net_loss": rets[r_loss],
        })
        u = fr.concat([s, r], ignore_index=True)
        u = u.merge(dd, left_on="date_sk", right_on="d_date_sk")
        u = u[u.unit_sk.isin(dim_keys)]
        g = u.groupby("unit_sk", as_index=False).agg(
            sales=("sales_price", "sum"), returns_=("return_amt", "sum"),
            profit=("profit", "sum"), profit_loss=("net_loss", "sum"),
        )
        g["profit"] = g.profit - g.profit_loss
        return g.rename(columns={"unit_sk": "id"})[
            ["id", "sales", "returns_", "profit"]
        ]

    wr = t["web_returns"].merge(
        t["web_sales"][["ws_item_sk", "ws_order_number", "ws_web_site_sk"]],
        left_on=["wr_item_sk", "wr_order_number"],
        right_on=["ws_item_sk", "ws_order_number"],
    )
    parts = [
        channel(t["store_sales"], "ss_store_sk", "ss_sold_date_sk",
                "ss_ext_sales_price", "ss_net_profit",
                t["store_returns"], "sr_store_sk", "sr_returned_date_sk",
                "sr_return_amt", "sr_net_loss",
                set(t["store"].s_store_sk)).assign(channel=1),
        channel(t["catalog_sales"], "cs_call_center_sk", "cs_sold_date_sk",
                "cs_ext_sales_price", "cs_net_profit",
                t["catalog_returns"], "cr_call_center_sk",
                "cr_returned_date_sk", "cr_return_amount", "cr_net_loss",
                set(t["call_center"].cc_call_center_sk)).assign(channel=2),
        channel(t["web_sales"], "ws_web_site_sk", "ws_sold_date_sk",
                "ws_ext_sales_price", "ws_net_profit",
                wr, "ws_web_site_sk", "wr_returned_date_sk",
                "wr_return_amt", "wr_net_loss",
                set(t["web_site"].web_site_sk)).assign(channel=3),
    ]
    x = fr.concat(parts, ignore_index=True)
    detail = x.groupby(["channel", "id"], as_index=False)[
        ["sales", "returns_", "profit"]
    ].sum()
    per_ch = x.groupby("channel", as_index=False)[
        ["sales", "returns_", "profit"]
    ].sum()
    per_ch["id"] = None
    total = fr.DataFrame({
        "channel": [None], "id": [None], "sales": [x.sales.sum()],
        "returns_": [x.returns_.sum()], "profit": [x.profit.sum()],
    })
    u = fr.concat(
        [detail, per_ch[["channel", "id", "sales", "returns_", "profit"]],
         total], ignore_index=True,
    )
    u = u.sort_values("id", na_position="last", kind="stable")
    u = u.sort_values("channel", na_position="last", kind="stable")
    return u[["channel", "id", "sales", "returns_", "profit"]].reset_index(
        drop=True
    ).head(100)

def q97(t):
    d = t["date_dim"]
    dd = d[(d.d_month_seq >= 1200) & (d.d_month_seq <= 1211)][["d_date_sk"]]
    ss = t["store_sales"].merge(dd, left_on="ss_sold_date_sk", right_on="d_date_sk")
    ssci = ss[["ss_customer_sk", "ss_item_sk"]].drop_duplicates()
    cs = t["catalog_sales"].merge(dd, left_on="cs_sold_date_sk", right_on="d_date_sk")
    csci = cs[["cs_bill_customer_sk", "cs_item_sk"]].drop_duplicates()
    # NULL keys never match in SQL (a merge, as pandas', WOULD match
    # NaN==NaN): count inner matches among fully-non-null pairs, then
    # derive the full-outer buckets arithmetically (both sides are
    # duplicate-free on the pair).
    both = ssci.dropna().merge(
        csci.dropna(),
        left_on=["ss_customer_sk", "ss_item_sk"],
        right_on=["cs_bill_customer_sk", "cs_item_sk"],
    )
    n = len(both)
    return fr.DataFrame({
        "store_only": [len(ssci) - n],
        "catalog_only": [len(csci) - n],
        "store_and_catalog": [n],
    })


def q51(t):
    d = t["date_dim"]
    dd = d[(d.d_month_seq >= 1200) & (d.d_month_seq <= 1211)][
        ["d_date_sk", "d_date"]
    ]

    def v1(tbl, item, date_col, price):
        j = t[tbl].merge(dd, left_on=date_col, right_on="d_date_sk")
        j = j[j[item].notna()]
        g = j.groupby([item, "d_date"], as_index=False).agg(s=(price, "sum"))
        g = g.sort_values([item, "d_date"], kind="stable")
        g["cume_sales"] = g.groupby(item)["s"].cumsum()
        return g.rename(columns={item: "item_sk"})[
            ["item_sk", "d_date", "cume_sales"]
        ]

    web = v1("web_sales", "ws_item_sk", "ws_sold_date_sk", "ws_sales_price")
    store = v1("store_sales", "ss_item_sk", "ss_sold_date_sk", "ss_sales_price")
    # keys are non-null (filtered above), so an outer merge == SQL full outer
    m = web.merge(store, on=["item_sk", "d_date"], how="outer",
                  suffixes=("_w", "_s"))
    m = m.rename(columns={"cume_sales_w": "web_sales",
                          "cume_sales_s": "store_sales"})
    m = m.sort_values(["item_sk", "d_date"], kind="stable")
    # SQL running MAX ignores NULLs: cummax (as pandas') leaves NaN at NaN
    # input positions, so forward-fill within the partition (an all-NaN
    # prefix stays NaN, matching MAX over an empty value set)
    for out, src in (("web_cumulative", "web_sales"),
                     ("store_cumulative", "store_sales")):
        m[out] = m.groupby("item_sk")[src].cummax()
        m[out] = m.groupby("item_sk")[out].ffill()
    r = m[m.web_cumulative > m.store_cumulative]
    r = r.sort_values(["item_sk", "d_date"], kind="stable").head(100)
    return r[["item_sk", "d_date", "web_sales", "store_sales",
              "web_cumulative", "store_cumulative"]].reset_index(drop=True)


def q27(t):
    j = _ss_dd_it(t).merge(
        t["customer_demographics"], left_on="ss_cdemo_sk",
        right_on="cd_demo_sk",
    ).merge(t["store"], left_on="ss_store_sk", right_on="s_store_sk")
    j = j[(j.cd_gender == "M") & (j.cd_marital_status == "S")
          & (j.cd_education_status == "College") & (j.d_year == 2000)
          & (j.s_state.isin(["HI", "KY", "LA"]))]
    vals = ["ss_quantity", "ss_list_price", "ss_coupon_amt", "ss_sales_price"]

    def level(keys):
        if keys:
            g = j.groupby(keys, as_index=False, dropna=False)[vals].mean()
        else:
            g = fr.DataFrame({v: [j[v].mean()] for v in vals})
        return g

    detail = level(["i_item_id", "s_state"]); detail["g_state"] = 0
    sub = level(["i_item_id"]); sub["g_state"] = 1; sub["s_state"] = None
    grand = level([]); grand["g_state"] = 1
    grand["i_item_id"] = None; grand["s_state"] = None
    u = fr.concat([detail, sub, grand], ignore_index=True)
    u = u.sort_values(["i_item_id", "s_state"], na_position="last",
                      kind="stable").head(100)
    u = u.rename(columns=dict(zip(vals, ["agg1", "agg2", "agg3", "agg4"])))
    return u[["i_item_id", "s_state", "g_state",
              "agg1", "agg2", "agg3", "agg4"]].reset_index(drop=True)


def q70(t):
    d = t["date_dim"]
    dd = d[(d.d_month_seq >= 1200) & (d.d_month_seq <= 1211)][["d_date_sk"]]
    j = t["store_sales"].merge(dd, left_on="ss_sold_date_sk",
                               right_on="d_date_sk")
    j = j.merge(t["store"], left_on="ss_store_sk", right_on="s_store_sk")
    # the official subquery ranks PARTITION BY s_state over a GROUP BY
    # s_state — one row per partition, so ranking is always 1 and the
    # `ranking <= 5` filter keeps every state (the well-known q70
    # quirk); mirror that exactly
    by_state = j.groupby("s_state")["ss_net_profit"].sum()
    j = j[j.s_state.isin(by_state.index)]
    detail = j.groupby(["s_state", "s_county"], as_index=False,
                       dropna=False).agg(total_sum=("ss_net_profit", "sum"))
    detail["lochierarchy"] = 0
    sub = j.groupby(["s_state"], as_index=False, dropna=False).agg(
        total_sum=("ss_net_profit", "sum"))
    sub["s_county"] = None; sub["lochierarchy"] = 1
    grand = fr.DataFrame({"total_sum": [j.ss_net_profit.sum()],
                          "s_state": [None], "s_county": [None],
                          "lochierarchy": [2]})
    u = fr.concat([detail, sub, grand], ignore_index=True)
    part_state = u.s_state.where(u.lochierarchy == 0, None)
    # rows carry no index: the partition column rides the frame through
    # the sorts below (the reference assigns it after them, by index)
    u["ck"] = part_state
    u["rank_within_parent"] = u.groupby(
        ["lochierarchy", "ck"], dropna=False
    )["total_sum"].rank(ascending=False, method="min").astype(int)
    u = u.sort_values(["s_state", "s_county"], na_position="last",
                      kind="stable")
    u = u.sort_values("rank_within_parent", kind="stable")
    u = u.sort_values("ck", na_position="last", kind="stable")
    u = u.sort_values("lochierarchy", ascending=False, kind="stable")
    return u[["total_sum", "s_state", "s_county", "lochierarchy",
              "rank_within_parent"]].head(100).reset_index(drop=True)


def q67(t):
    d = t["date_dim"]
    dd = d[(d.d_month_seq >= 1200) & (d.d_month_seq <= 1211)][
        ["d_date_sk", "d_year", "d_qoy", "d_moy"]]
    j = t["store_sales"].merge(dd, left_on="ss_sold_date_sk",
                               right_on="d_date_sk")
    j = j.merge(t["store"], left_on="ss_store_sk", right_on="s_store_sk")
    j = j.merge(t["item"], left_on="ss_item_sk", right_on="i_item_sk")
    # exact integer cents: the engine ranks on exact scaled-int decimal
    # sums, so a float oracle can flip near-tie rank boundaries
    j["sales"] = (
        (j.ss_sales_price * 100).round().fillna(0).astype(np.int64)
        * j.ss_quantity.fillna(0).astype(np.int64)
    )
    cols = ["i_category", "i_class", "i_brand", "i_product_name",
            "d_year", "d_qoy", "d_moy", "s_store_id"]
    frames = []
    for k in range(len(cols), -1, -1):
        keys = cols[:k]
        if keys:
            g = j.groupby(keys, as_index=False, dropna=False).agg(
                sumsales=("sales", "sum"))
        else:
            g = fr.DataFrame({"sumsales": [j.sales.sum()]})
        for c in cols[k:]:
            g[c] = None
        frames.append(g)
    u = fr.concat(frames, ignore_index=True)
    u["rk"] = u.groupby("i_category", dropna=False)["sumsales"].rank(
        ascending=False, method="min").astype(int)
    u = u[u.rk <= 100]
    u = u.sort_values(["rk"], kind="stable")
    u = u.sort_values(["sumsales"], kind="stable")
    for c in reversed(cols):
        u = u.sort_values(c, na_position="last", kind="stable")
    u["sumsales"] = u.sumsales / 100.0
    return u[cols + ["sumsales", "rk"]].head(100).reset_index(drop=True)


def _active_customers(t, extra_pred):
    """Customers with store activity AND (web OR catalog) activity in
    the window (q10/q35 EXISTS semantics)."""
    d = t["date_dim"]
    dd = d[extra_pred(d)][["d_date_sk"]]
    c = t["customer"]
    ss = t["store_sales"].merge(dd, left_on="ss_sold_date_sk",
                                right_on="d_date_sk")
    ws = t["web_sales"].merge(dd, left_on="ws_sold_date_sk",
                              right_on="d_date_sk")
    cs = t["catalog_sales"].merge(dd, left_on="cs_sold_date_sk",
                                  right_on="d_date_sk")
    has_ss = c.c_customer_sk.isin(ss.ss_customer_sk.dropna())
    has_wc = (c.c_customer_sk.isin(ws.ws_bill_customer_sk.dropna())
              | c.c_customer_sk.isin(cs.cs_ship_customer_sk.dropna()))
    return c[has_ss & has_wc]


def q10(t):
    c = _active_customers(
        t, lambda d: (d.d_year == 2000) & (d.d_moy >= 1) & (d.d_moy <= 4))
    j = c.merge(t["customer_address"], left_on="c_current_addr_sk",
                right_on="ca_address_sk")
    j = j[j.ca_county.isin(["Williamson County", "Huron County",
                            "Daviess County", "Maricopa County",
                            "Ziebach County"])]
    j = j.merge(t["customer_demographics"], left_on="c_current_cdemo_sk",
                right_on="cd_demo_sk")
    keys = ["cd_gender", "cd_marital_status", "cd_education_status",
            "cd_purchase_estimate", "cd_credit_rating", "cd_dep_count",
            "cd_dep_employed_count", "cd_dep_college_count"]
    g = j.groupby(keys, as_index=False, dropna=False).agg(
        cnt1=("cd_demo_sk", "size"))
    for n in ("cnt2", "cnt3", "cnt4", "cnt5", "cnt6"):
        g[n] = g.cnt1
    g = g.sort_values(keys, kind="stable").head(100)
    return g[["cd_gender", "cd_marital_status", "cd_education_status",
              "cnt1", "cd_purchase_estimate", "cnt2", "cd_credit_rating",
              "cnt3", "cd_dep_count", "cnt4", "cd_dep_employed_count",
              "cnt5", "cd_dep_college_count", "cnt6"]].reset_index(drop=True)


def q35(t):
    c = _active_customers(t, lambda d: (d.d_year == 2000) & (d.d_qoy < 4))
    j = c.merge(t["customer_address"], left_on="c_current_addr_sk",
                right_on="ca_address_sk")
    j = j.merge(t["customer_demographics"], left_on="c_current_cdemo_sk",
                right_on="cd_demo_sk")
    keys = ["ca_state", "cd_gender", "cd_marital_status", "cd_dep_count",
            "cd_dep_employed_count", "cd_dep_college_count"]
    g = j.groupby(keys, as_index=False, dropna=False).agg(
        cnt1=("cd_demo_sk", "size"),
        a1=("cd_dep_count", "mean"), m1=("cd_dep_count", "max"),
        s1=("cd_dep_count", "sum"),
        a2=("cd_dep_employed_count", "mean"),
        m2=("cd_dep_employed_count", "max"),
        s2=("cd_dep_employed_count", "sum"),
        a3=("cd_dep_college_count", "mean"),
        m3=("cd_dep_college_count", "max"),
        s3=("cd_dep_college_count", "sum"),
    )
    g["cnt2"] = g.cnt1
    g["cnt3"] = g.cnt1
    g = g.sort_values(keys, na_position="last", kind="stable").head(100)
    return g[["ca_state", "cd_gender", "cd_marital_status", "cd_dep_count",
              "cnt1", "a1", "m1", "s1", "cd_dep_employed_count", "cnt2",
              "a2", "m2", "s2", "cd_dep_college_count", "cnt3", "a3",
              "m3", "s3"]].reset_index(drop=True)


def q41(t):
    it = t["item"]
    c1 = (it.i_category == "Home") & it.i_size.isin(["medium", "economy"])
    c2 = ((it.i_category == "Electronics")
          & it.i_size.isin(["petite", "medium"]))
    c3 = (it.i_category == "Men") & it.i_size.isin(["medium", "economy"])
    c4 = ((it.i_category == "Jewelry")
          & it.i_size.isin(["petite", "extra large"]))
    good_manufacts = set(it[c1 | c2 | c3 | c4].i_manufact.dropna())
    sel = it[(it.i_manufact_id >= 600) & (it.i_manufact_id <= 800)
             & it.i_manufact.isin(good_manufacts)]
    names = sorted(sel.i_product_name.dropna().unique())[:100]
    return fr.DataFrame({"i_product_name": names})


def q84(t):
    cu = t["customer"]
    j = cu.merge(t["customer_address"], left_on="c_current_addr_sk",
                 right_on="ca_address_sk")
    j = j[j.ca_city.str.strip() == "after"]
    j = j.merge(t["customer_demographics"], left_on="c_current_cdemo_sk",
                right_on="cd_demo_sk")
    j = j.merge(t["household_demographics"], left_on="c_current_hdemo_sk",
                right_on="hd_demo_sk")
    ib = t["income_band"]
    ib = ib[(ib.ib_lower_bound >= 30001) & (ib.ib_upper_bound <= 80000)]
    j = j.merge(ib, left_on="hd_income_band_sk", right_on="ib_income_band_sk")
    j = j.merge(t["store_returns"], left_on="c_customer_sk",
                right_on="sr_customer_sk")
    j = j.sort_values("c_customer_id", kind="stable").head(100)
    # the engine's || emits the full fixed CHAR width of the left part
    # (c_last_name is bytes(30)); trailing padding of the final part is
    # stripped on decode
    name = (j.c_last_name.fillna("").str.ljust(30) + ", "
            + j.c_first_name.fillna("").str.ljust(20))
    return fr.DataFrame({"customer_id": j.c_customer_id.to_numpy(),
                         "customername": name.to_numpy()})


def q8(t):
    ca = t["customer_address"]
    ziplist = ["50183", "00355", "50970", "22225", "00565", "50602",
               "22614", "68502", "45287", "98313"]
    a = set(ca.ca_zip.dropna().str[:5]) & set(ziplist)
    pref = t["customer"][t["customer"].c_preferred_cust_flag == "Y"].merge(
        ca, left_on="c_current_addr_sk", right_on="ca_address_sk")
    vc = pref.ca_zip.dropna().str[:5].value_counts()
    b = set(vc[vc > 1].index)
    v1 = fr.DataFrame({"ca_zip2": [z[:2] for z in sorted(a & b)]})
    d = t["date_dim"]
    dd = d[(d.d_qoy == 2) & (d.d_year == 2000)][["d_date_sk"]]
    st = t["store"].copy()
    st["s_zip2"] = st.s_zip.str[:2]
    j = t["store_sales"].merge(dd, left_on="ss_sold_date_sk",
                               right_on="d_date_sk")
    j = j.merge(st, left_on="ss_store_sk", right_on="s_store_sk")
    j = j.merge(v1, left_on="s_zip2", right_on="ca_zip2")
    g = j.groupby("s_store_name", as_index=False).agg(
        profit=("ss_net_profit", "sum"))
    return g.sort_values("s_store_name", kind="stable").head(
        100).reset_index(drop=True)


def _q83_channel(t, tbl, item_col, date_col, qty_col):
    d = t["date_dim"]
    weeks = set(d[d.d_date.isin([D("2000-04-22"), D("2000-07-01"),
                                 D("2000-10-21")])].d_week_seq)
    dates = d[d.d_week_seq.isin(weeks)][["d_date_sk"]]
    j = t[tbl].merge(dates, left_on=date_col, right_on="d_date_sk")
    j = j.merge(t["item"], left_on=item_col, right_on="i_item_sk")
    return j.groupby("i_item_id", as_index=False).agg(q=(qty_col, "sum"))


def q83(t):
    sr = _q83_channel(t, "store_returns", "sr_item_sk",
                      "sr_returned_date_sk", "sr_return_quantity")
    cr = _q83_channel(t, "catalog_returns", "cr_item_sk",
                      "cr_returned_date_sk", "cr_return_quantity")
    wr = _q83_channel(t, "web_returns", "wr_item_sk",
                      "wr_returned_date_sk", "wr_return_quantity")
    j = sr.merge(cr, on="i_item_id", suffixes=("_sr", "_cr")).merge(
        wr, on="i_item_id")
    j = j.rename(columns={"q_sr": "sr_item_qty", "q_cr": "cr_item_qty",
                          "q": "wr_item_qty"})
    tot = j.sr_item_qty + j.cr_item_qty + j.wr_item_qty
    j["sr_dev"] = j.sr_item_qty / tot / 3.0 * 100
    j["cr_dev"] = j.cr_item_qty / tot / 3.0 * 100
    j["wr_dev"] = j.wr_item_qty / tot / 3.0 * 100
    j["average"] = tot / 3.0
    j = j.sort_values(["i_item_id", "sr_item_qty"], kind="stable").head(100)
    return j.rename(columns={"i_item_id": "item_id"})[
        ["item_id", "sr_item_qty", "sr_dev", "cr_item_qty", "cr_dev",
         "wr_item_qty", "wr_dev", "average"]].reset_index(drop=True)


def _q58_channel(t, tbl, item_col, date_col, rev_col):
    d = t["date_dim"]
    wk = d[d.d_date == D("2000-10-07")].d_week_seq.iloc[0]
    dates = d[d.d_week_seq == wk][["d_date_sk"]]
    j = t[tbl].merge(dates, left_on=date_col, right_on="d_date_sk")
    j = j.merge(t["item"], left_on=item_col, right_on="i_item_sk")
    return j.groupby("i_item_id", as_index=False).agg(r=(rev_col, "sum"))


def q58(t):
    ss = _q58_channel(t, "store_sales", "ss_item_sk", "ss_sold_date_sk",
                      "ss_ext_sales_price")
    cs = _q58_channel(t, "catalog_sales", "cs_item_sk", "cs_sold_date_sk",
                      "cs_ext_sales_price")
    ws = _q58_channel(t, "web_sales", "ws_item_sk", "ws_sold_date_sk",
                      "ws_ext_sales_price")
    j = ss.merge(cs, on="i_item_id", suffixes=("_ss", "_cs")).merge(
        ws, on="i_item_id")
    j = j.rename(columns={"r_ss": "ss_item_rev", "r_cs": "cs_item_rev",
                          "r": "ws_item_rev"})
    m = ((j.ss_item_rev.between(0.1 * j.cs_item_rev, 10.0 * j.cs_item_rev))
         & (j.ss_item_rev.between(0.1 * j.ws_item_rev, 10.0 * j.ws_item_rev))
         & (j.cs_item_rev.between(0.1 * j.ss_item_rev, 10.0 * j.ss_item_rev))
         & (j.cs_item_rev.between(0.1 * j.ws_item_rev, 10.0 * j.ws_item_rev))
         & (j.ws_item_rev.between(0.1 * j.ss_item_rev, 10.0 * j.ss_item_rev))
         & (j.ws_item_rev.between(0.1 * j.cs_item_rev, 10.0 * j.cs_item_rev)))
    j = j[m]
    avg = (j.ss_item_rev + j.cs_item_rev + j.ws_item_rev) / 3
    j["ss_dev"] = j.ss_item_rev / avg * 100
    j["cs_dev"] = j.cs_item_rev / avg * 100
    j["ws_dev"] = j.ws_item_rev / avg * 100
    j["average"] = avg
    j = j.sort_values(["i_item_id", "ss_item_rev"], kind="stable").head(100)
    return j.rename(columns={"i_item_id": "item_id"})[
        ["item_id", "ss_item_rev", "ss_dev", "cs_item_rev", "cs_dev",
         "ws_item_rev", "ws_dev", "average"]].reset_index(drop=True)


_Q66_MONTHS = ["jan", "feb", "mar", "apr", "may", "jun", "jul", "aug",
               "sep", "oct", "nov", "dec"]


def _q66_channel(t, tbl, wh_col, date_col, time_col, mode_col,
                 price_col, net_col, qty_col):
    d = t["date_dim"]
    td = t["time_dim"]
    sm = t["ship_mode"]
    j = t[tbl].merge(t["warehouse"], left_on=wh_col,
                     right_on="w_warehouse_sk")
    j = j.merge(d[d.d_year == 2001][["d_date_sk", "d_year", "d_moy"]],
                left_on=date_col, right_on="d_date_sk")
    j = j.merge(td[(td.t_time >= 30838) & (td.t_time <= 59638)][["t_time_sk"]],
                left_on=time_col, right_on="t_time_sk")
    j = j.merge(sm[sm.sm_carrier.isin(["DHL", "BARIAN"])][["sm_ship_mode_sk"]],
                left_on=mode_col, right_on="sm_ship_mode_sk")
    keys = ["w_warehouse_name", "w_warehouse_sq_ft", "w_city", "w_county",
            "w_state", "w_country", "d_year"]
    for i, mn in enumerate(_Q66_MONTHS):
        moy = j.d_moy == i + 1
        j[f"{mn}_sales"] = (j[price_col] * j[qty_col]).where(moy, 0.0)
        j[f"{mn}_net"] = (j[net_col] * j[qty_col]).where(moy, 0.0)
    cols = [f"{mn}_sales" for mn in _Q66_MONTHS] + [
        f"{mn}_net" for mn in _Q66_MONTHS]
    g = j.groupby(keys, as_index=False, dropna=False)[cols].sum()
    g["ship_carriers"] = "DHL,BARIAN"
    return g


def q66(t):
    web = _q66_channel(t, "web_sales", "ws_warehouse_sk", "ws_sold_date_sk",
                       "ws_sold_time_sk", "ws_ship_mode_sk",
                       "ws_ext_sales_price", "ws_net_paid", "ws_quantity")
    cat = _q66_channel(t, "catalog_sales", "cs_warehouse_sk",
                       "cs_sold_date_sk", "cs_sold_time_sk",
                       "cs_ship_mode_sk", "cs_sales_price", "cs_net_paid",
                       "cs_quantity")
    u = fr.concat([web, cat], ignore_index=True)
    keys = ["w_warehouse_name", "w_warehouse_sq_ft", "w_city", "w_county",
            "w_state", "w_country", "ship_carriers", "d_year"]
    u["jan_spsf"] = u.jan_sales / u.w_warehouse_sq_ft
    u["dec_spsf"] = u.dec_sales / u.w_warehouse_sq_ft
    cols = ([f"{mn}_sales" for mn in _Q66_MONTHS] + ["jan_spsf", "dec_spsf"]
            + [f"{mn}_net" for mn in _Q66_MONTHS])
    g = u.groupby(keys, as_index=False, dropna=False)[cols].sum()
    g = g.sort_values("w_warehouse_name", kind="stable").head(100)
    out_cols = (keys[:7] + ["d_year"]
                + [f"{mn}_sales" for mn in _Q66_MONTHS]
                + ["jan_spsf", "dec_spsf"]
                + [f"{mn}_net" for mn in _Q66_MONTHS])
    g = g[keys + cols]
    return g.reset_index(drop=True)


def _yt(t, tbl, cust_col, date_col, val_fn, extra_keys=()):
    """Per-customer-per-year channel totals in exact integer cents."""
    j = t["customer"].merge(t[tbl], left_on="c_customer_sk",
                            right_on=cust_col)
    j = j.merge(t["date_dim"][["d_date_sk", "d_year"]], left_on=date_col,
                right_on="d_date_sk")
    j = j[j.d_year.isin([1999, 2000])]
    j = j.assign(v=val_fn(j))
    keys = (["c_customer_id", "c_first_name", "c_last_name"]
            + list(extra_keys) + ["d_year"])
    return j.groupby(keys, as_index=False, dropna=False).agg(
        total=("v", "sum"))


def _cents(s):
    return (s * 100).round().fillna(0)


def _ratio32(sec, first):
    """Replicate the engine's DOUBLE division: decimal -> float32."""
    f32 = lambda s: (s.to_numpy() / 100.0).astype(np.float32)  # noqa: E731
    return f32(sec) / f32(first)


def q74(t):
    s = _yt(t, "store_sales", "ss_customer_sk", "ss_sold_date_sk",
            lambda j: _cents(j.ss_net_paid))
    w = _yt(t, "web_sales", "ws_bill_customer_sk", "ws_sold_date_sk",
            lambda j: _cents(j.ws_net_paid))
    s1 = s[s.d_year == 1999]
    s2 = s[s.d_year == 2000]
    w1 = w[w.d_year == 1999]
    w2 = w[w.d_year == 2000]
    m = (s2.merge(s1[["c_customer_id", "total"]], on="c_customer_id",
                  suffixes=("", "_s1"))
         .merge(w1[["c_customer_id", "total"]].rename(
             columns={"total": "total_w1"}), on="c_customer_id")
         .merge(w2[["c_customer_id", "total"]].rename(
             columns={"total": "total_w2"}), on="c_customer_id"))
    m = m[(m.total_s1 > 0) & (m.total_w1 > 0)]
    m = m[_ratio32(m.total_w2, m.total_w1) > _ratio32(m.total, m.total_s1)]
    m = m.sort_values(["c_customer_id", "c_first_name", "c_last_name"],
                      kind="stable").head(100)
    return m.rename(columns={
        "c_customer_id": "customer_id",
        "c_first_name": "customer_first_name",
        "c_last_name": "customer_last_name",
    })[["customer_id", "customer_first_name",
        "customer_last_name"]].reset_index(drop=True)


def q11(t):
    s = _yt(t, "store_sales", "ss_customer_sk", "ss_sold_date_sk",
            lambda j: _cents(j.ss_ext_list_price - j.ss_ext_discount_amt),
            extra_keys=("c_email_address",))
    w = _yt(t, "web_sales", "ws_bill_customer_sk", "ws_sold_date_sk",
            lambda j: _cents(j.ws_ext_list_price - j.ws_ext_discount_amt),
            extra_keys=("c_email_address",))
    s1 = s[s.d_year == 1999]
    s2 = s[s.d_year == 2000]
    w1 = w[w.d_year == 1999]
    w2 = w[w.d_year == 2000]
    m = (s2.merge(s1[["c_customer_id", "total"]], on="c_customer_id",
                  suffixes=("", "_s1"))
         .merge(w1[["c_customer_id", "total"]].rename(
             columns={"total": "total_w1"}), on="c_customer_id")
         .merge(w2[["c_customer_id", "total"]].rename(
             columns={"total": "total_w2"}), on="c_customer_id"))
    m = m[(m.total_s1 > 0) & (m.total_w1 > 0)]
    m = m[_ratio32(m.total_w2, m.total_w1) > _ratio32(m.total, m.total_s1)]
    m = m.sort_values(["c_customer_id", "c_first_name", "c_last_name",
                       "c_email_address"], kind="stable").head(100)
    return m.rename(columns={
        "c_customer_id": "customer_id",
        "c_first_name": "customer_first_name",
        "c_last_name": "customer_last_name",
        "c_email_address": "customer_email_address",
    })[["customer_id", "customer_first_name", "customer_last_name",
        "customer_email_address"]].reset_index(drop=True)


def q4(t):
    def half(j, p):
        return _cents(((j[f"{p}_ext_list_price"]
                        - j[f"{p}_ext_wholesale_cost"]
                        - j[f"{p}_ext_discount_amt"])
                       + j[f"{p}_ext_sales_price"]) / 2)

    s = _yt(t, "store_sales", "ss_customer_sk", "ss_sold_date_sk",
            lambda j: half(j, "ss"))
    c = _yt(t, "catalog_sales", "cs_bill_customer_sk", "cs_sold_date_sk",
            lambda j: half(j, "cs"))
    w = _yt(t, "web_sales", "ws_bill_customer_sk", "ws_sold_date_sk",
            lambda j: half(j, "ws"))
    m = s[s.d_year == 2000].merge(
        s[s.d_year == 1999][["c_customer_id", "total"]],
        on="c_customer_id", suffixes=("", "_s1"))
    for nm, fr in (("c1", c[c.d_year == 1999]), ("c2", c[c.d_year == 2000]),
                   ("w1", w[w.d_year == 1999]), ("w2", w[w.d_year == 2000])):
        m = m.merge(fr[["c_customer_id", "total"]].rename(
            columns={"total": f"total_{nm}"}), on="c_customer_id")
    m = m[(m.total_s1 > 0) & (m.total_c1 > 0) & (m.total_w1 > 0)]
    rc = _ratio32(m.total_c2, m.total_c1)
    m = m[(rc > _ratio32(m.total, m.total_s1))
          & (rc > _ratio32(m.total_w2, m.total_w1))]
    m = m.sort_values(["c_customer_id", "c_first_name", "c_last_name"],
                      kind="stable").head(100)
    return m.rename(columns={
        "c_customer_id": "customer_id",
        "c_first_name": "customer_first_name",
        "c_last_name": "customer_last_name",
    })[["customer_id", "customer_first_name",
        "customer_last_name"]].reset_index(drop=True)


def _date_window(t, lo="2000-08-03", days=30):
    d = t["date_dim"]
    return d[(d.d_date >= D(lo))
             & (d.d_date <= D(lo) + np.timedelta64(days, "D"))][["d_date_sk"]]


def q77(t):
    dd = _date_window(t)
    ss = (t["store_sales"].merge(dd, left_on="ss_sold_date_sk",
                                 right_on="d_date_sk")
          .merge(t["store"], left_on="ss_store_sk", right_on="s_store_sk")
          .groupby("s_store_sk", as_index=False)
          .agg(sales=("ss_ext_sales_price", "sum"),
               profit=("ss_net_profit", "sum")))
    sr = (t["store_returns"].merge(dd, left_on="sr_returned_date_sk",
                                   right_on="d_date_sk")
          .groupby("sr_store_sk", as_index=False)
          .agg(returns_=("sr_return_amt", "sum"),
               profit_loss=("sr_net_loss", "sum")))
    store = ss.merge(sr.dropna(subset=["sr_store_sk"]),
                     left_on="s_store_sk", right_on="sr_store_sk",
                     how="left")
    store = fr.DataFrame({
        "channel": "store channel", "id": store.s_store_sk,
        "sales": store.sales, "returns_": store.returns_.fillna(0),
        "profit": store.profit - store.profit_loss.fillna(0)})
    cs = (t["catalog_sales"].merge(dd, left_on="cs_sold_date_sk",
                                   right_on="d_date_sk")
          .groupby("cs_call_center_sk", as_index=False, dropna=False)
          .agg(sales=("cs_ext_sales_price", "sum"),
               profit=("cs_net_profit", "sum")))
    crj = t["catalog_returns"].merge(dd, left_on="cr_returned_date_sk",
                                     right_on="d_date_sk")
    cat = fr.DataFrame({
        "channel": "catalog channel", "id": cs.cs_call_center_sk,
        "sales": cs.sales,
        "returns_": float(crj.cr_return_amount.sum()),
        "profit": cs.profit - float(crj.cr_net_loss.sum())})
    wsj = t["web_sales"].merge(dd, left_on="ws_sold_date_sk",
                               right_on="d_date_sk")
    ws = (wsj[wsj.ws_web_page_sk.notna()]
          .groupby("ws_web_page_sk", as_index=False)
          .agg(sales=("ws_ext_sales_price", "sum"),
               profit=("ws_net_profit", "sum")))
    wrj = (t["web_returns"].merge(
        t["web_sales"][["ws_order_number", "ws_item_sk", "ws_web_page_sk"]],
        left_on=["wr_order_number", "wr_item_sk"],
        right_on=["ws_order_number", "ws_item_sk"])
        .merge(dd, left_on="wr_returned_date_sk", right_on="d_date_sk"))
    wr = (wrj[wrj.ws_web_page_sk.notna()]
          .groupby("ws_web_page_sk", as_index=False)
          .agg(returns_=("wr_return_amt", "sum"),
               profit_loss=("wr_net_loss", "sum")))
    web = ws.merge(wr, on="ws_web_page_sk", how="left")
    web = fr.DataFrame({
        "channel": "web channel", "id": web.ws_web_page_sk,
        "sales": web.sales, "returns_": web.returns_.fillna(0),
        "profit": web.profit - web.profit_loss.fillna(0)})
    x = fr.concat([store, cat, web], ignore_index=True)
    detail = x.groupby(["channel", "id"], as_index=False, dropna=False)[
        ["sales", "returns_", "profit"]].sum()
    sub = x.groupby(["channel"], as_index=False)[
        ["sales", "returns_", "profit"]].sum()
    sub["id"] = None
    grand = fr.DataFrame({c: [x[c].sum()] for c in ["sales", "returns_", "profit"]})
    grand["channel"] = None
    grand["id"] = None
    u = fr.concat([detail, sub, grand], ignore_index=True)
    u = u.sort_values("sales", kind="stable")
    u = u.sort_values("id", na_position="last", kind="stable")
    u = u.sort_values("channel", na_position="last", kind="stable")
    return u[["channel", "id", "sales", "returns_",
              "profit"]].head(100).reset_index(drop=True)


def _q80_channel(t, tbl, rtbl, sale_keys, ret_keys, ret_amt, ret_loss,
                 date_col, loc_join, loc_id, promo_col, chan, sales_col,
                 profit_col):
    dd = _date_window(t)
    j = t[tbl].merge(t[rtbl][ret_keys + [ret_amt, ret_loss]],
                     left_on=sale_keys, right_on=ret_keys, how="left")
    j = j.merge(dd, left_on=date_col, right_on="d_date_sk")
    j = j.merge(t[loc_join[0]], left_on=loc_join[1], right_on=loc_join[2])
    it = t["item"][t["item"].i_current_price > 50]
    j = j.merge(it[["i_item_sk"]], left_on=sale_keys[0],
                right_on="i_item_sk")
    pr = t["promotion"][t["promotion"].p_channel_tv == "N"]
    j = j.merge(pr[["p_promo_sk"]], left_on=promo_col,
                right_on="p_promo_sk")
    j = j.assign(ret_=j[ret_amt].fillna(0),
                 prof_=j[profit_col] - j[ret_loss].fillna(0))
    g = j.groupby(loc_id, as_index=False).agg(
        sales=(sales_col, "sum"), returns_=("ret_", "sum"),
        profit=("prof_", "sum"))
    return fr.DataFrame({"channel": chan, "id": g[loc_id],
                         "sales": g.sales, "returns_": g.returns_,
                         "profit": g.profit})


def q80(t):
    store = _q80_channel(
        t, "store_sales", "store_returns",
        ["ss_item_sk", "ss_ticket_number"],
        ["sr_item_sk", "sr_ticket_number"], "sr_return_amt", "sr_net_loss",
        "ss_sold_date_sk", ("store", "ss_store_sk", "s_store_sk"),
        "s_store_id", "ss_promo_sk", "store channel",
        "ss_ext_sales_price", "ss_net_profit")
    cat = _q80_channel(
        t, "catalog_sales", "catalog_returns",
        ["cs_item_sk", "cs_order_number"],
        ["cr_item_sk", "cr_order_number"], "cr_return_amount",
        "cr_net_loss", "cs_sold_date_sk",
        ("call_center", "cs_call_center_sk", "cc_call_center_sk"),
        "cc_call_center_id", "cs_promo_sk", "catalog channel",
        "cs_ext_sales_price", "cs_net_profit")
    web = _q80_channel(
        t, "web_sales", "web_returns",
        ["ws_item_sk", "ws_order_number"],
        ["wr_item_sk", "wr_order_number"], "wr_return_amt", "wr_net_loss",
        "ws_sold_date_sk", ("web_site", "ws_web_site_sk", "web_site_sk"),
        "web_site_id", "ws_promo_sk", "web channel",
        "ws_ext_sales_price", "ws_net_profit")
    x = fr.concat([store, cat, web], ignore_index=True)
    detail = x.groupby(["channel", "id"], as_index=False, dropna=False)[
        ["sales", "returns_", "profit"]].sum()
    sub = x.groupby(["channel"], as_index=False)[
        ["sales", "returns_", "profit"]].sum()
    sub["id"] = None
    grand = fr.DataFrame({c: [x[c].sum()] for c in ["sales", "returns_", "profit"]})
    grand["channel"] = None
    grand["id"] = None
    u = fr.concat([detail, sub, grand], ignore_index=True)
    u = u.sort_values("sales", kind="stable")
    u = u.sort_values("id", na_position="last", kind="stable")
    u = u.sort_values("channel", na_position="last", kind="stable")
    return u[["channel", "id", "sales", "returns_",
              "profit"]].head(100).reset_index(drop=True)


def _q75_channel(t, tbl, item_col, date_col, ret_tbl, sale_ret_keys,
                 qty_col, amt_col, rqty_col, ramt_col):
    j = t[tbl].merge(t["item"], left_on=item_col, right_on="i_item_sk")
    j = j[j.i_category == "Books"]
    j = j.merge(t["date_dim"][["d_date_sk", "d_year"]], left_on=date_col,
                right_on="d_date_sk")
    j = j.merge(t[ret_tbl][list(sale_ret_keys[1]) + [rqty_col, ramt_col]],
                left_on=list(sale_ret_keys[0]),
                right_on=list(sale_ret_keys[1]), how="left")
    out = fr.DataFrame({
        "d_year": j.d_year, "i_brand_id": j.i_brand_id,
        "i_class_id": j.i_class_id, "i_category_id": j.i_category_id,
        "i_manufact_id": j.i_manufact_id,
        "sales_cnt": j[qty_col] - j[rqty_col].fillna(0),
        "sales_amt": j[amt_col] - j[ramt_col].fillna(0),
    })
    return out


def q75(t):
    cat = _q75_channel(t, "catalog_sales", "cs_item_sk", "cs_sold_date_sk",
                       "catalog_returns",
                       (("cs_order_number", "cs_item_sk"),
                        ("cr_order_number", "cr_item_sk")),
                       "cs_quantity", "cs_ext_sales_price",
                       "cr_return_quantity", "cr_return_amount")
    st = _q75_channel(t, "store_sales", "ss_item_sk", "ss_sold_date_sk",
                      "store_returns",
                      (("ss_ticket_number", "ss_item_sk"),
                       ("sr_ticket_number", "sr_item_sk")),
                      "ss_quantity", "ss_ext_sales_price",
                      "sr_return_quantity", "sr_return_amt")
    web = _q75_channel(t, "web_sales", "ws_item_sk", "ws_sold_date_sk",
                       "web_returns",
                       (("ws_order_number", "ws_item_sk"),
                        ("wr_order_number", "wr_item_sk")),
                       "ws_quantity", "ws_ext_sales_price",
                       "wr_return_quantity", "wr_return_amt")
    sd = fr.concat([cat, st, web], ignore_index=True)
    sd["sales_amt"] = sd.sales_amt.round(2)
    sd = sd.drop_duplicates()  # UNION dedups
    g = sd.groupby(["d_year", "i_brand_id", "i_class_id", "i_category_id",
                    "i_manufact_id"], as_index=False, dropna=False).agg(
        sales_cnt=("sales_cnt", "sum"), sales_amt=("sales_amt", "sum"))
    cur = g[g.d_year == 2000]
    prev = g[g.d_year == 1999]
    m = cur.merge(prev, on=["i_brand_id", "i_class_id", "i_category_id",
                            "i_manufact_id"], suffixes=("", "_p"))
    r = (m.sales_cnt.to_numpy().astype(np.float32)
         / m.sales_cnt_p.to_numpy().astype(np.float32))
    m = m[r < 0.9]
    out = fr.DataFrame({
        "prev_year": m.d_year_p, "year_": m.d_year,
        "i_brand_id": m.i_brand_id, "i_class_id": m.i_class_id,
        "i_category_id": m.i_category_id, "i_manufact_id": m.i_manufact_id,
        "prev_yr_cnt": m.sales_cnt_p, "curr_yr_cnt": m.sales_cnt,
        "sales_cnt_diff": m.sales_cnt - m.sales_cnt_p,
        "sales_amt_diff": m.sales_amt - m.sales_amt_p,
    })
    out = out.sort_values(
        ["sales_cnt_diff", "sales_amt_diff", "i_brand_id", "i_class_id",
         "i_manufact_id"], kind="stable").head(100)
    return out.reset_index(drop=True)


def _q78_channel(t, tbl, ret_tbl, keys, date_col, year_out, item_out,
                 cust_src, cust_out, qty, wc, sp, prefix):
    j = t[tbl].merge(t[ret_tbl][list(keys[1])], left_on=list(keys[0]),
                     right_on=list(keys[1]), how="left")
    j = j[j[keys[1][0]].isna()]
    j = j.merge(t["date_dim"][["d_date_sk", "d_year"]], left_on=date_col,
                right_on="d_date_sk")
    g = j.groupby(["d_year", keys[0][1], cust_src], as_index=False,
                  dropna=False).agg(**{
                      f"{prefix}_qty": (qty, "sum"),
                      f"{prefix}_wc": (wc, "sum"),
                      f"{prefix}_sp": (sp, "sum")})
    return g.rename(columns={"d_year": year_out, keys[0][1]: item_out,
                             cust_src: cust_out})


def q78(t):
    ws = _q78_channel(t, "web_sales", "web_returns",
                      (("ws_order_number", "ws_item_sk"),
                       ("wr_order_number", "wr_item_sk")),
                      "ws_sold_date_sk", "ws_sold_year", "ws_item_sk",
                      "ws_bill_customer_sk", "ws_customer_sk",
                      "ws_quantity", "ws_wholesale_cost", "ws_sales_price",
                      "ws")
    cs = _q78_channel(t, "catalog_sales", "catalog_returns",
                      (("cs_order_number", "cs_item_sk"),
                       ("cr_order_number", "cr_item_sk")),
                      "cs_sold_date_sk", "cs_sold_year", "cs_item_sk",
                      "cs_bill_customer_sk", "cs_customer_sk",
                      "cs_quantity", "cs_wholesale_cost", "cs_sales_price",
                      "cs")
    ss = _q78_channel(t, "store_sales", "store_returns",
                      (("ss_ticket_number", "ss_item_sk"),
                       ("sr_ticket_number", "sr_item_sk")),
                      "ss_sold_date_sk", "ss_sold_year", "ss_item_sk",
                      "ss_customer_sk", "ss_customer_sk2",
                      "ss_quantity", "ss_wholesale_cost", "ss_sales_price",
                      "ss")
    ss = ss.rename(columns={"ss_customer_sk2": "ss_customer_sk"})
    m = ss.merge(
        ws.dropna(subset=["ws_item_sk", "ws_customer_sk"]),
        left_on=["ss_sold_year", "ss_item_sk", "ss_customer_sk"],
        right_on=["ws_sold_year", "ws_item_sk", "ws_customer_sk"],
        how="left")
    m = m.merge(
        cs.dropna(subset=["cs_item_sk", "cs_customer_sk"]),
        left_on=["ss_sold_year", "ss_item_sk", "ss_customer_sk"],
        right_on=["cs_sold_year", "cs_item_sk", "cs_customer_sk"],
        how="left")
    m = m[(m.ws_qty.fillna(0) > 0) | (m.cs_qty.fillna(0) > 0)]
    m = m[m.ss_sold_year == 2000]
    other_qty = m.ws_qty.fillna(0) + m.cs_qty.fillna(0)
    out = fr.DataFrame({
        "ss_customer_sk": m.ss_customer_sk,
        "ratio": (m.ss_qty / other_qty).round(2),
        "store_qty": m.ss_qty,
        "store_wholesale_cost": m.ss_wc,
        "store_sales_price": m.ss_sp,
        "other_chan_qty": other_qty,
        "other_chan_wholesale_cost": m.ws_wc.fillna(0) + m.cs_wc.fillna(0),
        "other_chan_sales_price": m.ws_sp.fillna(0) + m.cs_sp.fillna(0),
    })
    out = out.sort_values(
        ["other_chan_qty", "other_chan_wholesale_cost",
         "other_chan_sales_price", "ratio"], kind="stable")
    out = out.sort_values(["store_qty", "store_wholesale_cost",
                           "store_sales_price"], ascending=False,
                          kind="stable")
    out = out.sort_values("ss_customer_sk", kind="stable")
    return out.head(100).reset_index(drop=True)


def _q49_channel(t, tbl, rtbl, skeys, rkeys, qty, rqty, paid, ramt,
                 profit, chan):
    d = t["date_dim"]
    dd = d[(d.d_year == 2001) & (d.d_moy == 12)][["d_date_sk"]]
    j = t[tbl].merge(t[rtbl][rkeys + [rqty, ramt]], left_on=skeys,
                     right_on=rkeys, how="left")
    j = j.merge(dd, left_on=f"{skeys[1].split('_')[0]}_sold_date_sk",
                right_on="d_date_sk")
    j = j[(j[ramt] > 100) & (j[profit] > 1) & (j[paid] > 0)
          & (j[qty] > 0)]
    g = j.groupby(skeys[1], as_index=False).agg(
        # sum skips NULL, as the reference's fillna(0).sum() counts it 0
        rq=(rqty, "sum"), q=(qty, "sum"), ra=(ramt, "sum"), p=(paid, "sum"))
    f32 = lambda s: s.to_numpy().astype(np.float32)  # noqa: E731
    g["return_ratio"] = f32(g.rq) / f32(g.q)
    g["currency_ratio"] = f32(g.ra) / f32(g.p)
    g["return_rank"] = g.return_ratio.rank(method="min").astype(int)
    g["currency_rank"] = g.currency_ratio.rank(method="min").astype(int)
    g = g[(g.return_rank <= 10) | (g.currency_rank <= 10)]
    return fr.DataFrame({"channel": chan, "item": g[skeys[1]],
                         "return_ratio": g.return_ratio,
                         "currency_rank": g.currency_rank,
                         "return_rank": g.return_rank})


def q49(t):
    web = _q49_channel(t, "web_sales", "web_returns",
                       ["ws_order_number", "ws_item_sk"],
                       ["wr_order_number", "wr_item_sk"],
                       "ws_quantity", "wr_return_quantity", "ws_net_paid",
                       "wr_return_amt", "ws_net_profit", "web")
    cat = _q49_channel(t, "catalog_sales", "catalog_returns",
                       ["cs_order_number", "cs_item_sk"],
                       ["cr_order_number", "cr_item_sk"],
                       "cs_quantity", "cr_return_quantity", "cs_net_paid",
                       "cr_return_amount", "cs_net_profit", "catalog")
    st = _q49_channel(t, "store_sales", "store_returns",
                      ["ss_ticket_number", "ss_item_sk"],
                      ["sr_ticket_number", "sr_item_sk"],
                      "ss_quantity", "sr_return_quantity", "ss_net_paid",
                      "sr_return_amt", "ss_net_profit", "store")
    u = fr.concat([web, cat, st], ignore_index=True)
    u["return_ratio"] = u.return_ratio.round(6)
    u = u.drop_duplicates()
    u = u.sort_values(["channel", "return_rank", "currency_rank", "item"],
                      kind="stable").head(100)
    return u[["channel", "item", "return_ratio", "return_rank",
              "currency_rank"]].reset_index(drop=True)


def q95(t):
    ws = t["web_sales"]
    n_wh = ws.groupby("ws_order_number")["ws_warehouse_sk"].nunique()
    multi_wh = set(n_wh[n_wh > 1].index)
    d = t["date_dim"]
    dd = d[(d.d_date >= D("2000-02-01"))
           & (d.d_date <= D("2000-02-01") + np.timedelta64(60, "D"))][
        ["d_date_sk"]]
    j = ws.merge(dd, left_on="ws_ship_date_sk", right_on="d_date_sk")
    ca = t["customer_address"]
    j = j.merge(ca[ca.ca_state.str.strip() == "AR"][["ca_address_sk"]],
                left_on="ws_ship_addr_sk", right_on="ca_address_sk")
    wsit = t["web_site"]
    j = j.merge(wsit[wsit.web_company_name.str.strip() == "able"][
        ["web_site_sk"]], left_on="ws_web_site_sk", right_on="web_site_sk")
    j = j[j.ws_order_number.isin(multi_wh)]
    returned = set(t["web_returns"].wr_order_number.dropna()) & multi_wh
    j = j[j.ws_order_number.isin(returned)]
    return fr.DataFrame({
        "order_count": [j.ws_order_number.nunique()],
        "total_shipping_cost": [j.ws_ext_sales_price.sum()],
        "total_net_profit": [j.ws_net_profit.sum()],
    })


def q72(t):
    d = t["date_dim"][["d_date_sk", "d_week_seq", "d_year", "d_date"]]
    j = t["catalog_sales"].merge(
        d.rename(columns={c: c + "1" for c in d.columns}),
        left_on="cs_sold_date_sk", right_on="d_date_sk1")
    j = j[j.d_year1 == 2000]
    cd = t["customer_demographics"]
    j = j.merge(cd[cd.cd_marital_status == "D"][["cd_demo_sk"]],
                left_on="cs_bill_cdemo_sk", right_on="cd_demo_sk")
    cu = t["customer"][["c_customer_sk", "c_current_hdemo_sk"]]
    j = j.merge(cu, left_on="cs_bill_customer_sk", right_on="c_customer_sk")
    hd = t["household_demographics"]
    j = j.merge(hd[hd.hd_buy_potential == ">10000"][["hd_demo_sk"]],
                left_on="c_current_hdemo_sk", right_on="hd_demo_sk")
    j = j.merge(d.rename(columns={c: c + "3" for c in d.columns}),
                left_on="cs_ship_date_sk", right_on="d_date_sk3")
    j = j[j.d_date3 > j.d_date1 + np.timedelta64(5, "D")]
    inv = t["inventory"].merge(
        d.rename(columns={c: c + "2" for c in d.columns}),
        left_on="inv_date_sk", right_on="d_date_sk2")
    j = j.merge(inv, left_on="cs_item_sk", right_on="inv_item_sk")
    j = j[(j.d_week_seq1 == j.d_week_seq2)
          & (j.inv_quantity_on_hand < j.cs_quantity)]
    j = j.merge(t["warehouse"][["w_warehouse_sk", "w_warehouse_name"]],
                left_on="inv_warehouse_sk", right_on="w_warehouse_sk")
    j = j.merge(t["item"][["i_item_sk", "i_item_desc"]],
                left_on="cs_item_sk", right_on="i_item_sk")
    promo = set(t["promotion"].p_promo_sk)
    j["has_promo"] = j.cs_promo_sk.isin(promo)
    j["no_promo"] = ~j.has_promo
    g = j.groupby(["i_item_desc", "w_warehouse_name", "d_week_seq1"],
                  as_index=False, dropna=False).agg(
        no_promo=("no_promo", "sum"),
        promo=("has_promo", "sum"),
        total_cnt=("has_promo", "size"))
    g = g.sort_values(["i_item_desc", "w_warehouse_name", "d_week_seq1"],
                      kind="stable")
    g = g.sort_values("total_cnt", ascending=False, kind="stable")
    return g.rename(columns={"d_week_seq1": "d_week_seq"})[
        ["i_item_desc", "w_warehouse_name", "d_week_seq", "no_promo",
         "promo", "total_cnt"]].head(100).reset_index(drop=True)


def q54(t):
    u = fr.concat([
        t["catalog_sales"][["cs_sold_date_sk", "cs_bill_customer_sk",
                            "cs_item_sk"]].rename(columns={
            "cs_sold_date_sk": "sold_date_sk",
            "cs_bill_customer_sk": "customer_sk",
            "cs_item_sk": "item_sk"}),
        t["web_sales"][["ws_sold_date_sk", "ws_bill_customer_sk",
                        "ws_item_sk"]].rename(columns={
            "ws_sold_date_sk": "sold_date_sk",
            "ws_bill_customer_sk": "customer_sk",
            "ws_item_sk": "item_sk"}),
    ], ignore_index=True)
    it = t["item"]
    sel = it[(it.i_category == "Women") & (it.i_class == "women-infants")]
    d = t["date_dim"]
    dd = d[d.d_year == 1999]
    j = u.merge(sel[["i_item_sk"]], left_on="item_sk", right_on="i_item_sk")
    j = j.merge(dd[["d_date_sk"]], left_on="sold_date_sk",
                right_on="d_date_sk")
    cu = t["customer"]
    mc = cu[cu.c_customer_sk.isin(j.customer_sk.dropna())][
        ["c_customer_sk", "c_current_addr_sk"]].drop_duplicates()
    base_seq = int(d[(d.d_moy == 12) & (d.d_year == 1999)].d_month_seq.iloc[0])
    win = d[(d.d_month_seq >= base_seq + 1) & (d.d_month_seq <= base_seq + 3)]
    ss = t["store_sales"].merge(win[["d_date_sk"]],
                                left_on="ss_sold_date_sk",
                                right_on="d_date_sk")
    j2 = mc.merge(t["customer_address"], left_on="c_current_addr_sk",
                  right_on="ca_address_sk")
    j2 = j2.merge(t["store"], left_on="ca_county", right_on="s_county")
    j2 = j2.merge(ss, left_on="c_customer_sk", right_on="ss_customer_sk")
    rev = j2.groupby("c_customer_sk", as_index=False).agg(
        revenue=("ss_ext_sales_price", "sum"))
    # engine cast truncates the float32 division toward zero
    seg = np.trunc(rev.revenue.to_numpy().astype(np.float32)
                   / np.float32(50)).astype(np.int64)
    segment, count = np.unique(seg, return_counts=True)
    return fr.DataFrame({"segment": segment,
                         "num_customers": count.astype(np.int64),
                         "segment_base": segment * 50}
                        ).head(100).reset_index(drop=True)


def q24(t):
    j = t["store_sales"].merge(
        t["store_returns"][["sr_ticket_number", "sr_item_sk"]],
        left_on=["ss_ticket_number", "ss_item_sk"],
        right_on=["sr_ticket_number", "sr_item_sk"])
    j = j.merge(t["customer"], left_on="ss_customer_sk",
                right_on="c_customer_sk")
    j = j.merge(t["item"], left_on="ss_item_sk", right_on="i_item_sk")
    st = t["store"]
    j = j.merge(st[st.s_market_id == 8], left_on="ss_store_sk",
                right_on="s_store_sk")
    j = j.merge(t["customer_address"], left_on="c_current_addr_sk",
                right_on="ca_address_sk")
    j = j[j.s_zip.str[:1] == j.ca_zip.str[:1]]
    keys = ["c_last_name", "c_first_name", "s_store_name", "ca_state",
            "s_state", "i_color", "i_current_price", "i_manufact_id",
            "i_units", "i_size"]
    ssales = j.groupby(keys, as_index=False, dropna=False).agg(
        netpaid=("ss_net_paid", "sum"))
    thr = 0.05 * ssales.netpaid.mean()
    red = ssales[ssales.i_color == "burlywood"]
    g = red.groupby(["c_last_name", "c_first_name", "s_store_name"],
                    as_index=False, dropna=False).agg(
        paid=("netpaid", "sum"))
    g = g[g.paid > thr]
    g = g.sort_values(["c_last_name", "c_first_name", "s_store_name"],
                      na_position="last", kind="stable").head(100)
    return g.reset_index(drop=True)


def q23(t):
    d = t["date_dim"]
    dd = d[d.d_year.isin([1999, 2000, 2001, 2002])]
    ssj = t["store_sales"].merge(dd[["d_date_sk", "d_date"]],
                                 left_on="ss_sold_date_sk",
                                 right_on="d_date_sk")
    ssj = ssj.merge(t["item"][["i_item_sk", "i_item_desc"]],
                    left_on="ss_item_sk", right_on="i_item_sk")
    ssj = ssj.assign(itemdesc=ssj.i_item_desc.str[:30])
    f = ssj.groupby(["itemdesc", "i_item_sk", "d_date"]).size()
    frequent = set(f[f > 1].reset_index().i_item_sk)
    cs2 = t["store_sales"].merge(t["customer"][["c_customer_sk"]],
                                 left_on="ss_customer_sk",
                                 right_on="c_customer_sk")
    spend = (cs2.merge(dd[["d_date_sk"]], left_on="ss_sold_date_sk",
                       right_on="d_date_sk")
             .assign(v=lambda x: (x.ss_quantity * x.ss_sales_price))
             .groupby("c_customer_sk").v.sum())
    cmax = spend.max()
    all_spend = (cs2.assign(v=lambda x: x.ss_quantity * x.ss_sales_price)
                 .groupby("c_customer_sk").v.sum())
    best = set(all_spend[all_spend > 0.5 * cmax].index)
    d2 = d[(d.d_year == 2000) & (d.d_moy == 2)][["d_date_sk"]]
    cs = t["catalog_sales"].merge(d2, left_on="cs_sold_date_sk",
                                  right_on="d_date_sk")
    cs = cs[cs.cs_item_sk.isin(frequent)
            & cs.cs_bill_customer_sk.isin(best)]
    ws = t["web_sales"].merge(d2, left_on="ws_sold_date_sk",
                              right_on="d_date_sk")
    ws = ws[ws.ws_item_sk.isin(frequent)
            & ws.ws_bill_customer_sk.isin(best)]
    total = float((cs.cs_quantity * cs.cs_list_price).sum()
                  + (ws.ws_quantity * ws.ws_list_price).sum())
    return fr.DataFrame({"total_sales": [total]})


def q14(t):
    d = t["date_dim"]
    dd3 = d[(d.d_year >= 1999) & (d.d_year <= 2001)][["d_date_sk"]]
    it = t["item"]

    def ids(tbl, icol, dcol):
        j = t[tbl].merge(dd3, left_on=dcol, right_on="d_date_sk")
        j = j.merge(it, left_on=icol, right_on="i_item_sk")
        j = j.dropna(subset=["i_brand_id", "i_class_id", "i_category_id"])
        return set(map(tuple, j[["i_brand_id", "i_class_id",
                                 "i_category_id"]].to_numpy().tolist()))

    common = (ids("store_sales", "ss_item_sk", "ss_sold_date_sk")
              & ids("catalog_sales", "cs_item_sk", "cs_sold_date_sk")
              & ids("web_sales", "ws_item_sk", "ws_sold_date_sk"))
    key = it[["i_brand_id", "i_class_id", "i_category_id"]].itertuples(
        index=False)
    cross_items = set(it[np.array([k in common for k in key], bool)].i_item_sk)

    def month_qlp(tbl, icol, dcol, qty, lp):
        j = t[tbl].merge(dd3, left_on=dcol, right_on="d_date_sk")
        return (j[qty] * j[lp])

    avg_sales = np.float32(fr.concat([
        month_qlp("store_sales", "ss_item_sk", "ss_sold_date_sk",
                  "ss_quantity", "ss_list_price"),
        month_qlp("catalog_sales", "cs_item_sk", "cs_sold_date_sk",
                  "cs_quantity", "cs_list_price"),
        month_qlp("web_sales", "ws_item_sk", "ws_sold_date_sk",
                  "ws_quantity", "ws_list_price"),
    ], ignore_index=True).mean())

    dm = d[(d.d_year == 2001) & (d.d_moy == 11)][["d_date_sk"]]

    def channel(tbl, icol, dcol, qty, lp, chan):
        j = t[tbl].merge(dm, left_on=dcol, right_on="d_date_sk")
        j = j[j[icol].isin(cross_items)]
        j = j.merge(it[["i_item_sk", "i_brand_id", "i_class_id",
                        "i_category_id"]], left_on=icol,
                    right_on="i_item_sk")
        j = j.assign(v=j[qty] * j[lp])
        g = j.groupby(["i_brand_id", "i_class_id", "i_category_id"],
                      as_index=False, dropna=False).agg(
            sales=("v", "sum"), number_sales=("v", "size"))
        g = g[g.sales.to_numpy().astype(np.float32) > avg_sales]
        g["channel"] = chan
        return g

    y = fr.concat([
        channel("store_sales", "ss_item_sk", "ss_sold_date_sk",
                "ss_quantity", "ss_list_price", "store"),
        channel("catalog_sales", "cs_item_sk", "cs_sold_date_sk",
                "cs_quantity", "cs_list_price", "catalog"),
        channel("web_sales", "ws_item_sk", "ws_sold_date_sk",
                "ws_quantity", "ws_list_price", "web"),
    ], ignore_index=True)
    cols = ["channel", "i_brand_id", "i_class_id", "i_category_id"]
    frames = []
    for k in range(len(cols), -1, -1):
        keys = cols[:k]
        if keys:
            g = y.groupby(keys, as_index=False, dropna=False).agg(
                sales=("sales", "sum"), number_sales=("number_sales", "sum"))
        else:
            g = fr.DataFrame({"sales": [y.sales.sum()],
                              "number_sales": [y.number_sales.sum()]})
        for c in cols[k:]:
            g[c] = None
        frames.append(g)
    u = fr.concat(frames, ignore_index=True)
    for c in reversed(cols):
        u = u.sort_values(c, na_position="last", kind="stable")
    u = u[cols + ["sales", "number_sales"]].head(100).reset_index(drop=True)
    for c in ("i_brand_id", "i_class_id", "i_category_id"):
        if u[c].notna().all():
            u[c] = u[c].astype(np.int64)  # match the engine's int column
    return u


def q64(t):
    cs = t["catalog_sales"].merge(
        t["catalog_returns"], left_on=["cs_item_sk", "cs_order_number"],
        right_on=["cr_item_sk", "cr_order_number"])
    cs = cs.assign(refund=cs.cr_refunded_cash + cs.cr_store_credit)
    g = cs.groupby("cs_item_sk", as_index=False).agg(
        sale=("cs_ext_list_price", "sum"), refund=("refund", "sum"))
    cs_ui = set(g[g.sale > 2 * g.refund].cs_item_sk)

    j = t["store_sales"].merge(
        t["store_returns"][["sr_item_sk", "sr_ticket_number"]],
        left_on=["ss_item_sk", "ss_ticket_number"],
        right_on=["sr_item_sk", "sr_ticket_number"])
    j = j[j.ss_item_sk.isin(cs_ui)]
    it = t["item"]
    j = j.merge(it[(it.i_current_price >= 10)
                   & (it.i_current_price <= 70)][
        ["i_item_sk", "i_product_name"]], left_on="ss_item_sk",
        right_on="i_item_sk")
    j = j.merge(t["date_dim"][["d_date_sk", "d_year"]],
                left_on="ss_sold_date_sk", right_on="d_date_sk")
    j = j.merge(t["store"][["s_store_sk", "s_store_name", "s_zip"]],
                left_on="ss_store_sk", right_on="s_store_sk")
    j = j.merge(t["customer"], left_on="ss_customer_sk",
                right_on="c_customer_sk")
    cd = t["customer_demographics"][["cd_demo_sk", "cd_marital_status"]]
    j = j.merge(cd.rename(columns={"cd_demo_sk": "cd1_sk",
                                   "cd_marital_status": "ms1"}),
                left_on="ss_cdemo_sk", right_on="cd1_sk")
    j = j.merge(cd.rename(columns={"cd_demo_sk": "cd2_sk",
                                   "cd_marital_status": "ms2"}),
                left_on="c_current_cdemo_sk", right_on="cd2_sk")
    j = j[j.ms1 != j.ms2]
    hd = t["household_demographics"][["hd_demo_sk", "hd_income_band_sk"]]
    j = j.merge(hd.rename(columns={"hd_demo_sk": "hd1_sk",
                                   "hd_income_band_sk": "ib1_sk"}),
                left_on="ss_hdemo_sk", right_on="hd1_sk")
    j = j.merge(hd.rename(columns={"hd_demo_sk": "hd2_sk",
                                   "hd_income_band_sk": "ib2_sk"}),
                left_on="c_current_hdemo_sk", right_on="hd2_sk")
    ib = t["income_band"][["ib_income_band_sk"]]
    j = j.merge(ib.rename(columns={"ib_income_band_sk": "ib1"}),
                left_on="ib1_sk", right_on="ib1")
    j = j.merge(ib.rename(columns={"ib_income_band_sk": "ib2"}),
                left_on="ib2_sk", right_on="ib2")
    j = j.merge(t["promotion"][["p_promo_sk"]], left_on="ss_promo_sk",
                right_on="p_promo_sk")
    ca = t["customer_address"][["ca_address_sk", "ca_address_id",
                                "ca_city", "ca_zip"]]
    j = j.merge(ca.rename(columns={
        "ca_address_sk": "ad1_sk", "ca_address_id": "b_street_number",
        "ca_city": "b_city", "ca_zip": "b_zip"}),
        left_on="ss_addr_sk", right_on="ad1_sk")
    j = j.merge(ca.rename(columns={
        "ca_address_sk": "ad2_sk", "ca_address_id": "c_street_number",
        "ca_city": "c_city", "ca_zip": "c_zip"}),
        left_on="c_current_addr_sk", right_on="ad2_sk")
    keys = ["i_product_name", "i_item_sk", "s_store_name", "s_zip",
            "b_street_number", "b_city", "b_zip", "c_street_number",
            "c_city", "c_zip", "d_year"]
    g = j.groupby(keys, as_index=False, dropna=False).agg(
        cnt=("ss_item_sk", "size"), s1=("ss_wholesale_cost", "sum"),
        s2=("ss_list_price", "sum"), s3=("ss_coupon_amt", "sum"))
    cs1 = g[g.d_year == 1999]
    cs2 = g[g.d_year == 2000]
    m = cs1.merge(cs2, on=["i_item_sk", "s_store_name", "s_zip"],
                  suffixes=("", "_2"))
    m = m[m.cnt_2 <= m.cnt]
    m = m.sort_values(["i_product_name", "s_store_name", "cnt_2",
                       "b_zip", "c_zip", "s1_2"], kind="stable").head(100)
    return fr.DataFrame({
        "product_name": m.i_product_name, "store_name": m.s_store_name,
        "store_zip": m.s_zip, "b_street_number": m.b_street_number,
        "b_city": m.b_city, "b_zip": m.b_zip,
        "c_street_number": m.c_street_number, "c_city": m.c_city,
        "c_zip": m.c_zip, "syear": m.d_year, "cnt": m.cnt, "s1": m.s1,
        "s2": m.s2, "s3": m.s3, "s1_2": m.s1_2, "s2_2": m.s2_2,
        "s3_2": m.s3_2, "syear2": m.d_year_2, "cnt2": m.cnt_2,
    }).reset_index(drop=True)


ORACLES = {
    name: globals()[name]
    for name in ["q1", "q2", "q3", "q4", "q5", "q6", "q7", "q8", "q9", "q10", "q11", "q12", "q13", "q14", "q15", "q16", "q17", "q18", "q19",
                 "q20", "q21", "q22", "q23", "q24", "q25", "q26", "q27", "q28", "q29", "q30", "q31", "q32", "q33",
                 "q34", "q35", "q36", "q37", "q38", "q39", "q40", "q41", "q42", "q43", "q44", "q45", "q46", "q47", "q48", "q49", "q50", "q51",
                 "q52", "q53", "q54", "q55", "q56", "q57", "q58", "q59", "q60", "q61", "q62", "q63", "q64", "q65", "q66", "q67", "q68", "q69", "q70",
                 "q71", "q72", "q73", "q74", "q75", "q76", "q77", "q78", "q79", "q80", "q81", "q82", "q83", "q84", "q85", "q86", "q87", "q88", "q89",
                 "q90", "q91", "q92", "q93", "q94", "q95", "q96", "q97", "q98", "q99"]
}
