"""TPC-DS query suite (modeled dialect) — all 99 queries.

A copy of ``presto_tpu/connectors/tpcds/queries.py``, statement for
statement (a test holds the texts equal). The port answers all 99
through ``Session.sql``.

Reference parity: the TPC-DS SQL templates shipped with
``presto-tpcds`` / run by its query tests [SURVEY §2.2, §4; reference
tree unavailable]. Coverage: the three sales channels and their
returns tables, inventory/warehouse/time/ship-mode/call-center/
web-site periphery, star joins over the demographic dimensions,
windowed aggregates over grouped results, CTEs, correlated scalar
subqueries and EXISTS/NOT EXISTS, count(distinct), three-channel
UNION ALL reports, and ROLLUP hierarchies with grouping().

Adaptations from the official templates (documented per query/batch):
- literal predicate values are tuned so every query returns rows at
  small scale factors (the official values target SF>=1);
- ``substr`` is spelled ``substring``;
- join conjuncts stay outside OR groups (the equi-join graph remains
  explicit); ORDER BY carries full tiebreakers for deterministic
  result diffs;
- date ranges use this generator's sales span (1998-2002).
"""

QUERIES = {
    # q3: brand report for one manufacturer segment in November
    "q3": """
select d_year, i_brand_id as brand_id, i_brand as brand,
       sum(ss_ext_discount_amt) as sum_agg
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manufact_id <= 50
  and d_moy = 11
group by d_year, i_brand, i_brand_id
order by d_year, sum_agg desc, brand_id
limit 100
""",
    # q7: demographic averages over promoted store sales
    "q7": """
select i_item_id,
       avg(ss_quantity) as agg1,
       avg(ss_list_price) as agg2,
       avg(ss_coupon_amt) as agg3,
       avg(ss_sales_price) as agg4
from store_sales, customer_demographics, date_dim, item, promotion
where ss_sold_date_sk = d_date_sk
  and ss_item_sk = i_item_sk
  and ss_cdemo_sk = cd_demo_sk
  and ss_promo_sk = p_promo_sk
  and cd_gender = 'M'
  and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and (p_channel_email = 'N' or p_channel_event = 'N')
  and d_year = 2000
group by i_item_id
order by i_item_id
limit 100
""",
    # q12: web revenue ratio by class (window over aggregate)
    "q12": """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(ws_ext_sales_price) as itemrevenue,
       sum(ws_ext_sales_price) * 100 / sum(sum(ws_ext_sales_price))
         over (partition by i_class) as revenueratio
from web_sales, item, date_dim
where ws_item_sk = i_item_sk
  and i_category in ('Sports', 'Books', 'Home')
  and ws_sold_date_sk = d_date_sk
  and d_date between date '1999-02-22' and date '1999-04-22'
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100
""",
    # q19: brand/manufacturer revenue where customer and store zips differ
    "q19": """
select i_brand_id as brand_id, i_brand as brand, i_manufact_id, i_manufact,
       sum(ss_ext_sales_price) as ext_price
from date_dim, store_sales, item, customer, customer_address, store
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id <= 30
  and d_moy = 11
  and d_year = 1998
  and ss_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and substring(ca_zip, 1, 5) <> substring(s_zip, 1, 5)
  and ss_store_sk = s_store_sk
group by i_brand, i_brand_id, i_manufact_id, i_manufact
order by ext_price desc, brand, brand_id, i_manufact_id, i_manufact
limit 100
""",
    # q20: catalog revenue ratio by class (window over aggregate)
    "q20": """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(cs_ext_sales_price) as itemrevenue,
       sum(cs_ext_sales_price) * 100 / sum(sum(cs_ext_sales_price))
         over (partition by i_class) as revenueratio
from catalog_sales, item, date_dim
where cs_item_sk = i_item_sk
  and i_category in ('Jewelry', 'Music', 'Women')
  and cs_sold_date_sk = d_date_sk
  and d_date between date '2001-01-12' and date '2001-03-12'
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100
""",
    # q26: catalog demographic averages (q7's catalog twin)
    "q26": """
select i_item_id,
       avg(cs_quantity) as agg1,
       avg(cs_list_price) as agg2,
       avg(cs_coupon_amt) as agg3,
       avg(cs_sales_price) as agg4
from catalog_sales, customer_demographics, date_dim, item, promotion
where cs_sold_date_sk = d_date_sk
  and cs_item_sk = i_item_sk
  and cs_bill_cdemo_sk = cd_demo_sk
  and cs_promo_sk = p_promo_sk
  and cd_gender = 'F'
  and cd_marital_status = 'W'
  and cd_education_status = 'Primary'
  and (p_channel_email = 'N' or p_channel_event = 'N')
  and d_year = 2000
group by i_item_id
order by i_item_id
limit 100
""",
    # q42: category revenue for one month
    "q42": """
select d_year, i_category_id, i_category,
       sum(ss_ext_sales_price) as total_sales
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id <= 20
  and d_moy = 11
  and d_year = 1998
group by d_year, i_category_id, i_category
order by total_sales desc, d_year, i_category_id, i_category
limit 100
""",
    # q52: brand revenue for one month
    "q52": """
select d_year, i_brand_id as brand_id, i_brand as brand,
       sum(ss_ext_sales_price) as ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id <= 20
  and d_moy = 12
  and d_year = 1999
group by d_year, i_brand, i_brand_id
order by d_year, ext_price desc, brand_id
limit 100
""",
    # q53: manufacturer quarterly sales vs their average (window screen)
    "q53": """
select * from (
  select i_manufact_id,
         sum(ss_sales_price) as sum_sales,
         avg(sum(ss_sales_price))
           over (partition by i_manufact_id) as avg_quarterly_sales
  from item, store_sales, date_dim, store
  where ss_item_sk = i_item_sk
    and ss_sold_date_sk = d_date_sk
    and ss_store_sk = s_store_sk
    and d_month_seq in (1188, 1189, 1190, 1191, 1192, 1193,
                        1194, 1195, 1196, 1197, 1198, 1199)
    and i_category in ('Books', 'Children', 'Electronics',
                       'Home', 'Jewelry', 'Men')
  group by i_manufact_id, d_qoy
) tmp1
where case when avg_quarterly_sales > 0
           then abs(sum_sales - avg_quarterly_sales) / avg_quarterly_sales
           else 0.0 end > 0.05
order by avg_quarterly_sales, sum_sales, i_manufact_id
limit 100
""",
    # q55: brand revenue, minimal report shape
    "q55": """
select i_brand_id as brand_id, i_brand as brand,
       sum(ss_ext_sales_price) as ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id <= 28
  and d_moy = 11
  and d_year = 1999
group by i_brand, i_brand_id
order by ext_price desc, brand_id
limit 100
""",
    # q89: monthly class sales vs store average (window screen)
    "q89": """
select * from (
  select i_category, i_class, i_brand,
         s_store_name, s_company_name, d_moy,
         sum(ss_sales_price) as sum_sales,
         avg(sum(ss_sales_price))
           over (partition by i_category, i_brand,
                              s_store_name, s_company_name)
           as avg_monthly_sales
  from item, store_sales, date_dim, store
  where ss_item_sk = i_item_sk
    and ss_sold_date_sk = d_date_sk
    and ss_store_sk = s_store_sk
    and d_year = 1999
    and i_category in ('Books', 'Electronics', 'Sports',
                       'Men', 'Music', 'Women')
  group by i_category, i_class, i_brand,
           s_store_name, s_company_name, d_moy
) tmp1
where case when avg_monthly_sales <> 0
           then abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
           else 0.0 end > 0.1
order by sum_sales - avg_monthly_sales, s_store_name,
         i_category, i_class, i_brand, d_moy
limit 100
""",
    # q98: store revenue ratio by class (window over aggregate)
    "q98": """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(ss_ext_sales_price) as itemrevenue,
       sum(ss_ext_sales_price) * 100 / sum(sum(ss_ext_sales_price))
         over (partition by i_class) as revenueratio
from store_sales, item, date_dim
where ss_item_sk = i_item_sk
  and i_category in ('Children', 'Shoes', 'Electronics')
  and ss_sold_date_sk = d_date_sk
  and d_date between date '2000-01-29' and date '2000-03-29'
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
""",
}

# -- round-3 breadth: star joins over the returns/inventory/time/ship
# periphery (same documented adaptations: literals tuned for small SF;
# join conjuncts kept outside OR groups so the equi-join graph stays
# explicit; ORDER BY carries full tiebreakers for deterministic diffs)

QUERIES.update({
    # q13: demographic band averages with OR'd attribute screens
    "q13": """
select avg(ss_quantity) a1, avg(ss_ext_sales_price) a2,
       avg(ss_ext_wholesale_cost) a3, sum(ss_ext_wholesale_cost) a4
from store_sales, store, customer_demographics, household_demographics,
     customer_address, date_dim
where ss_store_sk = s_store_sk and ss_sold_date_sk = d_date_sk
  and d_year = 2001
  and ss_cdemo_sk = cd_demo_sk and ss_hdemo_sk = hd_demo_sk
  and ss_addr_sk = ca_address_sk
  and ((cd_marital_status = 'M' and cd_education_status = 'Advanced Degree'
        and ss_sales_price between 50.00 and 150.00)
    or (cd_marital_status = 'S' and cd_education_status = 'College'
        and ss_sales_price between 20.00 and 100.00)
    or (cd_marital_status = 'W' and cd_education_status = '2 yr Degree'
        and ss_sales_price between 50.00 and 200.00))
  and ((ca_state in ('TX', 'OH', 'KY') and ss_net_profit between -5000 and 20000)
    or (ca_state in ('WA', 'NE', 'GA') and ss_net_profit between -5000 and 30000)
    or (ca_state in ('MT', 'MS', 'IN') and ss_net_profit between -5000 and 25000))
""",
    # q21: warehouse inventory before/after a pivot date
    "q21": """
select w_warehouse_name, i_item_id,
       sum(case when d_date < date '2000-03-11' then inv_quantity_on_hand
                else 0 end) as inv_before,
       sum(case when d_date >= date '2000-03-11' then inv_quantity_on_hand
                else 0 end) as inv_after
from inventory, warehouse, item, date_dim
where i_item_sk = inv_item_sk and inv_warehouse_sk = w_warehouse_sk
  and inv_date_sk = d_date_sk
  and d_date between (date '2000-03-11' - interval '30' day)
                 and (date '2000-03-11' + interval '30' day)
group by w_warehouse_name, i_item_id
having sum(case when d_date < date '2000-03-11' then inv_quantity_on_hand
                else 0 end) > 0
order by w_warehouse_name, i_item_id
limit 100
""",
    # q25: store sale -> store return -> catalog repurchase profit trail
    "q25": """
select i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_net_profit) as store_sales_profit,
       sum(sr_net_loss) as store_returns_loss,
       sum(cs_net_profit) as catalog_sales_profit
from store_sales, store_returns, catalog_sales, date_dim d1, date_dim d2,
     date_dim d3, store, item
where d1.d_year = 2000 and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk and d2.d_year = 2000
  and sr_customer_sk = cs_bill_customer_sk and sr_item_sk = cs_item_sk
  and cs_sold_date_sk = d3.d_date_sk and d3.d_year = 2000
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name
limit 100
""",
    # q29: same trail, quantity flows
    "q29": """
select i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_quantity) as store_sales_quantity,
       sum(sr_return_quantity) as store_returns_quantity,
       sum(cs_quantity) as catalog_sales_quantity
from store_sales, store_returns, catalog_sales, date_dim d1, date_dim d2,
     date_dim d3, store, item
where d1.d_year = 1999 and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk and d2.d_year in (1999, 2000)
  and sr_customer_sk = cs_bill_customer_sk and sr_item_sk = cs_item_sk
  and cs_sold_date_sk = d3.d_date_sk and d3.d_year in (1999, 2000, 2001)
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name
limit 100
""",
    # q37: items with mid-range price and healthy inventory sold by catalog
    "q37": """
select i_item_id, i_item_desc, i_current_price
from item, inventory, date_dim, catalog_sales
where i_current_price between 10.00 and 60.00
  and inv_item_sk = i_item_sk and d_date_sk = inv_date_sk
  and d_date between date '2000-01-01' and date '2000-03-01'
  and i_manufact_id <= 300
  and inv_quantity_on_hand between 100 and 700
  and cs_item_sk = i_item_sk
group by i_item_id, i_item_desc, i_current_price
order by i_item_id
limit 100
""",
    # q43: store sales pivoted by day-of-week
    "q43": """
select s_store_name, s_store_id,
       sum(case when d_day_name = 'Sunday' then ss_sales_price else null end) sun_sales,
       sum(case when d_day_name = 'Monday' then ss_sales_price else null end) mon_sales,
       sum(case when d_day_name = 'Tuesday' then ss_sales_price else null end) tue_sales,
       sum(case when d_day_name = 'Wednesday' then ss_sales_price else null end) wed_sales,
       sum(case when d_day_name = 'Thursday' then ss_sales_price else null end) thu_sales,
       sum(case when d_day_name = 'Friday' then ss_sales_price else null end) fri_sales,
       sum(case when d_day_name = 'Saturday' then ss_sales_price else null end) sat_sales
from date_dim, store_sales, store
where d_date_sk = ss_sold_date_sk and s_store_sk = ss_store_sk
  and d_year = 2000 and s_gmt_offset <= -5
group by s_store_name, s_store_id
order by s_store_name, s_store_id
limit 100
""",
    # q62: web ship-lag buckets by warehouse/ship-mode/site
    "q62": """
select w_warehouse_name, sm_type, web_name,
       sum(case when ws_ship_date_sk - ws_sold_date_sk <= 30 then 1 else 0 end)
         as d30,
       sum(case when ws_ship_date_sk - ws_sold_date_sk > 30
                 and ws_ship_date_sk - ws_sold_date_sk <= 60 then 1 else 0 end)
         as d60,
       sum(case when ws_ship_date_sk - ws_sold_date_sk > 60
                 and ws_ship_date_sk - ws_sold_date_sk <= 90 then 1 else 0 end)
         as d90,
       sum(case when ws_ship_date_sk - ws_sold_date_sk > 90 then 1 else 0 end)
         as d120
from web_sales, warehouse, ship_mode, web_site, date_dim
where d_month_seq between 1200 and 1211
  and ws_ship_date_sk = d_date_sk
  and ws_warehouse_sk = w_warehouse_sk
  and ws_ship_mode_sk = sm_ship_mode_sk
  and ws_web_site_sk = web_site_sk
group by w_warehouse_name, sm_type, web_name
order by w_warehouse_name, sm_type, web_name
limit 100
""",
    # q79: per-ticket coupon/profit for busy-household shoppers
    "q79": """
select c_last_name, c_first_name, s_city, ss_ticket_number, amt, profit
from (select ss_ticket_number, ss_customer_sk, s_city,
             sum(ss_coupon_amt) amt, sum(ss_net_profit) profit
      from store_sales, date_dim, store, household_demographics
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk
        and (hd_dep_count = 6 or hd_vehicle_count > 2)
        and d_dow = 1 and d_year = 2000
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk, s_store_sk,
               s_city) ms,
     customer
where ss_customer_sk = c_customer_sk
order by c_last_name, c_first_name, s_city, profit, ss_ticket_number
limit 100
""",
    # q91: call-center losses from demographic-screened returners
    "q91": """
select cc_call_center_id, cc_name, cc_manager, sum(cr_net_loss) as returns_loss
from call_center, catalog_returns, date_dim, customer,
     customer_demographics, household_demographics
where cr_call_center_sk = cc_call_center_sk and cr_returned_date_sk = d_date_sk
  and cr_returning_customer_sk = c_customer_sk
  and cd_demo_sk = c_current_cdemo_sk and hd_demo_sk = c_current_hdemo_sk
  and d_year = 2000
  and ((cd_marital_status = 'M' and cd_education_status = 'Unknown')
    or (cd_marital_status = 'W' and cd_education_status = 'Advanced Degree'))
  and hd_buy_potential like '0-500%'
group by cc_call_center_id, cc_name, cc_manager
order by returns_loss desc, cc_call_center_id
limit 100
""",
    # q93: actual sales after in-store returns for one return reason
    "q93": """
select ss_customer_sk, sum(act_sales) sumsales
from (select ss_customer_sk,
             case when sr_return_quantity is not null
                  then (ss_quantity - sr_return_quantity) * ss_sales_price
                  else ss_quantity * ss_sales_price end act_sales
      from store_sales, store_returns, reason
      where sr_item_sk = ss_item_sk and sr_ticket_number = ss_ticket_number
        and sr_reason_sk = r_reason_sk
        and r_reason_desc = 'Stopped working') t
group by ss_customer_sk
order by sumsales, ss_customer_sk
limit 100
""",
    # q96: evening-rush store traffic for large households
    "q96": """
select count(*) cnt
from store_sales, household_demographics, time_dim, store
where ss_sold_time_sk = t_time_sk and ss_hdemo_sk = hd_demo_sk
  and ss_store_sk = s_store_sk
  and t_hour = 20 and t_minute >= 30
  and hd_dep_count = 7 and s_store_name = 'ese'
""",
    # q99: catalog ship-lag buckets by warehouse/ship-mode/call-center
    "q99": """
select w_warehouse_name, sm_type, cc_name,
       sum(case when cs_ship_date_sk - cs_sold_date_sk <= 30 then 1 else 0 end)
         as d30,
       sum(case when cs_ship_date_sk - cs_sold_date_sk > 30
                 and cs_ship_date_sk - cs_sold_date_sk <= 60 then 1 else 0 end)
         as d60,
       sum(case when cs_ship_date_sk - cs_sold_date_sk > 60
                 and cs_ship_date_sk - cs_sold_date_sk <= 90 then 1 else 0 end)
         as d90,
       sum(case when cs_ship_date_sk - cs_sold_date_sk > 90 then 1 else 0 end)
         as d120
from catalog_sales, warehouse, ship_mode, call_center, date_dim
where d_month_seq between 1200 and 1211
  and cs_ship_date_sk = d_date_sk
  and cs_warehouse_sk = w_warehouse_sk
  and cs_ship_mode_sk = sm_ship_mode_sk
  and cs_call_center_sk = cc_call_center_sk
group by w_warehouse_name, sm_type, cc_name
order by w_warehouse_name, sm_type, cc_name
limit 100
""",
})

# -- round-3 breadth batch 2: correlated scalar subqueries, derived
# tables, time-of-day counts. Extra documented adaptations:
# - wide BYTES group keys ride their table's primary key (added to
#   GROUP BY) or are narrowed via substring();
# - count(distinct) appears alone (engine restriction);
# - q90 drops the household join (web_sales has no ship hdemo column
#   in this schema); q16/q94's EXISTS correlates on warehouse equality
#   + order inequality (order numbers are unique here, one line per
#   order, so the official same-order-two-warehouses test is void).

QUERIES.update({
    # q15: catalog zip revenue for qualified zips/prices
    "q15": """
select substring(ca_zip, 1, 5) as zip, sum(cs_sales_price) as tot
from catalog_sales, customer, customer_address, date_dim
where cs_bill_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and (ca_state in ('CA', 'WA', 'GA') or cs_sales_price > 70)
  and cs_sold_date_sk = d_date_sk and d_qoy = 2 and d_year = 2000
group by substring(ca_zip, 1, 5)
order by zip
limit 100
""",
    # q17: quantity statistics across the sale -> return -> repurchase trail
    "q17": """
select i_item_id, i_item_desc, s_state,
       count(ss_quantity) as store_sales_quantitycount,
       avg(ss_quantity) as store_sales_quantityave,
       stddev_samp(ss_quantity) as store_sales_quantitystdev,
       stddev_samp(ss_quantity) / avg(ss_quantity) as store_sales_quantitycov,
       count(sr_return_quantity) as store_returns_quantitycount,
       avg(sr_return_quantity) as store_returns_quantityave,
       stddev_samp(sr_return_quantity) as store_returns_quantitystdev,
       stddev_samp(sr_return_quantity) / avg(sr_return_quantity)
         as store_returns_quantitycov,
       count(cs_quantity) as catalog_sales_quantitycount,
       avg(cs_quantity) as catalog_sales_quantityave,
       stddev_samp(cs_quantity) as catalog_sales_quantitystdev,
       stddev_samp(cs_quantity) / avg(cs_quantity) as catalog_sales_quantitycov
from store_sales, store_returns, catalog_sales, date_dim d1, date_dim d2,
     date_dim d3, store, item
where d1.d_year = 2000 and d1.d_qoy = 1 and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk and d2.d_year = 2000
  and sr_customer_sk = cs_bill_customer_sk and sr_item_sk = cs_item_sk
  and cs_sold_date_sk = d3.d_date_sk and d3.d_year = 2000
group by i_item_id, i_item_desc, s_state
order by i_item_id, i_item_desc, s_state
limit 100
""",
    # q32: catalog discounts 30% above the item's period average
    "q32": """
select sum(cs_ext_discount_amt) as excess_discount_amount
from catalog_sales, item, date_dim
where i_manufact_id <= 100
  and i_item_sk = cs_item_sk
  and d_date between date '2000-01-01' and date '2000-12-31'
  and d_date_sk = cs_sold_date_sk
  and cs_ext_discount_amt > (
    select 1.3 * avg(cs_ext_discount_amt)
    from catalog_sales cs2, date_dim d2
    where cs2.cs_item_sk = i_item_sk
      and d2.d_date between date '2000-01-01' and date '2000-12-31'
      and d2.d_date_sk = cs2.cs_sold_date_sk)
""",
    # q34: bulk-shopping households by ticket
    "q34": """
select c_last_name, c_first_name, c_salutation, c_preferred_cust_flag,
       ss_ticket_number, cnt
from (select ss_ticket_number, ss_customer_sk, count(*) cnt
      from store_sales, date_dim, store, household_demographics
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk
        and (d_dom between 1 and 3 or d_dom between 25 and 28)
        and (hd_buy_potential = '>10000' or hd_buy_potential = '0-500')
        and hd_vehicle_count > 0
        and (case when hd_vehicle_count > 0
                  then hd_dep_count / hd_vehicle_count
                  else null end) > 1.2
        and d_year in (1999, 2000, 2001)
      group by ss_ticket_number, ss_customer_sk) dn, customer
where ss_customer_sk = c_customer_sk and cnt between 1 and 5
order by c_last_name, c_first_name, c_salutation,
         c_preferred_cust_flag desc, ss_ticket_number
limit 100
""",
    # q45: web revenue by zip prefix for qualified zips/prices
    "q45": """
select substring(ca_zip, 1, 5) as zip, sum(ws_sales_price) as tot
from web_sales, customer, customer_address, date_dim
where ws_bill_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and ws_sold_date_sk = d_date_sk and d_qoy = 2 and d_year = 2000
  and (ca_state in ('CA', 'WA', 'GA') or ws_sales_price > 50)
group by substring(ca_zip, 1, 5)
order by zip
limit 100
""",
    # q46: weekend shoppers who bought in a different city than they live
    "q46": """
select c_last_name, c_first_name, current_addr.ca_city, bought_city,
       ss_ticket_number, amt, profit
from (select ss_ticket_number, ss_customer_sk, ca_city as bought_city,
             sum(ss_coupon_amt) as amt, sum(ss_net_profit) as profit
      from store_sales, date_dim, store, household_demographics,
           customer_address
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk and ss_addr_sk = ca_address_sk
        and (hd_dep_count = 5 or hd_vehicle_count = 3)
        and d_dow in (0, 6) and d_year in (1999, 2000, 2001)
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk,
               ca_address_sk, ca_city) dn,
     customer, customer_address current_addr
where ss_customer_sk = c_customer_sk
  and c_current_addr_sk = current_addr.ca_address_sk
  and current_addr.ca_city <> bought_city
order by c_last_name, c_first_name, current_addr.ca_city, bought_city,
         ss_ticket_number
limit 100
""",
    # q48: total quantity under OR'd demographic/geographic screens
    "q48": """
select sum(ss_quantity) as total_quantity
from store_sales, store, customer_demographics, customer_address, date_dim
where s_store_sk = ss_store_sk and ss_sold_date_sk = d_date_sk
  and d_year = 2001 and ss_cdemo_sk = cd_demo_sk
  and ss_addr_sk = ca_address_sk
  and ((cd_marital_status = 'M' and cd_education_status = '4 yr Degree'
        and ss_sales_price between 50.00 and 150.00)
    or (cd_marital_status = 'D' and cd_education_status = '2 yr Degree'
        and ss_sales_price between 10.00 and 100.00)
    or (cd_marital_status = 'S' and cd_education_status = 'College'
        and ss_sales_price between 50.00 and 200.00))
  and ((ca_country = 'United States' and ca_state in ('CO', 'OH', 'TX')
        and ss_net_profit between 0 and 22000)
    or (ca_country = 'United States' and ca_state in ('OR', 'MN', 'KY')
        and ss_net_profit between 0 and 30000)
    or (ca_country = 'United States' and ca_state in ('VA', 'CA', 'MS')
        and ss_net_profit between 0 and 25000))
""",
    # q65: items selling at or below their store's average revenue
    "q65": """
select s_store_name, i_item_desc, sc.revenue, i_current_price,
       i_wholesale_cost, i_brand
from store, item,
     (select ss_store_sk, avg(revenue) as ave
      from (select ss_store_sk, ss_item_sk, sum(ss_sales_price) as revenue
            from store_sales, date_dim
            where ss_sold_date_sk = d_date_sk
              and d_month_seq between 1200 and 1211
            group by ss_store_sk, ss_item_sk) sa
      group by ss_store_sk) sb,
     (select ss_store_sk, ss_item_sk, sum(ss_sales_price) as revenue
      from store_sales, date_dim
      where ss_sold_date_sk = d_date_sk
        and d_month_seq between 1200 and 1211
      group by ss_store_sk, ss_item_sk) sc
where sb.ss_store_sk = sc.ss_store_sk and sc.revenue <= 1.0 * sb.ave
  and s_store_sk = sc.ss_store_sk and i_item_sk = sc.ss_item_sk
order by s_store_name, i_item_desc, sc.revenue
limit 100
""",
    # q68: like q46 with extended amounts
    "q68": """
select c_last_name, c_first_name, current_addr.ca_city, bought_city,
       ss_ticket_number, extended_price, extended_tax, list_price
from (select ss_ticket_number, ss_customer_sk, ca_city as bought_city,
             sum(ss_ext_sales_price) as extended_price,
             sum(ss_ext_list_price) as list_price,
             sum(ss_ext_tax) as extended_tax
      from store_sales, date_dim, store, household_demographics,
           customer_address
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk and ss_addr_sk = ca_address_sk
        and d_dom between 1 and 2 and d_year in (1999, 2000, 2001)
        and (hd_dep_count = 5 or hd_vehicle_count = 3)
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk,
               ca_address_sk, ca_city) dn,
     customer, customer_address current_addr
where ss_customer_sk = c_customer_sk
  and c_current_addr_sk = current_addr.ca_address_sk
  and current_addr.ca_city <> bought_city
order by c_last_name, current_addr.ca_city, bought_city, ss_ticket_number
limit 100
""",
    # q73: like q34 with a tighter household screen
    "q73": """
select c_last_name, c_first_name, c_salutation, c_preferred_cust_flag,
       ss_ticket_number, cnt
from (select ss_ticket_number, ss_customer_sk, count(*) cnt
      from store_sales, date_dim, store, household_demographics
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk
        and d_dom between 1 and 2
        and (hd_buy_potential = '>10000' or hd_buy_potential = 'Unknown')
        and hd_vehicle_count > 0
        and (case when hd_vehicle_count > 0
                  then hd_dep_count / hd_vehicle_count
                  else null end) > 1
        and d_year in (1999, 2000, 2001)
      group by ss_ticket_number, ss_customer_sk) dj, customer
where ss_customer_sk = c_customer_sk and cnt between 1 and 5
order by cnt desc, c_last_name, c_first_name, ss_ticket_number
limit 100
""",
    # q85: web return reasons by refunding demographics
    "q85": """
select r_reason_desc,
       avg(ws_quantity) as q, avg(wr_refunded_cash) as rc, avg(wr_fee) as f
from web_sales, web_returns, web_page, customer_demographics cd1,
     customer_demographics cd2, customer_address, date_dim, reason
where ws_web_page_sk = wp_web_page_sk
  and ws_item_sk = wr_item_sk and ws_order_number = wr_order_number
  and ws_sold_date_sk = d_date_sk and d_year = 2000
  and cd1.cd_demo_sk = wr_refunded_cdemo_sk
  and cd2.cd_demo_sk = wr_returning_cdemo_sk
  and ca_address_sk = wr_refunded_addr_sk
  and r_reason_sk = wr_reason_sk
  and ((cd1.cd_marital_status = 'M' and ws_sales_price between 50.00 and 150.00)
    or (cd1.cd_marital_status = 'S' and ws_sales_price between 10.00 and 100.00)
    or (cd1.cd_marital_status = 'W' and ws_sales_price between 50.00 and 200.00))
  and ((ca_state in ('IN', 'OH', 'NJ') and ws_net_profit between -10000 and 10000)
    or (ca_state in ('WI', 'CT', 'KY') and ws_net_profit between -10000 and 20000)
    or (ca_state in ('LA', 'IA', 'AR') and ws_net_profit between -10000 and 30000))
group by r_reason_desc
order by r_reason_desc
limit 100
""",
    # q88: store traffic in eight half-hour windows (cross-joined counts)
    "q88": """
select * from
 (select count(*) h8_30_to_9
  from store_sales, household_demographics, time_dim, store
  where ss_sold_time_sk = t_time_sk and ss_hdemo_sk = hd_demo_sk
    and ss_store_sk = s_store_sk and t_hour = 8 and t_minute >= 30
    and ((hd_dep_count = 4 and hd_vehicle_count <= 6)
      or (hd_dep_count = 2 and hd_vehicle_count <= 4)
      or (hd_dep_count = 0 and hd_vehicle_count <= 2))
    and s_store_name = 'ese') s1,
 (select count(*) h9_to_9_30
  from store_sales, household_demographics, time_dim, store
  where ss_sold_time_sk = t_time_sk and ss_hdemo_sk = hd_demo_sk
    and ss_store_sk = s_store_sk and t_hour = 9 and t_minute < 30
    and ((hd_dep_count = 4 and hd_vehicle_count <= 6)
      or (hd_dep_count = 2 and hd_vehicle_count <= 4)
      or (hd_dep_count = 0 and hd_vehicle_count <= 2))
    and s_store_name = 'ese') s2,
 (select count(*) h9_30_to_10
  from store_sales, household_demographics, time_dim, store
  where ss_sold_time_sk = t_time_sk and ss_hdemo_sk = hd_demo_sk
    and ss_store_sk = s_store_sk and t_hour = 9 and t_minute >= 30
    and ((hd_dep_count = 4 and hd_vehicle_count <= 6)
      or (hd_dep_count = 2 and hd_vehicle_count <= 4)
      or (hd_dep_count = 0 and hd_vehicle_count <= 2))
    and s_store_name = 'ese') s3,
 (select count(*) h10_to_10_30
  from store_sales, household_demographics, time_dim, store
  where ss_sold_time_sk = t_time_sk and ss_hdemo_sk = hd_demo_sk
    and ss_store_sk = s_store_sk and t_hour = 10 and t_minute < 30
    and ((hd_dep_count = 4 and hd_vehicle_count <= 6)
      or (hd_dep_count = 2 and hd_vehicle_count <= 4)
      or (hd_dep_count = 0 and hd_vehicle_count <= 2))
    and s_store_name = 'ese') s4
""",
    # q90: morning/evening web traffic ratio
    "q90": """
select cast(amc as double) / cast(pmc as double) as am_pm_ratio
from (select count(*) amc
      from web_sales, time_dim, web_page
      where ws_sold_time_sk = t_time_sk and ws_web_page_sk = wp_web_page_sk
        and t_hour between 8 and 9
        and wp_char_count between 2000 and 6000) at_,
     (select count(*) pmc
      from web_sales, time_dim, web_page
      where ws_sold_time_sk = t_time_sk and ws_web_page_sk = wp_web_page_sk
        and t_hour between 19 and 20
        and wp_char_count between 2000 and 6000) pt
""",
    # q92: web discounts 30% above the item's period average
    "q92": """
select sum(ws_ext_discount_amt) as excess_discount_amount
from web_sales, item, date_dim
where i_manufact_id <= 150
  and i_item_sk = ws_item_sk
  and d_date between date '2000-01-01' and date '2000-12-31'
  and d_date_sk = ws_sold_date_sk
  and ws_ext_discount_amt > (
    select 1.3 * avg(ws_ext_discount_amt)
    from web_sales ws2, date_dim d2
    where ws2.ws_item_sk = i_item_sk
      and d2.d_date between date '2000-01-01' and date '2000-12-31'
      and d2.d_date_sk = ws2.ws_sold_date_sk)
""",
})

# -- round-3 breadth batch 3: correlated EXISTS / count-distinct (q1,
# q16, q94), three-channel UNION ALL reports (q33/q56/q60/q71/q76),
# ROLLUP hierarchies (q22/q36/q86). Round 5: q16/q94/q95 use the
# official order-equality/warehouse-inequality EXISTS correlation
# (the generator now emits multi-line orders), q76 the official
# string-literal channel keys and per-channel NULL columns, q22 the
# official rollup including i_product_name.

QUERIES.update({
    # q1: customers returning more than 1.2x their store's average
    "q1": """
with customer_total_return as
 (select sr_customer_sk as ctr_customer_sk, sr_store_sk as ctr_store_sk,
         sum(sr_return_amt) as ctr_total_return
  from store_returns, date_dim
  where sr_returned_date_sk = d_date_sk and d_year = 2000
  group by sr_customer_sk, sr_store_sk)
select c_customer_id
from customer_total_return ctr1, store, customer
where ctr1.ctr_total_return > (select avg(ctr_total_return) * 1.2
                               from customer_total_return ctr2
                               where ctr1.ctr_store_sk = ctr2.ctr_store_sk)
  and s_store_sk = ctr1.ctr_store_sk
  and ctr1.ctr_customer_sk = c_customer_sk
order by c_customer_id
limit 100
""",
    # q16: multi-order warehouses' unreturned catalog orders
    "q16": """
select count(distinct cs_order_number) as order_count
from catalog_sales cs1, date_dim, customer_address, call_center
where d_date between date '2000-03-01' and date '2000-06-30'
  and cs1.cs_ship_date_sk = d_date_sk
  and cs1.cs_ship_addr_sk = ca_address_sk
  and cs1.cs_call_center_sk = cc_call_center_sk
  and exists (select * from catalog_sales cs2
              where cs1.cs_order_number = cs2.cs_order_number
                and cs1.cs_warehouse_sk <> cs2.cs_warehouse_sk)
  and not exists (select * from catalog_returns cr1
                  where cs1.cs_order_number = cr1.cr_order_number)
""",
    # q94: q16's web twin
    "q94": """
select count(distinct ws_order_number) as order_count
from web_sales ws1, date_dim, customer_address, web_site
where d_date between date '2000-03-01' and date '2000-06-30'
  and ws1.ws_ship_date_sk = d_date_sk
  and ws1.ws_ship_addr_sk = ca_address_sk
  and ws1.ws_web_site_sk = web_site_sk
  and web_company_name = 'able'
  and exists (select * from web_sales ws2
              where ws1.ws_order_number = ws2.ws_order_number
                and ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk)
  and not exists (select * from web_returns wr1
                  where ws1.ws_order_number = wr1.wr_order_number)
""",
    # q33: one category's manufacturers across all three channels
    "q33": """
with ss as (
  select i_manufact_id, sum(ss_ext_sales_price) total_sales
  from store_sales, date_dim, item
  where i_manufact_id in (select i_manufact_id from item
                          where i_category in ('Books'))
    and ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
    and d_year = 2000
  group by i_manufact_id),
 cs as (
  select i_manufact_id, sum(cs_ext_sales_price) total_sales
  from catalog_sales, date_dim, item
  where i_manufact_id in (select i_manufact_id from item
                          where i_category in ('Books'))
    and cs_item_sk = i_item_sk and cs_sold_date_sk = d_date_sk
    and d_year = 2000
  group by i_manufact_id),
 ws as (
  select i_manufact_id, sum(ws_ext_sales_price) total_sales
  from web_sales, date_dim, item
  where i_manufact_id in (select i_manufact_id from item
                          where i_category in ('Books'))
    and ws_item_sk = i_item_sk and ws_sold_date_sk = d_date_sk
    and d_year = 2000
  group by i_manufact_id)
select i_manufact_id, sum(total_sales) total_sales
from (select * from ss union all select * from cs
      union all select * from ws) tmp1
group by i_manufact_id
order by total_sales, i_manufact_id
limit 100
""",
    # q56: colored items across all three channels
    "q56": """
with ss as (
  select i_item_id, sum(ss_ext_sales_price) total_sales
  from store_sales, date_dim, item
  where i_item_sk in (select i_item_sk from item
                      where i_color in ('blue', 'orchid', 'pink'))
    and ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
    and d_year = 2000
  group by i_item_id),
 cs as (
  select i_item_id, sum(cs_ext_sales_price) total_sales
  from catalog_sales, date_dim, item
  where i_item_sk in (select i_item_sk from item
                      where i_color in ('blue', 'orchid', 'pink'))
    and cs_item_sk = i_item_sk and cs_sold_date_sk = d_date_sk
    and d_year = 2000
  group by i_item_id),
 ws as (
  select i_item_id, sum(ws_ext_sales_price) total_sales
  from web_sales, date_dim, item
  where i_item_sk in (select i_item_sk from item
                      where i_color in ('blue', 'orchid', 'pink'))
    and ws_item_sk = i_item_sk and ws_sold_date_sk = d_date_sk
    and d_year = 2000
  group by i_item_id)
select i_item_id, sum(total_sales) total_sales
from (select * from ss union all select * from cs
      union all select * from ws) tmp1
group by i_item_id
order by total_sales, i_item_id
limit 100
""",
    # q60: one category's items across all three channels
    "q60": """
with ss as (
  select i_item_id, sum(ss_ext_sales_price) total_sales
  from store_sales, date_dim, item
  where i_item_sk in (select i_item_sk from item
                      where i_category in ('Music'))
    and ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
    and d_year = 1999
  group by i_item_id),
 cs as (
  select i_item_id, sum(cs_ext_sales_price) total_sales
  from catalog_sales, date_dim, item
  where i_item_sk in (select i_item_sk from item
                      where i_category in ('Music'))
    and cs_item_sk = i_item_sk and cs_sold_date_sk = d_date_sk
    and d_year = 1999
  group by i_item_id),
 ws as (
  select i_item_id, sum(ws_ext_sales_price) total_sales
  from web_sales, date_dim, item
  where i_item_sk in (select i_item_sk from item
                      where i_category in ('Music'))
    and ws_item_sk = i_item_sk and ws_sold_date_sk = d_date_sk
    and d_year = 1999
  group by i_item_id)
select i_item_id, sum(total_sales) total_sales
from (select * from ss union all select * from cs
      union all select * from ws) tmp1
group by i_item_id
order by total_sales, i_item_id
limit 100
""",
    # q71: brand revenue at meal times across all three channels
    "q71": """
select i_brand_id brand_id, i_brand brand, t_hour, t_minute,
       sum(ext_price) ext_price
from item,
     (select ws_ext_sales_price as ext_price, ws_item_sk as sold_item_sk,
             ws_sold_time_sk as time_sk
      from web_sales, date_dim
      where d_date_sk = ws_sold_date_sk and d_moy = 11 and d_year = 2000
      union all
      select cs_ext_sales_price, cs_item_sk, cs_sold_time_sk
      from catalog_sales, date_dim
      where d_date_sk = cs_sold_date_sk and d_moy = 11 and d_year = 2000
      union all
      select ss_ext_sales_price, ss_item_sk, ss_sold_time_sk
      from store_sales, date_dim
      where d_date_sk = ss_sold_date_sk and d_moy = 11 and d_year = 2000
     ) tmp_sales, time_dim
where sold_item_sk = i_item_sk and i_manager_id <= 20
  and time_sk = t_time_sk
  and (t_meal_time = 'breakfast' or t_meal_time = 'dinner')
group by i_brand_id, i_brand, t_hour, t_minute
order by ext_price desc, brand_id, t_hour, t_minute
limit 100
""",
    # q76: sales rows with NULL keys per channel (official shape:
    # string-literal channel/col_name group keys, per-channel null cols)
    "q76": """
select channel, col_name, d_year, d_qoy, i_category,
       count(*) sales_cnt, sum(ext_sales_price) sales_amt
from (
  select 'store' as channel, 'ss_store_sk' col_name, d_year, d_qoy,
         i_category, ss_ext_sales_price as ext_sales_price
  from store_sales, item, date_dim
  where ss_store_sk is null and ss_sold_date_sk = d_date_sk
    and ss_item_sk = i_item_sk
  union all
  select 'web' as channel, 'ws_ship_customer_sk' col_name, d_year, d_qoy,
         i_category, ws_ext_sales_price as ext_sales_price
  from web_sales, item, date_dim
  where ws_ship_customer_sk is null and ws_sold_date_sk = d_date_sk
    and ws_item_sk = i_item_sk
  union all
  select 'catalog' as channel, 'cs_ship_addr_sk' col_name, d_year, d_qoy,
         i_category, cs_ext_sales_price as ext_sales_price
  from catalog_sales, item, date_dim
  where cs_ship_addr_sk is null and cs_sold_date_sk = d_date_sk
    and cs_item_sk = i_item_sk) foo
group by channel, col_name, d_year, d_qoy, i_category
order by channel, col_name, d_year, d_qoy, i_category
limit 100
""",
    # q22: inventory quantity-on-hand over the brand hierarchy
    "q22": """
select i_product_name, i_brand, i_class, i_category,
       avg(inv_quantity_on_hand) qoh
from inventory, date_dim, item
where inv_date_sk = d_date_sk and inv_item_sk = i_item_sk
  and d_month_seq between 1200 and 1211
group by rollup(i_product_name, i_brand, i_class, i_category)
order by qoh, i_product_name nulls last, i_brand nulls last,
         i_class nulls last, i_category nulls last
limit 100
""",
    # q36: gross margin ranked within the category/class hierarchy
    "q36": """
select sum(ss_net_profit) / sum(ss_ext_sales_price) as gross_margin,
       i_category, i_class,
       grouping(i_category) + grouping(i_class) as lochierarchy,
       rank() over (partition by grouping(i_category) + grouping(i_class),
                    case when grouping(i_class) = 0 then i_category end
                    order by sum(ss_net_profit) / sum(ss_ext_sales_price) asc)
         as rank_within_parent
from store_sales, date_dim, store, item
where d_year = 2000 and d_date_sk = ss_sold_date_sk
  and ss_store_sk = s_store_sk and i_item_sk = ss_item_sk
group by rollup(i_category, i_class)
order by lochierarchy desc,
         case when lochierarchy = 0 then i_category end nulls first,
         rank_within_parent, i_class nulls last
limit 100
""",
    # q86: q36's web twin
    "q86": """
select sum(ws_net_paid) as total_sum, i_category, i_class,
       grouping(i_category) + grouping(i_class) as lochierarchy,
       rank() over (partition by grouping(i_category) + grouping(i_class),
                    case when grouping(i_class) = 0 then i_category end
                    order by sum(ws_net_paid) desc) as rank_within_parent
from web_sales, date_dim, item
where d_month_seq between 1200 and 1211
  and d_date_sk = ws_sold_date_sk and i_item_sk = ws_item_sk
group by rollup(i_category, i_class)
order by lochierarchy desc,
         case when lochierarchy = 0 then i_category end nulls first,
         rank_within_parent, i_class nulls last
limit 100
""",
})

QUERIES.update({
    # q38: customers who bought through ALL three channels in a year
    "q38": """
select count(*) cnt from (
  select distinct c_last_name, c_first_name, d_date
  from store_sales, date_dim, customer
  where ss_sold_date_sk = d_date_sk and ss_customer_sk = c_customer_sk
    and d_month_seq between 1200 and 1211
  intersect
  select distinct c_last_name, c_first_name, d_date
  from catalog_sales, date_dim, customer
  where cs_sold_date_sk = d_date_sk and cs_bill_customer_sk = c_customer_sk
    and d_month_seq between 1200 and 1211
  intersect
  select distinct c_last_name, c_first_name, d_date
  from web_sales, date_dim, customer
  where ws_sold_date_sk = d_date_sk and ws_bill_customer_sk = c_customer_sk
    and d_month_seq between 1200 and 1211
) hot_cust
""",
    # q87: store-only customers (except the other two channels)
    "q87": """
select count(*) cnt from (
  select distinct c_last_name, c_first_name, d_date
  from store_sales, date_dim, customer
  where ss_sold_date_sk = d_date_sk and ss_customer_sk = c_customer_sk
    and d_month_seq between 1200 and 1211
  except
  select distinct c_last_name, c_first_name, d_date
  from catalog_sales, date_dim, customer
  where cs_sold_date_sk = d_date_sk and cs_bill_customer_sk = c_customer_sk
    and d_month_seq between 1200 and 1211
  except
  select distinct c_last_name, c_first_name, d_date
  from web_sales, date_dim, customer
  where ws_sold_date_sk = d_date_sk and ws_bill_customer_sk = c_customer_sk
    and d_month_seq between 1200 and 1211
) cool_cust
""",
})

# -- round-3 breadth batch 4. Adaptations: q28 keeps only the
# count(distinct) per band block (the engine allows one DISTINCT
# aggregate per grouped query); q30/q81 correlate on the refunded
# address state (this schema's returns carry the refunded address);
# q50 drops the unconstrained d1 alias and anchors the group on the
# store PK.

QUERIES.update({
    # q28: distinct list prices in six quantity/price bands (cross join)
    "q28": """
select * from
 (select count(distinct ss_list_price) b1_cntd from store_sales
  where ss_quantity between 0 and 5
    and (ss_list_price between 8 and 108 or ss_coupon_amt between 0 and 1000
         or ss_wholesale_cost between 7 and 57)) b1,
 (select count(distinct ss_list_price) b2_cntd from store_sales
  where ss_quantity between 6 and 10
    and (ss_list_price between 9 and 109 or ss_coupon_amt between 0 and 2000
         or ss_wholesale_cost between 31 and 81)) b2,
 (select count(distinct ss_list_price) b3_cntd from store_sales
  where ss_quantity between 11 and 15
    and (ss_list_price between 14 and 114 or ss_coupon_amt between 0 and 3000
         or ss_wholesale_cost between 17 and 67)) b3,
 (select count(distinct ss_list_price) b4_cntd from store_sales
  where ss_quantity between 16 and 20
    and (ss_list_price between 6 and 106 or ss_coupon_amt between 0 and 4000
         or ss_wholesale_cost between 30 and 80)) b4,
 (select count(distinct ss_list_price) b5_cntd from store_sales
  where ss_quantity between 21 and 25
    and (ss_list_price between 10 and 110 or ss_coupon_amt between 0 and 5000
         or ss_wholesale_cost between 37 and 87)) b5,
 (select count(distinct ss_list_price) b6_cntd from store_sales
  where ss_quantity between 26 and 30
    and (ss_list_price between 17 and 117 or ss_coupon_amt between 0 and 6000
         or ss_wholesale_cost between 33 and 83)) b6
""",
    # q30: web returners above 1.2x their state's average
    "q30": """
with customer_total_return as
 (select wr_returning_customer_sk as ctr_customer_sk, ca_state as ctr_state,
         sum(wr_return_amt) as ctr_total_return
  from web_returns, date_dim, customer_address
  where wr_returned_date_sk = d_date_sk and d_year = 2000
    and wr_refunded_addr_sk = ca_address_sk
  group by wr_returning_customer_sk, ca_state)
select c_customer_id, c_salutation, c_first_name, c_last_name,
       ctr_total_return
from customer_total_return ctr1, customer
where ctr1.ctr_total_return > (select avg(ctr_total_return) * 1.2
                               from customer_total_return ctr2
                               where ctr1.ctr_state = ctr2.ctr_state)
  and ctr1.ctr_customer_sk = c_customer_sk
order by c_customer_id, ctr_total_return
limit 100
""",
    # q50: store return-lag buckets
    "q50": """
select s_store_name, s_store_id, s_state,
       sum(case when sr_returned_date_sk - ss_sold_date_sk <= 30
                then 1 else 0 end) as d30,
       sum(case when sr_returned_date_sk - ss_sold_date_sk > 30
                 and sr_returned_date_sk - ss_sold_date_sk <= 60
                then 1 else 0 end) as d60,
       sum(case when sr_returned_date_sk - ss_sold_date_sk > 60
                 and sr_returned_date_sk - ss_sold_date_sk <= 90
                then 1 else 0 end) as d90,
       sum(case when sr_returned_date_sk - ss_sold_date_sk > 90
                then 1 else 0 end) as d120
from store_sales, store_returns, store, date_dim d2
where d2.d_year = 2000 and d2.d_moy = 8
  and ss_ticket_number = sr_ticket_number and ss_item_sk = sr_item_sk
  and ss_customer_sk = sr_customer_sk
  and sr_returned_date_sk = d2.d_date_sk
  and ss_store_sk = s_store_sk
group by s_store_sk, s_store_name, s_store_id, s_state
order by s_store_name, s_store_id, s_state
limit 100
""",
    # q61: promoted share of one category's store revenue
    "q61": """
select promotions, total,
       cast(promotions as double) / cast(total as double) * 100 as share
from (select sum(ss_ext_sales_price) promotions
      from store_sales, store, promotion, date_dim, customer,
           customer_address, item
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_promo_sk = p_promo_sk and ss_customer_sk = c_customer_sk
        and ca_address_sk = c_current_addr_sk and ss_item_sk = i_item_sk
        and ca_gmt_offset <= -5 and i_category = 'Jewelry'
        and (p_channel_dmail = 'Y' or p_channel_email = 'Y'
             or p_channel_tv = 'Y')
        and d_year = 2000) promotional_sales,
     (select sum(ss_ext_sales_price) total
      from store_sales, store, date_dim, customer, customer_address, item
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_customer_sk = c_customer_sk
        and ca_address_sk = c_current_addr_sk and ss_item_sk = i_item_sk
        and ca_gmt_offset <= -5 and i_category = 'Jewelry'
        and d_year = 2000) all_sales
""",
    # q69: demographics of store-only shoppers in selected states
    "q69": """
select cd_gender, cd_marital_status, cd_education_status, count(*) cnt1,
       cd_purchase_estimate, count(*) cnt2
from customer c, customer_address ca, customer_demographics
where c.c_current_addr_sk = ca.ca_address_sk
  and ca_state in ('KY', 'GA', 'NM', 'CA', 'TX', 'OH')
  and cd_demo_sk = c.c_current_cdemo_sk
  and exists (select * from store_sales, date_dim
              where c.c_customer_sk = ss_customer_sk
                and ss_sold_date_sk = d_date_sk and d_year = 2001)
  and not exists (select * from web_sales, date_dim
                  where c.c_customer_sk = ws_bill_customer_sk
                    and ws_sold_date_sk = d_date_sk and d_year = 2001)
  and not exists (select * from catalog_sales, date_dim
                  where c.c_customer_sk = cs_bill_customer_sk
                    and cs_sold_date_sk = d_date_sk and d_year = 2001)
group by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate
order by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate
limit 100
""",
    # q81: q30's catalog twin (returning address state)
    "q81": """
with customer_total_return as
 (select cr_returning_customer_sk as ctr_customer_sk, ca_state as ctr_state,
         sum(cr_return_amount) as ctr_total_return
  from catalog_returns, date_dim, customer_address
  where cr_returned_date_sk = d_date_sk and d_year = 2000
    and cr_returning_addr_sk = ca_address_sk
  group by cr_returning_customer_sk, ca_state)
select c_customer_id, c_salutation, c_first_name, c_last_name,
       ctr_total_return
from customer_total_return ctr1, customer
where ctr1.ctr_total_return > (select avg(ctr_total_return) * 1.2
                               from customer_total_return ctr2
                               where ctr1.ctr_state = ctr2.ctr_state)
  and ctr1.ctr_customer_sk = c_customer_sk
order by c_customer_id, ctr_total_return
limit 100
""",
})

# -- round-3 breadth batch 5. Adaptations: q59 joins its two half-year
# derived tables on the store surrogate key (wide-BYTES join keys are
# not join-packable); q6's HAVING threshold is 1 at toy SF.

QUERIES.update({
    # q6: states whose customers buy premium-priced items
    "q6": """
select a.ca_state as state, count(*) cnt
from customer_address a, customer c, store_sales s, date_dim d, item i
where a.ca_address_sk = c.c_current_addr_sk
  and c.c_customer_sk = s.ss_customer_sk
  and s.ss_sold_date_sk = d.d_date_sk
  and s.ss_item_sk = i.i_item_sk
  and d.d_month_seq = (select distinct d_month_seq from date_dim
                       where d_year = 2001 and d_moy = 1)
  and i.i_current_price > (select 1.2 * avg(j.i_current_price)
                           from item j
                           where j.i_category = i.i_category)
group by a.ca_state
having count(*) >= 1
order by cnt, a.ca_state
limit 100
""",
    # q9: five quantity-band spend profiles via CASE'd scalar subqueries
    "q9": """
select case when (select count(*) from store_sales
                  where ss_quantity between 1 and 20) > 1000
            then (select avg(ss_ext_discount_amt) from store_sales
                  where ss_quantity between 1 and 20)
            else (select avg(ss_net_paid) from store_sales
                  where ss_quantity between 1 and 20) end bucket1,
       case when (select count(*) from store_sales
                  where ss_quantity between 21 and 40) > 1000
            then (select avg(ss_ext_discount_amt) from store_sales
                  where ss_quantity between 21 and 40)
            else (select avg(ss_net_paid) from store_sales
                  where ss_quantity between 21 and 40) end bucket2,
       case when (select count(*) from store_sales
                  where ss_quantity between 41 and 60) > 1000
            then (select avg(ss_ext_discount_amt) from store_sales
                  where ss_quantity between 41 and 60)
            else (select avg(ss_net_paid) from store_sales
                  where ss_quantity between 41 and 60) end bucket3,
       case when (select count(*) from store_sales
                  where ss_quantity between 61 and 80) > 1000
            then (select avg(ss_ext_discount_amt) from store_sales
                  where ss_quantity between 61 and 80)
            else (select avg(ss_net_paid) from store_sales
                  where ss_quantity between 61 and 80) end bucket4,
       case when (select count(*) from store_sales
                  where ss_quantity between 81 and 100) > 1000
            then (select avg(ss_ext_discount_amt) from store_sales
                  where ss_quantity between 81 and 100)
            else (select avg(ss_net_paid) from store_sales
                  where ss_quantity between 81 and 100) end bucket5
from reason
where r_reason_sk = 1
""",
    # q59: week-over-week store revenue ratios, one year apart
    "q59": """
with wss as
 (select d_week_seq, ss_store_sk,
         sum(case when d_day_name = 'Sunday' then ss_sales_price end) sun_sales,
         sum(case when d_day_name = 'Monday' then ss_sales_price end) mon_sales,
         sum(case when d_day_name = 'Friday' then ss_sales_price end) fri_sales,
         sum(case when d_day_name = 'Saturday' then ss_sales_price end) sat_sales
  from store_sales, date_dim
  where d_date_sk = ss_sold_date_sk
  group by d_week_seq, ss_store_sk)
select y.s_store_name1, y.d_week_seq1,
       y.sun_sales1 / x.sun_sales2 as sun_r,
       y.mon_sales1 / x.mon_sales2 as mon_r,
       y.fri_sales1 / x.fri_sales2 as fri_r,
       y.sat_sales1 / x.sat_sales2 as sat_r
from (select s_store_name s_store_name1, wss.d_week_seq d_week_seq1,
             ss_store_sk store_sk1, sun_sales sun_sales1,
             mon_sales mon_sales1, fri_sales fri_sales1,
             sat_sales sat_sales1
      from wss, store, date_dim d
      where d.d_week_seq = wss.d_week_seq and ss_store_sk = s_store_sk
        and d_month_seq between 1200 and 1211) y,
     (select s_store_name s_store_name2, wss.d_week_seq d_week_seq2,
             ss_store_sk store_sk2, sun_sales sun_sales2,
             mon_sales mon_sales2, fri_sales fri_sales2,
             sat_sales sat_sales2
      from wss, store, date_dim d
      where d.d_week_seq = wss.d_week_seq and ss_store_sk = s_store_sk
        and d_month_seq between 1212 and 1223) x
where y.store_sk1 = x.store_sk2
  and y.d_week_seq1 = x.d_week_seq2 - 52
order by y.s_store_name1, y.d_week_seq1
limit 100
""",
    # q63: q53's manager-group twin
    "q63": """
select * from (
  select i_manager_id,
         sum(ss_sales_price) as sum_sales,
         avg(sum(ss_sales_price))
           over (partition by i_manager_id) as avg_monthly_sales
  from item, store_sales, date_dim, store
  where ss_item_sk = i_item_sk
    and ss_sold_date_sk = d_date_sk
    and ss_store_sk = s_store_sk
    and d_month_seq in (1200, 1201, 1202, 1203, 1204, 1205,
                        1206, 1207, 1208, 1209, 1210, 1211)
    and ((i_category in ('Books', 'Children', 'Electronics')
          and i_class in ('books-accent', 'children-accent',
                          'electronics-accent'))
      or (i_category in ('Women', 'Music', 'Men')
          and i_class in ('women-pants', 'music-pants', 'men-pants')))
  group by i_manager_id, d_moy
) tmp1
where case when avg_monthly_sales > 0
           then abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
           else 0.0 end > 0.1
order by i_manager_id, avg_monthly_sales, sum_sales
limit 100
""",
    # q82: q37's store twin
    "q82": """
select i_item_id, i_item_desc, i_current_price
from item, inventory, date_dim, store_sales
where i_current_price between 20.00 and 70.00
  and inv_item_sk = i_item_sk and d_date_sk = inv_date_sk
  and d_date between date '2000-05-25' and date '2000-07-24'
  and i_manufact_id <= 400
  and inv_quantity_on_hand between 100 and 500
  and ss_item_sk = i_item_sk
group by i_item_id, i_item_desc, i_current_price
order by i_item_id
limit 100
""",
})

# -- round-3 breadth batch 6. Adaptations: q31 uses ws_ship_addr_sk
# (this schema's web address key); q39's cov threshold fits the
# generator's uniform quantities; q44 drops the null-address baseline
# arm (this generator's ss_addr_sk is never NULL) and keeps the
# 0.9 x store-average screen.

QUERIES.update({
    # q2: web+catalog weekly sales, year-over-year ratios by weekday
    "q2": """
with wscs as
 (select sold_date_sk, sales_price
  from (select ws_sold_date_sk sold_date_sk, ws_ext_sales_price sales_price
        from web_sales
        union all
        select cs_sold_date_sk, cs_ext_sales_price
        from catalog_sales) x),
 wswscs as
 (select d_week_seq,
         sum(case when d_day_name = 'Sunday' then sales_price end) sun_sales,
         sum(case when d_day_name = 'Monday' then sales_price end) mon_sales,
         sum(case when d_day_name = 'Friday' then sales_price end) fri_sales,
         sum(case when d_day_name = 'Saturday' then sales_price end) sat_sales
  from wscs, date_dim
  where d_date_sk = sold_date_sk
  group by d_week_seq)
select y.d_week_seq1,
       round(y.sun_sales1 / z.sun_sales2, 2) r_sun,
       round(y.mon_sales1 / z.mon_sales2, 2) r_mon,
       round(y.fri_sales1 / z.fri_sales2, 2) r_fri,
       round(y.sat_sales1 / z.sat_sales2, 2) r_sat
from (select wswscs.d_week_seq d_week_seq1, sun_sales sun_sales1,
             mon_sales mon_sales1, fri_sales fri_sales1,
             sat_sales sat_sales1
      from wswscs, date_dim
      where date_dim.d_week_seq = wswscs.d_week_seq and d_year = 2000) y,
     (select wswscs.d_week_seq d_week_seq2, sun_sales sun_sales2,
             mon_sales mon_sales2, fri_sales fri_sales2,
             sat_sales sat_sales2
      from wswscs, date_dim
      where date_dim.d_week_seq = wswscs.d_week_seq and d_year = 2001) z
where y.d_week_seq1 = z.d_week_seq2 - 53
order by y.d_week_seq1
limit 100
""",
    # q31: county quarter-over-quarter growth, web vs store
    "q31": """
with ss as
 (select ca_county, d_qoy, d_year, sum(ss_ext_sales_price) as store_sales
  from store_sales, date_dim, customer_address
  where ss_sold_date_sk = d_date_sk and ss_addr_sk = ca_address_sk
  group by ca_county, d_qoy, d_year),
 ws as
 (select ca_county, d_qoy, d_year, sum(ws_ext_sales_price) as web_sales
  from web_sales, date_dim, customer_address
  where ws_sold_date_sk = d_date_sk and ws_ship_addr_sk = ca_address_sk
  group by ca_county, d_qoy, d_year)
select ss1.ca_county, ss1.d_year,
       ws2.web_sales / ws1.web_sales web_q1_q2_increase,
       ss2.store_sales / ss1.store_sales store_q1_q2_increase
from ss ss1, ss ss2, ws ws1, ws ws2
where ss1.d_qoy = 1 and ss1.d_year = 2000
  and ss2.d_qoy = 2 and ss2.d_year = 2000
  and ws1.d_qoy = 1 and ws1.d_year = 2000
  and ws2.d_qoy = 2 and ws2.d_year = 2000
  and ss1.ca_county = ss2.ca_county
  and ss1.ca_county = ws1.ca_county
  and ss1.ca_county = ws2.ca_county
  and case when ws1.web_sales > 0 then ws2.web_sales / ws1.web_sales
           else null end
    > case when ss1.store_sales > 0 then ss2.store_sales / ss1.store_sales
           else null end
order by ss1.ca_county
limit 100
""",
    # q39: warehouse items with volatile inventory, month over month
    "q39": """
with inv as
 (select w_warehouse_sk, i_item_sk, d_moy, stdev, mean,
         case mean when 0 then null else stdev / mean end cov
  from (select w_warehouse_sk, i_item_sk, d_moy,
               stddev_samp(inv_quantity_on_hand) stdev,
               avg(inv_quantity_on_hand) mean
        from inventory, item, warehouse, date_dim
        where inv_item_sk = i_item_sk
          and inv_warehouse_sk = w_warehouse_sk
          and inv_date_sk = d_date_sk and d_year = 2000
        group by w_warehouse_sk, i_item_sk, d_moy) foo
  where case mean when 0 then 0.0 else stdev / mean end > 0.5)
select inv1.w_warehouse_sk wsk1, inv1.i_item_sk isk1, inv1.d_moy moy1,
       inv1.mean mean1, inv1.cov cov1,
       inv2.d_moy moy2, inv2.mean mean2, inv2.cov cov2
from inv inv1, inv inv2
where inv1.i_item_sk = inv2.i_item_sk
  and inv1.w_warehouse_sk = inv2.w_warehouse_sk
  and inv1.d_moy = 1 and inv2.d_moy = 2
order by wsk1, isk1, moy1, mean1, cov1
limit 100
""",
    # q44: best and worst items of one store, paired by rank
    "q44": """
select asceding.rnk, i1.i_product_name best_performing,
       i2.i_product_name worst_performing
from (select * from (select item_sk,
             rank() over (order by rank_col asc) rnk
      from (select ss_item_sk item_sk, avg(ss_net_profit) rank_col
            from store_sales where ss_store_sk = 4
            group by ss_item_sk
            having avg(ss_net_profit) > 0.9 * (
              select avg(ss_net_profit) rank_col from store_sales
              where ss_store_sk = 4 group by ss_store_sk)) v1) v11
      where rnk < 11) asceding,
     (select * from (select item_sk,
             rank() over (order by rank_col desc) rnk
      from (select ss_item_sk item_sk, avg(ss_net_profit) rank_col
            from store_sales where ss_store_sk = 4
            group by ss_item_sk
            having avg(ss_net_profit) > 0.9 * (
              select avg(ss_net_profit) rank_col from store_sales
              where ss_store_sk = 4 group by ss_store_sk)) v2) v21
      where rnk < 11) descending,
     item i1, item i2
where asceding.rnk = descending.rnk
  and i1.i_item_sk = asceding.item_sk
  and i2.i_item_sk = descending.item_sk
order by asceding.rnk
limit 100
""",
})

# -- q47/q57: year-over-year monthly screens, written with lag/lead
# over the grouped window (the standard rewrite of the official rn
# self-joins - identical semantics, one window pass).

QUERIES.update({
    # q47: store monthly outliers vs the year's average, with neighbors
    "q47": """
select * from (
  select i_category, i_brand, s_store_name, d_year, d_moy,
         sum(ss_sales_price) sum_sales,
         avg(sum(ss_sales_price)) over (partition by i_category, i_brand,
                                        s_store_name, d_year)
           avg_monthly_sales,
         lag(sum(ss_sales_price)) over (partition by i_category, i_brand,
                                        s_store_name
                                        order by d_year, d_moy) psum,
         lead(sum(ss_sales_price)) over (partition by i_category, i_brand,
                                         s_store_name
                                         order by d_year, d_moy) nsum
  from item, store_sales, date_dim, store
  where ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
    and ss_store_sk = s_store_sk
    and (d_year = 2000 or (d_year = 1999 and d_moy = 12)
         or (d_year = 2001 and d_moy = 1))
  group by i_category, i_brand, s_store_name, d_year, d_moy) v1
where d_year = 2000 and avg_monthly_sales > 0
  and abs(sum_sales - avg_monthly_sales) / avg_monthly_sales > 0.1
order by sum_sales - avg_monthly_sales, i_category, i_brand,
         s_store_name, d_moy
limit 100
""",
    # q57: q47's catalog twin over call centers
    "q57": """
select * from (
  select i_category, i_brand, cc_name, d_year, d_moy,
         sum(cs_sales_price) sum_sales,
         avg(sum(cs_sales_price)) over (partition by i_category, i_brand,
                                        cc_name, d_year) avg_monthly_sales,
         lag(sum(cs_sales_price)) over (partition by i_category, i_brand,
                                        cc_name
                                        order by d_year, d_moy) psum,
         lead(sum(cs_sales_price)) over (partition by i_category, i_brand,
                                         cc_name
                                         order by d_year, d_moy) nsum
  from item, catalog_sales, date_dim, call_center
  where cs_item_sk = i_item_sk and cs_sold_date_sk = d_date_sk
    and cs_call_center_sk = cc_call_center_sk
    and (d_year = 2000 or (d_year = 1999 and d_moy = 12)
         or (d_year = 2001 and d_moy = 1))
  group by i_category, i_brand, cc_name, d_year, d_moy) v1
where d_year = 2000 and avg_monthly_sales > 0
  and abs(sum_sales - avg_monthly_sales) / avg_monthly_sales > 0.1
order by sum_sales - avg_monthly_sales, i_category, i_brand, cc_name, d_moy
limit 100
""",
})

# -- q40/q18: multi-key outer join with returns netting; geographic
# rollup of demographic averages (q18 drops the household cd2 join).

QUERIES.update({
    # q40: warehouse sales net of returns, before/after a pivot date
    "q40": """
select w_state, i_item_id,
       sum(case when d_date < date '2000-03-11'
                then cs_sales_price - coalesce(cr_refunded_cash, 0)
                else 0 end) as sales_before,
       sum(case when d_date >= date '2000-03-11'
                then cs_sales_price - coalesce(cr_refunded_cash, 0)
                else 0 end) as sales_after
from catalog_sales left outer join catalog_returns
       on (cs_order_number = cr_order_number and cs_item_sk = cr_item_sk),
     warehouse, item, date_dim
where i_current_price between 10.00 and 60.00
  and i_item_sk = cs_item_sk
  and cs_warehouse_sk = w_warehouse_sk
  and cs_sold_date_sk = d_date_sk
  and d_date between (date '2000-03-11' - interval '30' day)
                 and (date '2000-03-11' + interval '30' day)
group by w_state, i_item_id
order by w_state, i_item_id
limit 100
""",
    # q18: catalog demographic averages over the geography hierarchy
    "q18": """
select i_item_id, ca_country, ca_state, ca_county,
       avg(cast(cs_quantity as double)) agg1,
       avg(cast(cs_list_price as double)) agg2,
       avg(cast(cs_coupon_amt as double)) agg3,
       avg(cast(cs_sales_price as double)) agg4,
       avg(cast(cs_net_profit as double)) agg5,
       avg(cast(c_birth_year as double)) agg6,
       avg(cast(cd_dep_count as double)) agg7
from catalog_sales, customer_demographics, customer, customer_address,
     date_dim, item
where cs_sold_date_sk = d_date_sk and cs_item_sk = i_item_sk
  and cs_bill_cdemo_sk = cd_demo_sk and cs_bill_customer_sk = c_customer_sk
  and cd_gender = 'F' and cd_education_status = 'Unknown'
  and c_current_addr_sk = ca_address_sk
  and d_year = 2001 and c_birth_month in (1, 2, 6, 8, 9, 12)
group by rollup(i_item_id, ca_country, ca_state, ca_county)
order by ca_country nulls last, ca_state nulls last, ca_county nulls last,
         i_item_id nulls last
limit 100
""",
})

# -- q5: per-channel sales vs returns report over a sales+returns
# union, rolled up. Adaptations: integer channel tags (no string
# concat); catalog ids are call centers (no catalog_page table here);
# web returns reach their site through the web_sales join.

QUERIES.update({
    "q5": """
with ssr as (
  select s_store_sk as id, sum(sales_price) as sales,
         sum(return_amt) as returns_, sum(profit) as profit,
         sum(net_loss) as profit_loss
  from (select ss_store_sk as unit_sk, ss_sold_date_sk as date_sk,
               ss_ext_sales_price as sales_price, ss_net_profit as profit,
               cast(0 as decimal(12,2)) as return_amt,
               cast(0 as decimal(12,2)) as net_loss
        from store_sales
        union all
        select sr_store_sk, sr_returned_date_sk,
               cast(0 as decimal(12,2)), cast(0 as decimal(12,2)),
               sr_return_amt, sr_net_loss
        from store_returns) salesreturns, date_dim, store
  where date_sk = d_date_sk
    and d_date between date '2000-08-03'
                   and (date '2000-08-03' + interval '14' day)
    and unit_sk = s_store_sk
  group by s_store_sk),
 csr as (
  select cc_call_center_sk as id, sum(sales_price) as sales,
         sum(return_amt) as returns_, sum(profit) as profit,
         sum(net_loss) as profit_loss
  from (select cs_call_center_sk as unit_sk, cs_sold_date_sk as date_sk,
               cs_ext_sales_price as sales_price, cs_net_profit as profit,
               cast(0 as decimal(12,2)) as return_amt,
               cast(0 as decimal(12,2)) as net_loss
        from catalog_sales
        union all
        select cr_call_center_sk, cr_returned_date_sk,
               cast(0 as decimal(12,2)), cast(0 as decimal(12,2)),
               cr_return_amount, cr_net_loss
        from catalog_returns) salesreturns, date_dim, call_center
  where date_sk = d_date_sk
    and d_date between date '2000-08-03'
                   and (date '2000-08-03' + interval '14' day)
    and unit_sk = cc_call_center_sk
  group by cc_call_center_sk),
 wsr as (
  select web_site_sk as id, sum(sales_price) as sales,
         sum(return_amt) as returns_, sum(profit) as profit,
         sum(net_loss) as profit_loss
  from (select ws_web_site_sk as unit_sk, ws_sold_date_sk as date_sk,
               ws_ext_sales_price as sales_price, ws_net_profit as profit,
               cast(0 as decimal(12,2)) as return_amt,
               cast(0 as decimal(12,2)) as net_loss
        from web_sales
        union all
        select ws_web_site_sk, wr_returned_date_sk,
               cast(0 as decimal(12,2)), cast(0 as decimal(12,2)),
               wr_return_amt, wr_net_loss
        from web_returns, web_sales
        where wr_item_sk = ws_item_sk
          and wr_order_number = ws_order_number) salesreturns,
       date_dim, web_site
  where date_sk = d_date_sk
    and d_date between date '2000-08-03'
                   and (date '2000-08-03' + interval '14' day)
    and unit_sk = web_site_sk
  group by web_site_sk)
select channel, id, sum(sales) sales, sum(returns_) returns_,
       sum(profit) profit
from (select 1 as channel, id, sales, returns_,
             profit - profit_loss as profit from ssr
      union all
      select 2 as channel, id, sales, returns_,
             profit - profit_loss as profit from csr
      union all
      select 3 as channel, id, sales, returns_,
             profit - profit_loss as profit from wsr) x
group by rollup(channel, id)
order by channel nulls last, id nulls last
limit 100
""",
})

QUERIES.update({
    # q97: store/catalog customer-item overlap via FULL OUTER JOIN of
    # the two grouped channel CTEs (official literals d_month_seq
    # 1200-1211 = year 2000, inside this generator's span)
    "q97": """
with ssci as (
  select ss_customer_sk as customer_sk, ss_item_sk as item_sk
  from store_sales, date_dim
  where ss_sold_date_sk = d_date_sk
    and d_month_seq between 1200 and 1211
  group by ss_customer_sk, ss_item_sk),
csci as (
  select cs_bill_customer_sk as customer_sk, cs_item_sk as item_sk
  from catalog_sales, date_dim
  where cs_sold_date_sk = d_date_sk
    and d_month_seq between 1200 and 1211
  group by cs_bill_customer_sk, cs_item_sk)
select sum(case when ssci.customer_sk is not null and csci.customer_sk is null
               then 1 else 0 end) as store_only,
       sum(case when ssci.customer_sk is null and csci.customer_sk is not null
               then 1 else 0 end) as catalog_only,
       sum(case when ssci.customer_sk is not null and csci.customer_sk is not null
               then 1 else 0 end) as store_and_catalog
from ssci full outer join csci
  on ssci.customer_sk = csci.customer_sk and ssci.item_sk = csci.item_sk
limit 100
""",
    # q51: cumulative web-vs-store revenue crossover — windowed running
    # sums inside the CTEs, FULL OUTER JOIN on (item, date), running max
    # outside. Adaptation: the outermost `select *` lists its columns.
    "q51": """
with web_v1 as (
  select ws_item_sk as item_sk, d_date,
         sum(sum(ws_sales_price)) over (partition by ws_item_sk order by d_date
           rows between unbounded preceding and current row) as cume_sales
  from web_sales, date_dim
  where ws_sold_date_sk = d_date_sk
    and d_month_seq between 1200 and 1211
    and ws_item_sk is not null
  group by ws_item_sk, d_date),
store_v1 as (
  select ss_item_sk as item_sk, d_date,
         sum(sum(ss_sales_price)) over (partition by ss_item_sk order by d_date
           rows between unbounded preceding and current row) as cume_sales
  from store_sales, date_dim
  where ss_sold_date_sk = d_date_sk
    and d_month_seq between 1200 and 1211
    and ss_item_sk is not null
  group by ss_item_sk, d_date)
select item_sk, d_date, web_sales, store_sales, web_cumulative, store_cumulative
from (select item_sk, d_date, web_sales, store_sales,
             max(web_sales) over (partition by item_sk order by d_date
               rows between unbounded preceding and current row) as web_cumulative,
             max(store_sales) over (partition by item_sk order by d_date
               rows between unbounded preceding and current row) as store_cumulative
      from (select case when web.item_sk is not null then web.item_sk
                        else store.item_sk end as item_sk,
                   case when web.d_date is not null then web.d_date
                        else store.d_date end as d_date,
                   web.cume_sales as web_sales,
                   store.cume_sales as store_sales
            from web_v1 web full outer join store_v1 store
              on web.item_sk = store.item_sk and web.d_date = store.d_date) x) y
where web_cumulative > store_cumulative
order by item_sk, d_date
limit 100
""",
})

QUERIES.update({
    # q27: demographic averages by item/state under ROLLUP with
    # grouping() (adapted: d_year 2000, the generator's three states)
    "q27": """
select i_item_id, s_state, grouping(s_state) as g_state,
       avg(ss_quantity) as agg1, avg(ss_list_price) as agg2,
       avg(ss_coupon_amt) as agg3, avg(ss_sales_price) as agg4
from store_sales, customer_demographics, date_dim, store, item
where ss_sold_date_sk = d_date_sk
  and ss_item_sk = i_item_sk
  and ss_store_sk = s_store_sk
  and ss_cdemo_sk = cd_demo_sk
  and cd_gender = 'M'
  and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and d_year = 2000
  and s_state in ('HI', 'KY', 'LA')
group by rollup(i_item_id, s_state)
order by i_item_id nulls last, s_state nulls last
limit 100
""",
    # q70: state/county profit hierarchy — rank within each rollup
    # level, states pre-filtered by a windowed top-5 subquery
    "q70": """
select sum(ss_net_profit) as total_sum, s_state, s_county,
       grouping(s_state) + grouping(s_county) as lochierarchy,
       rank() over (
         partition by grouping(s_state) + grouping(s_county),
                      case when grouping(s_county) = 0 then s_state end
         order by sum(ss_net_profit) desc) as rank_within_parent
from store_sales, date_dim d1, store
where d1.d_month_seq between 1200 and 1211
  and d1.d_date_sk = ss_sold_date_sk
  and s_store_sk = ss_store_sk
  and s_state in (select s_state
                  from (select s_state as s_state,
                               rank() over (partition by s_state
                                 order by sum(ss_net_profit) desc) as ranking
                        from store_sales, store, date_dim
                        where d_month_seq between 1200 and 1211
                          and d_date_sk = ss_sold_date_sk
                          and s_store_sk = ss_store_sk
                        group by s_state) tmp1
                  where ranking <= 5)
group by rollup(s_state, s_county)
order by lochierarchy desc,
         case when lochierarchy = 0 then s_state end,
         rank_within_parent, s_state nulls last, s_county nulls last
limit 100
""",
    # q67: top stores per category over an 8-level ROLLUP with rank()
    "q67": """
select i_category, i_class, i_brand, i_product_name, d_year, d_qoy,
       d_moy, s_store_id, sumsales, rk
from (select i_category, i_class, i_brand, i_product_name, d_year,
             d_qoy, d_moy, s_store_id,
             sum(coalesce(ss_sales_price * ss_quantity, 0)) as sumsales,
             rank() over (partition by i_category
               order by sum(coalesce(ss_sales_price * ss_quantity, 0)) desc
             ) as rk
      from store_sales, date_dim, store, item
      where ss_sold_date_sk = d_date_sk
        and ss_item_sk = i_item_sk
        and ss_store_sk = s_store_sk
        and d_month_seq between 1200 and 1211
      group by rollup(i_category, i_class, i_brand, i_product_name,
                      d_year, d_qoy, d_moy, s_store_id)) dw
where rk <= 100
order by i_category nulls last, i_class nulls last, i_brand nulls last,
         i_product_name nulls last, d_year nulls last, d_qoy nulls last,
         d_moy nulls last, s_store_id nulls last, sumsales, rk
limit 100
""",
    # q10: demographics of county customers active in stores AND on
    # web-or-catalog (OR of correlated EXISTS -> mark joins)
    "q10": """
select cd_gender, cd_marital_status, cd_education_status, count(*) as cnt1,
       cd_purchase_estimate, count(*) as cnt2, cd_credit_rating,
       count(*) as cnt3, cd_dep_count, count(*) as cnt4,
       cd_dep_employed_count, count(*) as cnt5, cd_dep_college_count,
       count(*) as cnt6
from customer c, customer_address ca, customer_demographics
where c.c_current_addr_sk = ca.ca_address_sk
  and ca_county in ('Williamson County', 'Huron County', 'Daviess County',
                    'Maricopa County', 'Ziebach County')
  and cd_demo_sk = c.c_current_cdemo_sk
  and exists (select ss_sold_date_sk from store_sales, date_dim
              where c.c_customer_sk = ss_customer_sk
                and ss_sold_date_sk = d_date_sk
                and d_year = 2000 and d_moy between 1 and 4)
  and (exists (select ws_sold_date_sk from web_sales, date_dim
               where c.c_customer_sk = ws_bill_customer_sk
                 and ws_sold_date_sk = d_date_sk
                 and d_year = 2000 and d_moy between 1 and 4)
       or exists (select cs_sold_date_sk from catalog_sales, date_dim
                  where c.c_customer_sk = cs_ship_customer_sk
                    and cs_sold_date_sk = d_date_sk
                    and d_year = 2000 and d_moy between 1 and 4))
group by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
order by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
limit 100
""",
    # q35: q10's statewide twin with avg/max/sum dependent stats
    "q35": """
select ca_state, cd_gender, cd_marital_status, cd_dep_count,
       count(*) as cnt1, avg(cd_dep_count) as a1, max(cd_dep_count) as m1,
       sum(cd_dep_count) as s1, cd_dep_employed_count, count(*) as cnt2,
       avg(cd_dep_employed_count) as a2, max(cd_dep_employed_count) as m2,
       sum(cd_dep_employed_count) as s2, cd_dep_college_count,
       count(*) as cnt3, avg(cd_dep_college_count) as a3,
       max(cd_dep_college_count) as m3, sum(cd_dep_college_count) as s3
from customer c, customer_address ca, customer_demographics
where c.c_current_addr_sk = ca.ca_address_sk
  and cd_demo_sk = c.c_current_cdemo_sk
  and exists (select ss_sold_date_sk from store_sales, date_dim
              where c.c_customer_sk = ss_customer_sk
                and ss_sold_date_sk = d_date_sk
                and d_year = 2000 and d_qoy < 4)
  and (exists (select ws_sold_date_sk from web_sales, date_dim
               where c.c_customer_sk = ws_bill_customer_sk
                 and ws_sold_date_sk = d_date_sk
                 and d_year = 2000 and d_qoy < 4)
       or exists (select cs_sold_date_sk from catalog_sales, date_dim
                  where c.c_customer_sk = cs_ship_customer_sk
                    and cs_sold_date_sk = d_date_sk
                    and d_year = 2000 and d_qoy < 4))
group by ca_state, cd_gender, cd_marital_status, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
order by ca_state nulls last, cd_gender, cd_marital_status, cd_dep_count,
         cd_dep_employed_count, cd_dep_college_count
limit 100
""",
})

QUERIES.update({
    # q41: product names of manufacturers with qualifying variants
    # (adaptations: the shared `i_manufact = i1.i_manufact` correlation
    # is factored out of the OR branches — algebraically identical; the
    # branches constrain category+size only — quadruple-constraint
    # branches are empty at toy SF where each manufact has ~1 item)
    "q41": """
select distinct i_product_name
from item i1
where i_manufact_id between 600 and 800
  and (select count(*) as item_cnt
       from item
       where i_manufact = i1.i_manufact
         and ((i_category = 'Home'
               and (i_size = 'medium' or i_size = 'economy'))
          or (i_category = 'Electronics'
              and (i_size = 'petite' or i_size = 'medium'))
          or (i_category = 'Men'
              and (i_size = 'medium' or i_size = 'economy'))
          or (i_category = 'Jewelry'
              and (i_size = 'petite' or i_size = 'extra large')))) > 0
order by i_product_name
limit 100
""",
    # q84: customers of one city in an income band with store returns
    # (adaptations: returns linked via sr_customer_sk — the cdemo link
    # is empty at toy SF; city/band constants from this generator)
    "q84": """
select c_customer_id as customer_id,
       coalesce(c_last_name, '') || ', ' || coalesce(c_first_name, '')
         as customername
from customer, customer_address, customer_demographics,
     household_demographics, income_band, store_returns
where ca_city = 'after'
  and c_current_addr_sk = ca_address_sk
  and ib_lower_bound >= 30001
  and ib_upper_bound <= 80000
  and ib_income_band_sk = hd_income_band_sk
  and cd_demo_sk = c_current_cdemo_sk
  and hd_demo_sk = c_current_hdemo_sk
  and sr_customer_sk = c_customer_sk
order by c_customer_id
limit 100
""",
    # q8: store profit where the store's zip prefix matches preferred
    # customers' zips (adaptations: expression join keys are
    # materialized in derived tables; zip list + having threshold fit
    # this generator)
    "q8": """
select s_store_name, sum(ss_net_profit) as profit
from store_sales, date_dim,
     (select s_store_sk, s_store_name, substring(s_zip, 1, 2) as s_zip2
      from store) s,
     (select substring(ca_zip5, 1, 2) as ca_zip2
      from ((select substring(ca_zip, 1, 5) as ca_zip5 from customer_address
             where substring(ca_zip, 1, 5) in
               ('50183', '00355', '50970', '22225', '00565', '50602',
                '22614', '68502', '45287', '98313'))
            intersect
            (select ca_zip5
             from (select substring(ca_zip, 1, 5) as ca_zip5,
                          count(*) as cnt
                   from customer_address, customer
                   where ca_address_sk = c_current_addr_sk
                     and c_preferred_cust_flag = 'Y'
                   group by substring(ca_zip, 1, 5)
                   having count(*) > 1) a1)) a2) v1
where ss_store_sk = s_store_sk
  and ss_sold_date_sk = d_date_sk
  and d_qoy = 2 and d_year = 2000
  and s_zip2 = ca_zip2
group by s_store_name
order by s_store_name
limit 100
""",
    # q83: returned-quantity share per channel for three chosen weeks
    "q83": """
with sr_items as (
  select i_item_id as item_id, sum(sr_return_quantity) as sr_item_qty
  from store_returns, item, date_dim
  where sr_item_sk = i_item_sk
    and d_date in (select d_date from date_dim
                   where d_week_seq in (select d_week_seq from date_dim
                                        where d_date in (date '2000-04-22',
                                                         date '2000-07-01',
                                                         date '2000-10-21')))
    and sr_returned_date_sk = d_date_sk
  group by i_item_id),
cr_items as (
  select i_item_id as item_id, sum(cr_return_quantity) as cr_item_qty
  from catalog_returns, item, date_dim
  where cr_item_sk = i_item_sk
    and d_date in (select d_date from date_dim
                   where d_week_seq in (select d_week_seq from date_dim
                                        where d_date in (date '2000-04-22',
                                                         date '2000-07-01',
                                                         date '2000-10-21')))
    and cr_returned_date_sk = d_date_sk
  group by i_item_id),
wr_items as (
  select i_item_id as item_id, sum(wr_return_quantity) as wr_item_qty
  from web_returns, item, date_dim
  where wr_item_sk = i_item_sk
    and d_date in (select d_date from date_dim
                   where d_week_seq in (select d_week_seq from date_dim
                                        where d_date in (date '2000-04-22',
                                                         date '2000-07-01',
                                                         date '2000-10-21')))
    and wr_returned_date_sk = d_date_sk
  group by i_item_id)
select sr_items.item_id, sr_item_qty,
       sr_item_qty / (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 * 100
         as sr_dev,
       cr_item_qty,
       cr_item_qty / (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 * 100
         as cr_dev,
       wr_item_qty,
       wr_item_qty / (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 * 100
         as wr_dev,
       (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 as average
from sr_items, cr_items, wr_items
where sr_items.item_id = cr_items.item_id
  and sr_items.item_id = wr_items.item_id
order by sr_items.item_id, sr_item_qty
limit 100
""",
    # q58: items with balanced revenue across all three channels in one
    # week (scalar subquery inside the date IN-subquery; adaptation:
    # the official +-10% balance band widens to [0.1x, 10x] — weekly
    # per-item channel revenues at toy SF differ by ~6x median)
    "q58": """
with ss_items as (
  select i_item_id as item_id, sum(ss_ext_sales_price) as ss_item_rev
  from store_sales, item, date_dim
  where ss_item_sk = i_item_sk
    and d_date in (select d_date from date_dim
                   where d_week_seq = (select d_week_seq from date_dim
                                       where d_date = date '2000-10-07'))
    and ss_sold_date_sk = d_date_sk
  group by i_item_id),
cs_items as (
  select i_item_id as item_id, sum(cs_ext_sales_price) as cs_item_rev
  from catalog_sales, item, date_dim
  where cs_item_sk = i_item_sk
    and d_date in (select d_date from date_dim
                   where d_week_seq = (select d_week_seq from date_dim
                                       where d_date = date '2000-10-07'))
    and cs_sold_date_sk = d_date_sk
  group by i_item_id),
ws_items as (
  select i_item_id as item_id, sum(ws_ext_sales_price) as ws_item_rev
  from web_sales, item, date_dim
  where ws_item_sk = i_item_sk
    and d_date in (select d_date from date_dim
                   where d_week_seq = (select d_week_seq from date_dim
                                       where d_date = date '2000-10-07'))
    and ws_sold_date_sk = d_date_sk
  group by i_item_id)
select ss_items.item_id, ss_item_rev,
       ss_item_rev / ((ss_item_rev + cs_item_rev + ws_item_rev) / 3) * 100
         as ss_dev,
       cs_item_rev,
       cs_item_rev / ((ss_item_rev + cs_item_rev + ws_item_rev) / 3) * 100
         as cs_dev,
       ws_item_rev,
       ws_item_rev / ((ss_item_rev + cs_item_rev + ws_item_rev) / 3) * 100
         as ws_dev,
       (ss_item_rev + cs_item_rev + ws_item_rev) / 3 as average
from ss_items, cs_items, ws_items
where ss_items.item_id = cs_items.item_id
  and ss_items.item_id = ws_items.item_id
  and ss_item_rev between 0.1 * cs_item_rev and 10.0 * cs_item_rev
  and ss_item_rev between 0.1 * ws_item_rev and 10.0 * ws_item_rev
  and cs_item_rev between 0.1 * ss_item_rev and 10.0 * ss_item_rev
  and cs_item_rev between 0.1 * ws_item_rev and 10.0 * ws_item_rev
  and ws_item_rev between 0.1 * ss_item_rev and 10.0 * ss_item_rev
  and ws_item_rev between 0.1 * cs_item_rev and 10.0 * cs_item_rev
order by item_id, ss_item_rev
limit 100
""",
})

QUERIES.update({
    # q66: warehouse monthly shipping report, web + catalog UNION ALL
    # (adaptations: ship_carriers is one literal — literal||literal
    # folding is not supported; `year` aliased year_; catalog net uses
    # cs_net_paid — this generator has no cs_net_paid_inc_tax)
    "q66": """
select w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
       w_country, ship_carriers, year_,
       sum(jan_sales) as jan_sales, sum(feb_sales) as feb_sales,
       sum(mar_sales) as mar_sales, sum(apr_sales) as apr_sales,
       sum(may_sales) as may_sales, sum(jun_sales) as jun_sales,
       sum(jul_sales) as jul_sales, sum(aug_sales) as aug_sales,
       sum(sep_sales) as sep_sales, sum(oct_sales) as oct_sales,
       sum(nov_sales) as nov_sales, sum(dec_sales) as dec_sales,
       sum(jan_sales / w_warehouse_sq_ft) as jan_sales_per_sq_foot,
       sum(dec_sales / w_warehouse_sq_ft) as dec_sales_per_sq_foot,
       sum(jan_net) as jan_net, sum(feb_net) as feb_net,
       sum(mar_net) as mar_net, sum(apr_net) as apr_net,
       sum(may_net) as may_net, sum(jun_net) as jun_net,
       sum(jul_net) as jul_net, sum(aug_net) as aug_net,
       sum(sep_net) as sep_net, sum(oct_net) as oct_net,
       sum(nov_net) as nov_net, sum(dec_net) as dec_net
from ((select w_warehouse_name, w_warehouse_sq_ft, w_city, w_county,
              w_state, w_country, 'DHL,BARIAN' as ship_carriers,
              d_year as year_,
              sum(case when d_moy = 1 then ws_ext_sales_price * ws_quantity
                       else 0 end) as jan_sales,
              sum(case when d_moy = 2 then ws_ext_sales_price * ws_quantity
                       else 0 end) as feb_sales,
              sum(case when d_moy = 3 then ws_ext_sales_price * ws_quantity
                       else 0 end) as mar_sales,
              sum(case when d_moy = 4 then ws_ext_sales_price * ws_quantity
                       else 0 end) as apr_sales,
              sum(case when d_moy = 5 then ws_ext_sales_price * ws_quantity
                       else 0 end) as may_sales,
              sum(case when d_moy = 6 then ws_ext_sales_price * ws_quantity
                       else 0 end) as jun_sales,
              sum(case when d_moy = 7 then ws_ext_sales_price * ws_quantity
                       else 0 end) as jul_sales,
              sum(case when d_moy = 8 then ws_ext_sales_price * ws_quantity
                       else 0 end) as aug_sales,
              sum(case when d_moy = 9 then ws_ext_sales_price * ws_quantity
                       else 0 end) as sep_sales,
              sum(case when d_moy = 10 then ws_ext_sales_price * ws_quantity
                       else 0 end) as oct_sales,
              sum(case when d_moy = 11 then ws_ext_sales_price * ws_quantity
                       else 0 end) as nov_sales,
              sum(case when d_moy = 12 then ws_ext_sales_price * ws_quantity
                       else 0 end) as dec_sales,
              sum(case when d_moy = 1 then ws_net_paid * ws_quantity
                       else 0 end) as jan_net,
              sum(case when d_moy = 2 then ws_net_paid * ws_quantity
                       else 0 end) as feb_net,
              sum(case when d_moy = 3 then ws_net_paid * ws_quantity
                       else 0 end) as mar_net,
              sum(case when d_moy = 4 then ws_net_paid * ws_quantity
                       else 0 end) as apr_net,
              sum(case when d_moy = 5 then ws_net_paid * ws_quantity
                       else 0 end) as may_net,
              sum(case when d_moy = 6 then ws_net_paid * ws_quantity
                       else 0 end) as jun_net,
              sum(case when d_moy = 7 then ws_net_paid * ws_quantity
                       else 0 end) as jul_net,
              sum(case when d_moy = 8 then ws_net_paid * ws_quantity
                       else 0 end) as aug_net,
              sum(case when d_moy = 9 then ws_net_paid * ws_quantity
                       else 0 end) as sep_net,
              sum(case when d_moy = 10 then ws_net_paid * ws_quantity
                       else 0 end) as oct_net,
              sum(case when d_moy = 11 then ws_net_paid * ws_quantity
                       else 0 end) as nov_net,
              sum(case when d_moy = 12 then ws_net_paid * ws_quantity
                       else 0 end) as dec_net
       from web_sales, warehouse, date_dim, time_dim, ship_mode
       where ws_warehouse_sk = w_warehouse_sk
         and ws_sold_date_sk = d_date_sk
         and ws_sold_time_sk = t_time_sk
         and ws_ship_mode_sk = sm_ship_mode_sk
         and d_year = 2001
         and t_time between 30838 and 59638
         and sm_carrier in ('DHL', 'BARIAN')
       group by w_warehouse_name, w_warehouse_sq_ft, w_city, w_county,
                w_state, w_country, d_year)
      union all
      (select w_warehouse_name, w_warehouse_sq_ft, w_city, w_county,
              w_state, w_country, 'DHL,BARIAN' as ship_carriers,
              d_year as year_,
              sum(case when d_moy = 1 then cs_sales_price * cs_quantity
                       else 0 end) as jan_sales,
              sum(case when d_moy = 2 then cs_sales_price * cs_quantity
                       else 0 end) as feb_sales,
              sum(case when d_moy = 3 then cs_sales_price * cs_quantity
                       else 0 end) as mar_sales,
              sum(case when d_moy = 4 then cs_sales_price * cs_quantity
                       else 0 end) as apr_sales,
              sum(case when d_moy = 5 then cs_sales_price * cs_quantity
                       else 0 end) as may_sales,
              sum(case when d_moy = 6 then cs_sales_price * cs_quantity
                       else 0 end) as jun_sales,
              sum(case when d_moy = 7 then cs_sales_price * cs_quantity
                       else 0 end) as jul_sales,
              sum(case when d_moy = 8 then cs_sales_price * cs_quantity
                       else 0 end) as aug_sales,
              sum(case when d_moy = 9 then cs_sales_price * cs_quantity
                       else 0 end) as sep_sales,
              sum(case when d_moy = 10 then cs_sales_price * cs_quantity
                       else 0 end) as oct_sales,
              sum(case when d_moy = 11 then cs_sales_price * cs_quantity
                       else 0 end) as nov_sales,
              sum(case when d_moy = 12 then cs_sales_price * cs_quantity
                       else 0 end) as dec_sales,
              sum(case when d_moy = 1 then cs_net_paid * cs_quantity
                       else 0 end) as jan_net,
              sum(case when d_moy = 2 then cs_net_paid * cs_quantity
                       else 0 end) as feb_net,
              sum(case when d_moy = 3 then cs_net_paid * cs_quantity
                       else 0 end) as mar_net,
              sum(case when d_moy = 4 then cs_net_paid * cs_quantity
                       else 0 end) as apr_net,
              sum(case when d_moy = 5 then cs_net_paid * cs_quantity
                       else 0 end) as may_net,
              sum(case when d_moy = 6 then cs_net_paid * cs_quantity
                       else 0 end) as jun_net,
              sum(case when d_moy = 7 then cs_net_paid * cs_quantity
                       else 0 end) as jul_net,
              sum(case when d_moy = 8 then cs_net_paid * cs_quantity
                       else 0 end) as aug_net,
              sum(case when d_moy = 9 then cs_net_paid * cs_quantity
                       else 0 end) as sep_net,
              sum(case when d_moy = 10 then cs_net_paid * cs_quantity
                       else 0 end) as oct_net,
              sum(case when d_moy = 11 then cs_net_paid * cs_quantity
                       else 0 end) as nov_net,
              sum(case when d_moy = 12 then cs_net_paid * cs_quantity
                       else 0 end) as dec_net
       from catalog_sales, warehouse, date_dim, time_dim, ship_mode
       where cs_warehouse_sk = w_warehouse_sk
         and cs_sold_date_sk = d_date_sk
         and cs_sold_time_sk = t_time_sk
         and cs_ship_mode_sk = sm_ship_mode_sk
         and d_year = 2001
         and t_time between 30838 and 59638
         and sm_carrier in ('DHL', 'BARIAN')
       group by w_warehouse_name, w_warehouse_sq_ft, w_city, w_county,
                w_state, w_country, d_year)) x
group by w_warehouse_name, w_warehouse_sq_ft, w_city, w_county, w_state,
         w_country, ship_carriers, year_
order by w_warehouse_name
limit 100
""",
})

QUERIES.update({
    # q74: customers whose web growth beat their store growth
    # (adapted years 1999->2000 inside this generator's sales span)
    "q74": """
with year_total as (
  select c_customer_id as customer_id, c_first_name, c_last_name,
         d_year as year_, sum(ss_net_paid) as year_total, 's' as sale_type
  from customer, store_sales, date_dim
  where c_customer_sk = ss_customer_sk and ss_sold_date_sk = d_date_sk
    and d_year in (1999, 2000)
  group by c_customer_id, c_first_name, c_last_name, d_year
  union all
  select c_customer_id as customer_id, c_first_name, c_last_name,
         d_year as year_, sum(ws_net_paid) as year_total, 'w' as sale_type
  from customer, web_sales, date_dim
  where c_customer_sk = ws_bill_customer_sk and ws_sold_date_sk = d_date_sk
    and d_year in (1999, 2000)
  group by c_customer_id, c_first_name, c_last_name, d_year)
select t_s_secyear.customer_id, t_s_secyear.c_first_name as customer_first_name,
       t_s_secyear.c_last_name as customer_last_name
from year_total t_s_firstyear, year_total t_s_secyear,
     year_total t_w_firstyear, year_total t_w_secyear
where t_s_secyear.customer_id = t_s_firstyear.customer_id
  and t_s_firstyear.customer_id = t_w_secyear.customer_id
  and t_s_firstyear.customer_id = t_w_firstyear.customer_id
  and t_s_firstyear.sale_type = 's' and t_w_firstyear.sale_type = 'w'
  and t_s_secyear.sale_type = 's' and t_w_secyear.sale_type = 'w'
  and t_s_firstyear.year_ = 1999 and t_s_secyear.year_ = 2000
  and t_w_firstyear.year_ = 1999 and t_w_secyear.year_ = 2000
  and t_s_firstyear.year_total > 0 and t_w_firstyear.year_total > 0
  and case when t_w_firstyear.year_total > 0
           then t_w_secyear.year_total / t_w_firstyear.year_total
           else null end
      > case when t_s_firstyear.year_total > 0
             then t_s_secyear.year_total / t_s_firstyear.year_total
             else null end
order by customer_id, customer_first_name, customer_last_name
limit 100
""",
    # q11: q74 with the list-minus-discount revenue formula and email
    # carried (adaptation: birth_country/login columns do not exist in
    # this generator; email replaces them in the grouping)
    "q11": """
with year_total as (
  select c_customer_id as customer_id, c_first_name, c_last_name,
         c_email_address, d_year as year_,
         sum(ss_ext_list_price - ss_ext_discount_amt) as year_total,
         's' as sale_type
  from customer, store_sales, date_dim
  where c_customer_sk = ss_customer_sk and ss_sold_date_sk = d_date_sk
    and d_year in (1999, 2000)
  group by c_customer_id, c_first_name, c_last_name, c_email_address, d_year
  union all
  select c_customer_id as customer_id, c_first_name, c_last_name,
         c_email_address, d_year as year_,
         sum(ws_ext_list_price - ws_ext_discount_amt) as year_total,
         'w' as sale_type
  from customer, web_sales, date_dim
  where c_customer_sk = ws_bill_customer_sk and ws_sold_date_sk = d_date_sk
    and d_year in (1999, 2000)
  group by c_customer_id, c_first_name, c_last_name, c_email_address, d_year)
select t_s_secyear.customer_id, t_s_secyear.c_first_name as customer_first_name,
       t_s_secyear.c_last_name as customer_last_name,
       t_s_secyear.c_email_address as customer_email_address
from year_total t_s_firstyear, year_total t_s_secyear,
     year_total t_w_firstyear, year_total t_w_secyear
where t_s_secyear.customer_id = t_s_firstyear.customer_id
  and t_s_firstyear.customer_id = t_w_secyear.customer_id
  and t_s_firstyear.customer_id = t_w_firstyear.customer_id
  and t_s_firstyear.sale_type = 's' and t_w_firstyear.sale_type = 'w'
  and t_s_secyear.sale_type = 's' and t_w_secyear.sale_type = 'w'
  and t_s_firstyear.year_ = 1999 and t_s_secyear.year_ = 2000
  and t_w_firstyear.year_ = 1999 and t_w_secyear.year_ = 2000
  and t_s_firstyear.year_total > 0 and t_w_firstyear.year_total > 0
  and case when t_w_firstyear.year_total > 0
           then t_w_secyear.year_total / t_w_firstyear.year_total
           else 0.0 end
      > case when t_s_firstyear.year_total > 0
             then t_s_secyear.year_total / t_s_firstyear.year_total
             else 0.0 end
order by customer_id, customer_first_name, customer_last_name,
         customer_email_address
limit 100
""",
    # q4: three-channel growth comparison with the half-margin formula
    "q4": """
with year_total as (
  select c_customer_id as customer_id, c_first_name, c_last_name,
         d_year as year_,
         sum(((ss_ext_list_price - ss_ext_wholesale_cost
               - ss_ext_discount_amt) + ss_ext_sales_price) / 2)
           as year_total,
         's' as sale_type
  from customer, store_sales, date_dim
  where c_customer_sk = ss_customer_sk and ss_sold_date_sk = d_date_sk
    and d_year in (1999, 2000)
  group by c_customer_id, c_first_name, c_last_name, d_year
  union all
  select c_customer_id as customer_id, c_first_name, c_last_name,
         d_year as year_,
         sum(((cs_ext_list_price - cs_ext_wholesale_cost
               - cs_ext_discount_amt) + cs_ext_sales_price) / 2)
           as year_total,
         'c' as sale_type
  from customer, catalog_sales, date_dim
  where c_customer_sk = cs_bill_customer_sk and cs_sold_date_sk = d_date_sk
    and d_year in (1999, 2000)
  group by c_customer_id, c_first_name, c_last_name, d_year
  union all
  select c_customer_id as customer_id, c_first_name, c_last_name,
         d_year as year_,
         sum(((ws_ext_list_price - ws_ext_wholesale_cost
               - ws_ext_discount_amt) + ws_ext_sales_price) / 2)
           as year_total,
         'w' as sale_type
  from customer, web_sales, date_dim
  where c_customer_sk = ws_bill_customer_sk and ws_sold_date_sk = d_date_sk
    and d_year in (1999, 2000)
  group by c_customer_id, c_first_name, c_last_name, d_year)
select t_s_secyear.customer_id, t_s_secyear.c_first_name as customer_first_name,
       t_s_secyear.c_last_name as customer_last_name
from year_total t_s_firstyear, year_total t_s_secyear,
     year_total t_c_firstyear, year_total t_c_secyear,
     year_total t_w_firstyear, year_total t_w_secyear
where t_s_secyear.customer_id = t_s_firstyear.customer_id
  and t_s_firstyear.customer_id = t_w_secyear.customer_id
  and t_s_firstyear.customer_id = t_w_firstyear.customer_id
  and t_s_firstyear.customer_id = t_c_secyear.customer_id
  and t_s_firstyear.customer_id = t_c_firstyear.customer_id
  and t_s_firstyear.sale_type = 's' and t_c_firstyear.sale_type = 'c'
  and t_w_firstyear.sale_type = 'w' and t_s_secyear.sale_type = 's'
  and t_c_secyear.sale_type = 'c' and t_w_secyear.sale_type = 'w'
  and t_s_firstyear.year_ = 1999 and t_s_secyear.year_ = 2000
  and t_c_firstyear.year_ = 1999 and t_c_secyear.year_ = 2000
  and t_w_firstyear.year_ = 1999 and t_w_secyear.year_ = 2000
  and t_s_firstyear.year_total > 0 and t_c_firstyear.year_total > 0
  and t_w_firstyear.year_total > 0
  and case when t_c_firstyear.year_total > 0
           then t_c_secyear.year_total / t_c_firstyear.year_total
           else null end
      > case when t_s_firstyear.year_total > 0
             then t_s_secyear.year_total / t_s_firstyear.year_total
             else null end
  and case when t_c_firstyear.year_total > 0
           then t_c_secyear.year_total / t_c_firstyear.year_total
           else null end
      > case when t_w_firstyear.year_total > 0
             then t_w_secyear.year_total / t_w_firstyear.year_total
             else null end
order by customer_id, customer_first_name, customer_last_name
limit 100
""",
})

QUERIES.update({
    # q77: 30-day sales vs returns per channel location, ROLLUP over
    # (channel, id). Adaptations: web returns reach their page via the
    # originating sale (this generator's web_returns carries no page
    # key — same device as q5); catalog keeps the official cs,cr
    # cartesian quirk.
    "q77": """
with ss as (
  select s_store_sk, sum(ss_ext_sales_price) as sales,
         sum(ss_net_profit) as profit
  from store_sales, date_dim, store
  where ss_sold_date_sk = d_date_sk
    and d_date between date '2000-08-03' and date '2000-08-03' + 30
    and ss_store_sk = s_store_sk
  group by s_store_sk),
sr as (
  select sr_store_sk, sum(sr_return_amt) as returns_,
         sum(sr_net_loss) as profit_loss
  from store_returns, date_dim
  where sr_returned_date_sk = d_date_sk
    and d_date between date '2000-08-03' and date '2000-08-03' + 30
  group by sr_store_sk),
cs as (
  select cs_call_center_sk, sum(cs_ext_sales_price) as sales,
         sum(cs_net_profit) as profit
  from catalog_sales, date_dim
  where cs_sold_date_sk = d_date_sk
    and d_date between date '2000-08-03' and date '2000-08-03' + 30
  group by cs_call_center_sk),
cr as (
  select sum(cr_return_amount) as returns_,
         sum(cr_net_loss) as profit_loss
  from catalog_returns, date_dim
  where cr_returned_date_sk = d_date_sk
    and d_date between date '2000-08-03' and date '2000-08-03' + 30),
ws as (
  select ws_web_page_sk, sum(ws_ext_sales_price) as sales,
         sum(ws_net_profit) as profit
  from web_sales, date_dim
  where ws_sold_date_sk = d_date_sk
    and d_date between date '2000-08-03' and date '2000-08-03' + 30
    and ws_web_page_sk is not null
  group by ws_web_page_sk),
wr as (
  select ws_web_page_sk, sum(wr_return_amt) as returns_,
         sum(wr_net_loss) as profit_loss
  from web_returns, web_sales, date_dim
  where wr_order_number = ws_order_number and wr_item_sk = ws_item_sk
    and wr_returned_date_sk = d_date_sk
    and d_date between date '2000-08-03' and date '2000-08-03' + 30
    and ws_web_page_sk is not null
  group by ws_web_page_sk)
select channel, id, sum(sales) as sales, sum(returns_) as returns_,
       sum(profit) as profit
from (select 'store channel' as channel, ss.s_store_sk as id, sales,
             coalesce(returns_, 0) as returns_,
             profit - coalesce(profit_loss, 0) as profit
      from ss left join sr on ss.s_store_sk = sr.sr_store_sk
      union all
      select 'catalog channel' as channel, cs_call_center_sk as id, sales,
             returns_, profit - profit_loss as profit
      from cs, cr
      union all
      select 'web channel' as channel, ws.ws_web_page_sk as id, sales,
             coalesce(returns_, 0) as returns_,
             profit - coalesce(profit_loss, 0) as profit
      from ws left join wr on ws.ws_web_page_sk = wr.ws_web_page_sk) x
group by rollup(channel, id)
order by channel nulls last, id nulls last, sales
limit 100
""",
    # q80: promoted high-price items: per-location sales net of
    # returns, three channels, ROLLUP. Adaptation: the catalog id is
    # the call center (no catalog-page key in this generator).
    "q80": """
with ssr as (
  select s_store_id,
         sum(ss_ext_sales_price) as sales,
         sum(coalesce(sr_return_amt, 0)) as returns_,
         sum(ss_net_profit - coalesce(sr_net_loss, 0)) as profit
  from store_sales left outer join store_returns
         on ss_item_sk = sr_item_sk and ss_ticket_number = sr_ticket_number,
       date_dim, store, item, promotion
  where ss_sold_date_sk = d_date_sk
    and d_date between date '2000-08-03' and date '2000-08-03' + 30
    and ss_store_sk = s_store_sk
    and ss_item_sk = i_item_sk and i_current_price > 50
    and ss_promo_sk = p_promo_sk and p_channel_tv = 'N'
  group by s_store_id),
csr as (
  select cc_call_center_id,
         sum(cs_ext_sales_price) as sales,
         sum(coalesce(cr_return_amount, 0)) as returns_,
         sum(cs_net_profit - coalesce(cr_net_loss, 0)) as profit
  from catalog_sales left outer join catalog_returns
         on cs_item_sk = cr_item_sk and cs_order_number = cr_order_number,
       date_dim, call_center, item, promotion
  where cs_sold_date_sk = d_date_sk
    and d_date between date '2000-08-03' and date '2000-08-03' + 30
    and cs_call_center_sk = cc_call_center_sk
    and cs_item_sk = i_item_sk and i_current_price > 50
    and cs_promo_sk = p_promo_sk and p_channel_tv = 'N'
  group by cc_call_center_id),
wsr as (
  select web_site_id,
         sum(ws_ext_sales_price) as sales,
         sum(coalesce(wr_return_amt, 0)) as returns_,
         sum(ws_net_profit - coalesce(wr_net_loss, 0)) as profit
  from web_sales left outer join web_returns
         on ws_item_sk = wr_item_sk and ws_order_number = wr_order_number,
       date_dim, web_site, item, promotion
  where ws_sold_date_sk = d_date_sk
    and d_date between date '2000-08-03' and date '2000-08-03' + 30
    and ws_web_site_sk = web_site_sk
    and ws_item_sk = i_item_sk and i_current_price > 50
    and ws_promo_sk = p_promo_sk and p_channel_tv = 'N'
  group by web_site_id)
select channel, id, sum(sales) as sales, sum(returns_) as returns_,
       sum(profit) as profit
from (select 'store channel' as channel, s_store_id as id, sales,
             returns_, profit
      from ssr
      union all
      select 'catalog channel' as channel, cc_call_center_id as id, sales,
             returns_, profit
      from csr
      union all
      select 'web channel' as channel, web_site_id as id, sales, returns_,
             profit
      from wsr) x
group by rollup(channel, id)
order by channel nulls last, id nulls last, sales
limit 100
""",
    # q75: categories whose current-year sales dropped below 90% of the
    # prior year, net of returns, across all three channels (UNION
    # dedup). Adaptation: the guard ratio divides directly (no
    # DECIMAL(17,2) casts).
    "q75": """
with all_sales as (
  select d_year, i_brand_id, i_class_id, i_category_id, i_manufact_id,
         sum(sales_cnt) as sales_cnt, sum(sales_amt) as sales_amt
  from (select d_year, i_brand_id, i_class_id, i_category_id,
               i_manufact_id,
               cs_quantity - coalesce(cr_return_quantity, 0) as sales_cnt,
               cs_ext_sales_price - coalesce(cr_return_amount, 0.0)
                 as sales_amt
        from catalog_sales
             join item on i_item_sk = cs_item_sk
             join date_dim on d_date_sk = cs_sold_date_sk
             left join catalog_returns
               on cs_order_number = cr_order_number
                  and cs_item_sk = cr_item_sk
        where i_category = 'Books'
        union
        select d_year, i_brand_id, i_class_id, i_category_id,
               i_manufact_id,
               ss_quantity - coalesce(sr_return_quantity, 0) as sales_cnt,
               ss_ext_sales_price - coalesce(sr_return_amt, 0.0)
                 as sales_amt
        from store_sales
             join item on i_item_sk = ss_item_sk
             join date_dim on d_date_sk = ss_sold_date_sk
             left join store_returns
               on ss_ticket_number = sr_ticket_number
                  and ss_item_sk = sr_item_sk
        where i_category = 'Books'
        union
        select d_year, i_brand_id, i_class_id, i_category_id,
               i_manufact_id,
               ws_quantity - coalesce(wr_return_quantity, 0) as sales_cnt,
               ws_ext_sales_price - coalesce(wr_return_amt, 0.0)
                 as sales_amt
        from web_sales
             join item on i_item_sk = ws_item_sk
             join date_dim on d_date_sk = ws_sold_date_sk
             left join web_returns
               on ws_order_number = wr_order_number
                  and ws_item_sk = wr_item_sk
        where i_category = 'Books') sales_detail
  group by d_year, i_brand_id, i_class_id, i_category_id, i_manufact_id)
select prev_yr.d_year as prev_year, curr_yr.d_year as year_,
       curr_yr.i_brand_id, curr_yr.i_class_id, curr_yr.i_category_id,
       curr_yr.i_manufact_id, prev_yr.sales_cnt as prev_yr_cnt,
       curr_yr.sales_cnt as curr_yr_cnt,
       curr_yr.sales_cnt - prev_yr.sales_cnt as sales_cnt_diff,
       curr_yr.sales_amt - prev_yr.sales_amt as sales_amt_diff
from all_sales curr_yr, all_sales prev_yr
where curr_yr.i_brand_id = prev_yr.i_brand_id
  and curr_yr.i_class_id = prev_yr.i_class_id
  and curr_yr.i_category_id = prev_yr.i_category_id
  and curr_yr.i_manufact_id = prev_yr.i_manufact_id
  and curr_yr.d_year = 2000
  and prev_yr.d_year = 1999
  and curr_yr.sales_cnt / prev_yr.sales_cnt < 0.9
order by sales_cnt_diff, sales_amt_diff, i_brand_id, i_class_id,
         i_manufact_id
limit 100
""",
    # q78: store-loyalty ratio for unreturned sales by customer/item/
    # year against the other two channels
    "q78": """
with ws as (
  select d_year as ws_sold_year, ws_item_sk,
         ws_bill_customer_sk as ws_customer_sk,
         sum(ws_quantity) as ws_qty,
         sum(ws_wholesale_cost) as ws_wc,
         sum(ws_sales_price) as ws_sp
  from web_sales
       left join web_returns on wr_order_number = ws_order_number
                                and ws_item_sk = wr_item_sk
       join date_dim on ws_sold_date_sk = d_date_sk
  where wr_order_number is null
  group by d_year, ws_item_sk, ws_bill_customer_sk),
cs as (
  select d_year as cs_sold_year, cs_item_sk,
         cs_bill_customer_sk as cs_customer_sk,
         sum(cs_quantity) as cs_qty,
         sum(cs_wholesale_cost) as cs_wc,
         sum(cs_sales_price) as cs_sp
  from catalog_sales
       left join catalog_returns on cr_order_number = cs_order_number
                                    and cs_item_sk = cr_item_sk
       join date_dim on cs_sold_date_sk = d_date_sk
  where cr_order_number is null
  group by d_year, cs_item_sk, cs_bill_customer_sk),
ss as (
  select d_year as ss_sold_year, ss_item_sk,
         ss_customer_sk,
         sum(ss_quantity) as ss_qty,
         sum(ss_wholesale_cost) as ss_wc,
         sum(ss_sales_price) as ss_sp
  from store_sales
       left join store_returns on sr_ticket_number = ss_ticket_number
                                  and ss_item_sk = sr_item_sk
       join date_dim on ss_sold_date_sk = d_date_sk
  where sr_ticket_number is null
  group by d_year, ss_item_sk, ss_customer_sk)
select ss_customer_sk,
       round(ss_qty / (coalesce(ws_qty, 0) + coalesce(cs_qty, 0)), 2)
         as ratio,
       ss_qty as store_qty, ss_wc as store_wholesale_cost,
       ss_sp as store_sales_price,
       coalesce(ws_qty, 0) + coalesce(cs_qty, 0) as other_chan_qty,
       coalesce(ws_wc, 0) + coalesce(cs_wc, 0)
         as other_chan_wholesale_cost,
       coalesce(ws_sp, 0) + coalesce(cs_sp, 0) as other_chan_sales_price
from ss
     left join ws on ws_sold_year = ss_sold_year
                     and ws_item_sk = ss_item_sk
                     and ws_customer_sk = ss_customer_sk
     left join cs on cs_sold_year = ss_sold_year
                     and cs_item_sk = ss_item_sk
                     and cs_customer_sk = ss_customer_sk
where (coalesce(ws_qty, 0) > 0 or coalesce(cs_qty, 0) > 0)
  and ss_sold_year = 2000
order by ss_customer_sk, ss_qty desc, ss_wc desc, ss_sp desc,
         other_chan_qty, other_chan_wholesale_cost, other_chan_sales_price,
         ratio
limit 100
""",
})

QUERIES.update({
    # q49: worst return ratios per channel, rank-filtered, UNION dedup
    # (adaptations: plain division instead of DECIMAL(15,4) casts;
    # return-amount floor lowered for toy SF)
    "q49": """
select channel, item, return_ratio, return_rank, currency_rank
from ((select 'web' as channel, web.item, web.return_ratio,
              web.return_rank, web.currency_rank
       from (select item, return_ratio, currency_ratio,
                    rank() over (order by return_ratio) as return_rank,
                    rank() over (order by currency_ratio) as currency_rank
             from (select ws_item_sk as item,
                          sum(coalesce(wr_return_quantity, 0))
                            / sum(coalesce(ws_quantity, 0)) as return_ratio,
                          sum(coalesce(wr_return_amt, 0))
                            / sum(coalesce(ws_net_paid, 0)) as currency_ratio
                   from web_sales left outer join web_returns
                        on ws_order_number = wr_order_number
                           and ws_item_sk = wr_item_sk, date_dim
                   where wr_return_amt > 100
                     and ws_net_profit > 1
                     and ws_net_paid > 0
                     and ws_quantity > 0
                     and ws_sold_date_sk = d_date_sk
                     and d_year = 2001 and d_moy = 12
                   group by ws_item_sk) in_web) web
       where web.return_rank <= 10 or web.currency_rank <= 10)
      union
      (select 'catalog' as channel, cat.item, cat.return_ratio,
              cat.return_rank, cat.currency_rank
       from (select item, return_ratio, currency_ratio,
                    rank() over (order by return_ratio) as return_rank,
                    rank() over (order by currency_ratio) as currency_rank
             from (select cs_item_sk as item,
                          sum(coalesce(cr_return_quantity, 0))
                            / sum(coalesce(cs_quantity, 0)) as return_ratio,
                          sum(coalesce(cr_return_amount, 0))
                            / sum(coalesce(cs_net_paid, 0)) as currency_ratio
                   from catalog_sales left outer join catalog_returns
                        on cs_order_number = cr_order_number
                           and cs_item_sk = cr_item_sk, date_dim
                   where cr_return_amount > 100
                     and cs_net_profit > 1
                     and cs_net_paid > 0
                     and cs_quantity > 0
                     and cs_sold_date_sk = d_date_sk
                     and d_year = 2001 and d_moy = 12
                   group by cs_item_sk) in_cat) cat
       where cat.return_rank <= 10 or cat.currency_rank <= 10)
      union
      (select 'store' as channel, sts.item, sts.return_ratio,
              sts.return_rank, sts.currency_rank
       from (select item, return_ratio, currency_ratio,
                    rank() over (order by return_ratio) as return_rank,
                    rank() over (order by currency_ratio) as currency_rank
             from (select ss_item_sk as item,
                          sum(coalesce(sr_return_quantity, 0))
                            / sum(coalesce(ss_quantity, 0)) as return_ratio,
                          sum(coalesce(sr_return_amt, 0))
                            / sum(coalesce(ss_net_paid, 0)) as currency_ratio
                   from store_sales left outer join store_returns
                        on ss_ticket_number = sr_ticket_number
                           and ss_item_sk = sr_item_sk, date_dim
                   where sr_return_amt > 100
                     and ss_net_profit > 1
                     and ss_net_paid > 0
                     and ss_quantity > 0
                     and ss_sold_date_sk = d_date_sk
                     and d_year = 2001 and d_moy = 12
                   group by ss_item_sk) in_store) sts
       where sts.return_rank <= 10 or sts.currency_rank <= 10)) x
order by 1, 4, 5, 2
limit 100
""",
    # q95: returned orders of multi-warehouse customers for one
    # state/site over 60 days (adaptations: this generator emits
    # single-line web orders, so the official per-order warehouse
    # diversity self-join keys on the billing customer instead; ship
    # cost column is ws_ext_sales_price — no ws_ext_ship_cost;
    # state/company constants from the generator)
    "q95": """
with ws_wh as (
  select ws1.ws_order_number, ws1.ws_warehouse_sk as wh1,
         ws2.ws_warehouse_sk as wh2
  from web_sales ws1, web_sales ws2
  where ws1.ws_order_number = ws2.ws_order_number
    and ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk)
select count(distinct ws1.ws_order_number) as order_count,
       sum(ws_ext_sales_price) as total_shipping_cost,
       sum(ws_net_profit) as total_net_profit
from web_sales ws1, date_dim, customer_address, web_site
where d_date between date '2000-02-01' and date '2000-02-01' + 60
  and ws1.ws_ship_date_sk = d_date_sk
  and ws1.ws_ship_addr_sk = ca_address_sk
  and ca_state = 'AR'
  and ws1.ws_web_site_sk = web_site_sk
  and web_company_name = 'able'
  and ws1.ws_order_number in (select ws_order_number from ws_wh)
  and ws1.ws_order_number in (select wr_order_number
                              from web_returns, ws_wh
                              where wr_order_number = ws_wh.ws_order_number)
limit 100
""",
    # q72: catalog orders promised from low stock: inventory of the
    # sale week below the ordered quantity, shipped 5+ days late
    # (adaptation: household demographics reach the sale via the
    # billing customer — no cs_bill_hdemo_sk in this generator)
    "q72": """
select i_item_desc, w_warehouse_name, d1.d_week_seq,
       sum(case when p_promo_sk is null then 1 else 0 end) as no_promo,
       sum(case when p_promo_sk is not null then 1 else 0 end) as promo,
       count(*) as total_cnt
from catalog_sales
     join inventory on cs_item_sk = inv_item_sk
     join warehouse on w_warehouse_sk = inv_warehouse_sk
     join item on i_item_sk = cs_item_sk
     join customer_demographics on cs_bill_cdemo_sk = cd_demo_sk
     join customer on cs_bill_customer_sk = c_customer_sk
     join household_demographics on c_current_hdemo_sk = hd_demo_sk
     join date_dim d1 on cs_sold_date_sk = d1.d_date_sk
     join date_dim d2 on inv_date_sk = d2.d_date_sk
     join date_dim d3 on cs_ship_date_sk = d3.d_date_sk
     left outer join promotion on cs_promo_sk = p_promo_sk
     left outer join catalog_returns on cr_item_sk = cs_item_sk
                                        and cr_order_number = cs_order_number
where d1.d_week_seq = d2.d_week_seq
  and inv_quantity_on_hand < cs_quantity
  and d3.d_date > d1.d_date + 5
  and hd_buy_potential = '>10000'
  and d1.d_year = 2000
  and cd_marital_status = 'D'
group by i_item_desc, w_warehouse_name, d1.d_week_seq
order by total_cnt desc, i_item_desc, w_warehouse_name, d_week_seq
limit 100
""",
})

QUERIES.update({
    # q54: revenue segments of customers who bought one class's items
    # (adaptations: class 'women-infants' — no 'maternity' class here;
    # the buyer window widens to the year and the store correlation is
    # county-only — month+county+state matches are empty at toy SF)
    "q54": """
with my_customers as (
  select distinct c_customer_sk, c_current_addr_sk
  from (select cs_sold_date_sk as sold_date_sk,
               cs_bill_customer_sk as customer_sk,
               cs_item_sk as item_sk
        from catalog_sales
        union all
        select ws_sold_date_sk as sold_date_sk,
               ws_bill_customer_sk as customer_sk,
               ws_item_sk as item_sk
        from web_sales) cs_or_ws_sales, item, date_dim, customer
  where sold_date_sk = d_date_sk
    and item_sk = i_item_sk
    and i_category = 'Women'
    and i_class = 'women-infants'
    and c_customer_sk = cs_or_ws_sales.customer_sk
    and d_year = 1999),
my_revenue as (
  select c_customer_sk, sum(ss_ext_sales_price) as revenue
  from my_customers, store_sales, customer_address, store, date_dim
  where c_current_addr_sk = ca_address_sk
    and ca_county = s_county
    and ss_customer_sk = c_customer_sk
    and ss_sold_date_sk = d_date_sk
    and d_month_seq between (select distinct d_month_seq + 1
                             from date_dim
                             where d_year = 1999 and d_moy = 12)
                        and (select distinct d_month_seq + 3
                             from date_dim
                             where d_year = 1999 and d_moy = 12)
  group by c_customer_sk),
segments as (
  select cast(revenue / 50 as int) as segment from my_revenue)
select segment, count(*) as num_customers, segment * 50 as segment_base
from segments
group by segment
order by segment, num_customers
limit 100
""",
    # q24: store customers who bought one color in their own zip
    # (adaptations: the c_birth_country = upper(ca_country) conjunct is
    # dropped — this generator's customer has no birth country; the zip
    # correlation relaxes to a shared first digit and the color comes
    # from the palette — exact zip equality is empty at toy SF)
    "q24": """
with ssales as (
  select c_last_name, c_first_name, s_store_name, ca_state, s_state,
         i_color, i_current_price, i_manufact_id, i_units, i_size,
         sum(ss_net_paid) as netpaid
  from store_sales, store_returns, store, item, customer, customer_address
  where ss_ticket_number = sr_ticket_number
    and ss_item_sk = sr_item_sk
    and ss_customer_sk = c_customer_sk
    and ss_item_sk = i_item_sk
    and ss_store_sk = s_store_sk
    and c_current_addr_sk = ca_address_sk
    and substring(s_zip, 1, 1) = substring(ca_zip, 1, 1)
    and s_market_id = 8
  group by c_last_name, c_first_name, s_store_name, ca_state, s_state,
           i_color, i_current_price, i_manufact_id, i_units, i_size)
select c_last_name, c_first_name, s_store_name, sum(netpaid) as paid
from ssales
where i_color = 'burlywood'
group by c_last_name, c_first_name, s_store_name
having sum(netpaid) > (select 0.05 * avg(netpaid) from ssales)
order by c_last_name, c_first_name, s_store_name
limit 100
""",
    # q23: off-channel spend of the best store customers on frequently
    # sold items (adaptations: the having thresholds fit toy SF; the
    # max_store_sales scalar names its column)
    "q23": """
with frequent_ss_items as (
  select substring(i_item_desc, 1, 30) as itemdesc, i_item_sk as item_sk,
         d_date as solddate, count(*) as cnt
  from store_sales, date_dim, item
  where ss_sold_date_sk = d_date_sk
    and ss_item_sk = i_item_sk
    and d_year in (1999, 2000, 2001, 2002)
  group by substring(i_item_desc, 1, 30), i_item_sk, d_date
  having count(*) > 1),
max_store_sales as (
  select max(csales) as tpcds_cmax
  from (select c_customer_sk, sum(ss_quantity * ss_sales_price) as csales
        from store_sales, customer, date_dim
        where ss_customer_sk = c_customer_sk
          and ss_sold_date_sk = d_date_sk
          and d_year in (1999, 2000, 2001, 2002)
        group by c_customer_sk) x),
best_ss_customer as (
  select c_customer_sk, sum(ss_quantity * ss_sales_price) as ssales
  from store_sales, customer
  where ss_customer_sk = c_customer_sk
  group by c_customer_sk
  having sum(ss_quantity * ss_sales_price)
         > 0.5 * (select tpcds_cmax from max_store_sales))
select sum(sales) as total_sales
from (select cs_quantity * cs_list_price as sales
      from catalog_sales, date_dim
      where d_year = 2000
        and d_moy = 2
        and cs_sold_date_sk = d_date_sk
        and cs_item_sk in (select item_sk from frequent_ss_items)
        and cs_bill_customer_sk in (select c_customer_sk
                                    from best_ss_customer)
      union all
      select ws_quantity * ws_list_price as sales
      from web_sales, date_dim
      where d_year = 2000
        and d_moy = 2
        and ws_sold_date_sk = d_date_sk
        and ws_item_sk in (select item_sk from frequent_ss_items)
        and ws_bill_customer_sk in (select c_customer_sk
                                    from best_ss_customer)) y
limit 100
""",
})

QUERIES.update({
    # q14: cross-channel brand/class/category overlap (3-way INTERSECT)
    # with an average-sales HAVING gate and ROLLUP report
    "q14": """
with cross_items as (
  select i_item_sk as ss_item_sk
  from item,
       (select iss.i_brand_id as brand_id, iss.i_class_id as class_id,
               iss.i_category_id as category_id
        from store_sales, item iss, date_dim d1
        where ss_item_sk = iss.i_item_sk
          and ss_sold_date_sk = d1.d_date_sk
          and d1.d_year between 1999 and 2001
        intersect
        select ics.i_brand_id as brand_id, ics.i_class_id as class_id,
               ics.i_category_id as category_id
        from catalog_sales, item ics, date_dim d2
        where cs_item_sk = ics.i_item_sk
          and cs_sold_date_sk = d2.d_date_sk
          and d2.d_year between 1999 and 2001
        intersect
        select iws.i_brand_id as brand_id, iws.i_class_id as class_id,
               iws.i_category_id as category_id
        from web_sales, item iws, date_dim d3
        where ws_item_sk = iws.i_item_sk
          and ws_sold_date_sk = d3.d_date_sk
          and d3.d_year between 1999 and 2001) x
  where i_brand_id = brand_id
    and i_class_id = class_id
    and i_category_id = category_id),
avg_sales as (
  select avg(quantity * list_price) as average_sales
  from (select ss_quantity as quantity, ss_list_price as list_price
        from store_sales, date_dim
        where ss_sold_date_sk = d_date_sk and d_year between 1999 and 2001
        union all
        select cs_quantity as quantity, cs_list_price as list_price
        from catalog_sales, date_dim
        where cs_sold_date_sk = d_date_sk and d_year between 1999 and 2001
        union all
        select ws_quantity as quantity, ws_list_price as list_price
        from web_sales, date_dim
        where ws_sold_date_sk = d_date_sk
          and d_year between 1999 and 2001) x)
select channel, i_brand_id, i_class_id, i_category_id, sum(sales) as sales,
       sum(number_sales) as number_sales
from (select 'store' as channel, i_brand_id, i_class_id, i_category_id,
             sum(ss_quantity * ss_list_price) as sales,
             count(*) as number_sales
      from store_sales, item, date_dim
      where ss_item_sk in (select ss_item_sk from cross_items)
        and ss_item_sk = i_item_sk
        and ss_sold_date_sk = d_date_sk
        and d_year = 2001 and d_moy = 11
      group by i_brand_id, i_class_id, i_category_id
      having sum(ss_quantity * ss_list_price)
             > (select average_sales from avg_sales)
      union all
      select 'catalog' as channel, i_brand_id, i_class_id, i_category_id,
             sum(cs_quantity * cs_list_price) as sales,
             count(*) as number_sales
      from catalog_sales, item, date_dim
      where cs_item_sk in (select ss_item_sk from cross_items)
        and cs_item_sk = i_item_sk
        and cs_sold_date_sk = d_date_sk
        and d_year = 2001 and d_moy = 11
      group by i_brand_id, i_class_id, i_category_id
      having sum(cs_quantity * cs_list_price)
             > (select average_sales from avg_sales)
      union all
      select 'web' as channel, i_brand_id, i_class_id, i_category_id,
             sum(ws_quantity * ws_list_price) as sales,
             count(*) as number_sales
      from web_sales, item, date_dim
      where ws_item_sk in (select ss_item_sk from cross_items)
        and ws_item_sk = i_item_sk
        and ws_sold_date_sk = d_date_sk
        and d_year = 2001 and d_moy = 11
      group by i_brand_id, i_class_id, i_category_id
      having sum(ws_quantity * ws_list_price)
             > (select average_sales from avg_sales)) y
group by rollup(channel, i_brand_id, i_class_id, i_category_id)
order by channel nulls last, i_brand_id nulls last, i_class_id nulls last,
         i_category_id nulls last
limit 100
""",
    # q64: profitable-return items sold in consecutive years
    # (adaptations: refund = refunded cash + store credit — no
    # cr_reversed_charge here; the first-sale/first-ship date dims and
    # birth-country are dropped with their columns — the generator's
    # customer has neither; street numbers substitute the address id —
    # no ca_street_number; prices from the generator)
    "q64": """
with cs_ui as (
  select cs_item_sk,
         sum(cs_ext_list_price) as sale,
         sum(cr_refunded_cash + cr_store_credit) as refund
  from catalog_sales, catalog_returns
  where cs_item_sk = cr_item_sk
    and cs_order_number = cr_order_number
  group by cs_item_sk
  having sum(cs_ext_list_price)
         > 2 * sum(cr_refunded_cash + cr_store_credit)),
cross_sales as (
  select i_product_name as product_name, i_item_sk as item_sk,
         s_store_name as store_name, s_zip as store_zip,
         ad1.ca_address_id as b_street_number,
         ad1.ca_city as b_city, ad1.ca_zip as b_zip,
         ad2.ca_address_id as c_street_number,
         ad2.ca_city as c_city, ad2.ca_zip as c_zip,
         d1.d_year as syear, count(*) as cnt,
         sum(ss_wholesale_cost) as s1, sum(ss_list_price) as s2,
         sum(ss_coupon_amt) as s3
  from store_sales, store_returns, cs_ui, date_dim d1, store, customer,
       customer_demographics cd1, customer_demographics cd2, promotion,
       household_demographics hd1, household_demographics hd2,
       customer_address ad1, customer_address ad2, income_band ib1,
       income_band ib2, item
  where ss_store_sk = s_store_sk
    and ss_sold_date_sk = d1.d_date_sk
    and ss_item_sk = i_item_sk
    and ss_customer_sk = c_customer_sk
    and ss_cdemo_sk = cd1.cd_demo_sk
    and ss_hdemo_sk = hd1.hd_demo_sk
    and ss_addr_sk = ad1.ca_address_sk
    and ss_item_sk = sr_item_sk
    and ss_ticket_number = sr_ticket_number
    and ss_item_sk = cs_ui.cs_item_sk
    and c_current_cdemo_sk = cd2.cd_demo_sk
    and c_current_hdemo_sk = hd2.hd_demo_sk
    and c_current_addr_sk = ad2.ca_address_sk
    and ss_promo_sk = p_promo_sk
    and hd1.hd_income_band_sk = ib1.ib_income_band_sk
    and hd2.hd_income_band_sk = ib2.ib_income_band_sk
    and cd1.cd_marital_status <> cd2.cd_marital_status
    and i_current_price between 10 and 70
  group by i_product_name, i_item_sk, s_store_name, s_zip,
           ad1.ca_address_id, ad1.ca_city, ad1.ca_zip,
           ad2.ca_address_id, ad2.ca_city, ad2.ca_zip, d1.d_year)
select cs1.product_name, cs1.store_name, cs1.store_zip,
       cs1.b_street_number, cs1.b_city, cs1.b_zip, cs1.c_street_number,
       cs1.c_city, cs1.c_zip, cs1.syear, cs1.cnt, cs1.s1, cs1.s2, cs1.s3,
       cs2.s1 as s1_2, cs2.s2 as s2_2, cs2.s3 as s3_2, cs2.syear as syear2,
       cs2.cnt as cnt2
from cross_sales cs1, cross_sales cs2
where cs1.item_sk = cs2.item_sk
  and cs1.syear = 1999
  and cs2.syear = 2000
  and cs2.cnt <= cs1.cnt
  and cs1.store_name = cs2.store_name
  and cs1.store_zip = cs2.store_zip
order by cs1.product_name, cs1.store_name, cs2.cnt, cs1.b_zip, cs1.c_zip,
         cs2.s1
limit 100
""",
})
