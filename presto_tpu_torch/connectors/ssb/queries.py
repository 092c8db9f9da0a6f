"""The 13 SSB queries (flights Q1-Q4) plus LIKE/substring variants.

A copy of ``presto_tpu/connectors/ssb/queries.py``. The port runs all
of them: flight Q1 on the fused leaf route, flights Q2-Q4 through its
joins and keyed aggregation (``q3_3`` onward filter with OR), and
``q_like_part`` / ``q_like_phone`` (the LIKE and substring predicates,
on the port's string kernels).

From the public SSB spec (O'Neil et al.); predicate constants follow
the spec. The two extra ``q_like_*`` queries are the SURVEY config-5
shape: LIKE/substring predicates over byte columns, served by the
Pallas string kernels on TPU.
"""

QUERIES = {
    "q1_1": """
select sum(lo_extendedprice * lo_discount) as revenue
from lineorder, date
where lo_orderdate = d_datekey
  and d_year = 1993
  and lo_discount between 1 and 3
  and lo_quantity < 25
""",
    "q1_2": """
select sum(lo_extendedprice * lo_discount) as revenue
from lineorder, date
where lo_orderdate = d_datekey
  and d_yearmonthnum = 199401
  and lo_discount between 4 and 6
  and lo_quantity between 26 and 35
""",
    "q1_3": """
select sum(lo_extendedprice * lo_discount) as revenue
from lineorder, date
where lo_orderdate = d_datekey
  and d_weeknuminyear = 6
  and d_year = 1994
  and lo_discount between 5 and 7
  and lo_quantity between 26 and 35
""",
    "q2_1": """
select sum(lo_revenue) as revenue, d_year, p_brand1
from lineorder, date, part, supplier
where lo_orderdate = d_datekey
  and lo_partkey = p_partkey
  and lo_suppkey = s_suppkey
  and p_category = 'MFGR#12'
  and s_region = 'AMERICA'
group by d_year, p_brand1
order by d_year, p_brand1
""",
    "q2_2": """
select sum(lo_revenue) as revenue, d_year, p_brand1
from lineorder, date, part, supplier
where lo_orderdate = d_datekey
  and lo_partkey = p_partkey
  and lo_suppkey = s_suppkey
  and p_brand1 between 'MFGR#2221' and 'MFGR#2228'
  and s_region = 'ASIA'
group by d_year, p_brand1
order by d_year, p_brand1
""",
    "q2_3": """
select sum(lo_revenue) as revenue, d_year, p_brand1
from lineorder, date, part, supplier
where lo_orderdate = d_datekey
  and lo_partkey = p_partkey
  and lo_suppkey = s_suppkey
  and p_brand1 = 'MFGR#2239'
  and s_region = 'EUROPE'
group by d_year, p_brand1
order by d_year, p_brand1
""",
    "q3_1": """
select c_nation, s_nation, d_year, sum(lo_revenue) as revenue
from customer, lineorder, supplier, date
where lo_custkey = c_custkey
  and lo_suppkey = s_suppkey
  and lo_orderdate = d_datekey
  and c_region = 'ASIA'
  and s_region = 'ASIA'
  and d_year >= 1992 and d_year <= 1997
group by c_nation, s_nation, d_year
order by d_year asc, revenue desc
""",
    "q3_2": """
select c_city, s_city, d_year, sum(lo_revenue) as revenue
from customer, lineorder, supplier, date
where lo_custkey = c_custkey
  and lo_suppkey = s_suppkey
  and lo_orderdate = d_datekey
  and c_nation = 'UNITED STATES'
  and s_nation = 'UNITED STATES'
  and d_year >= 1992 and d_year <= 1997
group by c_city, s_city, d_year
order by d_year asc, revenue desc
""",
    "q3_3": """
select c_city, s_city, d_year, sum(lo_revenue) as revenue
from customer, lineorder, supplier, date
where lo_custkey = c_custkey
  and lo_suppkey = s_suppkey
  and lo_orderdate = d_datekey
  and (c_city = 'UNITED KI1' or c_city = 'UNITED KI5')
  and (s_city = 'UNITED KI1' or s_city = 'UNITED KI5')
  and d_year >= 1992 and d_year <= 1997
group by c_city, s_city, d_year
order by d_year asc, revenue desc
""",
    "q3_4": """
select c_city, s_city, d_year, sum(lo_revenue) as revenue
from customer, lineorder, supplier, date
where lo_custkey = c_custkey
  and lo_suppkey = s_suppkey
  and lo_orderdate = d_datekey
  and (c_city = 'UNITED KI1' or c_city = 'UNITED KI5')
  and (s_city = 'UNITED KI1' or s_city = 'UNITED KI5')
  and d_yearmonth = 'Dec1997'
group by c_city, s_city, d_year
order by d_year asc, revenue desc
""",
    "q4_1": """
select d_year, c_nation, sum(lo_revenue - lo_supplycost) as profit
from date, customer, supplier, part, lineorder
where lo_custkey = c_custkey
  and lo_suppkey = s_suppkey
  and lo_partkey = p_partkey
  and lo_orderdate = d_datekey
  and c_region = 'AMERICA'
  and s_region = 'AMERICA'
  and (p_mfgr = 'MFGR#1' or p_mfgr = 'MFGR#2')
group by d_year, c_nation
order by d_year, c_nation
""",
    "q4_2": """
select d_year, s_nation, p_category, sum(lo_revenue - lo_supplycost) as profit
from date, customer, supplier, part, lineorder
where lo_custkey = c_custkey
  and lo_suppkey = s_suppkey
  and lo_partkey = p_partkey
  and lo_orderdate = d_datekey
  and c_region = 'AMERICA'
  and s_region = 'AMERICA'
  and (d_year = 1997 or d_year = 1998)
  and (p_mfgr = 'MFGR#1' or p_mfgr = 'MFGR#2')
group by d_year, s_nation, p_category
order by d_year, s_nation, p_category
""",
    "q4_3": """
select d_year, s_city, p_brand1, sum(lo_revenue - lo_supplycost) as profit
from date, customer, supplier, part, lineorder
where lo_custkey = c_custkey
  and lo_suppkey = s_suppkey
  and lo_partkey = p_partkey
  and lo_orderdate = d_datekey
  and s_nation = 'UNITED STATES'
  and (d_year = 1997 or d_year = 1998)
  and p_category = 'MFGR#14'
group by d_year, s_city, p_brand1
order by d_year, s_city, p_brand1
""",
    # config-5 shapes: LIKE / substring over byte columns (Pallas path)
    "q_like_part": """
select count(*) as cnt, sum(lo_revenue) as revenue
from lineorder, part
where lo_partkey = p_partkey
  and p_name like '%sky%'
""",
    "q_like_phone": """
select c_region, count(*) as cnt
from customer, lineorder
where lo_custkey = c_custkey
  and c_name like 'Customer%1'
  and substring(c_phone, 1, 2) <> '33'
group by c_region
order by c_region
""",
}
