"""TPC-DS schema: tables, types, value domains, row counts.

A copy of ``presto_tpu/connectors/tpcds/schema.py`` (the port imports
nothing of the JAX package); keep the two identical. ``table_dicts``
hands out the module's one ``Dictionary`` per column on every call:
VARCHAR comparisons across scans check dictionary identity.

Reference parity: ``presto-tpcds`` (``TpcdsMetadata`` over the
``com.teradata.tpcds`` row generator) [SURVEY §2.2; reference tree
unavailable, paths reconstructed]. Domains follow the public TPC-DS
v3 specification (dsdgen *semantics*, not dsdgen code — values are
deterministic but not byte-identical to dsdgen's RNG stream).

Modeled subset: the star-schema core that TPC-DS queries revolve
around — three sales channels (store_sales, catalog_sales, web_sales)
plus the dimensions date_dim, item, customer, customer_address,
customer_demographics, household_demographics, store, promotion.
The two demographics tables are pure cross-products of their attribute
domains (no RNG at all), exactly as in dsdgen.

Encoding rules (same as the TPC-H connector): low/mid-cardinality
strings are ordered-dictionary VARCHAR; identifier/free-text strings
are fixed-width BYTES. Fact-table FK columns carry NULLs (a few
percent, as in dsdgen) — the engine's validity masks are exercised by
every join over them.
"""

from __future__ import annotations

import numpy as np

from presto_tpu_torch.batch import Dictionary
from presto_tpu_torch.types import (
    BIGINT,
    DATE,
    INTEGER,
    DataType,
    decimal,
    fixed_bytes,
    varchar,
)

# ---------------------------------------------------------------------------
# Value domains (TPC-DS spec word lists)
# ---------------------------------------------------------------------------

GENDERS = ["F", "M"]
MARITAL = ["D", "M", "S", "U", "W"]
EDUCATION = [
    "Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree",
    "Advanced Degree", "Unknown",
]
CREDIT_RATINGS = ["Good", "High Risk", "Low Risk", "Unknown"]
BUY_POTENTIALS = ["0-500", "501-1000", "1001-5000", "5001-10000", ">10000", "Unknown"]

# cross-product cardinalities (dsdgen: customer_demographics = 1920800)
CD_PURCHASE_BANDS = 20  # purchase_estimate in {500,1000,...,10000}
CD_DEP_COUNTS = 7  # 0..6
HD_INCOME_BANDS = 20
HD_DEP_COUNTS = 10  # 0..9
HD_VEHICLES = 6  # -1..4

CATEGORIES = [
    "Books", "Children", "Electronics", "Home", "Jewelry",
    "Men", "Music", "Shoes", "Sports", "Women",
]
# classes: distinct per category in dsdgen; modeled as a flat list of
# category-qualified class names (cardinality ~5 per category)
CLASS_SYLL = ["accent", "classical", "estate", "infants", "pants"]
CLASSES = [f"{c.lower()}-{s}" for c in CATEGORIES for s in CLASS_SYLL]

ITEM_SIZES = ["N/A", "economy", "extra large", "large", "medium", "petite", "small"]
ITEM_UNITS = [
    "Box", "Bunch", "Bundle", "Carton", "Case", "Cup", "Dozen", "Dram",
    "Each", "Gram", "Gross", "Lb", "N/A", "Ounce", "Oz", "Pallet",
    "Pound", "Tbl", "Ton", "Tsp", "Unknown",
]
ITEM_COLORS = (
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

# brand names: "<maker-syllable><brand-syllable> #N" — ~500 distinct,
# dictionary-encoded (queries group by i_brand + i_brand_id)
BRAND_SYLL1 = ["amalg", "edu pack", "exporti", "importo", "scholar",
               "brand", "corp", "maxi", "univ", "nameless"]
BRAND_SYLL2 = ["amalg", "exporti", "importo", "edu pack", "scholar"]
N_BRANDS_PER = 10
BRANDS = [
    f"{a}{b} #{i}"
    for a in BRAND_SYLL1
    for b in BRAND_SYLL2
    for i in range(1, N_BRANDS_PER + 1)
]

STORE_NAMES = ["able", "anti", "bar", "cally", "ation", "eing", "ese", "ought"]
COMPANY_NAMES = ["Unknown"]
STORE_HOURS = ["8AM-12AM", "8AM-4PM", "8AM-8AM"]
STATES = (
    "AK AL AR AZ CA CO CT DE FL GA HI IA ID IL IN KS KY LA MA MD ME MI MN "
    "MO MS MT NC ND NE NH NJ NM NV NY OH OK OR PA RI SC SD TN TX UT VA VT "
    "WA WI WV WY"
).split()
COUNTIES = [
    "Ziebach County", "Williamson County", "Walker County", "Salem County",
    "Richland County", "Mobile County", "Maricopa County", "Luce County",
    "Kittitas County", "Huron County", "Franklin Parish", "Fairfield County",
    "Daviess County", "Bronx County", "Barrow County", "Arthur County",
]
COUNTRIES = ["United States"]
DAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
             "Friday", "Saturday"]
YN = ["N", "Y"]

COMMENT_WORDS = (
    "furiously quickly carefully slyly blithely fluffily express final bold "
    "regular unusual pending ironic silent daring even special packages "
    "requests deposits accounts instructions patterns forges braids realms "
    "about above according across after against along among around before "
    "between into like near of upon the waters nag integrate boost affix "
    "detect cajole"
).split()

SALUTATIONS = ["Dr.", "Miss", "Mr.", "Mrs.", "Ms.", "Sir"]

# dsdgen reason word list (abbreviated to the spec's reason shapes)
REASONS = [
    "Package was damaged", "Stopped working", "Did not get it on time",
    "Not the product that was ordred", "Parts missing",
    "Does not work with a product that I have", "Gift exchange",
    "Did not like the color", "Did not like the model", "Did not fit",
    "Wrong size", "Lost my job", "unauthoized purchase", "Found a better price",
    "Not working any more", "No service location in my area",
    "Did not like the warranty", "Did not believe the warranty",
    "duplicate purchase", "its is a boy", "its is a girl", "reason 22",
    "reason 23", "reason 24", "reason 25", "reason 26", "reason 27",
    "reason 28", "reason 29", "reason 30", "reason 31", "reason 32",
    "reason 33", "reason 34", "reason 35",
]

SHIP_MODE_TYPES = ["EXPRESS", "LIBRARY", "NEXT DAY", "OVERNIGHT",
                   "REGULAR", "TWO DAY"]
SHIP_MODE_CODES = ["AIR", "SURFACE", "SEA"]
SHIP_CARRIERS = [
    "UPS", "FEDEX", "AIRBORNE", "USPS", "DHL", "TBS", "ZHOU", "ZOUROS",
    "MSC", "LATVIAN", "ALLIANCE", "ORIENTAL", "BARIAN", "BOXBUNDLES",
    "HARMSTORF", "PRIVATECARRIER", "DIAMOND", "RUPEKSA", "GERMA", "GREAT EASTERN",
]

CC_NAMES = ["NY Metro", "Mid Atlantic", "Pacific Northwest", "North Midwest",
            "California", "New England"]
WEB_COMPANY_NAMES = ["pri", "able", "ese", "anti", "cally", "ation"]
WEB_PAGE_TYPES = ["ad", "dynamic", "feedback", "general", "order", "protected",
                  "welcome"]
AM_PM = ["AM", "PM"]
SHIFTS = ["first", "second", "third"]
SUB_SHIFTS = ["morning", "afternoon", "evening", "night"]
MEAL_TIMES = ["", "breakfast", "lunch", "dinner"]

# ---------------------------------------------------------------------------
# date_dim span: 1900-01-01 .. 2100-01-01 (dsdgen), julian-numbered sks
# ---------------------------------------------------------------------------

DATE_DIM_ROWS = 73049
#: d_date_sk of 1900-01-01 (julian day number, as in dsdgen:
#: 2450815 = 1998-01-01 -> 1900-01-01 = 2415021)
DATE_SK_BASE = 2415021
#: days from 1970-01-01 back to 1900-01-01
EPOCH_1900_OFFSET = -25567

#: fact sales dates span [1998-01-02, 2002-12-30] (dsdgen: 5 years)
SALES_DATE_LO = 10228  # 1998-01-02 as days since 1970-01-01
SALES_DATE_HI = 12051  # 2002-12-30


def date_to_sk(days_since_epoch):
    """days since 1970-01-01 -> d_date_sk (julian)."""
    return np.asarray(days_since_epoch) - EPOCH_1900_OFFSET + DATE_SK_BASE


# ---------------------------------------------------------------------------
# Shared dictionaries
# ---------------------------------------------------------------------------

DICTS = {
    "cd_gender": Dictionary(GENDERS),
    "cd_marital_status": Dictionary(MARITAL),
    "cd_education_status": Dictionary(EDUCATION),
    "cd_credit_rating": Dictionary(CREDIT_RATINGS),
    "hd_buy_potential": Dictionary(BUY_POTENTIALS),
    "i_category": Dictionary(CATEGORIES),
    "i_class": Dictionary(CLASSES),
    "i_size": Dictionary(ITEM_SIZES),
    "i_units": Dictionary(ITEM_UNITS),
    "i_color": Dictionary(ITEM_COLORS),
    "i_brand": Dictionary(BRANDS),
    "s_store_name": Dictionary(STORE_NAMES),
    "s_company_name": Dictionary(COMPANY_NAMES),
    "s_hours": Dictionary(STORE_HOURS),
    "s_state": Dictionary(STATES),
    "s_county": Dictionary(COUNTIES),
    "ca_state": Dictionary(STATES),
    "ca_county": Dictionary(COUNTIES),
    "ca_country": Dictionary(COUNTRIES),
    "ca_location_type": Dictionary(["apartment", "condo", "single family"]),
    "d_day_name": Dictionary(DAY_NAMES),
    "p_channel_dmail": Dictionary(YN),
    "p_channel_email": Dictionary(YN),
    "p_channel_tv": Dictionary(YN),
    "p_channel_event": Dictionary(YN),
    "p_discount_active": Dictionary(YN),
    "c_salutation": Dictionary(SALUTATIONS),
    "c_preferred_cust_flag": Dictionary(YN),
    "w_warehouse_name": Dictionary(
        [f"Warehouse #{i}" for i in range(1, 31)]
    ),
    "w_city": Dictionary(["Fairview", "Midway", "Oak Grove", "Five Points",
                          "Centerville"]),
    "w_county": Dictionary(COUNTIES),
    "w_state": Dictionary(STATES),
    "w_country": Dictionary(COUNTRIES),
    "r_reason_desc": Dictionary(REASONS),
    "sm_type": Dictionary(SHIP_MODE_TYPES),
    "sm_code": Dictionary(SHIP_MODE_CODES),
    "sm_carrier": Dictionary(SHIP_CARRIERS),
    "cc_name": Dictionary(CC_NAMES),
    "cc_county": Dictionary(COUNTIES),
    "cc_state": Dictionary(STATES),
    "web_name": Dictionary([f"site_{i}" for i in range(30)]),
    "web_company_name": Dictionary(WEB_COMPANY_NAMES),
    "wp_type": Dictionary(WEB_PAGE_TYPES),
    "t_am_pm": Dictionary(AM_PM),
    "t_shift": Dictionary(SHIFTS),
    "t_sub_shift": Dictionary(SUB_SHIFTS),
    "t_meal_time": Dictionary(MEAL_TIMES),
}

# ---------------------------------------------------------------------------
# Table schemas
# ---------------------------------------------------------------------------

TABLES: dict[str, dict[str, DataType]] = {
    "date_dim": {
        "d_date_sk": BIGINT,
        "d_date_id": fixed_bytes(16),
        "d_date": DATE,
        "d_month_seq": INTEGER,
        "d_week_seq": INTEGER,
        "d_quarter_seq": INTEGER,
        "d_year": INTEGER,
        "d_dow": INTEGER,
        "d_moy": INTEGER,
        "d_dom": INTEGER,
        "d_qoy": INTEGER,
        "d_day_name": varchar(),
    },
    "item": {
        "i_item_sk": BIGINT,
        "i_item_id": fixed_bytes(16),
        "i_item_desc": fixed_bytes(100),
        "i_current_price": decimal(7, 2),
        "i_wholesale_cost": decimal(7, 2),
        "i_brand_id": INTEGER,
        "i_brand": varchar(),
        "i_class_id": INTEGER,
        "i_class": varchar(),
        "i_category_id": INTEGER,
        "i_category": varchar(),
        "i_manufact_id": INTEGER,
        "i_manufact": fixed_bytes(50),
        "i_size": varchar(),
        "i_color": varchar(),
        "i_units": varchar(),
        "i_manager_id": INTEGER,
        "i_product_name": fixed_bytes(50),
    },
    "customer": {
        "c_customer_sk": BIGINT,
        "c_customer_id": fixed_bytes(16),
        "c_current_cdemo_sk": BIGINT,
        "c_current_hdemo_sk": BIGINT,
        "c_current_addr_sk": BIGINT,
        "c_salutation": varchar(),
        "c_preferred_cust_flag": varchar(),
        "c_first_name": fixed_bytes(20),
        "c_last_name": fixed_bytes(30),
        "c_birth_year": INTEGER,
        "c_birth_month": INTEGER,
        "c_email_address": fixed_bytes(50),
    },
    "warehouse": {
        "w_warehouse_sk": BIGINT,
        "w_warehouse_id": fixed_bytes(16),
        "w_warehouse_name": varchar(),
        "w_warehouse_sq_ft": INTEGER,
        "w_city": varchar(),
        "w_county": varchar(),
        "w_state": varchar(),
        "w_country": varchar(),
        "w_gmt_offset": decimal(5, 2),
    },
    "reason": {
        "r_reason_sk": BIGINT,
        "r_reason_id": fixed_bytes(16),
        "r_reason_desc": varchar(),
    },
    "ship_mode": {
        "sm_ship_mode_sk": BIGINT,
        "sm_ship_mode_id": fixed_bytes(16),
        "sm_type": varchar(),
        "sm_code": varchar(),
        "sm_carrier": varchar(),
    },
    "income_band": {
        "ib_income_band_sk": BIGINT,
        "ib_lower_bound": INTEGER,
        "ib_upper_bound": INTEGER,
    },
    "call_center": {
        "cc_call_center_sk": BIGINT,
        "cc_call_center_id": fixed_bytes(16),
        "cc_name": varchar(),
        "cc_manager": fixed_bytes(40),
        "cc_mkt_id": INTEGER,
        "cc_county": varchar(),
        "cc_state": varchar(),
    },
    "web_site": {
        "web_site_sk": BIGINT,
        "web_site_id": fixed_bytes(16),
        "web_name": varchar(),
        "web_company_name": varchar(),
        "web_manager": fixed_bytes(40),
    },
    "web_page": {
        "wp_web_page_sk": BIGINT,
        "wp_web_page_id": fixed_bytes(16),
        "wp_char_count": INTEGER,
        "wp_link_count": INTEGER,
        "wp_type": varchar(),
    },
    "time_dim": {
        "t_time_sk": BIGINT,
        "t_time_id": fixed_bytes(16),
        "t_time": INTEGER,
        "t_hour": INTEGER,
        "t_minute": INTEGER,
        "t_second": INTEGER,
        "t_am_pm": varchar(),
        "t_shift": varchar(),
        "t_sub_shift": varchar(),
        "t_meal_time": varchar(),
    },
    "inventory": {
        "inv_date_sk": BIGINT,
        "inv_item_sk": BIGINT,
        "inv_warehouse_sk": BIGINT,
        "inv_quantity_on_hand": INTEGER,
    },
    "customer_address": {
        "ca_address_sk": BIGINT,
        "ca_address_id": fixed_bytes(16),
        "ca_city": fixed_bytes(20),
        "ca_county": varchar(),
        "ca_state": varchar(),
        "ca_zip": fixed_bytes(10),
        "ca_country": varchar(),
        "ca_gmt_offset": decimal(5, 2),
        "ca_location_type": varchar(),
    },
    "customer_demographics": {
        "cd_demo_sk": BIGINT,
        "cd_gender": varchar(),
        "cd_marital_status": varchar(),
        "cd_education_status": varchar(),
        "cd_purchase_estimate": INTEGER,
        "cd_credit_rating": varchar(),
        "cd_dep_count": INTEGER,
        "cd_dep_employed_count": INTEGER,
        "cd_dep_college_count": INTEGER,
    },
    "household_demographics": {
        "hd_demo_sk": BIGINT,
        "hd_income_band_sk": BIGINT,
        "hd_buy_potential": varchar(),
        "hd_dep_count": INTEGER,
        "hd_vehicle_count": INTEGER,
    },
    "store": {
        "s_store_sk": BIGINT,
        "s_store_id": fixed_bytes(16),
        "s_store_name": varchar(),
        "s_number_employees": INTEGER,
        "s_floor_space": INTEGER,
        "s_hours": varchar(),
        "s_manager": fixed_bytes(40),
        "s_market_id": INTEGER,
        "s_company_id": INTEGER,
        "s_company_name": varchar(),
        "s_city": fixed_bytes(20),
        "s_county": varchar(),
        "s_state": varchar(),
        "s_zip": fixed_bytes(10),
        "s_gmt_offset": decimal(5, 2),
    },
    "promotion": {
        "p_promo_sk": BIGINT,
        "p_promo_id": fixed_bytes(16),
        "p_start_date_sk": BIGINT,
        "p_end_date_sk": BIGINT,
        "p_item_sk": BIGINT,
        "p_cost": decimal(15, 2),
        "p_response_target": INTEGER,
        "p_promo_name": fixed_bytes(50),
        "p_channel_dmail": varchar(),
        "p_channel_email": varchar(),
        "p_channel_tv": varchar(),
        "p_channel_event": varchar(),
        "p_discount_active": varchar(),
    },
    "store_sales": {
        "ss_sold_date_sk": BIGINT,
        "ss_sold_time_sk": BIGINT,
        "ss_item_sk": BIGINT,
        "ss_customer_sk": BIGINT,
        "ss_cdemo_sk": BIGINT,
        "ss_hdemo_sk": BIGINT,
        "ss_addr_sk": BIGINT,
        "ss_store_sk": BIGINT,
        "ss_promo_sk": BIGINT,
        "ss_ticket_number": BIGINT,
        "ss_quantity": INTEGER,
        "ss_wholesale_cost": decimal(7, 2),
        "ss_list_price": decimal(7, 2),
        "ss_sales_price": decimal(7, 2),
        "ss_ext_discount_amt": decimal(12, 2),
        "ss_ext_sales_price": decimal(12, 2),
        "ss_ext_wholesale_cost": decimal(12, 2),
        "ss_ext_list_price": decimal(12, 2),
        "ss_ext_tax": decimal(12, 2),
        "ss_coupon_amt": decimal(12, 2),
        "ss_net_paid": decimal(12, 2),
        "ss_net_paid_inc_tax": decimal(12, 2),
        "ss_net_profit": decimal(12, 2),
    },
    "catalog_sales": {
        "cs_sold_date_sk": BIGINT,
        "cs_sold_time_sk": BIGINT,
        "cs_ship_date_sk": BIGINT,
        "cs_item_sk": BIGINT,
        "cs_bill_customer_sk": BIGINT,
        "cs_ship_customer_sk": BIGINT,
        "cs_bill_cdemo_sk": BIGINT,
        "cs_ship_addr_sk": BIGINT,
        "cs_call_center_sk": BIGINT,
        "cs_ship_mode_sk": BIGINT,
        "cs_warehouse_sk": BIGINT,
        "cs_promo_sk": BIGINT,
        "cs_order_number": BIGINT,
        "cs_quantity": INTEGER,
        "cs_wholesale_cost": decimal(7, 2),
        "cs_list_price": decimal(7, 2),
        "cs_sales_price": decimal(7, 2),
        "cs_ext_discount_amt": decimal(12, 2),
        "cs_ext_sales_price": decimal(12, 2),
        "cs_ext_wholesale_cost": decimal(12, 2),
        "cs_ext_list_price": decimal(12, 2),
        "cs_coupon_amt": decimal(12, 2),
        "cs_net_paid": decimal(12, 2),
        "cs_net_profit": decimal(12, 2),
    },
    "web_sales": {
        "ws_sold_date_sk": BIGINT,
        "ws_sold_time_sk": BIGINT,
        "ws_ship_date_sk": BIGINT,
        "ws_item_sk": BIGINT,
        "ws_bill_customer_sk": BIGINT,
        "ws_ship_customer_sk": BIGINT,
        "ws_ship_addr_sk": BIGINT,
        "ws_web_page_sk": BIGINT,
        "ws_web_site_sk": BIGINT,
        "ws_ship_mode_sk": BIGINT,
        "ws_warehouse_sk": BIGINT,
        "ws_promo_sk": BIGINT,
        "ws_order_number": BIGINT,
        "ws_quantity": INTEGER,
        "ws_wholesale_cost": decimal(7, 2),
        "ws_list_price": decimal(7, 2),
        "ws_sales_price": decimal(7, 2),
        "ws_ext_discount_amt": decimal(12, 2),
        "ws_ext_sales_price": decimal(12, 2),
        "ws_ext_wholesale_cost": decimal(12, 2),
        "ws_ext_list_price": decimal(12, 2),
        "ws_coupon_amt": decimal(12, 2),
        "ws_net_paid": decimal(12, 2),
        "ws_net_profit": decimal(12, 2),
    },
    "store_returns": {
        "sr_returned_date_sk": BIGINT,
        "sr_item_sk": BIGINT,
        "sr_customer_sk": BIGINT,
        "sr_cdemo_sk": BIGINT,
        "sr_hdemo_sk": BIGINT,
        "sr_addr_sk": BIGINT,
        "sr_store_sk": BIGINT,
        "sr_reason_sk": BIGINT,
        "sr_ticket_number": BIGINT,
        "sr_return_quantity": INTEGER,
        "sr_return_amt": decimal(12, 2),
        "sr_return_tax": decimal(12, 2),
        "sr_fee": decimal(7, 2),
        "sr_return_ship_cost": decimal(12, 2),
        "sr_refunded_cash": decimal(12, 2),
        "sr_store_credit": decimal(12, 2),
        "sr_net_loss": decimal(12, 2),
    },
    "catalog_returns": {
        "cr_returned_date_sk": BIGINT,
        "cr_item_sk": BIGINT,
        "cr_refunded_customer_sk": BIGINT,
        "cr_returning_customer_sk": BIGINT,
        "cr_returning_addr_sk": BIGINT,
        "cr_call_center_sk": BIGINT,
        "cr_reason_sk": BIGINT,
        "cr_order_number": BIGINT,
        "cr_return_quantity": INTEGER,
        "cr_return_amount": decimal(12, 2),
        "cr_return_tax": decimal(12, 2),
        "cr_fee": decimal(7, 2),
        "cr_return_ship_cost": decimal(12, 2),
        "cr_refunded_cash": decimal(12, 2),
        "cr_store_credit": decimal(12, 2),
        "cr_net_loss": decimal(12, 2),
    },
    "web_returns": {
        "wr_returned_date_sk": BIGINT,
        "wr_item_sk": BIGINT,
        "wr_refunded_customer_sk": BIGINT,
        "wr_refunded_cdemo_sk": BIGINT,
        "wr_refunded_addr_sk": BIGINT,
        "wr_returning_customer_sk": BIGINT,
        "wr_returning_cdemo_sk": BIGINT,
        "wr_reason_sk": BIGINT,
        "wr_order_number": BIGINT,
        "wr_return_quantity": INTEGER,
        "wr_return_amt": decimal(12, 2),
        "wr_return_tax": decimal(12, 2),
        "wr_fee": decimal(7, 2),
        "wr_return_ship_cost": decimal(12, 2),
        "wr_refunded_cash": decimal(12, 2),
        "wr_net_loss": decimal(12, 2),
    },
}

UNIQUE_KEYS: dict[str, tuple[tuple[str, ...], ...]] = {
    "date_dim": (("d_date_sk",), ("d_date_id",), ("d_date",)),
    "item": (("i_item_sk",), ("i_item_id",)),
    "customer": (("c_customer_sk",), ("c_customer_id",)),
    "customer_address": (("ca_address_sk",),),
    "customer_demographics": (("cd_demo_sk",),),
    "household_demographics": (("hd_demo_sk",),),
    "store": (("s_store_sk",), ("s_store_id",)),
    "promotion": (("p_promo_sk",), ("p_promo_id",)),
    "store_sales": (),
    "catalog_sales": (),
    "web_sales": (),
    "store_returns": (),
    "catalog_returns": (),
    "web_returns": (),
    "warehouse": (("w_warehouse_sk",), ("w_warehouse_id",)),
    "reason": (("r_reason_sk",), ("r_reason_id",)),
    "ship_mode": (("sm_ship_mode_sk",), ("sm_ship_mode_id",)),
    "income_band": (("ib_income_band_sk",),),
    "call_center": (("cc_call_center_sk",), ("cc_call_center_id",)),
    "web_site": (("web_site_sk",), ("web_site_id",)),
    "web_page": (("wp_web_page_sk",), ("wp_web_page_id",)),
    "time_dim": (("t_time_sk",), ("t_time_id",), ("t_time",)),
    "inventory": (),
}


#: declared functional dependencies (generator invariants): a
#: determined column may ride grouped queries as a passenger of its
#: determinant (reference: dsdgen's id<->name pairing).
FUNC_DEPS: dict[str, dict[str, tuple[str, ...]]] = {
    "item": {
        "i_brand": ("i_brand_id",),
        "i_manufact": ("i_manufact_id",),
        "i_class": ("i_class_id",),
        "i_category": ("i_category_id",),
    },
    "date_dim": {
        "d_day_name": ("d_dow",),
    },
}


def table_dicts(table: str) -> dict[str, Dictionary]:
    return {c: DICTS[c] for c in TABLES[table] if c in DICTS}


#: probability a sales row has a return (dsdgen ratio ~10%)
RETURN_FRACTION = 0.1
#: inventory snapshot cadence: weekly over the sales span (261 weeks)
INVENTORY_WEEKS = (SALES_DATE_HI - SALES_DATE_LO) // 7 + 1

#: base rows per unit scale factor (facts scale linearly; dims follow
#: dsdgen's SF1 counts; demographics/date_dim are fixed)
ROWS_PER_SF = {
    "store_sales": 2_880_000,
    "catalog_sales": 1_440_000,
    "web_sales": 720_000,
    "customer": 100_000,
    "customer_address": 50_000,
    "item": 18_000,
    "store": 12,
    "promotion": 300,
    "warehouse": 5,
    "call_center": 6,
    "web_site": 30,
    "web_page": 60,
}

FIXED_ROWS = {
    "date_dim": DATE_DIM_ROWS,
    "customer_demographics": 2 * 5 * 7 * CD_PURCHASE_BANDS * 4 * CD_DEP_COUNTS
    * CD_DEP_COUNTS * CD_DEP_COUNTS,  # 1_920_800
    "household_demographics": HD_INCOME_BANDS * len(BUY_POTENTIALS)
    * HD_DEP_COUNTS * HD_VEHICLES,  # 7200
    "reason": len(REASONS),
    "ship_mode": 20,
    "income_band": HD_INCOME_BANDS,
    "time_dim": 86_400,
}

#: returns ride their parent sales table's chunk decomposition
#: (lineitem-style stream consistency): generation units ARE parent rows
RETURN_PARENT = {
    "store_returns": "store_sales",
    "catalog_returns": "catalog_sales",
    "web_returns": "web_sales",
}


def row_count(table: str, sf: float) -> int:
    if table in FIXED_ROWS:
        return FIXED_ROWS[table]
    if table in RETURN_PARENT:
        return max(1, int(row_count(RETURN_PARENT[table], sf) * RETURN_FRACTION))
    if table == "inventory":
        return INVENTORY_WEEKS * row_count("item", sf) * row_count("warehouse", sf)
    base = ROWS_PER_SF[table]
    mins = {"item": 102, "store": 4, "promotion": 3, "customer": 100,
            "customer_address": 50, "warehouse": 3, "call_center": 2,
            "web_site": 2, "web_page": 4}
    return max(int(base * sf), mins.get(table, 1))
