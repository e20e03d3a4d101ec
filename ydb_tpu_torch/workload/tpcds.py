"""TPC-DS workload: deterministic generator + query set + canonical
answers (BASELINE config 5; reference ships the dsdgen-compatible
generator and queries under ydb/library/workload/tpcds/ and
ydb/library/benchmarks/queries/tpcds/, run via `ydb workload tpcds` —
ydb_cli/commands/ydb_benchmark.cpp).

The schema is the subset of TPC-DS's 24 tables that the implemented
queries touch: the store_sales / catalog_sales / web_sales / inventory
fact tables plus the date_dim, item, store, time_dim, promotion,
customer, customer_address, customer_demographics,
household_demographics, warehouse, ship_mode and call_center
dimensions, with dsdgen's column domains (julian-numbered date
surrogate keys, brand/manufact naming, syllable store names,
gender x marital x education demographics cross product). Money
columns are decimal(2) scaled int64 like the TPC-H generator.

Queries follow 70 official templates (q1, q2, q3, q4, q6, q7, q9,
q10, q11, q12, q13, q15, q16, q17, q18, q19, q20, q21, q22, q25, q26,
q27, q29, q30, q31, q32, q33, q34, q35, q36, q37, q38, q39, q40, q42,
q43, q44, q45, q46, q48, q50, q52, q53, q55, q56, q60, q61, q62, q63,
q65, q67, q68, q69, q70, q71, q73, q74, q79, q81, q82, q86, q88, q89,
q91, q92, q93, q94, q96, q98, q99). q10/q35 run EXISTS plus an OR of
EXISTS (counting decorrelation). q44/q67/q70 run REAL ranking window functions
(rank / row_number over partitions). q17/q39
exercise the stddev_samp aggregate; ROLLUPs (q18/q27) restate flat at
their finest grouping; q9 picks buckets by CASE over scalar
subqueries; q74/q11/q4 restate the official UNION ALL year_total CTE
as one CTE per channel; q38's INTERSECT restates as a 1:1 join of
distinct triples; q89 restates AVG() OVER as a per-partition average
CTE; q2 ratios each week against the same week a year later. The
channel-union family (q33/q56/q60/q71) runs through real UNION ALL
planning; the returns chains (q1/q25/q29/q30/q40/q50/q81/q91/q93) join
the store/catalog/web returns tables; q16/q94 run EXISTS with a <>
correlation plus NOT EXISTS, with COUNT(DISTINCT order) restated
exactly as a per-order derived aggregate; q61/q88 restate the official
cross-joins of single-row derived tables exactly as CASE-filtered sums
in one pass.
All are restated in the framework
dialect: q13/q48 hoist the join
equalities shared by every OR branch (an exact identity); q34/q73
rewrite the dep/vehicle ratio as a multiply (exact under the
vehicle > 0 guard); q98 restates the window partition sum as a
class-total self-join; q65's month window adapts to our date epoch;
tie-prone ORDER BYs gain deterministic tiebreakers. Each is verified
against ``reference_answers`` — an independent numpy implementation
computed straight off the generated tables (the canondata pattern,
ydb/tests/functional/tpc).

The port's own copy of ``ydb_tpu/workload/tpcds.py``, with its imports
pointed at the port and ``run_tpcds`` taking the ``device``.
"""

from __future__ import annotations

import collections

import numpy as np

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.blocks.dictionary import DictionarySet

DEC2 = dtypes.decimal(2)

# dsdgen numbers date_dim surrogate keys as julian day numbers;
# 2415022 == 1900-01-01.  Our slice covers 1998-01-01..2002-12-31.
_D0_SK = 2450815
_D0 = np.datetime64("1998-01-01", "D")
_N_DATES = int((np.datetime64("2003-01-01", "D") - _D0).astype(int))

_DAY_NAMES = [b"Monday", b"Tuesday", b"Wednesday", b"Thursday",
              b"Friday", b"Saturday", b"Sunday"]
_CATEGORIES = [b"Books", b"Children", b"Electronics", b"Home",
               b"Jewelry", b"Men", b"Music", b"Shoes", b"Sports",
               b"Women"]
# dsdgen store names are spelled-out digit syllables
_STORE_NAMES = [b"ought", b"able", b"pri", b"ese", b"anti",
                b"cally", b"ation", b"eing", b"bar"]
_GENDERS = [b"M", b"F"]
# pools cover the spec queries' literal constants (q34/q46/q68/q73/q79
# counties and cities) so they always select rows at synthetic scale
_CITIES = [b"Five Forks", b"Oakland", b"Fairview", b"Winchester",
           b"Farmington", b"Pleasant Hill", b"Bethel", b"Midway",
           b"Union", b"Salem"]
_COUNTIES = [b"Salem County", b"Terrell County", b"Arthur County",
             b"Oglethorpe County", b"Lunenburg County", b"Perry County",
             b"Halifax County", b"Sumner County", b"Lea County",
             b"Furnas County", b"Pennington County", b"Bronx County",
             b"Mobile County", b"Ziebach County"]
_BUY_POTENTIAL = [b"0-500", b"501-1000", b"1001-5000", b"5001-10000",
                  b">10000", b"Unknown"]
_FIRST_NAMES = [b"James", b"Mary", b"John", b"Linda", b"Robert",
                b"Susan", b"Michael", b"Karen", b"William", b"Nancy",
                b"David", b"Lisa", b"Richard", b"Betty", b"Joseph"]
_LAST_NAMES = [b"Smith", b"Johnson", b"Williams", b"Brown", b"Jones",
               b"Garcia", b"Miller", b"Davis", b"Wilson", b"Moore",
               b"Taylor", b"Anderson", b"Thomas", b"Jackson", b"White"]
_SALUTATIONS = [b"Mr.", b"Mrs.", b"Ms.", b"Dr.", b"Miss", b"Sir"]
_CREDIT_RATINGS = [b"Low Risk", b"Good", b"High Risk", b"Unknown"]
_SHIP_TYPES = [b"EXPRESS", b"OVERNIGHT", b"REGULAR", b"TWO DAY",
               b"LIBRARY"]
_CC_NAMES = [b"NY Metro", b"Mid Atlantic", b"North Midwest",
             b"Pacific Northwest", b"Central", b"California"]
_MARITAL = [b"M", b"S", b"D", b"W", b"U"]
# dsdgen color domain subset covering the q56/q60 literal constants
_COLORS = [b"slate", b"blanched", b"cornsilk", b"chiffon", b"lace",
           b"lawn", b"orchid", b"salmon", b"powder", b"peru",
           b"sienna", b"drab", b"grey", b"rosy", b"metallic", b"navy"]
_REASONS = [b"Package was damaged", b"Stopped working",
            b"Did not fit", b"Found a better price", b"Not the product",
            b"Gift exchange", b"Duplicate purchase", b"Parts missing",
            b"Did not like the color", b"Did not like the model",
            b"Unauthorized purchase", b"Lost my job",
            b"reason 13", b"reason 14", b"reason 15"]
_EDUCATION = [b"Primary", b"Secondary", b"College", b"2 yr Degree",
              b"4 yr Degree", b"Advanced Degree", b"Unknown"]

DATE_DIM_SCHEMA = dtypes.schema(
    ("d_date_sk", dtypes.INT64, False),
    ("d_date", dtypes.DATE, False),
    ("d_year", dtypes.INT32, False),
    ("d_moy", dtypes.INT32, False),
    ("d_dom", dtypes.INT32, False),
    ("d_month_seq", dtypes.INT32, False),
    ("d_day_name", dtypes.STRING, False),
    ("d_dow", dtypes.INT32, False),
    ("d_qoy", dtypes.INT32, False),
    ("d_week_seq", dtypes.INT32, False),
)

ITEM_SCHEMA = dtypes.schema(
    ("i_item_sk", dtypes.INT64, False),
    ("i_item_id", dtypes.STRING, False),
    ("i_brand_id", dtypes.INT32, False),
    ("i_brand", dtypes.STRING, False),
    ("i_category_id", dtypes.INT32, False),
    ("i_category", dtypes.STRING, False),
    ("i_manufact_id", dtypes.INT32, False),
    ("i_manufact", dtypes.STRING, False),
    ("i_manager_id", dtypes.INT32, False),
    ("i_current_price", DEC2, False),
    ("i_class_id", dtypes.INT32, False),
    ("i_class", dtypes.STRING, False),
    ("i_item_desc", dtypes.STRING, False),
    ("i_wholesale_cost", DEC2, False),
    ("i_color", dtypes.STRING, False),
)

STORE_SCHEMA = dtypes.schema(
    ("s_store_sk", dtypes.INT64, False),
    ("s_store_id", dtypes.STRING, False),
    ("s_store_name", dtypes.STRING, False),
    ("s_gmt_offset", dtypes.INT32, False),
    ("s_zip", dtypes.STRING, False),
    ("s_city", dtypes.STRING, False),
    ("s_county", dtypes.STRING, False),
    ("s_number_employees", dtypes.INT32, False),
    ("s_state", dtypes.STRING, False),
)

TIME_DIM_SCHEMA = dtypes.schema(
    ("t_time_sk", dtypes.INT64, False),
    ("t_hour", dtypes.INT32, False),
    ("t_minute", dtypes.INT32, False),
    ("t_meal_time", dtypes.STRING, False),
)

PROMOTION_SCHEMA = dtypes.schema(
    ("p_promo_sk", dtypes.INT64, False),
    ("p_channel_email", dtypes.STRING, False),
    ("p_channel_event", dtypes.STRING, False),
    ("p_channel_dmail", dtypes.STRING, False),
    ("p_channel_tv", dtypes.STRING, False),
)

CUSTOMER_SCHEMA = dtypes.schema(
    ("c_customer_sk", dtypes.INT64, False),
    ("c_current_addr_sk", dtypes.INT64, False),
    ("c_first_name", dtypes.STRING, False),
    ("c_last_name", dtypes.STRING, False),
    ("c_salutation", dtypes.STRING, False),
    ("c_preferred_cust_flag", dtypes.STRING, False),
    ("c_current_cdemo_sk", dtypes.INT64, False),
    ("c_customer_id", dtypes.STRING, False),
    ("c_current_hdemo_sk", dtypes.INT64, False),
    ("c_birth_month", dtypes.INT32, False),
    ("c_birth_year", dtypes.INT32, False),
)

CUSTOMER_ADDRESS_SCHEMA = dtypes.schema(
    ("ca_address_sk", dtypes.INT64, False),
    ("ca_zip", dtypes.STRING, False),
    ("ca_state", dtypes.STRING, False),
    ("ca_country", dtypes.STRING, False),
    ("ca_city", dtypes.STRING, False),
    ("ca_county", dtypes.STRING, False),
    ("ca_gmt_offset", dtypes.INT32, False),
)

CUSTOMER_DEMOGRAPHICS_SCHEMA = dtypes.schema(
    ("cd_demo_sk", dtypes.INT64, False),
    ("cd_gender", dtypes.STRING, False),
    ("cd_marital_status", dtypes.STRING, False),
    ("cd_education_status", dtypes.STRING, False),
    ("cd_purchase_estimate", dtypes.INT32, False),
    ("cd_credit_rating", dtypes.STRING, False),
    ("cd_dep_count", dtypes.INT32, False),
)

HOUSEHOLD_DEMOGRAPHICS_SCHEMA = dtypes.schema(
    ("hd_demo_sk", dtypes.INT64, False),
    ("hd_dep_count", dtypes.INT32, False),
    ("hd_buy_potential", dtypes.STRING, False),
    ("hd_vehicle_count", dtypes.INT32, False),
)

STORE_SALES_SCHEMA = dtypes.schema(
    ("ss_sold_date_sk", dtypes.INT64, False),
    ("ss_sold_time_sk", dtypes.INT64, False),
    ("ss_item_sk", dtypes.INT64, False),
    ("ss_customer_sk", dtypes.INT64, False),
    ("ss_cdemo_sk", dtypes.INT64, False),
    ("ss_hdemo_sk", dtypes.INT64, False),
    ("ss_store_sk", dtypes.INT64, False),
    ("ss_promo_sk", dtypes.INT64, False),
    ("ss_addr_sk", dtypes.INT64, False),
    ("ss_quantity", dtypes.INT32, False),
    ("ss_list_price", DEC2, False),
    ("ss_sales_price", DEC2, False),
    ("ss_ext_sales_price", DEC2, False),
    ("ss_ext_wholesale_cost", DEC2, False),
    ("ss_coupon_amt", DEC2, False),
    ("ss_net_profit", DEC2, False),
    ("ss_ticket_number", dtypes.INT64, False),
    ("ss_ext_list_price", DEC2, False),
    ("ss_ext_tax", DEC2, False),
    ("ss_ext_discount_amt", DEC2, False),
    ("ss_net_paid", DEC2, False),
)

WEB_SALES_SCHEMA = dtypes.schema(
    ("ws_sold_date_sk", dtypes.INT64, False),
    ("ws_item_sk", dtypes.INT64, False),
    ("ws_bill_customer_sk", dtypes.INT64, False),
    ("ws_quantity", dtypes.INT32, False),
    ("ws_sales_price", DEC2, False),
    ("ws_ext_sales_price", DEC2, False),
    ("ws_ext_discount_amt", DEC2, False),
    ("ws_bill_addr_sk", dtypes.INT64, False),
    ("ws_sold_time_sk", dtypes.INT64, False),
    ("ws_net_profit", DEC2, False),
    ("ws_order_number", dtypes.INT64, False),
    ("ws_warehouse_sk", dtypes.INT64, False),
    ("ws_ship_mode_sk", dtypes.INT64, False),
    ("ws_web_site_sk", dtypes.INT64, False),
    ("ws_ship_addr_sk", dtypes.INT64, False),
    ("ws_ext_ship_cost", DEC2, False),
    ("ws_ship_date_sk", dtypes.INT64, False),
    ("ws_net_paid", DEC2, False),
    ("ws_ext_list_price", DEC2, False),
    ("ws_ext_wholesale_cost", DEC2, False),
)

INVENTORY_SCHEMA = dtypes.schema(
    ("inv_date_sk", dtypes.INT64, False),
    ("inv_item_sk", dtypes.INT64, False),
    ("inv_warehouse_sk", dtypes.INT64, False),
    ("inv_quantity_on_hand", dtypes.INT32, False),
)

WAREHOUSE_SCHEMA = dtypes.schema(
    ("w_warehouse_sk", dtypes.INT64, False),
    ("w_warehouse_name", dtypes.STRING, False),
    ("w_state", dtypes.STRING, False),
)

SHIP_MODE_SCHEMA = dtypes.schema(
    ("sm_ship_mode_sk", dtypes.INT64, False),
    ("sm_type", dtypes.STRING, False),
)

CALL_CENTER_SCHEMA = dtypes.schema(
    ("cc_call_center_sk", dtypes.INT64, False),
    ("cc_name", dtypes.STRING, False),
    ("cc_county", dtypes.STRING, False),
)

CATALOG_SALES_SCHEMA = dtypes.schema(
    ("cs_sold_date_sk", dtypes.INT64, False),
    ("cs_item_sk", dtypes.INT64, False),
    ("cs_bill_cdemo_sk", dtypes.INT64, False),
    ("cs_promo_sk", dtypes.INT64, False),
    ("cs_quantity", dtypes.INT32, False),
    ("cs_list_price", DEC2, False),
    ("cs_sales_price", DEC2, False),
    ("cs_ext_sales_price", DEC2, False),
    ("cs_coupon_amt", DEC2, False),
    ("cs_bill_customer_sk", dtypes.INT64, False),
    ("cs_ext_discount_amt", DEC2, False),
    ("cs_ship_date_sk", dtypes.INT64, False),
    ("cs_warehouse_sk", dtypes.INT64, False),
    ("cs_ship_mode_sk", dtypes.INT64, False),
    ("cs_call_center_sk", dtypes.INT64, False),
    ("cs_bill_addr_sk", dtypes.INT64, False),
    ("cs_ship_addr_sk", dtypes.INT64, False),
    ("cs_sold_time_sk", dtypes.INT64, False),
    ("cs_order_number", dtypes.INT64, False),
    ("cs_net_profit", DEC2, False),
    ("cs_ext_ship_cost", DEC2, False),
    ("cs_ext_list_price", DEC2, False),
    ("cs_ext_wholesale_cost", DEC2, False),
)
REASON_SCHEMA = dtypes.schema(
    ("r_reason_sk", dtypes.INT64, False),
    ("r_reason_desc", dtypes.STRING, False),
)
STORE_RETURNS_SCHEMA = dtypes.schema(
    ("sr_returned_date_sk", dtypes.INT64, False),
    ("sr_item_sk", dtypes.INT64, False),
    ("sr_customer_sk", dtypes.INT64, False),
    ("sr_ticket_number", dtypes.INT64, False),
    ("sr_store_sk", dtypes.INT64, False),
    ("sr_reason_sk", dtypes.INT64, False),
    ("sr_return_quantity", dtypes.INT32, False),
    ("sr_return_amt", DEC2, False),
    ("sr_net_loss", DEC2, False),
)
WEB_SITE_SCHEMA = dtypes.schema(
    ("web_site_sk", dtypes.INT64, False),
    ("web_name", dtypes.STRING, False),
    ("web_company_name", dtypes.STRING, False),
)
WEB_RETURNS_SCHEMA = dtypes.schema(
    ("wr_returned_date_sk", dtypes.INT64, False),
    ("wr_item_sk", dtypes.INT64, False),
    ("wr_order_number", dtypes.INT64, False),
    ("wr_returning_customer_sk", dtypes.INT64, False),
    ("wr_returning_addr_sk", dtypes.INT64, False),
    ("wr_return_quantity", dtypes.INT32, False),
    ("wr_return_amt", DEC2, False),
    ("wr_net_loss", DEC2, False),
)
CATALOG_RETURNS_SCHEMA = dtypes.schema(
    ("cr_returned_date_sk", dtypes.INT64, False),
    ("cr_item_sk", dtypes.INT64, False),
    ("cr_order_number", dtypes.INT64, False),
    ("cr_returning_customer_sk", dtypes.INT64, False),
    ("cr_returning_addr_sk", dtypes.INT64, False),
    ("cr_call_center_sk", dtypes.INT64, False),
    ("cr_return_quantity", dtypes.INT32, False),
    ("cr_return_amount", DEC2, False),
    ("cr_refunded_cash", DEC2, False),
    ("cr_net_loss", DEC2, False),
)

SCHEMAS = {
    "date_dim": DATE_DIM_SCHEMA,
    "item": ITEM_SCHEMA,
    "store": STORE_SCHEMA,
    "time_dim": TIME_DIM_SCHEMA,
    "promotion": PROMOTION_SCHEMA,
    "customer": CUSTOMER_SCHEMA,
    "customer_address": CUSTOMER_ADDRESS_SCHEMA,
    "customer_demographics": CUSTOMER_DEMOGRAPHICS_SCHEMA,
    "household_demographics": HOUSEHOLD_DEMOGRAPHICS_SCHEMA,
    "store_sales": STORE_SALES_SCHEMA,
    "catalog_sales": CATALOG_SALES_SCHEMA,
    "web_sales": WEB_SALES_SCHEMA,
    "inventory": INVENTORY_SCHEMA,
    "warehouse": WAREHOUSE_SCHEMA,
    "ship_mode": SHIP_MODE_SCHEMA,
    "call_center": CALL_CENTER_SCHEMA,
    "reason": REASON_SCHEMA,
    "store_returns": STORE_RETURNS_SCHEMA,
    "catalog_returns": CATALOG_RETURNS_SCHEMA,
    "web_site": WEB_SITE_SCHEMA,
    "web_returns": WEB_RETURNS_SCHEMA,
}

PRIMARY_KEYS = {
    "date_dim": ("d_date_sk",),
    "item": ("i_item_sk",),
    "store": ("s_store_sk",),
    "time_dim": ("t_time_sk",),
    "promotion": ("p_promo_sk",),
    "customer": ("c_customer_sk",),
    "customer_address": ("ca_address_sk",),
    "customer_demographics": ("cd_demo_sk",),
    "household_demographics": ("hd_demo_sk",),
    "store_sales": ("ss_item_sk", "ss_sold_date_sk", "ss_sold_time_sk"),
    "catalog_sales": ("cs_item_sk", "cs_sold_date_sk"),
    "web_sales": ("ws_item_sk", "ws_sold_date_sk"),
    "inventory": ("inv_date_sk", "inv_item_sk", "inv_warehouse_sk"),
    "warehouse": ("w_warehouse_sk",),
    "ship_mode": ("sm_ship_mode_sk",),
    "call_center": ("cc_call_center_sk",),
    "reason": ("r_reason_sk",),
    "store_returns": ("sr_item_sk", "sr_ticket_number"),
    "catalog_returns": ("cr_item_sk", "cr_order_number"),
    "web_site": ("web_site_sk",),
    "web_returns": ("wr_item_sk", "wr_order_number"),
}


def _enc(dicts: DictionarySet, col: str, values: list[bytes]) -> np.ndarray:
    d = dicts.for_column(col)
    return np.array([d.add(v) for v in values], dtype=np.int32)


def _cents(rng, lo: float, hi: float, n: int) -> np.ndarray:
    return rng.integers(round(lo * 100), round(hi * 100), n,
                        dtype=np.int64)


class TpcdsData:
    """Generated TPC-DS table subset + shared dictionaries.

    Row counts scale with ``sf`` following dsdgen's SF-1 cardinalities
    (store_sales 2 880 404, catalog_sales 1 441 548, item 18 000,
    customer 100 000, ...), floored so tiny test scale factors still
    produce joinable data.
    """

    def __init__(self, sf: float = 0.01, seed: int = 42):
        rng = np.random.default_rng(seed)
        self.dicts = DictionarySet()
        self.tables: dict[str, dict[str, np.ndarray]] = {}
        # floors keep dsdgen's fixed attribute domains (1000 manufact
        # ids, 100 manager ids, ...) populated at tiny test scales so
        # the spec queries' literal constants still select rows
        self._gen_date_dim()
        self._gen_item(rng, max(2000, int(sf * 18_000)))
        self._gen_store(rng, max(14, int(sf * 12)))
        self._gen_time_dim()
        self._gen_promotion(rng, max(20, int(sf * 300)))
        self._gen_demographics()
        self._gen_customer(rng, max(2000, int(sf * 100_000)),
                           max(400, int(sf * 50_000)))
        self._gen_warehouses(rng)
        self._gen_reason()
        self._gen_store_sales(rng, max(50_000, int(sf * 2_880_404)))
        # returns generate BEFORE catalog_sales: a slice of catalog
        # orders re-buys returned items (the q25/q29 cross-channel
        # chain needs store-return -> catalog-purchase correlation)
        self._gen_store_returns(rng)
        self._gen_catalog_sales(rng, max(25_000, int(sf * 1_441_548)))
        self._gen_web_sales(rng, max(15_000, int(sf * 719_384)))
        self._gen_catalog_returns(rng)
        self._gen_web_returns(rng)
        self._gen_inventory(rng, max(260_000, int(sf * 11_745_000)))

    def _gen_date_dim(self):
        days = _D0 + np.arange(_N_DATES)
        ymd = days.astype("datetime64[D]")
        y = ymd.astype("datetime64[Y]")
        m = ymd.astype("datetime64[M]")
        self.tables["date_dim"] = {
            "d_date_sk": (_D0_SK + np.arange(_N_DATES)).astype(np.int64),
            "d_date": days.astype(np.int32),
            "d_year": (y.astype(int) + 1970).astype(np.int32),
            "d_moy": ((m - y).astype(int) + 1).astype(np.int32),
            "d_dom": ((ymd - m).astype(int) + 1).astype(np.int32),
            # months since 1998-01 (a consistent absolute month index)
            "d_month_seq": (m.astype(int)
                            - np.datetime64("1998-01", "M")
                            .astype(int)).astype(np.int32),
            "d_day_name": _enc(
                self.dicts, "d_day_name",
                [_DAY_NAMES[d] for d in
                 ((days.astype(int) + 3) % 7).tolist()]),
            # 0 = Sunday (the spec's convention: d_dow in (6,0) means
            # Saturday+Sunday)
            "d_dow": (((days.astype(int) + 3) % 7 + 1) % 7)
            .astype(np.int32),
            "d_qoy": (((m - y).astype(int)) // 3 + 1).astype(np.int32),
            # absolute week index (Monday-anchored weeks since epoch;
            # q2 joins consecutive years via d_week_seq - 53)
            "d_week_seq": ((days.astype(int) + 3) // 7).astype(np.int32),
        }

    def _gen_item(self, rng, n: int):
        # cyclic-then-shuffled assignment keeps dsdgen's fixed domains
        # (1000 manufacturers, 100 managers) uniformly covered even at
        # small n, so spec query constants always select some items
        manufact_id = rng.permutation(
            (np.arange(n) % 1000 + 1)).astype(np.int32)
        brand_in_manu = rng.integers(1, 11, n).astype(np.int32)
        brand_id = manufact_id * 10 + brand_in_manu
        cat_id = rng.integers(1, len(_CATEGORIES) + 1, n).astype(np.int32)
        self.tables["item"] = {
            "i_item_sk": np.arange(1, n + 1, dtype=np.int64),
            "i_item_id": _enc(
                self.dicts, "i_item_id",
                [b"AAAAAAAA%08dCA" % i for i in range(1, n + 1)]),
            "i_brand_id": brand_id,
            "i_brand": _enc(
                self.dicts, "i_brand",
                [b"Brand#%d" % b for b in brand_id.tolist()]),
            "i_category_id": cat_id,
            "i_category": _enc(
                self.dicts, "i_category",
                [_CATEGORIES[c - 1] for c in cat_id.tolist()]),
            "i_manufact_id": manufact_id,
            "i_manufact": _enc(
                self.dicts, "i_manufact",
                [b"manufact#%d" % m for m in manufact_id.tolist()]),
            "i_manager_id": rng.permutation(
                (np.arange(n) % 100 + 1)).astype(np.int32),
            # dsdgen prices skew low: a fifth of items cluster under
            # $2 (q21's 0.99-1.49 band must select items at any scale)
            "i_current_price": np.where(
                rng.random(n) < 0.2, _cents(rng, 0.50, 2.00, n),
                _cents(rng, 2.00, 100.00, n)).astype(np.int64),
            "i_class_id": (class_id := rng.integers(
                1, 17, n).astype(np.int32)),
            "i_class": _enc(self.dicts, "i_class",
                            [b"class#%02d" % c
                             for c in class_id.tolist()]),
            "i_item_desc": _enc(
                self.dicts, "i_item_desc",
                [b"desc of item %d" % i
                 for i in range(1, n + 1)]),
            "i_wholesale_cost": _cents(rng, 0.30, 80.00, n),
            "i_color": _enc(
                self.dicts, "i_color",
                [_COLORS[c] for c in
                 rng.integers(0, len(_COLORS), n).tolist()]),
        }

    def _gen_store(self, rng, n: int):
        names = [_STORE_NAMES[i % len(_STORE_NAMES)] for i in range(n)]
        zips = [b"%05d" % z for z in
                rng.integers(10000, 99999, n).tolist()]
        self.tables["store"] = {
            "s_store_sk": np.arange(1, n + 1, dtype=np.int64),
            "s_store_id": _enc(
                self.dicts, "s_store_id",
                [b"AAAAAAAA%08dCA" % i for i in range(1, n + 1)]),
            "s_store_name": _enc(self.dicts, "s_store_name", names),
            "s_gmt_offset": np.where(
                rng.random(n) < 0.8, -5, -6).astype(np.int32),
            "s_zip": _enc(self.dicts, "s_zip", zips),
            "s_city": _enc(self.dicts, "s_city",
                           [_CITIES[i % len(_CITIES)]
                            for i in range(n)]),
            "s_county": _enc(self.dicts, "s_county",
                             [_COUNTIES[i % len(_COUNTIES)]
                              for i in range(n)]),
            "s_number_employees": rng.integers(
                180, 310, n).astype(np.int32),
            # TN dominates (dsdgen's single-state default; the q1
            # literal)
            "s_state": _enc(
                self.dicts, "s_state",
                [b"TN" if f else b"SD"
                 for f in rng.random(n) < 0.8]),
        }

    def _gen_time_dim(self):
        sk = np.arange(86_400, dtype=np.int64)
        hour = (sk // 3600).astype(np.int32)
        # dsdgen meal times: breakfast 6-9, lunch 11-13, dinner 17-21,
        # empty otherwise (the spec's NULL; queries test equality only)
        meal = np.select(
            [(hour >= 6) & (hour < 9), (hour >= 11) & (hour < 13),
             (hour >= 17) & (hour < 21)],
            [0, 1, 2], default=3)
        meal_names = [b"breakfast", b"lunch", b"dinner", b""]
        self.tables["time_dim"] = {
            "t_time_sk": sk,
            "t_hour": hour,
            "t_minute": ((sk % 3600) // 60).astype(np.int32),
            "t_meal_time": _enc(
                self.dicts, "t_meal_time",
                [meal_names[m] for m in meal.tolist()]),
        }

    def _gen_promotion(self, rng, n: int):
        yn = [b"N", b"Y"]
        self.tables["promotion"] = {
            "p_promo_sk": np.arange(1, n + 1, dtype=np.int64),
            "p_channel_email": _enc(
                self.dicts, "p_channel_email",
                [yn[v] for v in (rng.random(n) < 0.1).astype(int)]),
            "p_channel_event": _enc(
                self.dicts, "p_channel_event",
                [yn[v] for v in (rng.random(n) < 0.1).astype(int)]),
            "p_channel_dmail": _enc(
                self.dicts, "p_channel_dmail",
                [yn[v] for v in (rng.random(n) < 0.3).astype(int)]),
            "p_channel_tv": _enc(
                self.dicts, "p_channel_tv",
                [yn[v] for v in (rng.random(n) < 0.3).astype(int)]),
        }

    def _gen_demographics(self):
        combos = [(g, m, e) for g in _GENDERS for m in _MARITAL
                  for e in _EDUCATION]
        nc = len(combos)
        self.tables["customer_demographics"] = {
            "cd_demo_sk": np.arange(1, nc + 1, dtype=np.int64),
            "cd_gender": _enc(self.dicts, "cd_gender",
                              [c[0] for c in combos]),
            "cd_marital_status": _enc(self.dicts, "cd_marital_status",
                                      [c[1] for c in combos]),
            "cd_education_status": _enc(self.dicts, "cd_education_status",
                                        [c[2] for c in combos]),
            "cd_purchase_estimate": ((np.arange(nc) % 20 + 1) * 500)
            .astype(np.int32),
            "cd_credit_rating": _enc(
                self.dicts, "cd_credit_rating",
                [_CREDIT_RATINGS[i % len(_CREDIT_RATINGS)]
                 for i in range(nc)]),
            "cd_dep_count": (np.arange(nc) % 7).astype(np.int32),
        }
        n_hd = 7200
        self.tables["household_demographics"] = {
            "hd_demo_sk": np.arange(1, n_hd + 1, dtype=np.int64),
            "hd_dep_count": (np.arange(n_hd) % 10).astype(np.int32),
            "hd_buy_potential": _enc(
                self.dicts, "hd_buy_potential",
                [_BUY_POTENTIAL[i % len(_BUY_POTENTIAL)]
                 for i in range(n_hd)]),
            "hd_vehicle_count": ((np.arange(n_hd) // 10) % 5)
            .astype(np.int32),
        }

    _STATES = [b"TX", b"OH", b"OR", b"NM", b"KY", b"VA", b"MS",
               b"CA", b"NY", b"WA", b"GA", b"FL", b"MO", b"MN",
               b"AZ"]

    _SPEC_ZIPS = [b"85669", b"86197", b"88274", b"83405", b"86475",
                  b"85392", b"85460", b"80348", b"81792"]

    def _gen_customer(self, rng, n_cust: int, n_addr: int):
        # every 50th address takes a spec-query zip (q15/q45 prefix
        # lists) so those OR branches select rows at any scale
        zips = [self._SPEC_ZIPS[i // 50 % len(self._SPEC_ZIPS)]
                if i % 50 == 0 else b"%05d" % z
                for i, z in enumerate(
                    rng.integers(10000, 99999, n_addr).tolist())]
        state_pick = rng.integers(0, len(self._STATES), n_addr)
        self.tables["customer_address"] = {
            "ca_address_sk": np.arange(1, n_addr + 1, dtype=np.int64),
            "ca_zip": _enc(self.dicts, "ca_zip", zips),
            "ca_state": _enc(self.dicts, "ca_state",
                             [self._STATES[i] for i in state_pick]),
            "ca_country": _enc(
                self.dicts, "ca_country",
                [b"United States" if us else b"Canada"
                 for us in rng.random(n_addr) < 0.95]),
            "ca_city": _enc(
                self.dicts, "ca_city",
                [_CITIES[i] for i in
                 rng.integers(0, len(_CITIES), n_addr).tolist()]),
            "ca_county": _enc(
                self.dicts, "ca_county",
                [_COUNTIES[i] for i in
                 rng.integers(0, len(_COUNTIES), n_addr).tolist()]),
            # US timezone offsets; -5 dominates (the q33/q60 literal)
            "ca_gmt_offset": np.select(
                [rng.random(n_addr) < 0.4,
                 rng.random(n_addr) < 0.5,
                 rng.random(n_addr) < 0.5],
                [-5, -6, -7], default=-8).astype(np.int32),
        }
        self.tables["customer"] = {
            "c_customer_sk": np.arange(1, n_cust + 1, dtype=np.int64),
            "c_customer_id": _enc(
                self.dicts, "c_customer_id",
                [b"AAAAAAAA%08dCA" % i for i in range(1, n_cust + 1)]),
            "c_current_addr_sk": rng.integers(
                1, n_addr + 1, n_cust, dtype=np.int64),
            "c_first_name": _enc(
                self.dicts, "c_first_name",
                [_FIRST_NAMES[i] for i in rng.integers(
                    0, len(_FIRST_NAMES), n_cust).tolist()]),
            "c_last_name": _enc(
                self.dicts, "c_last_name",
                [_LAST_NAMES[i] for i in rng.integers(
                    0, len(_LAST_NAMES), n_cust).tolist()]),
            "c_salutation": _enc(
                self.dicts, "c_salutation",
                [_SALUTATIONS[i] for i in rng.integers(
                    0, len(_SALUTATIONS), n_cust).tolist()]),
            "c_preferred_cust_flag": _enc(
                self.dicts, "c_preferred_cust_flag",
                [b"Y" if f else b"N"
                 for f in rng.random(n_cust) < 0.5]),
            "c_current_cdemo_sk": rng.integers(
                1, len(_GENDERS) * len(_MARITAL) * len(_EDUCATION) + 1,
                n_cust, dtype=np.int64),
            "c_current_hdemo_sk": rng.integers(
                1, 7201, n_cust, dtype=np.int64),
            "c_birth_month": rng.integers(
                1, 13, n_cust).astype(np.int32),
            "c_birth_year": rng.integers(
                1924, 1993, n_cust).astype(np.int32),
        }

    def _fk(self, rng, table: str, pk: str, n: int) -> np.ndarray:
        return rng.choice(self.tables[table][pk], size=n)

    def _gen_store_sales(self, rng, n: int):
        qty = rng.integers(1, 101, n).astype(np.int32)
        list_price = _cents(rng, 1.00, 200.00, n)
        sales_price = (list_price *
                       rng.integers(20, 101, n) // 100).astype(np.int64)
        # dsdgen groups store_sales rows into TICKETS: one (customer,
        # store, date, time, hdemo, addr) purchase spanning 1..24 line
        # items — the q34/q73 "cnt between" bands need real multi-item
        # tickets, so per-ticket attributes generate first and expand
        n_tickets = max(n // 8, 1)
        # min of two uniforms skews ticket sizes small (dsdgen-like:
        # most baskets are a few lines) so the cnt-between-1-and-5
        # bands (q73) select tickets at every scale
        t_sizes = np.minimum(rng.integers(1, 25, n_tickets),
                             rng.integers(1, 25, n_tickets))
        row_ticket = np.repeat(np.arange(n_tickets), t_sizes)[:n]
        if len(row_ticket) < n:  # top up: tail rows get fresh tickets
            extra = np.arange(n_tickets,
                              n_tickets + n - len(row_ticket))
            row_ticket = np.concatenate([row_ticket, extra])
        nt = int(row_ticket.max()) + 1
        t_date = self._fk(rng, "date_dim", "d_date_sk", nt)
        t_time = rng.integers(0, 86_400, nt, dtype=np.int64)
        t_cust = self._fk(rng, "customer", "c_customer_sk", nt)
        t_cdemo = self._fk(rng, "customer_demographics",
                           "cd_demo_sk", nt)
        t_hdemo = self._fk(rng, "household_demographics",
                           "hd_demo_sk", nt)
        t_store = self._fk(rng, "store", "s_store_sk", nt)
        t_addr = self._fk(rng, "customer_address",
                          "ca_address_sk", nt)
        self.tables["store_sales"] = {
            "ss_sold_date_sk": t_date[row_ticket],
            "ss_sold_time_sk": t_time[row_ticket],
            "ss_item_sk": self._fk(rng, "item", "i_item_sk", n),
            "ss_customer_sk": t_cust[row_ticket],
            "ss_cdemo_sk": t_cdemo[row_ticket],
            "ss_hdemo_sk": t_hdemo[row_ticket],
            "ss_store_sk": t_store[row_ticket],
            "ss_promo_sk": self._fk(rng, "promotion", "p_promo_sk", n),
            "ss_addr_sk": t_addr[row_ticket],
            "ss_ticket_number": (row_ticket + 1).astype(np.int64),
            "ss_quantity": qty,
            "ss_list_price": list_price,
            "ss_sales_price": sales_price,
            "ss_ext_sales_price": sales_price * qty,
            "ss_ext_wholesale_cost": (
                list_price * rng.integers(40, 80, n) // 100
                * qty).astype(np.int64),
            "ss_coupon_amt": np.where(
                rng.random(n) < 0.2, _cents(rng, 0.0, 50.0, n),
                0).astype(np.int64),
            "ss_net_profit": _cents(rng, -100.0, 300.0, n),
            "ss_ext_list_price": list_price * qty,
            "ss_ext_tax": (sales_price * qty *
                           rng.integers(0, 9, n) // 100)
            .astype(np.int64),
            "ss_ext_discount_amt": np.where(
                rng.random(n) < 0.4, _cents(rng, 0.0, 40.0, n),
                0).astype(np.int64),
            "ss_net_paid": sales_price * qty,
        }

    def _gen_catalog_sales(self, rng, n: int):
        qty = rng.integers(1, 101, n).astype(np.int32)
        list_price = _cents(rng, 1.00, 300.00, n)
        sales_price = (list_price *
                       rng.integers(20, 101, n) // 100).astype(np.int64)
        self.tables["catalog_sales"] = {
            "cs_sold_date_sk": self._fk(rng, "date_dim", "d_date_sk", n),
            "cs_item_sk": self._fk(rng, "item", "i_item_sk", n),
            "cs_bill_cdemo_sk": self._fk(
                rng, "customer_demographics", "cd_demo_sk", n),
            "cs_promo_sk": self._fk(rng, "promotion", "p_promo_sk", n),
            "cs_quantity": qty,
            "cs_list_price": list_price,
            "cs_sales_price": sales_price,
            "cs_ext_sales_price": sales_price * qty,
            "cs_coupon_amt": np.where(
                rng.random(n) < 0.2, _cents(rng, 0.0, 60.0, n),
                0).astype(np.int64),
            "cs_bill_customer_sk": self._fk(
                rng, "customer", "c_customer_sk", n),
            "cs_bill_addr_sk": self._fk(
                rng, "customer_address", "ca_address_sk", n),
            "cs_ship_addr_sk": self._fk(
                rng, "customer_address", "ca_address_sk", n),
            "cs_sold_time_sk": rng.integers(0, 86_400, n,
                                            dtype=np.int64),
            # two lines per order: the q16 EXISTS (same order shipped
            # from a DIFFERENT warehouse) needs multi-line orders
            "cs_order_number": (np.arange(n, dtype=np.int64) // 2 + 1),
            "cs_net_profit": _cents(rng, -100.0, 300.0, n),
            "cs_ext_ship_cost": _cents(rng, 0.50, 90.0, n),
            "cs_ext_list_price": list_price * qty,
            "cs_ext_wholesale_cost": (
                list_price * rng.integers(40, 80, n) // 100
                * qty).astype(np.int64),
            "cs_ext_discount_amt": np.where(
                rng.random(n) < 0.5, _cents(rng, 0.0, 80.0, n),
                0).astype(np.int64),
            "cs_warehouse_sk": self._fk(
                rng, "warehouse", "w_warehouse_sk", n),
            "cs_ship_mode_sk": self._fk(
                rng, "ship_mode", "sm_ship_mode_sk", n),
            "cs_call_center_sk": self._fk(
                rng, "call_center", "cc_call_center_sk", n),
        }
        # cross-channel correlation: ~5% of catalog orders are a
        # customer re-buying an item they returned in a store (the
        # q25/q29 store->return->catalog chain), sold 1..30 days after
        # the return
        cs = self.tables["catalog_sales"]
        max_sk = int(self.tables["date_dim"]["d_date_sk"].max())
        sr = self.tables.get("store_returns")
        if sr is not None and len(sr["sr_item_sk"]):
            n_inj = min(len(sr["sr_item_sk"]), n // 20)
            src = rng.choice(len(sr["sr_item_sk"]), n_inj,
                             replace=False)
            dst = rng.choice(n, n_inj, replace=False)
            cs["cs_bill_customer_sk"][dst] = sr["sr_customer_sk"][src]
            cs["cs_item_sk"][dst] = sr["sr_item_sk"][src]
            cs["cs_sold_date_sk"][dst] = np.minimum(
                sr["sr_returned_date_sk"][src]
                + rng.integers(1, 31, n_inj), max_sk)
        # shipping: 1..120 days after the sale (q99 buckets), clamped
        # into the date_dim domain
        cs["cs_ship_date_sk"] = np.minimum(
            cs["cs_sold_date_sk"] + rng.integers(1, 151, n), max_sk)

    def _gen_warehouses(self, rng):
        self.tables["warehouse"] = {
            "w_warehouse_sk": np.arange(1, 6, dtype=np.int64),
            "w_warehouse_name": _enc(
                self.dicts, "w_warehouse_name",
                [b"Warehouse number %d distribution" % i
                 for i in range(1, 6)]),
            "w_state": _enc(
                self.dicts, "w_state",
                [b"TN", b"SD", b"TN", b"OH", b"GA"]),
        }
        self.tables["ship_mode"] = {
            "sm_ship_mode_sk": np.arange(1, 21, dtype=np.int64),
            "sm_type": _enc(
                self.dicts, "sm_type",
                [_SHIP_TYPES[i % len(_SHIP_TYPES)] for i in range(20)]),
        }
        self.tables["call_center"] = {
            "cc_call_center_sk": np.arange(1, 7, dtype=np.int64),
            "cc_name": _enc(
                self.dicts, "cc_name",
                [_CC_NAMES[i % len(_CC_NAMES)] for i in range(6)]),
            "cc_county": _enc(
                self.dicts, "cc_county",
                [_COUNTIES[i % len(_COUNTIES)] for i in range(6)]),
        }
        self.tables["web_site"] = {
            "web_site_sk": np.arange(1, 9, dtype=np.int64),
            "web_name": _enc(
                self.dicts, "web_name",
                [b"site_%d" % i for i in range(1, 9)]),
            # dsdgen company names; 'pri' is the q94/q95 literal
            "web_company_name": _enc(
                self.dicts, "web_company_name",
                [_STORE_NAMES[i % len(_STORE_NAMES)]
                 for i in range(8)]),
        }

    def _gen_web_sales(self, rng, n: int):
        qty = rng.integers(1, 101, n).astype(np.int32)
        list_price = _cents(rng, 1.00, 300.00, n)
        sales_price = (list_price *
                       rng.integers(20, 101, n) // 100).astype(np.int64)
        # unique (item, date) pairs back the declared PK
        items = self.tables["item"]["i_item_sk"]
        dates = self.tables["date_dim"]["d_date_sk"]
        cells = rng.choice(len(items) * len(dates), size=n,
                           replace=False)
        self.tables["web_sales"] = {
            "ws_sold_date_sk": dates[cells % len(dates)],
            "ws_item_sk": items[cells // len(dates)],
            "ws_bill_customer_sk": self._fk(
                rng, "customer", "c_customer_sk", n),
            "ws_quantity": qty,
            "ws_sales_price": sales_price,
            "ws_ext_sales_price": sales_price * qty,
            "ws_ext_discount_amt": np.where(
                rng.random(n) < 0.5, _cents(rng, 0.0, 90.0, n),
                0).astype(np.int64),
            "ws_bill_addr_sk": self._fk(
                rng, "customer_address", "ca_address_sk", n),
            "ws_sold_time_sk": rng.integers(0, 86_400, n,
                                            dtype=np.int64),
            "ws_net_profit": _cents(rng, -100.0, 300.0, n),
            # two lines per order (q94's EXISTS wants a sibling line
            # shipped from a different warehouse)
            "ws_order_number": (np.arange(n, dtype=np.int64) // 2 + 1),
            "ws_warehouse_sk": self._fk(
                rng, "warehouse", "w_warehouse_sk", n),
            "ws_ship_mode_sk": self._fk(
                rng, "ship_mode", "sm_ship_mode_sk", n),
            "ws_web_site_sk": self._fk(
                rng, "web_site", "web_site_sk", n),
            "ws_ship_addr_sk": self._fk(
                rng, "customer_address", "ca_address_sk", n),
            "ws_ext_ship_cost": _cents(rng, 0.50, 90.0, n),
            "ws_net_paid": sales_price * qty,
            "ws_ext_list_price": list_price * qty,
            "ws_ext_wholesale_cost": (
                list_price * rng.integers(40, 80, n) // 100
                * qty).astype(np.int64),
        }
        ws = self.tables["web_sales"]
        max_sk = int(self.tables["date_dim"]["d_date_sk"].max())
        ws["ws_ship_date_sk"] = np.minimum(
            ws["ws_sold_date_sk"] + rng.integers(1, 151, n), max_sk)

    def _gen_reason(self):
        self.tables["reason"] = {
            "r_reason_sk": np.arange(1, len(_REASONS) + 1,
                                     dtype=np.int64),
            "r_reason_desc": _enc(self.dicts, "r_reason_desc",
                                  list(_REASONS)),
        }

    def _gen_store_returns(self, rng):
        """~10% of store_sales line items come back 1..60 days later.

        Returns keep the sale's (customer, item, ticket) triple so the
        q25/q29 chain joins and the q50 day-bucketing land on real
        matches; the returned quantity is 1..sold quantity."""
        ss = self.tables["store_sales"]
        n_ss = len(ss["ss_item_sk"])
        pick = np.flatnonzero(rng.random(n_ss) < 0.10)
        # a ticket can hold the same item twice; the returns PK is
        # (item, ticket), so keep one return per pair
        key = (ss["ss_item_sk"][pick] * (1 << 32)
               + ss["ss_ticket_number"][pick])
        pick = pick[np.unique(key, return_index=True)[1]]
        n = len(pick)
        max_sk = int(self.tables["date_dim"]["d_date_sk"].max())
        ret_qty = rng.integers(1, ss["ss_quantity"][pick] + 1)
        ret_amt = (ss["ss_sales_price"][pick] * ret_qty).astype(np.int64)
        self.tables["store_returns"] = {
            "sr_returned_date_sk": np.minimum(
                ss["ss_sold_date_sk"][pick]
                + rng.integers(1, 61, n), max_sk),
            "sr_item_sk": ss["ss_item_sk"][pick],
            "sr_customer_sk": ss["ss_customer_sk"][pick],
            "sr_ticket_number": ss["ss_ticket_number"][pick],
            "sr_store_sk": ss["ss_store_sk"][pick],
            "sr_reason_sk": self._fk(rng, "reason", "r_reason_sk", n),
            "sr_return_quantity": ret_qty.astype(np.int32),
            "sr_return_amt": ret_amt,
            "sr_net_loss": _cents(rng, 0.50, 120.00, n),
        }

    def _gen_catalog_returns(self, rng):
        """~8% of catalog_sales rows return; the (order, item) pair is
        the join identity (each generated order holds one line)."""
        cs = self.tables["catalog_sales"]
        n_cs = len(cs["cs_item_sk"])
        pick = np.flatnonzero(rng.random(n_cs) < 0.08)
        # orders hold two lines that can draw the same item; the
        # returns PK is (item, order), so keep one return per pair
        key = (cs["cs_item_sk"][pick] * (1 << 40)
               + cs["cs_order_number"][pick])
        pick = pick[np.unique(key, return_index=True)[1]]
        n = len(pick)
        max_sk = int(self.tables["date_dim"]["d_date_sk"].max())
        ret_qty = rng.integers(1, cs["cs_quantity"][pick] + 1)
        self.tables["catalog_returns"] = {
            "cr_returned_date_sk": np.minimum(
                cs["cs_sold_date_sk"][pick]
                + rng.integers(1, 61, n), max_sk),
            "cr_item_sk": cs["cs_item_sk"][pick],
            "cr_order_number": cs["cs_order_number"][pick],
            "cr_returning_customer_sk": cs["cs_bill_customer_sk"][pick],
            "cr_returning_addr_sk": cs["cs_bill_addr_sk"][pick],
            "cr_call_center_sk": cs["cs_call_center_sk"][pick],
            "cr_return_quantity": ret_qty.astype(np.int32),
            "cr_return_amount": (cs["cs_sales_price"][pick]
                                 * ret_qty).astype(np.int64),
            "cr_refunded_cash": _cents(rng, 0.50, 150.00, n),
            "cr_net_loss": _cents(rng, 0.50, 120.00, n),
        }

    def _gen_web_returns(self, rng):
        """~8% of web_sales lines return; join identity (item, order)."""
        ws = self.tables["web_sales"]
        n_ws = len(ws["ws_item_sk"])
        pick = np.flatnonzero(rng.random(n_ws) < 0.08)
        key = (ws["ws_item_sk"][pick] * (1 << 40)
               + ws["ws_order_number"][pick])
        pick = pick[np.unique(key, return_index=True)[1]]
        n = len(pick)
        max_sk = int(self.tables["date_dim"]["d_date_sk"].max())
        ret_qty = rng.integers(1, ws["ws_quantity"][pick] + 1)
        self.tables["web_returns"] = {
            "wr_returned_date_sk": np.minimum(
                ws["ws_sold_date_sk"][pick]
                + rng.integers(1, 61, n), max_sk),
            "wr_item_sk": ws["ws_item_sk"][pick],
            "wr_order_number": ws["ws_order_number"][pick],
            "wr_returning_customer_sk":
                ws["ws_bill_customer_sk"][pick],
            "wr_returning_addr_sk": ws["ws_bill_addr_sk"][pick],
            "wr_return_quantity": ret_qty.astype(np.int32),
            "wr_return_amt": (ws["ws_sales_price"][pick]
                              * ret_qty).astype(np.int64),
            "wr_net_loss": _cents(rng, 0.50, 120.00, n),
        }

    def _gen_inventory(self, rng, n: int):
        # weekly snapshots: every 7th date_dim day. Rows are a random
        # sample WITHOUT replacement of the (item, week, warehouse)
        # grid, interleaved over items: the declared PK triple is
        # genuinely unique AND every item keeps inventory coverage at
        # every scale (q37/q82 point bands stay non-vacuous)
        weekly = self.tables["date_dim"]["d_date_sk"][::7]
        items = self.tables["item"]["i_item_sk"]
        wss = self.tables["warehouse"]["w_warehouse_sk"]
        n_cells = len(items) * len(weekly) * len(wss)
        n = min(n, n_cells)
        per_item = len(weekly) * len(wss)
        cell = np.concatenate([
            off + rng.permutation(per_item)[:(
                n // len(items) + (1 if i < n % len(items) else 0))]
            for i, off in enumerate(
                range(0, n_cells, per_item))])[:n]
        self.tables["inventory"] = {
            "inv_date_sk": weekly[(cell % per_item) // len(wss)],
            "inv_item_sk": items[cell // per_item],
            "inv_warehouse_sk": wss[cell % len(wss)],
            "inv_quantity_on_hand": rng.integers(
                0, 1000, n).astype(np.int32),
        }

    def schema(self, table: str) -> dtypes.Schema:
        return SCHEMAS[table]


QUERIES = {
    # q3: brand revenue by year for one manufacturer's November sales
    "q3": """
select d_year, i_brand_id, i_brand, sum(ss_ext_sales_price) as sum_agg
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manufact_id = 128
  and d_moy = 11
group by d_year, i_brand_id, i_brand
order by d_year, sum_agg desc, i_brand_id
limit 100""",
    # q6: states whose customers bought items priced 20% above their
    # category average, in one chosen month (uncorrelated DISTINCT
    # subquery for the month + correlated avg-by-category subquery)
    "q6": """
select a.ca_state, count(*) as cnt
from customer_address a, customer c, store_sales s, date_dim d,
     item i
where a.ca_address_sk = c.c_current_addr_sk
  and c.c_customer_sk = s.ss_customer_sk
  and s.ss_sold_date_sk = d.d_date_sk
  and s.ss_item_sk = i.i_item_sk
  and d.d_month_seq = (select distinct d_month_seq from date_dim
                       where d_year = 2001 and d_moy = 1)
  and i.i_current_price > 1.2 * (select avg(j.i_current_price)
                                 from item j
                                 where j.i_category = i.i_category)
group by a.ca_state
having count(*) >= 10
order by cnt, a.ca_state
limit 100""",
    # q7: demographic/promotion item averages
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
limit 100""",
    # q19: brand revenue where customer and store zip prefixes differ
    "q19": """
select i_brand_id, i_brand, i_manufact_id, i_manufact,
       sum(ss_ext_sales_price) as ext_price
from date_dim, store_sales, item, customer, customer_address, store
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id = 8
  and d_moy = 11
  and d_year = 1998
  and ss_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and substring(ca_zip, 1, 5) <> substring(s_zip, 1, 5)
  and ss_store_sk = s_store_sk
group by i_brand_id, i_brand, i_manufact_id, i_manufact
order by ext_price desc, i_brand, i_brand_id, i_manufact_id, i_manufact
limit 100""",
    # q13: store-sales averages under OR-combined demographic and
    # address bands (join equalities hoisted out of the OR groups —
    # (E and F1) or (E and F2) == E and (F1 or F2), exactly)
    "q13": """
select avg(ss_quantity) as avg_qty,
       avg(ss_ext_sales_price) as avg_esp,
       avg(ss_ext_wholesale_cost) as avg_ewc,
       sum(ss_ext_wholesale_cost) as sum_ewc
from store_sales, store, customer_demographics,
     household_demographics, customer_address, date_dim
where s_store_sk = ss_store_sk
  and ss_sold_date_sk = d_date_sk and d_year = 2001
  and ss_hdemo_sk = hd_demo_sk
  and cd_demo_sk = ss_cdemo_sk
  and ss_addr_sk = ca_address_sk
  and ((cd_marital_status = 'M'
        and cd_education_status = 'Advanced Degree'
        and ss_sales_price between 100.00 and 150.00
        and hd_dep_count = 3)
    or (cd_marital_status = 'S'
        and cd_education_status = 'College'
        and ss_sales_price between 50.00 and 100.00
        and hd_dep_count = 1)
    or (cd_marital_status = 'W'
        and cd_education_status = '2 yr Degree'
        and ss_sales_price between 150.00 and 200.00
        and hd_dep_count = 1))
  and ((ca_country = 'United States'
        and ca_state in ('TX', 'OH', 'TX')
        and ss_net_profit between 100 and 200)
    or (ca_country = 'United States'
        and ca_state in ('OR', 'NM', 'KY')
        and ss_net_profit between 150 and 300)
    or (ca_country = 'United States'
        and ca_state in ('VA', 'TX', 'MS')
        and ss_net_profit between 50 and 250))""",
    # q26: the catalog_sales twin of q7
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
  and cd_gender = 'M'
  and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and (p_channel_email = 'N' or p_channel_event = 'N')
  and d_year = 2000
group by i_item_id
order by i_item_id
limit 100""",
    # q48: total quantity under OR-combined demographic/address bands
    # (same hoisting identity as q13)
    "q48": """
select sum(ss_quantity) as total_qty
from store_sales, store, customer_demographics, customer_address,
     date_dim
where s_store_sk = ss_store_sk
  and ss_sold_date_sk = d_date_sk and d_year = 2001
  and cd_demo_sk = ss_cdemo_sk
  and ss_addr_sk = ca_address_sk
  and ((cd_marital_status = 'M'
        and cd_education_status = '4 yr Degree'
        and ss_sales_price between 100.00 and 150.00)
    or (cd_marital_status = 'D'
        and cd_education_status = '2 yr Degree'
        and ss_sales_price between 50.00 and 100.00)
    or (cd_marital_status = 'S'
        and cd_education_status = 'College'
        and ss_sales_price between 150.00 and 200.00))
  and ((ca_country = 'United States'
        and ca_state in ('CO', 'OH', 'TX')
        and ss_net_profit between 0 and 2000)
    or (ca_country = 'United States'
        and ca_state in ('OR', 'MN', 'KY')
        and ss_net_profit between 150 and 3000)
    or (ca_country = 'United States'
        and ca_state in ('VA', 'CA', 'MS')
        and ss_net_profit between 50 and 25000))""",
    # q42: category revenue for one manager's items
    "q42": """
select d_year, i_category_id, i_category,
       sum(ss_ext_sales_price) as sum_agg
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id = 1
  and d_moy = 11
  and d_year = 2000
group by d_year, i_category_id, i_category
order by sum_agg desc, d_year, i_category_id, i_category
limit 100""",
    # q43: store sales pivoted by day of week
    "q43": """
select s_store_name, s_store_id,
  sum(case when d_day_name = 'Sunday' then ss_sales_price
      else 0.00 end) as sun_sales,
  sum(case when d_day_name = 'Monday' then ss_sales_price
      else 0.00 end) as mon_sales,
  sum(case when d_day_name = 'Tuesday' then ss_sales_price
      else 0.00 end) as tue_sales,
  sum(case when d_day_name = 'Wednesday' then ss_sales_price
      else 0.00 end) as wed_sales,
  sum(case when d_day_name = 'Thursday' then ss_sales_price
      else 0.00 end) as thu_sales,
  sum(case when d_day_name = 'Friday' then ss_sales_price
      else 0.00 end) as fri_sales,
  sum(case when d_day_name = 'Saturday' then ss_sales_price
      else 0.00 end) as sat_sales
from date_dim, store_sales, store
where d_date_sk = ss_sold_date_sk
  and ss_store_sk = s_store_sk
  and s_gmt_offset = -5
  and d_year = 2000
group by s_store_name, s_store_id
order by s_store_name, s_store_id
limit 100""",
    # q52: brand revenue, manager 1, November 2000
    "q52": """
select d_year, i_brand_id, i_brand,
       sum(ss_ext_sales_price) as ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id = 1
  and d_moy = 11
  and d_year = 2000
group by d_year, i_brand_id, i_brand
order by d_year, ext_price desc, i_brand_id
limit 100""",
    # q55: brand revenue, manager 28
    "q55": """
select i_brand_id, i_brand, sum(ss_ext_sales_price) as ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id = 28
  and d_moy = 11
  and d_year = 1999
group by i_brand_id, i_brand
order by ext_price desc, i_brand_id
limit 100""",
    # q96: count of evening sales to 7-dependent households at 'ese'
    "q96": """
select count(*) as cnt
from store_sales, household_demographics, time_dim, store
where ss_sold_time_sk = t_time_sk
  and ss_hdemo_sk = hd_demo_sk
  and ss_store_sk = s_store_sk
  and t_hour = 20
  and t_minute >= 30
  and hd_dep_count = 7
  and s_store_name = 'ese'""",
    # q15: catalog sales by customer zip for Q2/1998 under an OR of
    # zip-prefix / state / price predicates
    "q15": """
select ca_zip, sum(cs_sales_price) as total
from catalog_sales, customer, customer_address, date_dim
where cs_bill_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and (substring(ca_zip, 1, 5) in ('85669', '86197', '88274', '83405',
                                   '86475', '85392', '85460', '80348',
                                   '81792')
       or ca_state in ('CA', 'WA', 'GA')
       or cs_sales_price > 500)
  and cs_sold_date_sk = d_date_sk
  and d_qoy = 2 and d_year = 1998
group by ca_zip
order by ca_zip
limit 100""",
    # q32: excess discount amount vs 1.3x the per-item average in a
    # 90-day window (official derives adi over item; grouping by
    # cs_item_sk is the same partition)
    "q32": """
with adi as (
  select cs_item_sk as adi_item_sk,
         avg(cs_ext_discount_amt) as avg_discount
  from catalog_sales, date_dim
  where d_date between date '2002-03-29' and date '2002-06-27'
    and d_date_sk = cs_sold_date_sk
  group by cs_item_sk)
select sum(cs_ext_discount_amt) as excess
from catalog_sales, item, date_dim, adi
where i_manufact_id = 66
  and i_item_sk = cs_item_sk
  and d_date between date '2002-03-29' and date '2002-06-27'
  and d_date_sk = cs_sold_date_sk
  and cs_item_sk = adi_item_sk
  and cs_ext_discount_amt > 1.3 * avg_discount""",
    # q34: customers with 15-20-item tickets on month edges (the
    # dep/vehicle ratio predicate rewrites as a multiply — exact under
    # the hd_vehicle_count > 0 guard)
    "q34": """
with dn as (
  select ss_ticket_number, ss_customer_sk, count(*) as cnt
  from store_sales, date_dim, store, household_demographics
  where ss_sold_date_sk = d_date_sk
    and ss_store_sk = s_store_sk
    and ss_hdemo_sk = hd_demo_sk
    and (d_dom between 1 and 3 or d_dom between 25 and 28)
    and (hd_buy_potential = '>10000' or hd_buy_potential = 'Unknown')
    and hd_vehicle_count > 0
    and hd_dep_count > 1.2 * hd_vehicle_count
    and d_year in (2000, 2001, 2002)
    and s_county in ('Salem County', 'Terrell County', 'Arthur County',
                     'Oglethorpe County', 'Lunenburg County',
                     'Perry County', 'Halifax County', 'Sumner County')
  group by ss_ticket_number, ss_customer_sk)
select c_last_name, c_first_name, c_salutation, c_preferred_cust_flag,
       ss_ticket_number, cnt
from dn, customer
where ss_customer_sk = c_customer_sk
  and cnt between 15 and 20
order by c_last_name, c_first_name, c_salutation,
         c_preferred_cust_flag desc, ss_ticket_number""",
    # q46: weekend coupon/profit per ticket in five cities, for
    # customers whose current city differs from the bought city
    "q46": """
with dn as (
  select ss_ticket_number, ss_customer_sk, ss_addr_sk,
         ca_city as bought_city, sum(ss_coupon_amt) as amt,
         sum(ss_net_profit) as profit
  from store_sales, date_dim, store, household_demographics,
       customer_address
  where ss_sold_date_sk = d_date_sk
    and ss_store_sk = s_store_sk
    and ss_hdemo_sk = hd_demo_sk
    and ss_addr_sk = ca_address_sk
    and (hd_dep_count = 0 or hd_vehicle_count = 1)
    and d_dow in (6, 0)
    and d_year in (2000, 2001, 2002)
    and s_city in ('Five Forks', 'Oakland', 'Fairview', 'Winchester',
                   'Farmington')
  group by ss_ticket_number, ss_customer_sk, ss_addr_sk, bought_city)
select c_last_name, c_first_name, ca_city, bought_city,
       ss_ticket_number, amt, profit
from dn, customer, customer_address
where ss_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and ca_city <> bought_city
order by c_last_name, c_first_name, ca_city, bought_city,
         ss_ticket_number
limit 100""",
    # q65: items whose yearly revenue is under 10% of their store's
    # average per-item revenue (month window adapted to our epoch)
    "q65": """
with sc as (
  select ss_store_sk as sc_store_sk, ss_item_sk as sc_item_sk,
         sum(ss_sales_price) as revenue
  from store_sales, date_dim
  where ss_sold_date_sk = d_date_sk and d_month_seq between 48 and 59
  group by ss_store_sk, ss_item_sk),
sb as (
  select sc_store_sk as sb_store_sk, avg(revenue) as ave
  from sc
  group by sc_store_sk)
select s_store_name, i_item_desc, revenue, i_current_price,
       i_wholesale_cost, i_brand
from store, item, sb, sc
where sb_store_sk = sc_store_sk
  and revenue <= 0.1 * ave
  and s_store_sk = sc_store_sk
  and i_item_sk = sc_item_sk
order by s_store_name, i_item_desc, revenue, i_current_price,
         i_wholesale_cost, i_brand
limit 100""",
    # q68: month-start sales in two cities, moved-customer filter
    "q68": """
with dn as (
  select ss_ticket_number, ss_customer_sk, ss_addr_sk,
         ca_city as bought_city,
         sum(ss_ext_sales_price) as extended_price,
         sum(ss_ext_list_price) as list_price,
         sum(ss_ext_tax) as extended_tax
  from store_sales, date_dim, store, household_demographics,
       customer_address
  where ss_sold_date_sk = d_date_sk
    and ss_store_sk = s_store_sk
    and ss_hdemo_sk = hd_demo_sk
    and ss_addr_sk = ca_address_sk
    and d_dom between 1 and 2
    and (hd_dep_count = 4 or hd_vehicle_count = 0)
    and d_year in (1999, 2000, 2001)
    and s_city in ('Pleasant Hill', 'Bethel')
  group by ss_ticket_number, ss_customer_sk, ss_addr_sk, bought_city)
select c_last_name, c_first_name, ca_city, bought_city,
       ss_ticket_number, extended_price, extended_tax, list_price
from dn, customer, customer_address
where ss_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and ca_city <> bought_city
order by c_last_name, ss_ticket_number
limit 100""",
    # q73: 1-5-item tickets for high-buy-potential households (the
    # dep/vehicle > 1 ratio rewrites as dep > vehicle, exact under the
    # vehicle > 0 guard)
    "q73": """
with dj as (
  select ss_ticket_number, ss_customer_sk, count(*) as cnt
  from store_sales, date_dim, store, household_demographics
  where ss_sold_date_sk = d_date_sk
    and ss_store_sk = s_store_sk
    and ss_hdemo_sk = hd_demo_sk
    and d_dom between 1 and 2
    and (hd_buy_potential = '>10000'
         or hd_buy_potential = '5001-10000')
    and hd_vehicle_count > 0
    and hd_dep_count > hd_vehicle_count
    and d_year in (2000, 2001, 2002)
    and s_county in ('Lea County', 'Furnas County',
                     'Pennington County', 'Bronx County')
  group by ss_ticket_number, ss_customer_sk)
select c_last_name, c_first_name, c_salutation, c_preferred_cust_flag,
       ss_ticket_number, cnt
from dj, customer
where ss_customer_sk = c_customer_sk
  and cnt between 1 and 5
order by cnt desc, c_last_name, ss_ticket_number""",
    # q79: Monday coupon/profit per ticket at mid-size stores
    "q79": """
with ms as (
  select ss_ticket_number, ss_customer_sk, s_city,
         sum(ss_coupon_amt) as amt, sum(ss_net_profit) as profit
  from store_sales, date_dim, store, household_demographics
  where ss_sold_date_sk = d_date_sk
    and ss_store_sk = s_store_sk
    and ss_hdemo_sk = hd_demo_sk
    and (hd_dep_count = 0 or hd_vehicle_count > 3)
    and d_dow = 1
    and d_year in (1998, 1999, 2000)
    and s_number_employees between 200 and 295
  group by ss_ticket_number, ss_customer_sk, ss_addr_sk, s_city)
select c_last_name, c_first_name, substring(s_city, 1, 30) as city30,
       ss_ticket_number, amt, profit
from ms, customer
where ss_customer_sk = c_customer_sk
order by c_last_name, c_first_name, city30, profit, ss_ticket_number
limit 100""",
    # q98: item revenue + share of its class (the official window
    # sum over partition restated as a class-total self-join — the
    # same partition sum, exactly)
    "q98": """
with ir as (
  select i_item_id, i_item_desc, i_category, i_class, i_current_price,
         sum(ss_ext_sales_price) as itemrevenue
  from store_sales, item, date_dim
  where ss_item_sk = i_item_sk
    and i_category in ('Home', 'Sports', 'Men')
    and ss_sold_date_sk = d_date_sk
    and d_date between date '2002-01-05' and date '2002-02-04'
  group by i_item_id, i_item_desc, i_category, i_class,
           i_current_price),
cr as (
  select i_class as cr_class, sum(itemrevenue) as classrevenue
  from ir group by i_class)
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       itemrevenue, itemrevenue * 100.0 / classrevenue as revenueratio
from ir, cr
where i_class = cr_class
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100""",
    # q12: web twin of q98 (window partition sum restated as a
    # class-total self-join)
    "q12": """
with ir as (
  select i_item_id, i_item_desc, i_category, i_class, i_current_price,
         sum(ws_ext_sales_price) as itemrevenue
  from web_sales, item, date_dim
  where ws_item_sk = i_item_sk
    and i_category in ('Electronics', 'Books', 'Women')
    and ws_sold_date_sk = d_date_sk
    and d_date between date '1998-01-06' and date '1998-02-05'
  group by i_item_id, i_item_desc, i_category, i_class,
           i_current_price),
cr as (
  select i_class as cr_class, sum(itemrevenue) as classrevenue
  from ir group by i_class)
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       itemrevenue, itemrevenue * 100.0 / classrevenue as revenueratio
from ir, cr
where i_class = cr_class
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100""",
    # q20: catalog twin of q98
    "q20": """
with ir as (
  select i_item_id, i_item_desc, i_category, i_class, i_current_price,
         sum(cs_ext_sales_price) as itemrevenue
  from catalog_sales, item, date_dim
  where cs_item_sk = i_item_sk
    and i_category in ('Shoes', 'Electronics', 'Children')
    and cs_sold_date_sk = d_date_sk
    and d_date between date '2001-03-14' and date '2001-04-13'
  group by i_item_id, i_item_desc, i_category, i_class,
           i_current_price),
cr as (
  select i_class as cr_class, sum(itemrevenue) as classrevenue
  from ir group by i_class)
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       itemrevenue, itemrevenue * 100.0 / classrevenue as revenueratio
from ir, cr
where i_class = cr_class
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100""",
    # q21: warehouse inventory before/after a date (the ratio band
    # 2/3 <= after/before <= 3/2 rewritten as multiplies — exact for
    # before > 0)
    "q21": """
with x as (
  select w_warehouse_name, i_item_id,
         sum(case when d_date < date '1999-03-20'
             then inv_quantity_on_hand else 0 end) as inv_before,
         sum(case when d_date >= date '1999-03-20'
             then inv_quantity_on_hand else 0 end) as inv_after
  from inventory, warehouse, item, date_dim
  where i_current_price between 0.99 and 1.49
    and i_item_sk = inv_item_sk
    and inv_warehouse_sk = w_warehouse_sk
    and inv_date_sk = d_date_sk
    and d_date between date '1999-02-18' and date '1999-04-19'
  group by w_warehouse_name, i_item_id)
select w_warehouse_name, i_item_id, inv_before, inv_after
from x
where inv_before > 0
  and 3 * inv_after >= 2 * inv_before
  and 2 * inv_after <= 3 * inv_before
order by w_warehouse_name, i_item_id
limit 100""",
    # q37: catalog-sold items with 100-500 on hand in a 60-day window
    "q37": """
select i_item_id, i_item_desc, i_current_price
from item, inventory, date_dim, catalog_sales
where i_current_price between 39 and 69
  and inv_item_sk = i_item_sk
  and d_date_sk = inv_date_sk
  and d_date between date '2001-01-16' and date '2001-03-17'
  and i_manufact_id in (765, 886, 889, 728)
  and inv_quantity_on_hand between 100 and 500
  and cs_item_sk = i_item_sk
group by i_item_id, i_item_desc, i_current_price
order by i_item_id
limit 100""",
    # q45: web sales by zip/county (the official's item-id IN-subquery
    # over fixed item_sks rewrites to the item_sk set — exact, item
    # ids are unique per sk)
    "q45": """
select ca_zip, ca_county, sum(ws_sales_price) as total
from web_sales, customer, customer_address, date_dim, item
where ws_bill_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and ws_item_sk = i_item_sk
  and (substring(ca_zip, 1, 5) in ('85669', '86197', '88274', '83405',
                                   '86475', '85392', '85460', '80348',
                                   '81792')
       or i_item_sk in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29))
  and ws_sold_date_sk = d_date_sk
  and d_qoy = 1 and d_year = 1998
group by ca_zip, ca_county
order by ca_zip, ca_county
limit 100""",
    # q69: demographics of customers active in store but not web or
    # catalog in the window (d_year 2003 adapts to 2001, inside our
    # five-year date domain)
    "q69": """
select cd_gender, cd_marital_status, cd_education_status,
       count(*) as cnt1, cd_purchase_estimate, count(*) as cnt2,
       cd_credit_rating, count(*) as cnt3
from customer c, customer_address ca, customer_demographics
where c.c_current_addr_sk = ca.ca_address_sk
  and ca_state in ('MO', 'MN', 'AZ')
  and cd_demo_sk = c.c_current_cdemo_sk
  and exists (select * from store_sales, date_dim
              where c.c_customer_sk = ss_customer_sk
                and ss_sold_date_sk = d_date_sk
                and d_year = 2001 and d_moy between 2 and 4)
  and not exists (select * from web_sales, date_dim
                  where c.c_customer_sk = ws_bill_customer_sk
                    and ws_sold_date_sk = d_date_sk
                    and d_year = 2001 and d_moy between 2 and 4)
  and not exists (select * from catalog_sales, date_dim
                  where c.c_customer_sk = cs_bill_customer_sk
                    and cs_sold_date_sk = d_date_sk
                    and d_year = 2001 and d_moy between 2 and 4)
group by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating
order by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating
limit 100""",
    # q82: store twin of q37
    "q82": """
select i_item_id, i_item_desc, i_current_price
from item, inventory, date_dim, store_sales
where i_current_price between 49 and 79
  and inv_item_sk = i_item_sk
  and d_date_sk = inv_date_sk
  and d_date between date '2001-01-28' and date '2001-03-29'
  and i_manufact_id in (80, 675, 292, 17)
  and inv_quantity_on_hand between 100 and 500
  and ss_item_sk = i_item_sk
group by i_item_id, i_item_desc, i_current_price
order by i_item_id
limit 100""",
    # q92: web twin of q32 (excess discount vs 1.3x per-item average)
    "q92": """
with adi as (
  select ws_item_sk as adi_item_sk,
         avg(ws_ext_discount_amt) as avg_discount
  from web_sales, date_dim
  where d_date between date '2001-03-12' and date '2001-06-10'
    and d_date_sk = ws_sold_date_sk
  group by ws_item_sk)
select sum(ws_ext_discount_amt) as excess
from web_sales, item, date_dim, adi
where i_manufact_id = 356
  and i_item_sk = ws_item_sk
  and d_date between date '2001-03-12' and date '2001-06-10'
  and d_date_sk = ws_sold_date_sk
  and ws_item_sk = adi_item_sk
  and ws_ext_discount_amt > 1.3 * avg_discount""",
    # q99: catalog shipping-delay buckets by warehouse/mode/center
    # (month window adapted to our epoch)
    "q99": """
select substring(w_warehouse_name, 1, 20) as wname, sm_type, cc_name,
  sum(case when cs_ship_date_sk - cs_sold_date_sk <= 30
      then 1 else 0 end) as d30,
  sum(case when cs_ship_date_sk - cs_sold_date_sk > 30
           and cs_ship_date_sk - cs_sold_date_sk <= 60
      then 1 else 0 end) as d60,
  sum(case when cs_ship_date_sk - cs_sold_date_sk > 60
           and cs_ship_date_sk - cs_sold_date_sk <= 90
      then 1 else 0 end) as d90,
  sum(case when cs_ship_date_sk - cs_sold_date_sk > 90
           and cs_ship_date_sk - cs_sold_date_sk <= 120
      then 1 else 0 end) as d120,
  sum(case when cs_ship_date_sk - cs_sold_date_sk > 120
      then 1 else 0 end) as dmore
from catalog_sales, warehouse, ship_mode, call_center, date_dim
where d_month_seq between 36 and 47
  and cs_ship_date_sk = d_date_sk
  and cs_warehouse_sk = w_warehouse_sk
  and cs_ship_mode_sk = sm_ship_mode_sk
  and cs_call_center_sk = cc_call_center_sk
group by wname, sm_type, cc_name
order by wname, sm_type, cc_name
limit 100""",
    # q33: Electronics revenue by manufacturer across all three sales
    # channels (CTE per channel, UNION ALL, re-aggregate;
    # deterministic i_manufact_id tiebreaker added)
    "q33": """
with ss as (
  select i_manufact_id, sum(ss_ext_sales_price) as total_sales
  from store_sales, date_dim, customer_address, item
  where i_manufact_id in (select i_manufact_id from item
                          where i_category = 'Electronics')
    and ss_item_sk = i_item_sk
    and ss_sold_date_sk = d_date_sk
    and d_year = 1998 and d_moy = 5
    and ss_addr_sk = ca_address_sk
    and ca_gmt_offset = -5
  group by i_manufact_id),
cs as (
  select i_manufact_id, sum(cs_ext_sales_price) as total_sales
  from catalog_sales, date_dim, customer_address, item
  where i_manufact_id in (select i_manufact_id from item
                          where i_category = 'Electronics')
    and cs_item_sk = i_item_sk
    and cs_sold_date_sk = d_date_sk
    and d_year = 1998 and d_moy = 5
    and cs_bill_addr_sk = ca_address_sk
    and ca_gmt_offset = -5
  group by i_manufact_id),
ws as (
  select i_manufact_id, sum(ws_ext_sales_price) as total_sales
  from web_sales, date_dim, customer_address, item
  where i_manufact_id in (select i_manufact_id from item
                          where i_category = 'Electronics')
    and ws_item_sk = i_item_sk
    and ws_sold_date_sk = d_date_sk
    and d_year = 1998 and d_moy = 5
    and ws_bill_addr_sk = ca_address_sk
    and ca_gmt_offset = -5
  group by i_manufact_id)
select i_manufact_id, sum(total_sales) as total_sales
from (select i_manufact_id, total_sales from ss
      union all
      select i_manufact_id, total_sales from cs
      union all
      select i_manufact_id, total_sales from ws) tmp1
group by i_manufact_id
order by total_sales, i_manufact_id
limit 100""",
    # q56: three-channel revenue for items in chosen colors
    "q56": """
with ss as (
  select i_item_id, sum(ss_ext_sales_price) as total_sales
  from store_sales, date_dim, customer_address, item
  where i_item_id in (select i_item_id from item
                      where i_color in ('slate', 'blanched',
                                        'cornsilk'))
    and ss_item_sk = i_item_sk
    and ss_sold_date_sk = d_date_sk
    and d_year = 2001 and d_moy = 2
    and ss_addr_sk = ca_address_sk
    and ca_gmt_offset = -5
  group by i_item_id),
cs as (
  select i_item_id, sum(cs_ext_sales_price) as total_sales
  from catalog_sales, date_dim, customer_address, item
  where i_item_id in (select i_item_id from item
                      where i_color in ('slate', 'blanched',
                                        'cornsilk'))
    and cs_item_sk = i_item_sk
    and cs_sold_date_sk = d_date_sk
    and d_year = 2001 and d_moy = 2
    and cs_bill_addr_sk = ca_address_sk
    and ca_gmt_offset = -5
  group by i_item_id),
ws as (
  select i_item_id, sum(ws_ext_sales_price) as total_sales
  from web_sales, date_dim, customer_address, item
  where i_item_id in (select i_item_id from item
                      where i_color in ('slate', 'blanched',
                                        'cornsilk'))
    and ws_item_sk = i_item_sk
    and ws_sold_date_sk = d_date_sk
    and d_year = 2001 and d_moy = 2
    and ws_bill_addr_sk = ca_address_sk
    and ca_gmt_offset = -5
  group by i_item_id)
select i_item_id, sum(total_sales) as total_sales
from (select i_item_id, total_sales from ss
      union all
      select i_item_id, total_sales from cs
      union all
      select i_item_id, total_sales from ws) tmp1
group by i_item_id
order by total_sales, i_item_id
limit 100""",
    # q60: three-channel revenue for the Music category
    "q60": """
with ss as (
  select i_item_id, sum(ss_ext_sales_price) as total_sales
  from store_sales, date_dim, customer_address, item
  where i_item_id in (select i_item_id from item
                      where i_category = 'Music')
    and ss_item_sk = i_item_sk
    and ss_sold_date_sk = d_date_sk
    and d_year = 1998 and d_moy = 9
    and ss_addr_sk = ca_address_sk
    and ca_gmt_offset = -5
  group by i_item_id),
cs as (
  select i_item_id, sum(cs_ext_sales_price) as total_sales
  from catalog_sales, date_dim, customer_address, item
  where i_item_id in (select i_item_id from item
                      where i_category = 'Music')
    and cs_item_sk = i_item_sk
    and cs_sold_date_sk = d_date_sk
    and d_year = 1998 and d_moy = 9
    and cs_bill_addr_sk = ca_address_sk
    and ca_gmt_offset = -5
  group by i_item_id),
ws as (
  select i_item_id, sum(ws_ext_sales_price) as total_sales
  from web_sales, date_dim, customer_address, item
  where i_item_id in (select i_item_id from item
                      where i_category = 'Music')
    and ws_item_sk = i_item_sk
    and ws_sold_date_sk = d_date_sk
    and d_year = 1998 and d_moy = 9
    and ws_bill_addr_sk = ca_address_sk
    and ca_gmt_offset = -5
  group by i_item_id)
select i_item_id, sum(total_sales) as total_sales
from (select i_item_id, total_sales from ss
      union all
      select i_item_id, total_sales from cs
      union all
      select i_item_id, total_sales from ws) tmp1
group by i_item_id
order by i_item_id, total_sales
limit 100""",
    # q71: brand revenue by meal-time minute across the three channels
    # (deterministic brand/hour/minute tiebreakers added)
    "q71": """
select i_brand_id as brand_id, i_brand as brand,
       t_hour, t_minute, sum(ext_price) as ext_price
from item,
     (select ws_ext_sales_price as ext_price,
             ws_item_sk as sold_item_sk,
             ws_sold_time_sk as time_sk
      from web_sales, date_dim
      where d_date_sk = ws_sold_date_sk
        and d_moy = 11 and d_year = 1999
      union all
      select cs_ext_sales_price as ext_price,
             cs_item_sk as sold_item_sk,
             cs_sold_time_sk as time_sk
      from catalog_sales, date_dim
      where d_date_sk = cs_sold_date_sk
        and d_moy = 11 and d_year = 1999
      union all
      select ss_ext_sales_price as ext_price,
             ss_item_sk as sold_item_sk,
             ss_sold_time_sk as time_sk
      from store_sales, date_dim
      where d_date_sk = ss_sold_date_sk
        and d_moy = 11 and d_year = 1999) tmp,
     time_dim
where sold_item_sk = i_item_sk
  and i_manager_id = 1
  and time_sk = t_time_sk
  and (t_meal_time = 'breakfast' or t_meal_time = 'dinner')
group by i_brand, i_brand_id, t_hour, t_minute
order by ext_price desc, brand_id, t_hour, t_minute""",
    # q1: customers returning over 1.2x their store's average (CTE
    # referenced twice; correlated per-store average; q6's multiplier
    # placement)
    "q1": """
with customer_total_return as (
  select sr_customer_sk as ctr_customer_sk,
         sr_store_sk as ctr_store_sk,
         sum(sr_return_amt) as ctr_total_return
  from store_returns, date_dim
  where sr_returned_date_sk = d_date_sk and d_year = 2000
  group by sr_customer_sk, sr_store_sk)
select c_customer_id
from customer_total_return ctr1, store, customer
where ctr1.ctr_total_return >
      1.2 * (select avg(ctr2.ctr_total_return)
             from customer_total_return ctr2
             where ctr1.ctr_store_sk = ctr2.ctr_store_sk)
  and s_store_sk = ctr1.ctr_store_sk
  and s_state = 'TN'
  and ctr1.ctr_customer_sk = c_customer_sk
order by c_customer_id
limit 100""",
    # q25: store sale -> store return -> catalog re-purchase profit
    # chain by item and store
    "q25": """
select i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_net_profit) as store_sales_profit,
       sum(sr_net_loss) as store_returns_loss,
       sum(cs_net_profit) as catalog_sales_profit
from store_sales, store_returns, catalog_sales,
     date_dim d1, date_dim d2, date_dim d3, store, item
where d1.d_moy = 4 and d1.d_year = 2001
  and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk
  and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk
  and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk
  and d2.d_moy between 4 and 10 and d2.d_year = 2001
  and sr_customer_sk = cs_bill_customer_sk
  and sr_item_sk = cs_item_sk
  and cs_sold_date_sk = d3.d_date_sk
  and d3.d_moy between 4 and 10 and d3.d_year = 2001
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name
limit 100""",
    # q29: the same chain, quantities over a wider catalog window
    "q29": """
select i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_quantity) as store_sales_quantity,
       sum(sr_return_quantity) as store_returns_quantity,
       sum(cs_quantity) as catalog_sales_quantity
from store_sales, store_returns, catalog_sales,
     date_dim d1, date_dim d2, date_dim d3, store, item
where d1.d_moy = 9 and d1.d_year = 1999
  and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk
  and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk
  and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk
  and d2.d_moy between 9 and 12 and d2.d_year = 1999
  and sr_customer_sk = cs_bill_customer_sk
  and sr_item_sk = cs_item_sk
  and cs_sold_date_sk = d3.d_date_sk
  and d3.d_year in (1999, 2000, 2001)
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name
limit 100""",
    # q40: catalog sales net of refunds by warehouse state around a
    # pivot date (left join to returns; NULL refund -> full price)
    "q40": """
select w_state, i_item_id,
  sum(case when d_date < date '2000-03-11' then
        case when cr_refunded_cash is null then cs_sales_price
             else cs_sales_price - cr_refunded_cash end
      else 0 end) as sales_before,
  sum(case when d_date >= date '2000-03-11' then
        case when cr_refunded_cash is null then cs_sales_price
             else cs_sales_price - cr_refunded_cash end
      else 0 end) as sales_after
from catalog_sales
  left join catalog_returns
    on cs_order_number = cr_order_number
   and cs_item_sk = cr_item_sk,
  warehouse, item, date_dim
where i_current_price between 0.99 and 1.49
  and i_item_sk = cs_item_sk
  and cs_warehouse_sk = w_warehouse_sk
  and cs_sold_date_sk = d_date_sk
  and d_date between date '2000-02-10' and date '2000-04-10'
group by w_state, i_item_id
order by w_state, i_item_id
limit 100""",
    # q50: return-lag day buckets per store for August-2001 returns
    "q50": """
select s_store_name, s_store_id,
  sum(case when sr_returned_date_sk - ss_sold_date_sk <= 30
      then 1 else 0 end) as d30,
  sum(case when sr_returned_date_sk - ss_sold_date_sk > 30
           and sr_returned_date_sk - ss_sold_date_sk <= 60
      then 1 else 0 end) as d60,
  sum(case when sr_returned_date_sk - ss_sold_date_sk > 60
           and sr_returned_date_sk - ss_sold_date_sk <= 90
      then 1 else 0 end) as d90,
  sum(case when sr_returned_date_sk - ss_sold_date_sk > 90
           and sr_returned_date_sk - ss_sold_date_sk <= 120
      then 1 else 0 end) as d120,
  sum(case when sr_returned_date_sk - ss_sold_date_sk > 120
      then 1 else 0 end) as dmore
from store_sales, store_returns, store, date_dim d2
where d2.d_year = 2001 and d2.d_moy = 8
  and ss_ticket_number = sr_ticket_number
  and ss_item_sk = sr_item_sk
  and ss_customer_sk = sr_customer_sk
  and sr_returned_date_sk = d2.d_date_sk
  and ss_store_sk = s_store_sk
group by s_store_name, s_store_id
order by s_store_name, s_store_id
limit 100""",
    # q93: per-customer sales net of returns for one return reason
    "q93": """
select ss_customer_sk, sum(act_sales) as sumsales
from (select ss_customer_sk,
             (ss_quantity - sr_return_quantity) * ss_sales_price
               as act_sales
      from store_sales, store_returns, reason
      where sr_item_sk = ss_item_sk
        and sr_ticket_number = ss_ticket_number
        and sr_reason_sk = r_reason_sk
        and r_reason_desc = 'Stopped working') t
group by ss_customer_sk
order by sumsales, ss_customer_sk
limit 100""",
    # q16: catalog orders shipped cross-warehouse with no returns.
    # COUNT(DISTINCT order) restated exactly as a per-order derived
    # aggregate (count of groups == count of distinct orders; the sums
    # are sums of per-order sums)
    "q16": """
select count(*) as order_count,
       sum(ship) as total_shipping_cost,
       sum(profit) as total_net_profit
from (select cs_order_number,
             sum(cs_ext_ship_cost) as ship,
             sum(cs_net_profit) as profit
      from catalog_sales cs1, date_dim, customer_address, call_center
      where d_date between date '1999-02-01' and date '1999-04-01'
        and cs1.cs_ship_date_sk = d_date_sk
        and cs1.cs_ship_addr_sk = ca_address_sk
        and ca_state = 'GA'
        and cs1.cs_call_center_sk = cc_call_center_sk
        and cc_county = 'Salem County'
        and exists (select * from catalog_sales cs2
                    where cs1.cs_order_number = cs2.cs_order_number
                      and cs1.cs_warehouse_sk <> cs2.cs_warehouse_sk)
        and not exists (select * from catalog_returns cr1
                        where cs1.cs_order_number
                              = cr1.cr_order_number)
      group by cs_order_number) o
limit 100""",
    # q94: the web twin of q16
    "q94": """
select count(*) as order_count,
       sum(ship) as total_shipping_cost,
       sum(profit) as total_net_profit
from (select ws_order_number,
             sum(ws_ext_ship_cost) as ship,
             sum(ws_net_profit) as profit
      from web_sales ws1, date_dim, customer_address, web_site
      where d_date between date '1999-02-01' and date '1999-04-01'
        and ws1.ws_ship_date_sk = d_date_sk
        and ws1.ws_ship_addr_sk = ca_address_sk
        and ca_state = 'GA'
        and ws1.ws_web_site_sk = web_site_sk
        and web_company_name = 'ought'
        and exists (select * from web_sales ws2
                    where ws1.ws_order_number = ws2.ws_order_number
                      and ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk)
        and not exists (select * from web_returns wr1
                        where ws1.ws_order_number
                              = wr1.wr_order_number)
      group by ws_order_number) o
limit 100""",
    # q62: web shipping-delay buckets (q99's web twin)
    "q62": """
select substring(w_warehouse_name, 1, 20) as wname, sm_type, web_name,
  sum(case when ws_ship_date_sk - ws_sold_date_sk <= 30
      then 1 else 0 end) as d30,
  sum(case when ws_ship_date_sk - ws_sold_date_sk > 30
           and ws_ship_date_sk - ws_sold_date_sk <= 60
      then 1 else 0 end) as d60,
  sum(case when ws_ship_date_sk - ws_sold_date_sk > 60
           and ws_ship_date_sk - ws_sold_date_sk <= 90
      then 1 else 0 end) as d90,
  sum(case when ws_ship_date_sk - ws_sold_date_sk > 90
           and ws_ship_date_sk - ws_sold_date_sk <= 120
      then 1 else 0 end) as d120,
  sum(case when ws_ship_date_sk - ws_sold_date_sk > 120
      then 1 else 0 end) as dmore
from web_sales, warehouse, ship_mode, web_site, date_dim
where d_month_seq between 36 and 47
  and ws_ship_date_sk = d_date_sk
  and ws_warehouse_sk = w_warehouse_sk
  and ws_ship_mode_sk = sm_ship_mode_sk
  and ws_web_site_sk = web_site_sk
group by wname, sm_type, web_name
order by wname, sm_type, web_name
limit 100""",
    # q81: catalog returners above 1.2x their return-state average
    "q81": """
with customer_total_return as (
  select cr_returning_customer_sk as ctr_customer_sk,
         ca_state as ctr_state,
         sum(cr_return_amount) as ctr_total_return
  from catalog_returns, date_dim, customer_address
  where cr_returned_date_sk = d_date_sk and d_year = 2000
    and cr_returning_addr_sk = ca_address_sk
  group by cr_returning_customer_sk, ca_state)
select c_customer_id, c_salutation, c_first_name, c_last_name,
       ctr_total_return
from customer_total_return ctr1, customer_address, customer
where ctr1.ctr_total_return >
      1.2 * (select avg(ctr2.ctr_total_return)
             from customer_total_return ctr2
             where ctr1.ctr_state = ctr2.ctr_state)
  and ca_address_sk = c_current_addr_sk
  and ca_state = 'GA'
  and ctr1.ctr_customer_sk = c_customer_sk
order by c_customer_id, c_salutation, c_first_name, c_last_name,
         ctr_total_return
limit 100""",
    # q30: the web twin of q81
    "q30": """
with customer_total_return as (
  select wr_returning_customer_sk as ctr_customer_sk,
         ca_state as ctr_state,
         sum(wr_return_amt) as ctr_total_return
  from web_returns, date_dim, customer_address
  where wr_returned_date_sk = d_date_sk and d_year = 2000
    and wr_returning_addr_sk = ca_address_sk
  group by wr_returning_customer_sk, ca_state)
select c_customer_id, c_salutation, c_first_name, c_last_name,
       ctr_total_return
from customer_total_return ctr1, customer_address, customer
where ctr1.ctr_total_return >
      1.2 * (select avg(ctr2.ctr_total_return)
             from customer_total_return ctr2
             where ctr1.ctr_state = ctr2.ctr_state)
  and ca_address_sk = c_current_addr_sk
  and ca_state = 'MO'
  and ctr1.ctr_customer_sk = c_customer_sk
order by c_customer_id, c_salutation, c_first_name, c_last_name,
         ctr_total_return
limit 100""",
    # q61: promotional share of Jewelry sales. The official cross join
    # of two single-row derived tables restates exactly as one pass:
    # the promotion dimension is N:1 total, so joining it in the
    # "all sales" leg changes nothing, and the promotional leg becomes
    # a CASE-filtered sum
    "q61": """
select sum(case when p_channel_dmail = 'Y' or p_channel_email = 'Y'
                 or p_channel_tv = 'Y'
            then ss_ext_sales_price else 0 end) as promotions,
       sum(ss_ext_sales_price) as total
from store_sales, store, promotion, date_dim, customer,
     customer_address, item
where ss_sold_date_sk = d_date_sk
  and ss_store_sk = s_store_sk
  and ss_promo_sk = p_promo_sk
  and ss_customer_sk = c_customer_sk
  and ca_address_sk = c_current_addr_sk
  and ss_item_sk = i_item_sk
  and ca_gmt_offset = -5
  and i_category = 'Jewelry'
  and s_gmt_offset = -5
  and d_year = 1998 and d_moy = 11""",
    # q88: half-hour store traffic bands. The official 8-way cross join
    # of single-row counts restates exactly as 8 CASE-filtered sums
    # over one pass (all legs share the demographic and store filters)
    "q88": """
select
  sum(case when t_hour = 8 and t_minute >= 30 then 1 else 0 end)
    as h8_30_to_9,
  sum(case when t_hour = 9 and t_minute < 30 then 1 else 0 end)
    as h9_to_9_30,
  sum(case when t_hour = 9 and t_minute >= 30 then 1 else 0 end)
    as h9_30_to_10,
  sum(case when t_hour = 10 and t_minute < 30 then 1 else 0 end)
    as h10_to_10_30,
  sum(case when t_hour = 10 and t_minute >= 30 then 1 else 0 end)
    as h10_30_to_11,
  sum(case when t_hour = 11 and t_minute < 30 then 1 else 0 end)
    as h11_to_11_30,
  sum(case when t_hour = 11 and t_minute >= 30 then 1 else 0 end)
    as h11_30_to_12,
  sum(case when t_hour = 12 and t_minute < 30 then 1 else 0 end)
    as h12_to_12_30
from store_sales, household_demographics, time_dim, store
where ss_sold_time_sk = t_time_sk
  and ss_hdemo_sk = hd_demo_sk
  and ss_store_sk = s_store_sk
  and t_hour between 8 and 12
  and ((hd_dep_count = 4 and hd_vehicle_count <= 6)
       or (hd_dep_count = 2 and hd_vehicle_count <= 4)
       or (hd_dep_count = 0 and hd_vehicle_count <= 2))
  and s_store_name = 'ese'""",
    # q91: call-center catalog-return losses by demographic band
    # (window widened to the year and the gmt conjunct dropped — the
    # official compound selectivity is vacuous at synthetic test scale,
    # same adaptation practice as q65's month window)
    "q91": """
select cc_name, cd_marital_status, cd_education_status,
       sum(cr_net_loss) as returns_loss
from call_center, catalog_returns, date_dim, customer,
     customer_demographics, household_demographics
where cr_call_center_sk = cc_call_center_sk
  and cr_returned_date_sk = d_date_sk
  and cr_returning_customer_sk = c_customer_sk
  and cd_demo_sk = c_current_cdemo_sk
  and hd_demo_sk = c_current_hdemo_sk
  and d_year = 1998
  and ((cd_marital_status = 'M' and cd_education_status = 'Unknown')
       or (cd_marital_status = 'W'
           and cd_education_status = 'Advanced Degree'))
  and hd_buy_potential like 'Unknown%'
group by cc_name, cd_marital_status, cd_education_status
order by returns_loss desc, cc_name, cd_marital_status,
         cd_education_status""",
    # q17: quantity statistics (count/avg/stddev_samp) over the store
    # sale -> return -> catalog re-purchase chain by item and store
    # state (the cov ratio columns are display math and are omitted)
    "q17": """
select i_item_id, i_item_desc, s_state,
       count(ss_quantity) as store_sales_quantitycount,
       avg(ss_quantity) as store_sales_quantityave,
       stddev_samp(ss_quantity) as store_sales_quantitystdev,
       count(sr_return_quantity) as store_returns_quantitycount,
       avg(sr_return_quantity) as store_returns_quantityave,
       stddev_samp(sr_return_quantity) as store_returns_quantitystdev,
       count(cs_quantity) as catalog_sales_quantitycount,
       avg(cs_quantity) as catalog_sales_quantityave,
       stddev_samp(cs_quantity) as catalog_sales_quantitystdev
from store_sales, store_returns, catalog_sales,
     date_dim d1, date_dim d2, date_dim d3, store, item
where d1.d_qoy = 1 and d1.d_year = 2001
  and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk
  and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk
  and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk
  and d2.d_qoy in (1, 2, 3) and d2.d_year = 2001
  and sr_customer_sk = cs_bill_customer_sk
  and sr_item_sk = cs_item_sk
  and cs_sold_date_sk = d3.d_date_sk
  and d3.d_qoy in (1, 2, 3) and d3.d_year = 2001
group by i_item_id, i_item_desc, s_state
order by i_item_id, i_item_desc, s_state
limit 100""",
    # q39: warehouse/item inventory demand variability across two
    # consecutive months (cov threshold adapted to the uniform
    # synthetic quantities: 0.5 instead of 1, same practice as q65)
    "q39": """
with inv as (
  select w_warehouse_sk, i_item_sk, d_moy,
         stddev_samp(inv_quantity_on_hand) as stdev,
         avg(inv_quantity_on_hand) as mean
  from inventory, item, warehouse, date_dim
  where inv_item_sk = i_item_sk
    and inv_warehouse_sk = w_warehouse_sk
    and inv_date_sk = d_date_sk
    and d_year = 2001
  group by w_warehouse_sk, i_item_sk, d_moy)
select inv1.w_warehouse_sk as wsk, inv1.i_item_sk as isk,
       inv1.d_moy as moy1, inv1.mean as mean1, inv1.stdev as stdev1,
       inv2.d_moy as moy2, inv2.mean as mean2, inv2.stdev as stdev2
from inv inv1, inv inv2
where inv1.i_item_sk = inv2.i_item_sk
  and inv1.w_warehouse_sk = inv2.w_warehouse_sk
  and inv1.d_moy = 1
  and inv2.d_moy = 2
  and inv1.stdev / inv1.mean > 0.5
  and inv2.stdev / inv2.mean > 0.5
order by wsk, isk
limit 100""",
    # q27: demographic item averages by store state (ROLLUP restated
    # flat at its finest grouping, the practice used for every rollup)
    "q27": """
select i_item_id, s_state,
       avg(ss_quantity) as agg1, avg(ss_list_price) as agg2,
       avg(ss_coupon_amt) as agg3, avg(ss_sales_price) as agg4
from store_sales, customer_demographics, date_dim, store, item
where ss_sold_date_sk = d_date_sk
  and ss_item_sk = i_item_sk
  and ss_store_sk = s_store_sk
  and ss_cdemo_sk = cd_demo_sk
  and cd_gender = 'M' and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and d_year = 2002 and s_state = 'TN'
group by i_item_id, s_state
order by i_item_id, s_state
limit 100""",
    # q18: catalog averages by item and bill-to geography for chosen
    # birth months (ROLLUP restated flat; the unfiltered cd2 join is
    # N:1 total and drops out)
    "q18": """
select i_item_id, ca_country, ca_state, ca_county,
       avg(cs_quantity) as agg1, avg(cs_list_price) as agg2,
       avg(cs_coupon_amt) as agg3, avg(cs_sales_price) as agg4,
       avg(cs_net_profit) as agg5, avg(c_birth_year) as agg6,
       avg(cd_dep_count) as agg7
from catalog_sales, customer_demographics, customer,
     customer_address, date_dim, item
where cs_sold_date_sk = d_date_sk
  and cs_item_sk = i_item_sk
  and cs_bill_cdemo_sk = cd_demo_sk
  and cs_bill_customer_sk = c_customer_sk
  and cd_gender = 'F' and cd_education_status = 'Unknown'
  and c_birth_month in (1, 6, 8, 9, 12, 2)
  and d_year = 1998
  and c_current_addr_sk = ca_address_sk
  and ca_state in ('MS', 'GA', 'NM', 'OH', 'TX')
group by i_item_id, ca_country, ca_state, ca_county
order by i_item_id, ca_country, ca_state, ca_county
limit 100""",
    # q9: five quantity-band buckets picked by CASE over scalar
    # subqueries, driven off a one-row reason scan (count thresholds
    # adapted to synthetic scale, same practice as q65/q91)
    "q9": """
select
  case when (select count(*) from store_sales
             where ss_quantity between 1 and 20) > 10000
       then (select avg(ss_ext_discount_amt) from store_sales
             where ss_quantity between 1 and 20)
       else (select avg(ss_net_paid) from store_sales
             where ss_quantity between 1 and 20) end as bucket1,
  case when (select count(*) from store_sales
             where ss_quantity between 21 and 40) > 10000
       then (select avg(ss_ext_discount_amt) from store_sales
             where ss_quantity between 21 and 40)
       else (select avg(ss_net_paid) from store_sales
             where ss_quantity between 21 and 40) end as bucket2,
  case when (select count(*) from store_sales
             where ss_quantity between 41 and 60) > 10000
       then (select avg(ss_ext_discount_amt) from store_sales
             where ss_quantity between 41 and 60)
       else (select avg(ss_net_paid) from store_sales
             where ss_quantity between 41 and 60) end as bucket3,
  case when (select count(*) from store_sales
             where ss_quantity between 61 and 80) > 10000
       then (select avg(ss_ext_discount_amt) from store_sales
             where ss_quantity between 61 and 80)
       else (select avg(ss_net_paid) from store_sales
             where ss_quantity between 61 and 80) end as bucket4,
  case when (select count(*) from store_sales
             where ss_quantity between 81 and 100) > 10000
       then (select avg(ss_ext_discount_amt) from store_sales
             where ss_quantity between 81 and 100)
       else (select avg(ss_net_paid) from store_sales
             where ss_quantity between 81 and 100) end as bucket5
from reason
where r_reason_sk = 1""",
    # q74: customers whose web spending grew faster than their store
    # spending year over year. The official UNION ALL year_total CTE
    # with a literal sale_type column restates exactly as one CTE per
    # channel (each self-join leg filters to a single sale_type)
    "q74": """
with store_total as (
  select c_customer_id as customer_id,
         c_first_name as customer_first_name,
         c_last_name as customer_last_name,
         d_year as yr, sum(ss_net_paid) as year_total
  from customer, store_sales, date_dim
  where c_customer_sk = ss_customer_sk
    and ss_sold_date_sk = d_date_sk
    and d_year in (1998, 1999)
  group by c_customer_id, c_first_name, c_last_name, d_year),
web_total as (
  select c_customer_id as customer_id,
         c_first_name as customer_first_name,
         c_last_name as customer_last_name,
         d_year as yr, sum(ws_net_paid) as year_total
  from customer, web_sales, date_dim
  where c_customer_sk = ws_bill_customer_sk
    and ws_sold_date_sk = d_date_sk
    and d_year in (1998, 1999)
  group by c_customer_id, c_first_name, c_last_name, d_year)
select s2.customer_id, s2.customer_first_name,
       s2.customer_last_name
from store_total s1, store_total s2, web_total w1, web_total w2
where s2.customer_id = s1.customer_id
  and s1.customer_id = w1.customer_id
  and s1.customer_id = w2.customer_id
  and s1.yr = 1998 and s2.yr = 1999
  and w1.yr = 1998 and w2.yr = 1999
  and s1.year_total > 0
  and w1.year_total > 0
  and w2.year_total / w1.year_total
      > s2.year_total / s1.year_total
order by customer_id, customer_first_name, customer_last_name
limit 100""",
    # q36: gross margin by category/class (ROLLUP + lochierarchy rank
    # restated flat at the finest grouping; margin sorts via its
    # output alias)
    "q36": """
select sum(ss_net_profit) / sum(ss_ext_sales_price) as gross_margin,
       i_category, i_class
from store_sales, date_dim, item, store
where d_year = 2001
  and d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk
  and s_store_sk = ss_store_sk
  and s_state = 'TN'
group by i_category, i_class
order by gross_margin, i_category, i_class
limit 100""",
    # q86: web revenue by category/class (ROLLUP restated flat)
    "q86": """
select sum(ws_net_paid) as total_sum, i_category, i_class
from web_sales, date_dim, item
where d_month_seq between 24 and 35
  and d_date_sk = ws_sold_date_sk
  and i_item_sk = ws_item_sk
group by i_category, i_class
order by total_sum desc, i_category, i_class
limit 100""",
    # q22: average inventory quantity by item attributes (ROLLUP
    # restated flat; i_product_name adapted to i_item_id)
    "q22": """
select i_item_id, i_brand, i_class, i_category,
       avg(inv_quantity_on_hand) as qoh
from inventory, date_dim, item
where inv_date_sk = d_date_sk
  and inv_item_sk = i_item_sk
  and d_month_seq between 24 and 35
group by i_item_id, i_brand, i_class, i_category
order by qoh, i_item_id, i_brand, i_class, i_category
limit 100""",
    # q53: manufacturers whose quarterly revenue deviates >10% from
    # their yearly average (q89's partition-average restatement by
    # manufacturer and quarter)
    "q53": """
with msum as (
  select i_manufact_id, d_qoy,
         sum(ss_sales_price) as sum_sales
  from item, store_sales, date_dim, store
  where ss_item_sk = i_item_sk
    and ss_sold_date_sk = d_date_sk
    and ss_store_sk = s_store_sk
    and d_year = 1999
    and ((i_category in ('Books', 'Children', 'Electronics')
          and i_class in ('class#01', 'class#02', 'class#03'))
         or (i_category in ('Women', 'Music', 'Men')
             and i_class in ('class#04', 'class#05', 'class#06')))
  group by i_manufact_id, d_qoy),
mavg as (
  select i_manufact_id as a_id,
         avg(sum_sales) as avg_quarterly_sales
  from msum
  group by i_manufact_id)
select i_manufact_id, d_qoy, sum_sales, avg_quarterly_sales
from msum, mavg
where i_manufact_id = a_id
  and avg_quarterly_sales > 0
  and abs(sum_sales - avg_quarterly_sales) / avg_quarterly_sales
      > 0.1
order by avg_quarterly_sales, sum_sales, i_manufact_id, d_qoy
limit 100""",
    # q10: demographics of county customers who bought in a store AND
    # in at least one remote channel in the window (EXISTS plus an
    # OR of EXISTS, decorrelated through counting scalar joins;
    # dep-employed/college columns adapted to cd_dep_count)
    "q10": """
select cd_gender, cd_marital_status, cd_education_status,
       cd_purchase_estimate, cd_credit_rating, cd_dep_count,
       count(*) as cnt
from customer c, customer_address ca, customer_demographics
where c.c_current_addr_sk = ca.ca_address_sk
  and ca_county in ('Salem County', 'Terrell County',
                    'Arthur County', 'Oglethorpe County',
                    'Lunenburg County')
  and cd_demo_sk = c.c_current_cdemo_sk
  and exists (select * from store_sales, date_dim
              where c.c_customer_sk = ss_customer_sk
                and ss_sold_date_sk = d_date_sk
                and d_year = 2002 and d_moy between 1 and 4)
  and (exists (select * from web_sales, date_dim
               where c.c_customer_sk = ws_bill_customer_sk
                 and ws_sold_date_sk = d_date_sk
                 and d_year = 2002 and d_moy between 1 and 4)
       or exists (select * from catalog_sales, date_dim
                  where c.c_customer_sk = cs_bill_customer_sk
                    and cs_sold_date_sk = d_date_sk
                    and d_year = 2002 and d_moy between 1 and 4))
group by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating, cd_dep_count
order by cd_gender, cd_marital_status, cd_education_status,
         cd_purchase_estimate, cd_credit_rating, cd_dep_count
limit 100""",
    # q35: q10's state-level twin with dep-count statistics
    "q35": """
select ca_state, cd_gender, cd_marital_status, cd_dep_count,
       count(*) as cnt1, min(cd_dep_count) as mn,
       max(cd_dep_count) as mx, avg(cd_dep_count) as av
from customer c, customer_address ca, customer_demographics
where c.c_current_addr_sk = ca.ca_address_sk
  and cd_demo_sk = c.c_current_cdemo_sk
  and exists (select * from store_sales, date_dim
              where c.c_customer_sk = ss_customer_sk
                and ss_sold_date_sk = d_date_sk
                and d_year = 2002 and d_qoy < 4)
  and (exists (select * from web_sales, date_dim
               where c.c_customer_sk = ws_bill_customer_sk
                 and ws_sold_date_sk = d_date_sk
                 and d_year = 2002 and d_qoy < 4)
       or exists (select * from catalog_sales, date_dim
                  where c.c_customer_sk = cs_bill_customer_sk
                    and cs_sold_date_sk = d_date_sk
                    and d_year = 2002 and d_qoy < 4))
group by ca_state, cd_gender, cd_marital_status, cd_dep_count
order by ca_state, cd_gender, cd_marital_status, cd_dep_count
limit 100""",
    # q63: q53's twin — managers whose monthly revenue deviates >10%
    # from their yearly average
    "q63": """
with msum as (
  select i_manager_id, d_moy,
         sum(ss_sales_price) as sum_sales
  from item, store_sales, date_dim, store
  where ss_item_sk = i_item_sk
    and ss_sold_date_sk = d_date_sk
    and ss_store_sk = s_store_sk
    and d_year = 1999
    and ((i_category in ('Books', 'Children', 'Electronics')
          and i_class in ('class#01', 'class#02', 'class#03'))
         or (i_category in ('Women', 'Music', 'Men')
             and i_class in ('class#04', 'class#05', 'class#06')))
  group by i_manager_id, d_moy),
mavg as (
  select i_manager_id as a_id,
         avg(sum_sales) as avg_monthly_sales
  from msum
  group by i_manager_id)
select i_manager_id, d_moy, sum_sales, avg_monthly_sales
from msum, mavg
where i_manager_id = a_id
  and avg_monthly_sales > 0
  and abs(sum_sales - avg_monthly_sales) / avg_monthly_sales > 0.1
order by i_manager_id, avg_monthly_sales, sum_sales, d_moy
limit 100""",
    # q67: top-ranked item/month/store revenue cells per category
    # (ROLLUP restated flat at the finest grouping; i_product_name
    # adapted to i_item_id; full tiebreakers added to the sort)
    "q67": """
select i_category, i_class, i_brand, i_item_id, d_year, d_qoy,
       d_moy, s_store_id, sumsales, rk
from (select i_category, i_class, i_brand, i_item_id, d_year,
             d_qoy, d_moy, s_store_id, sumsales,
             rank() over (partition by i_category
                          order by sumsales desc) as rk
      from (select i_category, i_class, i_brand, i_item_id,
                   d_year, d_qoy, d_moy, s_store_id,
                   sum(ss_sales_price * ss_quantity) as sumsales
            from store_sales, date_dim, store, item
            where ss_sold_date_sk = d_date_sk
              and ss_item_sk = i_item_sk
              and ss_store_sk = s_store_sk
              and d_month_seq between 24 and 35
            group by i_category, i_class, i_brand, i_item_id,
                     d_year, d_qoy, d_moy, s_store_id) t) w
where rk <= 100
order by i_category, rk, i_class, i_brand, i_item_id, d_year,
         d_qoy, d_moy, s_store_id
limit 100""",
    # q70: county profit ranked within state (ROLLUP + the
    # tautological top-5-state IN subquery restated flat — partition
    # by s_state over one row per state always ranks 1)
    "q70": """
select s_state, s_county, sumsales, rk
from (select s_state, s_county, sumsales,
             rank() over (partition by s_state
                          order by sumsales desc) as rk
      from (select s_state, s_county,
                   sum(ss_net_profit) as sumsales
            from store_sales, date_dim, store
            where ss_sold_date_sk = d_date_sk
              and ss_store_sk = s_store_sk
              and d_month_seq between 24 and 35
            group by s_state, s_county) t) w
order by s_state, rk, s_county
limit 100""",
    # q44: best vs worst items by average profit at one store
    # (row_number with an item tiebreaker instead of rank, so the
    # rnk = rnk join never fans out on avg ties)
    "q44": """
with v as (
  select ss_item_sk as item_sk, avg(ss_net_profit) as avgp
  from store_sales
  where ss_store_sk = 4
  group by ss_item_sk)
select a.rnk as rnk, i1.i_item_id as best_performing,
       i2.i_item_id as worst_performing
from (select item_sk, rnk from (
        select item_sk,
               row_number() over (order by avgp desc, item_sk)
                 as rnk from v) x
      where rnk < 11) a,
     (select item_sk, rnk from (
        select item_sk,
               row_number() over (order by avgp, item_sk)
                 as rnk from v) y
      where rnk < 11) b,
     item i1, item i2
where a.rnk = b.rnk
  and i1.i_item_sk = a.item_sk
  and i2.i_item_sk = b.item_sk
order by rnk
limit 100""",
    # q11: q74's twin over list-price-minus-discount revenue with the
    # preferred-customer flag carried (same per-channel CTE
    # restatement of the official UNION ALL year_total)
    "q11": """
with store_total as (
  select c_customer_id as customer_id,
         c_preferred_cust_flag as flag,
         d_year as yr,
         sum(ss_ext_list_price - ss_ext_discount_amt) as year_total
  from customer, store_sales, date_dim
  where c_customer_sk = ss_customer_sk
    and ss_sold_date_sk = d_date_sk
    and d_year in (1998, 1999)
  group by c_customer_id, c_preferred_cust_flag, d_year),
web_total as (
  select c_customer_id as customer_id,
         c_preferred_cust_flag as flag,
         d_year as yr,
         sum(ws_ext_list_price - ws_ext_discount_amt) as year_total
  from customer, web_sales, date_dim
  where c_customer_sk = ws_bill_customer_sk
    and ws_sold_date_sk = d_date_sk
    and d_year in (1998, 1999)
  group by c_customer_id, c_preferred_cust_flag, d_year)
select s2.customer_id, s2.flag
from store_total s1, store_total s2, web_total w1, web_total w2
where s2.customer_id = s1.customer_id
  and s1.customer_id = w1.customer_id
  and s1.customer_id = w2.customer_id
  and s1.yr = 1998 and s2.yr = 1999
  and w1.yr = 1998 and w2.yr = 1999
  and s1.year_total > 0
  and w1.year_total > 0
  and w2.year_total / w1.year_total
      > s2.year_total / s1.year_total
order by customer_id, flag
limit 100""",
    # q31: counties where web sales grew faster than store sales in
    # consecutive 2000 quarters (6-way self-join of per-channel CTEs;
    # the zero-denominator CASEs drop to plain >0 guards — a NULL
    # comparison is never satisfied either way)
    "q31": """
with ss as (
  select ca_county, d_qoy, d_year,
         sum(ss_ext_sales_price) as store_sales
  from store_sales, date_dim, customer_address
  where ss_sold_date_sk = d_date_sk
    and ss_addr_sk = ca_address_sk
  group by ca_county, d_qoy, d_year),
ws as (
  select ca_county, d_qoy, d_year,
         sum(ws_ext_sales_price) as web_sales
  from web_sales, date_dim, customer_address
  where ws_sold_date_sk = d_date_sk
    and ws_bill_addr_sk = ca_address_sk
  group by ca_county, d_qoy, d_year)
select ss1.ca_county, ss1.d_year,
       ws2.web_sales / ws1.web_sales as web_q1_q2_increase,
       ss2.store_sales / ss1.store_sales as store_q1_q2_increase,
       ws3.web_sales / ws2.web_sales as web_q2_q3_increase,
       ss3.store_sales / ss2.store_sales as store_q2_q3_increase
from ss ss1, ss ss2, ss ss3, ws ws1, ws ws2, ws ws3
where ss1.d_qoy = 1 and ss1.d_year = 2000
  and ss1.ca_county = ss2.ca_county
  and ss2.d_qoy = 2 and ss2.d_year = 2000
  and ss2.ca_county = ss3.ca_county
  and ss3.d_qoy = 3 and ss3.d_year = 2000
  and ss1.ca_county = ws1.ca_county
  and ws1.d_qoy = 1 and ws1.d_year = 2000
  and ws1.ca_county = ws2.ca_county
  and ws2.d_qoy = 2 and ws2.d_year = 2000
  and ws2.ca_county = ws3.ca_county
  and ws3.d_qoy = 3 and ws3.d_year = 2000
  and ws1.web_sales > 0 and ss1.store_sales > 0
  and ws2.web_sales > 0 and ss2.store_sales > 0
  and ws2.web_sales / ws1.web_sales
      > ss2.store_sales / ss1.store_sales
  and ws3.web_sales / ws2.web_sales
      > ss3.store_sales / ss2.store_sales
order by ss1.ca_county""",
    # q38: customers buying in all three channels in one year. The
    # official INTERSECT of DISTINCT (last, first, date) triples
    # restates exactly as a 1:1 join of the three distinct derived
    # tables on the triple
    "q38": """
select count(*) as cnt
from (select distinct c_last_name as ln, c_first_name as fn,
             d_date as dt
      from store_sales, date_dim, customer
      where ss_sold_date_sk = d_date_sk
        and ss_customer_sk = c_customer_sk
        and d_month_seq between 24 and 35) s,
     (select distinct c_last_name as ln, c_first_name as fn,
             d_date as dt
      from catalog_sales, date_dim, customer
      where cs_sold_date_sk = d_date_sk
        and cs_bill_customer_sk = c_customer_sk
        and d_month_seq between 24 and 35) c,
     (select distinct c_last_name as ln, c_first_name as fn,
             d_date as dt
      from web_sales, date_dim, customer
      where ws_sold_date_sk = d_date_sk
        and ws_bill_customer_sk = c_customer_sk
        and d_month_seq between 24 and 35) w
where s.ln = c.ln and s.fn = c.fn and s.dt = c.dt
  and s.ln = w.ln and s.fn = w.fn and s.dt = w.dt""",
    # q89: months deviating >10% from the (category, brand, store)
    # yearly average — the official AVG() OVER (PARTITION BY) restates
    # exactly as a join against a per-partition average CTE (the q98
    # practice; company-name column adapted to s_store_name)
    "q89": """
with msum as (
  select i_category, i_brand, s_store_name, d_moy,
         sum(ss_sales_price) as sum_sales
  from item, store_sales, date_dim, store
  where ss_item_sk = i_item_sk
    and ss_sold_date_sk = d_date_sk
    and ss_store_sk = s_store_sk
    and d_year = 1999
    and ((i_category in ('Books', 'Electronics', 'Sports')
          and i_class in ('class#01', 'class#02', 'class#03'))
         or (i_category in ('Men', 'Jewelry', 'Women')
             and i_class in ('class#04', 'class#05', 'class#06')))
  group by i_category, i_brand, s_store_name, d_moy),
mavg as (
  select i_category as a_category, i_brand as a_brand,
         s_store_name as a_store_name,
         avg(sum_sales) as avg_monthly_sales
  from msum
  group by i_category, i_brand, s_store_name)
select i_category, i_brand, s_store_name, d_moy, sum_sales,
       avg_monthly_sales,
       sum_sales - avg_monthly_sales as diff
from msum, mavg
where i_category = a_category
  and i_brand = a_brand
  and s_store_name = a_store_name
  and avg_monthly_sales > 0
  and abs(sum_sales - avg_monthly_sales) / avg_monthly_sales > 0.1
order by diff, i_category, i_brand, s_store_name, d_moy
limit 100""",
    # q2: web+catalog weekly day-of-week sales, each week ratioed to
    # the same week one year later (53-week shift precomputed in the
    # second leg; week membership in a year via IN, avoiding the
    # official's row-duplicating date_dim join; ratios as plain
    # division, ROUND omitted)
    "q2": """
with wscs as (
  select ws_sold_date_sk as sold_date_sk,
         ws_ext_sales_price as sales_price
  from web_sales
  union all
  select cs_sold_date_sk as sold_date_sk,
         cs_ext_sales_price as sales_price
  from catalog_sales),
wswscs as (
  select d_week_seq,
         sum(case when d_day_name = 'Sunday'
             then sales_price else 0 end) as sun_sales,
         sum(case when d_day_name = 'Monday'
             then sales_price else 0 end) as mon_sales,
         sum(case when d_day_name = 'Tuesday'
             then sales_price else 0 end) as tue_sales,
         sum(case when d_day_name = 'Wednesday'
             then sales_price else 0 end) as wed_sales,
         sum(case when d_day_name = 'Thursday'
             then sales_price else 0 end) as thu_sales,
         sum(case when d_day_name = 'Friday'
             then sales_price else 0 end) as fri_sales,
         sum(case when d_day_name = 'Saturday'
             then sales_price else 0 end) as sat_sales
  from wscs, date_dim
  where d_date_sk = sold_date_sk
  group by d_week_seq)
select y.d_week_seq as week1,
       y.sun_sales / z.sun_sales as sun_ratio,
       y.mon_sales / z.mon_sales as mon_ratio,
       y.tue_sales / z.tue_sales as tue_ratio,
       y.wed_sales / z.wed_sales as wed_ratio,
       y.thu_sales / z.thu_sales as thu_ratio,
       y.fri_sales / z.fri_sales as fri_ratio,
       y.sat_sales / z.sat_sales as sat_ratio
from (select d_week_seq, sun_sales, mon_sales, tue_sales, wed_sales,
             thu_sales, fri_sales, sat_sales
      from wswscs
      where d_week_seq in (select d_week_seq from date_dim
                           where d_year = 2001)) y,
     (select d_week_seq - 53 as week_m53, sun_sales, mon_sales,
             tue_sales, wed_sales, thu_sales, fri_sales, sat_sales
      from wswscs
      where d_week_seq in (select d_week_seq from date_dim
                           where d_year = 2002)) z
where y.d_week_seq = z.week_m53
  and z.sun_sales > 0 and z.mon_sales > 0 and z.tue_sales > 0
  and z.wed_sales > 0 and z.thu_sales > 0 and z.fri_sales > 0
  and z.sat_sales > 0
order by week1""",
    # q4: customers whose catalog growth beats both store and web
    # growth (three per-channel CTEs as in q74/q11; the official /2
    # inside each sum scales every total equally and drops out of the
    # ratio comparisons; first-year totals of all channels guarded >0)
    "q4": """
with store_total as (
  select c_customer_id as customer_id,
         c_first_name as customer_first_name,
         c_last_name as customer_last_name,
         d_year as yr,
         sum(ss_ext_list_price - ss_ext_wholesale_cost
             - ss_ext_discount_amt + ss_ext_sales_price)
           as year_total
  from customer, store_sales, date_dim
  where c_customer_sk = ss_customer_sk
    and ss_sold_date_sk = d_date_sk
    and d_year in (1998, 1999)
  group by c_customer_id, c_first_name, c_last_name, d_year),
cat_total as (
  select c_customer_id as customer_id, d_year as yr,
         sum(cs_ext_list_price - cs_ext_wholesale_cost
             - cs_ext_discount_amt + cs_ext_sales_price)
           as year_total
  from customer, catalog_sales, date_dim
  where c_customer_sk = cs_bill_customer_sk
    and cs_sold_date_sk = d_date_sk
    and d_year in (1998, 1999)
  group by c_customer_id, d_year),
web_total as (
  select c_customer_id as customer_id, d_year as yr,
         sum(ws_ext_list_price - ws_ext_wholesale_cost
             - ws_ext_discount_amt + ws_ext_sales_price)
           as year_total
  from customer, web_sales, date_dim
  where c_customer_sk = ws_bill_customer_sk
    and ws_sold_date_sk = d_date_sk
    and d_year in (1998, 1999)
  group by c_customer_id, d_year)
select s2.customer_id, s2.customer_first_name,
       s2.customer_last_name
from store_total s1, store_total s2, cat_total c1, cat_total c2,
     web_total w1, web_total w2
where s2.customer_id = s1.customer_id
  and s1.customer_id = c1.customer_id
  and s1.customer_id = c2.customer_id
  and s1.customer_id = w1.customer_id
  and s1.customer_id = w2.customer_id
  and s1.yr = 1998 and s2.yr = 1999
  and c1.yr = 1998 and c2.yr = 1999
  and w1.yr = 1998 and w2.yr = 1999
  and s1.year_total > 0 and c1.year_total > 0
  and w1.year_total > 0
  and c2.year_total / c1.year_total
      > s2.year_total / s1.year_total
  and c2.year_total / c1.year_total
      > w2.year_total / w1.year_total
order by customer_id, customer_first_name, customer_last_name
limit 100""",
}


def _decode(data: TpcdsData, table: str, col: str) -> np.ndarray:
    d = data.dicts[col]
    vals = np.array(d.values + [b""], dtype=object)
    return vals[data.tables[table][col]]


def _desc_bytes(b: bytes) -> tuple:
    """Sort key inverting lexicographic byte order (DESC string sort)."""
    return tuple(255 - x for x in b) + (256,)


def _pk_map(data, table, pk, *cols):
    t = data.tables[table]
    out = {}
    for i, k in enumerate(t[pk].tolist()):
        out[k] = tuple(t[c][i] for c in cols)
    return out


def reference_answers(data: TpcdsData,
                      queries=None) -> dict[str, list[tuple]]:
    """Independent numpy/python reference results (the canondata)."""
    names = queries or sorted(QUERIES)
    ref = _Ref(data)  # shared: the lookup-dict helpers memoize on self
    out: dict[str, list[tuple]] = {}
    for name in names:
        out[name] = getattr(ref, name)()
    return out


class _Ref:
    def __init__(self, data: TpcdsData):
        self.d = data

    def _date_info(self):
        dd = self.d.tables["date_dim"]
        return {k: (y, m) for k, y, m in zip(
            dd["d_date_sk"].tolist(), dd["d_year"].tolist(),
            dd["d_moy"].tolist())}

    def _brand_rollup(self, manager_id=None, manufact_id=None,
                      moy=11, year=None, key="brand"):
        d = self.d
        ss = d.tables["store_sales"]
        it = d.tables["item"]
        dates = self._date_info()
        brands = _decode(d, "item", "i_brand")
        cats = _decode(d, "item", "i_category")
        imap = {}
        for i, sk in enumerate(it["i_item_sk"].tolist()):
            imap[sk] = i
        acc: dict = collections.defaultdict(int)
        for dk, ik, p in zip(ss["ss_sold_date_sk"].tolist(),
                             ss["ss_item_sk"].tolist(),
                             ss["ss_ext_sales_price"].tolist()):
            y, m = dates[dk]
            if m != moy or (year is not None and y != year):
                continue
            i = imap[ik]
            if manager_id is not None and \
                    it["i_manager_id"][i] != manager_id:
                continue
            if manufact_id is not None and \
                    it["i_manufact_id"][i] != manufact_id:
                continue
            if key == "brand":
                k = (y, int(it["i_brand_id"][i]), brands[i])
            elif key == "category":
                k = (y, int(it["i_category_id"][i]), cats[i])
            else:
                raise KeyError(key)
            acc[k] += p
        return acc

    def q3(self):
        acc = self._brand_rollup(manufact_id=128, moy=11)
        rows = [(y, b, bn, s) for (y, b, bn), s in acc.items()]
        rows.sort(key=lambda r: (r[0], -r[3], r[1]))
        return rows[:100]

    def _demo_avgs(self, fact, pfx, cdemo_col):
        d = self.d
        f = d.tables[fact]
        dd = d.tables["date_dim"]
        years = dict(zip(dd["d_date_sk"].tolist(),
                         dd["d_year"].tolist()))
        cd = d.tables["customer_demographics"]
        g = _decode(d, "customer_demographics", "cd_gender")
        m = _decode(d, "customer_demographics", "cd_marital_status")
        e = _decode(d, "customer_demographics", "cd_education_status")
        demo_ok = {sk for i, sk in enumerate(cd["cd_demo_sk"].tolist())
                   if g[i] == b"M" and m[i] == b"S"
                   and e[i] == b"College"}
        pr = d.tables["promotion"]
        em = _decode(d, "promotion", "p_channel_email")
        ev = _decode(d, "promotion", "p_channel_event")
        promo_ok = {sk for i, sk in enumerate(pr["p_promo_sk"].tolist())
                    if em[i] == b"N" or ev[i] == b"N"}
        item_ids = _decode(d, "item", "i_item_id")
        iid = dict(zip(self.d.tables["item"]["i_item_sk"].tolist(),
                       item_ids.tolist()))
        acc: dict = collections.defaultdict(
            lambda: [0, 0, 0, 0, 0])  # qty, list, coupon, sales, n
        for dk, ik, cdk, pk, q, lp, cp, sp in zip(
                f[pfx + "sold_date_sk"].tolist(),
                f[pfx + "item_sk"].tolist(),
                f[cdemo_col].tolist(),
                f[pfx + "promo_sk"].tolist(),
                f[pfx + "quantity"].tolist(),
                f[pfx + "list_price"].tolist(),
                f[pfx + "coupon_amt"].tolist(),
                f[pfx + "sales_price"].tolist()):
            if years[dk] != 2000 or cdk not in demo_ok \
                    or pk not in promo_ok:
                continue
            st = acc[iid[ik]]
            st[0] += q
            st[1] += lp
            st[2] += cp
            st[3] += sp
            st[4] += 1
        rows = [(k, st[0] / st[4], st[1] / st[4] / 100,
                 st[2] / st[4] / 100, st[3] / st[4] / 100)
                for k, st in sorted(acc.items())]
        return rows[:100]

    def q6(self):
        d = self.d
        dd = d.tables["date_dim"]
        target_seq = {int(s) for y, m, s in zip(
            dd["d_year"].tolist(), dd["d_moy"].tolist(),
            dd["d_month_seq"].tolist()) if y == 2001 and m == 1}
        assert len(target_seq) == 1
        seq = next(iter(target_seq))
        date_ok = {k for k, s in zip(dd["d_date_sk"].tolist(),
                                     dd["d_month_seq"].tolist())
                   if s == seq}
        it = d.tables["item"]
        cat_sum: dict = collections.defaultdict(lambda: [0, 0])
        for c, p in zip(it["i_category_id"].tolist(),
                        it["i_current_price"].tolist()):
            cat_sum[c][0] += p
            cat_sum[c][1] += 1
        cat_avg = {c: s / n for c, (s, n) in cat_sum.items()}
        pricey = {sk for sk, c, p in zip(
            it["i_item_sk"].tolist(), it["i_category_id"].tolist(),
            it["i_current_price"].tolist())
            if p > 1.2 * cat_avg[c]}
        cust_addr = dict(zip(
            d.tables["customer"]["c_customer_sk"].tolist(),
            d.tables["customer"]["c_current_addr_sk"].tolist()))
        states = _decode(d, "customer_address", "ca_state")
        addr_state = dict(zip(
            d.tables["customer_address"]["ca_address_sk"].tolist(),
            states.tolist()))
        ss = d.tables["store_sales"]
        cnt: dict = collections.Counter()
        for dk, ck, ik in zip(ss["ss_sold_date_sk"].tolist(),
                              ss["ss_customer_sk"].tolist(),
                              ss["ss_item_sk"].tolist()):
            if dk in date_ok and ik in pricey:
                cnt[addr_state[cust_addr[ck]]] += 1
        rows = [(st, n) for st, n in cnt.items() if n >= 10]
        rows.sort(key=lambda r: (r[1], r[0]))
        return rows[:100]

    def q7(self):
        return self._demo_avgs("store_sales", "ss_", "ss_cdemo_sk")

    def q26(self):
        return self._demo_avgs("catalog_sales", "cs_", "cs_bill_cdemo_sk")

    def q19(self):
        d = self.d
        ss = d.tables["store_sales"]
        it = d.tables["item"]
        dates = self._date_info()
        brands = _decode(d, "item", "i_brand")
        manufacts = _decode(d, "item", "i_manufact")
        imap = dict((sk, i) for i, sk in
                    enumerate(it["i_item_sk"].tolist()))
        cust_addr = dict(zip(
            d.tables["customer"]["c_customer_sk"].tolist(),
            d.tables["customer"]["c_current_addr_sk"].tolist()))
        azip = dict(zip(
            d.tables["customer_address"]["ca_address_sk"].tolist(),
            _decode(d, "customer_address", "ca_zip").tolist()))
        szip = dict(zip(d.tables["store"]["s_store_sk"].tolist(),
                        _decode(d, "store", "s_zip").tolist()))
        acc: dict = collections.defaultdict(int)
        for dk, ik, ck, sk, p in zip(
                ss["ss_sold_date_sk"].tolist(),
                ss["ss_item_sk"].tolist(),
                ss["ss_customer_sk"].tolist(),
                ss["ss_store_sk"].tolist(),
                ss["ss_ext_sales_price"].tolist()):
            y, m = dates[dk]
            if m != 11 or y != 1998:
                continue
            i = imap[ik]
            if it["i_manager_id"][i] != 8:
                continue
            if azip[cust_addr[ck]][:5] == szip[sk][:5]:
                continue
            acc[(int(it["i_brand_id"][i]), brands[i],
                 int(it["i_manufact_id"][i]), manufacts[i])] += p
        rows = [(b, bn, mi, mn, s) for (b, bn, mi, mn), s
                in acc.items()]
        rows.sort(key=lambda r: (-r[4], r[1], r[0], r[2], r[3]))
        return rows[:100]

    def _sales_dim_maps(self):
        """Shared q13/q48 lookup maps: date_sk->year, cd_demo_sk->
        (marital, education), ca_address_sk->(state, country)."""
        d = self.d
        dd = d.tables["date_dim"]
        years = dict(zip(dd["d_date_sk"].tolist(),
                         dd["d_year"].tolist()))
        cd = d.tables["customer_demographics"]
        m = _decode(d, "customer_demographics", "cd_marital_status")
        e = _decode(d, "customer_demographics", "cd_education_status")
        demo = {sk: (m[i], e[i]) for i, sk in
                enumerate(cd["cd_demo_sk"].tolist())}
        ca = d.tables["customer_address"]
        states = _decode(d, "customer_address", "ca_state")
        countries = _decode(d, "customer_address", "ca_country")
        addr = {sk: (states[i], countries[i]) for i, sk in
                enumerate(ca["ca_address_sk"].tolist())}
        return years, demo, addr

    def q13(self):
        d = self.d
        ss = d.tables["store_sales"]
        years, demo, addr = self._sales_dim_maps()
        hd = dict(zip(
            d.tables["household_demographics"]["hd_demo_sk"].tolist(),
            d.tables["household_demographics"]["hd_dep_count"].tolist()))
        qty_sum = esp_sum = ewc_sum = n_rows = 0
        for dk, hk, ck, ak, q, sp, esp, ewc, npf in zip(
                ss["ss_sold_date_sk"].tolist(),
                ss["ss_hdemo_sk"].tolist(),
                ss["ss_cdemo_sk"].tolist(),
                ss["ss_addr_sk"].tolist(),
                ss["ss_quantity"].tolist(),
                ss["ss_sales_price"].tolist(),
                ss["ss_ext_sales_price"].tolist(),
                ss["ss_ext_wholesale_cost"].tolist(),
                ss["ss_net_profit"].tolist()):
            if years[dk] != 2001:
                continue
            ms, ed = demo[ck]
            dep = hd[hk]
            band1 = (
                (ms == b"M" and ed == b"Advanced Degree"
                 and 10000 <= sp <= 15000 and dep == 3)
                or (ms == b"S" and ed == b"College"
                    and 5000 <= sp <= 10000 and dep == 1)
                or (ms == b"W" and ed == b"2 yr Degree"
                    and 15000 <= sp <= 20000 and dep == 1))
            if not band1:
                continue
            st, country = addr[ak]
            band2 = country == b"United States" and (
                (st in (b"TX", b"OH") and 10000 <= npf <= 20000)
                or (st in (b"OR", b"NM", b"KY")
                    and 15000 <= npf <= 30000)
                or (st in (b"VA", b"TX", b"MS")
                    and 5000 <= npf <= 25000))
            if not band2:
                continue
            qty_sum += q
            esp_sum += esp
            ewc_sum += ewc
            n_rows += 1
        if n_rows == 0:
            return [(None, None, None, None)]
        return [(qty_sum / n_rows, esp_sum / n_rows / 100,
                 ewc_sum / n_rows / 100, ewc_sum)]

    def q48(self):
        ss = self.d.tables["store_sales"]
        years, demo, addr = self._sales_dim_maps()
        total = 0
        for dk, ck, ak, q, sp, npf in zip(
                ss["ss_sold_date_sk"].tolist(),
                ss["ss_cdemo_sk"].tolist(),
                ss["ss_addr_sk"].tolist(),
                ss["ss_quantity"].tolist(),
                ss["ss_sales_price"].tolist(),
                ss["ss_net_profit"].tolist()):
            if years[dk] != 2001:
                continue
            ms, ed = demo[ck]
            band1 = (
                (ms == b"M" and ed == b"4 yr Degree"
                 and 10000 <= sp <= 15000)
                or (ms == b"D" and ed == b"2 yr Degree"
                    and 5000 <= sp <= 10000)
                or (ms == b"S" and ed == b"College"
                    and 15000 <= sp <= 20000))
            if not band1:
                continue
            st, country = addr[ak]
            band2 = country == b"United States" and (
                (st in (b"CO", b"OH", b"TX")
                 and 0 <= npf <= 200000)
                or (st in (b"OR", b"MN", b"KY")
                    and 15000 <= npf <= 300000)
                or (st in (b"VA", b"CA", b"MS")
                    and 5000 <= npf <= 2500000))
            if not band2:
                continue
            total += q
        return [(total if total else None,)]

    def q42(self):
        acc = self._brand_rollup(manager_id=1, moy=11, year=2000,
                                 key="category")
        rows = [(y, c, cn, s) for (y, c, cn), s in acc.items()]
        rows.sort(key=lambda r: (-r[3], r[0], r[1], r[2]))
        return rows[:100]

    def q43(self):
        d = self.d
        ss = d.tables["store_sales"]
        dd = d.tables["date_dim"]
        day_names = _decode(d, "date_dim", "d_day_name")
        dinfo = {k: (y, day_names[i]) for i, (k, y) in enumerate(zip(
            dd["d_date_sk"].tolist(), dd["d_year"].tolist()))}
        st = d.tables["store"]
        snames = _decode(d, "store", "s_store_name")
        sids = _decode(d, "store", "s_store_id")
        smap = {}
        for i, sk in enumerate(st["s_store_sk"].tolist()):
            if st["s_gmt_offset"][i] == -5:
                smap[sk] = (snames[i], sids[i])
        order = [b"Sunday", b"Monday", b"Tuesday", b"Wednesday",
                 b"Thursday", b"Friday", b"Saturday"]
        acc: dict = collections.defaultdict(lambda: [0] * 7)
        for dk, sk, p in zip(ss["ss_sold_date_sk"].tolist(),
                             ss["ss_store_sk"].tolist(),
                             ss["ss_sales_price"].tolist()):
            y, dn = dinfo[dk]
            if y != 2000 or sk not in smap:
                continue
            acc[smap[sk]][order.index(dn)] += p
        rows = [(k[0], k[1], *v) for k, v in acc.items()]
        rows.sort(key=lambda r: (r[0], r[1]))
        return rows[:100]

    def q52(self):
        acc = self._brand_rollup(manager_id=1, moy=11, year=2000)
        rows = [(y, b, bn, s) for (y, b, bn), s in acc.items()]
        rows.sort(key=lambda r: (r[0], -r[3], r[1]))
        return rows[:100]

    def q55(self):
        acc = self._brand_rollup(manager_id=28, moy=11, year=1999)
        rows = [(b, bn, s) for (y, b, bn), s in acc.items()]
        rows.sort(key=lambda r: (-r[2], r[0]))
        return rows[:100]

    def q96(self):
        d = self.d
        ss = d.tables["store_sales"]
        hd_ok = {sk for sk, c in zip(
            d.tables["household_demographics"]["hd_demo_sk"].tolist(),
            d.tables["household_demographics"]["hd_dep_count"].tolist())
            if c == 7}
        snames = _decode(d, "store", "s_store_name")
        s_ok = {sk for i, sk in enumerate(
            d.tables["store"]["s_store_sk"].tolist())
            if snames[i] == b"ese"}
        n = 0
        for tk, hk, sk in zip(ss["ss_sold_time_sk"].tolist(),
                              ss["ss_hdemo_sk"].tolist(),
                              ss["ss_store_sk"].tolist()):
            h, mnt = tk // 3600, (tk % 3600) // 60
            if h == 20 and mnt >= 30 and hk in hd_ok and sk in s_ok:
                n += 1
        return [(n,)]

    # ---- batch-1 additions (q15/q32/q34/q46/q65/q68/q73/q79/q98) ----

    def _hd(self):
        if getattr(self, "_hd_cache", None) is not None:
            return self._hd_cache
        hd = self.d.tables["household_demographics"]
        bp = _decode(self.d, "household_demographics",
                     "hd_buy_potential")
        self._hd_cache = {sk: (int(dep), int(veh), b)
                          for sk, dep, veh, b in zip(
                              hd["hd_demo_sk"].tolist(),
                              hd["hd_dep_count"].tolist(),
                              hd["hd_vehicle_count"].tolist(), bp)}
        return self._hd_cache

    def _dd(self):
        if getattr(self, "_dd_cache", None) is not None:
            return self._dd_cache
        dd = self.d.tables["date_dim"]
        self._dd_cache = {
            sk: (int(y), int(m), int(dom), int(dow), int(q),
                 int(dt), int(ms))
            for sk, y, m, dom, dow, q, dt, ms in zip(
                dd["d_date_sk"].tolist(), dd["d_year"].tolist(),
                dd["d_moy"].tolist(), dd["d_dom"].tolist(),
                dd["d_dow"].tolist(), dd["d_qoy"].tolist(),
                dd["d_date"].tolist(), dd["d_month_seq"].tolist())}
        return self._dd_cache

    def _cust(self):
        if getattr(self, "_cust_cache", None) is not None:
            return self._cust_cache
        c = self.d.tables["customer"]
        fn = _decode(self.d, "customer", "c_first_name")
        ln = _decode(self.d, "customer", "c_last_name")
        sal = _decode(self.d, "customer", "c_salutation")
        fl = _decode(self.d, "customer", "c_preferred_cust_flag")
        self._cust_cache = {
            sk: (ln[i], fn[i], sal[i], fl[i],
                 int(c["c_current_addr_sk"][i]))
            for i, sk in enumerate(c["c_customer_sk"].tolist())}
        return self._cust_cache

    def q15(self):
        d = self.d
        cs = d.tables["catalog_sales"]
        dd = self._dd()
        cust = self._cust()
        ca = d.tables["customer_address"]
        zips = _decode(d, "customer_address", "ca_zip")
        states = _decode(d, "customer_address", "ca_state")
        ai = {sk: i for i, sk in
              enumerate(ca["ca_address_sk"].tolist())}
        tz = {b"85669", b"86197", b"88274", b"83405", b"86475",
              b"85392", b"85460", b"80348", b"81792"}
        ts = {b"CA", b"WA", b"GA"}
        acc: dict = collections.defaultdict(int)
        for dk, ck, sp in zip(cs["cs_sold_date_sk"].tolist(),
                              cs["cs_bill_customer_sk"].tolist(),
                              cs["cs_sales_price"].tolist()):
            y, _m, _dom, _dow, q, _dt, _ms = dd[dk]
            if y != 1998 or q != 2:
                continue
            i = ai[cust[ck][4]]
            if not (zips[i][:5] in tz or states[i] in ts
                    or sp > 50000):
                continue
            acc[zips[i]] += sp
        return sorted(acc.items())[:100]

    def _excess_discount(self, fact, date_col, item_col, amt_col,
                         manu_id, lo_s, hi_s):
        d = self.d
        f = d.tables[fact]
        dd = self._dd()
        lo = int(np.datetime64(lo_s, "D").astype(int))
        hi = int(np.datetime64(hi_s, "D").astype(int))
        manu = {sk for sk, m in zip(
            d.tables["item"]["i_item_sk"].tolist(),
            d.tables["item"]["i_manufact_id"].tolist())
            if m == manu_id}
        by_item: dict = collections.defaultdict(lambda: [0, 0])
        rows = []
        for dk, ik, amt in zip(f[date_col].tolist(),
                               f[item_col].tolist(),
                               f[amt_col].tolist()):
            if not (lo <= dd[dk][5] <= hi):
                continue
            st = by_item[ik]
            st[0] += amt
            st[1] += 1
            rows.append((ik, amt))
        excess = 0
        any_row = False
        for ik, amt in rows:
            if ik in manu:
                sm, n = by_item[ik]
                if amt > 1.3 * (sm / n):
                    excess += amt
                    any_row = True
        return [(excess if any_row else None,)]

    def q32(self):
        return self._excess_discount(
            "catalog_sales", "cs_sold_date_sk", "cs_item_sk",
            "cs_ext_discount_amt", 66, "2002-03-29", "2002-06-27")

    def _ticket_counts(self, dom_ok, bp_set, dep_pred, years,
                       county_set):
        """(ticket, customer) -> line count under q34/q73 filters."""
        d = self.d
        ss = d.tables["store_sales"]
        dd = self._dd()
        hd = self._hd()
        counties = _decode(d, "store", "s_county")
        s_ok = {sk for i, sk in enumerate(
            d.tables["store"]["s_store_sk"].tolist())
            if counties[i] in county_set}
        acc: dict = collections.defaultdict(int)
        for dk, sk, hk, tn, ck in zip(
                ss["ss_sold_date_sk"].tolist(),
                ss["ss_store_sk"].tolist(),
                ss["ss_hdemo_sk"].tolist(),
                ss["ss_ticket_number"].tolist(),
                ss["ss_customer_sk"].tolist()):
            y, _m, dom, _dow, _q, _dt, _ms = dd[dk]
            dep, veh, bp = hd[hk]
            if y not in years or not dom_ok(dom) or sk not in s_ok \
                    or bp not in bp_set or veh <= 0 \
                    or not dep_pred(dep, veh):
                continue
            acc[(tn, ck)] += 1
        return acc

    def q34(self):
        acc = self._ticket_counts(
            lambda dom: 1 <= dom <= 3 or 25 <= dom <= 28,
            {b">10000", b"Unknown"},
            lambda dep, veh: dep > 1.2 * veh,
            {2000, 2001, 2002},
            {b"Salem County", b"Terrell County", b"Arthur County",
             b"Oglethorpe County", b"Lunenburg County",
             b"Perry County", b"Halifax County", b"Sumner County"})
        cust = self._cust()
        rows = [(cust[ck][0], cust[ck][1], cust[ck][2], cust[ck][3],
                 tn, c)
                for (tn, ck), c in acc.items() if 15 <= c <= 20]
        # c_preferred_cust_flag DESC, everything else ASC
        rows.sort(key=lambda r: (r[0], r[1], r[2],
                                 _desc_bytes(r[3]), r[4]))
        return rows

    def q73(self):
        acc = self._ticket_counts(
            lambda dom: 1 <= dom <= 2,
            {b">10000", b"5001-10000"},
            lambda dep, veh: dep > veh,
            {2000, 2001, 2002},
            {b"Lea County", b"Furnas County", b"Pennington County",
             b"Bronx County"})
        cust = self._cust()
        rows = [(cust[ck][0], cust[ck][1], cust[ck][2], cust[ck][3],
                 tn, c)
                for (tn, ck), c in acc.items() if 1 <= c <= 5]
        rows.sort(key=lambda r: (-r[5], r[0], r[4]))
        return rows

    def _ticket_sums(self, row_ok, cols):
        """(ticket, customer, addr) -> [sums of cols] under a filter."""
        d = self.d
        ss = d.tables["store_sales"]
        dd = self._dd()
        hd = self._hd()
        acc: dict = {}
        arrs = [ss[c].tolist() for c in cols]
        for i, (dk, sk, hk, tn, ck, ak) in enumerate(zip(
                ss["ss_sold_date_sk"].tolist(),
                ss["ss_store_sk"].tolist(),
                ss["ss_hdemo_sk"].tolist(),
                ss["ss_ticket_number"].tolist(),
                ss["ss_customer_sk"].tolist(),
                ss["ss_addr_sk"].tolist())):
            if not row_ok(dd[dk], sk, hd[hk]):
                continue
            st = acc.setdefault((tn, ck, ak), [0] * len(cols))
            for j, a in enumerate(arrs):
                st[j] += a[i]
        return acc

    def _city_move_rows(self, acc):
        """q46/q68 shape: join customer + current address, keep rows
        whose current city differs from the bought city."""
        d = self.d
        cust = self._cust()
        cities = _decode(d, "customer_address", "ca_city")
        ai = {sk: i for i, sk in enumerate(
            d.tables["customer_address"]["ca_address_sk"].tolist())}
        rows = []
        for (tn, ck, ak), sums in acc.items():
            bought = cities[ai[ak]]
            cur = cities[ai[cust[ck][4]]]
            if cur == bought:
                continue
            rows.append((cust[ck][0], cust[ck][1], cur, bought, tn,
                         *sums))
        return rows

    def q46(self):
        store_ok = self._city_stores(
            {b"Five Forks", b"Oakland", b"Fairview", b"Winchester",
             b"Farmington"})

        def ok(dinfo, sk, hdinfo):
            y, _m, _dom, dow, _q, _dt, _ms = dinfo
            dep, veh, _bp = hdinfo
            return (y in (2000, 2001, 2002) and dow in (6, 0)
                    and sk in store_ok and (dep == 0 or veh == 1))

        acc = self._ticket_sums(ok, ("ss_coupon_amt",
                                     "ss_net_profit"))
        rows = self._city_move_rows(acc)
        rows.sort(key=lambda r: r[:5])
        return rows[:100]

    def q68(self):
        store_ok = self._city_stores({b"Pleasant Hill", b"Bethel"})

        def ok(dinfo, sk, hdinfo):
            y, _m, dom, _dow, _q, _dt, _ms = dinfo
            dep, veh, _bp = hdinfo
            return (y in (1999, 2000, 2001) and 1 <= dom <= 2
                    and sk in store_ok and (dep == 4 or veh == 0))

        acc = self._ticket_sums(ok, ("ss_ext_sales_price",
                                     "ss_ext_list_price",
                                     "ss_ext_tax"))
        rows = [(ln, fn, cur, bought, tn, esp, etax, elp)
                for ln, fn, cur, bought, tn, esp, elp, etax
                in self._city_move_rows(acc)]
        rows.sort(key=lambda r: (r[0], r[4]))
        return rows[:100]

    def _city_stores(self, names):
        cities = _decode(self.d, "store", "s_city")
        return {sk for i, sk in enumerate(
            self.d.tables["store"]["s_store_sk"].tolist())
            if cities[i] in names}

    def q79(self):
        d = self.d
        st = d.tables["store"]
        cities = _decode(d, "store", "s_city")
        emp_ok = {sk: cities[i] for i, sk in
                  enumerate(st["s_store_sk"].tolist())
                  if 200 <= st["s_number_employees"][i] <= 295}

        def ok(dinfo, sk, hdinfo):
            y, _m, _dom, dow, _q, _dt, _ms = dinfo
            dep, veh, _bp = hdinfo
            return (y in (1998, 1999, 2000) and dow == 1
                    and sk in emp_ok and (dep == 0 or veh > 3))

        ss = d.tables["store_sales"]
        dd = self._dd()
        hd = self._hd()
        acc: dict = {}
        for dk, sk, hk, tn, ck, amt, pr in zip(
                ss["ss_sold_date_sk"].tolist(),
                ss["ss_store_sk"].tolist(),
                ss["ss_hdemo_sk"].tolist(),
                ss["ss_ticket_number"].tolist(),
                ss["ss_customer_sk"].tolist(),
                ss["ss_coupon_amt"].tolist(),
                ss["ss_net_profit"].tolist()):
            if not ok(dd[dk], sk, hd[hk]):
                continue
            st2 = acc.setdefault((tn, ck, emp_ok.get(sk)), [0, 0])
            st2[0] += amt
            st2[1] += pr
        cust = self._cust()
        rows = [(cust[ck][0], cust[ck][1], city[:30], tn, a, p)
                for (tn, ck, city), (a, p) in acc.items()]
        rows.sort(key=lambda r: (r[0], r[1], r[2], r[5], r[3]))
        return rows[:100]

    def q65(self):
        d = self.d
        ss = d.tables["store_sales"]
        dd = self._dd()
        rev: dict = collections.defaultdict(int)
        for dk, sk, ik, sp in zip(ss["ss_sold_date_sk"].tolist(),
                                  ss["ss_store_sk"].tolist(),
                                  ss["ss_item_sk"].tolist(),
                                  ss["ss_sales_price"].tolist()):
            if 48 <= dd[dk][6] <= 59:
                rev[(sk, ik)] += sp
        per_store: dict = collections.defaultdict(list)
        for (sk, _ik), r in rev.items():
            per_store[sk].append(r)
        ave = {sk: sum(v) / len(v) for sk, v in per_store.items()}
        it = d.tables["item"]
        ii = {sk: i for i, sk in enumerate(it["i_item_sk"].tolist())}
        si = {sk: i for i, sk in enumerate(
            d.tables["store"]["s_store_sk"].tolist())}
        snames = _decode(d, "store", "s_store_name")
        descs = _decode(d, "item", "i_item_desc")
        brands = _decode(d, "item", "i_brand")
        rows = []
        for (sk, ik), r in rev.items():
            if r <= 0.1 * ave[sk]:
                i = ii[ik]
                rows.append((snames[si[sk]], descs[i], r,
                             int(it["i_current_price"][i]),
                             int(it["i_wholesale_cost"][i]),
                             brands[i]))
        rows.sort(key=lambda x: (x[0], x[1], x[2], x[3],
                                 x[4], x[5]))
        return rows[:100]

    def q98(self):
        return self._class_share(
            "store_sales", "ss_sold_date_sk", "ss_item_sk",
            "ss_ext_sales_price", {b"Home", b"Sports", b"Men"},
            "2002-01-05", "2002-02-04")

    # ---- batch-2 additions (q12/q20/q21/q37/q45/q69/q82/q92/q99) ----

    def _item_info(self):
        if getattr(self, "_item_cache", None) is None:
            it = self.d.tables["item"]
            self._item_cache = ({sk: i for i, sk in
                                 enumerate(it["i_item_sk"].tolist())},
                                it)
        return self._item_cache

    def _class_share(self, fact, date_col, item_col, price_col,
                     cats, lo_s, hi_s):
        d = self.d
        f = d.tables[fact]
        dd = self._dd()
        lo = int(np.datetime64(lo_s, "D").astype(int))
        hi = int(np.datetime64(hi_s, "D").astype(int))
        ii, it = self._item_info()
        cats_d = _decode(d, "item", "i_category")
        classes = _decode(d, "item", "i_class")
        ids = _decode(d, "item", "i_item_id")
        descs = _decode(d, "item", "i_item_desc")
        acc: dict = collections.defaultdict(int)
        for dk, ik, p in zip(f[date_col].tolist(),
                             f[item_col].tolist(),
                             f[price_col].tolist()):
            if not (lo <= dd[dk][5] <= hi):
                continue
            i = ii[ik]
            if cats_d[i] not in cats:
                continue
            acc[(ids[i], descs[i], cats_d[i], classes[i],
                 int(it["i_current_price"][i]))] += p
        ctot: dict = collections.defaultdict(int)
        for (_i, _de, _ca, cl, _pr), r in acc.items():
            ctot[cl] += r
        rows = [(k[0], k[1], k[2], k[3], k[4], r,
                 r * 100.0 / ctot[k[3]])
                for k, r in acc.items()]
        rows.sort(key=lambda x: (x[2], x[3], x[0], x[1], x[6]))
        return rows[:100]

    def q12(self):
        return self._class_share(
            "web_sales", "ws_sold_date_sk", "ws_item_sk",
            "ws_ext_sales_price",
            {b"Electronics", b"Books", b"Women"},
            "1998-01-06", "1998-02-05")

    def q20(self):
        return self._class_share(
            "catalog_sales", "cs_sold_date_sk", "cs_item_sk",
            "cs_ext_sales_price",
            {b"Shoes", b"Electronics", b"Children"},
            "2001-03-14", "2001-04-13")

    def q21(self):
        d = self.d
        inv = d.tables["inventory"]
        dd = self._dd()
        cut = int(np.datetime64("1999-03-20", "D").astype(int))
        lo = int(np.datetime64("1999-02-18", "D").astype(int))
        hi = int(np.datetime64("1999-04-19", "D").astype(int))
        ii, it = self._item_info()
        ids = _decode(d, "item", "i_item_id")
        wnames = _decode(d, "warehouse", "w_warehouse_name")
        wi = {sk: i for i, sk in enumerate(
            d.tables["warehouse"]["w_warehouse_sk"].tolist())}
        acc: dict = collections.defaultdict(lambda: [0, 0])
        for dk, ik, wk, q in zip(inv["inv_date_sk"].tolist(),
                                 inv["inv_item_sk"].tolist(),
                                 inv["inv_warehouse_sk"].tolist(),
                                 inv["inv_quantity_on_hand"].tolist()):
            dt = dd[dk][5]
            if not (lo <= dt <= hi):
                continue
            i = ii[ik]
            if not (99 <= it["i_current_price"][i] <= 149):
                continue
            st = acc[(wnames[wi[wk]], ids[i])]
            if dt < cut:
                st[0] += q
            else:
                st[1] += q
        rows = [(w, iid, b, a) for (w, iid), (b, a) in acc.items()
                if b > 0 and 3 * a >= 2 * b and 2 * a <= 3 * b]
        rows.sort(key=lambda r: (r[0], r[1]))
        return rows[:100]

    def _inv_items(self, fact, item_col, price_lo, price_hi, manus,
                   lo_s, hi_s):
        d = self.d
        inv = d.tables["inventory"]
        dd = self._dd()
        lo = int(np.datetime64(lo_s, "D").astype(int))
        hi = int(np.datetime64(hi_s, "D").astype(int))
        ii, it = self._item_info()
        ids = _decode(d, "item", "i_item_id")
        descs = _decode(d, "item", "i_item_desc")
        sold = set(d.tables[fact][item_col].tolist())
        keep = set()
        for dk, ik, q in zip(inv["inv_date_sk"].tolist(),
                             inv["inv_item_sk"].tolist(),
                             inv["inv_quantity_on_hand"].tolist()):
            if not (lo <= dd[dk][5] <= hi) or not (100 <= q <= 500):
                continue
            i = ii[ik]
            if not (price_lo <= it["i_current_price"][i] <= price_hi):
                continue
            if it["i_manufact_id"][i] not in manus or ik not in sold:
                continue
            keep.add((ids[i], descs[i], int(it["i_current_price"][i])))
        return sorted(keep)[:100]

    def q37(self):
        return self._inv_items("catalog_sales", "cs_item_sk",
                               3900, 6900, {765, 886, 889, 728},
                               "2001-01-16", "2001-03-17")

    def q82(self):
        return self._inv_items("store_sales", "ss_item_sk",
                               4900, 7900, {80, 675, 292, 17},
                               "2001-01-28", "2001-03-29")

    def q45(self):
        d = self.d
        ws = d.tables["web_sales"]
        dd = self._dd()
        cust = self._cust()
        ca = d.tables["customer_address"]
        zips = _decode(d, "customer_address", "ca_zip")
        counties = _decode(d, "customer_address", "ca_county")
        ai = {sk: i for i, sk in
              enumerate(ca["ca_address_sk"].tolist())}
        tz = {b"85669", b"86197", b"88274", b"83405", b"86475",
              b"85392", b"85460", b"80348", b"81792"}
        hot_items = {2, 3, 5, 7, 11, 13, 17, 19, 23, 29}
        acc: dict = collections.defaultdict(int)
        for dk, ck, ik, sp in zip(ws["ws_sold_date_sk"].tolist(),
                                  ws["ws_bill_customer_sk"].tolist(),
                                  ws["ws_item_sk"].tolist(),
                                  ws["ws_sales_price"].tolist()):
            y, _m, _dom, _dow, q, _dt, _ms = dd[dk]
            if y != 1998 or q != 1:
                continue
            i = ai[cust[ck][4]]
            if not (zips[i][:5] in tz or ik in hot_items):
                continue
            acc[(zips[i], counties[i])] += sp
        return sorted((k[0], k[1], v) for k, v in acc.items())[:100]

    def q69(self):
        d = self.d
        dd = self._dd()

        def active(fact, date_col, cust_col):
            out = set()
            f = d.tables[fact]
            for dk, ck in zip(f[date_col].tolist(),
                              f[cust_col].tolist()):
                y, m = dd[dk][0], dd[dk][1]
                if y == 2001 and 2 <= m <= 4:
                    out.add(ck)
            return out

        store = active("store_sales", "ss_sold_date_sk",
                       "ss_customer_sk")
        web = active("web_sales", "ws_sold_date_sk",
                     "ws_bill_customer_sk")
        cat = active("catalog_sales", "cs_sold_date_sk",
                     "cs_bill_customer_sk")
        ca = d.tables["customer_address"]
        states = _decode(d, "customer_address", "ca_state")
        ai = {sk: i for i, sk in
              enumerate(ca["ca_address_sk"].tolist())}
        cd = d.tables["customer_demographics"]
        g = _decode(d, "customer_demographics", "cd_gender")
        m_ = _decode(d, "customer_demographics", "cd_marital_status")
        e = _decode(d, "customer_demographics", "cd_education_status")
        cr = _decode(d, "customer_demographics", "cd_credit_rating")
        di = {sk: i for i, sk in enumerate(cd["cd_demo_sk"].tolist())}
        cust = d.tables["customer"]
        acc: dict = collections.defaultdict(int)
        for ck, ak, cdk in zip(cust["c_customer_sk"].tolist(),
                               cust["c_current_addr_sk"].tolist(),
                               cust["c_current_cdemo_sk"].tolist()):
            if states[ai[ak]] not in (b"MO", b"MN", b"AZ"):
                continue
            if ck not in store or ck in web or ck in cat:
                continue
            i = di[cdk]
            acc[(g[i], m_[i], e[i],
                 int(cd["cd_purchase_estimate"][i]), cr[i])] += 1
        rows = [(k[0], k[1], k[2], c, k[3], c, k[4], c)
                for k, c in acc.items()]
        rows.sort(key=lambda r: (r[0], r[1], r[2], r[4], r[6]))
        return rows[:100]

    def q92(self):
        return self._excess_discount(
            "web_sales", "ws_sold_date_sk", "ws_item_sk",
            "ws_ext_discount_amt", 356, "2001-03-12", "2001-06-10")

    def q99(self):
        d = self.d
        cs = d.tables["catalog_sales"]
        dd = self._dd()
        wnames = _decode(d, "warehouse", "w_warehouse_name")
        wi = {sk: i for i, sk in enumerate(
            d.tables["warehouse"]["w_warehouse_sk"].tolist())}
        smt = _decode(d, "ship_mode", "sm_type")
        smi = {sk: i for i, sk in enumerate(
            d.tables["ship_mode"]["sm_ship_mode_sk"].tolist())}
        ccn = _decode(d, "call_center", "cc_name")
        cci = {sk: i for i, sk in enumerate(
            d.tables["call_center"]["cc_call_center_sk"].tolist())}
        acc: dict = collections.defaultdict(lambda: [0] * 5)
        for sold, ship, wk, smk, cck in zip(
                cs["cs_sold_date_sk"].tolist(),
                cs["cs_ship_date_sk"].tolist(),
                cs["cs_warehouse_sk"].tolist(),
                cs["cs_ship_mode_sk"].tolist(),
                cs["cs_call_center_sk"].tolist()):
            if not (36 <= dd[ship][6] <= 47):
                continue
            lag = ship - sold
            st = acc[(wnames[wi[wk]][:20], smt[smi[smk]],
                      ccn[cci[cck]])]
            if lag <= 30:
                st[0] += 1
            elif lag <= 60:
                st[1] += 1
            elif lag <= 90:
                st[2] += 1
            elif lag <= 120:
                st[3] += 1
            else:
                st[4] += 1
        rows = [(k[0], k[1], k[2], *v) for k, v in acc.items()]
        rows.sort(key=lambda r: (r[0], r[1], r[2]))
        return rows[:100]

    # -- channel-union queries (q33/q56/q60/q71) --

    def _item_pos(self):
        it = self.d.tables["item"]
        sks = it["i_item_sk"]
        pos = np.full(int(sks.max()) + 1, -1, dtype=np.int64)
        pos[sks] = np.arange(len(sks))
        return pos

    _CHANNELS = (
        ("store_sales", "ss_sold_date_sk", "ss_item_sk",
         "ss_addr_sk", "ss_ext_sales_price"),
        ("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
         "cs_bill_addr_sk", "cs_ext_sales_price"),
        ("web_sales", "ws_sold_date_sk", "ws_item_sk",
         "ws_bill_addr_sk", "ws_ext_sales_price"),
    )

    def _chan_union(self, year, moy, item_ok, key_of):
        """Three-channel union: ext_sales_price summed by an item
        attribute, branches filtered to (year, moy) x gmt_offset -5."""
        d = self.d
        dd = d.tables["date_dim"]
        dok = dd["d_date_sk"][(dd["d_year"] == year)
                              & (dd["d_moy"] == moy)]
        ca = d.tables["customer_address"]
        aok = ca["ca_address_sk"][ca["ca_gmt_offset"] == -5]
        pos = self._item_pos()
        acc: dict = collections.defaultdict(int)
        for t, dk, ik, ak, p in self._CHANNELS:
            tb = d.tables[t]
            m = np.isin(tb[dk], dok) & np.isin(tb[ak], aok)
            rows = pos[tb[ik][m]]
            price = tb[p][m]
            keep = item_ok[rows]
            for r, pp in zip(rows[keep].tolist(), price[keep].tolist()):
                acc[key_of(r)] += pp
        return acc

    def q33(self):
        it = self.d.tables["item"]
        cats = _decode(self.d, "item", "i_category")
        # IN (select i_manufact_id ... where category='Electronics'):
        # every item of any manufacturer with >= 1 Electronics item
        # qualifies, regardless of that item's own category
        manu_ok = set(
            it["i_manufact_id"][cats == b"Electronics"].tolist())
        item_ok = np.array(
            [int(m) in manu_ok for m in it["i_manufact_id"]])
        acc = self._chan_union(
            1998, 5, item_ok,
            lambda r: int(it["i_manufact_id"][r]))
        return sorted(acc.items(), key=lambda kv: (kv[1], kv[0]))[:100]

    def q56(self):
        colors = _decode(self.d, "item", "i_color")
        ids = _decode(self.d, "item", "i_item_id")
        ok = np.isin(colors, [b"slate", b"blanched", b"cornsilk"])
        acc = self._chan_union(2001, 2, ok, lambda r: ids[r])
        return sorted(acc.items(), key=lambda kv: (kv[1], kv[0]))[:100]

    def q60(self):
        cats = _decode(self.d, "item", "i_category")
        ids = _decode(self.d, "item", "i_item_id")
        acc = self._chan_union(1998, 9, cats == b"Music",
                               lambda r: ids[r])
        return sorted(acc.items(), key=lambda kv: (kv[0], kv[1]))[:100]

    def q71(self):
        d = self.d
        it = d.tables["item"]
        dd = d.tables["date_dim"]
        dok = dd["d_date_sk"][(dd["d_year"] == 1999)
                              & (dd["d_moy"] == 11)]
        brands = _decode(d, "item", "i_brand")
        pos = self._item_pos()
        acc: dict = collections.defaultdict(int)
        for t, dk, ik, ak, p in self._CHANNELS:
            tk = {"store_sales": "ss_sold_time_sk",
                  "catalog_sales": "cs_sold_time_sk",
                  "web_sales": "ws_sold_time_sk"}[t]
            tb = d.tables[t]
            m = np.isin(tb[dk], dok)
            rows = pos[tb[ik][m]]
            tks = tb[tk][m]
            price = tb[p][m]
            hour = tks // 3600
            keep = (it["i_manager_id"][rows] == 1) & (
                ((hour >= 6) & (hour < 9))
                | ((hour >= 17) & (hour < 21)))
            for r, tsec, pp in zip(rows[keep].tolist(),
                                   tks[keep].tolist(),
                                   price[keep].tolist()):
                acc[(int(it["i_brand_id"][r]), brands[r],
                     int(tsec) // 3600,
                     (int(tsec) % 3600) // 60)] += pp
        rows_ = [(*k, v) for k, v in acc.items()]
        rows_.sort(key=lambda r: (-r[4], r[0], r[2], r[3]))
        return rows_

    # -- returns-chain queries (q1/q25/q29/q40/q50/q93) --

    def _date_cols(self, sks):
        """(year, moy, date) arrays for date-sk array, via the
        contiguous sk layout d_date_sk = _D0_SK + row."""
        dd = self.d.tables["date_dim"]
        idx = np.asarray(sks) - _D0_SK
        return dd["d_year"][idx], dd["d_moy"][idx], dd["d_date"][idx]

    def q1(self):
        d = self.d
        sr = d.tables["store_returns"]
        yr, _, _ = self._date_cols(sr["sr_returned_date_sk"])
        m = yr == 2000
        acc: dict = collections.defaultdict(int)
        for c, s, a in zip(sr["sr_customer_sk"][m].tolist(),
                           sr["sr_store_sk"][m].tolist(),
                           sr["sr_return_amt"][m].tolist()):
            acc[(c, s)] += a
        per_store: dict = collections.defaultdict(list)
        for (c, s), t in acc.items():
            per_store[s].append(t)
        st = d.tables["store"]
        states = _decode(d, "store", "s_state")
        tn = {sk for sk, stt in zip(st["s_store_sk"].tolist(), states)
              if stt == b"TN"}
        cids = _decode(d, "customer", "c_customer_id")
        out = []
        for (c, s), t in acc.items():
            if s in tn and t > 1.2 * (sum(per_store[s])
                                      / len(per_store[s])):
                out.append(cids[c - 1])
        out.sort()
        return [(x,) for x in out[:100]]

    def _chain_rows(self, d1_ok, d2_ok, d3_ok):
        """(ss_row, sr_row, cs_row) triples of the q25/q29 join chain:
        store sale (d1) -> its return (d2) -> catalog purchases by the
        same (customer, item) (d3)."""
        d = self.d
        ss, sr = d.tables["store_sales"], d.tables["store_returns"]
        cs = d.tables["catalog_sales"]
        ss_rows: dict = collections.defaultdict(list)
        for i, (c, k, t) in enumerate(zip(
                ss["ss_customer_sk"].tolist(),
                ss["ss_item_sk"].tolist(),
                ss["ss_ticket_number"].tolist())):
            if d1_ok[i]:
                ss_rows[(c, k, t)].append(i)
        cs_rows: dict = collections.defaultdict(list)
        for j, (c, k) in enumerate(zip(
                cs["cs_bill_customer_sk"].tolist(),
                cs["cs_item_sk"].tolist())):
            if d3_ok[j]:
                cs_rows[(c, k)].append(j)
        out = []
        for r, (c, k, t) in enumerate(zip(
                sr["sr_customer_sk"].tolist(),
                sr["sr_item_sk"].tolist(),
                sr["sr_ticket_number"].tolist())):
            if not d2_ok[r]:
                continue
            for i in ss_rows.get((c, k, t), ()):
                for j in cs_rows.get((c, k), ()):
                    out.append((i, r, j))
        return out

    def _chain_agg(self, d1_ok, d2_ok, d3_ok, ss_col, sr_col, cs_col):
        d = self.d
        ss, sr = d.tables["store_sales"], d.tables["store_returns"]
        cs = d.tables["catalog_sales"]
        it, st = d.tables["item"], d.tables["store"]
        iids = _decode(d, "item", "i_item_id")
        idescs = _decode(d, "item", "i_item_desc")
        sids = _decode(d, "store", "s_store_id")
        snames = _decode(d, "store", "s_store_name")
        ipos = self._item_pos()
        spos = {sk: i for i, sk in enumerate(
            st["s_store_sk"].tolist())}
        acc: dict = collections.defaultdict(lambda: [0, 0, 0])
        for i, r, j in self._chain_rows(d1_ok, d2_ok, d3_ok):
            ir = ipos[ss["ss_item_sk"][i]]
            sp = spos[ss["ss_store_sk"][i]]
            k = (iids[ir], idescs[ir], sids[sp], snames[sp])
            acc[k][0] += int(ss[ss_col][i])
            acc[k][1] += int(sr[sr_col][r])
            acc[k][2] += int(cs[cs_col][j])
        rows = [(*k, *v) for k, v in sorted(acc.items())]
        return rows[:100]

    def q25(self):
        d = self.d
        y1, m1, _ = self._date_cols(
            d.tables["store_sales"]["ss_sold_date_sk"])
        y2, m2, _ = self._date_cols(
            d.tables["store_returns"]["sr_returned_date_sk"])
        y3, m3, _ = self._date_cols(
            d.tables["catalog_sales"]["cs_sold_date_sk"])
        return self._chain_agg(
            (y1 == 2001) & (m1 == 4),
            (y2 == 2001) & (m2 >= 4) & (m2 <= 10),
            (y3 == 2001) & (m3 >= 4) & (m3 <= 10),
            "ss_net_profit", "sr_net_loss", "cs_net_profit")

    def q29(self):
        d = self.d
        y1, m1, _ = self._date_cols(
            d.tables["store_sales"]["ss_sold_date_sk"])
        y2, m2, _ = self._date_cols(
            d.tables["store_returns"]["sr_returned_date_sk"])
        y3, _, _ = self._date_cols(
            d.tables["catalog_sales"]["cs_sold_date_sk"])
        return self._chain_agg(
            (y1 == 1999) & (m1 == 9),
            (y2 == 1999) & (m2 >= 9) & (m2 <= 12),
            np.isin(y3, (1999, 2000, 2001)),
            "ss_quantity", "sr_return_quantity", "cs_quantity")

    def q40(self):
        d = self.d
        cs = d.tables["catalog_sales"]
        cr = d.tables["catalog_returns"]
        it = d.tables["item"]
        refund = {(o, k): c for o, k, c in zip(
            cr["cr_order_number"].tolist(),
            cr["cr_item_sk"].tolist(),
            cr["cr_refunded_cash"].tolist())}
        wstates = _decode(d, "warehouse", "w_state")
        wpos = {sk: i for i, sk in enumerate(
            d.tables["warehouse"]["w_warehouse_sk"].tolist())}
        iids = _decode(d, "item", "i_item_id")
        ipos = self._item_pos()
        _, _, dates = self._date_cols(cs["cs_sold_date_sk"])
        pivot = int((np.datetime64("2000-03-11", "D")
                     - np.datetime64("1970-01-01", "D")).astype(int))
        lo = pivot - 30
        hi = pivot + 30
        acc: dict = collections.defaultdict(lambda: [0, 0])
        for j, (dt, ik, wk, o, p) in enumerate(zip(
                dates.tolist(), cs["cs_item_sk"].tolist(),
                cs["cs_warehouse_sk"].tolist(),
                cs["cs_order_number"].tolist(),
                cs["cs_sales_price"].tolist())):
            if not (lo <= dt <= hi):
                continue
            ir = ipos[ik]
            if not (99 <= it["i_current_price"][ir] <= 149):
                continue
            net = p - refund.get((o, ik), 0)
            k = (wstates[wpos[wk]], iids[ir])
            acc[k][0 if dt < pivot else 1] += net
        rows = [(*k, *v) for k, v in sorted(acc.items())]
        return rows[:100]

    def q50(self):
        d = self.d
        ss, sr = d.tables["store_sales"], d.tables["store_returns"]
        y2, m2, _ = self._date_cols(sr["sr_returned_date_sk"])
        sold = dict()
        for i, (c, k, t) in enumerate(zip(
                ss["ss_customer_sk"].tolist(),
                ss["ss_item_sk"].tolist(),
                ss["ss_ticket_number"].tolist())):
            sold.setdefault((c, k, t), []).append(i)
        st = d.tables["store"]
        sids = _decode(d, "store", "s_store_id")
        snames = _decode(d, "store", "s_store_name")
        spos = {sk: i for i, sk in enumerate(
            st["s_store_sk"].tolist())}
        acc: dict = collections.defaultdict(lambda: [0] * 5)
        for r in np.flatnonzero((y2 == 2001) & (m2 == 8)).tolist():
            key = (sr["sr_customer_sk"][r], sr["sr_item_sk"][r],
                   sr["sr_ticket_number"][r])
            for i in sold.get(key, ()):
                lag = int(sr["sr_returned_date_sk"][r]
                          - ss["ss_sold_date_sk"][i])
                sp = spos[ss["ss_store_sk"][i]]
                st_ = acc[(snames[sp], sids[sp])]
                if lag <= 30:
                    st_[0] += 1
                elif lag <= 60:
                    st_[1] += 1
                elif lag <= 90:
                    st_[2] += 1
                elif lag <= 120:
                    st_[3] += 1
                else:
                    st_[4] += 1
        rows = [(*k, *v) for k, v in sorted(acc.items())]
        return rows[:100]

    def q93(self):
        d = self.d
        ss, sr = d.tables["store_sales"], d.tables["store_returns"]
        rdesc = _decode(d, "reason", "r_reason_desc")
        rok = {sk for sk, t in zip(
            d.tables["reason"]["r_reason_sk"].tolist(), rdesc)
            if t == b"Stopped working"}
        pairs: dict = collections.defaultdict(list)
        for i, (k, t) in enumerate(zip(
                ss["ss_item_sk"].tolist(),
                ss["ss_ticket_number"].tolist())):
            pairs[(k, t)].append(i)
        acc: dict = collections.defaultdict(int)
        for r, (k, t, rk, q) in enumerate(zip(
                sr["sr_item_sk"].tolist(),
                sr["sr_ticket_number"].tolist(),
                sr["sr_reason_sk"].tolist(),
                sr["sr_return_quantity"].tolist())):
            if rk not in rok:
                continue
            for i in pairs.get((k, t), ()):
                acc[int(ss["ss_customer_sk"][i])] += (
                    int(ss["ss_quantity"][i]) - q
                ) * int(ss["ss_sales_price"][i])
        rows = sorted(acc.items(), key=lambda kv: (kv[1], kv[0]))
        return rows[:100]

    # -- web-channel queries (q16/q94/q62/q81/q30) --

    @staticmethod
    def _days(s: str) -> int:
        return int((np.datetime64(s, "D")
                    - np.datetime64("1970-01-01", "D")).astype(int))

    def _ship_no_return(self, fact, pfx, returns, r_pfx, row_ok):
        """q16/q94 shape: lines shipped in a window whose order has a
        sibling line from another warehouse and no return."""
        d = self.d
        tb = d.tables[fact]
        _, _, dates = self._date_cols(tb[pfx + "ship_date_sk"])
        lo, hi = self._days("1999-02-01"), self._days("1999-04-01")
        wh_sets: dict = collections.defaultdict(set)
        for o, w in zip(tb[pfx + "order_number"].tolist(),
                        tb[pfx + "warehouse_sk"].tolist()):
            wh_sets[o].add(w)
        returned = set(
            d.tables[returns][r_pfx + "order_number"].tolist())
        orders: set = set()
        ship = profit = 0
        for i, (o, dt) in enumerate(zip(
                tb[pfx + "order_number"].tolist(), dates.tolist())):
            if not (lo <= dt <= hi) or not row_ok[i]:
                continue
            if len(wh_sets[o]) < 2 or o in returned:
                continue
            orders.add(o)
            ship += int(tb[pfx + "ext_ship_cost"][i])
            profit += int(tb[pfx + "net_profit"][i])
        if not orders:
            return [(0, None, None)]
        return [(len(orders), ship, profit)]

    def _addr_state_ok(self, sks, state: bytes):
        states = _decode(self.d, "customer_address", "ca_state")
        return states[np.asarray(sks) - 1] == state

    def q16(self):
        d = self.d
        cs = d.tables["catalog_sales"]
        counties = _decode(d, "call_center", "cc_county")
        cc_ok = {sk for sk, c in zip(
            d.tables["call_center"]["cc_call_center_sk"].tolist(),
            counties) if c == b"Salem County"}
        row_ok = self._addr_state_ok(cs["cs_ship_addr_sk"], b"GA") & \
            np.array([c in cc_ok
                      for c in cs["cs_call_center_sk"].tolist()])
        return self._ship_no_return(
            "catalog_sales", "cs_", "catalog_returns", "cr_", row_ok)

    def q94(self):
        d = self.d
        ws = d.tables["web_sales"]
        comp = _decode(d, "web_site", "web_company_name")
        site_ok = {sk for sk, c in zip(
            d.tables["web_site"]["web_site_sk"].tolist(), comp)
            if c == b"ought"}
        row_ok = self._addr_state_ok(ws["ws_ship_addr_sk"], b"GA") & \
            np.array([s in site_ok
                      for s in ws["ws_web_site_sk"].tolist()])
        return self._ship_no_return(
            "web_sales", "ws_", "web_returns", "wr_", row_ok)

    def q62(self):
        d = self.d
        ws = d.tables["web_sales"]
        dd = self._dd()
        wnames = _decode(d, "warehouse", "w_warehouse_name")
        wi = {sk: i for i, sk in enumerate(
            d.tables["warehouse"]["w_warehouse_sk"].tolist())}
        smt = _decode(d, "ship_mode", "sm_type")
        smi = {sk: i for i, sk in enumerate(
            d.tables["ship_mode"]["sm_ship_mode_sk"].tolist())}
        wn = _decode(d, "web_site", "web_name")
        wsi = {sk: i for i, sk in enumerate(
            d.tables["web_site"]["web_site_sk"].tolist())}
        acc: dict = collections.defaultdict(lambda: [0] * 5)
        for sold, ship, wk, smk, sk in zip(
                ws["ws_sold_date_sk"].tolist(),
                ws["ws_ship_date_sk"].tolist(),
                ws["ws_warehouse_sk"].tolist(),
                ws["ws_ship_mode_sk"].tolist(),
                ws["ws_web_site_sk"].tolist()):
            if not (36 <= dd[ship][6] <= 47):
                continue
            lag = ship - sold
            st = acc[(wnames[wi[wk]][:20], smt[smi[smk]],
                      wn[wsi[sk]])]
            if lag <= 30:
                st[0] += 1
            elif lag <= 60:
                st[1] += 1
            elif lag <= 90:
                st[2] += 1
            elif lag <= 120:
                st[3] += 1
            else:
                st[4] += 1
        rows = [(k[0], k[1], k[2], *v) for k, v in acc.items()]
        rows.sort(key=lambda r: (r[0], r[1], r[2]))
        return rows[:100]

    def _ctr_over_state_avg(self, rt, pfx, amt_col, state_lit):
        """q81/q30 shape: returners above 1.2x their return-state
        average, restricted to customers whose CURRENT address is in
        state_lit."""
        d = self.d
        tb = d.tables[rt]
        yr, _, _ = self._date_cols(tb[pfx + "returned_date_sk"])
        states = _decode(d, "customer_address", "ca_state")
        acc: dict = collections.defaultdict(int)
        for ok, c, a, amt in zip(
                (yr == 2000).tolist(),
                tb[pfx + "returning_customer_sk"].tolist(),
                tb[pfx + "returning_addr_sk"].tolist(),
                tb[amt_col].tolist()):
            if ok:
                acc[(c, states[a - 1])] += amt
        per_state: dict = collections.defaultdict(list)
        for (c, st), t in acc.items():
            per_state[st].append(t)
        cust = d.tables["customer"]
        cur_state = states[cust["c_current_addr_sk"] - 1]
        cids = _decode(d, "customer", "c_customer_id")
        sal = _decode(d, "customer", "c_salutation")
        fn = _decode(d, "customer", "c_first_name")
        ln = _decode(d, "customer", "c_last_name")
        out = []
        for (c, st), t in acc.items():
            if t <= 1.2 * (sum(per_state[st]) / len(per_state[st])):
                continue
            if cur_state[c - 1] != state_lit:
                continue
            out.append((cids[c - 1], sal[c - 1], fn[c - 1],
                        ln[c - 1], t))
        out.sort()
        return out[:100]

    def q61(self):
        d = self.d
        ss = d.tables["store_sales"]
        y, m, _ = self._date_cols(ss["ss_sold_date_sk"])
        cats = _decode(d, "item", "i_category")
        ipos = self._item_pos()
        st = d.tables["store"]
        s_ok = set(st["s_store_sk"][
            st["s_gmt_offset"] == -5].tolist())
        pr = d.tables["promotion"]
        promo_ok = set(pr["p_promo_sk"][
            (_decode(d, "promotion", "p_channel_dmail") == b"Y")
            | (_decode(d, "promotion", "p_channel_email") == b"Y")
            | (_decode(d, "promotion", "p_channel_tv") == b"Y")
        ].tolist())
        cust_addr = d.tables["customer"]["c_current_addr_sk"]
        addr_gmt = d.tables["customer_address"]["ca_gmt_offset"]
        total = promos = n_rows = 0
        for i in np.flatnonzero((y == 1998) & (m == 11)).tolist():
            if ss["ss_store_sk"][i] not in s_ok:
                continue
            if cats[ipos[ss["ss_item_sk"][i]]] != b"Jewelry":
                continue
            if addr_gmt[cust_addr[ss["ss_customer_sk"][i] - 1] - 1] \
                    != -5:
                continue
            p = int(ss["ss_ext_sales_price"][i])
            total += p
            n_rows += 1
            if ss["ss_promo_sk"][i] in promo_ok:
                promos += p
        if not n_rows:
            return [(None, None)]
        return [(promos, total)]

    def q88(self):
        d = self.d
        ss = d.tables["store_sales"]
        hd = d.tables["household_demographics"]
        dep = hd["hd_dep_count"]
        veh = hd["hd_vehicle_count"]
        hd_ok = set(hd["hd_demo_sk"][
            ((dep == 4) & (veh <= 6)) | ((dep == 2) & (veh <= 4))
            | ((dep == 0) & (veh <= 2))].tolist())
        st = d.tables["store"]
        names = _decode(d, "store", "s_store_name")
        s_ok = {sk for sk, nm in zip(st["s_store_sk"].tolist(), names)
                if nm == b"ese"}
        bands = [0] * 8
        for t, h, s in zip(ss["ss_sold_time_sk"].tolist(),
                           ss["ss_hdemo_sk"].tolist(),
                           ss["ss_store_sk"].tolist()):
            if h not in hd_ok or s not in s_ok:
                continue
            half = t // 1800  # half-hour index in the day
            if 17 <= half <= 24:  # 8:30 .. 12:30
                bands[half - 17] += 1
        return [tuple(bands)]

    def q91(self):
        d = self.d
        cr = d.tables["catalog_returns"]
        yr, _, _ = self._date_cols(cr["cr_returned_date_sk"])
        ccn = _decode(d, "call_center", "cc_name")
        cci = {sk: i for i, sk in enumerate(
            d.tables["call_center"]["cc_call_center_sk"].tolist())}
        cust = d.tables["customer"]
        cd = d.tables["customer_demographics"]
        ms = _decode(d, "customer_demographics", "cd_marital_status")
        es = _decode(d, "customer_demographics", "cd_education_status")
        cd_ok = {}
        for sk, m_, e_ in zip(cd["cd_demo_sk"].tolist(), ms, es):
            if (m_ == b"M" and e_ == b"Unknown") or (
                    m_ == b"W" and e_ == b"Advanced Degree"):
                cd_ok[sk] = (m_, e_)
        hd = d.tables["household_demographics"]
        bp = _decode(d, "household_demographics", "hd_buy_potential")
        hd_ok = {sk for sk, b in zip(hd["hd_demo_sk"].tolist(), bp)
                 if b.startswith(b"Unknown")}
        acc: dict = collections.defaultdict(int)
        for ok, cc, c, loss in zip(
                (yr == 1998).tolist(),
                cr["cr_call_center_sk"].tolist(),
                cr["cr_returning_customer_sk"].tolist(),
                cr["cr_net_loss"].tolist()):
            if not ok:
                continue
            band = cd_ok.get(int(cust["c_current_cdemo_sk"][c - 1]))
            if band is None:
                continue
            if int(cust["c_current_hdemo_sk"][c - 1]) not in hd_ok:
                continue
            acc[(ccn[cci[cc]], band[0], band[1])] += loss
        rows = [(*k, v) for k, v in acc.items()]
        rows.sort(key=lambda r: (-r[3], r[0], r[1], r[2]))
        return rows

    def q17(self):
        d = self.d
        ss, sr = d.tables["store_sales"], d.tables["store_returns"]
        cs = d.tables["catalog_sales"]
        y1, m1, _ = self._date_cols(ss["ss_sold_date_sk"])
        y2, m2, _ = self._date_cols(sr["sr_returned_date_sk"])
        y3, m3, _ = self._date_cols(cs["cs_sold_date_sk"])
        qoy = lambda m: (m - 1) // 3 + 1  # noqa: E731
        triples = self._chain_rows(
            (y1 == 2001) & (qoy(m1) == 1),
            (y2 == 2001) & (qoy(m2) <= 3),
            (y3 == 2001) & (qoy(m3) <= 3))
        it, st = d.tables["item"], d.tables["store"]
        iids = _decode(d, "item", "i_item_id")
        idescs = _decode(d, "item", "i_item_desc")
        states = _decode(d, "store", "s_state")
        ipos = self._item_pos()
        spos = {sk: i for i, sk in enumerate(
            st["s_store_sk"].tolist())}
        acc: dict = collections.defaultdict(
            lambda: ([], [], []))
        for i, r, j in triples:
            ir = ipos[ss["ss_item_sk"][i]]
            sp = spos[ss["ss_store_sk"][i]]
            vals = acc[(iids[ir], idescs[ir], states[sp])]
            vals[0].append(int(ss["ss_quantity"][i]))
            vals[1].append(int(sr["sr_return_quantity"][r]))
            vals[2].append(int(cs["cs_quantity"][j]))

        def stats(v):
            sd = float(np.std(v, ddof=1)) if len(v) >= 2 else None
            return (len(v), float(np.mean(v)), sd)

        rows = [(*k, *stats(v[0]), *stats(v[1]), *stats(v[2]))
                for k, v in sorted(acc.items())]
        return rows[:100]

    def q39(self):
        d = self.d
        inv = d.tables["inventory"]
        y, m, _ = self._date_cols(inv["inv_date_sk"])
        acc: dict = collections.defaultdict(list)
        sel = np.flatnonzero((y == 2001) & (m <= 2))
        for w, i, mm, q in zip(
                inv["inv_warehouse_sk"][sel].tolist(),
                inv["inv_item_sk"][sel].tolist(), m[sel].tolist(),
                inv["inv_quantity_on_hand"][sel].tolist()):
            acc[(w, i, mm)].append(q)
        st = {}
        for k, v in acc.items():
            if len(v) < 2:
                continue
            mean = float(np.mean(v))
            sd = float(np.std(v, ddof=1))
            if mean > 0 and sd / mean > 0.5:
                st[k] = (mean, sd)
        out = []
        for (w, i, mm), (mean1, sd1) in sorted(st.items()):
            if mm != 1:
                continue
            two = st.get((w, i, 2))
            if two is not None:
                out.append((w, i, 1, mean1, sd1, 2, two[0], two[1]))
        return out[:100]

    def q9(self):
        ss = self.d.tables["store_sales"]
        q = ss["ss_quantity"]
        out = []
        for lo in (1, 21, 41, 61, 81):
            m = (q >= lo) & (q <= lo + 19)
            col = ("ss_ext_discount_amt" if int(m.sum()) > 10000
                   else "ss_net_paid")
            out.append(float(ss[col][m].mean()) / 100.0)
        return [tuple(out)]

    def _year_totals(self, fact, cust_col, date_col, vals):
        """(customer, year) -> sum of the precomputed per-row ``vals``
        over 1998/1999 (the q74/q11/q4 year_total accumulation)."""
        tb = self.d.tables[fact]
        y, _, _ = self._date_cols(tb[date_col])
        acc: dict = collections.defaultdict(int)
        sel = np.flatnonzero(np.isin(y, (1998, 1999)))
        for yy, c, p in zip(y[sel].tolist(),
                            tb[cust_col][sel].tolist(),
                            np.asarray(vals)[sel].tolist()):
            acc[(c, yy)] += p
        return acc

    def _year_ratio_customers(self, value_cols):
        """q74/q11 shape: customers whose 1998->1999 web revenue ratio
        beats the store ratio; ``value_cols`` maps channel prefix ->
        per-row revenue column(s) (first minus the rest)."""
        d = self.d

        def vals_of(fact, cols):
            v = d.tables[fact][cols[0]].astype(np.int64)
            for extra in cols[1:]:
                v = v - d.tables[fact][extra]
            return v

        st = self._year_totals(
            "store_sales", "ss_customer_sk", "ss_sold_date_sk",
            vals_of("store_sales", value_cols["ss_"]))
        wt = self._year_totals(
            "web_sales", "ws_bill_customer_sk", "ws_sold_date_sk",
            vals_of("web_sales", value_cols["ws_"]))
        n_cust = len(d.tables["customer"]["c_customer_sk"])
        for c in range(1, n_cust + 1):
            s1, s2 = st.get((c, 1998)), st.get((c, 1999))
            w1, w2 = wt.get((c, 1998)), wt.get((c, 1999))
            if None in (s1, s2, w1, w2) or s1 <= 0 or w1 <= 0:
                continue
            if w2 / w1 > s2 / s1:
                yield c

    def q74(self):
        d = self.d
        cids = _decode(d, "customer", "c_customer_id")
        fn = _decode(d, "customer", "c_first_name")
        ln = _decode(d, "customer", "c_last_name")
        out = [(cids[c - 1], fn[c - 1], ln[c - 1])
               for c in self._year_ratio_customers(
                   {"ss_": ("ss_net_paid",),
                    "ws_": ("ws_net_paid",)})]
        out.sort()
        return out[:100]

    def _channel_profit_totals(self, fact, pfx, cust_col):
        """q4's per-row profit: list - wholesale - discount + sales."""
        tb = self.d.tables[fact]
        vals = (tb[pfx + "ext_list_price"].astype(np.int64)
                - tb[pfx + "ext_wholesale_cost"]
                - tb[pfx + "ext_discount_amt"]
                + tb[pfx + "ext_sales_price"])
        return self._year_totals(fact, cust_col,
                                 pfx + "sold_date_sk", vals)

    def q4(self):
        d = self.d
        cids = _decode(d, "customer", "c_customer_id")
        fn = _decode(d, "customer", "c_first_name")
        ln = _decode(d, "customer", "c_last_name")
        st = self._channel_profit_totals(
            "store_sales", "ss_", "ss_customer_sk")
        ct = self._channel_profit_totals(
            "catalog_sales", "cs_", "cs_bill_customer_sk")
        wt = self._channel_profit_totals(
            "web_sales", "ws_", "ws_bill_customer_sk")
        out = []
        for c in range(1, len(cids) + 1):
            legs = [(t.get((c, 1998)), t.get((c, 1999)))
                    for t in (st, ct, wt)]
            if any(a is None or b is None for a, b in legs):
                continue
            (s1, s2), (c1, c2), (w1, w2) = legs
            if s1 <= 0 or c1 <= 0 or w1 <= 0:
                continue
            if c2 / c1 > s2 / s1 and c2 / c1 > w2 / w1:
                out.append((cids[c - 1], fn[c - 1], ln[c - 1]))
        out.sort()
        return out[:100]

    def q11(self):
        d = self.d
        cids = _decode(d, "customer", "c_customer_id")
        flags = _decode(d, "customer", "c_preferred_cust_flag")
        out = [(cids[c - 1], flags[c - 1])
               for c in self._year_ratio_customers(
                   {"ss_": ("ss_ext_list_price",
                            "ss_ext_discount_amt"),
                    "ws_": ("ws_ext_list_price",
                            "ws_ext_discount_amt")})]
        out.sort()
        return out[:100]

    def q36(self):
        d = self.d
        ss = d.tables["store_sales"]
        y, _, _ = self._date_cols(ss["ss_sold_date_sk"])
        cats = _decode(d, "item", "i_category")
        classes = _decode(d, "item", "i_class")
        ipos = self._item_pos()
        st = d.tables["store"]
        states = _decode(d, "store", "s_state")
        s_ok = {sk for sk, sst in zip(st["s_store_sk"].tolist(),
                                      states) if sst == b"TN"}
        acc: dict = collections.defaultdict(lambda: [0, 0])
        for i in np.flatnonzero(y == 2001).tolist():
            if ss["ss_store_sk"][i] not in s_ok:
                continue
            ir = ipos[ss["ss_item_sk"][i]]
            a = acc[(cats[ir], classes[ir])]
            a[0] += int(ss["ss_net_profit"][i])
            a[1] += int(ss["ss_ext_sales_price"][i])
        rows = [(p / s, c_, cl) for (c_, cl), (p, s) in acc.items()
                if s]
        rows.sort(key=lambda r: (r[0], r[1], r[2]))
        return rows[:100]

    def q86(self):
        d = self.d
        ws = d.tables["web_sales"]
        dd = self._dd()
        cats = _decode(d, "item", "i_category")
        classes = _decode(d, "item", "i_class")
        ipos = self._item_pos()
        acc: dict = collections.defaultdict(int)
        for dk, ik, p in zip(ws["ws_sold_date_sk"].tolist(),
                             ws["ws_item_sk"].tolist(),
                             ws["ws_net_paid"].tolist()):
            if not (24 <= dd[dk][6] <= 35):
                continue
            ir = ipos[ik]
            acc[(cats[ir], classes[ir])] += p
        rows = [(v, c_, cl) for (c_, cl), v in acc.items()]
        rows.sort(key=lambda r: (-r[0], r[1], r[2]))
        return rows[:100]

    def q22(self):
        d = self.d
        inv = d.tables["inventory"]
        dd = self._dd()
        iids = _decode(d, "item", "i_item_id")
        brands = _decode(d, "item", "i_brand")
        classes = _decode(d, "item", "i_class")
        cats = _decode(d, "item", "i_category")
        ipos = self._item_pos()
        acc: dict = collections.defaultdict(lambda: [0, 0])
        for dk, ik, q in zip(inv["inv_date_sk"].tolist(),
                             inv["inv_item_sk"].tolist(),
                             inv["inv_quantity_on_hand"].tolist()):
            if not (24 <= dd[dk][6] <= 35):
                continue
            ir = ipos[ik]
            a = acc[(iids[ir], brands[ir], classes[ir], cats[ir])]
            a[0] += q
            a[1] += 1
        rows = [(k[0], k[1], k[2], k[3], s / n)
                for k, (s, n) in acc.items()]
        rows.sort(key=lambda r: (r[4], r[0], r[1], r[2], r[3]))
        return rows[:100]

    def _monthly_dev(self, key_col, period_of, sort_key):
        """q53/q63 shape: per-(item attribute, period) revenue vs the
        attribute's average over its periods, >10% deviations kept."""
        d = self.d
        ss = d.tables["store_sales"]
        y, m, _ = self._date_cols(ss["ss_sold_date_sk"])
        cats = _decode(d, "item", "i_category")
        classes = _decode(d, "item", "i_class")
        it = d.tables["item"]
        ipos = self._item_pos()
        set_a_cat = {b"Books", b"Children", b"Electronics"}
        set_a_cls = {b"class#01", b"class#02", b"class#03"}
        set_b_cat = {b"Women", b"Music", b"Men"}
        set_b_cls = {b"class#04", b"class#05", b"class#06"}
        acc: dict = collections.defaultdict(int)
        for i in np.flatnonzero(y == 1999).tolist():
            ir = ipos[ss["ss_item_sk"][i]]
            c_, cl = cats[ir], classes[ir]
            if not ((c_ in set_a_cat and cl in set_a_cls)
                    or (c_ in set_b_cat and cl in set_b_cls)):
                continue
            acc[(int(it[key_col][ir]), period_of(int(m[i])))] += int(
                ss["ss_sales_price"][i])
        groups: dict = collections.defaultdict(list)
        for (kid, _p), s in acc.items():
            groups[kid].append(s)
        rows = []
        for (kid, period), s in acc.items():
            avg = (sum(groups[kid]) / len(groups[kid])) / 100.0
            sv = s / 100.0
            if avg > 0 and abs(sv - avg) / avg > 0.1:
                rows.append((kid, period, s, avg))
        rows.sort(key=sort_key)
        return rows[:100]

    def _bought_in(self, fact, cust_col, date_col, date_ok):
        tb = self.d.tables[fact]
        y_m = self._date_cols(tb[date_col])
        ok = date_ok(*y_m)
        return set(tb[cust_col][ok].tolist())

    def _q10_shape(self, date_ok):
        """Customers with a store purchase AND a web-or-catalog
        purchase in the window -> their cdemo rows."""
        store = self._bought_in("store_sales", "ss_customer_sk",
                                "ss_sold_date_sk", date_ok)
        remote = (self._bought_in("web_sales", "ws_bill_customer_sk",
                                  "ws_sold_date_sk", date_ok)
                  | self._bought_in("catalog_sales",
                                    "cs_bill_customer_sk",
                                    "cs_sold_date_sk", date_ok))
        return store & remote

    def q10(self):
        d = self.d
        ok_counties = {b"Salem County", b"Terrell County",
                       b"Arthur County", b"Oglethorpe County",
                       b"Lunenburg County"}
        counties = _decode(d, "customer_address", "ca_county")
        cust = d.tables["customer"]
        cd = d.tables["customer_demographics"]
        g = _decode(d, "customer_demographics", "cd_gender")
        ms = _decode(d, "customer_demographics", "cd_marital_status")
        es = _decode(d, "customer_demographics",
                     "cd_education_status")
        cr = _decode(d, "customer_demographics", "cd_credit_rating")
        buyers = self._q10_shape(
            lambda y, m, _d: (y == 2002) & (m >= 1) & (m <= 4))
        acc: dict = collections.Counter()
        for c in buyers:
            a_row = int(cust["c_current_addr_sk"][c - 1]) - 1
            if counties[a_row] not in ok_counties:
                continue
            i = int(cust["c_current_cdemo_sk"][c - 1]) - 1
            acc[(g[i], ms[i], es[i],
                 int(cd["cd_purchase_estimate"][i]), cr[i],
                 int(cd["cd_dep_count"][i]))] += 1
        rows = [(*k, n) for k, n in sorted(acc.items())]
        return rows[:100]

    def q35(self):
        d = self.d
        cust = d.tables["customer"]
        cd = d.tables["customer_demographics"]
        g = _decode(d, "customer_demographics", "cd_gender")
        ms = _decode(d, "customer_demographics", "cd_marital_status")
        states = _decode(d, "customer_address", "ca_state")
        buyers = self._q10_shape(
            lambda y, m, _d: (y == 2002) & (m <= 9))
        acc: dict = collections.Counter()
        for c in buyers:
            a_row = int(cust["c_current_addr_sk"][c - 1]) - 1
            i = int(cust["c_current_cdemo_sk"][c - 1]) - 1
            dep = int(cd["cd_dep_count"][i])
            acc[(states[a_row], g[i], ms[i], dep)] += 1
        rows = [(*k, n, k[3], k[3], float(k[3]))
                for k, n in sorted(acc.items())]
        return rows[:100]

    def q63(self):
        return self._monthly_dev(
            "i_manager_id", lambda m: m,
            lambda r: (r[0], r[3], r[2], r[1]))

    def q53(self):
        return self._monthly_dev(
            "i_manufact_id", lambda m: (m - 1) // 3 + 1,
            lambda r: (r[3], r[2], r[0], r[1]))

    def q67(self):
        d = self.d
        ss = d.tables["store_sales"]
        dd = self._dd()
        cats = _decode(d, "item", "i_category")
        classes = _decode(d, "item", "i_class")
        brands = _decode(d, "item", "i_brand")
        iids = _decode(d, "item", "i_item_id")
        ipos = self._item_pos()
        sids = _decode(d, "store", "s_store_id")
        spos = {sk: i for i, sk in enumerate(
            d.tables["store"]["s_store_sk"].tolist())}
        acc: dict = collections.defaultdict(int)
        for dk, ik, sk, p, q in zip(
                ss["ss_sold_date_sk"].tolist(),
                ss["ss_item_sk"].tolist(),
                ss["ss_store_sk"].tolist(),
                ss["ss_sales_price"].tolist(),
                ss["ss_quantity"].tolist()):
            info = dd[dk]  # (year, moy, dom, dow, qoy, date, mseq)
            if not (24 <= info[6] <= 35):
                continue
            ir = ipos[ik]
            sp = spos[sk]
            acc[(cats[ir], classes[ir], brands[ir], iids[ir],
                 info[0], info[4], info[1], sids[sp])] += p * q
        by_cat: dict = collections.defaultdict(list)
        for k, s in acc.items():
            by_cat[k[0]].append((k, s))
        rows = []
        for cat, cells in by_cat.items():
            cells.sort(key=lambda kv: -kv[1])
            rk = 0
            prev = None
            for i, (k, s) in enumerate(cells):
                if s != prev:
                    rk = i + 1
                if rk > 100:
                    break
                rows.append((*k[:4], k[4], k[5], k[6], k[7], s, rk))
                prev = s
        rows.sort(key=lambda r: (r[0], r[9], r[1], r[2], r[3], r[4],
                                 r[5], r[6], r[7]))
        return rows[:100]

    def q70(self):
        d = self.d
        ss = d.tables["store_sales"]
        dd = self._dd()
        states = _decode(d, "store", "s_state")
        counties = _decode(d, "store", "s_county")
        spos = {sk: i for i, sk in enumerate(
            d.tables["store"]["s_store_sk"].tolist())}
        acc: dict = collections.defaultdict(int)
        for dk, sk, p in zip(ss["ss_sold_date_sk"].tolist(),
                             ss["ss_store_sk"].tolist(),
                             ss["ss_net_profit"].tolist()):
            if not (24 <= dd[dk][6] <= 35):
                continue
            sp = spos[sk]
            acc[(states[sp], counties[sp])] += p
        by_state: dict = collections.defaultdict(list)
        for (st, co), s in acc.items():
            by_state[st].append((co, s))
        rows = []
        for st, cells in by_state.items():
            cells.sort(key=lambda kv: -kv[1])
            rk = 0
            prev = None
            for i, (co, s) in enumerate(cells):
                if s != prev:
                    rk = i + 1
                rows.append((st, co, s, rk))
                prev = s
        rows.sort(key=lambda r: (r[0], r[3], r[1]))
        return rows[:100]

    def q44(self):
        d = self.d
        ss = d.tables["store_sales"]
        acc: dict = collections.defaultdict(lambda: [0, 0])
        for sk, ik, p in zip(ss["ss_store_sk"].tolist(),
                             ss["ss_item_sk"].tolist(),
                             ss["ss_net_profit"].tolist()):
            if sk == 4:
                a = acc[ik]
                a[0] += p
                a[1] += 1
        avgs = sorted(
            ((s / n_, ik) for ik, (s, n_) in acc.items()))
        iids = _decode(d, "item", "i_item_id")
        ipos = self._item_pos()
        worst = [ik for _a, ik in avgs[:10]]
        best = [ik for _a, ik in sorted(
            ((-a, ik) for a, ik in avgs))[:10]]
        return [(r + 1, iids[ipos[b]], iids[ipos[w]])
                for r, (b, w) in enumerate(zip(best, worst))]

    def q89(self):
        d = self.d
        ss = d.tables["store_sales"]
        y, m, _ = self._date_cols(ss["ss_sold_date_sk"])
        cats = _decode(d, "item", "i_category")
        brands = _decode(d, "item", "i_brand")
        classes = _decode(d, "item", "i_class")
        ipos = self._item_pos()
        snames = _decode(d, "store", "s_store_name")
        spos = {sk: i for i, sk in enumerate(
            d.tables["store"]["s_store_sk"].tolist())}
        set_a_cat = {b"Books", b"Electronics", b"Sports"}
        set_a_cls = {b"class#01", b"class#02", b"class#03"}
        set_b_cat = {b"Men", b"Jewelry", b"Women"}
        set_b_cls = {b"class#04", b"class#05", b"class#06"}
        acc: dict = collections.defaultdict(int)
        for i in np.flatnonzero(y == 1999).tolist():
            ir = ipos[ss["ss_item_sk"][i]]
            c_, cl = cats[ir], classes[ir]
            if not ((c_ in set_a_cat and cl in set_a_cls)
                    or (c_ in set_b_cat and cl in set_b_cls)):
                continue
            sp = spos[ss["ss_store_sk"][i]]
            acc[(c_, brands[ir], snames[sp], int(m[i]))] += int(
                ss["ss_sales_price"][i])
        groups: dict = collections.defaultdict(list)
        for (c_, b, sn, _moy), s in acc.items():
            groups[(c_, b, sn)].append(s)
        rows = []
        for (c_, b, sn, moy), s in acc.items():
            vals = groups[(c_, b, sn)]
            avg = (sum(vals) / len(vals)) / 100.0
            sv = s / 100.0
            if avg > 0 and abs(sv - avg) / avg > 0.1:
                rows.append((c_, b, sn, moy, s, avg, sv - avg))
        rows.sort(key=lambda r: (r[6], r[0], r[1], r[2], r[3]))
        return rows[:100]

    def q2(self):
        d = self.d
        dd = d.tables["date_dim"]
        dnames = _decode(d, "date_dim", "d_day_name")
        wk_of = dict(zip(dd["d_date_sk"].tolist(),
                         dd["d_week_seq"].tolist()))
        day_of = dict(zip(dd["d_date_sk"].tolist(), dnames))
        order = [b"Sunday", b"Monday", b"Tuesday", b"Wednesday",
                 b"Thursday", b"Friday", b"Saturday"]
        acc: dict = collections.defaultdict(lambda: [0] * 7)
        for fact, dk, pk in (
                ("web_sales", "ws_sold_date_sk",
                 "ws_ext_sales_price"),
                ("catalog_sales", "cs_sold_date_sk",
                 "cs_ext_sales_price")):
            tb = d.tables[fact]
            for sk, p in zip(tb[dk].tolist(), tb[pk].tolist()):
                acc[wk_of[sk]][order.index(day_of[sk])] += p
        weeks_of = {
            yy: set(dd["d_week_seq"][dd["d_year"] == yy].tolist())
            for yy in (2001, 2002)}
        out = []
        for w in sorted(weeks_of[2001]):
            if w not in acc or (w + 53) not in acc:
                continue
            if (w + 53) not in weeks_of[2002]:
                continue
            z = acc[w + 53]
            if any(v <= 0 for v in z):
                continue
            yv = acc[w]
            out.append((int(w), *(yv[i] / z[i] for i in range(7))))
        return out

    def q38(self):
        d = self.d
        ln = _decode(d, "customer", "c_last_name")
        fn = _decode(d, "customer", "c_first_name")

        def triples(fact, cust_col, date_col):
            tb = d.tables[fact]
            _, _, dates = self._date_cols(tb[date_col])
            dd = d.tables["date_dim"]
            seq_ok = (dd["d_month_seq"] >= 24) & (dd["d_month_seq"]
                                                  <= 35)
            ok_dates = set(dd["d_date"][seq_ok].tolist())
            out = set()
            for c, dt in zip(tb[cust_col].tolist(), dates.tolist()):
                if dt in ok_dates:
                    out.add((ln[c - 1], fn[c - 1], dt))
            return out

        n = len(triples("store_sales", "ss_customer_sk",
                        "ss_sold_date_sk")
                & triples("catalog_sales", "cs_bill_customer_sk",
                          "cs_sold_date_sk")
                & triples("web_sales", "ws_bill_customer_sk",
                          "ws_sold_date_sk"))
        return [(n,)]

    def q31(self):
        d = self.d
        counties = _decode(d, "customer_address", "ca_county")

        def qsums(fact, date_col, addr_col, price_col):
            tb = d.tables[fact]
            y, m, _ = self._date_cols(tb[date_col])
            acc: dict = collections.defaultdict(int)
            sel = np.flatnonzero((y == 2000) & (m <= 9))
            for a, mm, p in zip(tb[addr_col][sel].tolist(),
                                m[sel].tolist(),
                                tb[price_col][sel].tolist()):
                acc[(counties[a - 1], (mm - 1) // 3 + 1)] += p
            return acc

        ssq = qsums("store_sales", "ss_sold_date_sk", "ss_addr_sk",
                    "ss_ext_sales_price")
        wsq = qsums("web_sales", "ws_sold_date_sk", "ws_bill_addr_sk",
                    "ws_ext_sales_price")
        out = []
        for county in sorted(set(k[0] for k in ssq)):
            s = [ssq.get((county, q)) for q in (1, 2, 3)]
            w = [wsq.get((county, q)) for q in (1, 2, 3)]
            if None in s or None in w or s[0] <= 0 or s[1] <= 0 \
                    or w[0] <= 0 or w[1] <= 0:
                continue
            if w[1] / w[0] > s[1] / s[0] and w[2] / w[1] > s[2] / s[1]:
                out.append((county, 2000, w[1] / w[0], s[1] / s[0],
                            w[2] / w[1], s[2] / s[1]))
        return out

    def q27(self):
        d = self.d
        ss = d.tables["store_sales"]
        y, _, _ = self._date_cols(ss["ss_sold_date_sk"])
        cd = d.tables["customer_demographics"]
        g = _decode(d, "customer_demographics", "cd_gender")
        ms = _decode(d, "customer_demographics", "cd_marital_status")
        es = _decode(d, "customer_demographics", "cd_education_status")
        cd_ok = {sk for sk, a, b, c in zip(
            cd["cd_demo_sk"].tolist(), g, ms, es)
            if a == b"M" and b == b"S" and c == b"College"}
        st = d.tables["store"]
        states = _decode(d, "store", "s_state")
        s_ok = {sk for sk, sst in zip(st["s_store_sk"].tolist(),
                                      states) if sst == b"TN"}
        iids = _decode(d, "item", "i_item_id")
        ipos = self._item_pos()
        acc: dict = collections.defaultdict(lambda: [0] * 5)
        for i in np.flatnonzero(y == 2002).tolist():
            if ss["ss_cdemo_sk"][i] not in cd_ok:
                continue
            if ss["ss_store_sk"][i] not in s_ok:
                continue
            a = acc[(iids[ipos[ss["ss_item_sk"][i]]], b"TN")]
            a[0] += 1
            a[1] += int(ss["ss_quantity"][i])
            a[2] += int(ss["ss_list_price"][i])
            a[3] += int(ss["ss_coupon_amt"][i])
            a[4] += int(ss["ss_sales_price"][i])
        rows = [(k[0], k[1], a[1] / a[0], a[2] / a[0] / 100,
                 a[3] / a[0] / 100, a[4] / a[0] / 100)
                for k, a in sorted(acc.items())]
        return rows[:100]

    def q18(self):
        d = self.d
        cs = d.tables["catalog_sales"]
        y, _, _ = self._date_cols(cs["cs_sold_date_sk"])
        cd = d.tables["customer_demographics"]
        g = _decode(d, "customer_demographics", "cd_gender")
        es = _decode(d, "customer_demographics", "cd_education_status")
        cd_ok = {sk for sk, a, b in zip(cd["cd_demo_sk"].tolist(),
                                        g, es)
                 if a == b"F" and b == b"Unknown"}
        dep = dict(zip(cd["cd_demo_sk"].tolist(),
                       cd["cd_dep_count"].tolist()))
        cust = d.tables["customer"]
        ca = d.tables["customer_address"]
        ca_states = _decode(d, "customer_address", "ca_state")
        countries = _decode(d, "customer_address", "ca_country")
        counties = _decode(d, "customer_address", "ca_county")
        ok_states = {b"MS", b"GA", b"NM", b"OH", b"TX"}
        iids = _decode(d, "item", "i_item_id")
        ipos = self._item_pos()
        acc: dict = collections.defaultdict(lambda: [0] * 8)
        for j in np.flatnonzero(y == 1998).tolist():
            cdk = cs["cs_bill_cdemo_sk"][j]
            if cdk not in cd_ok:
                continue
            c = int(cs["cs_bill_customer_sk"][j]) - 1
            if int(cust["c_birth_month"][c]) not in (1, 6, 8, 9,
                                                     12, 2):
                continue
            a_row = int(cust["c_current_addr_sk"][c]) - 1
            if ca_states[a_row] not in ok_states:
                continue
            k = (iids[ipos[cs["cs_item_sk"][j]]], countries[a_row],
                 ca_states[a_row], counties[a_row])
            a = acc[k]
            a[0] += 1
            a[1] += int(cs["cs_quantity"][j])
            a[2] += int(cs["cs_list_price"][j])
            a[3] += int(cs["cs_coupon_amt"][j])
            a[4] += int(cs["cs_sales_price"][j])
            a[5] += int(cs["cs_net_profit"][j])
            a[6] += int(cust["c_birth_year"][c])
            a[7] += int(dep[cdk])
        rows = [(k[0], k[1], k[2], k[3], a[1] / a[0],
                 a[2] / a[0] / 100, a[3] / a[0] / 100,
                 a[4] / a[0] / 100, a[5] / a[0] / 100,
                 a[6] / a[0], a[7] / a[0])
                for k, a in sorted(acc.items())]
        return rows[:100]

    def q81(self):
        return self._ctr_over_state_avg(
            "catalog_returns", "cr_", "cr_return_amount", b"GA")

    def q30(self):
        return self._ctr_over_state_avg(
            "web_returns", "wr_", "wr_return_amt", b"MO")


def run_tpcds(sf: float = 0.01, queries=None, iterations: int = 1,
              seed: int = 42, verify: bool = True, device=None):
    """Plan+execute the query set on ``device`` (CUDA when None);
    optionally verify vs the reference. Returns [(name, best_seconds,
    result_rows)]."""
    import time

    from ydb_tpu_torch.engine.scan import ColumnSource
    from ydb_tpu_torch.plan import Database, execute_plan, to_host
    from ydb_tpu_torch.sql.parser import parse
    from ydb_tpu_torch.sql.planner import Catalog, plan_select_full

    data = TpcdsData(sf=sf, seed=seed)
    db = Database(
        sources={t: ColumnSource(cols, SCHEMAS[t], data.dicts)
                 for t, cols in data.tables.items()},
        dicts=data.dicts, device=device,
    )
    catalog = Catalog(schemas=dict(SCHEMAS),
                      primary_keys=dict(PRIMARY_KEYS),
                      dicts=data.dicts)
    names = queries or sorted(QUERIES, key=lambda q: int(q[1:]))
    want = reference_answers(data, names) if verify else {}
    results = []
    for name in names:
        from ydb_tpu_torch.workload.runner import scalar_exec_for

        pq = plan_select_full(parse(QUERIES[name]), catalog,
                              scalar_exec_for(db))
        out = to_host(execute_plan(pq.plan, db))  # warmup/compile
        if verify:
            verify_result(name, out, want[name], data, pq)
        best = float("inf")
        for _ in range(max(1, iterations)):
            t0 = time.monotonic()
            out = to_host(execute_plan(pq.plan, db))
            best = min(best, time.monotonic() - t0)
        results.append((name, best, out.num_rows))
    return results


# verification column layout per query: (name, kind) where kind is
# int | str | dec (scaled cents -> compare exactly) | avg (float)
_VERIFY_COLS = {
    "q3": (("d_year", "int"), ("i_brand_id", "int"), ("i_brand", "str"),
           ("sum_agg", "dec")),
    "q6": (("ca_state", "str"), ("cnt", "int")),
    "q7": (("i_item_id", "str"), ("agg1", "avg"), ("agg2", "avg"),
           ("agg3", "avg"), ("agg4", "avg")),
    "q13": (("avg_qty", "avg"), ("avg_esp", "avg"),
            ("avg_ewc", "avg"), ("sum_ewc", "dec")),
    "q48": (("total_qty", "int"),),
    "q19": (("i_brand_id", "int"), ("i_brand", "str"),
            ("i_manufact_id", "int"), ("i_manufact", "str"),
            ("ext_price", "dec")),
    "q26": (("i_item_id", "str"), ("agg1", "avg"), ("agg2", "avg"),
            ("agg3", "avg"), ("agg4", "avg")),
    "q42": (("d_year", "int"), ("i_category_id", "int"),
            ("i_category", "str"), ("sum_agg", "dec")),
    "q43": (("s_store_name", "str"), ("s_store_id", "str"),
            ("sun_sales", "dec"), ("mon_sales", "dec"),
            ("tue_sales", "dec"), ("wed_sales", "dec"),
            ("thu_sales", "dec"), ("fri_sales", "dec"),
            ("sat_sales", "dec")),
    "q52": (("d_year", "int"), ("i_brand_id", "int"), ("i_brand", "str"),
            ("ext_price", "dec")),
    "q55": (("i_brand_id", "int"), ("i_brand", "str"),
            ("ext_price", "dec")),
    "q96": (("cnt", "int"),),
    "q15": (("ca_zip", "str"), ("total", "dec")),
    "q32": (("excess", "dec"),),
    "q34": (("c_last_name", "str"), ("c_first_name", "str"),
            ("c_salutation", "str"), ("c_preferred_cust_flag", "str"),
            ("ss_ticket_number", "int"), ("cnt", "int")),
    "q46": (("c_last_name", "str"), ("c_first_name", "str"),
            ("ca_city", "str"), ("bought_city", "str"),
            ("ss_ticket_number", "int"), ("amt", "dec"),
            ("profit", "dec")),
    "q65": (("s_store_name", "str"), ("i_item_desc", "str"),
            ("revenue", "dec"), ("i_current_price", "dec"),
            ("i_wholesale_cost", "dec"), ("i_brand", "str")),
    "q68": (("c_last_name", "str"), ("c_first_name", "str"),
            ("ca_city", "str"), ("bought_city", "str"),
            ("ss_ticket_number", "int"), ("extended_price", "dec"),
            ("extended_tax", "dec"), ("list_price", "dec")),
    "q73": (("c_last_name", "str"), ("c_first_name", "str"),
            ("c_salutation", "str"), ("c_preferred_cust_flag", "str"),
            ("ss_ticket_number", "int"), ("cnt", "int")),
    "q79": (("c_last_name", "str"), ("c_first_name", "str"),
            ("city30", "str"), ("ss_ticket_number", "int"),
            ("amt", "dec"), ("profit", "dec")),
    "q1": (("c_customer_id", "str"),),
    "q25": (("i_item_id", "str"), ("i_item_desc", "str"),
            ("s_store_id", "str"), ("s_store_name", "str"),
            ("store_sales_profit", "dec"),
            ("store_returns_loss", "dec"),
            ("catalog_sales_profit", "dec")),
    "q29": (("i_item_id", "str"), ("i_item_desc", "str"),
            ("s_store_id", "str"), ("s_store_name", "str"),
            ("store_sales_quantity", "int"),
            ("store_returns_quantity", "int"),
            ("catalog_sales_quantity", "int")),
    "q40": (("w_state", "str"), ("i_item_id", "str"),
            ("sales_before", "dec"), ("sales_after", "dec")),
    "q50": (("s_store_name", "str"), ("s_store_id", "str"),
            ("d30", "int"), ("d60", "int"), ("d90", "int"),
            ("d120", "int"), ("dmore", "int")),
    "q93": (("ss_customer_sk", "int"), ("sumsales", "dec")),
    "q16": (("order_count", "int"), ("total_shipping_cost", "dec"),
            ("total_net_profit", "dec")),
    "q94": (("order_count", "int"), ("total_shipping_cost", "dec"),
            ("total_net_profit", "dec")),
    "q62": (("wname", "str"), ("sm_type", "str"), ("web_name", "str"),
            ("d30", "int"), ("d60", "int"), ("d90", "int"),
            ("d120", "int"), ("dmore", "int")),
    "q81": (("c_customer_id", "str"), ("c_salutation", "str"),
            ("c_first_name", "str"), ("c_last_name", "str"),
            ("ctr_total_return", "dec")),
    "q30": (("c_customer_id", "str"), ("c_salutation", "str"),
            ("c_first_name", "str"), ("c_last_name", "str"),
            ("ctr_total_return", "dec")),
    "q61": (("promotions", "dec"), ("total", "dec")),
    "q17": (("i_item_id", "str"), ("i_item_desc", "str"),
            ("s_state", "str"),
            ("store_sales_quantitycount", "int"),
            ("store_sales_quantityave", "avg"),
            ("store_sales_quantitystdev", "avg"),
            ("store_returns_quantitycount", "int"),
            ("store_returns_quantityave", "avg"),
            ("store_returns_quantitystdev", "avg"),
            ("catalog_sales_quantitycount", "int"),
            ("catalog_sales_quantityave", "avg"),
            ("catalog_sales_quantitystdev", "avg")),
    "q39": (("wsk", "int"), ("isk", "int"), ("moy1", "int"),
            ("mean1", "avg"), ("stdev1", "avg"), ("moy2", "int"),
            ("mean2", "avg"), ("stdev2", "avg")),
    "q9": (("bucket1", "avg"), ("bucket2", "avg"), ("bucket3", "avg"),
           ("bucket4", "avg"), ("bucket5", "avg")),
    "q74": (("customer_id", "str"), ("customer_first_name", "str"),
            ("customer_last_name", "str")),
    "q11": (("customer_id", "str"), ("flag", "str")),
    "q4": (("customer_id", "str"), ("customer_first_name", "str"),
           ("customer_last_name", "str")),
    "q38": (("cnt", "int"),),
    "q36": (("gross_margin", "avg"), ("i_category", "str"),
            ("i_class", "str")),
    "q86": (("total_sum", "dec"), ("i_category", "str"),
            ("i_class", "str")),
    "q22": (("i_item_id", "str"), ("i_brand", "str"),
            ("i_class", "str"), ("i_category", "str"),
            ("qoh", "avg")),
    "q53": (("i_manufact_id", "int"), ("d_qoy", "int"),
            ("sum_sales", "dec"), ("avg_quarterly_sales", "avg")),
    "q10": (("cd_gender", "str"), ("cd_marital_status", "str"),
            ("cd_education_status", "str"),
            ("cd_purchase_estimate", "int"),
            ("cd_credit_rating", "str"), ("cd_dep_count", "int"),
            ("cnt", "int")),
    "q35": (("ca_state", "str"), ("cd_gender", "str"),
            ("cd_marital_status", "str"), ("cd_dep_count", "int"),
            ("cnt1", "int"), ("mn", "int"), ("mx", "int"),
            ("av", "avg")),
    "q63": (("i_manager_id", "int"), ("d_moy", "int"),
            ("sum_sales", "dec"), ("avg_monthly_sales", "avg")),
    "q67": (("i_category", "str"), ("i_class", "str"),
            ("i_brand", "str"), ("i_item_id", "str"),
            ("d_year", "int"), ("d_qoy", "int"), ("d_moy", "int"),
            ("s_store_id", "str"), ("sumsales", "dec"),
            ("rk", "int")),
    "q70": (("s_state", "str"), ("s_county", "str"),
            ("sumsales", "dec"), ("rk", "int")),
    "q44": (("rnk", "int"), ("best_performing", "str"),
            ("worst_performing", "str")),
    "q89": (("i_category", "str"), ("i_brand", "str"),
            ("s_store_name", "str"), ("d_moy", "int"),
            ("sum_sales", "dec"), ("avg_monthly_sales", "avg"),
            ("diff", "avg")),
    "q2": (("week1", "int"), ("sun_ratio", "avg"),
           ("mon_ratio", "avg"), ("tue_ratio", "avg"),
           ("wed_ratio", "avg"), ("thu_ratio", "avg"),
           ("fri_ratio", "avg"), ("sat_ratio", "avg")),
    "q31": (("ca_county", "str"), ("d_year", "int"),
            ("web_q1_q2_increase", "avg"),
            ("store_q1_q2_increase", "avg"),
            ("web_q2_q3_increase", "avg"),
            ("store_q2_q3_increase", "avg")),
    "q27": (("i_item_id", "str"), ("s_state", "str"), ("agg1", "avg"),
            ("agg2", "avg"), ("agg3", "avg"), ("agg4", "avg")),
    "q18": (("i_item_id", "str"), ("ca_country", "str"),
            ("ca_state", "str"), ("ca_county", "str"),
            ("agg1", "avg"), ("agg2", "avg"), ("agg3", "avg"),
            ("agg4", "avg"), ("agg5", "avg"), ("agg6", "avg"),
            ("agg7", "avg")),
    "q88": (("h8_30_to_9", "int"), ("h9_to_9_30", "int"),
            ("h9_30_to_10", "int"), ("h10_to_10_30", "int"),
            ("h10_30_to_11", "int"), ("h11_to_11_30", "int"),
            ("h11_30_to_12", "int"), ("h12_to_12_30", "int")),
    "q91": (("cc_name", "str"), ("cd_marital_status", "str"),
            ("cd_education_status", "str"), ("returns_loss", "dec")),
    "q33": (("i_manufact_id", "int"), ("total_sales", "dec")),
    "q56": (("i_item_id", "str"), ("total_sales", "dec")),
    "q60": (("i_item_id", "str"), ("total_sales", "dec")),
    "q71": (("brand_id", "int"), ("brand", "str"), ("t_hour", "int"),
            ("t_minute", "int"), ("ext_price", "dec")),
    "q98": (("i_item_id", "str"), ("i_item_desc", "str"),
            ("i_category", "str"), ("i_class", "str"),
            ("i_current_price", "dec"), ("itemrevenue", "dec"),
            ("revenueratio", "avg")),
    "q12": (("i_item_id", "str"), ("i_item_desc", "str"),
            ("i_category", "str"), ("i_class", "str"),
            ("i_current_price", "dec"), ("itemrevenue", "dec"),
            ("revenueratio", "avg")),
    "q20": (("i_item_id", "str"), ("i_item_desc", "str"),
            ("i_category", "str"), ("i_class", "str"),
            ("i_current_price", "dec"), ("itemrevenue", "dec"),
            ("revenueratio", "avg")),
    "q21": (("w_warehouse_name", "str"), ("i_item_id", "str"),
            ("inv_before", "int"), ("inv_after", "int")),
    "q37": (("i_item_id", "str"), ("i_item_desc", "str"),
            ("i_current_price", "dec")),
    "q45": (("ca_zip", "str"), ("ca_county", "str"),
            ("total", "dec")),
    "q69": (("cd_gender", "str"), ("cd_marital_status", "str"),
            ("cd_education_status", "str"), ("cnt1", "int"),
            ("cd_purchase_estimate", "int"), ("cnt2", "int"),
            ("cd_credit_rating", "str"), ("cnt3", "int")),
    "q82": (("i_item_id", "str"), ("i_item_desc", "str"),
            ("i_current_price", "dec")),
    "q92": (("excess", "dec"),),
    "q99": (("wname", "str"), ("sm_type", "str"), ("cc_name", "str"),
            ("d30", "int"), ("d60", "int"), ("d90", "int"),
            ("d120", "int"), ("dmore", "int")),
}

# reference rows carry avgs pre-descaled; engine avg output of a DEC2
# column is a double that still needs descaling only when the engine
# kept decimal typing -- col_out handles both via the schema.


def verify_result(name, out, want, data, pq=None) -> None:
    spec = _VERIFY_COLS[name]
    got_cols = []
    for col, kind in spec:
        v, _ok = out.cols[col]
        arr = np.asarray(v)
        if kind == "str":
            src = col
            if pq is not None:
                src = pq.dict_aliases.get(col, col)
            got_cols.append(data.dicts[src].decode(arr))
        elif kind == "dec":
            t = out.schema.field(col).type
            if t.is_decimal:
                got_cols.append([int(x) for x in arr])
            else:
                got_cols.append([int(round(float(x) * 100))
                                 for x in arr])
        elif kind == "avg":
            t = out.schema.field(col).type
            scale = 10.0 ** t.scale if t.is_decimal else 1.0
            got_cols.append([float(x) / scale for x in arr])
        else:
            got_cols.append([int(x) for x in arr])
    ok_cols = [np.asarray(out.cols[col][1], dtype=bool)
               for col, _k in spec]
    got = list(zip(*got_cols)) if got_cols else []
    assert len(got) == len(want), \
        (name, len(got), len(want), got[:3], want[:3])
    for i, (gi, wi) in enumerate(zip(got, want)):
        for j, ((col, kind), g, w) in enumerate(zip(spec, gi, wi)):
            if w is None:
                # zero-input aggregate: the engine must mark the
                # value NULL (validity false), not fabricate one
                assert not ok_cols[j][i], (name, col, g)
            elif kind == "avg":
                assert abs(g - w) < 1e-9, (name, col, g, w)
            elif kind == "dec":
                ww = int(round(w)) if not isinstance(w, int) else w
                assert g == ww, (name, col, g, w)
            else:
                assert g == w, (name, col, g, w)
