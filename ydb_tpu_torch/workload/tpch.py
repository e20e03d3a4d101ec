"""TPC-H workload: deterministic data generator + queries as SSA programs
and logical plans.

The port's copy of ``ydb_tpu/workload/tpch.py`` (the reference ships
dbgen-compatible generators, ydb/library/workload/tpch/): all eight
tables, drawn from one numpy random stream in the reference's order, so a
seed gives arrays and dictionaries identical to the reference's (the
pinned TPC-H digests depend on it). Not copied: ``lineitem_chunks``, the
reference's out-of-core chunked generator.

Dates are int32 days since epoch; money columns are decimal(2) scaled
int64, matching dbgen's cent-exact semantics.
"""

from __future__ import annotations

import numpy as np

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.blocks.dictionary import DictionarySet
from ydb_tpu_torch.ssa.ops import Agg, Op
from ydb_tpu_torch.ssa.program import (
    AggSpec,
    AssignStep,
    Call,
    Col,
    Const,
    FilterStep,
    GroupByStep,
    Program,
    ProjectStep,
    SortStep,
    decimal_lit,
)

DEC2 = dtypes.decimal(2)


def _days(s: str) -> int:
    return np.datetime64(s, "D").astype(np.int32).item()


LINEITEM_SCHEMA = dtypes.schema(
    ("l_orderkey", dtypes.INT64, False),
    ("l_partkey", dtypes.INT64, False),
    ("l_suppkey", dtypes.INT64, False),
    ("l_linenumber", dtypes.INT32, False),
    ("l_quantity", DEC2, False),
    ("l_extendedprice", DEC2, False),
    ("l_discount", DEC2, False),
    ("l_tax", DEC2, False),
    ("l_returnflag", dtypes.STRING, False),
    ("l_linestatus", dtypes.STRING, False),
    ("l_shipdate", dtypes.DATE, False),
    ("l_commitdate", dtypes.DATE, False),
    ("l_receiptdate", dtypes.DATE, False),
    ("l_shipinstruct", dtypes.STRING, False),
    ("l_shipmode", dtypes.STRING, False),
)

ORDERS_SCHEMA = dtypes.schema(
    ("o_orderkey", dtypes.INT64, False),
    ("o_custkey", dtypes.INT64, False),
    ("o_orderstatus", dtypes.STRING, False),
    ("o_totalprice", DEC2, False),
    ("o_orderdate", dtypes.DATE, False),
    ("o_orderpriority", dtypes.STRING, False),
    ("o_shippriority", dtypes.INT32, False),
    ("o_comment", dtypes.STRING, False),
)

CUSTOMER_SCHEMA = dtypes.schema(
    ("c_custkey", dtypes.INT64, False),
    ("c_name", dtypes.STRING, False),
    ("c_address", dtypes.STRING, False),
    ("c_nationkey", dtypes.INT32, False),
    ("c_phone", dtypes.STRING, False),
    ("c_acctbal", DEC2, False),
    ("c_mktsegment", dtypes.STRING, False),
    ("c_comment", dtypes.STRING, False),
)

SUPPLIER_SCHEMA = dtypes.schema(
    ("s_suppkey", dtypes.INT64, False),
    ("s_name", dtypes.STRING, False),
    ("s_address", dtypes.STRING, False),
    ("s_nationkey", dtypes.INT32, False),
    ("s_phone", dtypes.STRING, False),
    ("s_acctbal", DEC2, False),
    ("s_comment", dtypes.STRING, False),
)

PART_SCHEMA = dtypes.schema(
    ("p_partkey", dtypes.INT64, False),
    ("p_name", dtypes.STRING, False),
    ("p_mfgr", dtypes.STRING, False),
    ("p_brand", dtypes.STRING, False),
    ("p_type", dtypes.STRING, False),
    ("p_size", dtypes.INT32, False),
    ("p_container", dtypes.STRING, False),
    ("p_retailprice", DEC2, False),
)

PARTSUPP_SCHEMA = dtypes.schema(
    ("ps_partkey", dtypes.INT64, False),
    ("ps_suppkey", dtypes.INT64, False),
    ("ps_availqty", dtypes.INT32, False),
    ("ps_supplycost", DEC2, False),
)

NATION_SCHEMA = dtypes.schema(
    ("n_nationkey", dtypes.INT32, False),
    ("n_regionkey", dtypes.INT32, False),
    ("n_name", dtypes.STRING, False),
)

REGION_SCHEMA = dtypes.schema(
    ("r_regionkey", dtypes.INT32, False),
    ("r_name", dtypes.STRING, False),
)

NATIONS = [
    b"ALGERIA", b"ARGENTINA", b"BRAZIL", b"CANADA", b"EGYPT", b"ETHIOPIA",
    b"FRANCE", b"GERMANY", b"INDIA", b"INDONESIA", b"IRAN", b"IRAQ",
    b"JAPAN", b"JORDAN", b"KENYA", b"MOROCCO", b"MOZAMBIQUE", b"PERU",
    b"CHINA", b"ROMANIA", b"SAUDI ARABIA", b"VIETNAM", b"RUSSIA",
    b"UNITED KINGDOM", b"UNITED STATES",
]
NATION_REGION = [0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2,
                 3, 4, 2, 3, 3, 1]
REGIONS = [b"AFRICA", b"AMERICA", b"ASIA", b"EUROPE", b"MIDDLE EAST"]
SEGMENTS = [b"AUTOMOBILE", b"BUILDING", b"FURNITURE", b"MACHINERY",
            b"HOUSEHOLD"]
SHIPMODES = [b"REG AIR", b"AIR", b"RAIL", b"SHIP", b"TRUCK", b"MAIL", b"FOB"]
INSTRUCTS = [b"DELIVER IN PERSON", b"COLLECT COD", b"NONE",
             b"TAKE BACK RETURN"]
PRIORITIES = [b"1-URGENT", b"2-HIGH", b"3-MEDIUM", b"4-NOT SPECIFIED",
              b"5-LOW"]

# dbgen text grammar stand-ins: bounded pools keep dictionary sizes (and
# plan-time LIKE-mask evaluation) independent of SF while preserving the
# patterns the TPC-H predicates probe for (p_name '%green%', o_comment
# '%special%requests%', s_comment '%Customer%Complaints%', p_type
# '%BRASS' / 'PROMO%', ...). Reference grammar: dbgen dists.dss via
# ydb/library/workload/tpch_workload.cpp data generators.
COLORS = [
    b"almond", b"antique", b"aquamarine", b"azure", b"beige", b"bisque",
    b"black", b"blanched", b"blue", b"blush", b"brown", b"burlywood",
    b"burnished", b"chartreuse", b"chiffon", b"chocolate", b"coral",
    b"cornflower", b"cornsilk", b"cream", b"cyan", b"dark", b"deep",
    b"dim", b"dodger", b"drab", b"firebrick", b"floral", b"forest",
    b"frosted", b"gainsboro", b"ghost", b"goldenrod", b"green", b"grey",
    b"honeydew", b"hot", b"indian", b"ivory", b"khaki", b"lace",
    b"lavender", b"lawn", b"lemon", b"light", b"lime", b"linen",
    b"magenta", b"maroon", b"medium", b"metallic", b"midnight", b"mint",
    b"misty", b"moccasin", b"navajo", b"navy", b"olive", b"orange",
    b"orchid", b"pale", b"papaya", b"peach", b"peru", b"pink", b"plum",
    b"powder", b"puff", b"purple", b"red", b"rose", b"rosy", b"royal",
    b"saddle", b"salmon", b"sandy", b"seashell", b"sienna", b"sky",
    b"slate", b"smoke", b"snow", b"spring", b"steel", b"tan", b"thistle",
    b"tomato", b"turquoise", b"violet", b"wheat", b"white", b"yellow",
]
TYPE_SYL1 = [b"STANDARD", b"SMALL", b"MEDIUM", b"LARGE", b"ECONOMY",
             b"PROMO"]
TYPE_SYL2 = [b"ANODIZED", b"BURNISHED", b"PLATED", b"POLISHED", b"BRUSHED"]
TYPE_SYL3 = [b"TIN", b"NICKEL", b"BRASS", b"STEEL", b"COPPER"]
CONTAINER_SYL1 = [b"SM", b"LG", b"MED", b"JUMBO", b"WRAP"]
CONTAINER_SYL2 = [b"CASE", b"BOX", b"BAG", b"JAR", b"PKG", b"PACK", b"CAN",
                  b"DRUM"]
COMMENT_WORDS = [
    b"furiously", b"carefully", b"quickly", b"blithely", b"slyly",
    b"express", b"regular", b"final", b"ironic", b"pending", b"bold",
    b"unusual", b"even", b"special", b"silent", b"daring", b"requests",
    b"accounts", b"packages", b"deposits", b"instructions", b"theodolites",
    b"dependencies", b"excuses", b"platelets", b"asymptotes", b"somas",
    b"dugouts", b"sleep", b"nag", b"haggle", b"wake", b"cajole", b"detect",
    b"integrate", b"Customer", b"Complaints", b"above", b"against",
    b"along",
]


def _register(dicts: DictionarySet, col: str, values) -> np.ndarray:
    d = dicts.for_column(col)
    return np.fromiter((d.add(v) for v in values), dtype=np.int32,
                       count=len(values))


def _encode_pool(dicts: DictionarySet, col: str, pool: list[bytes],
                 picks: np.ndarray) -> np.ndarray:
    """Bulk dictionary encode: register the pool once, map pick indices."""
    ids = _register(dicts, col, pool)
    return ids[picks]


def _make_comment_pool(rng, size: int, n_words: int = 5) -> list[bytes]:
    """Bounded pool of pseudo-dbgen comments (word-chain grammar)."""
    words = np.array(COMMENT_WORDS, dtype=object)
    out = []
    for _ in range(size):
        k = rng.integers(2, n_words + 1)
        out.append(b" ".join(words[rng.integers(0, len(words), k)]))
    return out


def _encode_values(dicts: DictionarySet, col: str, values) -> np.ndarray:
    """Bulk encode a (possibly huge, mostly-distinct) value list: register
    each distinct value once, then map by index — O(n log n) instead of n
    Python dict probes."""
    arr = np.asarray(values, dtype=object)
    uniq, inv = np.unique(arr, return_inverse=True)
    ids = _register(dicts, col, list(uniq))
    return ids[inv].astype(np.int32)


class TpchData:
    """Generated tables as host numpy column dicts + shared dictionaries."""

    def __init__(self, sf: float, seed: int = 42):
        self.sf = sf
        self.dicts = DictionarySet()
        rng = np.random.default_rng(seed)
        self.tables: dict[str, dict[str, np.ndarray]] = {}
        self._gen_orders_lineitem(rng)
        self._gen_customer(rng)
        self._gen_supplier(rng)
        self._gen_part_partsupp(rng)
        self._gen_nation_region()

    # dbgen cardinalities: orders = 1.5M * SF; lineitem ~ 4 lines/order
    def _gen_orders_lineitem(self, rng):
        n_orders = int(1_500_000 * self.sf)
        n_cust = max(int(150_000 * self.sf), 1)
        start = _days("1992-01-01")
        end = _days("1998-08-02")
        o_orderkey = np.arange(1, n_orders + 1, dtype=np.int64)
        o_orderdate = rng.integers(start, end + 1, n_orders, dtype=np.int32)
        o_custkey = rng.integers(1, n_cust + 1, n_orders, dtype=np.int64)
        lines_per_order = rng.integers(1, 8, n_orders, dtype=np.int32)
        n_li = int(lines_per_order.sum())

        li_order_idx = np.repeat(np.arange(n_orders), lines_per_order)
        l_orderkey = o_orderkey[li_order_idx]
        l_linenumber = (
            np.arange(n_li, dtype=np.int64)
            - np.repeat(
                np.cumsum(lines_per_order) - lines_per_order, lines_per_order
            )
            + 1
        ).astype(np.int32)
        n_part = max(int(200_000 * self.sf), 1)
        n_supp = max(int(10_000 * self.sf), 1)
        l_partkey = rng.integers(1, n_part + 1, n_li, dtype=np.int64)
        l_suppkey = rng.integers(1, n_supp + 1, n_li, dtype=np.int64)
        l_quantity = rng.integers(1, 51, n_li, dtype=np.int64) * 100
        # dbgen: extendedprice = qty * part retail price (~90k-110k cents)
        part_price = rng.integers(90_000, 110_001, n_li, dtype=np.int64)
        l_extendedprice = (l_quantity // 100) * part_price // 100 * 100
        l_discount = rng.integers(0, 11, n_li, dtype=np.int64)  # 0.00-0.10
        l_tax = rng.integers(0, 9, n_li, dtype=np.int64)        # 0.00-0.08
        ship_delay = rng.integers(1, 122, n_li, dtype=np.int32)
        l_shipdate = o_orderdate[li_order_idx] + ship_delay
        l_commitdate = o_orderdate[li_order_idx] + rng.integers(
            30, 91, n_li, dtype=np.int32)
        l_receiptdate = l_shipdate + rng.integers(1, 31, n_li, dtype=np.int32)

        today = _days("1995-06-17")
        shipped = l_shipdate <= today
        # returnflag: R or A for shipped-long-ago (50/50), N otherwise
        ret = np.where(
            l_receiptdate > today,
            2,  # N
            rng.integers(0, 2, n_li),  # 0=R 1=A
        )
        rf_dict = self.dicts.for_column("l_returnflag")
        ids = np.array([rf_dict.add(b"R"), rf_dict.add(b"A"),
                        rf_dict.add(b"N")], dtype=np.int32)
        l_returnflag = ids[ret]
        ls_dict = self.dicts.for_column("l_linestatus")
        ls_ids = np.array([ls_dict.add(b"O"), ls_dict.add(b"F")],
                          dtype=np.int32)
        l_linestatus = ls_ids[shipped.astype(np.int32)]
        sm = rng.integers(0, len(SHIPMODES), n_li)
        si = rng.integers(0, len(INSTRUCTS), n_li)
        smd = self.dicts.for_column("l_shipmode")
        sm_ids = np.array([smd.add(v) for v in SHIPMODES], dtype=np.int32)
        sid = self.dicts.for_column("l_shipinstruct")
        si_ids = np.array([sid.add(v) for v in INSTRUCTS], dtype=np.int32)

        self.tables["lineitem"] = {
            "l_orderkey": l_orderkey,
            "l_partkey": l_partkey,
            "l_suppkey": l_suppkey,
            "l_linenumber": l_linenumber,
            "l_quantity": l_quantity,
            "l_extendedprice": l_extendedprice,
            "l_discount": l_discount,
            "l_tax": l_tax,
            "l_returnflag": l_returnflag,
            "l_linestatus": l_linestatus,
            "l_shipdate": l_shipdate.astype(np.int32),
            "l_commitdate": l_commitdate.astype(np.int32),
            "l_receiptdate": l_receiptdate.astype(np.int32),
            "l_shipinstruct": si_ids[si],
            "l_shipmode": sm_ids[sm],
        }
        pr = rng.integers(0, len(PRIORITIES), n_orders)
        prd = self.dicts.for_column("o_orderpriority")
        pr_ids = np.array([prd.add(v) for v in PRIORITIES], dtype=np.int32)
        osd = self.dicts.for_column("o_orderstatus")
        os_ids = np.array([osd.add(b"O"), osd.add(b"F"), osd.add(b"P")],
                          dtype=np.int32)
        status = rng.integers(0, 3, n_orders)
        # o_comment pool: ~2% of entries carry the q13 'special…requests'
        # chain, the rest are plain word chains
        pool = _make_comment_pool(rng, 2048)
        for i in range(0, len(pool), 50):
            pool[i] = pool[i] + b" special handling requests " + pool[i]
        self.tables["orders"] = {
            "o_orderkey": o_orderkey,
            "o_custkey": o_custkey,
            "o_orderstatus": os_ids[status],
            "o_totalprice": rng.integers(
                100_00, 500_000_00, n_orders, dtype=np.int64),
            "o_orderdate": o_orderdate,
            "o_orderpriority": pr_ids[pr],
            "o_shippriority": np.zeros(n_orders, dtype=np.int32),
            "o_comment": _encode_pool(
                self.dicts, "o_comment", pool,
                rng.integers(0, len(pool), n_orders)),
        }

    @staticmethod
    def _phones(rng, nationkey: np.ndarray) -> list[bytes]:
        """dbgen phone format: 'CC-xxx-xxx-xxxx', CC = 10 + nationkey
        (q22 reads substring(c_phone, 1, 2) as the country code)."""
        digits = rng.integers(0, 10, (len(nationkey), 10))
        return [
            b"%d-%d%d%d-%d%d%d-%d%d%d%d" % ((10 + int(nk),) + tuple(d))
            for nk, d in zip(nationkey, digits)
        ]

    def _gen_customer(self, rng):
        n = max(int(150_000 * self.sf), 1)
        seg = rng.integers(0, len(SEGMENTS), n)
        sd = self.dicts.for_column("c_mktsegment")
        seg_ids = np.array([sd.add(v) for v in SEGMENTS], dtype=np.int32)
        nationkey = rng.integers(0, 25, n, dtype=np.int32)
        addr_pool = _make_comment_pool(rng, 512, n_words=3)
        self.tables["customer"] = {
            "c_custkey": np.arange(1, n + 1, dtype=np.int64),
            "c_name": _encode_values(
                self.dicts, "c_name",
                [b"Customer#%09d" % k for k in range(1, n + 1)]),
            "c_address": _encode_pool(
                self.dicts, "c_address", addr_pool,
                rng.integers(0, len(addr_pool), n)),
            "c_nationkey": nationkey,
            "c_phone": _encode_values(
                self.dicts, "c_phone", self._phones(rng, nationkey)),
            "c_acctbal": rng.integers(-999_99, 9999_99, n, dtype=np.int64),
            "c_mktsegment": seg_ids[seg],
            "c_comment": _encode_pool(
                self.dicts, "c_comment", _make_comment_pool(rng, 1024),
                rng.integers(0, 1024, n)),
        }

    def _gen_supplier(self, rng):
        n = max(int(10_000 * self.sf), 1)
        nationkey = rng.integers(0, 25, n, dtype=np.int32)
        addr_pool = _make_comment_pool(rng, 256, n_words=3)
        # ~1.6% of suppliers carry the q16 'Customer Complaints' chain
        comment_pool = _make_comment_pool(rng, 512)
        for i in range(0, len(comment_pool), 64):
            comment_pool[i] = comment_pool[i] + b" Customer loud Complaints"
        self.tables["supplier"] = {
            "s_suppkey": np.arange(1, n + 1, dtype=np.int64),
            "s_name": _encode_values(
                self.dicts, "s_name",
                [b"Supplier#%09d" % k for k in range(1, n + 1)]),
            "s_address": _encode_pool(
                self.dicts, "s_address", addr_pool,
                rng.integers(0, len(addr_pool), n)),
            "s_nationkey": nationkey,
            "s_phone": _encode_values(
                self.dicts, "s_phone", self._phones(rng, nationkey)),
            "s_acctbal": rng.integers(-999_99, 9999_99, n, dtype=np.int64),
            "s_comment": _encode_pool(
                self.dicts, "s_comment", comment_pool,
                rng.integers(0, len(comment_pool), n)),
        }

    def _gen_part_partsupp(self, rng):
        n = max(int(200_000 * self.sf), 1)
        # p_name: 3 colors joined (dbgen: 5 of 92); pool bounded by combos
        picks = rng.integers(0, len(COLORS), (n, 3))
        names = [b" ".join((COLORS[a], COLORS[b], COLORS[c]))
                 for a, b, c in picks]
        mfgr = rng.integers(1, 6, n)
        brand = mfgr * 10 + rng.integers(1, 6, n)
        t1 = rng.integers(0, len(TYPE_SYL1), n)
        t2 = rng.integers(0, len(TYPE_SYL2), n)
        t3 = rng.integers(0, len(TYPE_SYL3), n)
        types = [b" ".join((TYPE_SYL1[a], TYPE_SYL2[b], TYPE_SYL3[c]))
                 for a, b, c in zip(t1, t2, t3)]
        c1 = rng.integers(0, len(CONTAINER_SYL1), n)
        c2 = rng.integers(0, len(CONTAINER_SYL2), n)
        containers = [b" ".join((CONTAINER_SYL1[a], CONTAINER_SYL2[b]))
                      for a, b in zip(c1, c2)]
        self.tables["part"] = {
            "p_partkey": np.arange(1, n + 1, dtype=np.int64),
            "p_name": _encode_values(self.dicts, "p_name", names),
            "p_mfgr": _encode_values(
                self.dicts, "p_mfgr",
                [b"Manufacturer#%d" % m for m in mfgr]),
            "p_brand": _encode_values(
                self.dicts, "p_brand", [b"Brand#%d" % b for b in brand]),
            "p_type": _encode_values(self.dicts, "p_type", types),
            "p_size": rng.integers(1, 51, n, dtype=np.int32),
            "p_container": _encode_values(
                self.dicts, "p_container", containers),
            "p_retailprice": (90_000 + (np.arange(1, n + 1) % 20_001)
                              ).astype(np.int64),
        }
        # partsupp: each part has 4 suppliers (dbgen), pk (partkey, suppkey)
        n_supp = max(int(10_000 * self.sf), 1)
        ps_partkey = np.repeat(np.arange(1, n + 1, dtype=np.int64), 4)
        ps_suppkey = (
            (ps_partkey + np.tile(np.arange(4, dtype=np.int64), n)
             * max(n_supp // 4, 1)) % n_supp + 1
        )
        m = len(ps_partkey)
        self.tables["partsupp"] = {
            "ps_partkey": ps_partkey,
            "ps_suppkey": ps_suppkey,
            "ps_availqty": rng.integers(1, 10_000, m, dtype=np.int32),
            "ps_supplycost": rng.integers(100, 1000_00, m, dtype=np.int64),
        }

    def _gen_nation_region(self):
        self.tables["nation"] = {
            "n_nationkey": np.arange(25, dtype=np.int32),
            "n_regionkey": np.array(NATION_REGION, dtype=np.int32),
            "n_name": _register(self.dicts, "n_name", NATIONS),
        }
        self.tables["region"] = {
            "r_regionkey": np.arange(5, dtype=np.int32),
            "r_name": _register(self.dicts, "r_name", REGIONS),
        }

    def schema(self, table: str) -> dtypes.Schema:
        return {
            "lineitem": LINEITEM_SCHEMA,
            "orders": ORDERS_SCHEMA,
            "customer": CUSTOMER_SCHEMA,
            "supplier": SUPPLIER_SCHEMA,
            "part": PART_SCHEMA,
            "partsupp": PARTSUPP_SCHEMA,
            "nation": NATION_SCHEMA,
            "region": REGION_SCHEMA,
        }[table]


#: catalog primary keys (FK->PK lookup-join planning; schemeshard analog)
PRIMARY_KEYS = {
    "lineitem": ("l_orderkey", "l_linenumber"),
    "orders": ("o_orderkey",),
    "customer": ("c_custkey",),
    "supplier": ("s_suppkey",),
    "part": ("p_partkey",),
    "partsupp": ("ps_partkey", "ps_suppkey"),
    "nation": ("n_nationkey",),
    "region": ("r_regionkey",),
}


# ---------------- queries as SSA programs ----------------


def q1_program() -> Program:
    """TPC-H Q1: pricing summary report (the BASELINE north-star scan).

    select l_returnflag, l_linestatus, sum(qty), sum(price),
           sum(price*(1-disc)), sum(price*(1-disc)*(1+tax)),
           avg(qty), avg(price), avg(disc), count(*)
    from lineitem where l_shipdate <= '1998-12-01' - 90 days
    group by l_returnflag, l_linestatus order by same
    """
    cutoff = _days("1998-12-01") - 90
    one = decimal_lit("1", 2)
    disc_price = Call(Op.MUL, Col("l_extendedprice"),
                      Call(Op.SUB, one, Col("l_discount")))
    # charge: scale-6 decimal; int64 sums hold through ~SF-10 (SF-100 needs
    # the planned two-word accumulator)
    charge = Call(Op.MUL, Col("disc_price"),
                  Call(Op.ADD, one, Col("l_tax")))
    return Program((
        FilterStep(Call(Op.LE, Col("l_shipdate"),
                        Const(cutoff, dtypes.DATE))),
        AssignStep("disc_price", disc_price),
        AssignStep("charge", charge),
        GroupByStep(
            keys=("l_returnflag", "l_linestatus"),
            aggs=(
                AggSpec(Agg.SUM, "l_quantity", "sum_qty"),
                AggSpec(Agg.SUM, "l_extendedprice", "sum_base_price"),
                AggSpec(Agg.SUM, "disc_price", "sum_disc_price"),
                AggSpec(Agg.SUM, "charge", "sum_charge"),
                AggSpec(Agg.AVG, "l_quantity", "avg_qty"),
                AggSpec(Agg.AVG, "l_extendedprice", "avg_price"),
                AggSpec(Agg.AVG, "l_discount", "avg_disc"),
                AggSpec(Agg.COUNT_ALL, None, "count_order"),
            ),
        ),
        SortStep(keys=("l_returnflag", "l_linestatus")),
    ))


def q6_program() -> Program:
    """TPC-H Q6: forecasting revenue change (pure filter + global agg)."""
    d0 = _days("1994-01-01")
    d1 = _days("1995-01-01")
    return Program((
        FilterStep(Call(Op.GE, Col("l_shipdate"), Const(d0, dtypes.DATE))),
        FilterStep(Call(Op.LT, Col("l_shipdate"), Const(d1, dtypes.DATE))),
        FilterStep(Call(Op.GE, Col("l_discount"), decimal_lit("0.05", 2))),
        FilterStep(Call(Op.LE, Col("l_discount"), decimal_lit("0.07", 2))),
        FilterStep(Call(Op.LT, Col("l_quantity"), decimal_lit("24", 2))),
        AssignStep("revenue_item",
                   Call(Op.MUL, Col("l_extendedprice"), Col("l_discount"))),
        GroupByStep(keys=(), aggs=(
            AggSpec(Agg.SUM, "revenue_item", "revenue"),
        )),
    ))


# ---------------- join queries as logical plans ----------------


def q3_plan():
    """TPC-H Q3: shipping priority (BASELINE config 4 join shape).

    customer(BUILDING) semi-> orders(< date) -> lineitem(> date) joins,
    then group by (l_orderkey, o_orderdate, o_shippriority), top-10 by
    revenue.
    """
    from ydb_tpu_torch.plan import LookupJoin, TableScan, Transform
    from ydb_tpu_torch.ssa.program import DictPredicate

    date = _days("1995-03-15")
    customers = TableScan("customer", Program((
        FilterStep(DictPredicate("c_mktsegment", "eq", b"BUILDING")),
        ProjectStep(("c_custkey",)),
    )))
    orders = TableScan("orders", Program((
        FilterStep(Call(Op.LT, Col("o_orderdate"), Const(date, dtypes.DATE))),
        ProjectStep(("o_orderkey", "o_custkey", "o_orderdate",
                     "o_shippriority")),
    )))
    orders_building = LookupJoin(
        probe=orders, build=customers,
        probe_keys=("o_custkey",), build_keys=("c_custkey",), kind="semi",
    )
    lineitem = TableScan("lineitem", Program((
        FilterStep(Call(Op.GT, Col("l_shipdate"), Const(date, dtypes.DATE))),
        ProjectStep(("l_orderkey", "l_extendedprice", "l_discount")),
    )))
    joined = LookupJoin(
        probe=lineitem, build=orders_building,
        probe_keys=("l_orderkey",), build_keys=("o_orderkey",),
        payload=("o_orderdate", "o_shippriority"), kind="inner",
    )
    return Transform(joined, Program((
        AssignStep("rev_item", Call(Op.MUL, Col("l_extendedprice"),
                   Call(Op.SUB, decimal_lit("1", 2), Col("l_discount")))),
        GroupByStep(
            keys=("l_orderkey", "o_orderdate", "o_shippriority"),
            aggs=(AggSpec(Agg.SUM, "rev_item", "revenue"),),
        ),
        # l_orderkey tie-break pins the order beyond the spec's
        # (revenue desc, date) for deterministic comparisons
        SortStep(keys=("revenue", "o_orderdate", "l_orderkey"),
                 descending=(True, False, False), limit=10),
    )))


def q5_plan():
    """TPC-H Q5: local supplier volume (6-table join chain)."""
    from ydb_tpu_torch.plan import LookupJoin, TableScan, Transform
    from ydb_tpu_torch.ssa.program import DictPredicate

    d0, d1 = _days("1994-01-01"), _days("1995-01-01")
    region = TableScan("region", Program((
        FilterStep(DictPredicate("r_name", "eq", b"ASIA")),
        ProjectStep(("r_regionkey",)),
    )))
    nation = LookupJoin(
        probe=TableScan("nation"), build=region,
        probe_keys=("n_regionkey",), build_keys=("r_regionkey",),
        kind="semi",
    )
    orders = TableScan("orders", Program((
        FilterStep(Call(Op.GE, Col("o_orderdate"), Const(d0, dtypes.DATE))),
        FilterStep(Call(Op.LT, Col("o_orderdate"), Const(d1, dtypes.DATE))),
        ProjectStep(("o_orderkey", "o_custkey")),
    )))
    li = TableScan("lineitem", Program((
        ProjectStep(("l_orderkey", "l_suppkey", "l_extendedprice",
                     "l_discount")),
    )))
    li_orders = LookupJoin(
        probe=li, build=orders,
        probe_keys=("l_orderkey",), build_keys=("o_orderkey",),
        payload=("o_custkey",), kind="inner",
    )
    li_supp = LookupJoin(
        probe=li_orders, build=TableScan("supplier"),
        probe_keys=("l_suppkey",), build_keys=("s_suppkey",),
        payload=("s_nationkey",), kind="inner",
    )
    li_cust = LookupJoin(
        probe=li_supp, build=TableScan("customer"),
        probe_keys=("o_custkey",), build_keys=("c_custkey",),
        payload=("c_nationkey",), kind="inner",
    )
    li_nation = LookupJoin(
        probe=li_cust, build=nation,
        probe_keys=("s_nationkey",), build_keys=("n_nationkey",),
        payload=("n_name",), kind="inner",
    )
    return Transform(li_nation, Program((
        # customer and supplier must share the nation
        FilterStep(Call(Op.EQ, Call(Op.CAST_INT64, Col("c_nationkey")),
                        Call(Op.CAST_INT64, Col("s_nationkey")))),
        AssignStep("rev_item", Call(Op.MUL, Col("l_extendedprice"),
                   Call(Op.SUB, decimal_lit("1", 2), Col("l_discount")))),
        GroupByStep(keys=("n_name",),
                    aggs=(AggSpec(Agg.SUM, "rev_item", "revenue"),)),
        SortStep(keys=("revenue",), descending=(True,)),
    )))
