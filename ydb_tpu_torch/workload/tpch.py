"""TPC-H workload: deterministic data generator + Q1/Q6 as SSA programs.

The port's copy of the lineitem/orders part of ``ydb_tpu/workload/tpch.py``
(the reference ships dbgen-compatible generators,
ydb/library/workload/tpch/). ``TpchData`` draws from the same numpy
random stream in the same order as the reference's generator, whose
first step is ``_gen_orders_lineitem``, so a seed gives arrays identical
to the reference's ``lineitem`` and ``orders`` tables. The other tables
(customer, supplier, part, partsupp, nation, region) are not on the
ported slice and are not generated.

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

SHIPMODES = [b"REG AIR", b"AIR", b"RAIL", b"SHIP", b"TRUCK", b"MAIL", b"FOB"]
INSTRUCTS = [b"DELIVER IN PERSON", b"COLLECT COD", b"NONE",
             b"TAKE BACK RETURN"]
PRIORITIES = [b"1-URGENT", b"2-HIGH", b"3-MEDIUM", b"4-NOT SPECIFIED",
              b"5-LOW"]


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


class TpchData:
    """Generated ``lineitem`` and ``orders`` as host numpy column dicts +
    shared dictionaries."""

    def __init__(self, sf: float, seed: int = 42):
        self.sf = sf
        self.dicts = DictionarySet()
        rng = np.random.default_rng(seed)
        self.tables: dict[str, dict[str, np.ndarray]] = {}
        self._gen_orders_lineitem(rng)

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

    def schema(self, table: str) -> dtypes.Schema:
        return {"lineitem": LINEITEM_SCHEMA, "orders": ORDERS_SCHEMA}[table]


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
