"""ClickBench workload: the hits-table generator and the URL group-by
queries (q33, q36) as SSA programs.

The port's copy of the generator of ``ydb_tpu/workload/clickbench.py``
(reference: ydb/library/workload/clickbench/click_bench_queries.sql),
unchanged so a seed gives the same hits table as the reference. The URL
dictionary is drawn from a pool of 2000 synthetic paths (about 1750
distinct values), so ``GROUP BY URL`` lands in the group-by tier above
``kernels.ONEHOT_GROUP_LIMIT`` (512) groups — the tier of the CUDA
kernels. ``q33_q36_answers`` is an independent vectorised numpy
reference for the two queries (``np.bincount`` over URL ids), fast
enough for the published row counts.
"""

from __future__ import annotations

import numpy as np

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.blocks.dictionary import DictionarySet
from ydb_tpu_torch.ssa.ops import Agg, Op
from ydb_tpu_torch.ssa.program import (
    AggSpec,
    Call,
    Col,
    Const,
    DictPredicate,
    FilterStep,
    GroupByStep,
    Program,
    SortStep,
    lit,
)

HITS_SCHEMA = dtypes.schema(
    ("WatchID", dtypes.INT64, False),
    ("UserID", dtypes.INT64, False),
    ("EventDate", dtypes.DATE, False),
    ("EventTime", dtypes.TIMESTAMP, False),
    ("CounterID", dtypes.INT32, False),
    ("RegionID", dtypes.INT32, False),
    ("AdvEngineID", dtypes.INT32, False),
    ("SearchEngineID", dtypes.INT32, False),
    ("ResolutionWidth", dtypes.INT32, False),
    ("MobilePhone", dtypes.INT32, False),
    ("MobilePhoneModel", dtypes.STRING, False),
    ("SearchPhrase", dtypes.STRING, False),
    ("URL", dtypes.STRING, False),
    ("Title", dtypes.STRING, False),
    ("Referer", dtypes.STRING, False),
    ("ClientIP", dtypes.INT64, False),
    ("IsRefresh", dtypes.INT32, False),
    ("DontCountHits", dtypes.INT32, False),
    ("IsLink", dtypes.INT32, False),
    ("IsDownload", dtypes.INT32, False),
    ("TraficSourceID", dtypes.INT32, False),
    ("URLHash", dtypes.INT64, False),
    ("RefererHash", dtypes.INT64, False),
    ("WindowClientWidth", dtypes.INT32, False),
    ("WindowClientHeight", dtypes.INT32, False),
)

# spec constants the point-filter queries (q40/q41) probe for; the
# generator plants them so synthetic runs return rows
URLHASH_HOT = 2868770270353813622
REFERERHASH_HOT = 3594120000172545465

_PHONE_MODELS = [b"", b"iPhone 2", b"iPhone 4", b"Nokia 3310",
                 b"Galaxy S", b"Pixel", b"Xperia Z", b"Moto G"]
_PHRASE_WORDS = [b"weather", b"news", b"cats", b"tpu", b"database",
                 b"flights", b"pizza", b"maps", b"music", b"jobs"]


def _zipf_choice(rng, n_values: int, size: int) -> np.ndarray:
    """Skewed (zipf-ish) ids in [0, n_values): few heavy hitters."""
    z = rng.zipf(1.5, size=size)
    return np.minimum(z - 1, n_values - 1).astype(np.int64)


class ClickBenchData:
    """Generated hits table + shared dictionaries."""

    def __init__(self, rows: int = 100_000, seed: int = 42):
        rng = np.random.default_rng(seed)
        self.dicts = DictionarySet()
        n = rows
        d0 = int(np.datetime64("2013-07-01", "D").astype(np.int32))
        n_users = max(n // 20, 10)

        phrase_pool = [b""] + [
            b" ".join(rng.choice(_PHRASE_WORDS,
                                 size=rng.integers(1, 4), replace=True))
            for _ in range(999)
        ]
        phrase_d = self.dicts.for_column("SearchPhrase")
        phrase_ids = np.array([phrase_d.add(p) for p in phrase_pool],
                              dtype=np.int32)
        # ~77% of hits have no search phrase (ClickBench-like sparsity)
        phrase_pick = np.where(
            rng.random(n) < 0.77, 0,
            1 + _zipf_choice(rng, len(phrase_pool) - 1, n))

        model_d = self.dicts.for_column("MobilePhoneModel")
        model_ids = np.array([model_d.add(m) for m in _PHONE_MODELS],
                             dtype=np.int32)
        model_pick = np.where(
            rng.random(n) < 0.9, 0,
            1 + _zipf_choice(rng, len(_PHONE_MODELS) - 1, n))

        # URLs: a skewed pool of synthetic paths; 2 of 7 hosts are
        # google.* so ~29% of rows match the LIKE '%google%' queries
        hosts = [b"example.com", b"news.site", b"google.com",
                 b"shop.io", b"google.de", b"docs.org", b"blog.net"]
        url_pool = [
            b"http://%s/%s/%d" % (rng.choice(hosts),
                                  rng.choice(_PHRASE_WORDS),
                                  rng.integers(0, 100))
            for _ in range(2000)
        ]
        url_d = self.dicts.for_column("URL")
        url_ids = np.array([url_d.add(u) for u in url_pool],
                           dtype=np.int32)
        title_pool = [b""] + [
            (b"Google %s - page %d" if i % 5 == 0
             else b"%s - page %d") % (rng.choice(_PHRASE_WORDS),
                                      rng.integers(0, 50))
            for i in range(499)
        ]
        title_d = self.dicts.for_column("Title")
        title_ids = np.array([title_d.add(t) for t in title_pool],
                             dtype=np.int32)

        # referers: skewed pool over hosts incl. www.-prefixed ones
        # (q28 groups by CutWWW(GetHost(Referer))); ~35% empty
        ref_hosts = [b"www.google.com", b"news.site", b"google.de",
                     b"www.shop.io", b"blog.net", b"example.com"]
        referer_pool = [b""] + [
            b"http://%s/%s/%d" % (rng.choice(ref_hosts),
                                  rng.choice(_PHRASE_WORDS),
                                  rng.integers(0, 40))
            for _ in range(499)
        ]
        referer_d = self.dicts.for_column("Referer")
        referer_ids = np.array([referer_d.add(r) for r in referer_pool],
                               dtype=np.int32)
        referer_pick = np.where(
            rng.random(n) < 0.35, 0,
            1 + _zipf_choice(rng, len(referer_pool) - 1, n))

        # hash columns: skewed pools seeded with the spec's hot
        # constants so q40/q41 point filters hit rows
        urlhash_pool = np.concatenate([
            np.array([URLHASH_HOT], dtype=np.int64),
            rng.integers(1, 1 << 62, 199, dtype=np.int64)])
        refhash_pool = np.concatenate([
            np.array([REFERERHASH_HOT], dtype=np.int64),
            rng.integers(1, 1 << 62, 199, dtype=np.int64)])

        dates = (d0 + rng.integers(0, 31, n)).astype(np.int32)
        self.hits: dict[str, np.ndarray] = {
            "WatchID": rng.integers(1, 1 << 62, n, dtype=np.int64),
            "UserID": (_zipf_choice(rng, n_users, n) + 1),
            "EventDate": dates,
            "EventTime": (dates.astype(np.int64) * 86_400_000_000
                          + rng.integers(0, 86_400, n) * 1_000_000),
            # CounterID 62 is a heavy hitter (~10%): the q36-q42 site
            # analytics queries all filter CounterID = 62
            "CounterID": np.where(
                rng.random(n) < 0.10, 62,
                rng.integers(1, 10_000, n)).astype(np.int32),
            "RegionID": _zipf_choice(rng, 5000, n).astype(np.int32),
            "AdvEngineID": np.where(
                rng.random(n) < 0.95, 0,
                rng.integers(1, 20, n)).astype(np.int32),
            "SearchEngineID": np.where(
                rng.random(n) < 0.7, 0,
                rng.integers(1, 8, n)).astype(np.int32),
            "ResolutionWidth": rng.choice(
                np.array([1024, 1280, 1366, 1440, 1536, 1600, 1920],
                         dtype=np.int32), size=n),
            "MobilePhone": rng.integers(0, 8, n, dtype=np.int32),
            "MobilePhoneModel": model_ids[model_pick],
            "SearchPhrase": phrase_ids[phrase_pick],
            "URL": url_ids[_zipf_choice(rng, len(url_pool), n)],
            "Title": title_ids[np.where(
                rng.random(n) < 0.3, 0,
                1 + _zipf_choice(rng, len(title_pool) - 1, n))],
            "Referer": referer_ids[referer_pick],
            "ClientIP": (0x0A000000
                         + _zipf_choice(rng, max(n // 30, 10), n)),
            "IsRefresh": (rng.random(n) < 0.12).astype(np.int32),
            "DontCountHits": (rng.random(n) < 0.05).astype(np.int32),
            "IsLink": (rng.random(n) < 0.15).astype(np.int32),
            "IsDownload": (rng.random(n) < 0.03).astype(np.int32),
            "TraficSourceID": rng.choice(
                np.array([-1, 0, 1, 2, 3, 6], dtype=np.int32), size=n,
                p=[0.1, 0.35, 0.2, 0.15, 0.1, 0.1]),
            "URLHash": urlhash_pool[_zipf_choice(
                rng, len(urlhash_pool), n)],
            "RefererHash": refhash_pool[_zipf_choice(
                rng, len(refhash_pool), n)],
            "WindowClientWidth": rng.choice(
                np.array([0, 1024, 1280, 1366, 1920], dtype=np.int32),
                size=n),
            "WindowClientHeight": rng.choice(
                np.array([0, 600, 720, 768, 1080], dtype=np.int32),
                size=n),
        }

    def schema(self, table: str = "hits") -> dtypes.Schema:
        assert table == "hits"
        return HITS_SCHEMA


#: the SQL text of the two queries the programs below express
QUERIES = {
    "q33": ("select URL, count(*) as c from hits group by URL "
            "order by c desc, URL limit 10"),
    "q36": ("select URL, count(*) as pv from hits "
            "where CounterID = 62 "
            "and EventDate >= date '2013-07-01' "
            "and EventDate <= date '2013-07-31' "
            "and DontCountHits = 0 and IsRefresh = 0 and URL <> '' "
            "group by URL order by pv desc, URL limit 10"),
}


def _days(s: str) -> int:
    return int(np.datetime64(s, "D").astype(np.int32))


def q33_program() -> Program:
    """q33: select URL, count(*) as c from hits group by URL
    order by c desc, URL limit 10."""
    return Program((
        GroupByStep(("URL",), (AggSpec(Agg.COUNT_ALL, None, "c"),)),
        SortStep(("c", "URL"), (True, False), limit=10),
    ))


def q36_program() -> Program:
    """q36: the q33 grouping behind the site filter (CounterID = 62, July
    2013, DontCountHits = 0, IsRefresh = 0, URL <> '')."""
    return Program((
        FilterStep(Call(Op.EQ, Col("CounterID"), lit(62))),
        FilterStep(Call(Op.GE, Col("EventDate"),
                        Const(_days("2013-07-01"), dtypes.DATE))),
        FilterStep(Call(Op.LE, Col("EventDate"),
                        Const(_days("2013-07-31"), dtypes.DATE))),
        FilterStep(Call(Op.EQ, Col("DontCountHits"), lit(0))),
        FilterStep(Call(Op.EQ, Col("IsRefresh"), lit(0))),
        FilterStep(DictPredicate("URL", "ne", b"")),
        GroupByStep(("URL",), (AggSpec(Agg.COUNT_ALL, None, "pv"),)),
        SortStep(("pv", "URL"), (True, False), limit=10),
    ))


def _top_urls(ids: np.ndarray, dicts: DictionarySet) -> list:
    """(url bytes, count) of the 10 most frequent ids, ties by URL."""
    d = dicts["URL"]
    cnt = np.bincount(ids, minlength=len(d))
    hit = np.flatnonzero(cnt)
    rank = d.sort_rank()[hit]
    order = np.lexsort((rank, -cnt[hit]))[:10]
    return [(d.values[i], int(cnt[i])) for i in hit[order]]


def q33_q36_answers(data: ClickBenchData) -> dict[str, list]:
    """Vectorised numpy answers of q33 and q36, in the shape of the
    reference's ``reference_answers`` (a list of (URL bytes, count))."""
    h = data.hits
    site = ((h["CounterID"] == 62)
            & (h["EventDate"] >= _days("2013-07-01"))
            & (h["EventDate"] <= _days("2013-07-31"))
            & (h["DontCountHits"] == 0) & (h["IsRefresh"] == 0))
    empty = data.dicts["URL"].get(b"")
    if empty is not None:
        site &= h["URL"] != empty
    return {"q33": _top_urls(h["URL"], data.dicts),
            "q36": _top_urls(h["URL"][site], data.dicts)}
