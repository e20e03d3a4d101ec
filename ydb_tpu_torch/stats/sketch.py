"""Mergeable column sketches: count-min + HyperLogLog NDV, pure numpy.

The port's own copy of ``ydb_tpu/stats/sketch.py`` (device-free).

Reference: the statistics service aggregates per-shard count-min
sketches into table-level statistics for the cost-based optimizer
(ydb/core/statistics/aggregator; SURVEY.md §2.7). Both sketches here
are linear structures — count-min merges by elementwise table addition,
HLL by elementwise register max — so per-portion sketches fold into
per-shard then table-level stats in any order (associative AND
commutative; tests/test_stats.py asserts the algebra).

Hashing is splitmix64 over the column's 64-bit physical image (ints
reinterpreted, floats via their IEEE bits), vectorized; no Python-level
per-row work anywhere.

Error contracts (fixed seeds make these deterministic):
  * count-min: estimate >= true always; estimate <= true + e/width * N
    with probability 1 - exp(-depth) per query;
  * HLL: relative NDV error ~ 1.04 / sqrt(2**p) (p=12 -> ~1.6%).
"""

from __future__ import annotations

import numpy as np

_U = np.uint64


def _to_u64(values: np.ndarray) -> np.ndarray:
    """Reinterpret any physical column as uint64 hash input."""
    arr = np.asarray(values)
    if arr.dtype.kind == "f":
        # IEEE bits; normalize -0.0 so it hashes like 0.0
        a = arr.astype(np.float64)
        a = np.where(a == 0.0, 0.0, a)
        return a.view(_U)
    if arr.dtype.kind == "b":
        return arr.astype(_U)
    return arr.astype(np.int64).view(_U)


def _splitmix64(x: np.ndarray, seed: int) -> np.ndarray:
    x = x + _U((seed * 0x9E3779B97F4A7C15 + 0x9E3779B97F4A7C15)
               & 0xFFFFFFFFFFFFFFFF)
    x = (x ^ (x >> _U(30))) * _U(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> _U(27))) * _U(0x94D049BB133111EB)
    return x ^ (x >> _U(31))


class CountMinSketch:
    """Conservative frequency sketch: ``depth`` hash rows of ``width``
    int64 counters; point estimate = min over rows."""

    def __init__(self, width: int = 2048, depth: int = 4, seed: int = 0):
        self.width = int(width)
        self.depth = int(depth)
        self.seed = int(seed)
        self.table = np.zeros((self.depth, self.width), dtype=np.int64)
        self.total = 0

    def _rows(self, values: np.ndarray) -> np.ndarray:
        u = _to_u64(values)
        return np.stack([
            (_splitmix64(u, self.seed + d) % _U(self.width)).astype(
                np.int64)
            for d in range(self.depth)
        ])

    def add_many(self, values: np.ndarray,
                 validity: np.ndarray | None = None) -> None:
        arr = np.asarray(values)
        if validity is not None:
            arr = arr[np.asarray(validity, dtype=bool)]
        if arr.size == 0:
            return
        idx = self._rows(arr)
        for d in range(self.depth):
            np.add.at(self.table[d], idx[d], 1)
        self.total += int(arr.size)

    def estimate(self, value) -> int:
        idx = self._rows(np.asarray([value]))
        return int(min(self.table[d][idx[d][0]]
                       for d in range(self.depth)))

    def max_freq(self) -> int:
        """Upper bound on the most frequent value's count, without
        knowing the value: freq(v) <= table[d, h_d(v)] <= max of row d,
        for every depth d — so min over depths of the per-row max cell
        bounds the heaviest hitter. Tight under adversarial skew (the
        hot key dominates its cells); loose but small (~collision load)
        on uniform data. Feeds shuffle bucket sizing
        (parallel/shuffle.size_buckets)."""
        if self.total == 0:
            return 0
        return int(self.table.max(axis=1).min())

    def merge(self, other: "CountMinSketch") -> "CountMinSketch":
        """Associative/commutative fold (elementwise counter addition).
        Returns a NEW sketch; operands stay untouched."""
        if (self.width, self.depth, self.seed) != (
                other.width, other.depth, other.seed):
            raise ValueError("count-min parameter mismatch")
        out = CountMinSketch(self.width, self.depth, self.seed)
        out.table = self.table + other.table
        out.total = self.total + other.total
        return out

    def to_json(self) -> dict:
        return {"width": self.width, "depth": self.depth,
                "seed": self.seed, "total": self.total,
                "table": self.table.ravel().tolist()}

    @staticmethod
    def from_json(d: dict) -> "CountMinSketch":
        s = CountMinSketch(d["width"], d["depth"], d["seed"])
        s.total = d["total"]
        s.table = np.asarray(d["table"], dtype=np.int64).reshape(
            s.depth, s.width)
        return s


class HyperLogLog:
    """NDV estimator: 2**p uint8 registers over splitmix64 hashes."""

    def __init__(self, p: int = 12, seed: int = 0):
        self.p = int(p)
        self.seed = int(seed)
        self.m = 1 << self.p
        self.registers = np.zeros(self.m, dtype=np.uint8)

    def add_many(self, values: np.ndarray,
                 validity: np.ndarray | None = None) -> None:
        arr = np.asarray(values)
        if validity is not None:
            arr = arr[np.asarray(validity, dtype=bool)]
        if arr.size == 0:
            return
        h = _splitmix64(_to_u64(arr), self.seed)
        reg = (h >> _U(64 - self.p)).astype(np.int64)
        w = (h & _U((1 << (64 - self.p)) - 1)).astype(np.uint64)
        # rank = leading-zero count of the (64-p)-bit suffix + 1; the
        # suffix fits float64's 53-bit mantissa for p >= 11, so frexp
        # gives the exact bit length without a Python loop
        _mant, expo = np.frexp(w.astype(np.float64))
        rank = ((64 - self.p) - expo + 1).astype(np.uint8)
        rank = np.where(w == 0, np.uint8(64 - self.p + 1), rank)
        np.maximum.at(self.registers, reg, rank)

    def estimate(self) -> float:
        m = float(self.m)
        alpha = 0.7213 / (1.0 + 1.079 / m)
        inv = np.ldexp(1.0, -self.registers.astype(np.int64))
        e = alpha * m * m / float(inv.sum())
        zeros = int(np.count_nonzero(self.registers == 0))
        if e <= 2.5 * m and zeros:
            return m * float(np.log(m / zeros))  # linear counting
        return float(e)

    def merge(self, other: "HyperLogLog") -> "HyperLogLog":
        """Associative/commutative fold (elementwise register max)."""
        if (self.p, self.seed) != (other.p, other.seed):
            raise ValueError("hll parameter mismatch")
        out = HyperLogLog(self.p, self.seed)
        out.registers = np.maximum(self.registers, other.registers)
        return out

    def to_json(self) -> dict:
        return {"p": self.p, "seed": self.seed,
                "registers": self.registers.tolist()}

    @staticmethod
    def from_json(d: dict) -> "HyperLogLog":
        s = HyperLogLog(d["p"], d["seed"])
        s.registers = np.asarray(d["registers"], dtype=np.uint8)
        return s


class ColumnSketch:
    """One column's mergeable statistics bundle: NDV (HLL), frequency
    (count-min), row/null accounting and the physical value zone."""

    def __init__(self, p: int = 12, cm_width: int = 2048,
                 cm_depth: int = 4, seed: int = 0):
        self.hll = HyperLogLog(p, seed)
        self.cms = CountMinSketch(cm_width, cm_depth, seed)
        self.rows = 0
        self.nulls = 0
        self.vmin = None
        self.vmax = None

    def observe(self, values: np.ndarray,
                validity: np.ndarray | None = None) -> None:
        from ydb_tpu_torch.stats.zonemap import zone_of

        arr = np.asarray(values)
        self.rows += int(arr.size)
        vmin, vmax, nulls = zone_of(arr, validity)
        self.nulls += nulls
        if vmin is not None:
            self.vmin = vmin if self.vmin is None else min(self.vmin, vmin)
            self.vmax = vmax if self.vmax is None else max(self.vmax, vmax)
        self.hll.add_many(arr, validity)
        self.cms.add_many(arr, validity)

    @property
    def ndv(self) -> int:
        return max(int(round(self.hll.estimate())), 1) \
            if self.rows > self.nulls else 0

    @property
    def null_fraction(self) -> float:
        return self.nulls / self.rows if self.rows else 0.0

    @property
    def max_freq(self) -> int:
        """Heaviest-hitter bound (CountMinSketch.max_freq)."""
        return self.cms.max_freq()

    def merge(self, other: "ColumnSketch") -> "ColumnSketch":
        out = ColumnSketch()
        out.hll = self.hll.merge(other.hll)
        out.cms = self.cms.merge(other.cms)
        out.rows = self.rows + other.rows
        out.nulls = self.nulls + other.nulls
        mins = [v for v in (self.vmin, other.vmin) if v is not None]
        maxs = [v for v in (self.vmax, other.vmax) if v is not None]
        out.vmin = min(mins) if mins else None
        out.vmax = max(maxs) if maxs else None
        return out

    def to_json(self) -> dict:
        return {"hll": self.hll.to_json(), "cms": self.cms.to_json(),
                "rows": self.rows, "nulls": self.nulls,
                "vmin": self.vmin, "vmax": self.vmax}

    @staticmethod
    def from_json(d: dict) -> "ColumnSketch":
        s = ColumnSketch()
        s.hll = HyperLogLog.from_json(d["hll"])
        s.cms = CountMinSketch.from_json(d["cms"])
        s.rows = d["rows"]
        s.nulls = d["nulls"]
        s.vmin = d["vmin"]
        s.vmax = d["vmax"]
        return s
