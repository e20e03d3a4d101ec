"""Device equi-join kernels, in plain torch.

The counterpart of ``ydb_tpu/ssa/join.py``. The reference joins rows
with hash tables (GraceJoin partitioned hash join mkql_grace_join.cpp:558,
MapJoin broadcast mkql_map_join.cpp); both packages join by sorting
instead, with static shapes:

  * ``lookup_join`` — N:1 join (probe side may repeat keys; build keys
    unique, e.g. any FK -> PK join): sort build by key once, then
    ``searchsorted`` + gather per probe row. Output shape == probe shape;
    a found-mask drives inner/left/semi/anti variants.
  * ``expand_join`` — N:M join via prefix-sum expansion into a static
    output capacity: per-probe match counts -> cumulative offsets ->
    each output slot maps back to (probe row, k-th match) with two
    searchsorted passes. Exact while total matches <= out capacity; the
    returned total lets callers detect overflow and re-run with a larger
    capacity.

Translation notes against the JAX version: ``jnp.lexsort`` becomes the
chained stable sorts of ``kernels._lexsort``; ``searchsorted(side=
"right")`` becomes ``right=True`` over a contiguous sorted input; every
index stays int64.
"""

from __future__ import annotations

import torch

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.analysis import memsan
from ydb_tpu_torch.blocks.block import Column, TableBlock
from ydb_tpu_torch.ssa import kernels

# the join entry points run under memsan.seam(): their tensors are
# the dispatch's working set, the reference's XLA temporaries


def _key_i64(cols: list[Column]) -> torch.Tensor:
    """Combine key columns into one int64 per row, exactly.

    One column passes through; two int columns pack as (a << 32) | b —
    exact while both values fit in 32 bits (all TPC-H/ClickBench composite
    keys do, e.g. partsupp's (partkey, suppkey)). Wider composites need a
    pre-assigned join-key column (planner's job), not a lossy hash.
    Liveness / NULL handling lives entirely in _join_keys_live.
    """
    if len(cols) == 1:
        return cols[0].data.to(torch.int64)
    if len(cols) == 2:
        a = cols[0].data.to(torch.int64)
        b = cols[1].data.to(torch.int64)
        return (a << 32) | (b & 0xFFFFFFFF)
    raise NotImplementedError(
        ">2 join key columns: pre-pack a composite key column"
    )


def _sorted_build(bk: torch.Tensor, blive: torch.Tensor):
    """Sort build keys with dead rows last, WITHOUT a value sentinel
    (sentinels collide with legitimate INT64_MAX keys).

    Returns (order, bk_sorted, n_live): live keys sorted in the prefix
    [0, n_live); suffix positions are overwritten with the prefix's last
    value so the whole array stays sorted for searchsorted. Matches are
    validated against idx < n_live, so suffix duplicates never count.
    """
    # primary: liveness (live first), then key
    order = kernels._lexsort((bk, ~blive))
    bk_sorted = bk[order]
    n_live = blive.sum().to(torch.int32)
    cap = bk.shape[0]
    # a one-element gather, not bk_sorted[0-d tensor]: indexing with a
    # 0-d tensor may read the index back to the host, which a CUDA graph
    # capture forbids
    last_live = bk_sorted.index_select(
        0, torch.clamp(n_live - 1, min=0).long().reshape(1))
    pos = torch.arange(cap, dtype=torch.int32, device=bk.device)
    bk_sorted = torch.where(pos < n_live, bk_sorted, last_live).contiguous()
    return order, bk_sorted, n_live


def _join_keys_live(block: TableBlock, keys: list[str]) -> tuple:
    cols = [block.columns[k] for k in keys]
    live = block.row_mask()
    for c in cols:
        live = live & c.validity  # NULL keys drop out of equi-joins
    return _key_i64(cols), live


@memsan.computing
def lookup_join(
    probe: TableBlock,
    build: TableBlock,
    probe_keys: list[str],
    build_keys: list[str],
    payload: list[str],
    suffix: str = "",
    null_extended: bool = False,
) -> tuple[TableBlock, torch.Tensor]:
    """N:1 equi-join: gather ``payload`` columns from build into probe.

    Returns (probe + payload columns, found_mask). Build keys must be
    unique among live rows (duplicate keys: one match wins). Inner join =
    compact by found; left join = keep all, payload validity = found.
    """
    pk, plive = _join_keys_live(probe, probe_keys)
    bk, blive = _join_keys_live(build, build_keys)

    order, bk_sorted, n_live = _sorted_build(bk, blive)
    idx = torch.searchsorted(bk_sorted, pk)
    idx = torch.clamp(idx, 0, bk_sorted.shape[0] - 1)
    found = (idx < n_live) & (bk_sorted[idx] == pk) & plive
    src = order[idx]

    if len(set(payload)) != len(payload):
        raise ValueError(f"duplicate payload columns {payload}")
    out_cols = dict(probe.columns)
    sch = probe.schema
    for name in payload:
        c = build.columns[name]
        out_name = name + suffix
        if out_name in probe.columns:
            # a silent overwrite would leave the schema typed as the probe
            # column while the data came from the build side
            raise ValueError(
                f"payload column {out_name!r} collides with a probe column;"
                " pass a suffix"
            )
        out_cols[out_name] = Column(c.data[src], c.validity[src] & found)
        f = build.schema.field(name)
        # a LEFT join NULL-extends unmatched rows, so its payload is
        # nullable no matter what the build side declares
        sch = sch.with_field(
            dtypes.Field(out_name, f.type, f.nullable or null_extended))
    return TableBlock(out_cols, probe.length, sch), found


@memsan.computing
def run_equi_join(
    probe: TableBlock,
    build: TableBlock,
    probe_keys,
    build_keys,
    kind: str = "inner",
    suffix: str = "",
    expand: bool = False,
    payload=(),
    probe_payload=(),
    build_payload=(),
) -> TableBlock:
    """One entry point for every equi-join shape.

    Lookup (N:1) joins support inner/left/semi/anti; expand (N:M) joins
    support inner/left and size their output from the match count (the
    ``int(total)`` read is the one deliberate wait for the device). The
    reference first guesses probe capacity × ``fanout_hint`` and retries
    exactly on overflow; along a chain of expand joins each guess starts
    from the last one's padded capacity, so the guesses compound (4x per
    join, whatever the matches), while an exact size equals the retry's
    and needs one pass (``tests/test_torch_join.py``,
    ``test_chained_expand_joins_size_exactly``).
    """
    if not expand:
        joined, found = lookup_join(
            probe, build, list(probe_keys), list(build_keys),
            list(payload), suffix, null_extended=(kind == "left"))
        if kind == "inner":
            return kernels.compact(joined, found)
        if kind == "left":
            return joined
        if kind == "semi":
            return kernels.compact(probe, found)
        if kind == "anti":
            return kernels.compact(probe, ~found & probe.row_mask())
        raise ValueError(kind)
    if kind not in ("inner", "left"):
        # expand_join silently computes INNER for anything else
        raise ValueError(f"expand join does not support kind {kind!r}")
    counted = _expand_counts(probe, build, list(probe_keys),
                             list(build_keys), kind)
    cap = max(int(counted[-1] + 1023) // 1024 * 1024, 1024)
    return _expand_emit(probe, build, counted, list(probe_payload),
                        list(build_payload), cap, suffix, kind)


@memsan.computing
def expand_join(
    probe: TableBlock,
    build: TableBlock,
    probe_keys: list[str],
    build_keys: list[str],
    probe_payload: list[str],
    build_payload: list[str],
    out_capacity: int,
    build_suffix: str = "",
    kind: str = "inner",
) -> tuple[TableBlock, torch.Tensor]:
    """N:M equi-join with static output capacity.

    ``kind``: "inner" emits matches only; "left" additionally emits every
    unmatched live probe row once with NULL build payload (LEFT OUTER).
    Returns (joined block, total rows). Rows beyond ``out_capacity``
    are truncated — callers check ``total <= out_capacity`` (host
    side) and retry bigger if exceeded.
    """
    counted = _expand_counts(probe, build, probe_keys, build_keys, kind)
    return (_expand_emit(probe, build, counted, probe_payload,
                         build_payload, out_capacity, build_suffix, kind),
            counted[-1])


def _expand_counts(probe, build, probe_keys, build_keys, kind):
    """An expand join's match plan: the build order, each probe row's
    first match and match count, emitted rows per probe row, their
    inclusive offsets, and the total (a 0-d tensor, last)."""
    pk, plive = _join_keys_live(probe, probe_keys)
    bk, blive = _join_keys_live(build, build_keys)
    # LEFT JOIN keeps probe rows whose key is NULL too (they just match
    # nothing): row liveness for emission is the block mask, while
    # _join_keys_live's plive already excludes NULL keys from matching
    row_live = probe.row_mask()
    dev = pk.device

    order, bk_sorted, n_live = _sorted_build(bk, blive)
    lo = torch.searchsorted(bk_sorted, pk)
    hi = torch.searchsorted(bk_sorted, pk, right=True)
    # the suffix repeats the last live key: clamp ranges to the live prefix
    lo = torch.minimum(lo, n_live.to(lo.dtype))
    hi = torch.minimum(hi, n_live.to(hi.dtype))
    # int64 accounting: skewed keys can exceed 2^31 matches, and a wrapped
    # total would defeat the overflow-retry protocol
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    matches = torch.where(plive, hi - lo, zero)
    if kind == "left":
        counts = torch.where(row_live, torch.clamp(matches, min=1), zero)
    else:
        counts = matches
    offsets = torch.cumsum(counts, 0)  # inclusive
    total = offsets[-1] if counts.shape[0] else zero
    return order, lo, matches, counts, offsets, total


def _expand_emit(probe, build, counted, probe_payload, build_payload,
                 out_capacity: int, build_suffix: str,
                 kind: str) -> TableBlock:
    """The joined block of ``out_capacity`` rows from an expand plan
    (``_expand_counts``); rows past the capacity are cut."""
    order, lo, matches, counts, offsets, total = counted
    dev = offsets.device
    starts = offsets - counts

    # map each output slot j to (probe row i, k-th match)
    j = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    i = torch.searchsorted(offsets, j, right=True)
    i = torch.clamp(i, 0, probe.capacity - 1)
    valid_out = j < torch.clamp(total, max=out_capacity)
    k = j - starts[i]
    # matched: this output slot carries a real build match (a left join's
    # pad slot for an unmatched probe row has k == 0 == matches[i])
    matched = valid_out & (k < matches[i])
    b_src = order[torch.clamp(lo[i] + k, 0, build.capacity - 1)]

    cols: dict[str, Column] = {}
    fields = []
    for name in probe_payload:
        c = probe.columns[name]
        cols[name] = Column(c.data[i], c.validity[i] & valid_out)
        fields.append(probe.schema.field(name))
    for name in build_payload:
        c = build.columns[name]
        out_name = name + build_suffix
        cols[out_name] = Column(c.data[b_src], c.validity[b_src] & matched)
        f = build.schema.field(name)
        fields.append(dtypes.Field(
            out_name, f.type, f.nullable or kind == "left"))
    length = torch.clamp(total, max=out_capacity).to(torch.int32)
    return TableBlock(cols, length, dtypes.Schema(tuple(fields)))
