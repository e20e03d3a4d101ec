# ydb-devmem: device-module — pure torch kernels: every body runs inside
# a compiled program, a join or a captured plan (the dispatch's working
# set, not resident buffers)
"""Device kernel primitives for SSA programs, in plain torch.

The counterpart of ``ydb_tpu/ssa/kernels.py`` (plain ``jnp`` that XLA
fuses there). Reference block operators:
  * masked elementwise ops with Arrow null semantics
    (arrow compute + ydb/library/arrow_kernels/operations.h)
  * ``compact`` — BlockCompress (mkql_block_compress.h): row compaction by
    stable-partition permutation, applied only at block boundaries
  * grouped aggregation — BlockCombineHashed (mkql_block_agg.cpp:1637):
    dense or sort-derived group ids + reductions with a *static* group
    capacity; rows that must not count carry the id ``num_groups``
  * ``sort_block`` / top-k — WideTopSort / BlockTop (mkql_block_top.cpp)

Every primitive keeps static shapes; "how many" results there are is a
0-d int32 tensor, never a shape, so no primitive waits for the device.

Translation notes against the JAX version:
  * torch has no ``lexsort``: ``_lexsort`` chains stable sorts from the
    least significant key; bool keys sort as uint8.
  * torch has no ``mode="drop"`` scatter: dead rows go to a spare slot
    ``num_groups`` that is sliced off.
  * integer ``//`` is ``torch.div(..., rounding_mode="floor")``; the
    reference's integer math runs with 64-bit types enabled, so every
    int64 stays int64 here too.
"""

from __future__ import annotations

import os

import torch

from ydb_tpu_torch.blocks.block import Column, TableBlock

# ---------------- null-propagating elementwise ----------------


def binop(fn, a: Column, b: Column) -> Column:
    return Column(fn(a.data, b.data), a.validity & b.validity)


def unop(fn, a: Column) -> Column:
    return Column(fn(a.data), a.validity)


def kleene_and(a: Column, b: Column) -> Column:
    data = a.data & b.data
    # false AND anything = false (valid); else valid iff both valid
    valid = (
        (~a.data & a.validity) | (~b.data & b.validity)
        | (a.validity & b.validity)
    )
    return Column(data, valid)


def kleene_or(a: Column, b: Column) -> Column:
    data = a.data | b.data
    valid = (
        (a.data & a.validity) | (b.data & b.validity)
        | (a.validity & b.validity)
    )
    return Column(data, valid)


def floordiv(a, b):
    """Floor division (Python/jnp ``//``) for tensors and ints alike."""
    return torch.div(a, b, rounding_mode="floor")


def safe_div(a: Column, b: Column, float_result: bool) -> Column:
    zero = b.data == 0
    denom = torch.where(zero, torch.ones_like(b.data), b.data)
    if float_result:
        data = a.data / denom
    else:
        data = _trunc_div(a.data, denom)
    return Column(data, a.validity & b.validity & ~zero)


def _trunc_div(a, b):
    """SQL integer division truncates toward zero (-7/2 = -3), unlike
    floor division (-7//2 = -4)."""
    q = floordiv(a, b)
    exact = a - q * b == 0
    neg = (a < 0) ^ (b < 0)
    return torch.where(~exact & neg, q + 1, q)


def trunc_mod(a, b):
    """SQL remainder takes the dividend's sign: -7 % 2 = -1."""
    return a - b * _trunc_div(a, b)


def pred_mask(col: Column) -> torch.Tensor:
    """Boolean predicate -> selection mask (NULL counts as False)."""
    return col.data & col.validity


def dict_gather(table: torch.Tensor, ids: Column) -> Column:
    """Lookup a plan-time table (dictionary mask/rank) by string ids."""
    safe = torch.clamp(ids.data, 0, table.shape[0] - 1).long()
    return Column(table[safe], ids.validity)


# ---------------- calendar (branchless civil-from-days) ----------------


def civil_from_days(days):
    """days since 1970-01-01 -> (year, month, day), vectorized int math."""
    z = days.to(torch.int64) + 719468
    era = floordiv(z, 146097)
    doe = z - era * 146097
    yoe = floordiv(doe - floordiv(doe, 1460) + floordiv(doe, 36524)
                   - floordiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + floordiv(yoe, 4) - floordiv(yoe, 100))
    mp = floordiv(5 * doy + 2, 153)
    d = doy - floordiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def days_from_civil(y, m, d):
    """(year, month, day) -> days since 1970-01-01 (inverse of
    civil_from_days; Hinnant's algorithm, vectorized)."""
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = floordiv(y, 400)
    yoe = y - era * 400
    doy = floordiv(153 * torch.where(m > 2, m - 3, m + 9) + 2, 5) + d - 1
    doe = yoe * 365 + floordiv(yoe, 4) - floordiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


# ---------------- sorting helpers ----------------


def _sortable(k: torch.Tensor) -> torch.Tensor:
    # bool keys sort as uint8 (bool sorts are not supported everywhere)
    return k.to(torch.uint8) if k.dtype == torch.bool else k


def _lexsort(keys) -> torch.Tensor:
    """``jnp.lexsort``: the LAST key is primary. Chains stable sorts from
    the least significant key, so ties keep their original order."""
    perm = None
    for k in keys:
        k = _sortable(k)
        if perm is None:
            perm = torch.argsort(k, stable=True)
        else:
            perm = perm[torch.argsort(k[perm], stable=True)]
    return perm


# ---------------- filter / compact ----------------


def compact(block: TableBlock, selected: torch.Tensor) -> TableBlock:
    """Move selected live rows to the front (stable), update length.

    selected: bool[capacity]; rows outside the live range must be False
    (callers AND with block.row_mask()).
    """
    keep = selected & block.row_mask()
    # stable partition: sort by (not kept); ties keep original order
    perm = torch.argsort((~keep).to(torch.uint8), stable=True)
    keep_p = keep[perm]
    cols = {
        n: Column(c.data[perm], c.validity[perm] & keep_p)
        for n, c in block.columns.items()
    }
    n = keep.sum().to(torch.int32)
    return TableBlock(cols, n, block.schema)


# ---------------- grouped aggregation ----------------


def group_ids_dense(keys: list[Column], bounds: list[int],
                    live: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Dense group ids from small-cardinality keys (dict ids / bounded ints).

    NULL key values get their own slot per key (SQL GROUP BY semantics), so
    each key contributes (bound + 1) values; id 0 means NULL.
    Rows not live get id = num_groups (the spare slot).
    """
    num_groups = 1
    gid = torch.zeros(keys[0].data.shape, dtype=torch.int32,
                      device=keys[0].data.device)
    for k, b in zip(keys, bounds):
        enc = torch.where(k.validity, k.data.to(torch.int32) + 1, 0)
        gid = gid * (b + 1) + enc
        num_groups *= b + 1
    gid = torch.where(live, gid, num_groups).to(torch.int32)
    return gid, num_groups


def group_ids_sorted(keys: list[Column], live: torch.Tensor,
                     max_groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Generic exact group ids via lexicographic sort (no hash table).

    Returns (gid[capacity] int32 with dead rows = max_groups, n_groups
    0-d int32). Group ids follow sorted key order, so per-group outputs
    come out key-ordered.
    """
    # sort dead rows last; NULLs first within a key (stable choice)
    sort_keys = []
    for k in reversed(keys):
        sort_keys.append(k.data)
        sort_keys.append(~k.validity)
    sort_keys.append(~live)
    perm = _lexsort(sort_keys)  # last key is primary
    # invert the permutation with one linear scatter (not a second sort)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype,
                             device=perm.device)

    live_s = live[perm]
    # row 0 always starts a group (a mask, not ``changed[0] = True``: that
    # copies a host scalar to the device, which a CUDA graph forbids)
    changed = torch.arange(live.shape[0], device=live.device) == 0
    for k in keys:
        d, v = k.data[perm], k.validity[perm]
        # normalize garbage under NULL slots so all NULLs form one group
        d = torch.where(v, d, torch.zeros_like(d))
        diff = (d != torch.roll(d, 1)) | (v != torch.roll(v, 1))
        changed = changed | diff
    # boundaries only count within the live prefix
    boundary = changed & live_s
    seg_sorted = torch.cumsum(boundary.to(torch.int32), 0,
                              dtype=torch.int32) - 1
    n_groups = torch.clamp(
        torch.amax(torch.where(live_s, seg_sorted, -1)) + 1, min=0)
    seg_sorted = torch.where(live_s, seg_sorted, max_groups)
    gid = seg_sorted[inv].to(torch.int32)
    return gid, n_groups.to(torch.int32)


#: Below this many groups the one-hot masked reduction runs (the
#: reference's small-key fast path); above it the scatter / CUDA-kernel
#: tier. Identical to the JAX package so tier choices match.
ONEHOT_GROUP_LIMIT = 512

#: test/bench override for the fused multi-aggregate group-by lowering
#: (compiler._resolve_group_by): True/False forces the decision
#: regardless of the environment. Consulted when a program runs.
FUSED_FORCE: bool | None = None


def fused_group_by_enabled() -> bool:
    """Whether GroupByStep lowers through the fused single-contraction
    path (one shared hit matrix + one contraction per accumulator dtype)
    instead of one independent reduction per aggregate. Default on;
    YDB_TPU_FUSED_GROUPBY=0 restores the per-aggregate path."""
    if FUSED_FORCE is not None:
        return FUSED_FORCE
    return os.environ.get("YDB_TPU_FUSED_GROUPBY", "1") not in (
        "0", "", "off")


def group_hits(gid: torch.Tensor, num_groups: int) -> torch.Tensor:
    """bool (rows x groups) one-hot hit matrix from spare-slot group ids
    (dead/invalid rows carry gid >= num_groups and match no group)."""
    groups = torch.arange(num_groups, dtype=torch.int32, device=gid.device)
    return gid[:, None] == groups[None, :]


def first_live_index(hits: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-group first hit row: (index int64[groups], found bool[groups]).

    Empty groups report index 0 with found=False; callers gather with
    the clamped index and mask by ``found``."""
    n = hits.shape[0]
    rows = torch.arange(n, dtype=torch.int32, device=hits.device)
    first = torch.amin(torch.where(hits, rows[:, None], n), dim=0)
    found = first < n
    return torch.clamp(first, max=max(n - 1, 0)).long(), found


def _drop_index(gid: torch.Tensor, num_groups: int) -> torch.Tensor:
    """int64 scatter index: ids outside [0, num_groups) -> spare slot."""
    ok = (gid >= 0) & (gid < num_groups)
    return torch.where(ok, gid, num_groups).long()


def scatter_add_drop(values: torch.Tensor, gid: torch.Tensor,
                     num_groups: int) -> torch.Tensor:
    """``zeros.at[gid].add(values, mode="drop")``: per-group sums of rows
    (or row vectors) with out-of-range ids dropped via a spare slot."""
    out = torch.zeros((num_groups + 1,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    out.index_add_(0, _drop_index(gid, num_groups), values)
    return out[:num_groups]


def fused_group_reduce(stacked: torch.Tensor, gid: torch.Tensor,
                       num_groups: int, dtype=None) -> torch.Tensor:
    """All linear aggregates in one contraction: (rows x slots) stacked
    inputs -> (groups x slots) per-group sums.

    ``stacked`` columns are pre-masked (invalid contributions already
    zero); ``gid`` carries dead rows as >= num_groups. Tiers:

      * groups <= ONEHOT_GROUP_LIMIT — one dense contraction
        ``hits.T @ stacked`` (exact for ints through the limb encoder;
        from 2^29 rows on, where limbs stop being exact, integers take
        the 2-D scatter-add).
      * larger, kernel-eligible dtype — the hand-written CUDA kernel
        ``cuda_kernels.grouped_sum_multi`` (its plain version on CPU
        tensors).
      * otherwise — one 2D scatter-add.
    """
    dtype = dtype or stacked.dtype
    stacked = stacked.to(dtype)
    if num_groups <= ONEHOT_GROUP_LIMIT:
        if stacked.shape[0] < _INT_LIMB_MAX_ROWS:
            return fused_group_reduce_banks(
                {dtype: stacked}, gid, num_groups)[dtype]
        if not (stacked.is_floating_point() or dtype == torch.bool):
            # the reference contracts integers in integer dtype here;
            # CUDA has no integer matmul, so integers take the exact
            # int 2-D scatter-add (the large-group tier's fallback)
            return scatter_add_drop(stacked, gid, num_groups)
        hits = group_hits(gid, num_groups).to(dtype)
        return hits.T @ stacked
    from ydb_tpu_torch.ssa import cuda_kernels

    if cuda_kernels.enabled() and cuda_kernels.supported_fused(
            dtype, num_groups, stacked.shape[1]):
        return cuda_kernels.grouped_sum_multi(stacked, gid, num_groups)
    return scatter_add_drop(stacked, gid, num_groups)


#: 24-bit-limb exactness bound: each limb column sums < 2^24 * rows, so
#: rows below this keep every limb sum inside f64's 2^53 integer range.
_INT_LIMB_MAX_ROWS = 1 << 29
#: up to here TWO 32-bit limbs suffice ((2^32-1) * 2^21 < 2^53)
_INT_LIMB2_MAX_ROWS = 1 << 21


def fused_group_reduce_banks(banks: dict, gid: torch.Tensor,
                             num_groups: int) -> dict:
    """All of a GroupByStep's linear banks in ONE contraction.

    ``banks`` maps accumulator dtype -> (rows x slots) pre-masked
    values. In the one-hot tier every bank encodes into a single f64
    matrix — float banks as-is, integer banks as 32- or 24-bit limb
    columns (each limb sum stays an exact f64 integer, so the recombined
    int64 is bit-exact whatever the summation order) — and contracts
    against ONE f64 hit matrix. The large-group tier reduces each bank
    via fused_group_reduce (CUDA kernel / 2D scatter).
    """
    rows = next(iter(banks.values())).shape[0] if banks else 0
    if num_groups > ONEHOT_GROUP_LIMIT or rows >= _INT_LIMB_MAX_ROWS:
        return {dt: fused_group_reduce(st, gid, num_groups, dtype=dt)
                for dt, st in banks.items()}
    if rows <= _INT_LIMB2_MAX_ROWS:
        shifts, mask = (0, 32), 0xFFFFFFFF
    else:
        shifts, mask = (0, 24, 48), 0xFFFFFF
    enc = []
    plan = []
    for dt, st in banks.items():
        n_slots = st.shape[1]
        if not (dt.is_floating_point or dt == torch.bool):
            v = st.to(torch.int64)
            for s in shifts[:-1]:
                enc.append(((v >> s) & mask).to(torch.float64))
            enc.append((v >> shifts[-1]).to(torch.float64))
            plan.append((dt, n_slots, True))
        else:
            enc.append(st.to(torch.float64))
            plan.append((dt, n_slots, False))
    mat = torch.cat(enc, dim=1) if len(enc) > 1 else enc[0]
    hits = group_hits(gid, num_groups).to(torch.float64)
    res = hits.T @ mat
    out = {}
    off = 0
    for dt, n_slots, is_int in plan:
        if is_int:
            tot = torch.zeros((num_groups, n_slots), dtype=torch.int64,
                              device=res.device)
            for s in shifts:
                tot = tot + (res[:, off:off + n_slots].to(torch.int64) << s)
                off += n_slots
            out[dt] = tot.to(dt)
        else:
            out[dt] = res[:, off:off + n_slots].to(dt)
            off += n_slots
    return out


def _onehot_hits(valid_row, gid, num_groups: int):
    return group_hits(gid, num_groups) & valid_row[:, None]


def _onehot_reduce(values, valid_row, gid, num_groups: int, fill,
                   reduce_fn):
    """Masked (rows x groups) reduction — the shared one-hot fast path."""
    hit = _onehot_hits(valid_row, gid, num_groups)
    vals = torch.where(hit, values[:, None], fill)
    return reduce_fn(vals, dim=0)


def scatter_first(values: torch.Tensor, valid_row, gid, num_groups: int):
    """Per-group 'some' value: any valid row's value wins."""
    if num_groups <= ONEHOT_GROUP_LIMIT and values.ndim == 1:
        n = values.shape[0]
        rows = torch.arange(n, dtype=torch.int32, device=values.device)
        hit = _onehot_hits(valid_row, gid, num_groups)
        first = torch.amin(torch.where(hit, rows[:, None], n), dim=0)
        picked = values[torch.clamp(first, max=n - 1).long()]
        return torch.where(first < n, picked, torch.zeros_like(picked))
    idx = _drop_index(torch.where(valid_row, gid, num_groups), num_groups)
    out = torch.zeros((num_groups + 1,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    out[idx] = values
    return out[:num_groups]


def scatter_sum(values, valid_row, gid, num_groups: int, dtype=None):
    dtype = dtype or values.dtype
    if num_groups <= ONEHOT_GROUP_LIMIT:
        # like jnp.sum, torch.sum widens integer sums to int64
        return _onehot_reduce(values.to(dtype), valid_row, gid,
                              num_groups, 0, torch.sum)
    # larger group counts: the CUDA kernel when eligible
    # (ydb_tpu_torch/ssa/cuda_kernels.py), else the scatter
    from ydb_tpu_torch.ssa import cuda_kernels

    if cuda_kernels.enabled() and cuda_kernels.supported(dtype, num_groups):
        return cuda_kernels.scatter_sum_kernel(
            values, valid_row, gid, num_groups, dtype)
    idx = torch.where(valid_row, gid, num_groups)
    return scatter_add_drop(values.to(dtype), idx, num_groups)


def _scatter_extreme(values, valid_row, gid, num_groups, init, reduce):
    idx = _drop_index(torch.where(valid_row, gid, num_groups), num_groups)
    out = torch.full((num_groups + 1,), init, dtype=values.dtype,
                     device=values.device)
    out.scatter_reduce_(0, idx, values, reduce=reduce, include_self=True)
    return out[:num_groups]


def scatter_min(values, valid_row, gid, num_groups: int):
    init = _extreme(values.dtype, maximum=True)
    if num_groups <= ONEHOT_GROUP_LIMIT:
        return _onehot_reduce(values, valid_row, gid, num_groups, init,
                              torch.amin)
    return _scatter_extreme(values, valid_row, gid, num_groups, init, "amin")


def scatter_max(values, valid_row, gid, num_groups: int):
    init = _extreme(values.dtype, maximum=False)
    if num_groups <= ONEHOT_GROUP_LIMIT:
        return _onehot_reduce(values, valid_row, gid, num_groups, init,
                              torch.amax)
    return _scatter_extreme(values, valid_row, gid, num_groups, init, "amax")


def _extreme(dtype: torch.dtype, maximum: bool):
    if dtype.is_floating_point:
        return float("inf") if maximum else float("-inf")
    if dtype == torch.bool:
        return maximum
    info = torch.iinfo(dtype)
    return info.max if maximum else info.min


# ---------------- sort / top-k ----------------


def sort_perm(keys: list[Column], descending: list[bool],
              live: torch.Tensor) -> torch.Tensor:
    """Stable multi-key sort permutation; dead rows sink to the end.

    Descending numeric keys negate via bitwise complement on ints (exact,
    overflow-free) and negation on floats; NULLS LAST within each key.
    """
    sort_keys = []
    for k, desc in zip(reversed(keys), reversed(descending)):
        d = k.data
        if desc:
            d = -d if d.is_floating_point() else ~d
        # NULLs last regardless of direction; the null flag is appended
        # after the data key so it is more significant in the lexsort
        sort_keys.append(d)
        sort_keys.append(~k.validity)
    sort_keys.append(~live)
    return _lexsort(sort_keys)


def sort_block(block: TableBlock, keys: list[str], descending: list[bool],
               limit: int | None = None,
               live: torch.Tensor | None = None) -> TableBlock:
    """Sort live (optionally pre-masked) rows; one lexsort pass does both
    the selection compaction (non-live rows sink) and the ordering."""
    if live is None:
        live = block.row_mask()
    else:
        live = live & block.row_mask()
    perm = sort_perm([block.columns[k] for k in keys], descending, live)
    live_p = live[perm]
    length = live.sum().to(torch.int32)
    if limit is not None:
        length = torch.clamp(length, max=limit)
    # zero validity past the length so padding never leaks
    cut = torch.arange(block.capacity, dtype=torch.int32,
                       device=live.device) < length
    cols = {
        n: Column(c.data[perm], c.validity[perm] & live_p & cut)
        for n, c in block.columns.items()
    }
    return TableBlock(cols, length, block.schema)
