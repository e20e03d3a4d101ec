# ydb-devmem: device-module — the shuffle's send buffers and received
# blocks are one exchange's working set, not resident buffers
"""Hash-partition shuffle over the shard mesh: the DQ repartitioning
channel.

The counterpart of ``ydb_tpu/parallel/shuffle.py``. Reference: rows
route to output partitions by key hash between stages
(TDqOutputHashPartitionConsumer, dq_output_consumer.cpp:105; vectorized
block path :338). Here each shard buckets its rows by destination shard
and the buckets exchange with ``mesh.all_to_all`` — the collective shape
of MoE expert dispatch (SURVEY.md §2.11).

The exchange ships a fixed-capacity bucket to every peer, as the
reference's static shapes do. Full local capacity is always enough —
worst case all local rows hash to one shard — but ships n_shards ×
capacity rows per exchange; ``size_buckets`` instead sizes the bucket
from column statistics (mean destination load × safety margin + the
count-min heaviest-hitter bound, rounded to a plan_fuse shape class).
Undersized buckets cannot corrupt results: ``repartition`` returns the
worst per-destination count over the mesh, the caller compares it with
the bucket and grows-and-re-exchanges on overflow (the grace-join
respill protocol). ``YDB_TPU_TORCH_SHUFFLE_STATS=0`` restores
full-capacity buckets. After the exchange each shard owns exactly the
rows whose key hash maps to it — the precondition for partitioned
(grace-style) joins and re-keyed aggregation.

The device ``hash_rows`` gives the reference's bits (and
``ydb_tpu_torch.native.hash_rows``'s) on int64 tensors: torch's ``>>``
on int64 is arithmetic and uint64 is only partly supported on CUDA, so
the logical shifts are masked, the multiplies rely on int64's wrapping
product, and the unsigned ``% n_shards`` is taken on the hash's top 63
bits and its low bit.
"""

from __future__ import annotations

import os

import torch

from ydb_tpu_torch.blocks.block import Column, TableBlock
from ydb_tpu_torch.parallel import mesh as meshlib
from ydb_tpu_torch.ssa import kernels

#: in-process override for stats-sized buckets (bench A/B seam); None
#: defers to the YDB_TPU_TORCH_SHUFFLE_STATS environment gate
SHUFFLE_STATS_FORCE: "bool | None" = None

#: headroom over the mean per-destination load: absorbs ordinary hash
#: imbalance without a grow-and-re-exchange; measured skew beyond it
#: still corrects itself through the overflow protocol
SAFETY_MARGIN = 1.5


def shuffle_stats_enabled() -> bool:
    if SHUFFLE_STATS_FORCE is not None:
        return SHUFFLE_STATS_FORCE
    return os.environ.get("YDB_TPU_TORCH_SHUFFLE_STATS", "1") not in (
        "0", "", "off")


def size_buckets(local_rows: int, n_shards: int, heavy: int = 0,
                 margin: float = SAFETY_MARGIN) -> int:
    """Stats-sized per-destination send bucket for ``repartition``.

    Uniform keys spread ``local_rows`` evenly over ``n_shards``
    destinations, so the bucket holds mean × margin; a heavy hitter can
    pile its whole frequency onto one destination, so the estimate adds
    ``heavy`` (the table-wide count-min bound — every local occurrence
    routes to the same shard in the worst case). Rounded UP to a
    plan_fuse shape class and clamped to the always-sufficient full
    capacity. Stats off (or a degenerate 1-shard mesh) keeps full
    capacity."""
    from ydb_tpu_torch.ssa.plan_fuse import shape_class

    full = max(int(local_rows), 1)
    if n_shards <= 1 or not shuffle_stats_enabled():
        return full
    mean = -(-full // n_shards)
    est = int(mean * margin) + max(int(heavy), 0)
    return min(full, shape_class(est))


def row_bytes(schema) -> int:
    """Physical bytes one row ships in an exchange: column payloads
    plus one validity byte per column (host-side accounting helper)."""
    return sum(f.type.physical.itemsize + 1 for f in schema.fields)


def exchange_bytes_per_device(schema, n_shards: int,
                              bucket_rows: int) -> int:
    """Bytes ONE shard sends in one ``repartition`` exchange: a
    fixed-capacity bucket to every peer (the shape of the all_to_all,
    not the live row count). Callers feed this to
    ``timeline.add_bytes("shuffle_bytes_dev<i>", ...)``."""
    return int(n_shards) * int(bucket_rows) * row_bytes(schema)


def heavy_bound(stats, keys) -> int:
    """Heaviest joint-key frequency bound from aggregator statistics.

    Each key column's bound is the max matching ``ColumnStats.heavy``
    across tables (join keys may appear under the same name on both
    sides; the max stays conservative). A composite key occurs at most
    as often as its rarest component, so the joint bound is the min
    over per-key bounds. Unknown columns contribute nothing (0 = no
    bound)."""
    if not stats:
        return 0
    per_key = []
    for k in keys:
        best = 0
        for ts in stats.values():
            cs = getattr(ts, "columns", {}).get(k)
            if cs is not None:
                best = max(best, int(getattr(cs, "heavy", 0)))
        if best:
            per_key.append(best)
    return min(per_key) if per_key else 0


def _signed(u: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


# splitmix64-style avalanche constants, as int64 bit patterns
_SEED = _signed(0x9E3779B97F4A7C15)
_C1 = _signed(0xBF58476D1CE4E5B9)
_C2 = _signed(0x94D049BB133111EB)
_TOP = -(1 << 63)  # the sign bit alone


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical shift right of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def hash_rows(cols: list[Column]) -> torch.Tensor:
    """Vectorized 64-bit row hash over key columns: int64 tensors
    holding the uint64 bits of the reference's ``hash_rows``."""
    h = torch.full(cols[0].data.shape, _SEED, dtype=torch.int64,
                   device=cols[0].data.device)
    for c in cols:
        k = c.data.to(torch.int64)
        # null keys hash as a distinct class via the validity bit
        x = h ^ torch.where(c.validity, k ^ _TOP, k)
        x = (x ^ _lsr(x, 30)) * _C1
        x = (x ^ _lsr(x, 27)) * _C2
        h = x ^ _lsr(x, 31)
    return h


def dest_shard(h: torch.Tensor, n_shards: int) -> torch.Tensor:
    """``uint64(h) % n_shards`` as int32, for int64 bit patterns ``h``:
    uint64(h) = 2 * (h >>> 1) + (h & 1)."""
    hi = torch.remainder(_lsr(h, 1), n_shards)
    return torch.remainder(2 * hi + (h & 1), n_shards).to(torch.int32)


def _bucket(block: TableBlock, key_names: list[str], n_shards: int,
            B: int):
    """The send side of one shard: every live row's destination, rows
    scattered into (n_shards, B) send buffers per column (overflow and
    dead rows drop), and the per-destination counts (n_shards + 1: the
    last is the dead rows' bucket)."""
    cap = block.capacity
    dev = block.device
    live = block.row_mask()
    h = hash_rows([block.columns[k] for k in key_names])
    dest = dest_shard(h, n_shards)
    dest = torch.where(live, dest, n_shards)  # dead rows -> drop bucket
    # stable-sort rows by destination => contiguous buckets
    order = torch.argsort(dest, stable=True)
    dest_s = dest[order].long()
    counts = torch.bincount(dest_s, minlength=n_shards + 1).to(torch.int32)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_bucket = (torch.arange(cap, dtype=torch.int32, device=dev)
                     - starts[dest_s])
    # scatter into (n_shards, B) send buffers; overflow/dead rows drop
    slot = torch.where((dest_s < n_shards) & (pos_in_bucket < B),
                       dest_s * B + pos_in_bucket.long(),
                       n_shards * B)
    bufs = {}
    for n, c in block.columns.items():
        for part, x in (("d", c.data), ("v", c.validity)):
            buf = torch.zeros(n_shards * B + 1, dtype=x.dtype, device=dev)
            buf[slot] = x[order]
            bufs[(n, part)] = buf[:-1].reshape(n_shards, B)
    return bufs, counts


def repartition(
    mesh,
    blocks: list[TableBlock],
    key_names: list[str],
    bucket_rows: int | None = None,
    with_counts: bool = False,
) -> "list[TableBlock] | tuple[list[TableBlock], torch.Tensor]":
    """Exchange rows so each shard owns hash(keys) % n_shards == its index.

    ``blocks[i]`` is shard ``i``'s block, on its device, all of one
    capacity. Returns the shards' blocks, each of capacity n_shards *
    bucket_rows. With ``with_counts``, returns (blocks, worst: a 0-d
    int32 tensor on shard 0's device) — the mesh-wide max rows any shard
    wanted to send to one destination. worst > bucket_rows means rows
    were dropped somewhere; callers re-exchange with bucket_rows grown
    to hold ``worst`` exactly (the grace-join respill protocol,
    mkql_grace_join_imp.cpp bucket overflow, sized by the observed count
    instead of blind doubling)."""
    n_shards = mesh.n_shards
    if len(blocks) != n_shards:
        raise ValueError(f"{len(blocks)} blocks for {n_shards} shards")
    B = bucket_rows if bucket_rows is not None else blocks[0].capacity
    sent = [_bucket(b, key_names, n_shards, B) for b in blocks]
    # rows sent to each destination, as the receivers will count them
    sent_counts = [torch.clamp(counts[:n_shards], max=B)[:, None]
                   for _, counts in sent]
    recv_counts = meshlib.all_to_all(mesh, sent_counts)
    recv = {key: meshlib.all_to_all(mesh, [bufs[key] for bufs, _ in sent])
            for key in sent[0][0]}
    schema = blocks[0].schema
    out = []
    for i in range(n_shards):
        dev = mesh.device_of(i)
        row = torch.arange(B, dtype=torch.int32, device=dev)
        mask = (row[None, :] < recv_counts[i].reshape(-1)[:, None]
                ).reshape(-1)
        cols = {n: Column(recv[(n, "d")][i].reshape(-1),
                          recv[(n, "v")][i].reshape(-1))
                for n in schema.names}
        big = TableBlock(cols, torch.full((), n_shards * B,
                                          dtype=torch.int32, device=dev),
                         schema)
        out.append(kernels.compact(big, mask))
    if not with_counts:
        return out
    # a drop anywhere poisons every shard's result: reduce over the mesh
    # so every shard (and the host, once) sees the same grow target
    worst = meshlib.pmax(mesh, [counts[:n_shards].max()
                                for _, counts in sent])
    return out, worst[0]
