"""Blob groups: VDisks, topology, and the quorum DSProxy.

Mirror of the reference's group machinery (SURVEY.md §2.3): a group is a
set of disks across fail domains (TBlobStorageGroupInfo
groupinfo/blobstorage_groupinfo.h:65); clients talk to a per-group
DSProxy which erasure-encodes puts across the disks
(dsproxy_put.cpp:29), reads with reconstruction when disks are down
(restore-on-read, dsproxy_get.cpp:34), and the controller replaces
broken disks and rebuilds their parts (self-heal
mind/bscontroller/self_heal.cpp + vdisk repl).

VDisk here is the per-disk part store (the hull LSM collapsed to a KV
namespace on a host BlobStore); ``down`` simulates disk death for
tests/nemesis.

The port's own copy of ``ydb_tpu/blobstorage/group.py``: the same part
keys (``vdisk/<disk>/<part>/<blob>@<seq>``), META records and rotation
(``common.fnv1a_64``), so a group written by either package reads in
the other. One difference: every public ``DSProxy`` call holds the
proxy's lock, since the port's scans read blobs on conveyor workers and
a PDisk's seek-then-read is not atomic (ROADMAP.md queue C).
"""

from __future__ import annotations

import functools
import json
import threading

from ydb_tpu_torch.blobstorage.erasure import ErasureCodec
from ydb_tpu_torch.common import fnv1a_64
from ydb_tpu_torch.engine.blobs import BlobStore, MemBlobStore


class DiskDown(Exception):
    pass


class VDisk:
    def __init__(self, disk_id: str, backing: BlobStore | None = None):
        self.disk_id = disk_id
        self.backing = backing if backing is not None else MemBlobStore()
        self.down = False

    def _key(self, blob_id: str, part: int) -> str:
        return f"vdisk/{self.disk_id}/{part}/{blob_id}"

    def put_part(self, blob_id: str, part: int, data: bytes) -> None:
        if self.down:
            raise DiskDown(self.disk_id)
        self.backing.put(self._key(blob_id, part), data)

    def get_part(self, blob_id: str, part: int) -> bytes:
        if self.down:
            raise DiskDown(self.disk_id)
        return self.backing.get(self._key(blob_id, part))

    def has_part(self, blob_id: str, part: int) -> bool:
        if self.down:
            raise DiskDown(self.disk_id)
        return self.backing.exists(self._key(blob_id, part))

    def delete_part(self, blob_id: str, part: int) -> None:
        if self.down:
            raise DiskDown(self.disk_id)
        self.backing.delete(self._key(blob_id, part))

    def list_parts(self, part: int, prefix: str = "") -> list[str]:
        if self.down:
            raise DiskDown(self.disk_id)
        full = f"vdisk/{self.disk_id}/{part}/{prefix}"
        skip = len(full) - len(prefix)
        return [k[skip:] for k in self.backing.list(full)]


class GroupInfo:
    """Topology: one disk per (fail domain, part slot). Part i of a blob
    lands on disk (i + rotation(blob)) % n — the reference's blob->disk
    mapper keeps load even the same way (groupinfo.h:274)."""

    def __init__(self, group_id: int, species: str = "block42",
                 disks: list[VDisk] | None = None):
        self.group_id = group_id
        self.codec = ErasureCodec(species)
        n = self.codec.total_parts
        self.disks = disks if disks is not None else [
            VDisk(f"g{group_id}-d{i}") for i in range(n)
        ]
        if len(self.disks) != n:
            raise ValueError(
                f"{species} needs exactly {n} disks per group")

    def disk_for(self, blob_id: str, part: int) -> VDisk:
        rot = hash_rotation(blob_id, len(self.disks))
        return self.disks[(part + rot) % len(self.disks)]


def hash_rotation(blob_id: str, n: int) -> int:
    return fnv1a_64(blob_id) % n


def _locked(fn):
    """Run a DSProxy call under the proxy's lock."""
    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)
    return call


class DSProxy:
    """Per-group client: erasure put/get with quorum + restore-on-read.

    Blobs are stored under versioned ids (``blob_id@seq``, the TLogoBlobID
    analog: reference blobs are immutable and never overwritten in place),
    so an overwrite — or a failed overwrite during a disk outage — never
    touches the parts of the previous version. Parts that cannot land on
    their designated disk go to handoff slots on surviving disks (the
    reference's handoff placement, dsproxy_put.cpp); the write quorum
    demands every part written AND at least total-max_lost distinct
    disks, so the advertised loss tolerance is real for a healthy group
    and degrades only as far as the live topology forces it to.
    """

    META_PART = 255  # per-blob metadata (orig length) replicated broadly

    def __init__(self, group: GroupInfo):
        self.group = group
        self._lock = threading.RLock()
        self.codec = group.codec
        # synclog-lite (vdisk/syncer analog): an append-only log of
        # committed writes + a per-disk watermark of the log position
        # that disk has fully applied. A disk that was DOWN during
        # writes falls behind; resync() replays the gap so the rejoined
        # replica converges in the background instead of only via
        # read-repair/self-heal. (Process-local like VDisk.down itself:
        # the outage being simulated is a disk, not the proxy.)
        # entries: ("put", blob_id) | ("del", blob_id, upto_seq) —
        # deletes carry the highest version deleted so resync can drop
        # a rejoined disk's stale copy instead of resurrecting it
        self.sync_log: list[tuple] = []
        self.watermark: dict[str, int] = {
            d.disk_id: 0 for d in self.group.disks
        }
        # highest version ever deleted per blob: a re-created blob must
        # NOT reuse a tombstoned seq (resync would treat it as deleted)
        self._seq_floor: dict[str, int] = {}

    def _compact_synclog(self) -> None:
        """Drop log entries every replica has applied."""
        floor = min(self.watermark.values()) if self.watermark else 0
        if floor:
            self.sync_log = self.sync_log[floor:]
            for k in self.watermark:
                self.watermark[k] -= floor

    def _prune_meta(self, vid: str) -> None:
        """META stays only on disks still holding a data part of vid
        (shared by self-heal and resync repatriation)."""
        held = set()
        for d in self.group.disks:
            try:
                if any(d.has_part(vid, i)
                       for i in range(self.codec.total_parts)):
                    held.add(d.disk_id)
            except DiskDown:
                held.add(d.disk_id)  # unknown: keep its META
        for d in self.group.disks:
            if d.disk_id not in held:
                try:
                    d.delete_part(vid, self.META_PART)
                except DiskDown:
                    continue

    @staticmethod
    def _vid(blob_id: str, seq: int) -> str:
        return f"{blob_id}@{seq:016x}"

    def _seqs(self, blob_id: str) -> list[int]:
        """All stored versions of blob_id, newest first."""
        seqs = set()
        pref = blob_id + "@"
        for disk in self.group.disks:
            try:
                for vid in disk.list_parts(self.META_PART, prefix=pref):
                    seqs.add(int(vid[len(pref):], 16))
            except DiskDown:
                continue
        return sorted(seqs, reverse=True)

    # ---- put: encode, place parts (handoff), demand a write quorum ----

    @_locked
    def put(self, blob_id: str, data: bytes) -> None:
        parts = self.codec.encode(data)
        # next version = one past the highest stored version of THIS blob
        # (not a process counter: ordering must survive process restarts
        # over persistent backing)
        seq = max(max(self._seqs(blob_id), default=0),
                  self._seq_floor.get(blob_id, 0)) + 1
        vid = self._vid(blob_id, seq)
        meta = json.dumps({"len": len(data)}).encode()
        n = len(self.group.disks)
        rot = hash_rotation(blob_id, n)
        used: set[int] = set()
        placed: list[tuple[VDisk, int]] = []
        for i, part in enumerate(parts):
            # designated slot first, then handoff slots in rotation
            # order; prefer disks not already holding a part of this
            # blob, double up only when the live topology is smaller
            # than the part count
            slots = [(i + rot + off) % n for off in range(n)]
            for only_fresh in (True, False):
                done = False
                for slot in slots:
                    if only_fresh and slot in used:
                        continue
                    disk = self.group.disks[slot]
                    try:
                        disk.put_part(vid, i, part)
                        disk.put_part(vid, self.META_PART, meta)
                    except DiskDown:
                        continue
                    used.add(slot)
                    placed.append((disk, i))
                    done = True
                    break
                if done:
                    break
        # quorum needs (a) every part placed and (b) enough DISTINCT
        # disks that any two successful write quorums intersect — a
        # strict majority — so version numbering (seq = max seen + 1)
        # always observes the previous successful write even across
        # disjoint outages. For block42 the erasure bound (4) is already
        # a majority of 6; mirror3 gets majority 2-of-3.
        need_disks = max(self.codec.total_parts - self.codec.max_lost,
                         len(self.group.disks) // 2 + 1)
        if len(placed) < len(parts) or len(used) < need_disks:
            # roll back this version's parts only — the previous
            # version, living under its own vid, is untouched
            for disk, i in placed:
                try:
                    disk.delete_part(vid, i)
                    disk.delete_part(vid, self.META_PART)
                except DiskDown:
                    continue
            raise IOError(
                f"write quorum failed: {len(placed)}/{len(parts)} parts "
                f"on {len(used)} disks (need all parts on >= "
                f"{need_disks} disks)")
        # supersede older versions (best effort; down disks may keep
        # stale parts but get() always prefers the newest readable seq)
        for old in self._seqs(blob_id):
            if old != seq:
                self._delete_version(blob_id, old)
        # synclog: record the commit; disks that were fully caught up
        # AND took part in this write advance their watermark, anyone
        # down (or skipped) falls behind until resync()
        self.sync_log.append(("put", blob_id))
        pos = len(self.sync_log)
        took = {d.disk_id for d, _i in placed}
        for d in self.group.disks:
            if self.watermark.get(d.disk_id, 0) == pos - 1 \
                    and d.disk_id in took:
                self.watermark[d.disk_id] = pos
        self._compact_synclog()

    # ---- get: collect parts, reconstruct when disks are down ----

    def _gather(self, vid: str):
        parts: dict[int, bytes] = {}
        meta = None
        for disk in self.group.disks:
            try:
                if meta is None and disk.has_part(vid, self.META_PART):
                    meta = json.loads(
                        disk.get_part(vid, self.META_PART).decode())
                for i in range(self.codec.total_parts):
                    if i not in parts and disk.has_part(vid, i):
                        parts[i] = disk.get_part(vid, i)
            except DiskDown:
                continue
        return parts, meta

    @_locked
    def get(self, blob_id: str) -> bytes:
        seqs = self._seqs(blob_id)
        if not seqs:
            raise KeyError(blob_id)
        err: Exception | None = None
        for seq in seqs:
            parts, meta = self._gather(self._vid(blob_id, seq))
            if meta is None or not parts:
                continue
            try:
                return self.codec.decode(parts, meta["len"])
            except ValueError as e:
                err = e  # undecodable at this version; try older
        raise err if err is not None else KeyError(blob_id)

    @_locked
    def exists(self, blob_id: str) -> bool:
        return bool(self._seqs(blob_id))

    def _delete_version(self, blob_id: str, seq: int) -> None:
        vid = self._vid(blob_id, seq)
        for disk in self.group.disks:
            try:
                for i in range(self.codec.total_parts):
                    disk.delete_part(vid, i)
                disk.delete_part(vid, self.META_PART)
            except DiskDown:
                continue

    @_locked
    def delete(self, blob_id: str) -> None:
        seqs = self._seqs(blob_id)
        for seq in seqs:
            self._delete_version(blob_id, seq)
        # deletes are sync events too: a disk down during the delete
        # must drop its stale parts at resync (the tombstone carries
        # the highest deleted version so resync cannot resurrect)
        upto = max(seqs, default=0)
        if upto:
            self._seq_floor[blob_id] = max(
                self._seq_floor.get(blob_id, 0), upto)
        self.sync_log.append(("del", blob_id, upto))
        pos = len(self.sync_log)
        for d in self.group.disks:
            if self.watermark.get(d.disk_id, 0) == pos - 1 and not d.down:
                self.watermark[d.disk_id] = pos
        self._compact_synclog()

    # ---- background resync (vdisk/syncer + synclog analog) ----

    @_locked
    def resync(self) -> int:
        """Catch rejoined replicas up: replay the lagging UP disks'
        sync-log gap. For every blob touched while any of them was
        down, stale/superseded/deleted versions are dropped (delete
        tombstones carry the highest deleted seq so a stale replica
        cannot resurrect a blob) and the current version is fully
        REPATRIATED — every part restored to its designated disk,
        reconstructing where needed, handoff doubles removed — so the
        group's full loss tolerance returns, exactly as after
        self-heal. Advances watermarks; compacts the log when all
        replicas converge. Returns parts transferred.

        Reference: ydb/core/blobstorage/vdisk/syncer/ (synclog catch-up
        between group replicas), miniaturized to a per-commit log +
        per-replica watermark."""
        n = len(self.group.disks)
        moved = 0
        log_len = len(self.sync_log)
        lagging = [d for d in self.group.disks
                   if not d.down
                   and self.watermark.get(d.disk_id, 0) < log_len]
        if not lagging:
            return 0
        incomplete = False
        wm_floor = min(self.watermark.get(d.disk_id, 0)
                       for d in lagging)
        gap = self.sync_log[wm_floor:]
        max_del: dict[str, int] = {}
        for ent in gap:
            if ent[0] == "del":
                max_del[ent[1]] = max(max_del.get(ent[1], 0), ent[2])
        for blob_id in dict.fromkeys(e[1] for e in gap):
            rot = hash_rotation(blob_id, n)
            # versions at or below a tombstone are DELETED even if a
            # stale replica still advertises them
            seqs = [q for q in self._seqs(blob_id)
                    if q > max_del.get(blob_id, 0)]
            current = self._vid(blob_id, seqs[0]) if seqs else None
            pref = blob_id + "@"
            for disk in lagging:
                # drop anything this disk holds that is not current
                # (list_parts returns full vids, prefix included)
                for vid in disk.list_parts(self.META_PART, prefix=pref):
                    if vid != current:
                        for i in range(self.codec.total_parts):
                            disk.delete_part(vid, i)
                        disk.delete_part(vid, self.META_PART)
            if current is None:
                continue
            parts, meta = self._gather(current)
            if meta is None:
                incomplete = True
                continue
            meta_raw = json.dumps({"len": meta["len"]}).encode()
            # repatriate: every part onto its designated live disk,
            # handoff copies dropped — restores full loss tolerance
            for i in range(self.codec.total_parts):
                disk = self.group.disks[(i + rot) % n]
                try:
                    have = disk.has_part(current, i)
                except DiskDown:
                    continue
                if not have:
                    if i in parts:
                        part = parts[i]
                    else:
                        try:
                            part = self.codec.reconstruct_part(
                                parts, i, meta["len"])
                        except ValueError:
                            incomplete = True
                            continue  # unreconstructable right now
                    disk.put_part(current, i, part)
                    disk.put_part(current, self.META_PART, meta_raw)
                    moved += 1
                for other in self.group.disks:
                    if other is disk:
                        continue
                    try:
                        other.delete_part(current, i)
                    except DiskDown:
                        continue
            self._prune_meta(current)
        if incomplete:
            # something could not repatriate (peer disks down, meta
            # unreachable): leave watermarks so a later resync RETRIES
            # the gap — repatriation is idempotent
            return moved
        for d in self.group.disks:
            if not d.down:
                self.watermark[d.disk_id] = log_len
        self._compact_synclog()
        return moved

    @_locked
    def list(self, prefix: str = "") -> list[str]:
        seen = set()
        for disk in self.group.disks:
            try:
                for vid in disk.list_parts(self.META_PART, prefix=prefix):
                    seen.add(vid.rsplit("@", 1)[0])
            except DiskDown:
                continue
        return sorted(seen)

    # ---- self-heal: replace a dead disk, rebuild missing parts ----

    @_locked
    def self_heal(self, disk_index: int,
                  replacement: VDisk | None = None) -> int:
        """Swap in a fresh disk for group slot disk_index and rebuild
        every part the group is missing (BSC self-heal + vdisk repl).
        Returns the number of parts rebuilt."""
        old = self.group.disks[disk_index]
        new = replacement if replacement is not None else VDisk(
            old.disk_id + "'")
        self.group.disks[disk_index] = new
        # the dead disk's watermark must not pin log compaction
        self.watermark.pop(old.disk_id, None)
        n = len(self.group.disks)
        rebuilt = 0
        complete = True
        for blob_id in self.list():
            rot = hash_rotation(blob_id, n)
            for seq in self._seqs(blob_id):
                vid = self._vid(blob_id, seq)
                parts, meta = self._gather(vid)
                if meta is None:
                    continue
                # restore every part onto its designated live disk —
                # this both fills the replacement disk and repatriates
                # handoff copies written while disks were down, so the
                # group's full loss tolerance comes back after heal
                for i in range(self.codec.total_parts):
                    disk = self.group.disks[(i + rot) % n]
                    try:
                        on_designated = disk.has_part(vid, i)
                    except DiskDown:
                        continue
                    if not on_designated:
                        if i in parts:
                            part = parts[i]
                        else:
                            try:
                                part = self.codec.reconstruct_part(
                                    parts, i, meta["len"])
                            except ValueError:
                                complete = False
                                break  # unreconstructable: heal the rest
                        try:
                            disk.put_part(vid, i, part)
                            disk.put_part(
                                vid, self.META_PART,
                                json.dumps({"len": meta["len"]}).encode())
                        except DiskDown:
                            continue
                        rebuilt += 1
                    # drop now-redundant handoff copies of this part
                    for other in self.group.disks:
                        if other is disk:
                            continue
                        try:
                            other.delete_part(vid, i)
                        except DiskDown:
                            continue
                self._prune_meta(vid)
        # an INCOMPLETE heal (peers down made blobs unreconstructable)
        # leaves the replacement lagging so resync retries what it can;
        # rerun self_heal once the peers return for unlogged blobs
        self.watermark[new.disk_id] = (
            len(self.sync_log) if complete else 0)
        return rebuilt
