"""The port's PDisk, LSM hull and controller (``ydb_tpu_torch/blobstorage/
pdisk.py``, ``vdisk_lsm.py``, ``controller.py``) against the reference's.

Mirrors ``tests/test_pdisk_lsm.py`` (5 cases) and ``tests/test_bsc.py`` (2):
each body runs over the reference's classes and over the port's on the same
inputs and returns what it observed; the records must be equal. The PDisk
files both packages leave after the same operations must be equal byte for
byte; a group on LSM/PDisk files written by either package reopens and reads
in the other; both packages refuse a part larger than a chunk.
"""

import types

import numpy as np
import pytest

from ydb_tpu.blobstorage import controller as r_controller
from ydb_tpu.blobstorage import group as r_group
from ydb_tpu.blobstorage import pdisk as r_pdisk
from ydb_tpu.blobstorage import vdisk_lsm as r_lsm

from ydb_tpu_torch.blobstorage import controller as t_controller
from ydb_tpu_torch.blobstorage import group as t_group
from ydb_tpu_torch.blobstorage import pdisk as t_pdisk
from ydb_tpu_torch.blobstorage import vdisk_lsm as t_lsm

REF = types.SimpleNamespace(
    name="ref", PDisk=r_pdisk.PDisk, LsmBlobStore=r_lsm.LsmBlobStore,
    DSProxy=r_group.DSProxy, GroupInfo=r_group.GroupInfo,
    VDisk=r_group.VDisk, BSController=r_controller.BSController,
    NodeWarden=r_controller.NodeWarden)
PORT = types.SimpleNamespace(
    name="port", PDisk=t_pdisk.PDisk, LsmBlobStore=t_lsm.LsmBlobStore,
    DSProxy=t_group.DSProxy, GroupInfo=t_group.GroupInfo,
    VDisk=t_group.VDisk, BSController=t_controller.BSController,
    NodeWarden=t_controller.NodeWarden)


def _both(body, tmp_path):
    """``body(P, dir)`` over the reference and the port, each in its own
    directory: equal records, and equal files left in the directories."""
    dirs = {}
    out = []
    for P in (REF, PORT):
        dirs[P.name] = tmp_path / P.name
        dirs[P.name].mkdir()
        out.append(body(P, dirs[P.name]))
    assert out[1] == out[0]
    names = sorted(p.name for p in dirs["ref"].iterdir())
    assert sorted(p.name for p in dirs["port"].iterdir()) == names
    for name in names:
        assert (dirs["port"] / name).read_bytes() == \
            (dirs["ref"] / name).read_bytes(), name
    return out[1]


# ---------------- tests/test_pdisk_lsm.py ----------------

def test_pdisk_alloc_io_and_superblock(tmp_path):
    def body(P, d):
        p = P.PDisk(str(d / "d0"), chunk_size=4096)
        a, b = p.alloc(), p.alloc()
        assert a != b
        p.write(a, 0, b"hello")
        p.write(b, 100, b"world")
        assert p.read(a, 0, 5) == b"hello"
        assert p.read(b, 100, 5) == b"world"
        with pytest.raises(ValueError):
            p.write(a, 4090, b"spans-boundary")
        p.release(b)
        p.commit_meta({"owner": "vdisk-1"})
        p.close()
        p2 = P.PDisk(str(d / "d0"), chunk_size=4096)
        assert p2.meta == {"owner": "vdisk-1"}
        got = p2.alloc()
        assert got == b
        p2.close()
        return a, b, got
    _both(body, tmp_path)


def test_pdisk_superblock_double_buffer_survives_torn_write(tmp_path):
    def body(P, d):
        path = str(d / "d1")
        p = P.PDisk(path, chunk_size=4096)
        p.commit_meta({"gen": 1})
        p.commit_meta({"gen": 2})
        p.close()
        with open(path, "r+b") as f:
            f.seek(0 * 4096 + 20)
            f.write(b"\xff" * 16)
        p2 = P.PDisk(path, chunk_size=4096)
        assert p2.meta == {"gen": 1}
        p2.close()
        return p2.meta
    _both(body, tmp_path)


def test_lsm_put_get_delete_flush_compact(tmp_path):
    def body(P, d):
        p = P.PDisk(str(d / "d2"), chunk_size=4096)
        lsm = P.LsmBlobStore(p, memtable_bytes=2048, max_runs=3)
        for i in range(40):
            lsm.put(f"k/{i:03d}", f"value-{i}".encode() * 20)
        assert lsm.get("k/005") == b"value-5" * 20
        assert len(lsm.runs) >= 1
        lsm.delete("k/005")
        assert not lsm.exists("k/005")
        with pytest.raises(KeyError):
            lsm.get("k/005")
        lsm.put("k/006", b"NEW")
        assert lsm.get("k/006") == b"NEW"
        listed = lsm.list("k/")
        assert "k/005" not in listed and "k/006" in listed
        assert len(listed) == 39
        for i in range(100, 140):
            lsm.put(f"k/{i}", b"x" * 100)
        lsm.flush()
        assert len(lsm.runs) <= 3
        out = (lsm.runs, lsm.list(""), p.allocated_chunks)
        p.close()
        return out
    _both(body, tmp_path)


def test_lsm_recovery_replays_wal_and_manifest(tmp_path):
    def body(P, d):
        path = str(d / "d3")
        p = P.PDisk(path, chunk_size=4096)
        lsm = P.LsmBlobStore(p, memtable_bytes=1 << 14)
        lsm.put("a", b"1")
        lsm.put("b", b"2" * 500)
        lsm.flush()
        lsm.put("c", b"3")
        lsm.delete("a")
        p.close()
        p2 = P.PDisk(path, chunk_size=4096)
        lsm2 = P.LsmBlobStore(p2)
        assert lsm2.get("b") == b"2" * 500
        assert lsm2.get("c") == b"3"
        assert not lsm2.exists("a")
        assert lsm2.list("") == ["b", "c"]
        out = (lsm2.mem, lsm2.runs, lsm2._log_pos)
        p2.close()
        return out
    _both(body, tmp_path)


def _lsm_group(P, d, prefix="pd", chunk_size=8192):
    disks = [P.VDisk(f"d{i}", backing=P.LsmBlobStore(
        P.PDisk(str(d / f"{prefix}{i}"), chunk_size=chunk_size)))
        for i in range(6)]
    return P.GroupInfo(7, "block42", disks)


def _close(group):
    for disk in group.disks:
        disk.backing.pdisk.close()


def test_group_on_lsm_disks_heals(tmp_path):
    def body(P, d):
        group = _lsm_group(P, d)
        disks = group.disks
        proxy = P.DSProxy(group)
        rng = np.random.default_rng(3)
        blobs = {f"blob/{i}": rng.bytes(777 + i) for i in range(8)}
        for bid, data in blobs.items():
            proxy.put(bid, data)
        disks[2].down = True
        for bid, data in blobs.items():
            assert proxy.get(bid) == data
        fresh = P.VDisk("d2r", backing=P.LsmBlobStore(
            P.PDisk(str(d / "pd2r"), chunk_size=8192)))
        rebuilt = proxy.self_heal(2, fresh)
        disks[2] = fresh
        for bid, data in blobs.items():
            assert proxy.get(bid) == data
        _close(group)
        return rebuilt
    _both(body, tmp_path)


# ---------------- tests/test_bsc.py ----------------

def _group(P, gid):
    group = P.GroupInfo(gid, "block42")
    proxy = P.DSProxy(group)
    rng = np.random.default_rng(gid)
    blobs = {f"b{gid}/{i}": rng.bytes(300 + i) for i in range(5)}
    for bid, data in blobs.items():
        proxy.put(bid, data)
    return proxy, blobs


def _records(ctl):
    return [(h.group_id, h.slot, h.old_disk, h.new_disk, h.parts_rebuilt)
            for h in ctl.heal_log]


def test_controller_heals_degraded_groups_from_spares(tmp_path):
    def body(P, _d):
        ctl = P.BSController()
        p1, blobs1 = _group(P, 1)
        p2, blobs2 = _group(P, 2)
        ctl.register_group(p1)
        ctl.register_group(p2)
        w = P.NodeWarden(1)
        for i in range(3):
            w.register_spare(P.VDisk(f"spare-{i}"))
        ctl.register_warden(w)
        assert ctl.check_and_heal() == []
        p1.group.disks[0].down = True
        p2.group.disks[3].down = True
        p2.group.disks[5].down = True
        healed = ctl.check_and_heal()
        assert [h.group_id for h in healed] == [2, 2, 1]
        assert w.spare_count == 0
        assert ctl.degraded_groups() == []
        for proxy, blobs in ((p1, blobs1), (p2, blobs2)):
            for bid, data in blobs.items():
                assert proxy.get(bid) == data
        return _records(ctl)
    _both(body, tmp_path)


def test_controller_stops_when_out_of_spares(tmp_path):
    def body(P, _d):
        ctl = P.BSController()
        p1, blobs1 = _group(P, 7)
        ctl.register_group(p1)
        w = P.NodeWarden(1)
        w.register_spare(P.VDisk("only-spare"))
        ctl.register_warden(w)
        p1.group.disks[0].down = True
        p1.group.disks[1].down = True
        healed = ctl.check_and_heal()
        assert len(healed) == 1
        assert len(ctl.degraded_groups()) == 1
        for bid, data in blobs1.items():
            assert p1.get(bid) == data
        return _records(ctl), ctl.degraded_groups()
    _both(body, tmp_path)


# ---------------- the state both packages share ----------------

@pytest.mark.parametrize("writer", ["reference", "port"])
def test_lsm_group_files_read_in_the_other_package(tmp_path, writer):
    """A block-4-2 group on six LSM/PDisk files, written by one package
    (flushes, a compaction, overwrites, a delete, a WAL tail left
    unflushed), closed as by a crash, reopens in the other from the files
    alone and reads every blob, with two disks down too; the same history
    through both packages leaves the same files."""
    rng = np.random.default_rng(44)
    blobs = {f"f/{i}": rng.bytes(int(n))
             for i, n in enumerate(rng.integers(1, 9000, size=24))}

    def history(P, d):
        group = _lsm_group(P, d)
        for disk in group.disks:
            disk.backing.memtable_bytes = 4096
            disk.backing.max_runs = 2
        proxy = P.DSProxy(group)
        for bid, data in blobs.items():
            proxy.put(bid, data)
        proxy.put("f/3", b"overwritten")
        proxy.delete("f/5")
        _close(group)
        return sorted(proxy.list(""))

    _both(history, tmp_path)
    src = "ref" if writer == "reference" else "port"
    reader = PORT if writer == "reference" else REF
    group = _lsm_group(reader, tmp_path / src)
    proxy = reader.DSProxy(group)
    want = dict(blobs, **{"f/3": b"overwritten"})
    del want["f/5"]
    assert proxy.list("") == sorted(want)
    assert {b: proxy.get(b) for b in want} == want
    group.disks[1].down = group.disks[4].down = True
    assert {b: proxy.get(b) for b in want} == want
    _close(group)


def test_part_larger_than_a_chunk_raises_in_both(tmp_path):
    """Copied on purpose: a WAL record must fit one chunk, so a blob whose
    block-4-2 part outgrows the chunk cannot be put (ROADMAP.md queue C);
    both packages refuse the put with the reference's message, leave no
    part of it behind, and take a blob whose parts fit."""
    def body(P, d):
        lsm = P.LsmBlobStore(P.PDisk(str(d / "one"), chunk_size=4096))
        with pytest.raises(ValueError, match="record larger than a chunk"):
            lsm.put("big", b"\x01" * 4096)
        lsm.pdisk.close()
        group = _lsm_group(P, d, chunk_size=4096)
        proxy = P.DSProxy(group)
        big = np.random.default_rng(9).bytes(4 * 4096)
        with pytest.raises(ValueError) as e:
            proxy.put("big", big)
        proxy.put("fits", big[:4 * 4000])
        out = (str(e.value), proxy.list(""), proxy.get("fits") == big[:16000])
        _close(group)
        return out
    msg, listed, fits = _both(body, tmp_path)
    assert (msg, listed, fits) == ("record larger than a chunk", ["fits"],
                                   True)


def test_group_on_lsm_disks_under_concurrent_readers_and_writers(tmp_path):
    """The port's scans read blobs on worker threads while statements
    write: 16 threads (more than this machine's cores), a switch
    interval of 1 us, each putting its own blobs and reading every
    thread's back from one DSProxy over six LSM/PDisk disks. Without the
    proxy's lock a PDisk seek-then-read interleaves and a read returns
    another part's bytes."""
    import sys
    import threading

    group = _lsm_group(PORT, tmp_path, chunk_size=1 << 16)
    proxy = PORT.DSProxy(group)
    rng = np.random.default_rng(12)
    blobs = {f"t{w}/{i}": rng.bytes(int(rng.integers(100, 20_000)))
             for w in range(16) for i in range(4)}
    errors = []

    def work(w):
        try:
            for i in range(4):
                proxy.put(f"t{w}/{i}", blobs[f"t{w}/{i}"])
                for v in (w, (w + 1) % 16, (w + 5) % 16):
                    for j in range(i + 1):
                        bid = f"t{v}/{j}"
                        if proxy.exists(bid):
                            assert proxy.get(bid) == blobs[bid], bid
        except BaseException as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(w,))
                   for w in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[:3]
    assert {b: proxy.get(b) for b in blobs} == blobs
    _close(group)
