"""The port's Console (versioned dynamic config with selector overrides),
ConfigsDispatcher and CMS maintenance permissions
(``ydb_tpu_torch/runtime/console.py``) against the reference's.

Each case of ``tests/test_console.py`` runs through both packages on the
same clock: every return value, resolved config and error equal, and
after it every blob of the two stores the same bytes (the tablets' redo
and snapshot blobs). A console and a CMS written by either package boot
in the other with every version, override, permission and queue entry.
Tolerance: none."""

import pytest

from ydb_tpu.config import ConfigError as RConfigError
from ydb_tpu.engine.blobs import MemBlobStore as RMemBlobStore
from ydb_tpu.runtime import console as rconsole

from ydb_tpu_torch import interop
from ydb_tpu_torch.config import ConfigError
from ydb_tpu_torch.engine.blobs import MemBlobStore
from ydb_tpu_torch.runtime import console

from conftest import Clock

#: (package label, console module, its MemBlobStore, its ConfigError)
KITS = (("ref", rconsole, RMemBlobStore, RConfigError),
        ("port", console, MemBlobStore, ConfigError))


def _blobs(store) -> dict:
    return {b: bytes(store.get(b)) for b in store.list("")}


def _run(case):
    """``case(m, store, ConfigError)`` once per package: the same
    result, the same blobs."""
    outs, stores = [], []
    for _label, m, store_cls, config_error in KITS:
        store = store_cls()
        outs.append(case(m, store, config_error))
        stores.append(_blobs(store))
    assert outs[0] == outs[1]
    assert stores[0] == stores[1]
    return outs[1]


def test_versioned_config_cas_and_validation():
    def case(m, store, config_error):
        c = m.Console(store)
        assert c.set_config("n_shards: 8") == 1
        text, v = c.get_config()
        assert "n_shards: 8" in text and v == 1
        # CAS: stale expected version rejected
        with pytest.raises(m.VersionMismatch) as ei:
            c.set_config("n_shards: 2", expected_version=0)
        assert c.set_config("n_shards: 2", expected_version=1) == 2
        # invalid config rejected BEFORE commit; version unchanged
        with pytest.raises(config_error) as ei2:
            c.set_config("nope_key: 1")
        assert c.version == 2
        return text, str(ei.value), str(ei2.value), c.get_config()

    _run(case)


def test_selector_overrides_merge_in_order():
    def case(m, store, _err):
        c = m.Console(store)
        c.set_config("n_shards: 4\nplan_cache_size: 64")
        c.add_override({"tenant": "/Root/a"}, "n_shards: 16")
        c.add_override({"node_kind": "storage"}, "plan_cache_size: 8")
        base = c.resolve({})
        assert base.n_shards == 4 and base.plan_cache_size == 64
        a = c.resolve({"tenant": "/Root/a"})
        assert a.n_shards == 16 and a.plan_cache_size == 64
        both = c.resolve({"tenant": "/Root/a", "node_kind": "storage"})
        assert both.n_shards == 16 and both.plan_cache_size == 8
        return [(cfg.n_shards, cfg.plan_cache_size)
                for cfg in (base, a, both)], c.version

    _run(case)


def test_dispatcher_receives_pushes():
    def case(m, store, _err):
        c = m.Console(store)
        c.set_config("n_shards: 4")
        d = m.ConfigsDispatcher({"tenant": "/Root/x"})
        seen = []
        c.subscribe(d)
        d.on_change(lambda cfg: seen.append(cfg.n_shards))
        assert seen == [4]  # immediate delivery on subscribe
        c.add_override({"tenant": "/Root/x"}, "n_shards: 32")
        assert seen[-1] == 32
        c.set_config("n_shards: 6")  # override still applies on top
        assert seen[-1] == 32 and d.version == c.version
        return seen, d.version

    _run(case)


def test_console_reboot_keeps_versions_and_overrides():
    def case(m, store, _err):
        c = m.Console(store)
        c.set_config("n_shards: 8")
        c.add_override({"tenant": "/t"}, "n_shards: 2")
        c2 = m.Console(store)
        assert c2.version == 2
        assert c2.resolve({"tenant": "/t"}).n_shards == 2
        return c2.get_config()

    _run(case)


def test_cms_availability_budget():
    def case(m, store, _err):
        clock = Clock()
        cms = m.Cms(store, max_unavailable=1, now=clock)
        assert cms.request(1, duration_s=100)
        assert cms.permitted(1)
        assert not cms.request(2)          # budget spent -> queued
        assert cms.request(1)              # idempotent re-request
        granted = cms.done(1)              # returning grants the head
        assert granted == [2] and cms.permitted(2)
        assert not cms.permitted(1)
        return granted

    _run(case)


def test_cms_expired_permission_frees_budget():
    def case(m, store, _err):
        clock = Clock()
        cms = m.Cms(store, max_unavailable=1, now=clock)
        assert cms.request(1, duration_s=50)
        clock.t += 60  # lapsed
        assert not cms.permitted(1)
        assert cms.request(2)  # expired permission no longer counts
        return cms.permitted(2)

    _run(case)


def test_cms_expiry_grants_queue_fifo_no_jumping():
    """A fresh request does not jump nodes already queued when an
    expired permission frees budget."""
    def case(m, store, _err):
        clock = Clock()
        cms = m.Cms(store, max_unavailable=1, now=clock)
        assert cms.request(1, duration_s=50)
        assert not cms.request(2)          # queued behind 1
        clock.t += 60                      # 1's permission expires
        assert not cms.request(3)          # 2 is first in line
        assert cms.permitted(2) and not cms.permitted(3)
        granted = cms.done(2)
        assert granted == [3]              # then 3 gets its turn
        return granted

    _run(case)


def test_cms_tick_grants_after_expiry():
    def case(m, store, _err):
        clock = Clock()
        cms = m.Cms(store, max_unavailable=1, now=clock)
        cms.request(1, duration_s=50)
        assert not cms.request(2)
        clock.t += 60
        granted = cms.tick()
        assert granted == [2]
        assert cms.permitted(2)
        return granted

    _run(case)


def test_invalid_override_rejected_before_commit():
    def case(m, store, config_error):
        c = m.Console(store)
        c.set_config("n_shards: 4")
        with pytest.raises(config_error) as ei:
            c.add_override({"tenant": "/t"}, "nope_key: 1")
        assert c.version == 1  # nothing committed
        assert c.resolve({"tenant": "/t"}).n_shards == 4  # not poisoned
        return str(ei.value)

    _run(case)


def test_cms_repeat_request_keeps_queue_position():
    def case(m, store, _err):
        clock = Clock()
        cms = m.Cms(store, max_unavailable=1, now=clock)
        assert cms.request(1, duration_s=500)
        assert not cms.request(2)
        assert not cms.request(2)  # retry: same position, no duplicate
        assert not cms.request(3)
        g1 = cms.done(1)
        assert g1 == [2]
        # node 2's duplicate must not consume the next free slot
        g2 = cms.done(2)
        assert g2 == [3]
        return g1, g2

    _run(case)


def test_cms_survives_reboot():
    def case(m, store, _err):
        clock = Clock()
        cms = m.Cms(store, max_unavailable=1, now=clock)
        cms.request(7, duration_s=500)
        cms2 = m.Cms(store, max_unavailable=1, now=clock)
        assert cms2.permitted(7)
        assert not cms2.request(8)
        return cms2.permitted(7)

    _run(case)


# ---- state written by one package, booted by the other ----

def _copy_to_reference(store):
    out = RMemBlobStore()
    for blob_id in store.list(""):
        out.put(blob_id, bytes(store.get(blob_id)))
    return out


def _write_console(m, store):
    c = m.Console(store)
    c.set_config("n_shards: 8\nplan_cache_size: 32")
    c.add_override({"tenant": "/t"}, "n_shards: 2")
    c.set_config("n_shards: 6\nplan_cache_size: 32", expected_version=2)


def _read_console(m, store):
    c = m.Console(store)
    out = (c.version, c.get_config(),
           c.resolve({}).n_shards, c.resolve({"tenant": "/t"}).n_shards,
           c.resolve({"tenant": "/t"}).plan_cache_size)
    with pytest.raises(m.VersionMismatch):
        c.set_config("n_shards: 1", expected_version=2)
    assert c.set_config("n_shards: 1", expected_version=3) == 4
    return out


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_console_boots_across_packages(writer):
    """A console written by one package boots in the other: the same
    version, main config and override resolution, and the next CAS
    continues from it; the blobs after equal the writer's own reboot."""
    if writer == "ref":
        src = RMemBlobStore()
        _write_console(rconsole, src)
        theirs, mine = interop.blob_store_from_reference(src), src
        reader, same = console, rconsole
    else:
        src = MemBlobStore()
        _write_console(console, src)
        theirs, mine = _copy_to_reference(src), src
        reader, same = rconsole, console
    got = _read_console(reader, theirs)
    assert got == (3, ("n_shards: 6\nplan_cache_size: 32", 3), 6, 2, 32)
    assert got == _read_console(same, mine)
    assert _blobs(theirs) == _blobs(mine)


def _write_cms(m, store, clock):
    cms = m.Cms(store, max_unavailable=1, now=clock)
    assert cms.request(1, duration_s=500)
    assert not cms.request(2)
    assert not cms.request(3)


def _read_cms(m, store, clock):
    cms = m.Cms(store, max_unavailable=1, now=clock)
    out = (cms.permitted(1), cms.permitted(2), cms.request(1))
    return out, cms.done(1), cms.done(2), cms.permitted(3)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_cms_boots_across_packages(writer):
    """Permissions and the FIFO queue written by one package are the
    other's after a boot: node 1 permitted, then 2 and 3 granted in
    order; the blobs after equal the writer's own reboot."""
    clock = Clock()
    if writer == "ref":
        src = RMemBlobStore()
        _write_cms(rconsole, src, clock)
        theirs, mine = interop.blob_store_from_reference(src), src
        reader, same = console, rconsole
    else:
        src = MemBlobStore()
        _write_cms(console, src, clock)
        theirs, mine = _copy_to_reference(src), src
        reader, same = rconsole, console
    got = _read_cms(reader, theirs, clock)
    assert got == ((True, False, True), [2], [3], True)
    assert got == _read_cms(same, mine, clock)
    assert _blobs(theirs) == _blobs(mine)
