"""Console dynamic config tablet + CMS maintenance permissions.

Mirror of the reference's cluster-management plane (ydb/core/cms/
console: the Console tablet stores versioned YAML configs with
selector-based overrides that nodes receive via ConfigsDispatcher
subscriptions, kikimr_services_initializers.h:474 + yaml_config.cpp;
ydb/core/cms: maintenance requests granting node-down permissions
under an availability budget; SURVEY.md §2.14 "CMS / console").

Console semantics:
  * one main YAML config, versioned; set_config with an expected
    version is compare-and-swap (lost-update protection);
  * overrides attach to selectors ({tenant: ..., node_kind: ...});
    resolve(node_attrs) deep-merges main <- each matching override in
    registration order (the reference's selector_config semantics);
  * dispatchers subscribe with node attrs and get called back with the
    merged AppConfig whenever the effective config changes.

CMS semantics: a maintenance request names a node and a duration; it
is granted while fewer than ``max_unavailable`` nodes hold active
permissions, otherwise queued and granted in order as permissions
expire/return (the availability-budget contract of cms_impl).
All state is durable (tablet WAL) — a rebooted console still knows
every version, override and outstanding permission.

The port's own copy of ``ydb_tpu/runtime/console.py``, over the port's
``config.py``, ``engine/blobs.py`` and ``tablet/executor.py``: the same
tablet ids and rows, so a console or CMS of either package boots from a
store the other wrote.
"""

from __future__ import annotations

import time

import yaml

from ydb_tpu_torch.config import AppConfig, ConfigError
from ydb_tpu_torch.engine.blobs import BlobStore
from ydb_tpu_torch.tablet.executor import TabletExecutor


def deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


class VersionMismatch(Exception):
    pass


class Console:
    """Versioned dynamic config with selector overrides (durable)."""

    def __init__(self, store: BlobStore):
        self.executor = TabletExecutor.boot("console", store)
        self._subs: list["ConfigsDispatcher"] = []

    @property
    def version(self) -> int:
        row = self.executor.db.table("meta").get(("version",))
        return row["v"] if row else 0

    def set_config(self, yaml_text: str,
                   expected_version: int | None = None) -> int:
        AppConfig.from_yaml(yaml_text)  # strict-validate BEFORE commit

        def fn(txc):
            cur = self.version
            if expected_version is not None and cur != expected_version:
                raise VersionMismatch(
                    f"config is v{cur}, expected v{expected_version}")
            txc.put("config", ("main",), {"yaml": yaml_text})
            txc.put("meta", ("version",), {"v": cur + 1})
            return cur + 1
        v = self.executor.run(fn)
        self._notify()
        return v

    def get_config(self) -> tuple[str, int]:
        row = self.executor.db.table("config").get(("main",))
        return (row["yaml"] if row else "", self.version)

    def add_override(self, selector: dict, yaml_fragment: str) -> int:
        # validate the EFFECTIVE config before commit, like set_config:
        # a fragment with unknown keys/bad types must not durably
        # poison resolve() for matching nodes
        frag = yaml.safe_load(yaml_fragment) or {}
        if not isinstance(frag, dict):
            raise ConfigError("override fragment must be a mapping")
        main_row = self.executor.db.table("config").get(("main",))
        base = yaml.safe_load(main_row["yaml"]) if main_row else {}
        AppConfig.from_yaml(yaml.safe_dump(
            deep_merge(base or {}, frag)))

        def fn(txc):
            n = sum(1 for _ in
                    self.executor.db.table("overrides").range())
            txc.put("overrides", (n,), {
                "selector": dict(selector), "yaml": yaml_fragment})
            v = self.version + 1
            txc.put("meta", ("version",), {"v": v})
            return v
        v = self.executor.run(fn)
        self._notify()
        return v

    def resolve(self, node_attrs: dict | None = None) -> AppConfig:
        """Effective config for a node: main merged with every override
        whose selector is a subset of the node's attributes."""
        attrs = node_attrs or {}
        main_row = self.executor.db.table("config").get(("main",))
        merged = yaml.safe_load(main_row["yaml"]) if main_row else {}
        merged = merged or {}
        for (_n,), row in self.executor.db.table("overrides").range():
            if all(attrs.get(k) == v for k, v in
                   row["selector"].items()):
                frag = yaml.safe_load(row["yaml"]) or {}
                merged = deep_merge(merged, frag)
        return AppConfig.from_yaml(yaml.safe_dump(merged))

    # -- subscriptions (ConfigsDispatcher plane) --

    def subscribe(self, dispatcher: "ConfigsDispatcher") -> None:
        self._subs.append(dispatcher)
        dispatcher._deliver(self)

    def _notify(self) -> None:
        for d in self._subs:
            d._deliver(self)


class ConfigsDispatcher:
    """Per-node config subscriber: holds the node's selector attrs and
    invokes callbacks with the merged AppConfig on every change."""

    def __init__(self, node_attrs: dict | None = None):
        self.node_attrs = node_attrs or {}
        self.config: AppConfig | None = None
        self.version = -1
        self._callbacks = []

    def on_change(self, fn):
        """Register a callback; returns an unsubscribe callable so a
        component torn down before its node (pool reconfig, tests)
        detaches instead of leaking the callback — and a reference to
        itself — for the dispatcher's lifetime (lifecycle R007)."""
        self._callbacks.append(fn)
        if self.config is not None:
            fn(self.config)

        def unsubscribe() -> None:
            try:
                self._callbacks.remove(fn)
            except ValueError:  # already detached: idempotent
                pass

        return unsubscribe

    def _deliver(self, console: Console) -> None:
        v = console.version
        if v == self.version:
            return
        self.version = v
        self.config = console.resolve(self.node_attrs)
        for fn in self._callbacks:
            fn(self.config)


class Cms:
    """Maintenance permissions under an availability budget."""

    def __init__(self, store: BlobStore, max_unavailable: int = 1,
                 now=time.time):
        self.executor = TabletExecutor.boot("cms", store)
        self.max_unavailable = max_unavailable
        self.now = now

    def _active(self, now: float) -> list[int]:
        return [nid for (nid,), row in
                self.executor.db.table("permissions").range()
                if row["deadline"] > now]

    def _grant_queued(self, txc, now: float,
                      exclude: frozenset = frozenset()
                      ) -> tuple[list[int], int]:
        """Drop expired/excluded permissions, then grant queued
        requests FIFO while the availability budget allows. Returns
        (granted node ids, resulting active count). Shared by
        request()/done()/tick() so queue order is honored no matter
        HOW budget frees up (return or expiry). All counting is done
        against the committed view plus this tx's own effects, since
        in-tx reads do not see in-tx writes."""
        perms = list(self.executor.db.table("permissions").range())
        active = [nid for (nid,), row in perms
                  if row["deadline"] > now and nid not in exclude]
        for (nid,), row in perms:
            if row["deadline"] <= now or nid in exclude:
                txc.erase("permissions", (nid,))
        granted = []
        for (qn,), row in list(self.executor.db.table("queue").range()):
            if len(active) + len(granted) >= self.max_unavailable:
                break
            txc.erase("queue", (qn,))
            txc.put("permissions", (row["node"],), {
                "action": row["action"],
                "deadline": now + row["duration"],
            })
            granted.append(row["node"])
        return granted, len(active) + len(granted)

    def request(self, node_id: int, action: str = "restart",
                duration_s: float = 600.0) -> bool:
        """True = permission granted now; False = queued. Earlier
        queued requests are served first — a fresh request cannot jump
        a queue that freed-up budget could satisfy."""
        def fn(txc):
            now = self.now()
            if node_id in self._active(now):
                return True  # already permitted
            granted, active_n = self._grant_queued(txc, now)
            if node_id in granted:
                return True
            # already queued: keep the original position, no duplicate
            for (_qn,), row in self.executor.db.table("queue").range():
                if row["node"] == node_id:
                    return False
            q_committed = sum(
                1 for _ in self.executor.db.table("queue").range())
            still_queued = q_committed - len(granted)
            if active_n < self.max_unavailable and still_queued == 0:
                txc.put("permissions", (node_id,), {
                    "action": action,
                    "deadline": now + duration_s,
                })
                return True
            # FIFO key from a monotonic counter: a count-based key
            # would sort fresh entries before older surviving ones
            seq_row = self.executor.db.table("meta").get(("queue_seq",))
            seq = seq_row["v"] if seq_row else 0
            txc.put("meta", ("queue_seq",), {"v": seq + 1})
            txc.put("queue", (seq,), {
                "node": node_id, "action": action,
                "duration": duration_s,
            })
            return False
        return self.executor.run(fn)

    def tick(self, now: float | None = None) -> list[int]:
        """Expire lapsed permissions and grant queued requests FIFO."""
        now = self.now() if now is None else now
        return self.executor.run(
            lambda txc: self._grant_queued(txc, now)[0])

    def done(self, node_id: int) -> list[int]:
        """Return a permission; grants queued requests that now fit."""
        def fn(txc):
            return self._grant_queued(txc, self.now(),
                                      exclude=frozenset({node_id}))[0]
        return self.executor.run(fn)

    def permitted(self, node_id: int) -> bool:
        row = self.executor.db.table("permissions").get((node_id,))
        return row is not None and row["deadline"] > self.now()
