"""Deterministic, seeded fault injection for the real failure surfaces.

The perf tiers (HBM-resident columns, whole-plan fusion, mesh scale-out)
all assumed the happy path; the serving/multi-host roadmap items assume
the opposite — blob reads fail, devices disappear, statements outlive
their callers, overload arrives in bursts. This package makes the worst
stage injectable so every layer can prove it degrades instead of
deadlocking, leaking, or answering wrongly.

Shape (mirrors the timeline/TSAN gates):

  * Disabled by default. ``chaos.hit(site)`` on the disabled path is one
    module-global bool check returning ``None`` — safe to leave compiled
    into hot paths (blob reads, conveyor task dispatch).
  * Gated twice: the environment switch ``YDB_TPU_TORCH_CHAOS=1`` (or the
    in-process override ``chaos.CHAOS_FORCE = True``) *allows* arming;
    ``chaos.install(scenario)`` actually arms a :class:`Scenario`.
  * Deterministic: each :class:`FaultPoint` owns a PRNG seeded from
    ``scenario.seed ^ crc32(site)``, so a scenario replays the same
    fault sequence per site for the same sequence of ``hit()`` calls.
  * Observable: fired faults bump per-site counters (exported by the
    cluster background cadence under ``component="chaos"``), fire the
    ``chaos.fault`` probe, and annotate the active trace span so
    ``EXPLAIN ANALYZE`` shows which statements absorbed faults.

Sites are just names; the catalog of the ones threaded through the tree
lives in ``ydb_tpu_torch/chaos/README.md``. The layered-on hardening —
:class:`RetryPolicy` (retry.py), statement :class:`Deadline` /
cancellation (deadline.py) — works whether or not faults come from
here; chaos is how the tests drive it.

The port's own copy of ``ydb_tpu/chaos/__init__.py``: the same gates,
the same per-site seeded streams (a scenario replays exactly the
reference's fault sequence), the same counters. Its sites are listed in
``README.md`` beside this file, ``interconnect.send`` among them;
``mesh.dispatch`` comes with the mesh (ROADMAP.md queue A item 13b).
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
import zlib

from ydb_tpu_torch.runtime.failpoints import InjectedFault

from ydb_tpu_torch.chaos.deadline import (  # noqa: F401  (re-exports)
    Deadline,
    StatementCancelled,
)
from ydb_tpu_torch.chaos import retry as _retry_mod
from ydb_tpu_torch.chaos.retry import RetryPolicy, note_retry  # noqa: F401

#: In-process override of the YDB_TPU_TORCH_CHAOS env gate (the
#: timeline.TIMELINE_FORCE idiom): None = follow the environment,
#: True/False = force. Tests set this instead of mutating os.environ.
CHAOS_FORCE: bool | None = None


def chaos_enabled() -> bool:
    """May a scenario be armed in this process?"""
    if CHAOS_FORCE is not None:
        return CHAOS_FORCE
    return os.environ.get("YDB_TPU_TORCH_CHAOS", "") not in ("", "0", "off")


class ChaosError(InjectedFault):
    """Base for faults raised (not just described) by the chaos plane.

    Subclasses ``failpoints.InjectedFault`` so existing test plumbing
    that treats injected failures specially keeps working.
    """


class InjectedIOError(ChaosError, OSError):
    """Injected blob/storage IO failure. Also an ``OSError`` so every
    transient-IO retry path treats it as the real thing."""


class DeviceLostError(ChaosError):
    """Injected accelerator loss mid-dispatch; the mesh executor's
    graceful-degradation path (mesh -> single chip -> walk) handles it."""


class Fault:
    """One fired fault: what the injection site should now do.

    ``hit()`` returns a Fault (or None); the site interprets ``kind``:
    raise, truncate, sleep, kill the worker — whatever failure that
    surface really exhibits.
    """

    __slots__ = ("site", "kind", "latency")

    def __init__(self, site: str, kind: str, latency: float = 0.0):
        self.site = site
        self.kind = kind
        self.latency = latency

    def sleep(self) -> None:
        """Apply the latency component (no-op when 0): 'delay' /
        'latency' kinds are pure sleeps, error kinds may also carry a
        latency to model slow failures."""
        if self.latency > 0.0:
            time.sleep(self.latency)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Fault({self.site!r}, {self.kind!r}, {self.latency})"


class FaultPoint:
    """A named injection site armed with probability/budget/seed."""

    def __init__(self, name: str, kind: str, p: float = 1.0,
                 budget: int | None = None, latency: float = 0.0,
                 seed: int = 0):
        self.name = name
        self.kind = kind
        self.p = float(p)
        self.budget = budget
        self.latency = float(latency)
        # per-site stream: scenario seed mixed with the site name, so
        # adding a site never perturbs another site's fault sequence
        self._rng = random.Random((seed ^ zlib.crc32(name.encode()))
                                  & 0xFFFFFFFF)
        self._lock = threading.Lock()
        self.hits = 0
        self.fired = 0

    def roll(self) -> Fault | None:
        with self._lock:
            self.hits += 1
            if self.budget is not None and self.fired >= self.budget:
                return None
            if self.p < 1.0 and self._rng.random() >= self.p:
                return None
            self.fired += 1
        return Fault(self.name, self.kind, self.latency)

    def stats(self) -> dict:
        with self._lock:
            return {"kind": self.kind, "p": self.p,
                    "budget": self.budget, "hits": self.hits,
                    "fired": self.fired}


class Scenario:
    """A replayable set of armed fault points (the chaos DSL).

    JSON shape::

        {"seed": 42,
         "sites": {
           "blob.get_range": {"kind": "io_error", "p": 0.05},
           "mesh.dispatch":  {"kind": "device_lost", "budget": 1},
           "conveyor.task":  {"kind": "delay", "p": 0.1,
                              "latency": 0.002}}}

    ``p`` defaults to 1.0, ``budget`` to unlimited, ``latency`` to 0.
    Same seed + same per-site call sequence => same faults.
    """

    def __init__(self, seed: int = 0,
                 sites: dict[str, dict] | None = None):
        self.seed = int(seed)
        self.spec = {name: dict(cfg) for name, cfg in
                     (sites or {}).items()}

    def build_points(self) -> dict[str, FaultPoint]:
        pts = {}
        for name, cfg in self.spec.items():
            pts[name] = FaultPoint(
                name, kind=cfg.get("kind", "io_error"),
                p=cfg.get("p", 1.0), budget=cfg.get("budget"),
                latency=cfg.get("latency", 0.0), seed=self.seed)
        return pts

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed, "sites": self.spec},
                          indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Scenario":
        doc = json.loads(text)
        return cls(seed=doc.get("seed", 0), sites=doc.get("sites"))

    @classmethod
    def from_file(cls, path: str) -> "Scenario":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# process-wide armed state
# ---------------------------------------------------------------------------

_ARMED = False  # the single check on the disabled hot path
_POINTS: dict[str, FaultPoint] = {}
_FALLBACKS: dict[str, int] = {}
_state_lock = threading.Lock()
_FAULT_PROBE = None  # lazily bound (keeps import graph acyclic)


def install(scenario: Scenario) -> None:
    """Arm a scenario. Requires the gate (env or CHAOS_FORCE) open —
    chaos must never switch on by accident in a serving process."""
    global _ARMED, _POINTS
    if not chaos_enabled():
        raise RuntimeError(
            "chaos is gated off: set YDB_TPU_TORCH_CHAOS=1 or "
            "chaos.CHAOS_FORCE = True before install()")
    with _state_lock:
        _POINTS = scenario.build_points()
        _ARMED = True


def clear() -> None:
    """Disarm and drop all points/counters (test teardown)."""
    global _ARMED, _POINTS
    with _state_lock:
        _ARMED = False
        _POINTS = {}
        _FALLBACKS.clear()
    _retry_mod.clear_counters()


def armed() -> bool:
    return _ARMED


def hit(site: str, **ctx) -> Fault | None:
    """The injection-site call. Disabled path: one bool check, None.

    When a scenario is armed and the site rolls a fault, returns the
    :class:`Fault` (after surfacing it on probes/spans); the site then
    enacts it. ``ctx`` rides onto the probe event for filtering.
    """
    if not _ARMED:
        return None
    pt = _POINTS.get(site)
    if pt is None:
        return None
    f = pt.roll()
    if f is None:
        return None
    _surface_fault(f, ctx)
    return f


def _surface_fault(f: Fault, ctx: dict) -> None:
    global _FAULT_PROBE
    with _state_lock:
        if _FAULT_PROBE is None:
            from ydb_tpu_torch.obs import probes
            _FAULT_PROBE = probes.probe("chaos.fault")
        probe = _FAULT_PROBE
    if probe:
        probe.fire(site=f.site, kind=f.kind, **ctx)
    from ydb_tpu_torch.obs import tracing
    sp = tracing.current_span()
    if sp is not None:
        sp.set(chaos_faults=sp.attrs.get("chaos_faults", 0) + 1,
               chaos_last=f"{f.site}:{f.kind}")


def note_fallback(site: str) -> None:
    """Count a graceful degradation taken because of a fault (mesh ->
    single chip, fused -> walk, resident -> host)."""
    with _state_lock:
        _FALLBACKS[site] = _FALLBACKS.get(site, 0) + 1


def counters_snapshot() -> dict:
    """Per-site counters for the ``component="chaos"`` export; empty
    dict when nothing armed and nothing counted (the background cadence
    skips the group entirely)."""
    with _state_lock:
        out: dict = {}
        sites = {n: p.stats() for n, p in _POINTS.items()}
        if sites:
            out["sites"] = sites
        if _FALLBACKS:
            out["fallbacks"] = dict(_FALLBACKS)
    retries = _retry_mod.retry_counters()
    if retries:
        out["retries"] = retries
    return out
