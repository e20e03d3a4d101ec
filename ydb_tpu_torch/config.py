"""Configuration: YAML static config, immediate-control-board knobs,
feature flags.

Mirror of the reference's config planes (SURVEY.md §5.6): a strict
YAML-parsed static config (yaml_config_parser.cpp analog — unknown keys
and type mismatches are errors, not warnings), lock-free-ish runtime
knobs registered by name and clamped to bounds (TControlWrapper,
immediate_control_board_wrapper.h:7), and feature flags consulted at
gates (TFeatureFlags analog).

The port's own copy of ``ydb_tpu/config.py``. The port's ``Cluster``
gates row tables on ``enable_row_tables`` and the sys views on
``enable_sys_views`` and changefeeds on ``enable_changefeeds`` as the
reference does.
"""

from __future__ import annotations

import dataclasses
import threading


class ConfigError(Exception):
    pass


@dataclasses.dataclass
class FeatureFlags:
    enable_row_tables: bool = True
    enable_changefeeds: bool = True
    enable_sys_views: bool = True
    enable_native_kernels: bool = True


@dataclasses.dataclass
class AppConfig:
    n_shards: int = 4
    plan_cache_size: int = 128
    scan_block_rows: int = 1 << 20
    compact_portion_threshold: int = 8
    checkpoint_interval: int = 64
    # load-driven shard management (schemeshard__table_stats.cpp
    # analog): a column table whose rows/shard exceed the split
    # threshold doubles its shard count at the next background pass
    # (0 disables); merges halve when rows/shard fall below
    # threshold/8 (hysteresis against flapping)
    split_rows_per_shard: int = 0
    max_auto_shards: int = 64
    min_auto_shards: int = 1  # MinPartitionsCount analog
    # page-cache memory pressure: run_background shrinks the
    # shared cache as RSS nears this soft limit (0 disables)
    memory_soft_limit_bytes: int = 0
    grpc_port: int = 2136
    data_dir: str | None = None
    auth_tokens: tuple = ()
    background_period_seconds: float = 5.0
    feature_flags: FeatureFlags = dataclasses.field(
        default_factory=FeatureFlags)

    @classmethod
    def from_yaml(cls, text: str) -> "AppConfig":
        import yaml

        raw = yaml.safe_load(text) or {}
        if not isinstance(raw, dict):
            raise ConfigError("config root must be a mapping")
        kwargs = {}
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for key, value in raw.items():
            if key not in fields:
                raise ConfigError(f"unknown config key {key!r}")
            if key == "feature_flags":
                if not isinstance(value, dict):
                    raise ConfigError("feature_flags must be a mapping")
                known = {f.name for f in
                         dataclasses.fields(FeatureFlags)}
                bad = set(value) - known
                if bad:
                    raise ConfigError(
                        f"unknown feature flag(s): {sorted(bad)}")
                for k, v in value.items():
                    if not isinstance(v, bool):
                        raise ConfigError(
                            f"feature flag {k} must be a boolean")
                kwargs[key] = FeatureFlags(**value)
            elif key == "auth_tokens":
                if not isinstance(value, list) or not all(
                        isinstance(v, str) for v in value):
                    raise ConfigError("auth_tokens must be a string list")
                kwargs[key] = tuple(value)
            elif key == "data_dir":
                if value is not None and not isinstance(value, str):
                    raise ConfigError("data_dir must be a string")
                kwargs[key] = value
            else:
                want = fields[key].type
                if want in ("int", int) and not (
                        isinstance(value, int) and
                        not isinstance(value, bool)):
                    raise ConfigError(f"{key} must be an integer")
                if want in ("float", float) and not isinstance(
                        value, (int, float)):
                    raise ConfigError(f"{key} must be a number")
                kwargs[key] = value
        cfg = cls(**kwargs)
        if cfg.n_shards < 1:
            raise ConfigError("n_shards must be >= 1")
        if cfg.scan_block_rows < 1:
            raise ConfigError("scan_block_rows must be >= 1")
        if cfg.compact_portion_threshold < 2:
            raise ConfigError("compact_portion_threshold must be >= 2")
        if cfg.checkpoint_interval < 1:
            raise ConfigError("checkpoint_interval must be >= 1")
        if cfg.plan_cache_size < 1:
            raise ConfigError("plan_cache_size must be >= 1")
        return cfg


@dataclasses.dataclass
class _Control:
    name: str
    value: int
    default: int
    lo: int
    hi: int


class ControlBoard:
    """Runtime knobs: registered with bounds, settable live, consulted
    at hot spots (the ICB pattern — tuning without restart)."""

    def __init__(self):
        self._controls: dict[str, _Control] = {}
        self._lock = threading.Lock()

    def register(self, name: str, default: int, lo: int,
                 hi: int) -> None:
        default = max(lo, min(hi, int(default)))  # bounds always hold
        with self._lock:
            if name not in self._controls:
                self._controls[name] = _Control(name, default, default,
                                                lo, hi)

    def set(self, name: str, value: int) -> int:
        """Clamped to the registered bounds; returns the applied value."""
        with self._lock:
            c = self._controls[name]
            c.value = max(c.lo, min(c.hi, int(value)))
            return c.value

    def get(self, name: str) -> int:
        with self._lock:
            return self._controls[name].value

    def reset(self, name: str) -> None:
        with self._lock:
            c = self._controls[name]
            c.value = c.default

    def dump(self) -> dict:
        with self._lock:
            return {n: dataclasses.asdict(c)
                    for n, c in self._controls.items()}
