"""Typed serving configuration: the validated object every layer merges into.

``ServeConfig`` is the single source of truth for how a serving process is
assembled — what was ~15 interacting CLI flags on
``repro_torch.launch.serve`` (``--multi/--store/--precision/--executors/--priorities/--rebalance/
--paged/--kv-frac/...``) is now one dataclass tree with four sections:

  * top level   — what to serve (``arch`` / ``models``, ``reduce``);
  * ``workload``  — the reference request mix (requests, prompt/new tokens,
    rounds, priority classes);
  * ``runtime``   — the memory/storage envelope
    (:class:`~repro_torch.core.multi_model.MultiModelRuntime` construction:
    budget, store backend, precision, executors, prefetch depth,
    cache/KV fractions, paging);
  * ``scheduler`` — :class:`~repro_torch.core.serving_scheduler
    .ServingScheduler` policy (preemption, rebalance, slack, degradation
    knobs);
  * ``http``      — the control plane (serving/control_plane.py).

Construction goes through :func:`ServeConfig.from_dict`, which REJECTS
unknown keys with a did-you-mean hint instead of silently ignoring a typo'd
``budjet_mb`` (a mis-spelled override that falls back to a default is the
worst failure mode a layered config can have), and coerces string values
(env vars arrive as strings) onto the declared field types.
``validate()`` then checks cross-field invariants the type system can't.
"""
from __future__ import annotations

import dataclasses
import difflib
import typing
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.errors import ConfigError

__all__ = ["ServeConfig", "WorkloadConfig", "RuntimeConfig",
           "SchedulerConfig", "HttpConfig", "ConfigError",
           "REDUCE_PRESETS", "SERVE_STORES", "PRECISIONS"]

REDUCE_PRESETS = ("smoke", "100m", "full")
# the servable subset of repro_torch.store.STORE_BACKENDS: `faulty` is a test
# wrapper (it needs an inner backend + fault schedule), not a deployment tier
SERVE_STORES = ("mmap", "rawio", "quant", "directio")
# `mixed` = per-unit precision from a calibration pass (repro_torch/calibrate/):
# requires the quant store plus a runtime.fidelity target
PRECISIONS = (None, "int8", "int4", "mixed")


@dataclass
class WorkloadConfig:
    """The reference request mix a profile run (or warmup) drives."""
    requests: int = 8          # prompts per submitted batch
    prompt_len: int = 32
    new_tokens: int = 16       # generation length (decode paths)
    max_len: int = 128         # decode cache capacity (plain engine)
    rounds: int = 3            # round-robin passes over the tenant set
    priorities: List[float] = field(default_factory=lambda: [1.0])


@dataclass
class RuntimeConfig:
    """Memory/storage envelope: MultiModelRuntime construction knobs."""
    budget_mb: Optional[float] = None   # None = unswapped (no budget)
    prefetch_depth: int = 2
    cache_frac: float = 0.25
    executors: int = 1
    store: str = "mmap"
    precision: Optional[str] = None     # None = the arch's swap_precision
    fidelity: Optional[float] = None    # max rel-L2 output error (mixed)
    paged: bool = False
    kv_frac: float = 0.3
    page_tokens: int = 16
    max_batch: int = 8


@dataclass
class SchedulerConfig:
    """ServingScheduler policy knobs."""
    preempt: bool = True
    rebalance: bool = False
    default_slack: float = 1.0
    fail_fast_after: int = 3
    shed_deadlines: bool = False


@dataclass
class HttpConfig:
    """Control-plane endpoint (serving/control_plane.py)."""
    enabled: bool = False
    host: str = "127.0.0.1"
    port: int = 8799            # 0 = ephemeral (the bound port is printed)


@dataclass
class ServeConfig:
    """The resolved, validated serving configuration (all layers merged)."""
    profile: Optional[str] = None       # which profile resolved this, if any
    arch: Optional[str] = None          # single-model serving
    models: List[str] = field(default_factory=list)   # multi-tenant set
    reduce: str = "smoke"
    workload: WorkloadConfig = field(default_factory=WorkloadConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    http: HttpConfig = field(default_factory=HttpConfig)

    # ------------------------------------------------------------ dict I/O
    @classmethod
    def from_dict(cls, data: Dict) -> "ServeConfig":
        """Build (and coerce) from a plain nested dict, rejecting unknown
        keys at every level with a did-you-mean hint."""
        return _build_dataclass(cls, data, path="")

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def model_names(self) -> List[str]:
        """The tenant set: ``models`` if given, else the single ``arch``."""
        if self.models:
            return list(self.models)
        return [self.arch] if self.arch else []

    # ---------------------------------------------------------- validation
    def validate(self) -> "ServeConfig":
        """Cross-field invariants; returns self so calls chain."""
        if self.reduce not in REDUCE_PRESETS:
            raise ConfigError(f"reduce={self.reduce!r} is not one of "
                              f"{list(REDUCE_PRESETS)}")
        rt = self.runtime
        if rt.store not in SERVE_STORES:
            raise ConfigError(f"runtime.store={rt.store!r} is not one of "
                              f"{list(SERVE_STORES)}")
        if rt.precision not in PRECISIONS:
            raise ConfigError(f"runtime.precision={rt.precision!r} is not "
                              f"one of {[p for p in PRECISIONS if p]} (or "
                              f"unset)")
        if rt.fidelity is not None and rt.fidelity <= 0:
            raise ConfigError(f"runtime.fidelity={rt.fidelity} must be > 0")
        if rt.precision == "mixed":
            if rt.store != "quant":
                raise ConfigError("runtime.precision='mixed' requires "
                                  "runtime.store='quant' (the plan "
                                  "parameterizes the quantized store)")
            if rt.fidelity is None:
                raise ConfigError("runtime.precision='mixed' requires a "
                                  "runtime.fidelity target (max rel-L2 "
                                  "output error, e.g. 1e-2)")
        if rt.executors < 1:
            raise ConfigError(f"runtime.executors={rt.executors} must be >= 1")
        if rt.prefetch_depth < 1:
            raise ConfigError(f"runtime.prefetch_depth={rt.prefetch_depth} "
                              f"must be >= 1")
        if not 0.0 <= rt.cache_frac < 1.0:
            raise ConfigError(f"runtime.cache_frac={rt.cache_frac} must be "
                              f"in [0, 1)")
        if not 0.0 <= rt.kv_frac < 1.0:
            raise ConfigError(f"runtime.kv_frac={rt.kv_frac} must be in [0, 1)")
        if rt.paged and rt.cache_frac + rt.kv_frac >= 1.0:
            raise ConfigError(
                f"runtime.cache_frac + runtime.kv_frac = "
                f"{rt.cache_frac + rt.kv_frac:g} leaves no block budget")
        if rt.budget_mb is not None and rt.budget_mb <= 0:
            raise ConfigError(f"runtime.budget_mb={rt.budget_mb} must be > 0")
        if self.scheduler.fail_fast_after < 1:
            raise ConfigError(
                f"scheduler.fail_fast_after={self.scheduler.fail_fast_after} "
                f"must be >= 1")
        if self.workload.requests < 1 or self.workload.prompt_len < 1:
            raise ConfigError("workload.requests and workload.prompt_len "
                              "must be >= 1")
        if not self.workload.priorities:
            raise ConfigError("workload.priorities must not be empty")
        if self.arch and self.models:
            raise ConfigError("set either arch (single model) or models "
                              "(multi-tenant), not both")
        names = self.model_names()
        if names:
            from repro_torch.configs import ARCHS      # lazy: keep import light
            for name in names:
                if name not in ARCHS:
                    hint = _did_you_mean(name, ARCHS)
                    raise ConfigError(f"unknown arch {name!r}{hint}")
        return self


# --------------------------------------------------------------- internals
def _did_you_mean(key: str, known) -> str:
    close = difflib.get_close_matches(key, list(known), n=2, cutoff=0.5)
    return f" — did you mean {' or '.join(repr(c) for c in close)}?" \
        if close else f" (known: {sorted(known)})"


def _hints(cls) -> Dict[str, type]:
    """Resolved field types (``from __future__ import annotations`` makes
    ``dataclasses.fields(...)[i].type`` a STRING; resolve to real types)."""
    return typing.get_type_hints(cls)


def config_fields(cls=ServeConfig, prefix: str = "") -> Dict[str, type]:
    """Flat ``section.key -> declared type`` map over the dataclass tree —
    the schema surface the env-var layer and the docs-drift checker walk."""
    out: Dict[str, type] = {}
    hints = _hints(cls)
    for f in dataclasses.fields(cls):
        t = hints[f.name]
        if dataclasses.is_dataclass(t):
            out.update(config_fields(t, prefix=f"{prefix}{f.name}."))
        else:
            out[f"{prefix}{f.name}"] = t
    return out


def coerce_value(value, target_type, path: str):
    """Coerce ``value`` (possibly a string from an env var) onto the
    declared field type. Raises ConfigError on a value that cannot be
    represented, instead of letting a stringly-typed '8' poison an int
    comparison three layers down."""
    origin = typing.get_origin(target_type)
    if origin is typing.Union:                  # Optional[x]
        args = [a for a in typing.get_args(target_type) if a is not type(None)]
        if value is None or (isinstance(value, str)
                             and value.lower() in ("", "none", "null")):
            return None
        return coerce_value(value, args[0], path)
    if origin in (list, List):
        (elem,) = typing.get_args(target_type) or (str,)
        if isinstance(value, str):              # "1,8" -> [1.0, 8.0]
            value = [v.strip() for v in value.split(",") if v.strip()]
        if not isinstance(value, (list, tuple)):
            raise ConfigError(f"{path}: expected a list, got {value!r}")
        return [coerce_value(v, elem, f"{path}[]") for v in value]
    if target_type is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            low = value.strip().lower()
            if low in ("1", "true", "yes", "on"):
                return True
            if low in ("0", "false", "no", "off"):
                return False
        raise ConfigError(f"{path}: expected a bool, got {value!r}")
    if target_type is int:
        if isinstance(value, bool) or not isinstance(value, (int, str)):
            raise ConfigError(f"{path}: expected an int, got {value!r}")
        try:
            return int(value)
        except ValueError:
            raise ConfigError(f"{path}: expected an int, got {value!r}") \
                from None
    if target_type is float:
        if isinstance(value, bool) or not isinstance(value, (int, float, str)):
            raise ConfigError(f"{path}: expected a float, got {value!r}")
        try:
            return float(value)
        except ValueError:
            raise ConfigError(f"{path}: expected a float, got {value!r}") \
                from None
    if target_type is str:
        if not isinstance(value, str):
            raise ConfigError(f"{path}: expected a string, got {value!r}")
        return value
    return value


def _build_dataclass(cls, data: Dict, path: str):
    if not isinstance(data, dict):
        raise ConfigError(f"{path or cls.__name__}: expected a mapping, "
                          f"got {data!r}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    hints = _hints(cls)
    kwargs = {}
    for key, value in data.items():
        if key not in fields:
            where = f"{path}{key}" if path else key
            raise ConfigError(f"unknown config key {where!r}"
                              f"{_did_you_mean(key, fields)}")
        sub = f"{path}{key}"
        t = hints[key]
        if dataclasses.is_dataclass(t):
            kwargs[key] = _build_dataclass(t, value or {}, f"{sub}.")
        else:
            kwargs[key] = coerce_value(value, t, sub)
    return cls(**kwargs)
