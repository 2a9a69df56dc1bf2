"""Layered serving configuration (defaults -> profile -> env -> CLI).

``repro_torch.config`` owns HOW a serving process is assembled;
``repro_torch.configs`` (plural) owns the model architecture registry. An
arch config describes a network, a ServeConfig describes a deployment.
This package is the port's own copy of the JAX package's ``repro.config``
(which imports no JAX either): the same schema, profiles and layers, so a
configuration resolves to the same dict in both packages. The torch device
is not part of it: ``--device`` stays a flag of the launcher.

    from repro_torch.config import resolve_config
    cfg = resolve_config(profile="edge-tpu")         # + env + CLI overlays
    rt = MultiModelRuntime.from_config(cfg)
"""
from repro_torch.config.layering import (ENV_PREFIX, deep_merge,
                                         env_overlay, explain_layers,
                                         resolve_config)
from repro_torch.config.profiles import (PROFILES, profile_names,
                                         profile_overlay)
from repro_torch.config.schema import (PRECISIONS, REDUCE_PRESETS,
                                       SERVE_STORES, ConfigError, HttpConfig,
                                       RuntimeConfig, SchedulerConfig,
                                       ServeConfig, WorkloadConfig,
                                       config_fields)

__all__ = [
    "ServeConfig", "WorkloadConfig", "RuntimeConfig", "SchedulerConfig",
    "HttpConfig", "ConfigError", "resolve_config", "explain_layers",
    "deep_merge", "env_overlay", "config_fields", "PROFILES",
    "profile_names", "profile_overlay", "ENV_PREFIX", "REDUCE_PRESETS",
    "SERVE_STORES", "PRECISIONS",
]
