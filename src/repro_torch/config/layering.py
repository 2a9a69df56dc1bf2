"""Layered config resolution: defaults -> profile -> env -> CLI.

The merge semantics follow the layered-config pattern (SNIPPETS.md
Snippet 3, comfyui-remote's ``config/layering.py``):

  * **dicts recurse** — a profile that sets ``runtime.budget_mb`` does not
    clobber the default ``runtime.store`` next to it;
  * **scalars AND lists are last-wins** — a layer that sets
    ``workload.priorities`` REPLACES the list wholesale (element-wise
    merging of positional lists produces franken-configs nobody wrote).

The env layer reads ``SWAPNET_<SECTION>_<KEY>`` variables
(``SWAPNET_RUNTIME_BUDGET_MB=24``, ``SWAPNET_HTTP_PORT=9000``; top-level
keys drop the section: ``SWAPNET_ARCH``, ``SWAPNET_MODELS=a,b``,
``SWAPNET_REDUCE``). Values are coerced onto the declared field types —
``"2"`` becomes the int 2 for ``runtime.executors``, ``"1,8"`` becomes
``[1.0, 8.0]`` for ``workload.priorities`` — and an unknown ``SWAPNET_*``
variable is an error with a did-you-mean hint, not a silent no-op
(a typo'd env override that falls back to the default is invisible
exactly when you depend on it).

``resolve_config`` is the one entry point; ``explain_layers`` returns the
per-layer overlays for debugging (``repro_torch.launch.serve --print-config``).
"""
from __future__ import annotations

import copy
import difflib
import os
from typing import Dict, List, Mapping, Optional, Tuple

from repro_torch.config.profiles import profile_overlay
from repro_torch.config.schema import ServeConfig, config_fields
from repro_torch.errors import ConfigError

__all__ = ["deep_merge", "env_overlay", "resolve_config", "explain_layers",
           "ENV_PREFIX"]

ENV_PREFIX = "SWAPNET_"


def deep_merge(base: Dict, overlay: Mapping) -> Dict:
    """Merge ``overlay`` onto ``base`` (returns a new dict; inputs are not
    mutated): dicts recurse, scalars and lists last-wins."""
    out = copy.deepcopy(dict(base))
    for key, value in overlay.items():
        if (key in out and isinstance(out[key], dict)
                and isinstance(value, Mapping)):
            out[key] = deep_merge(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


def _env_key_map() -> Dict[str, Tuple[str, ...]]:
    """``SWAPNET_RUNTIME_BUDGET_MB`` -> ('runtime', 'budget_mb') for every
    field in the schema (top-level fields drop the section)."""
    mapping: Dict[str, Tuple[str, ...]] = {}
    for path in config_fields():
        parts = tuple(path.split("."))
        mapping[ENV_PREFIX + "_".join(p.upper() for p in parts)] = parts
    return mapping


def env_overlay(env: Optional[Mapping[str, str]] = None) -> Dict:
    """The env layer as a nested overlay dict. ``env=None`` reads
    ``os.environ``; pass ``{}`` for hermetic resolution (tests)."""
    env = os.environ if env is None else env
    mapping = _env_key_map()
    # SWAPNET_PROFILE selects the profile layer (handled by resolve_config)
    # and SWAPNET_ vars owned by other subsystems are not config keys
    ignored = {ENV_PREFIX + "PROFILE"}
    overlay: Dict = {}
    for name, raw in env.items():
        if not name.startswith(ENV_PREFIX) or name in ignored:
            continue
        if name not in mapping:
            close = difflib.get_close_matches(name, mapping, n=2, cutoff=0.5)
            hint = (f" — did you mean {' or '.join(close)}?" if close
                    else f" (known: {sorted(mapping)})")
            raise ConfigError(f"unknown config env var {name}{hint}")
        node = overlay
        *parents, leaf = mapping[name]
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = raw          # coerced by ServeConfig.from_dict
    return overlay


def explain_layers(profile: Optional[str] = None,
                   env: Optional[Mapping[str, str]] = None,
                   cli: Optional[Mapping] = None) -> List[Tuple[str, Dict]]:
    """The ordered ``(layer_name, overlay_dict)`` stack resolve_config
    merges, for debugging/printing. Defaults layer is the full dict."""
    env_map = os.environ if env is None else env
    profile = profile or env_map.get(ENV_PREFIX + "PROFILE") or None
    layers: List[Tuple[str, Dict]] = [
        ("defaults", ServeConfig().to_dict()),
    ]
    if profile:
        layers.append((f"profile:{profile}",
                       deep_merge({"profile": profile},
                                  profile_overlay(profile))))
    layers.append(("env", env_overlay(env)))
    if cli:
        layers.append(("cli", dict(cli)))
    return layers


def resolve_config(profile: Optional[str] = None,
                   env: Optional[Mapping[str, str]] = None,
                   cli: Optional[Mapping] = None) -> ServeConfig:
    """Resolve the full layered configuration into a validated
    :class:`ServeConfig`.

    ``profile`` — device-class profile name (CLI ``--profile``; falls back
    to ``$SWAPNET_PROFILE``); ``env`` — environment mapping (None = the
    real ``os.environ``; pass ``{}`` to resolve hermetically); ``cli`` —
    the nested overlay built from explicitly-passed CLI flags (the
    highest-precedence layer).
    """
    merged: Dict = {}
    for _name, overlay in explain_layers(profile, env, cli):
        merged = deep_merge(merged, overlay)
    return ServeConfig.from_dict(merged).validate()
