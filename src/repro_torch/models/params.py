"""Parameter definitions and their initialisation.

A :class:`ParamDef` gives a parameter's shape, its logical axes (for the
sharding rules) and init rule; trees of them
(nested dicts) are built once per model and turned into tensors by
:func:`init_from_defs`. Shapes and scales are the JAX package's
(``fan_in ** -0.5`` normal, 0.02 "small", zeros, ones), stored fp32; the
random numbers come from ``torch.Generator``s seeded per parameter path,
so they differ from ``jax.random``'s (parity tests hand the JAX params over
instead, see ``repro_torch.convert``).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.tree import keystr, tree_flatten_with_path, tree_unflatten


@dataclass(frozen=True)
class ParamDef:
    """``logical`` names each dim's logical axis ("residual", "tp",
    "vocab", "experts" or None, the JAX package's); :meth:`spec` maps it to
    mesh axes (``distributed/sharding.py``). It does not change the init."""
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...] = ()
    init: str = "normal"        # normal | zeros | ones | small

    def spec(self):
        from repro_torch.distributed.sharding import pspec
        return pspec(self.shape, self.logical or (None,) * len(self.shape))


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def _path_seed(seed: int, path: str) -> int:
    h = hashlib.sha256(f"{seed}:{path}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def init_from_defs(defs, seed: int, device: torch.device,
                   lead: Tuple[int, ...] = ()):
    """Tree of ParamDef -> tree of tensors of shape ``lead + def.shape``
    (``lead`` stacks layers of one segment); each leaf draws from its own
    generator, seeded from ``seed`` and its path."""
    flat, treedef = tree_flatten_with_path(defs, is_leaf=is_def)
    out = []
    dt = torch.float32
    for path, d in flat:
        shape = tuple(lead) + tuple(d.shape)
        if d.init == "zeros":
            out.append(torch.zeros(shape, dtype=dt, device=device))
            continue
        if d.init == "ones":
            out.append(torch.ones(shape, dtype=dt, device=device))
            continue
        if d.init == "small":
            scale = 0.02
        else:
            fan_in = d.shape[0] if len(d.shape) >= 2 else max(d.shape[-1], 1)
            scale = fan_in ** -0.5
        g = torch.Generator(device=device)
        g.manual_seed(_path_seed(seed, keystr(path)))
        w = torch.randn(shape, generator=g, dtype=dt, device=device)
        out.append(w.mul_(scale))
    return tree_unflatten(treedef, out)
