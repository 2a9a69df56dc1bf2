"""Parameters of the JAX package, handed over as numpy, as the port's.

``params_from_jax(np_tree)`` takes the tree of ``repro``'s ``Model.init``
with every leaf turned into a numpy array (``jax.tree.map(np.asarray,
params)``; this module never imports JAX) and returns the same tree with
torch leaves: the same keys, the same stacked ``segments`` layout, the
same bytes. Both packages then compute on identical weights, which is
what the parity tests need: ``torch.Generator`` cannot reproduce
``jax.random``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def _leaf(a) -> torch.Tensor:
    arr = np.array(a, copy=True)
    if str(arr.dtype) == "bfloat16":             # ml_dtypes, no numpy dtype
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(np_tree):
    """Nested dicts/lists of numpy arrays -> the same tree of tensors: a
    model's dict with its stacked segments, or a conv net's list of
    per-layer dicts (``{}`` for a pool or gap layer) as it is."""
    return tree_map(_leaf, np_tree)
