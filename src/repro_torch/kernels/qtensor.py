"""QuantizedTensor: the quantized-RESIDENT form of a swapped weight.

What the quantized store hands the engine when eager dequant is off: the
int8 values (or packed int4 carrier) plus the per-channel fp32 scales, as
device tensors. Linear consumers (``models/layers.linear``: MLP in/out,
attention qkv/output projections, the LM head) feed it straight to the
fused dequant-matmul kernel (kernels/swap_linear_q.py), so fp never exists
for those weights; every other consumer dequantizes on the device at use
(:meth:`QuantizedTensor.dequant` / :func:`materialize`).

A plain class: tree functions that must treat it as one leaf pass
``is_leaf=is_quantized``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core.skeleton import torch_dtype
from repro_torch.kernels.dequant import dequant_int8
from repro_torch.tree import tree_flatten_with_path, tree_map, tree_unflatten

# param keys whose consumers route through models/layers.linear: these may
# stay quantized-resident; everything else dequantizes at use
FUSED_WEIGHT_KEYS = frozenset({"wi", "wi0", "wi1", "wo", "wq", "wk", "wv",
                               "lm_head"})


class QuantizedTensor:
    """Per-channel symmetric-quantized tensor (int8, or int4 packed two rows
    per int8 carrier byte; see kernels/dequant.pack_int4).

    ``q``      [R, C] int8 values (bits=8) or [ceil(R/2), C] carrier
               (bits=4), C = channels = last axis of ``shape``;
    ``scales`` [C] fp32;
    ``shape``/``dtype`` the logical tensor this dequantizes back to;
    ``bits``   8 or 4.
    """

    __slots__ = ("q", "scales", "shape", "dtype", "bits")

    def __init__(self, q: torch.Tensor, scales: torch.Tensor,
                 shape: Tuple[int, ...], dtype: str, bits: int = 8):
        if bits not in (8, 4):
            raise ValueError(f"bits must be 8 or 4, got {bits}")
        self.q = q
        self.scales = scales
        self.shape = tuple(shape)
        self.dtype = dtype
        self.bits = bits

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def rows(self) -> int:
        """Logical rows of the channel grid (prod of all but the last axis)."""
        return math.prod(self.shape[:-1]) if len(self.shape) > 1 else 1

    def dequant(self) -> torch.Tensor:
        """On-device reconstruction to the logical shape/dtype (the
        dequant-at-use path for non-matmul consumers)."""
        out = dequant_int8(self.q, self.scales, torch_dtype(self.dtype),
                           bits=self.bits, rows=self.rows)
        return out.reshape(self.shape)

    def __repr__(self) -> str:
        return (f"QuantizedTensor(int{self.bits}, shape={self.shape}, "
                f"dtype={self.dtype})")


def is_quantized(x) -> bool:
    return isinstance(x, QuantizedTensor)


def materialize(x):
    """Leaf -> tensor: dequantize a QuantizedTensor, pass a tensor through."""
    return x.dequant() if isinstance(x, QuantizedTensor) else x


def materialize_tree(tree):
    """Dequantize every QuantizedTensor leaf of a param tree."""
    return tree_map(materialize, tree, is_leaf=is_quantized)


def cast_unit_params(uparams, dtype: torch.dtype):
    """Compute-dtype cast of one swapped unit that KEEPS fused-routable
    weights quantized: 2-D weights under :data:`FUSED_WEIGHT_KEYS` stay
    :class:`QuantizedTensor` and stream through ``swap_linear_q``; every
    other leaf is dequantized on the device and floats are cast to
    ``dtype``. Runs on every pass (stored params are fp32)."""
    flat, treedef = tree_flatten_with_path(uparams, is_leaf=is_quantized)
    leaves = []
    for path, leaf in flat:
        if isinstance(leaf, QuantizedTensor):
            key = path[-1] if path else None
            if leaf.ndim == 2 and key in FUSED_WEIGHT_KEYS:
                leaves.append(leaf)
                continue
            leaf = leaf.dequant()
        if leaf.is_floating_point():
            leaf = leaf.to(dtype)
        leaves.append(leaf)
    return tree_unflatten(treedef, leaves)
