"""Checkpoints on the SwapNet flat store, the JAX package's
``training/checkpoint.py`` and its format: ``params.bin`` is one flat byte
buffer laid out as ``core/skeleton.py`` lays out a unit (each leaf at an
aligned offset, in the tree's leaf order), ``meta.json`` its refs
([offset, shape, dtype] per leaf) and byte count. A checkpoint either
package writes restores in the other.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from repro_torch.core.skeleton import Ref, Skeleton, assemble_np, write_flat
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten


def save(path: str, tree: Any) -> None:
    """Write ``tree`` (tensors on any device) as ``params.bin`` and
    ``meta.json`` under ``path``: leaf by leaf, the bytes of
    ``flatten_params`` without a host copy of the whole tree."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "params.bin"), "wb") as fh:
        skel, _ = write_flat(tree, fh)
    meta = {"refs": [[r.offset, list(r.shape), r.dtype] for r in skel.refs],
            "nbytes": skel.nbytes}
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump(meta, fh)


def restore(path: str, like: Any) -> Any:
    """The checkpoint at ``path`` in the structure of ``like``, each leaf on
    its ``like`` leaf's device, read through a memmap of ``params.bin``.
    Raises ``ValueError`` when the tensor count or a shape differs from
    ``like``'s (the reference asserts)."""
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    refs = [Ref(o, tuple(s), d) for o, s, d in meta["refs"]]
    leaves_like, treedef = tree_flatten(like)
    if len(refs) != len(leaves_like):
        raise ValueError(f"checkpoint has {len(refs)} tensors, tree expects "
                         f"{len(leaves_like)}")
    for r, leaf in zip(refs, leaves_like):
        if tuple(r.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint tensor at offset {r.offset} has "
                             f"shape {tuple(r.shape)}, tree expects "
                             f"{tuple(leaf.shape)}")
    buf = np.memmap(os.path.join(path, "params.bin"), dtype=np.uint8,
                    mode="c")
    host = assemble_np(Skeleton(treedef, refs, meta["nbytes"]), buf)
    return tree_unflatten(treedef, [
        t.to(leaf.device, copy=True)
        for t, leaf in zip(tree_leaves(host), leaves_like)])
