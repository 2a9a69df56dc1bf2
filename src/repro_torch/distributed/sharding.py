"""Sharding rules: logical axes -> mesh axes, with divisibility downgrade,
the JAX package's ``distributed/sharding.py`` on
``torch.distributed.device_mesh.DeviceMesh`` and DTensor placements.

Production meshes (``launch/mesh.py``):
    single-pod: (16, 16)        axes ("data", "model")
    multi-pod : (2, 16, 16)     axes ("pod", "data", "model")

Logical axes used by the model zoo:
    "residual" -> FSDP over "data" (weights gathered at use)
    "tp"       -> tensor parallel over "model" (heads / mlp hidden / vocab)
    "experts"  -> expert parallel over "model"
    None       -> replicated

The "pod" axis is pure data parallelism: parameter specs never name it,
batch specs include it when present in the mesh.

A :class:`PartitionSpec` names, per tensor dim, the mesh axis (a str), the
mesh axes (a tuple, major to minor) or None. :func:`placements` turns it
into one DTensor placement per mesh dim: a dim named by several mesh axes
is ``Shard(d)`` on each of them, which DTensor splits in mesh-dim order,
the order JAX splits a tuple entry in.

The model calls :func:`maybe_constrain` where a sharding must be fixed (the
reference's ``with_sharding_constraint``); it is a no-op unless a mesh is
installed with :func:`set_mesh` and the tensor is a DTensor, so every
unsharded caller runs exactly as before.

The hand kernels launch on ``data_ptr()``, which a DTensor does not have:
on a mesh each kernel call runs on the local shards through
:func:`run_local` (``local_map``), the reference's ``shard_map``, its
inputs' gradients placed by :func:`grad_placements`. A CPU mesh runs the
plain versions there, as a CPU tensor does everywhere.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.tree import tree_leaves, tree_map

POD_AXIS = "pod"
DATA_AXIS = "data"
MODEL_AXIS = "model"

# The batch dim's mesh axes (pure data parallelism); filter_spec drops
# "pod" on a single-pod mesh.
BATCH_AXES = (POD_AXIS, DATA_AXIS)

# Extents of the production mesh axes, used for the divisibility downgrade
# at param-def time.
PROD_AXIS_SIZES = {POD_AXIS: 2, DATA_AXIS: 16, MODEL_AXIS: 16}

RULES = {
    "residual": DATA_AXIS,
    "tp": MODEL_AXIS,
    "vocab": MODEL_AXIS,
    "experts": MODEL_AXIS,
    None: None,
}

Entry = Union[None, str, Tuple[str, ...]]


def _canon(entry) -> Entry:
    """A one-axis tuple is that axis, an empty one None (as JAX's
    ``PartitionSpec`` reads them)."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else entry
    return entry


class PartitionSpec(tuple):
    """Per-dim mesh axes of a tensor: a tuple of None, str or tuple of str.
    A leaf in spec trees (``tree_map(..., is_leaf=is_spec)``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canon(e) for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


P = PartitionSpec


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _axis_extent(mesh_axes: Union[str, Tuple[str, ...]]) -> int:
    if isinstance(mesh_axes, str):
        return PROD_AXIS_SIZES[mesh_axes]
    return math.prod(PROD_AXIS_SIZES[a] for a in mesh_axes)


def pspec(shape: Sequence[int], logical: Sequence[Optional[str]]
          ) -> PartitionSpec:
    """PartitionSpec for ``shape`` given per-dim logical axes.

    A dim whose extent is not divisible by its mesh-axis extent is
    replicated instead (explicit downgrade, never padding)."""
    if len(shape) != len(logical):
        raise ValueError(f"shape {tuple(shape)} and logical axes "
                         f"{tuple(logical)} differ in rank")
    out = []
    for dim, name in zip(shape, logical):
        mesh_ax = (RULES.get(name, None) if isinstance(name, (str, type(None)))
                   else name)
        if mesh_ax is None or dim % _axis_extent(mesh_ax) != 0:
            out.append(None)
        else:
            out.append(mesh_ax)
    return PartitionSpec(*out)


def _axis_names(mesh) -> Tuple[str, ...]:
    """A DeviceMesh's ``mesh_dim_names``, or the names of a mapping of
    axis sizes."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh)


def axis_sizes(mesh) -> dict:
    """{axis name: extent} of a DeviceMesh (or of such a dict itself)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh)


def batch_axes(mesh) -> Tuple[str, ...]:
    names = _axis_names(mesh)
    return tuple(a for a in (POD_AXIS, DATA_AXIS) if a in names)


def batch_spec(mesh, *trailing) -> PartitionSpec:
    """Spec for a [batch, ...] tensor: batch over (pod, data)."""
    return PartitionSpec(batch_axes(mesh), *trailing)


def filter_spec(spec: PartitionSpec, mesh) -> PartitionSpec:
    """Drop axes not present in ``mesh`` from a PartitionSpec."""
    names = set(_axis_names(mesh))

    def _f(entry):
        if entry is None:
            return None
        if isinstance(entry, str):
            return entry if entry in names else None
        kept = tuple(a for a in entry if a in names)
        return kept if kept else None

    return PartitionSpec(*[_f(e) for e in spec])


def specs_from_defs(defs):
    """Tree of ParamDef -> tree of their PartitionSpecs."""
    from repro_torch.models.params import is_def
    return tree_map(lambda d: d.spec(), defs, is_leaf=is_def)


def stack_specs(specs, n_leading: int = 1):
    """Prepend ``n_leading`` replicated dims (for stacked segments)."""
    return tree_map(lambda s: PartitionSpec(*((None,) * n_leading), *s),
                    specs, is_leaf=is_spec)


# --------------------------------------------------------------------------
# Mesh context: the model calls maybe_constrain() on large intermediates; it
# is a no-op unless the launcher installed a mesh.
# --------------------------------------------------------------------------
_CURRENT_MESH = None


def set_mesh(mesh) -> None:
    global _CURRENT_MESH
    _CURRENT_MESH = mesh


def get_mesh():
    return _CURRENT_MESH


def placements(spec: PartitionSpec, mesh, shape=None) -> list:
    """One DTensor placement per mesh dim: ``Shard(d)`` where tensor dim d
    names that mesh axis, else ``Replicate()``. Axes absent from ``mesh``
    are dropped first (:func:`filter_spec`); given the tensor's ``shape``,
    a dim its axes' extent does not divide is replicated (:func:`pspec`'s
    downgrade: DTensor would shard it unevenly)."""
    from torch.distributed.tensor import Replicate, Shard
    spec = filter_spec(spec, mesh)
    if shape is not None:
        sizes = axis_sizes(mesh)
        spec = PartitionSpec(*(
            e if e is None or shape[d] % math.prod(
                sizes[a] for a in ((e,) if isinstance(e, str) else e)) == 0
            else None for d, e in enumerate(spec)))
    out = [Replicate() for _ in mesh.mesh_dim_names]
    dims = {}
    for d, entry in enumerate(spec):
        for ax in ((entry,) if isinstance(entry, str) else entry or ()):
            if ax in dims:
                raise ValueError(f"{spec}: mesh axis {ax!r} shards two dims")
            dims[ax] = d
    # a tensor dim split over several mesh axes is split in the order the
    # entry names them; DTensor splits in mesh-dim order, so the entry's
    # order must be the mesh's
    for entry in spec:
        if isinstance(entry, tuple):
            idx = [mesh.mesh_dim_names.index(a) for a in entry]
            if idx != sorted(idx):
                raise ValueError(f"{spec}: {entry} is not in the mesh's "
                                 f"axis order {mesh.mesh_dim_names}")
    for ax, d in dims.items():
        out[mesh.mesh_dim_names.index(ax)] = Shard(d)
    return out


def maybe_constrain(x, spec: PartitionSpec):
    """``x`` redistributed to ``spec``'s placements (a dim they do not
    divide replicated) when a mesh is installed and ``x`` is a DTensor;
    ``x`` itself otherwise."""
    if _CURRENT_MESH is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh,
                          placements(spec, x.device_mesh, x.shape))


def batch_layout(*ts, decode: bool):
    """Tensors [B, ...] held batch-sharded with nothing else sharded
    (``maybe_constrain``; each returned as it is without a mesh): the
    inputs and outputs of the attention and SSM math, which then runs on
    each device's sequences whole. Outside decode the batch spreads over
    every mesh axis where it divides their product, else over (pod, data).

    The reference shards heads over "model" (or, where the heads do not
    divide it, the sequence); DTensor can do neither here: a dim sharded
    16 ways does not unflatten into heads 16 does not divide (qwen2.5-3b's
    2 KV heads, llama4's 40), and an einsum's bmm flattens (batch, heads)
    or (group, query) into one dim sharded on two mesh axes, a strided
    placement DTensor cannot size under FakeTensorMode."""
    if _CURRENT_MESH is None:
        return ts
    axes = BATCH_AXES
    if not decode and ts[0].shape[0] % _CURRENT_MESH.size() == 0:
        axes = tuple(_CURRENT_MESH.mesh_dim_names)
    return tuple(maybe_constrain(t, PartitionSpec(axes,
                                                  *(None,) * (t.ndim - 1)))
                 for t in ts)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor: the sharded path is chosen by the tensor
    itself, so plain local tensors run the plain path on a mesh too."""
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def full_tensor(t):
    """A DTensor's whole value as a plain tensor on every device (its
    ``full_tensor()``: a gather, differentiable); ``t`` itself otherwise."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def as_dtensor(t, mesh):
    """``t`` as a DTensor on ``mesh``: a plain tensor, which every device
    holds whole, replicated (its local tensor, no collective); a DTensor
    as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def is_shard(p, dim: Optional[int] = None) -> bool:
    """Whether placement ``p`` shards a tensor dim (``dim``, if given)."""
    from torch.distributed.tensor import Shard
    return isinstance(p, Shard) and (dim is None or p.dim == dim)


def batch_placements(*ts, what: str) -> list:
    """The placements DTensors ``ts`` share, each ``Shard(0)`` (the batch)
    or ``Replicate()``: the layout :func:`batch_layout` holds the inputs
    of attention and the SSM recurrences to. Any other layout raises
    ``ValueError``: a kernel's inputs are never redistributed silently."""
    pl = list(ts[0].placements)
    for t in ts:
        if (list(t.placements) != pl or t.device_mesh != ts[0].device_mesh
                or not all(is_shard(p, 0) or p.is_replicate() for p in pl)):
            raise ValueError(
                f"{what}: the inputs must share placements that shard the "
                f"batch (dim 0) and nothing else, got "
                f"{[tuple(t.placements) for t in ts]}")
    return pl


def grad_placements(placements: Sequence[Sequence]) -> list:
    """The gradient placements of a local function's inputs, from their
    forward placements: an input replicated on a mesh axis where another
    input is sharded met only that device's part of the other, so its
    local gradient there is a partial sum (``Partial``); every other
    gradient is placed as its input."""
    from torch.distributed.tensor import Partial
    sharded = [any(is_shard(pl[i]) for pl in placements)
               for i in range(len(placements[0]))]
    return [[Partial() if p.is_replicate() and sharded[i] else p
             for i, p in enumerate(pl)] for pl in placements]


def run_local(fn, tensors: Sequence, out_placements):
    """``fn`` on each device's local shards of ``tensors`` (DTensors on one
    mesh, taken in the placements they have) through ``local_map``; its
    outputs come back as DTensors with ``out_placements`` (one list, or a
    tuple of lists for several outputs). Plain tensors reach ``fn``, so a
    kernel wrapper inside it launches on ``data_ptr()`` (its plain version
    on the CPU), and autograd runs any ``autograd.Function`` it calls on
    local tensors too. The inputs' gradients are placed by
    :func:`grad_placements`."""
    from torch.distributed.tensor.experimental import local_map
    ins = [tuple(t.placements) for t in tensors]
    grads = tuple(tuple(g) for g in grad_placements(ins))
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(ins), in_grad_placements=grads,
                     device_mesh=tensors[0].device_mesh)(*tensors)


def gather_fsdp(w):
    """A weight's FSDP shards gathered at use (its "data" placement made
    ``Replicate``), tensor parallelism kept: the reference's rule for
    "residual" weights. ``w`` itself without a mesh, for a plain tensor or
    a weight not sharded over "data"."""
    if _CURRENT_MESH is None:
        return w
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    pl = list(w.placements)
    i = names.index(DATA_AXIS)
    if pl[i].is_replicate():
        return w
    pl[i] = Replicate()
    return w.redistribute(w.device_mesh, pl)


def local_shape(shape: Sequence[int], spec: PartitionSpec, mesh
                ) -> Tuple[int, ...]:
    """The shape of one device's shard. A sharded dim must divide by the
    extent of its mesh axes (the specs downgrade those that do not)."""
    sizes = axis_sizes(mesh)
    spec = filter_spec(spec, mesh)
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = (entry,) if isinstance(entry, str) else entry or ()
        ext = math.prod(sizes[a] for a in axes)
        if n % ext:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {axes} ({ext})")
        out.append(n // ext)
    return tuple(out)


def distribute(tree, specs, mesh):
    """Each leaf, a full tensor that every rank holds alike, as a DTensor
    on ``mesh`` with its spec's placements (``distribute_tensor``: each
    rank keeps its shard); a leaf that required grad still does."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    flat_specs = tree_leaves(specs, is_leaf=is_spec)
    leaves = tree_leaves(tree)
    if len(flat_specs) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves against {len(flat_specs)} "
                         f"specs")
    it = iter(flat_specs)

    def one(t):
        spec = next(it)
        if isinstance(t, DTensor):
            raise TypeError("distribute takes plain tensors")
        pl = placements(spec, mesh)
        return distribute_tensor(t.detach(), mesh, pl).requires_grad_(
            t.requires_grad)
    return tree_map(one, tree)


def from_local_struct(shape: Sequence[int], dtype: torch.dtype,
                      spec: PartitionSpec, mesh):
    """A DTensor of global ``shape`` whose local shard is a fresh
    ``torch.empty``: under ``FakeTensorMode`` a fake tensor, so nothing is
    allocated (the dry run's state, batch and cache)."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    local = torch.empty(local_shape(shape, spec, mesh), dtype=dtype)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def local_bytes(tree) -> int:
    """Bytes of each leaf's local shard (a plain tensor's own bytes),
    summed over the tree."""
    from torch.distributed.tensor import DTensor
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total
