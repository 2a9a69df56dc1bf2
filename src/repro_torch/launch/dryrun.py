"""Dry run of the production meshes, the JAX package's ``launch/dryrun.py``
on DTensor: one train, prefill or decode step of an (arch, shape) traced
on a ``fake`` process group of 256 ranks, mesh (16, 16) ("data",
"model"), or 512 ranks, (2, 16, 16) with "pod".

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
        --shape decode_32k --out build/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --min-depth
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch h2o-danube-3-4b \\
        --shape decode_32k --windowed-kv --tag _wkv

The reference's three perf variants are flags that set the model's
switches for a run and reset them when it ends: ``--flash-decode``
(``attention.SHARDED_DECODE_AXIS``: ("pod", "data", "model") at batch 1,
else ("model",)), ``--windowed-kv`` (``transformer.WINDOWED_KV_CACHE``)
and ``--seq-parallel`` (``transformer.SEQ_PARALLEL_RESIDUAL``).

State, batch and (for decode) cache are DTensors whose local shards are
fake tensors (``FakeTensorMode``): nothing is allocated and no rank but
rank 0 exists; the fake group's collectives return at once. The step runs
the port's own code (``make_train_step``: loss, backward and AdamW;
``Model.prefill``; ``Model.decode_step``) with the mesh installed
(``distributed.sharding.set_mesh``), so the model's ``maybe_constrain``
calls take effect. Plain tensors the model makes (positions, masks,
accumulators) are treated as replicated (DTensor's
``implicit_replication``).

The tensors lie on the CPU, so every kernel wrapper takes its plain
PyTorch version, as the reference traces XLA math on host devices: the dry
run launches no kernel, and the wrappers have no branch for it. As on a
CUDA mesh, the wrappers get each device's local shards
(``distributed.sharding.run_local``).

Recorded, under the reference's keys where the meaning carries over:

* ``collectives``: per kind (all-reduce, all-gather, reduce-scatter,
  all-to-all, collective-permute) the count and the bytes of the results
  on one device, from the ``_c10d_functional`` collectives DTensor and
  the model issue (:class:`_LocalOps`); ``collective_max_bytes``, per
  kind, the largest single result;
* ``cost_analysis.flops``: the FLOPs one device runs on its local
  shards, each op counted by ``torch.utils.flop_counter``'s formulas
  below DTensor's dispatch (:class:`_LocalOps`), as the reference's
  per-device cost analysis counts them: work replicated over an axis is
  counted on each device;
* ``memory_analysis``: ``argument_size_in_bytes`` (the local shards of
  state, batch and cache), ``output_size_in_bytes`` (the local shards of
  what the step returns; ``alias_size_in_bytes`` of them are arguments
  updated in place) and ``temp_size_in_bytes``, the peak of live local
  bytes allocated during the step (:class:`_LiveBytes`); for decode also
  ``cache_size_in_bytes``, the cache's share of the arguments;
* ``trace_s`` (the reference's ``lower_s``; there is no compile), and
  ``n_params``, ``mode``, ``n_devices``, ``flops_analytic_per_dev``,
  ``tokens``, ``n_layers`` and ``torch``.

An error is recorded as ``status: "error"`` with its message, and
:func:`main` exits 1 if any combination failed.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import weakref
from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, SHAPES, applicable, get_arch, get_shape
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.flops import analytic_flops_per_device
from repro_torch.distributed.sharding import (from_local_struct, is_spec,
                                              local_bytes, set_mesh)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import Model, input_pspecs, input_specs
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import make_train_step, train_state_specs
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def _collective_kind(func) -> Optional[str]:
    """The reference's kind of a functional collective op DTensor issues,
    else None. DTensor issues no permutes, so "collective-permute" stays
    at 0 (the key is kept for the reference's schema)."""
    if func.namespace not in ("_c10d_functional", "_dtensor"):
        return None
    name = func.__name__.split(".")[0]
    for prefix, kind in (("all_reduce", "all-reduce"),
                         ("all_gather", "all-gather"),
                         ("reduce_scatter", "reduce-scatter"),
                         ("all_to_all", "all-to-all"),
                         ("shard_dim_alltoall", "all-to-all")):
        if name.startswith(prefix):
            return kind
    return None


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


class _LiveBytes:
    """Live local bytes of the storages the step allocates, and their
    peak. A storage is counted once from the first op that returns it and
    dropped when the last tensor on it dies (a weakref on the storage,
    whose Python object lives as long as the storage does)."""

    def __init__(self, known):
        self.known = {_local(t).untyped_storage()._cdata for t in known}
        self.refs: Dict[int, weakref.ref] = {}
        self.live = 0
        self.peak = 0

    def add(self, t: torch.Tensor) -> None:
        st = _local(t).untyped_storage()
        key = st._cdata
        if key in self.known or key in self.refs:
            return
        n = st.nbytes()

        def gone(_, key=key, n=n):
            self.refs.pop(key, None)
            self.live -= n
        self.refs[key] = weakref.ref(st, gone)
        self.live += n
        self.peak = max(self.peak, self.live)


class _GlobalOps(TorchDispatchMode):
    """Above DTensor's dispatch: sees each op once, with DTensor (global)
    arguments, and records the storages of its outputs' local shards."""

    def __init__(self, live: _LiveBytes):
        super().__init__()
        self.live = live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.live.add(t)
        return out


_SHARDING_PROP = "torch.distributed.tensor._sharding_prop"


def _shape_propagation() -> bool:
    """Whether the op being dispatched is DTensor's sharding propagation
    running it on fake tensors of the global shapes to learn the output's
    metadata (``torch.distributed.tensor._sharding_prop``): not the
    device's work."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_globals.get("__name__") == _SHARDING_PROP:
            return True
        f = f.f_back
    return False


class _LocalOps(TorchDispatchMode):
    """Below DTensor's dispatch (it returns NotImplemented for DTensor
    arguments, as ``CommDebugMode`` does, so DTensor runs first and its
    local ops and collectives come back here, as do the ops of a function
    run on local shards): counts each op's FLOPs and each collective and
    the bytes of its local result, and records the result's storage."""

    def __init__(self, live: _LiveBytes, coll: dict):
        super().__init__()
        self.live, self.coll = live, coll
        self.largest = dict.fromkeys(coll, 0)
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        count = flop_registry.get(func._overloadpacket)
        if count is not None and not _shape_propagation():
            self.flops += count(*args, **(kwargs or {}), out_val=out)
        kind = _collective_kind(func)
        if kind is not None:
            res = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            n = sum(t.numel() * t.element_size() for t in res)
            self.coll[kind]["count"] += 1
            self.coll[kind]["bytes"] += n
            self.largest[kind] = max(self.largest[kind], n)
            for t in res:
                self.live.add(t)
        return out


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A ``fake`` default process group of ``world_size`` ranks (this
    process is rank 0), destroyed on the way out."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def min_depth(cfg: ModelConfig) -> int:
    """The fewest layers whose (kind, local) pairs are all of the arch's:
    every layer kind and, for local / global patterns, both."""
    def pairs(c):
        return {(k, c.is_local_layer(i))
                for i, k in enumerate(c.layer_kinds())}
    want = pairs(cfg)
    for n in range(1, cfg.n_layers + 1):
        if pairs(dataclasses.replace(cfg, n_layers=n)) == want:
            return n
    return cfg.n_layers


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _sharded(struct, specs, mesh):
    """A tree of meta tensors -> DTensors of fake local shards."""
    leaves, treedef = tree_flatten(struct)
    flat_specs = tree_leaves(specs, is_leaf=is_spec)
    return tree_unflatten(treedef, [
        from_local_struct(t.shape, t.dtype, s, mesh)
        for t, s in zip(leaves, flat_specs)])


def build_step(cfg: ModelConfig, shape, mesh):
    """(fn, args, meta) for one step of ``cfg`` at ``shape`` on ``mesh``;
    call under FakeTensorMode. Serving params are in ``cfg.dtype``, the
    train state in fp32."""
    model = Model(cfg)
    batch = _sharded({k: _meta(shp, dt) for k, (shp, dt)
                      in input_specs(cfg, shape).items()},
                     input_pspecs(cfg, shape, mesh), mesh)
    cache_bytes = 0
    if shape.mode == "train":
        specs = train_state_specs(model)
        params = _sharded(model.param_struct(), specs["params"], mesh)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        state = {"params": params,
                 "mu": _sharded(model.param_struct(), specs["mu"], mesh),
                 "nu": _sharded(model.param_struct(), specs["nu"], mesh),
                 "step": 0}
        step = make_train_step(model, OptConfig())
        fn, args = step, (state, batch)
    elif shape.mode == "prefill":
        params = _sharded(model.param_struct(cfg.dtype), model.param_specs(),
                          mesh)
        fn, args = model.prefill, (params, batch)
    else:
        params = _sharded(model.param_struct(cfg.dtype), model.param_specs(),
                          mesh)
        cstruct = [{k: _meta(shp, dt) for k, (shp, dt) in seg.items()}
                   for seg in model.cache_struct(shape.global_batch,
                                                 shape.seq_len)]
        cache = _sharded(cstruct, model.cache_specs(shape, mesh), mesh)
        fn, args = model.decode_step, (params, cache, batch)
        cache_bytes = local_bytes(cache)
    n_params = sum(math.prod(t.shape)
                   for t in tree_leaves(model.param_struct()))
    n_dev = mesh.size()
    meta = {"n_params": n_params, "mode": shape.mode, "n_devices": n_dev,
            "flops_analytic_per_dev":
                analytic_flops_per_device(cfg, shape, n_dev),
            "tokens": shape.global_batch * (1 if shape.mode == "decode"
                                            else shape.seq_len),
            "n_layers": cfg.n_layers, "cache_size_in_bytes": cache_bytes}
    return fn, args, meta


def trace_step(fn, args, n_dev: int) -> dict:
    """Run ``fn(*args)`` under the counters; the measured part of a
    result row. The FLOPs are one device's (``flops``) and, over the
    ``n_dev`` devices of the mesh, ``flops_total``: replicated work counts
    on each device."""
    from torch.distributed.tensor.experimental import implicit_replication
    arg_leaves = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
    live = _LiveBytes(arg_leaves)
    coll = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
    local = _LocalOps(live, coll)
    with implicit_replication(), local, _GlobalOps(live):
        out = fn(*args)
    out_leaves = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    arg_keys = {_local(t).untyped_storage()._cdata for t in arg_leaves}
    alias = sum(_local(t).numel() * _local(t).element_size()
                for t in out_leaves
                if _local(t).untyped_storage()._cdata in arg_keys)
    return {"memory_analysis": {
                "argument_size_in_bytes": local_bytes(arg_leaves),
                "output_size_in_bytes": local_bytes(out_leaves),
                "alias_size_in_bytes": alias,
                "temp_size_in_bytes": live.peak},
            "cost_analysis": {"flops": local.flops,
                              "flops_total": local.flops * n_dev},
            "collectives": coll, "collective_max_bytes": local.largest}


def run_one(arch: str, shape_name: str, multi_pod: bool,
            out_dir: Optional[str] = None, verbose: bool = True,
            n_layers: Optional[int] = None, tag_suffix: str = "",
            flash_decode: bool = False, windowed_kv: bool = False,
            seq_parallel: bool = False) -> Dict:
    """Trace one (arch, shape) on the production mesh and return its row
    (written to ``out_dir`` when given). ``n_layers`` cuts the depth. The
    perf variants set the model's switches for this run only (module
    docstring); the row's ``variants`` names those set."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import transformer as tmod
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    cfg = get_arch(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    shape = get_shape(shape_name)
    variants = [name for name, on in (("flash_decode", flash_decode),
                                      ("windowed_kv", windowed_kv),
                                      ("seq_parallel", seq_parallel)) if on]
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
            "torch": torch.__version__, "variants": variants}
    with fake_process_group(512 if multi_pod else 256):
        try:
            if flash_decode:
                attn_mod.SHARDED_DECODE_AXIS = (
                    ("pod", "data", "model") if shape.global_batch == 1
                    else ("model",))
            tmod.WINDOWED_KV_CACHE = windowed_kv
            tmod.SEQ_PARALLEL_RESIDUAL = seq_parallel
            mesh = make_production_mesh(multi_pod=multi_pod)
            set_mesh(mesh)
            t0 = time.time()
            with FakeTensorMode():
                fn, args, meta = build_step(cfg, shape, mesh)
                measured = trace_step(fn, args, meta["n_devices"])
            result = {**base, "status": "ok",
                      "trace_s": round(time.time() - t0, 1),
                      **measured, **meta}
        except Exception as e:  # noqa: BLE001 -- recorded, not swallowed
            result = {**base, "status": "error",
                      "error": f"{type(e).__name__}: {e}"[:2000]}
        finally:
            set_mesh(None)
            attn_mod.SHARDED_DECODE_AXIS = None
            tmod.WINDOWED_KV_CACHE = False
            tmod.SEQ_PARALLEL_RESIDUAL = False
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}__{shape_name}__{mesh_tag}{tag_suffix}.json"
        with open(os.path.join(out_dir, tag), "w") as fh:
            json.dump(result, fh, indent=1)
    if verbose:
        if result["status"] == "ok":
            print(f"[dryrun] {arch} x {shape_name} x {mesh_tag}: OK "
                  f"flops/dev={result['cost_analysis']['flops']:.3e} "
                  f"trace={result['trace_s']}s", flush=True)
            print(f"  memory_analysis: {result['memory_analysis']}",
                  flush=True)
        else:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_tag}: FAILED "
                  f"{result['error']}", flush=True)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry-run (DTensor "
                                             "on a fake process group)")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every applicable (arch x shape) on this mesh; "
                         "with --arch or --shape, of that arch or shape")
    ap.add_argument("--min-depth", action="store_true",
                    help="cut each arch to the fewest layers that hold "
                         "every layer kind it has (min_depth)")
    ap.add_argument("--out", default="build/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="", help="suffix for the result file")
    ap.add_argument("--flash-decode", action="store_true",
                    help="perf variant: flash-decoding over the "
                         "sequence-sharded KV cache")
    ap.add_argument("--windowed-kv", action="store_true",
                    help="perf variant: ring-buffer KV cache for SWA archs")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="perf variant: sequence-parallel residual stream "
                         "(train memory)")
    args = ap.parse_args()
    variants = dict(flash_decode=args.flash_decode,
                    windowed_kv=args.windowed_kv,
                    seq_parallel=args.seq_parallel)

    if args.all:
        combos = [(a, s) for a in ARCHS for s in SHAPES
                  if args.arch in (None, a) and args.shape in (None, s)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        combos = [(args.arch, args.shape)]

    mesh_tag = "2x16x16" if args.multi_pod else "16x16"
    n_ok = n_skip = n_err = 0
    for a, s in combos:
        if not applicable(ARCHS[a], SHAPES[s]):
            print(f"[dryrun] {a} x {s}: SKIP (per DESIGN.md §5)", flush=True)
            n_skip += 1
            continue
        tag = os.path.join(args.out, f"{a}__{s}__{mesh_tag}{args.tag}.json")
        if args.skip_existing and os.path.exists(tag):
            with open(tag) as fh:
                if json.load(fh).get("status") == "ok":
                    n_ok += 1
                    continue
        depth = min_depth(ARCHS[a]) if args.min_depth else None
        r = run_one(a, s, args.multi_pod, args.out, n_layers=depth,
                    tag_suffix=args.tag, **variants)
        if r["status"] == "ok":
            n_ok += 1
        else:
            n_err += 1
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} failed",
          flush=True)
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
