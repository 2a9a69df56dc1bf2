"""SwappedModel: end-to-end swapped inference of a model (paper §3).

Splits a model into swappable units (embedding, each layer, head), stores
them through a pluggable block store (``mmap`` | ``rawio`` | ``directio``
| ``quant`` | ``faulty``, see ``repro_torch.store``) and executes a
forward pass block by block under a memory budget with a depth-m
prefetch pipeline (m=2 is the paper's double buffer). On the ``mmap`` store the output is bit-identical to the
in-memory model (:meth:`SwappedModel.forward_unswapped`), the paper's
lossless property; the ``quant`` store trades a bounded quantization error
for 4x (int8) to 8x (int4) fewer swap-in bytes and keeps units
quantized-RESIDENT: 2-D matmul weights stream through the fused
dequant-matmul kernel, other consumers dequantize at use.

Engines may share a MemoryLedger and BlockCache with other models: the
multi-DNN serving path (``core/multi_model.py``) keeps several co-resident
models under ONE budget this way, each model's units named under its own
prefix so a shared cache never collides.

PyTorch queues device work asynchronously, so a block's memory is safe to
free only once the compute stream is done with it: :func:`swap_schedule`
waits for the device before every swap-out (the JAX package's
``block_until_ready`` at the same place). The ledger therefore never says
"freed" while a kernel still reads the bytes.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.cost_model import (DelayModel, LayerInfo, layer_flops,
                                         resident_infos)
from repro_torch.core.partition import BlockPlan, PartitionPlanner
from repro_torch.core.skeleton import assemble, flatten_params, torch_dtype
from repro_torch.core.swap_engine import BlockCache, MemoryLedger, SwapEngine
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels.qtensor import (QuantizedTensor, cast_unit_params,
                                         materialize_tree)
from repro_torch.kernels import swap_linear, swap_linear_q
from repro_torch.models.layers import linear, rms_norm, softcap
from repro_torch.models.transformer import (Model, alloc_layer_cache,
                                            apply_layer, layer_slice)
from repro_torch.store import build_store
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten


def swap_schedule(eng: SwapEngine, blocks, unit_names: Sequence[str], m: int):
    """Drive the depth-m prefetch pipeline over ``blocks``.

    Yields (block_index, lo, hi, handle) with the handle's block resident;
    swap-out happens after the caller's body returns control and the
    device has finished the body's work. Issues the load of block i only
    once block i-m has been freed, so at most m blocks are ever resident.
    """
    m = max(m, 1)
    futs: deque = deque()
    issued = 0

    def pump(limit: int) -> None:
        nonlocal issued
        while issued < min(limit, len(blocks)):
            lo, hi = blocks[issued]
            futs.append(eng.prefetch(list(unit_names[lo:hi])))
            issued += 1

    pump(m)
    try:
        for bi, (lo, hi) in enumerate(blocks):
            handle = eng.wait(futs.popleft())
            try:
                yield bi, lo, hi, handle
            finally:
                synchronize(eng.device)     # nothing may still read the block
                eng.swap_out(handle)
            pump(bi + 1 + m)
    finally:
        # abandoned mid-run: drain in-flight prefetches so their ledger
        # bytes and cache leases are released
        while futs:
            try:
                eng.swap_out(futs.popleft().result())
            except Exception:
                continue


@dataclass
class PassState:
    """A swapped forward pass, resumable at block boundaries: the
    activation, the position carrier and the index of the next block, so a
    preempted request re-executes nothing on resume. ``blocks`` and ``m``
    are snapshotted at pass start. ``caches`` (``collect_cache=True``)
    holds each layer's prefill cache by layer id (K/V, or a recurrent
    layer's final state), for a serving admit to seed the paged pool
    without a second pass."""
    blocks: List[Tuple[int, int]]
    m: int = 2
    x: Any = None
    positions: Any = None
    next_block: int = 0
    t_active: float = 0.0
    preemptions: int = 0
    logits: Any = None
    caches: Optional[Dict[int, Dict[str, torch.Tensor]]] = None

    @property
    def done(self) -> bool:
        return self.next_block >= len(self.blocks)


@dataclass
class Unit:
    name: str
    # embed | head | dense | moe | mamba2 | rwkv6 | shared_attn
    kind: str
    layer_id: Optional[int]
    params: dict


def split_units(model: Model, params: dict) -> List[Unit]:
    """The paper's get_layers(Net): one-time layer-wise division. Layer
    params are views of the stacked segments. The embed unit holds every
    input-side leaf the params have (``embed``, llama4's unread
    ``frontend`` stub), as the JAX package's does. zamba2's shared block
    gives one ``shared_attn`` unit per occurrence, all with one name and
    one param tree (stored once, pinned by :class:`SwappedModel`), each
    with its occurrence's layer id."""
    cfg = model.cfg
    units: List[Unit] = [Unit("embed", "embed", None,
                              {k: params[k] for k in
                               ("embed", "frontend", "mask_emb")
                               if k in params})]
    for si, seg in enumerate(model.plan):
        if not seg.scanned:
            units.append(Unit("shared_attn", "shared_attn", seg.layer_ids[0],
                              params["shared_attn"]))
            continue
        stacked = params["segments"][si]
        for j, lid in enumerate(seg.layer_ids):
            units.append(Unit(f"layer{lid:03d}_{seg.kind}", seg.kind, lid,
                              layer_slice(stacked, j)))
    tail = {"final_norm": params["final_norm"]}
    if "lm_head" in params:
        tail["lm_head"] = params["lm_head"]
    elif cfg.tie_embeddings:
        # tied head: materialize the transposed table in the head unit so
        # the embed block need not stay resident (storage, not memory, pays)
        tail["lm_head"] = params["embed"].T.contiguous()
    units.append(Unit("head", "head", None, tail))
    return units


def unit_infos(model: Model, units: Sequence[Unit], batch: int,
               seq: int) -> List[LayerInfo]:
    """Model info table rows (paper Table 2) aligned 1:1 with units."""
    cfg = model.cfg
    rows = []
    for u in units:
        leaves = tree_leaves(u.params)
        size = sum(l.numel() * l.element_size() for l in leaves)
        if u.kind == "embed":
            f = 2.0 * batch * seq * cfg.d_model
        elif u.kind == "head":
            f = 2.0 * batch * cfg.d_model * cfg.vocab_size
        else:
            f = layer_flops(cfg, u.kind, u.params, batch, seq)
        rows.append(LayerInfo(u.name, int(size), len(leaves), float(f)))
    return rows


def resolve_backend(cfg, store_backend: Optional[str],
                    mode: str = "snet") -> str:
    """Default the store backend to ``mmap`` and reject nonsensical
    combinations: the engine's ablation ``mode`` flags reinterpret the RAW
    file format, so they compose only with the mmap backend (rawio IS the
    copy_in arm; quant files cannot be read through the raw paths). A
    model that opts out of quantized swap units (``cfg.quant_eligible``)
    serves from the exact store; ``cfg=None`` (a unit list with no model
    config, :class:`SwappedSequential`) opts out of nothing."""
    backend = store_backend or "mmap"
    if backend != "mmap" and mode != "snet":
        raise ValueError(f"store backend {backend!r} requires mode='snet' "
                         f"(got mode={mode!r})")
    if backend == "quant" and cfg is not None and not cfg.quant_eligible:
        return "mmap"
    return backend


def store_opts(backend: str, precision: str = "int8",
               gpu_dispatch: bool = False) -> dict:
    """Per-backend build options. For ``quant``, ``precision`` picks the
    bit-width (int8 | int4, or ``mixed`` with a ``plan=`` in the store
    options) and units come back lazy: fused-routable weights stay
    quantized. ``store_options={"eager": True}`` selects eager dequant.
    ``rawio`` takes the dispatch-copy flag; ``faulty`` wraps ``mmap``
    unless the store options name another ``inner``."""
    if backend == "rawio":
        return {"gpu_dispatch": gpu_dispatch}
    if backend == "quant":
        if precision not in ("int8", "int4", "mixed"):
            raise ValueError(f"unknown precision {precision!r}")
        return {"bits": 4 if precision == "int4" else 8, "eager": False}
    if backend == "faulty":
        return {"inner": "mmap"}
    return {}


def kernel_smem_working_set(precision: str, dtype: str = "bfloat16") -> int:
    """Shared memory one block of the port's weight-stream matmul holds for
    a store precision: ``fp`` weights run ``swap_linear`` (a ring of x and
    w tiles in the compute dtype), quantized ones the fused dequant-matmul
    (a ring of x tiles and still-quantized weight tiles, plus for bf16 the
    two tiles the weight is widened into). ``mixed`` reports the int8
    figure, the larger of the quantized ones."""
    item = torch_dtype(dtype).itemsize
    if precision == "fp":
        return swap_linear.smem_bytes(item)
    bits = 4 if precision == "int4" else 8
    return swap_linear_q.smem_bytes(bits, item)


def _to_device_like(new, like, device: torch.device):
    """``new`` (a substituted unit from a ``param_override``) on ``device``
    in the dtypes of ``like``'s leaves: an extra device copy outside the
    ledger, dropped once the unit has run."""
    leaves, treedef = tree_flatten(new)
    dts = [leaf.dtype for leaf in tree_leaves(like)]
    return tree_unflatten(treedef, [
        torch.as_tensor(leaf).to(device, dt)
        for leaf, dt in zip(leaves, dts)])


class SwappedSequential:
    """Generic swapped executor over an arbitrary unit list: the paper's
    conv workloads (``models/vision.py``) and fc stacks.

    ``named_units``: ``[(name, params)]``; ``apply_fn(i, params, x) -> x``
    runs unit ``i``. A block is a plain loop over its units on the device
    (the JAX package jits one function a block); :func:`swap_schedule`
    waits for the device before each swap-out.

    ``precision`` / ``fused`` apply to the quant backend only, with the
    JAX package's meaning: ``fused=False`` (the default) dequantizes every
    quantized leaf at swap-in with ``dequant_int8`` (eager), ``fused=True``
    hands ``apply_fn`` :class:`QuantizedTensor` weights that
    ``models/layers.linear`` streams through ``swap_linear_q`` (other
    consumers materialize them at use; the store widens quantized leaves
    no linear streams on the loader). ``store_options`` overlays extra
    backend build options (``inner`` / ``p`` / ``seed`` for ``faulty``, a
    ``plan`` for ``precision="mixed"``).

    ``param_override(i, params) -> params`` (the calibration seam) runs on
    each swapped-in unit before ``apply_fn``; a substituted unit is copied
    to the device in the unit's dtypes."""

    def __init__(self, named_units, apply_fn, workdir: str,
                 mode: str = "snet", budget: Optional[int] = None,
                 gpu_dispatch: bool = False, prefetch_depth: int = 2,
                 ledger: Optional[MemoryLedger] = None,
                 cache: Optional[BlockCache] = None,
                 store_backend: Optional[str] = None,
                 precision: str = "int8", fused: bool = False,
                 store_options: Optional[dict] = None, device="cuda"):
        self.device = resolve_device(device)
        self.named_units = list(named_units)
        self.apply_fn = apply_fn
        self.prefetch_depth = max(prefetch_depth, 1)
        self.store_backend = resolve_backend(None, store_backend, mode)
        quant = self.store_backend == "quant"
        self.precision = precision if quant else "fp"
        self.fused = fused and quant
        opts = store_opts(self.store_backend, precision, gpu_dispatch)
        if quant:
            opts["eager"] = not fused
        opts.update(store_options or {})
        if self.precision == "mixed" and opts.get("plan") is None:
            raise ValueError("precision='mixed' needs a calibration plan: "
                             "pass store_options={'plan': ...} (see "
                             "repro_torch.calibrate.calibrate_sequential)")
        self.store = build_store(self.named_units, workdir,
                                 backend=self.store_backend,
                                 device=self.device, **opts)
        self.engine = SwapEngine(self.store, mode=mode, budget=budget,
                                 gpu_dispatch=gpu_dispatch, ledger=ledger,
                                 cache=cache)
        # the eager arm widens before the matmul, so its kernel streams fp
        # tiles: only the fused path earns the quantized figure
        self.engine.smem_working_set = kernel_smem_working_set(
            self.precision if self.fused else "fp", "float32")
        self.plan: Optional[BlockPlan] = None
        self.param_override: Optional[Any] = None

    def partition_with(self, infos, budget: int, dm: DelayModel,
                       delta: float = 0.05) -> BlockPlan:
        """Plan against RESIDENT unit costs (rows align 1:1 with the
        units): quantized swap units shrink the working set the budget
        must hold."""
        infos = resident_infos(infos, self.engine.store,
                               [n for n, _ in self.named_units])
        planner = PartitionPlanner(infos, dm, m=self.prefetch_depth)
        self.plan, self.table = planner.best_partition(budget, delta)
        self.planner = planner
        return self.plan

    def set_plan(self, points) -> None:
        self.plan = BlockPlan(tuple(points), len(self.named_units),
                              m=self.prefetch_depth)

    def forward(self, x) -> Tuple[torch.Tensor, Dict]:
        """Swapped forward pass of ``x`` (moved to the device). Returns
        (output, stats)."""
        if self.plan is None:
            raise RuntimeError("call partition_with()/set_plan() first")
        eng = self.engine
        names = [n for n, _ in self.named_units]
        x = torch.as_tensor(x).to(self.device)
        t_start = time.perf_counter()
        gen = swap_schedule(eng, self.plan.blocks(), names, self.plan.m)
        try:
            for bi, lo, hi, handle in gen:
                t0 = time.perf_counter()
                for i, p in zip(range(lo, hi), handle.params):
                    if self.param_override is not None:
                        new = self.param_override(i, p)
                        if new is not p:
                            p = _to_device_like(new, self.named_units[i][1],
                                                self.device)
                    x = self.apply_fn(i, p, x)
                synchronize(self.device)
                eng.record_exec(time.perf_counter() - t0)
        finally:
            gen.close()     # drains in-flight prefetches on early exit
        total = time.perf_counter() - t_start
        st = eng.stats
        return x, {"latency_s": total,
                   "peak_resident_mb": st.peak_resident / 1e6,
                   "peak_device_weights_mb": st.peak_device_weights / 1e6,
                   "t_in": list(st.t_in), "t_ex": list(st.t_ex),
                   "t_out": list(st.t_out),
                   "overlap_efficiency": st.overlap_efficiency(),
                   "cache_hit_rate": st.cache_hit_rate(),
                   "store_backend": self.store_backend,
                   "precision": self.precision,
                   "bytes_swapped": st.bytes_swapped,
                   "bytes_logical": st.bytes_logical,
                   "bytes_resident_quantized": st.bytes_resident_quantized,
                   "bytes_by_precision": dict(st.bytes_by_precision),
                   "smem_working_set": st.smem_working_set,
                   "retries": st.retries, "faults": dict(st.faults)}

    def close(self):
        self.engine.close()
        self.store.close()


class SwappedModel:
    """Executes prefill-equivalent inference by swapping blocks.

    ``mode`` / ``gpu_dispatch`` select the engine's ablation arm;
    ``ledger`` / ``cache`` join a shared budget and block cache; ``name``
    prefixes every unit name (``"<name>/embed"``) so several models can
    share one cache.

    A shared unit (zamba2's attention block) is stored once and pinned in
    the block cache: its first read stays charged to the ledger after its
    block, and its later occurrences are cache hits. As in the JAX
    package, :meth:`partition` does not reserve those bytes: a lone model
    whose ledger budget equals its plan budget can raise ``MemoryError``
    once the pinned unit is charged beside a block. Give the ledger the
    plan budget plus the pinned bytes, as
    ``MultiModelRuntime.block_budget`` reserves them."""

    def __init__(self, model: Model, params: dict, workdir: str,
                 budget: Optional[int] = None, prefetch_depth: int = 2,
                 store_backend: Optional[str] = None,
                 precision: Optional[str] = None,
                 store_options: Optional[dict] = None,
                 device="cuda", mode: str = "snet",
                 gpu_dispatch: bool = False,
                 ledger: Optional[MemoryLedger] = None,
                 cache: Optional[BlockCache] = None,
                 name: Optional[str] = None):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = model.cfg
        self.name = name or model.cfg.name
        self.prefetch_depth = max(prefetch_depth, 1)
        self.store_backend = resolve_backend(self.cfg, store_backend, mode)
        if self.store_backend == "quant":
            self.precision = precision or self.cfg.swap_precision
        else:
            self.precision = "fp"
        self.units = split_units(model, params)
        prefix = f"{name}/" if name else ""
        for u in self.units:
            u.name = prefix + u.name
        pinned = tuple(sorted({u.name for u in self.units
                               if u.kind == "shared_attn"}))
        store_units = list({u.name: u.params for u in self.units}.items())
        opts = store_opts(self.store_backend, self.precision, gpu_dispatch)
        opts.update(store_options or {})
        if self.precision == "mixed" and opts.get("plan") is None:
            raise ValueError("precision='mixed' needs a plan: pass "
                             "store_options={'plan': {unit: bits}}")
        self.store = build_store(store_units, workdir,
                                 backend=self.store_backend,
                                 device=self.device, **opts)
        self.engine = SwapEngine(self.store, mode=mode, budget=budget,
                                 gpu_dispatch=gpu_dispatch, pinned=pinned,
                                 ledger=ledger, cache=cache)
        self.engine.smem_working_set = kernel_smem_working_set(
            self.precision, self.cfg.dtype)
        self.plan: Optional[BlockPlan] = None
        # calibration seam (repro_torch/calibrate): fn(Unit, params) ->
        # params, applied in forward_partial's unit loop once the unit's
        # block is resident (see _overridden)
        self.param_override: Optional[Any] = None

    # ------------------------------------------------------------ partition
    def partition(self, budget: int, dm: DelayModel, batch: int, seq: int,
                  delta: float = 0.05) -> BlockPlan:
        infos = unit_infos(self.model, self.units, batch, seq)
        # the block-plan search sees the RESIDENT working set: quantized
        # units cost their payload, so one budget packs more layers a block
        infos = resident_infos(infos, self.engine.store,
                               [u.name for u in self.units])
        planner = PartitionPlanner(infos, dm, m=self.prefetch_depth)
        self.plan, self.table = planner.best_partition(budget, delta)
        self.planner = planner
        return self.plan

    def set_plan(self, points: Tuple[int, ...]) -> None:
        self.plan = BlockPlan(tuple(points), len(self.units),
                              m=self.prefetch_depth)

    # ------------------------------------------------------------ apply fns
    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def _head_logits(self, uparams: dict, h: torch.Tensor) -> torch.Tensor:
        """Final norm + lm_head projection in fp32; a quantized head streams
        through the fused kernel."""
        cfg = self.cfg
        h = rms_norm(h, uparams["final_norm"].to(h.dtype), cfg.norm_eps,
                     plus_one=cfg.post_norms)
        w = uparams["lm_head"]
        if isinstance(w, QuantizedTensor):
            logits = linear(h.to(torch.float32), w)
        else:
            logits = h.to(torch.float32) @ w.to(torch.float32)
        return softcap(logits, cfg.final_logit_softcap)

    def _apply_unit(self, unit: Unit, uparams: dict, x, positions, batch,
                    collect: Optional[dict] = None):
        cfg = self.cfg
        if unit.kind == "embed":
            # embeddings are gather consumers: dequantize at use
            return self.model._embed(materialize_tree(uparams), batch,
                                     "prefill")
        if unit.kind == "head":
            # every caller reads the last position only: projecting the
            # prompt's other positions would hold [B, S, vocab] fp32 logits
            # the ledger never sees (4.3 GB for gemma2-9b at S = 4,200)
            return self._head_logits(uparams, x[:, -1:]), positions
        p = cast_unit_params(uparams, torch_dtype(cfg.dtype))
        x, new_cache, _ = apply_layer(cfg, unit.kind, p, x, positions,
                                      cfg.is_local_layer(unit.layer_id), None,
                                      None, "prefill")
        if collect is not None:
            collect[unit.layer_id] = new_cache
        return x, positions

    def _overridden(self, unit: Unit, uparams):
        """``param_override(unit, uparams)``, its params on this model's
        device in the unit's own dtypes (:func:`_to_device_like`)."""
        new = self.param_override(unit, uparams)
        if new is uparams:
            return uparams
        return _to_device_like(new, unit.params, self.device)

    # ------------------------------------------------------------ decode
    def decode_loop(self, prompt_tokens, max_new_tokens: int = 8,
                    max_len: int = 128) -> Tuple[torch.Tensor, Dict]:
        """Greedy generation with WEIGHT-BLOCK STREAMING (paper §10): every
        decode step swaps the model's blocks through the memory window;
        only the decode caches (K/V, or a recurrent layer's state) and m
        weight blocks are resident at any time. The prompt is fed one token
        at a time, as in the JAX package.

        prompt_tokens: [B, S] ints. Returns (generated [B, max_new], stats).
        """
        if self.plan is None:
            raise RuntimeError("call partition()/set_plan() first")
        cfg = self.cfg
        dev = self.device
        prompt = torch.as_tensor(prompt_tokens).to(dev)
        B, S = prompt.shape
        dt = torch_dtype(cfg.dtype)
        caches = {i: alloc_layer_cache(cfg, u.kind, B, max_len, dev)
                  for i, u in enumerate(self.units) if u.layer_id is not None}
        unit_names = [u.name for u in self.units]

        def run_tokens(tokens, pos0):
            """Teacher-forced pass, one token at a time, swapped."""
            last_logits = None
            for t in range(tokens.shape[1]):
                batch = {"token": tokens[:, t:t + 1],
                         "pos": torch.full((B,), pos0 + t, dtype=torch.long,
                                           device=dev)}
                if cfg.rope_type == "mrope":
                    batch["positions"] = torch.full(
                        (B, 1, 3), pos0 + t, dtype=torch.long, device=dev)
                x = positions = None
                gen = swap_schedule(self.engine, self.plan.blocks(),
                                    unit_names, self.plan.m)
                try:
                    for bi, lo, hi, handle in gen:
                        for ui, p in zip(range(lo, hi), handle.params):
                            unit = self.units[ui]
                            if unit.kind == "embed":
                                x, positions = self.model._embed(
                                    materialize_tree(p), batch, "decode")
                            elif unit.kind == "head":
                                last_logits = self._head_logits(p, x)
                            else:
                                pc = cast_unit_params(p, dt)
                                x, caches[ui], _ = apply_layer(
                                    cfg, unit.kind, pc, x, positions,
                                    cfg.is_local_layer(unit.layer_id),
                                    caches[ui], batch["pos"], "decode")
                finally:
                    gen.close()     # drain in-flight prefetches now
            return last_logits

        t0 = time.time()
        logits = run_tokens(prompt, 0)
        out = []
        tok = logits[:, -1].argmax(dim=-1)[:, None]
        for step in range(max_new_tokens):
            out.append(tok)
            if S + step + 1 >= max_len or step == max_new_tokens - 1:
                break
            logits = run_tokens(tok, S + step)
            tok = logits[:, -1].argmax(dim=-1)[:, None]
        return torch.cat(out, dim=1), {
            "wall_s": time.time() - t0,
            "peak_resident_mb": self.engine.stats.peak_resident / 1e6}

    def decode_step_paged(self, batch: dict, view) -> torch.Tensor:
        """One BATCHED decode step through the paged KV cache (continuous
        batching, ``serving/batch_engine.py``): the weight blocks stream
        through the memory window once and their swap-in cost amortizes
        over every active sequence. Attention K/V land in the page pool via
        ``view`` (``serving/paged_kv.PagedBatchView``), so there is no
        contiguous per-batch cache and batch membership may change freely
        between steps.

        batch: ``{"token": [B, 1], "pos": [B]}`` (+ ``"positions"``
        [B, 1, 3] for M-RoPE). Returns last-position logits [B, 1, vocab].
        """
        if self.plan is None:
            raise RuntimeError("call partition()/set_plan() first")
        cfg = self.cfg
        eng = self.engine
        dt = torch_dtype(cfg.dtype)
        batch = self._to_device(batch)
        names = [u.name for u in self.units]
        x = positions = logits = None
        gen = swap_schedule(eng, self.plan.blocks(), names, self.plan.m)
        try:
            for bi, lo, hi, handle in gen:
                t0 = time.perf_counter()
                for ui, p in zip(range(lo, hi), handle.params):
                    unit = self.units[ui]
                    if unit.kind == "embed":
                        x, positions = self.model._embed(
                            materialize_tree(p), batch, "decode")
                    elif unit.kind == "head":
                        logits = self._head_logits(p, x)
                    else:
                        x, _, _ = apply_layer(
                            cfg, unit.kind, cast_unit_params(p, dt), x,
                            positions, cfg.is_local_layer(unit.layer_id),
                            None, batch["pos"], "decode",
                            paged=view.bind(unit.layer_id))
                synchronize(self.device)
                eng.record_exec(time.perf_counter() - t0)
        finally:
            gen.close()     # a raising step drains in-flight prefetches now
        return logits

    # ------------------------------------------------------------ forward
    def forward_partial(self, batch: dict, state: Optional[PassState] = None,
                        should_yield=None, collect_cache: bool = False
                        ) -> Tuple[PassState, Optional[Dict]]:
        """Swapped forward pass with block-boundary yield points.

        Runs blocks from ``state`` (fresh pass when None). After each block
        completes and is swapped out, ``should_yield(state)`` decides
        whether to pause: on True the pass returns ``(state, None)`` with
        in-flight prefetches drained. Resuming re-executes nothing, so a
        preempted pass stays bit-identical to an uninterrupted one. On
        completion ``state.logits`` holds the last-position logits and
        ``stats`` matches :meth:`forward`. With ``collect_cache`` a fresh
        pass keeps each layer's prefill cache in ``state.caches``: its K/V,
        or a recurrent (rwkv6, mamba2) layer's final state.
        """
        if self.plan is None:
            raise RuntimeError("call partition()/set_plan() first")
        eng = self.engine
        names = [u.name for u in self.units]
        batch = self._to_device(batch)
        if state is None:
            state = PassState(blocks=self.plan.blocks(), m=self.plan.m,
                              caches={} if collect_cache else None)

        t_start = time.perf_counter()
        pending = state.blocks[state.next_block:]
        gen = swap_schedule(eng, pending, names, state.m)
        try:
            for bi, lo, hi, handle in gen:
                t0 = time.perf_counter()
                for u, p in zip(self.units[lo:hi], handle.params):
                    if self.param_override is not None:
                        p = self._overridden(u, p)
                    state.x, state.positions = self._apply_unit(
                        u, p, state.x, state.positions, batch,
                        collect=state.caches)
                synchronize(self.device)
                eng.record_exec(time.perf_counter() - t0)
                state.next_block += 1
                if (should_yield is not None and not state.done
                        and should_yield(state)):
                    state.preemptions += 1
                    break
        finally:
            gen.close()     # drains in-flight prefetches on early exit
        state.t_active += time.perf_counter() - t_start
        if not state.done:
            return state, None
        x = state.x
        if x.ndim == 3 and x.shape[-1] == self.cfg.vocab_size:
            state.logits = x[:, -1:]
        else:
            state.logits = x
        st = eng.stats
        return state, {
            "latency_s": state.t_active,
            "preemptions": state.preemptions,
            "t_in": list(st.t_in), "t_ex": list(st.t_ex), "t_out": list(st.t_out),
            "peak_resident_mb": st.peak_resident / 1e6,
            "peak_device_weights_mb": st.peak_device_weights / 1e6,
            "meta_mb": self.store.meta_bytes() / 1e6,
            "overlap_efficiency": st.overlap_efficiency(),
            "cache_hit_rate": st.cache_hit_rate(),
            "store_backend": self.store_backend,
            "precision": self.precision,
            "bytes_swapped": st.bytes_swapped,
            "bytes_logical": st.bytes_logical,
            "bytes_resident_quantized": st.bytes_resident_quantized,
            "bytes_by_precision": dict(st.bytes_by_precision),
            "smem_working_set": st.smem_working_set,
            "retries": st.retries, "faults": dict(st.faults),
        }

    def forward(self, batch: dict) -> Tuple[torch.Tensor, Dict]:
        """Swapped forward pass. Returns (last-position logits, stats)."""
        state, stats = self.forward_partial(batch)
        return state.logits, stats

    def resident_units(self, unit_params: Optional[List[dict]] = None
                       ) -> List[Any]:
        """Every unit on the device at once, each laid out as one flat
        device buffer exactly as a swap-in lays it out (so the kernels see
        the same alignments). ``unit_params`` replaces the units' own
        params (e.g. :func:`repro_torch.store.quantized_store.roundtrip` of
        each, the reference for the quantized store)."""
        plist = unit_params or [u.params for u in self.units]
        resident = []
        for p in plist:
            buf, skel = flatten_params(p)
            resident.append(assemble(skel, torch.from_numpy(buf)
                                     .to(self.device)))
        return resident

    def forward_unswapped(self, batch: dict,
                          unit_params: Optional[List[dict]] = None,
                          resident: Optional[List[Any]] = None
                          ) -> torch.Tensor:
        """The in-memory model: every unit resident on the device at once
        (:meth:`resident_units`, or ``resident`` when the caller built them
        once for several batches), no store, no engine, no pipeline; the
        same per-unit computation as :meth:`forward`. Returns last-position
        logits."""
        batch = self._to_device(batch)
        if resident is None:
            resident = self.resident_units(unit_params)
        x = positions = None
        for u, p in zip(self.units, resident):
            x, positions = self._apply_unit(u, p, x, positions, batch)
        synchronize(self.device)
        return x[:, -1:]

    def close(self):
        self.engine.close()
        self.store.close()
