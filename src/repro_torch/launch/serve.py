"""Serving entry point over the layered configuration (``repro_torch.config``).

Configuration resolves defaults -> device-class profile -> env
(``SWAPNET_*``) -> CLI, so a deployment is one flag:

    PYTHONPATH=src python -m repro_torch.launch.serve --profile mcu
        # one tenant on a calibrated mixed-precision quant store
    PYTHONPATH=src python -m repro_torch.launch.serve --profile edge-tpu
    PYTHONPATH=src python -m repro_torch.launch.serve --profile workstation
    PYTHONPATH=src python -m repro_torch.launch.serve --profile mcu --http
        # the same serving system behind the HTTP control plane
        # (submit / poll / cancel, /healthz, Prometheus /metrics)
    PYTHONPATH=src python -m repro_torch.launch.serve --profile mcu \
        --print-config      # the resolved config + the layers behind it

Every other flag is an override onto the resolved config and selects one
of the single-model or multi-model modes:

* swapped (``--budget-mb``): a swapped prefill under a weight budget, then
  greedy decode of a few tokens with the weights streamed per step;
* paged (``--paged --budget-mb``): continuous-batching decode through the
  paged KV cache, weight blocks and KV pages under ONE ledger;
* in-memory (neither): the plain engine, every weight resident;
* multi (``--multi a,b --budget-mb``): the tenants' swapped prefills
  interleaved round-robin under one shared ledger and block cache, each
  held to its tenant's unswapped logits;
* multi-scheduled (``--multi a,b --budget-mb --executors K``, K > 1): K
  executor threads over the same runtime, requests admitted by
  urgency-weighted deadline (``--priorities``, assigned round-robin) and
  lower classes preempted at block boundaries.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --reduce smoke --budget-mb 8 --requests 2 --prompt-len 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --reduce smoke --budget-mb 4 --store quant --precision int4 \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --reduce smoke --budget-mb 8 --store quant --precision mixed \
        --fidelity 2e-2 --device cpu    # calibrated per-unit precision
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --reduce smoke --budget-mb 24 --paged --kv-frac 0.3 --max-batch 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --reduce smoke --requests 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --reduce smoke --budget-mb 8 --prompt-len 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --multi qwen2.5-3b,gemma2-9b --reduce smoke --budget-mb 48 \
        --executors 2 --priorities 1,8 --store directio --device cpu

rwkv6 serves on the swapped and the in-memory paths (``--store quant``
resolves to mmap: it is quant-ineligible); ``--paged`` refuses it, as the
paged KV cache covers attention stacks only. Its chunked prefill takes
prompts of at most 16 tokens or a multiple of 16.

Runs on ``cuda`` unless ``--device`` says otherwise; without CUDA the
default raises. The flags are the JAX CLI's (``repro.launch.serve``) plus
``--device``, which stays outside the config.
"""
from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np
import torch

from repro_torch.config import (ServeConfig, explain_layers, profile_names,
                                resolve_config)
from repro_torch.configs import get_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import DelayModel
from repro_torch.core.multi_model import MultiModelRuntime
from repro_torch.core.runtime import SwappedModel
from repro_torch.core.serving_scheduler import ServingScheduler
from repro_torch.device import resolve_device
from repro_torch.launch.train import scale_config  # noqa: F401  (re-exported)
from repro_torch.models.transformer import Model
from repro_torch.serving.batch_engine import BatchDecodeEngine
from repro_torch.serving.control_plane import ControlPlane
from repro_torch.serving.engine import (MultiModelServingEngine, Request,
                                        ServingEngine, pad_prompts)
from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.paged_kv import PagedKVCache


def _percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, float), q)) if xs else 0.0


# ----------------------------------------------------------------- assembly
def _build_runtime(cfg: ServeConfig, workdir: str, device: torch.device):
    """Resolved config -> planned MultiModelRuntime (tenant i from seed i):
    the one construction path the multi-model modes share. A mixed-
    precision tenant calibrates inside ``add_model``. Returns (names,
    runtime, {name: model})."""
    names = cfg.model_names()
    rt = MultiModelRuntime.from_config(cfg, device=device)
    models = {}
    for i, arch in enumerate(names):
        model = Model(scale_config(get_arch(arch), cfg.reduce))
        rt.add_model(arch, model, model.init(i, device="cpu"), workdir)
        models[arch] = model
    rt.plan(batch=cfg.workload.requests, seq=cfg.workload.prompt_len)
    return names, rt, models


def _build_multi_runtime(cfg: ServeConfig, workdir: str,
                         device: torch.device):
    """The ``--multi`` setup: at least two tenants."""
    if len(cfg.model_names()) < 2:
        raise SystemExit("--multi wants at least two comma-separated archs")
    return _build_runtime(cfg, workdir, device)


def _make_batches(cfg: ServeConfig, models: dict, seed: int = 0) -> dict:
    """One padded prefill batch per tenant from the reference workload."""
    rng = np.random.default_rng(seed)
    batches = {}
    for arch, model in models.items():
        reqs = [Request(i, list(map(int, rng.integers(
                    0, model.cfg.vocab_size, cfg.workload.prompt_len))))
                for i in range(cfg.workload.requests)]
        batches[arch] = pad_prompts(model.cfg, reqs)
    return batches


def _mixed_store_options(cfg: ServeConfig, model: Model, params: dict,
                         device: torch.device):
    """With ``--precision mixed`` on the quant store, the calibration pass
    and ``{"plan": PrecisionPlan}`` for the swapped model's store; None
    where mixed does not apply (another precision or store, or a
    quant-ineligible arch that falls back to mmap)."""
    rt = cfg.runtime
    if (rt.precision != "mixed" or rt.store != "quant"
            or not model.cfg.quant_eligible):
        return None
    from repro_torch.calibrate import calibrate_model
    _, plan = calibrate_model(model, params, fidelity=rt.fidelity,
                              prefetch_depth=rt.prefetch_depth,
                              device=device)
    hist = plan.histogram()
    print(f"[calibrate] {model.cfg.name}: fidelity {rt.fidelity:g} "
          f"-> predicted_err {plan.predicted_err:.2e}, "
          f"stored {plan.stored_bytes/1e6:.2f} MB, units "
          f"fp={hist['fp']} int8={hist['int8']} int4={hist['int4']}",
          flush=True)
    return {"plan": plan}


# ------------------------------------------------------------ profile mode
def serve_profile(cfg: ServeConfig, device: torch.device) -> dict:
    """The config-driven path: every tenant through the priority-aware
    scheduler, priorities assigned round-robin from the workload; with
    ``runtime.paged`` also one generation per tenant per round through the
    continuous-batching engine."""
    classes = [float(p) for p in cfg.workload.priorities]
    budget = int(cfg.runtime.budget_mb * 1e6)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as d:
        names, rt, models = _build_runtime(cfg, d, device)
        try:
            batches = _make_batches(cfg, models)
            for arch in names:
                rt.forward(arch, batches[arch])                 # warm
            sched = ServingScheduler.from_config(rt, cfg)
            metrics = MetricsRegistry(rt, sched)
            submitted = []
            try:
                for round_i in range(cfg.workload.rounds):
                    for j, arch in enumerate(names):
                        k = round_i * len(names) + j
                        prio = classes[k % len(classes)]
                        submitted.append(sched.submit(arch, batches[arch],
                                                      priority=prio))
                        if cfg.runtime.paged:
                            gen = Request(1000 + k, list(map(int, rng.integers(
                                0, models[arch].cfg.vocab_size, 8))),
                                max_new_tokens=cfg.workload.new_tokens)
                            submitted.append(sched.submit_generate(
                                arch, gen, priority=prio))
                for r in submitted:
                    r.wait(timeout=600)
                by_class = sched.latency_by_class()
                quantiles = metrics.latency_quantiles()
            finally:
                sched.shutdown(timeout=600)
            st = rt.stats()
        finally:
            rt.close()
    peak = st["peak_resident_mb"] * 1e6
    print(f"[serve-profile] profile={cfg.profile}: {len(names)} model(s) "
          f"({', '.join(names)}), {cfg.runtime.executors} executor(s), "
          f"store={cfg.runtime.store}"
          f"{'/' + cfg.runtime.precision if cfg.runtime.precision else ''} "
          f"under {cfg.runtime.budget_mb:g} MB: "
          f"{len(submitted)} requests served, "
          f"peak resident {st['peak_resident_mb']:.1f} MB "
          f"({'OK' if peak <= budget else 'OVER'}), "
          f"preemptions={sched.preemptions}, device={device}", flush=True)
    print(f"[serve-profile] cache hit rate {st['cache_hit_rate']*100:.1f}% "
          f"({st['cache_hits']} hits / {st['cache_misses']} misses)",
          flush=True)
    for prio in sorted(by_class, reverse=True):
        q = quantiles[prio]
        print(f"[serve-profile]   priority {prio:g}: n={q['n']} "
              f"p50={q['p50_s']*1e3:.1f} ms p99={q['p99_s']*1e3:.1f} ms",
              flush=True)
    return {"requests": submitted, "stats": st, "peak": peak,
            "budget": budget, "preemptions": sched.preemptions,
            "latency_by_class": by_class}


def serve_http(cfg: ServeConfig, device: torch.device) -> dict:
    """Profile serving behind the HTTP control plane: build and warm the
    runtime ``serve_profile`` runs, then serve until ``POST /v1/shutdown``
    (or Ctrl-C). Everything observable in-process is scrapeable at
    ``/metrics``; requests submit / poll / cancel over plain JSON."""
    with tempfile.TemporaryDirectory() as d:
        names, rt, models = _build_runtime(cfg, d, device)
        try:
            batches = _make_batches(cfg, models)
            for arch in names:                                  # warm
                rt.forward(arch, batches[arch])
            sched = ServingScheduler.from_config(rt, cfg)
            cp = ControlPlane(rt, sched, MetricsRegistry(rt, sched),
                              host=cfg.http.host, port=cfg.http.port,
                              plan_shape=(cfg.workload.requests,
                                          cfg.workload.prompt_len),
                              reduce=cfg.reduce, workdir=d)
            try:
                cp.start()
                # the line clients parse: keep the format stable
                print(f"[serve-http] listening on {cp.url} "
                      f"(models: {', '.join(names)}; profile={cfg.profile}; "
                      f"POST /v1/shutdown to stop)", flush=True)
                try:
                    cp.shutdown_requested.wait()
                except KeyboardInterrupt:
                    pass
            finally:
                cp.stop()
                sched.shutdown(timeout=600)
            st = rt.stats()
        finally:
            rt.close()
    print(f"[serve-http] shut down cleanly: peak resident "
          f"{st['peak_resident_mb']:.1f} MB, "
          f"cache hit rate {st['cache_hit_rate']*100:.1f}%, "
          f"device={device}", flush=True)
    return {"stats": st, "url": cp.url}


# ------------------------------------------------------- multi-model modes
def _agreement(rt: MultiModelRuntime, arch: str, logits, batch) -> tuple:
    """(exact, cosine) of a swapped pass against the tenant's unswapped
    forward: exact stores must match bitwise; the quantized store's bounded
    error is reported as the cosine of the two logit vectors."""
    ref = rt.models[arch].forward_unswapped(batch)
    a = logits.double().flatten()
    b = ref.double().flatten()
    cos = float(a @ b / max(float(a.norm() * b.norm()), 1e-30))
    return bool(torch.equal(logits, ref)), cos


def serve_multi(cfg: ServeConfig, device: torch.device) -> dict:
    """Two or more models interleaved under ONE weight budget, one pass at
    a time (:class:`MultiModelServingEngine`): the paper's §6 multi-DNN
    scenario. The first round's logits are held to each tenant's unswapped
    forward; then peak residency against the budget, overlap efficiency
    and the cache hit rate."""
    budget = int(cfg.runtime.budget_mb * 1e6)
    rng = np.random.default_rng(0)
    exact, fidelity = True, {}
    with tempfile.TemporaryDirectory() as d:
        archs, rt, models = _build_multi_runtime(cfg, d, device)
        try:
            engine = MultiModelServingEngine(rt)
            for round_i in range(cfg.workload.rounds):
                for arch in archs:          # interleave tenants round-robin
                    reqs = [Request(i, list(map(int, rng.integers(
                                0, models[arch].cfg.vocab_size,
                                cfg.workload.prompt_len))))
                            for i in range(cfg.workload.requests)]
                    logits = engine.prefill(arch, reqs)
                    if round_i:
                        continue
                    same, cos = _agreement(
                        rt, arch, logits, pad_prompts(models[arch].cfg, reqs))
                    if rt.models[arch].store_backend == "quant":
                        fidelity[arch] = cos
                    else:
                        exact = exact and same
            st = rt.stats()
        finally:
            rt.close()
    parts = []
    if fidelity:
        parts.append(f"fidelity={min(fidelity.values()):.4f}")
    if len(fidelity) < len(archs):
        parts.append(f"lossless={exact}")
    peak = st["peak_resident_mb"] * 1e6
    print(f"[serve-multi] {len(archs)} models under "
          f"{cfg.runtime.budget_mb:.0f} MB (store={cfg.runtime.store}): "
          f"peak resident {st['peak_resident_mb']:.1f} MB "
          f"({'OK' if peak <= budget else 'OVER'}), {' '.join(parts)}, "
          f"device={device}", flush=True)
    print(f"[serve-multi] cache {st['cache_resident_mb']:.1f}/"
          f"{st['cache_capacity_mb']:.1f} MB, "
          f"hit rate {st['cache_hit_rate']*100:.1f}% "
          f"({st['cache_hits']} hits / {st['cache_misses']} misses)",
          flush=True)
    for name, ms in st["models"].items():
        print(f"[serve-multi]   {name}: blocks={ms['n_blocks']} m={ms['m']} "
              f"store={ms['store_backend']}/{ms['precision']} "
              f"overlap_eff={ms['overlap_efficiency']*100:.1f}% "
              f"swapped {ms['bytes_swapped_mb']:.1f} MB "
              f"({ms['bytes_logical_mb']:.1f} MB logical)", flush=True)
    return {"stats": st, "lossless": exact, "fidelity": fidelity,
            "peak": peak, "budget": budget}


def serve_multi_scheduled(cfg: ServeConfig, device: torch.device) -> dict:
    """K concurrent executors + priority-aware preemptive scheduling over
    the shared-budget runtime: requests carry an urgency class
    (``--priorities``, assigned round-robin) and are admitted by
    urgency-weighted deadline; lower classes yield at block boundaries to
    higher ones. Reports per-class p50 / p99 latency, the preemption count
    and every request's agreement with its tenant's unswapped model."""
    classes = [float(p) for p in cfg.workload.priorities]
    budget = int(cfg.runtime.budget_mb * 1e6)
    with tempfile.TemporaryDirectory() as d:
        archs, rt, models = _build_multi_runtime(cfg, d, device)
        try:
            batches = _make_batches(cfg, models)
            refs = {a: rt.models[a].forward_unswapped(batches[a])
                    for a in archs}
            for a in archs:
                rt.forward(a, batches[a])                   # warm
            sched = ServingScheduler.from_config(rt, cfg)
            submitted = []
            try:
                for round_i in range(cfg.workload.rounds):
                    for j, arch in enumerate(archs):
                        prio = classes[(round_i * len(archs) + j)
                                       % len(classes)]
                        submitted.append(sched.submit(arch, batches[arch],
                                                      priority=prio))
                for r in submitted:
                    r.wait(timeout=600)
            finally:
                sched.shutdown(timeout=600)
            exact = all(torch.equal(r.logits, refs[r.model])
                        for r in submitted
                        if rt.models[r.model].store_backend != "quant")
            st = rt.stats()
        finally:
            rt.close()
    peak = st["peak_resident_mb"] * 1e6
    print(f"[serve-sched] {len(archs)} models, {cfg.runtime.executors} "
          f"executors under {cfg.runtime.budget_mb:.0f} MB "
          f"(store={cfg.runtime.store}): peak "
          f"resident {st['peak_resident_mb']:.1f} MB "
          f"({'OK' if peak <= budget else 'OVER'}), lossless={exact}, "
          f"preemptions={sched.preemptions}, device={device}", flush=True)
    by_class = sched.latency_by_class()
    for prio in sorted(by_class, reverse=True):
        lat = [x * 1e3 for x in by_class[prio]]
        print(f"[serve-sched]   priority {prio:g}: n={len(lat)} "
              f"p50={_percentile(lat, 50):.1f} ms "
              f"p99={_percentile(lat, 99):.1f} ms", flush=True)
    return {"stats": st, "lossless": exact, "peak": peak, "budget": budget,
            "preemptions": sched.preemptions, "latency_by_class": by_class}


# ------------------------------------------------------ single-model modes
def serve_paged(cfg: ServeConfig, mcfg: ModelConfig, model: Model,
                params: dict, device: torch.device) -> dict:
    """Swap-aware continuous-batching decode: weight blocks are planned
    against (1 - kv_frac) of the budget and the KV page pool is sized from
    the rest, BOTH charged to one ledger that enforces the whole budget;
    page pressure preempts the youngest/lowest-priority sequences
    (recomputed on re-admission)."""
    rt, wl = cfg.runtime, cfg.workload
    budget = int(rt.budget_mb * 1e6)
    kv_bytes = int(budget * rt.kv_frac)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as d:
        sm = SwappedModel(model, params, d, budget=budget,
                          prefetch_depth=rt.prefetch_depth,
                          store_backend=rt.store, precision=rt.precision,
                          store_options=_mixed_store_options(cfg, model,
                                                             params, device),
                          device=device)
        try:
            sm.partition(budget - kv_bytes, DelayModel(), 1, wl.prompt_len)
            kv = PagedKVCache.for_budget(mcfg, sm.engine.ledger, kv_bytes,
                                         page_tokens=rt.page_tokens,
                                         device=device)
            be = BatchDecodeEngine(sm, kv, max_batch=rt.max_batch)
            reqs = [Request(i, list(map(int, rng.integers(
                        0, mcfg.vocab_size, wl.prompt_len))),
                        max_new_tokens=wl.new_tokens)
                    for i in range(wl.requests)]
            for r in reqs:
                be.submit(r)
            be.run_all()
            st = be.stats()
            peak = sm.engine.ledger.peak
        finally:
            sm.close()
    print(f"[serve-paged] {wl.requests} requests x {wl.new_tokens} new "
          f"tokens under {rt.budget_mb:.0f} MB "
          f"(kv_frac={rt.kv_frac:g}, {kv.max_pages} pages x "
          f"{kv.page_tokens} tok): {st['tok_per_s']:.2f} tok/s, "
          f"occupancy {st['mean_occupancy']*100:.0f}%, "
          f"preemptions {st['preemptions']:.0f}, "
          f"peak resident {peak/1e6:.1f} MB "
          f"({'OK' if peak <= budget else 'OVER'}), "
          f"KV pool on device {kv.pool_bytes/1e6:.1f} MB, "
          f"device={device}", flush=True)
    print(f"[serve-paged] sample output: {reqs[0].output[:12]}", flush=True)
    return {"requests": reqs, "stats": st, "peak": peak, "budget": budget}


def serve_in_memory(cfg: ServeConfig, mcfg: ModelConfig, model: Model,
                    params: dict, device: torch.device) -> dict:
    """The plain in-memory engine, every weight resident on ``device``."""
    wl = cfg.workload
    rng = np.random.default_rng(0)
    engine = ServingEngine(model, params, max_len=wl.max_len, device=device)
    reqs = [Request(i, list(map(int, rng.integers(0, mcfg.vocab_size,
                                                  wl.prompt_len))),
                    max_new_tokens=wl.new_tokens)
            for i in range(wl.requests)]
    engine.generate(reqs)                                   # warm
    reqs2 = [Request(100 + i, r.prompt, r.max_new_tokens)
             for i, r in enumerate(reqs)]
    stats = engine.generate(reqs2)
    print(f"[serve] {wl.requests} requests x {wl.new_tokens} new "
          f"tokens: prefill {stats['prefill_s']*1e3:.1f} ms, "
          f"{stats['tok_per_s']:.1f} tok/s decode, device={device}",
          flush=True)
    print(f"[serve] sample output: {reqs2[0].output[:12]}", flush=True)
    return {"requests": reqs2, "stats": stats}


def serve_swapped(cfg: ServeConfig, mcfg: ModelConfig, model: Model,
                  params: dict, device: torch.device) -> dict:
    """A swapped prefill under the weight budget, then greedy decode with
    the weights streamed per step."""
    rt, wl = cfg.runtime, cfg.workload
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(
        0, mcfg.vocab_size, (wl.requests, wl.prompt_len)), dtype=torch.int32)
    with tempfile.TemporaryDirectory() as d:
        sm = SwappedModel(model, params, d, budget=None,
                          prefetch_depth=rt.prefetch_depth,
                          store_backend=rt.store, precision=rt.precision,
                          store_options=_mixed_store_options(cfg, model,
                                                             params, device),
                          device=device)
        try:
            sm.partition(int(rt.budget_mb * 1e6), DelayModel(), wl.requests,
                         wl.prompt_len)
            sm.forward({"tokens": tokens})                      # warm
            sm.engine.stats.__init__()
            logits, stats = sm.forward({"tokens": tokens})
            print(f"[serve] swapped prefill: {stats['latency_s']*1e3:.1f} ms, "
                  f"peak resident {stats['peak_resident_mb']:.1f} MB "
                  f"(budget {rt.budget_mb:g} MB), "
                  f"blocks={sm.plan.n_blocks}, "
                  f"store={stats['store_backend']}/{stats['precision']}, "
                  f"swapped {stats['bytes_swapped']/1e6:.1f} MB "
                  f"({stats['bytes_logical']/1e6:.1f} MB logical, "
                  f"{stats['bytes_resident_quantized']/1e6:.1f} MB "
                  f"quantized-resident), "
                  f"kernel smem {stats['smem_working_set']} B, "
                  f"overlap_eff={stats['overlap_efficiency']*100:.1f}%, "
                  f"device={device}", flush=True)
            out = {"logits": logits, "stats": stats}
            if wl.new_tokens > 0:
                gen, dstats = sm.decode_loop(
                    tokens, max_new_tokens=wl.new_tokens,
                    max_len=wl.prompt_len + wl.new_tokens)
                print(f"[serve] decode {wl.requests} x {gen.shape[1]} "
                      f"tokens: {dstats['wall_s']*1e3:.1f} ms, "
                      f"peak resident {dstats['peak_resident_mb']:.1f} MB",
                      flush=True)
                print(f"[serve] sample output: {gen[0].tolist()}", flush=True)
                out["tokens"] = gen
        finally:
            sm.close()
    return out


def serve_single(cfg: ServeConfig, mode: str, device: torch.device) -> dict:
    """The single-arch modes: paged decode, swapped prefill, or the plain
    in-memory engine."""
    mcfg = scale_config(get_arch(cfg.arch), cfg.reduce)
    if not mcfg.supports_decode():
        raise SystemExit(f"{mcfg.name} is encoder-only: no decode serving")
    model = Model(mcfg)
    params = model.init(0, device="cpu")     # host: the store's source
    fn = {"paged": serve_paged, "swapped-prefill": serve_swapped,
          "plain": serve_in_memory}[mode]
    return fn(cfg, mcfg, model, params, device)


# ------------------------------------------------------------- entry point
def build_parser() -> argparse.ArgumentParser:
    """Every value-bearing flag defaults to None: only EXPLICITLY passed
    flags enter the CLI layer, everything else resolves through
    defaults -> profile -> env (see ``repro_torch.config.layering``)."""
    ap = argparse.ArgumentParser(
        description="SwapNet serving, PyTorch/CUDA port (layered config: "
                    "defaults -> profile -> SWAPNET_* env -> CLI)")
    ap.add_argument("--profile", default=None,
                    help=f"device-class deployment profile "
                         f"({', '.join(profile_names())}); every other flag "
                         f"overrides on top")
    ap.add_argument("--print-config", action="store_true",
                    help="print the resolved config (and the layers that "
                         "produced it) as JSON, then exit")
    ap.add_argument("--http", action="store_true", default=None,
                    help="serve behind the HTTP control plane "
                         "(submit/poll/cancel, /healthz, /metrics) until "
                         "POST /v1/shutdown")
    ap.add_argument("--http-host", default=None,
                    help="control-plane bind host (default 127.0.0.1)")
    ap.add_argument("--http-port", type=int, default=None,
                    help="control-plane port (0 = ephemeral; the bound "
                         "port is printed on startup)")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--multi", default=None,
                    help="comma-separated archs served interleaved under one "
                         "shared weight budget (requires --budget-mb)")
    ap.add_argument("--reduce", default=None,
                    choices=["smoke", "100m", "full"])
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--prompt-len", type=int, default=None)
    ap.add_argument("--new-tokens", type=int, default=None)
    ap.add_argument("--max-len", type=int, default=None,
                    help="decode cache capacity of the in-memory engine")
    ap.add_argument("--rounds", type=int, default=None,
                    help="multi-tenant round-robin passes (repeat requests "
                         "exercise the shared block cache)")
    ap.add_argument("--prefetch-depth", type=int, default=None,
                    help="pipeline residency m (1=serial, 2=double buffer)")
    ap.add_argument("--executors", type=int, default=None,
                    help="concurrent executor threads for --multi serving "
                         "(>1 runs the priority-aware preemptive scheduler; "
                         "each model's blocks are planned against a 1/K "
                         "slice of the block budget so K pipelines co-fit)")
    ap.add_argument("--priorities", default=None,
                    help="comma-separated urgency classes assigned "
                         "round-robin to --multi requests (e.g. '1,8'; "
                         "higher = more urgent: admitted earlier, preempts "
                         "lower classes at block boundaries)")
    ap.add_argument("--rebalance", action="store_true", default=None,
                    help="re-split the block budget (MultiDNNScheduler, "
                         "Eq. 1) whenever the queued urgency mix changes")
    ap.add_argument("--cache-frac", type=float, default=None,
                    help="fraction of the budget reserved for the shared "
                         "hot-block cache (multi-tenant mode)")
    ap.add_argument("--budget-mb", type=float, default=None,
                    help="SwapNet budget: stream weight blocks within it "
                         "(without it, and without --paged, the in-memory "
                         "engine serves)")
    ap.add_argument("--paged", action="store_true", default=None,
                    help="continuous-batching decode through the paged KV "
                         "cache (requires --budget-mb): weight blocks and "
                         "KV pages share one ledger, sequences admit/retire "
                         "at every decode step")
    ap.add_argument("--kv-frac", type=float, default=None,
                    help="fraction of --budget-mb reserved for KV pages in "
                         "--paged mode (the rest plans weight blocks)")
    ap.add_argument("--page-tokens", type=int, default=None,
                    help="tokens per KV page (one page spans all layers)")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="decode batch slots for --paged continuous batching")
    ap.add_argument("--store", default=None,
                    choices=["mmap", "rawio", "quant", "directio"],
                    help="block store: mmap (zero-copy, lossless), rawio "
                         "(read()-based ablation arm), quant (per-channel "
                         "quantized units kept quantized-resident; 2-D "
                         "weights stream through the fused dequant-matmul "
                         "kernel) or directio (O_DIRECT lossless reads that "
                         "bypass the page cache; buffered reads on "
                         "filesystems without O_DIRECT)")
    ap.add_argument("--precision", default=None,
                    choices=["int8", "int4", "mixed"],
                    help="quant-store precision (default: the arch's "
                         "swap_precision); mixed runs the calibration pass "
                         "and assigns int4 / int8 / fp PER UNIT against "
                         "the --fidelity target")
    ap.add_argument("--fidelity", type=float, default=None,
                    help="max rel-L2 model-output error the mixed-precision "
                         "plan may spend (e.g. 1e-2); required with "
                         "--precision mixed")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions of the kernels); not part of the config")
    return ap


def cli_overrides(args: argparse.Namespace) -> dict:
    """The CLI layer: only flags the user actually passed, mapped onto the
    nested config schema. ``--arch`` and ``--multi`` clear each other so a
    CLI choice cleanly overrides a profile's tenant set."""
    ov: dict = {}

    def put(section, key, value):
        if value is not None:
            ov.setdefault(section, {})[key] = value

    if args.arch is not None:
        ov["arch"] = args.arch
        ov["models"] = []
    if args.multi is not None:
        ov["models"] = [a.strip() for a in args.multi.split(",") if a.strip()]
        ov["arch"] = None
    if args.reduce is not None:
        ov["reduce"] = args.reduce
    put("workload", "requests", args.requests)
    put("workload", "prompt_len", args.prompt_len)
    put("workload", "new_tokens", args.new_tokens)
    put("workload", "max_len", args.max_len)
    put("workload", "rounds", args.rounds)
    if args.priorities is not None:
        ov.setdefault("workload", {})["priorities"] = [
            float(p) for p in args.priorities.split(",")]
    put("runtime", "budget_mb", args.budget_mb)
    put("runtime", "prefetch_depth", args.prefetch_depth)
    put("runtime", "cache_frac", args.cache_frac)
    put("runtime", "executors", args.executors)
    put("runtime", "store", args.store)
    put("runtime", "precision", args.precision)
    put("runtime", "fidelity", args.fidelity)
    put("runtime", "paged", args.paged)
    put("runtime", "kv_frac", args.kv_frac)
    put("runtime", "page_tokens", args.page_tokens)
    put("runtime", "max_batch", args.max_batch)
    put("scheduler", "rebalance", args.rebalance)
    put("http", "enabled", args.http)
    put("http", "host", args.http_host)
    put("http", "port", args.http_port)
    return ov


def dispatch_mode(cfg: ServeConfig) -> str:
    """Which serving path a resolved config takes (pure routing)."""
    if cfg.http.enabled:
        return "http"
    if cfg.profile:
        return "profile"
    if cfg.models:
        if cfg.runtime.budget_mb is None:
            raise SystemExit("--multi requires --budget-mb")
        return "multi-scheduled" if cfg.runtime.executors > 1 else "multi"
    if not cfg.arch:
        raise SystemExit("need --arch (single model), --multi a,b, or "
                         "--profile <name>")
    if cfg.runtime.paged:
        if cfg.runtime.budget_mb is None:
            raise SystemExit("--paged requires --budget-mb")
        return "paged"
    return "swapped-prefill" if cfg.runtime.budget_mb is not None else "plain"


def run_config(cfg: ServeConfig, device="cuda") -> dict:
    """Serve a resolved config on ``device``; returns what the mode
    printed."""
    mode = dispatch_mode(cfg)
    device = resolve_device(device)
    if mode == "http":
        return serve_http(cfg, device)
    if mode == "profile":
        return serve_profile(cfg, device)
    if mode == "multi-scheduled":
        return serve_multi_scheduled(cfg, device)
    if mode == "multi":
        return serve_multi(cfg, device)
    return serve_single(cfg, mode, device)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    overlay = cli_overrides(args)
    cfg = resolve_config(profile=args.profile, cli=overlay)
    if args.print_config:
        layers = [(name, ov) for name, ov in
                  explain_layers(profile=args.profile, cli=overlay)
                  if name != "defaults"]
        out = {"resolved": cfg.to_dict(), "mode": dispatch_mode(cfg),
               "layers": dict(layers)}
        print(json.dumps(out, indent=2, sort_keys=True))
        return out
    return run_config(cfg, args.device)


if __name__ == "__main__":
    main()
