"""Where a train step's device memory and time go: the unsharded step
against the same step on the (1, 1) mesh.

    python3 tools/torch_mesh_step_profile.py [--arch deepseek-v2-lite-16b]
        [--layers 2] [--steps 6]

The model at its published widths in its own dtype, the depth cut to
``--layers``, random weights from seed 0, ``SyntheticLM`` batches of 8 x
256 (``chip_smoke.py``'s phases 17 and 19); the port's train step
(``make_train_step``, AdamW). The mesh is ``chip_smoke.py``'s phase 19: a
one-rank NCCL group on loopback and the (1, 1) ("data", "model") CUDA
mesh, the state and batch placed by ``train_state_specs`` /
``input_pspecs``. The two paths run in turn, unsharded, mesh, unsharded,
mesh, each from a fresh state. Per path and round it prints:

- the state's device bytes (params and AdamW moments);
- each step's ms, a wait for the card after each (the recorded and the
  profiled step left out; step 0 of the first round builds the kernels);
- the peak of ``max_memory_allocated`` over the state in those steps;
- in the first round, one step recorded by the allocator's history
  (``torch.cuda.memory._record_memory_history``, Python stacks taken at
  each allocation): the
  bytes live at the step's peak, by the innermost frame of the repo that
  allocated them (an allocation with no Python frame is autograd's
  backward), largest first;
- one step under ``torch.profiler``: its kernels' device time against the
  step's wall time (the rest is the card waiting for the host).

Needs a CUDA card and nvcc (the kernels build on first use); exits 2
without a card.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

BATCH, SEQ = 8, 256
TOP = 14                 # frames printed per breakdown


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def frame_key(frames) -> str:
    """An allocation's key: its innermost frame in ``repro_torch`` (file
    and line) and, where torch code lies between that frame and the
    allocation, the innermost torch function; no Python frame at all:
    autograd's backward."""
    if not frames:
        return "(no Python frame: autograd's backward)"
    inner = None
    for f in frames:
        name = f.get("filename", "")
        if "/repro_torch/" in name:
            where = name[name.index("/repro_torch/") + 1:]
            key = f"{where}:{f.get('line')} {f.get('name')}"
            if inner is not None:
                key += f" < {inner}"
            return key
        if inner is None and "/torch/" in name:
            inner = f"torch/{name.split('/torch/')[-1]}:{f.get('name')}"
    return inner or f"{frames[0].get('filename')}:{frames[0].get('name')}"


def live_at_peak(trace) -> tuple:
    """Replays one device's allocator trace: (the largest sum of live
    traced bytes, {key: bytes live at that moment})."""
    live, total, peak, at_peak = {}, 0, 0, {}
    for ev in trace:
        act = ev.get("action")
        if act == "alloc":
            live[ev["addr"]] = (ev["size"], ev.get("frames", []))
            total += ev["size"]
            if total > peak:
                peak = total
                at_peak = dict(live)
        elif act in ("free_requested", "free_completed"):
            got = live.pop(ev["addr"], None)
            if got is not None:
                total -= got[0]
    by_key = collections.Counter()
    for size, frames in at_peak.values():
        by_key[frame_key(frames)] += size
    return peak, by_key


def device_ms(prof) -> float:
    """The profiled window's kernel, copy and fill time on the card, in ms
    (the events the profiler timed on the device; 0.0 where it saw none)."""
    from torch.autograd import DeviceType
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3


def run_path(torch, cfg, mesh, steps: int, detail: bool) -> dict:
    """``steps`` train steps of ``cfg`` from a fresh state, unsharded
    (``mesh`` None) or on ``mesh``; step 1 recorded by the allocator's
    history and step 2 profiled when ``detail``."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.sharding import (distribute, full_tensor,
                                                  set_mesh)
    from repro_torch.launch.train import default_opt
    from repro_torch.models.transformer import Model, input_pspecs
    from repro_torch.training.train_loop import (TrainState, make_train_step,
                                                 train_state_specs)
    torch.cuda.empty_cache()
    model = Model(cfg)
    params = model.init(0, device="cuda")
    if mesh is not None:
        params = distribute(params, train_state_specs(model)["params"], mesh)
    state = TrainState(params)
    del params
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    step = make_train_step(model, default_opt(steps, 3e-4))
    ds = SyntheticLM(cfg, SEQ, BATCH)
    shape = ShapeConfig("train", seq_len=SEQ, global_batch=BATCH,
                        mode="train")
    torch.cuda.reset_peak_memory_stats()
    out = {"state_gb": base / 1e9, "ms": []}
    set_mesh(mesh)
    try:
        with implicit_replication():
            for i in range(steps):
                b = {k: v.to("cuda") for k, v in ds.sample(i).items()}
                if mesh is not None:
                    b = distribute(b, input_pspecs(cfg, shape, mesh), mesh)
                torch.cuda.synchronize()
                record = detail and i == 1
                profiled = detail and i == 2
                if record:
                    # stacks at allocation only: a stack taken at a free
                    # inside a checkpoint's recompute, which stops early
                    # by raising, clears the exception in flight
                    torch.cuda.memory._record_memory_history(
                        context="alloc", stacks="python",
                        max_entries=2_000_000)
                t0 = time.perf_counter()
                if profiled:
                    from torch.profiler import ProfilerActivity, profile
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        state, m = step(state, b)
                        torch.cuda.synchronize()
                    out["prof_wall_ms"] = 1e3 * (time.perf_counter() - t0)
                    out["prof_device_ms"] = device_ms(prof)
                else:
                    state, m = step(state, b)
                    loss = float(full_tensor(m["loss"]))
                    torch.cuda.synchronize()
                    if not record:
                        out["ms"].append(1e3 * (time.perf_counter() - t0))
                if record:
                    snap = torch.cuda.memory._snapshot()
                    torch.cuda.memory._record_memory_history(enabled=None)
                    trace = snap["device_traces"][torch.cuda.current_device()]
                    out["traced_peak_gb"], by_key = live_at_peak(trace)
                    out["traced_peak_gb"] /= 1e9
                    out["at_peak"] = by_key
    finally:
        set_mesh(None)
    out["peak_over_state_gb"] = (torch.cuda.max_memory_allocated()
                                 - base) / 1e9
    out["loss"] = loss
    del state, m, b
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-v2-lite-16b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_smoke_mesh
    print(card_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    cfg = dataclasses.replace(get_arch(args.arch), n_layers=args.layers)
    print(f"{cfg.name} d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}, {args.layers} layers; batch {BATCH} x seq {SEQ}; "
          f"{args.steps} steps a round", flush=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_smoke_mesh("cuda")
        for rnd in range(2):
            for name, m in (("unsharded", None), ("mesh (1, 1)", mesh)):
                r = run_path(torch, cfg, m, args.steps, detail=rnd == 0)
                print(f"[{name}, round {rnd}] state {r['state_gb']:.3f} GB;"
                      f" steps (ms) {[round(x, 1) for x in r['ms']]}; peak "
                      f"over the state {r['peak_over_state_gb']:.3f} GB; "
                      f"loss {r['loss']:.4f}", flush=True)
                if rnd:
                    continue
                print(f"  profiled step: wall {r['prof_wall_ms']:.1f} ms, "
                      f"kernels on the card {r['prof_device_ms']:.1f} ms",
                      flush=True)
                print(f"  recorded step: {r['traced_peak_gb']:.3f} GB live "
                      f"at its peak over the state, by frame:", flush=True)
                for key, n in r["at_peak"].most_common(TOP):
                    print(f"    {n / 1e9:8.3f} GB  {key}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
