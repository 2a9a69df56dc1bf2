"""Stdlib-only HTTP control plane in front of :class:`ServingScheduler`.

The JAX package's ``repro/serving/control_plane.py`` over the port's
runtime and scheduler: the same routes, JSON bodies and status codes. A
model arriving over HTTP is built on the runtime's device.

Until now the only way to observe or drive the scheduler was from inside
the same Python process — every fleet scenario was a bespoke CLI
invocation frozen at process start. This module puts a small JSON/HTTP
surface (``http.server.ThreadingHTTPServer``; no dependencies) over the
EXISTING request IDs and runtime entry points, so scenarios are scripted
against a running serving process instead of rebuilt per flag combination:

  ==========  ==============================  ====================================
  method      path                            action
  ==========  ==============================  ====================================
  GET         ``/healthz``                    liveness + per-model breaker state
  GET         ``/metrics``                    Prometheus text (MetricsRegistry)
  GET         ``/v1/models``                  registered models + plans
  POST        ``/v1/submit``                  prefill request -> ``{"rid": n}``
  POST        ``/v1/generate``                generation request -> ``{"rid": n}``
  GET         ``/v1/requests/<rid>``          poll status/result
  POST        ``/v1/requests/<rid>/cancel``   queue-removal cancellation
  POST        ``/v1/models``                  RUNTIME model arrival (add + replan)
  POST        ``/v1/models/<name>/reset``     clear the model's circuit breaker
  POST        ``/v1/replan``                  live ``replan_budgets()`` trigger
  POST        ``/v1/shutdown``                graceful stop (drains the server)
  ==========  ==============================  ====================================

``/v1/submit`` accepts either explicit prompts (``{"model": "qwen2.5-3b",
"tokens": [[1,2,3], ...]}``) or a seeded random workload (``{"model": ...,
"requests": 2, "prompt_len": 32, "seed": 0}``) so clients do not ship
kilobytes of token JSON to reproduce a bench arm. Latency reported on poll
is the scheduler's own ``latency_s`` (arrival -> completion), so HTTP
polling cadence never distorts the serving numbers.

Runtime model arrival (``POST /v1/models``) is the FusedInf-style piece:
the handler builds the arch, registers it on the shared-ledger runtime,
and re-plans the block budgets — co-tenants keep serving; passes already
in flight keep their snapshotted block lists. Mutating routes serialize on
one lock; the data plane (submit/poll) stays lock-free on the scheduler's
own thread-safe queue.
"""
from __future__ import annotations

import functools
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.errors import ConfigError, RequestCancelled
from repro_torch.serving.engine import Request, pad_prompts
from repro_torch.serving.metrics import MetricsRegistry

__all__ = ["ControlPlane", "ENDPOINTS"]

# (METHOD, path-template) — the stable HTTP contract; the docs-drift
# checker verifies the documented endpoints against this list.
ENDPOINTS: Tuple[Tuple[str, str], ...] = (
    ("GET", "/healthz"),
    ("GET", "/metrics"),
    ("GET", "/v1/models"),
    ("POST", "/v1/submit"),
    ("POST", "/v1/generate"),
    ("GET", "/v1/requests/<rid>"),
    ("POST", "/v1/requests/<rid>/cancel"),
    ("POST", "/v1/models"),
    ("POST", "/v1/models/<name>/reset"),
    ("POST", "/v1/replan"),
    ("POST", "/v1/shutdown"),
)


class _ApiError(Exception):
    def __init__(self, status: int, msg: str):
        super().__init__(msg)
        self.status = status


def _default_build_model(arch: str, reduce: str, seed: int, device):
    """Build (model, params) for a runtime arrival from the arch registry,
    through ``launch/serve.py``'s ``scale_config``, its params made on
    ``device`` (the runtime's)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import scale_config
    from repro_torch.models.transformer import Model
    model = Model(scale_config(get_arch(arch), reduce))
    return model, model.init(seed, device=device)


class ControlPlane:
    """HTTP front for one (runtime, scheduler) pair.

    ``plan_shape`` is the (batch, seq) the runtime was planned with — model
    arrivals re-plan against the same shape. ``port=0`` binds an ephemeral
    port (read ``self.port`` after :meth:`start`). ``build_model(arch,
    reduce, seed)`` is the arrival factory, injectable for tests; by
    default it builds on the runtime's device."""

    def __init__(self, runtime, scheduler, metrics: Optional[MetricsRegistry]
                 = None, host: str = "127.0.0.1", port: int = 0,
                 plan_shape: Tuple[int, int] = (2, 32),
                 reduce: str = "smoke", workdir: Optional[str] = None,
                 build_model: Optional[Callable] = None):
        self.runtime = runtime
        self.scheduler = scheduler
        self.metrics = (metrics if metrics is not None
                        else MetricsRegistry(runtime, scheduler))
        self.host = host
        self.port = int(port)
        self.plan_shape = plan_shape
        self.reduce = reduce
        self.workdir = workdir
        self.build_model = build_model or functools.partial(
            _default_build_model, device=runtime.device)
        self._requests: Dict[int, Any] = {}      # rid -> ServingRequest
        self._gen_of: Dict[int, Request] = {}    # rid -> decode Request
        self._mutate = threading.Lock()          # add_model/replan serialize
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.shutdown_requested = threading.Event()

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "ControlPlane":
        handler = _make_handler(self)
        self._server = ThreadingHTTPServer((self.host, self.port), handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="swapnet-http", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __enter__(self) -> "ControlPlane":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ handlers
    def _model_or_404(self, name: str):
        if name not in self.runtime.models:
            raise _ApiError(404, f"unknown model {name!r}; registered: "
                                 f"{sorted(self.runtime.models)}")
        return self.runtime.models[name]

    def _build_batch(self, sm, body: Dict) -> Dict:
        cfg = sm.cfg
        if "tokens" in body:
            rows = body["tokens"]
            if (not isinstance(rows, list) or not rows
                    or not all(isinstance(r, list) and r for r in rows)):
                raise _ApiError(400, "tokens must be a non-empty list of "
                                     "non-empty token lists")
            hi = cfg.vocab_size
            if any(not (0 <= int(t) < hi) for r in rows for t in r):
                raise _ApiError(400, f"token id out of range [0, {hi})")
            reqs = [Request(i, [int(t) for t in r])
                    for i, r in enumerate(rows)]
        else:
            n = int(body.get("requests", 1))
            plen = int(body.get("prompt_len", self.plan_shape[1]))
            if n < 1 or plen < 1:
                raise _ApiError(400, "requests and prompt_len must be >= 1")
            rng = np.random.default_rng(int(body.get("seed", 0)))
            reqs = [Request(i, list(map(int, rng.integers(0, cfg.vocab_size,
                                                          plen))))
                    for i in range(n)]
        return pad_prompts(cfg, reqs)

    def h_submit(self, body: Dict) -> Dict:
        name = body.get("model")
        if not name:
            raise _ApiError(400, "missing 'model'")
        sm = self._model_or_404(name)
        batch = self._build_batch(sm, body)
        req = self.scheduler.submit(
            name, batch, priority=float(body.get("priority", 1.0)),
            deadline=(float(body["deadline"]) if body.get("deadline")
                      is not None else None))
        self._requests[req.rid] = req
        return {"rid": req.rid, "model": name,
                "batch_shape": [int(x) for x in batch["tokens"].shape]}

    def h_generate(self, body: Dict) -> Dict:
        name = body.get("model")
        if not name:
            raise _ApiError(400, "missing 'model'")
        sm = self._model_or_404(name)
        prompt = body.get("prompt")
        if not isinstance(prompt, list) or not prompt:
            raise _ApiError(400, "generate wants 'prompt': [token, ...]")
        if any(not (0 <= int(t) < sm.cfg.vocab_size) for t in prompt):
            raise _ApiError(400, f"token id out of range "
                                 f"[0, {sm.cfg.vocab_size})")
        gen = Request(0, [int(t) for t in prompt],
                      max_new_tokens=int(body.get("max_new_tokens", 16)))
        try:
            req = self.scheduler.submit_generate(
                name, gen, priority=float(body.get("priority", 1.0)),
                deadline=(float(body["deadline"]) if body.get("deadline")
                          is not None else None))
        except (ValueError, AssertionError) as e:   # e.g. kv_frac == 0
            raise _ApiError(409, f"generate unavailable for {name!r}: {e}")
        gen.rid = req.rid       # one id namespace for the HTTP client
        self._requests[req.rid] = req
        self._gen_of[req.rid] = gen
        return {"rid": req.rid, "model": name}

    def h_poll(self, rid: int, query: Dict) -> Dict:
        req = self._requests.get(rid)
        if req is None:
            raise _ApiError(404, f"unknown rid {rid}")
        out: Dict[str, Any] = {"rid": rid, "model": req.model,
                               "priority": req.priority, "kind": req.kind}
        if not req.done.is_set():
            out["status"] = "pending"
            return out
        if req.error is not None:
            out["status"] = ("cancelled"
                             if isinstance(req.error, RequestCancelled)
                             else "error")
            out["error"] = {"type": type(req.error).__name__,
                            "message": str(req.error)}
            return out
        out["status"] = "done"
        out["latency_s"] = req.latency_s
        if req.kind == "generate":
            gen = self._gen_of.get(rid)
            if gen is not None:
                out["output"] = [int(t) for t in gen.output]
        elif req.logits is not None:
            out["logits_shape"] = list(req.logits.shape)
            if query.get("logits"):        # opt-in: logits payloads are big
                out["logits"] = req.logits.detach().to(
                    "cpu", torch.float64).tolist()
        return out

    def h_cancel(self, rid: int) -> Dict:
        if rid not in self._requests:
            raise _ApiError(404, f"unknown rid {rid}")
        return {"rid": rid, "cancelled": bool(self.scheduler.cancel(rid))}

    def h_models_get(self) -> Dict:
        models = {}
        for name, sm in self.runtime.models.items():
            down = self.scheduler.model_down(name)
            models[name] = {
                "arch": sm.cfg.name,
                "store": sm.store_backend,
                "precision": sm.precision,
                "n_blocks": sm.plan.n_blocks if sm.plan else None,
                "m": sm.plan.m if sm.plan else None,
                "up": down is None,
                "down_reason": str(down) if down is not None else None,
            }
        return {"models": models}

    def h_add_model(self, body: Dict) -> Dict:
        arch = body.get("arch")
        if not arch:
            raise _ApiError(400, "missing 'arch'")
        name = body.get("name") or arch
        if self.workdir is None:
            raise _ApiError(409, "this control plane has no workdir for "
                                 "model arrivals")
        with self._mutate:
            if name in self.runtime.models:
                raise _ApiError(409, f"model {name!r} already registered")
            try:
                model, params = self.build_model(
                    arch, body.get("reduce", self.reduce),
                    seed=len(self.runtime.models))
            except KeyError as e:
                raise _ApiError(404, str(e))
            self.runtime.add_model(name, model, params, self.workdir,
                                   store_backend=body.get("store"),
                                   precision=body.get("precision"))
            plans = self.runtime.plan(*self.plan_shape)
        return {"added": name, "arch": arch,
                "n_blocks": plans[name].n_blocks,
                "models": sorted(self.runtime.models)}

    def h_reset_model(self, name: str) -> Dict:
        self._model_or_404(name)
        self.scheduler.reset_model(name)
        return {"reset": name, "up": self.scheduler.model_down(name) is None}

    def h_replan(self, body: Dict) -> Dict:
        urgencies = body.get("urgencies") or self.scheduler.queue.urgency_mix()
        if not urgencies:
            # idle queue, no explicit mix: uniform re-split
            urgencies = {name: 1.0 for name in self.runtime.models}
        try:
            with self._mutate:
                budgets = self.runtime.replan_budgets(
                    {str(k): float(v) for k, v in urgencies.items()})
        except (ValueError, AssertionError) as e:
            raise _ApiError(409, f"replan rejected: {e}")
        return {"budgets_mb": {k: v / 1e6 for k, v in budgets.items()},
                "urgencies": urgencies}

    def h_healthz(self) -> Dict:
        models = {name: self.scheduler.model_down(name) is None
                  for name in self.runtime.models}
        return {"status": "ok" if all(models.values()) else "degraded",
                "models": models,
                "queue_depth": len(self.scheduler.queue)}

    def h_shutdown(self) -> Dict:
        self.shutdown_requested.set()
        return {"shutting_down": True}


# --------------------------------------------------------------- transport
def _make_handler(cp: ControlPlane):
    routes_get = [
        (re.compile(r"^/healthz$"), lambda m, q: cp.h_healthz()),
        (re.compile(r"^/v1/models$"), lambda m, q: cp.h_models_get()),
        (re.compile(r"^/v1/requests/(\d+)$"),
         lambda m, q: cp.h_poll(int(m.group(1)), q)),
    ]
    routes_post = [
        (re.compile(r"^/v1/submit$"), lambda m, b: cp.h_submit(b)),
        (re.compile(r"^/v1/generate$"), lambda m, b: cp.h_generate(b)),
        (re.compile(r"^/v1/requests/(\d+)/cancel$"),
         lambda m, b: cp.h_cancel(int(m.group(1)))),
        (re.compile(r"^/v1/models$"), lambda m, b: cp.h_add_model(b)),
        (re.compile(r"^/v1/models/([^/]+)/reset$"),
         lambda m, b: cp.h_reset_model(m.group(1))),
        (re.compile(r"^/v1/replan$"), lambda m, b: cp.h_replan(b)),
        (re.compile(r"^/v1/shutdown$"), lambda m, b: cp.h_shutdown()),
    ]

    class Handler(BaseHTTPRequestHandler):
        server_version = "swapnet-control/1"
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):      # noqa: D102 — quiet server
            pass

        def _reply(self, status: int, payload, content_type="application/json"):
            body = (payload if isinstance(payload, bytes)
                    else json.dumps(payload, sort_keys=True).encode())
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _dispatch(self, routes, payload):
            path, _, rawq = self.path.partition("?")
            query = dict(p.partition("=")[::2] for p in rawq.split("&") if p)
            cp.metrics.count_http(path)
            for pattern, fn in routes:
                m = pattern.match(path)
                if m:
                    try:
                        arg = query if payload is None else payload
                        return self._reply(200, fn(m, arg))
                    except _ApiError as e:
                        return self._reply(e.status, {"error": str(e)})
                    except ConfigError as e:
                        return self._reply(400, {"error": str(e)})
                    except Exception as e:      # noqa: BLE001 — API boundary
                        return self._reply(
                            500, {"error": f"{type(e).__name__}: {e}"})
            return self._reply(404, {"error": f"no route for {path}"})

        def do_GET(self):                       # noqa: N802 — http.server API
            path = self.path.partition("?")[0]
            if path == "/metrics":
                cp.metrics.count_http("/metrics")
                return self._reply(200, cp.metrics.render_prometheus().encode(),
                                   content_type="text/plain; version=0.0.4")
            return self._dispatch(routes_get, None)

        def do_POST(self):                      # noqa: N802 — http.server API
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length) if length else b""
            try:
                body = json.loads(raw) if raw else {}
            except json.JSONDecodeError as e:
                return self._reply(400, {"error": f"bad JSON body: {e}"})
            if not isinstance(body, dict):
                return self._reply(400, {"error": "body must be a JSON "
                                                  "object"})
            return self._dispatch(routes_post, body)

    return Handler
