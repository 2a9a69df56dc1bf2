"""The HTTP control plane and the metrics registry of the port: the cases
of the JAX package's ``tests/test_control_plane.py`` against the port's
runtime and scheduler on the CPU (a real ThreadingHTTPServer on an
ephemeral port), plus the Prometheus text against the reference's for the
same samples and the route table against the reference's.

qwen2.5-3b ``reduced()``, float32, params from JAX ``Model.init`` handed
over as numpy. Tolerances: HTTP logits equal the in-process forward
bitwise (float32 through JSON float64 and back); ``/metrics`` numbers
equal the scheduler's internals exactly; rendered text equals the
reference's byte for byte.
"""
import dataclasses
import json
import tempfile
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro.serving.control_plane import ENDPOINTS as REF_ENDPOINTS  # noqa: E402
from repro.serving.metrics import METRIC_FAMILIES as REF_FAMILIES  # noqa: E402
from repro.serving.metrics import \
    render_prometheus as ref_render  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.multi_model import MultiModelRuntime  # noqa: E402
from repro_torch.core.serving_scheduler import ServingScheduler  # noqa: E402
from repro_torch.launch.serve import scale_config  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serving.control_plane import (ENDPOINTS,  # noqa: E402
                                               ControlPlane)
from repro_torch.serving.engine import Request, pad_prompts  # noqa: E402
from repro_torch.serving.metrics import (METRIC_FAMILIES,  # noqa: E402
                                         MetricsRegistry, render_prometheus)

ARCH = "qwen2.5-3b"


def _call(base, path, body=None, timeout=60.0):
    req = urllib.request.Request(
        base + path,
        data=(json.dumps(body).encode() if body is not None else None),
        headers={"Content-Type": "application/json"},
        method="POST" if body is not None else "GET")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        raw = resp.read()
        if "text/plain" in resp.headers.get("Content-Type", ""):
            return resp.status, raw.decode()
        return resp.status, json.loads(raw)


def _expect_error(base, path, status, body=None):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _call(base, path, body)
    assert ei.value.code == status, ei.value.read()
    return json.loads(ei.value.read() or b"{}")


def _poll_done(base, rid, deadline_s=120.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        _, out = _call(base, f"/v1/requests/{rid}")
        if out["status"] != "pending":
            assert out["status"] == "done", out
            return out
        time.sleep(0.02)
    raise AssertionError(f"rid {rid} still pending after {deadline_s}s")


def _tiny(seed=0):
    """A reduced float32 model of the port on the JAX package's params."""
    ref_cfg = dataclasses.replace(ref_get_arch(ARCH).reduced(),
                                  dtype="float32")
    params = RefModel(ref_cfg).init(jax.random.key(seed))
    model = Model(dataclasses.replace(get_arch(ARCH).reduced(),
                                      dtype="float32"))
    return model, params_from_jax(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def stack():
    """runtime + scheduler + control plane over ONE reduced model, with an
    injected arrival factory so add_model stays cheap."""
    model, params = _tiny()

    def build_model(arch, reduce, seed):
        return _tiny(seed=seed)

    with tempfile.TemporaryDirectory() as d:
        rt = MultiModelRuntime(budget=int(40e6), cache_frac=0.2,
                               device="cpu")
        rt.add_model(ARCH, model, params, d)
        rt.plan(batch=2, seq=16)
        sched = ServingScheduler(rt, preempt=True)
        cp = ControlPlane(rt, sched, host="127.0.0.1", port=0,
                          plan_shape=(2, 16), reduce="smoke", workdir=d,
                          build_model=build_model)
        try:
            with cp:
                yield model.cfg, rt, sched, cp, cp.url
        finally:
            sched.shutdown(timeout=60)
            rt.close()


def test_healthz_and_models(stack):
    _, rt, _, _, base = stack
    status, health = _call(base, "/healthz")
    assert status == 200
    assert health == {"status": "ok", "models": {ARCH: True},
                      "queue_depth": 0}
    _, out = _call(base, "/v1/models")
    info = out["models"][ARCH]
    assert info["up"] is True and info["store"] == "mmap"
    assert info["n_blocks"] == rt.models[ARCH].plan.n_blocks
    assert info["arch"] == rt.models[ARCH].cfg.name


def test_submit_poll_equals_in_process_forward_bitwise(stack):
    cfg, rt, _, _, base = stack
    rng = np.random.default_rng(3)
    rows = [[int(t) for t in rng.integers(0, cfg.vocab_size, 16)]
            for _ in range(2)]
    _, sub = _call(base, "/v1/submit", {"model": ARCH, "tokens": rows})
    assert sub["batch_shape"] == [2, 16]
    out = _poll_done(base, sub["rid"])
    assert out["latency_s"] > 0 and out["logits_shape"] == [2, 1,
                                                            cfg.vocab_size]
    _, full = _call(base, f"/v1/requests/{sub['rid']}?logits=1")
    got = torch.tensor(full["logits"], dtype=torch.float64).float()
    ref, _ = rt.forward(ARCH, pad_prompts(cfg, [Request(i, r)
                                                for i, r in enumerate(rows)]))
    assert torch.equal(got, ref)


def test_submit_seeded_random_workload(stack):
    _, _, _, _, base = stack
    _, sub = _call(base, "/v1/submit", {"model": ARCH, "requests": 3,
                                        "prompt_len": 8, "seed": 11,
                                        "priority": 4.0})
    out = _poll_done(base, sub["rid"])
    assert out["logits_shape"][0] == 3 and out["priority"] == 4.0


def test_cancel_or_complete(stack):
    _, _, _, _, base = stack
    _, sub = _call(base, "/v1/submit", {"model": ARCH, "requests": 1,
                                        "prompt_len": 8})
    _, res = _call(base, f"/v1/requests/{sub['rid']}/cancel", {})
    _, out = _call(base, f"/v1/requests/{sub['rid']}")
    if res["cancelled"]:
        assert out["status"] == "cancelled"
        assert out["error"]["type"] == "RequestCancelled"
    else:       # the executor won the race: the request completes cleanly
        _poll_done(base, sub["rid"])


def _prom_samples(text, family):
    """{tuple(sorted(label pairs)): value} for one metric family."""
    out = {}
    for line in text.splitlines():
        if not line.startswith(family) or line.startswith("#"):
            continue
        rest = line[len(family):]
        if rest[:1] not in ("{", " "):
            continue
        labels = ()
        if rest.startswith("{"):
            inner, _, rest = rest[1:].partition("}")
            labels = tuple(sorted(
                tuple(p.split("=", 1)) for p in inner.split(",") if p))
            labels = tuple((k, v.strip('"')) for k, v in labels)
        out[labels] = float(rest.strip())
    return out


def test_metrics_equal_scheduler_internals_exactly(stack):
    _, rt, sched, cp, base = stack
    by_class = sched.latency_by_class()
    quant = cp.metrics.latency_quantiles()
    assert by_class
    _, text = _call(base, "/metrics")
    got = _prom_samples(text, "swapnet_requests_completed_total")
    for prio, lats in by_class.items():
        assert got[(("priority", f"{prio:g}"),)] == float(len(lats))
    got = _prom_samples(text, "swapnet_request_latency_seconds")
    for prio, q in quant.items():
        key = ("priority", f"{prio:g}")
        assert got[(key, ("quantile", "0.5"))] == q["p50_s"]
        assert got[(key, ("quantile", "0.99"))] == q["p99_s"]
        assert q["p50_s"] == float(np.percentile(by_class[prio], 50))
    assert _prom_samples(text, "swapnet_cache_hit_rate")[()] == \
        float(rt.cache.hit_rate())
    assert _prom_samples(text, "swapnet_ledger_peak_bytes")[()] == \
        float(rt.ledger.peak)
    assert _prom_samples(text, "swapnet_preemptions_total")[()] == \
        float(sched.preemptions)
    assert _prom_samples(text, "swapnet_model_up")[(("model", ARCH),)] == 1.0
    assert _prom_samples(text, "swapnet_model_bytes_swapped_total")[
        (("model", ARCH),)] == float(rt.models[ARCH].engine.stats
                                     .bytes_swapped)


def test_metrics_content_type_and_families(stack):
    _, _, _, _, base = stack
    with urllib.request.urlopen(base + "/metrics", timeout=30) as resp:
        assert "text/plain" in resp.headers["Content-Type"]
        text = resp.read().decode()
    assert "# TYPE swapnet_ledger_occupancy gauge" in text
    assert "# HELP swapnet_cache_hit_rate" in text
    assert "swapnet_http_requests_total" in text


def test_add_model_then_serve_it(stack):
    _, rt, _, _, base = stack
    _, added = _call(base, "/v1/models", {"arch": ARCH, "name": "tenant-b"})
    assert added["added"] == "tenant-b" and "tenant-b" in added["models"]
    assert rt.models["tenant-b"].plan is not None            # replanned
    _, sub = _call(base, "/v1/submit", {"model": "tenant-b", "requests": 2,
                                        "prompt_len": 16})
    _poll_done(base, sub["rid"])
    _expect_error(base, "/v1/models", 409, {"arch": ARCH, "name": "tenant-b"})


def test_replan_and_reset_over_http(stack):
    _, rt, _, _, base = stack
    _, out = _call(base, "/v1/replan",
                   {"urgencies": {name: 1.0 for name in rt.models}})
    assert set(out["budgets_mb"]) == set(rt.models)
    assert all(v > 0 for v in out["budgets_mb"].values())
    _, out = _call(base, f"/v1/models/{ARCH}/reset", {})
    assert out == {"reset": ARCH, "up": True}
    _expect_error(base, "/v1/models/nope/reset", 404, {})


def test_error_surface(stack):
    _, _, _, _, base = stack
    _expect_error(base, "/v1/submit", 400, {})                  # no model
    _expect_error(base, "/v1/submit", 404, {"model": "ghost"})
    _expect_error(base, "/v1/submit", 400, {"model": ARCH,
                                            "tokens": [[999999]]})
    _expect_error(base, "/v1/requests/424242", 404)
    _expect_error(base, "/no/such/route", 404)
    # generate needs a KV reserve; this runtime has kv_frac=0 -> 409
    _expect_error(base, "/v1/generate", 409, {"model": ARCH,
                                              "prompt": [1, 2, 3]})
    req = urllib.request.Request(base + "/v1/submit", data=b"{nope",
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400


def test_generate_over_http_with_a_kv_reserve():
    """A runtime with a KV reserve serves /v1/generate through the paged
    engine; the tokens equal the same prompt served alone."""
    model, params = _tiny()
    with tempfile.TemporaryDirectory() as d:
        rt = MultiModelRuntime(budget=int(40e6), cache_frac=0.2, kv_frac=0.2,
                               device="cpu")
        rt.add_model(ARCH, model, params, d)
        rt.plan(batch=1, seq=8)
        sched = ServingScheduler(rt)
        try:
            with ControlPlane(rt, sched, plan_shape=(1, 8)) as cp:
                _, sub = _call(cp.url, "/v1/generate", {
                    "model": ARCH, "prompt": [5, 6, 7, 8],
                    "max_new_tokens": 3})
                out = _poll_done(cp.url, sub["rid"])
                _, shut = _call(cp.url, "/v1/shutdown", {})
                assert shut == {"shutting_down": True}
                assert cp.shutdown_requested.is_set()
            alone = Request(99, [5, 6, 7, 8], max_new_tokens=3)
            be = rt.batch_engine(ARCH)
            be.submit(alone)
            be.run_all()
        finally:
            sched.shutdown(timeout=60)
            rt.close()
    assert out["kind"] == "generate" and out["output"] == alone.output
    assert len(alone.output) == 3


def test_default_arrival_builds_on_the_runtime_device():
    rt = MultiModelRuntime(budget=int(40e6), device="cpu")
    cp = ControlPlane(rt, None)
    model, params = cp.build_model(ARCH, "smoke", seed=1)
    assert model.cfg == scale_config(get_arch(ARCH), "smoke")
    leaves = jax.tree.leaves(params)
    assert leaves and all(t.device == rt.device for t in leaves)
    rt.close()


def test_endpoints_and_families_equal_reference():
    assert ENDPOINTS == REF_ENDPOINTS
    assert METRIC_FAMILIES == REF_FAMILIES


SAMPLES = [
    ("swapnet_queue_depth", {}, 3.0),
    ("swapnet_model_up", {"model": "a"}, 1.0),
    ("swapnet_model_up", {"model": "b"}, 0.0),
    ("swapnet_request_latency_seconds", {"priority": "8",
                                         "quantile": "0.99"}, 0.1234567891),
    ("swapnet_cache_hit_rate", {}, 1 / 3),
    ("swapnet_not_a_family", {"k": "v"}, 2.5),
]


def test_render_prometheus_equals_reference():
    assert render_prometheus(SAMPLES) == ref_render(SAMPLES)
    lines = render_prometheus(SAMPLES).splitlines()
    assert lines.count("# TYPE swapnet_model_up gauge") == 1
    assert 'swapnet_model_up{model="a"} 1' in lines


def test_metrics_registry_without_scheduler():
    reg = MetricsRegistry()
    assert reg.collect() == [] and reg.latency_quantiles() == {}
    reg.count_http("/healthz")
    reg.count_http("/healthz")
    assert 'swapnet_http_requests_total{endpoint="/healthz"} 2' in \
        reg.render_prometheus()


def test_serve_http_entry_point(capsys):
    """``serve --profile mcu --http`` on the CPU: the listening line, a
    submit polled to done, then POST /v1/shutdown ends the process's
    serving loop cleanly."""
    import re
    import threading

    from repro_torch.launch import serve
    result = {}
    th = threading.Thread(target=lambda: result.update(serve.main([
        "--profile", "mcu", "--http", "--http-port", "0",
        "--device", "cpu"])), daemon=True)
    th.start()
    text, t0 = "", time.monotonic()
    while "listening on" not in text:
        assert th.is_alive() and time.monotonic() - t0 < 120, text
        time.sleep(0.05)
        text += capsys.readouterr().out
    base = re.search(r"listening on (http://\S+)", text).group(1)
    _, health = _call(base, "/healthz")
    assert health["models"] == {ARCH: True}
    _, sub = _call(base, "/v1/submit", {"model": ARCH, "requests": 2,
                                        "prompt_len": 16})
    assert _poll_done(base, sub["rid"])["logits_shape"][0] == 2
    assert _call(base, "/v1/shutdown", {})[1] == {"shutting_down": True}
    th.join(timeout=120)
    assert not th.is_alive()
    assert "[serve-http] shut down cleanly" in capsys.readouterr().out
    assert result["url"] == base
