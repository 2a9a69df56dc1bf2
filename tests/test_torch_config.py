"""The layered serving configuration and the launcher of the port against
the JAX package's: the golden legacy invocations, ``--print-config`` per
profile, the layer precedence, ``ConfigError`` messages, the
``from_config`` constructors, and the profile path end to end on the CPU.

Tolerance: exact. Resolved dicts, dispatch modes, printed JSON and error
messages are equal to the reference's strings and values. The env layer
reads ``SWAPNET_*`` from ``os.environ``; every test clears it first.
"""
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro.config import resolve_config as ref_resolve  # noqa: E402
from repro.config import explain_layers as ref_explain  # noqa: E402
from repro.config import ServeConfig as RefServeConfig  # noqa: E402
from repro.core.multi_model import \
    MultiModelRuntime as RefMultiModelRuntime  # noqa: E402
from repro.core.serving_scheduler import \
    ServingScheduler as RefServingScheduler  # noqa: E402
from repro.errors import ConfigError as RefConfigError  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro_torch.config import (ServeConfig, env_overlay,  # noqa: E402
                                explain_layers, profile_names,
                                resolve_config)
from repro_torch.core.multi_model import MultiModelRuntime  # noqa: E402
from repro_torch.core.serving_scheduler import ServingScheduler  # noqa: E402
from repro_torch.errors import ConfigError  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "serve_configs.json")
with open(GOLDEN) as _f:
    CASES = json.load(_f)


@pytest.fixture(autouse=True)
def no_swapnet_env(monkeypatch):
    for name in list(os.environ):
        if name.startswith("SWAPNET_"):
            monkeypatch.delenv(name)


@pytest.mark.parametrize("case", CASES, ids=[" ".join(c["argv"])
                                             for c in CASES])
def test_golden_invocation_resolves_identically(case):
    args = serve.build_parser().parse_args(case["argv"])
    cfg = resolve_config(profile=args.profile, env={},
                         cli=serve.cli_overrides(args))
    assert cfg.to_dict() == case["resolved"]
    assert serve.dispatch_mode(cfg) == case["mode"]
    assert cfg.profile is None


@pytest.mark.parametrize("profile", profile_names())
def test_print_config_equals_reference(profile, capsys):
    ref_serve.main(["--profile", profile, "--print-config"])
    want = capsys.readouterr().out
    out = serve.main(["--profile", profile, "--print-config"])
    got = capsys.readouterr().out
    assert got == want
    assert json.loads(got) == json.loads(json.dumps(out))


def test_layer_precedence_defaults_profile_env_cli(monkeypatch):
    env = {"SWAPNET_RUNTIME_BUDGET_MB": "48", "SWAPNET_RUNTIME_EXECUTORS": "3",
           "SWAPNET_WORKLOAD_PRIORITIES": "2,4"}
    cli = {"runtime": {"executors": 4}}
    cfg = resolve_config(profile="edge-tpu", env=env, cli=cli)
    assert cfg.runtime.cache_frac == 0.25            # the profile's
    assert cfg.runtime.kv_frac == 0.3                # the default
    assert cfg.runtime.budget_mb == 48.0             # env over profile
    assert cfg.workload.priorities == [2.0, 4.0]     # lists replace
    assert cfg.runtime.executors == 4                # CLI over env
    assert cfg.to_dict() == ref_resolve(profile="edge-tpu", env=env,
                                        cli=cli).to_dict()
    assert explain_layers("edge-tpu", env, cli) == ref_explain(
        "edge-tpu", env, cli)
    # the real os.environ is the env layer when none is passed
    monkeypatch.setenv("SWAPNET_RUNTIME_BUDGET_MB", "48")
    monkeypatch.setenv("SWAPNET_PROFILE", "mcu")
    cfg = resolve_config()
    assert (cfg.profile, cfg.runtime.budget_mb) == ("mcu", 48.0)
    assert cfg.to_dict() == ref_resolve().to_dict()


ERRORS = {
    "unknown-key": lambda m: m.ServeConfig.from_dict(
        {"runtime": {"budjet_mb": 8}}),
    "unknown-top-key": lambda m: m.ServeConfig.from_dict({"runtme": {}}),
    "unknown-profile": lambda m: m.resolve_config(profile="edge-tpuu",
                                                  env={}),
    "unknown-env": lambda m: m.env_overlay({"SWAPNET_RUNTIME_BUDGT_MB": "8"}),
    "bad-int": lambda m: m.resolve_config(
        env={"SWAPNET_RUNTIME_EXECUTORS": "two"}),
    "unknown-arch": lambda m: m.resolve_config(env={},
                                               cli={"arch": "qwen2.5-3"}),
    "mixed-without-fidelity": lambda m: m.resolve_config(env={}, cli={
        "arch": "qwen2.5-3b",
        "runtime": {"store": "quant", "precision": "mixed"}}),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_config_errors_equal_reference(case):
    import repro.config as ref_config
    import repro_torch.config as config
    with pytest.raises(ConfigError) as got:
        ERRORS[case](config)
    with pytest.raises(RefConfigError) as want:
        ERRORS[case](ref_config)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


def test_env_overlay_ignores_foreign_and_profile_vars():
    assert env_overlay({"PATH": "/bin", "SWAPNET_PROFILE": "mcu"}) == {}


@pytest.mark.parametrize("profile", profile_names())
def test_from_config_matches_reference(profile):
    cfg = resolve_config(profile=profile, env={})
    ref_cfg = ref_resolve(profile=profile, env={})
    rt = MultiModelRuntime.from_config(cfg, device="cpu")
    ref = RefMultiModelRuntime.from_config(ref_cfg)
    keys = ("budget", "kv_frac", "page_tokens", "max_batch", "store_backend",
            "precision", "fidelity", "calib_method", "calib_seed",
            "prefetch_depth", "executors", "mode", "delta")
    assert {k: getattr(rt, k) for k in keys} == \
        {k: getattr(ref, k) for k in keys}
    assert rt.cache.capacity == ref.cache.capacity
    sched = ServingScheduler.from_config(rt, cfg)
    ref_sched = RefServingScheduler.from_config(ref, ref_cfg)
    try:
        keys = ("executors", "preempt", "auto_rebalance", "fail_fast_after",
                "shed_deadlines")
        assert {k: getattr(sched, k) for k in keys} == \
            {k: getattr(ref_sched, k) for k in keys}
        assert sched.queue.default_slack == ref_sched.queue.default_slack
    finally:
        sched.shutdown()
        ref_sched.shutdown()
    with pytest.raises(ValueError, match="budget_mb is required"):
        MultiModelRuntime.from_config(dataclasses.replace(
            cfg, runtime=dataclasses.replace(cfg.runtime, budget_mb=None)),
            device="cpu")


def test_routing_edges_raise_like_reference():
    for argv, match in ((["--multi", "qwen2.5-3b,gemma2-9b"], "budget"),
                        (["--arch", "qwen2.5-3b", "--paged"], "budget"),
                        ([], "--arch")):
        args = serve.build_parser().parse_args(argv)
        cfg = resolve_config(env={}, cli=serve.cli_overrides(args))
        with pytest.raises(SystemExit, match=match):
            serve.dispatch_mode(cfg)
    args = serve.build_parser().parse_args(["--profile", "mcu", "--http"])
    cfg = resolve_config(profile="mcu", env={}, cli=serve.cli_overrides(args))
    assert serve.dispatch_mode(cfg) == "http"
    assert isinstance(cfg, ServeConfig) and not isinstance(cfg,
                                                           RefServeConfig)


@pytest.mark.parametrize("profile", profile_names())
def test_profile_serves_on_cpu(profile, capsys):
    """``--profile <name>`` end to end: every tenant through the
    scheduler under the profile's budget; mcu on the calibrated mixed
    store, workstation with its paged generations too."""
    cfg = resolve_config(profile=profile, env={})
    out = serve.main(["--profile", profile, "--device", "cpu"])
    text = capsys.readouterr().out
    names = cfg.model_names()
    n = cfg.workload.rounds * len(names) * (2 if cfg.runtime.paged else 1)
    assert (f"[serve-profile] profile={profile}: {len(names)} model(s) "
            f"({', '.join(names)}), {cfg.runtime.executors} executor(s), "
            f"store={cfg.runtime.store}" in text)
    assert f"{n} requests served" in text and "(OK)" in text
    assert out["peak"] <= out["budget"] == int(cfg.runtime.budget_mb * 1e6)
    assert all(r.error is None for r in out["requests"])
    if profile == "mcu":
        st = out["stats"]["models"]["qwen2.5-3b"]
        assert st["precision"] == "mixed"
        assert sum(st["bytes_by_precision_mb"].values()) == pytest.approx(
            st["bytes_swapped_mb"])


def test_mixed_precision_flag_on_the_swapped_path(capsys):
    out = serve.main(["--arch", "qwen2.5-3b", "--budget-mb", "8",
                      "--store", "quant", "--precision", "mixed",
                      "--fidelity", "2e-2", "--requests", "2",
                      "--prompt-len", "8", "--new-tokens", "2",
                      "--device", "cpu"])
    text = capsys.readouterr().out
    assert "[calibrate] qwen2.5-3b-reduced: fidelity 0.02 -> predicted_err" in text
    assert "store=quant/mixed" in text
    assert tuple(out["tokens"].shape) == (2, 2)
