"""The dry run's train_4k step on 16 x 16 for the families whose layers
take the model's other sharding paths: llama4-scout (mixture of experts,
40 heads, block-local and global layers), zamba2 (Mamba2 and the shared
attention block) and deepseek-v2-lite (MLA attention, shared experts).
Each runs at the fewest layers that hold every layer kind its arch has
(``min_depth``): llama4 4, zamba2 6, deepseek 1. On an 8-core CPU they
took about 26 s, 48 s and 15 s. A file of its own, so that the test
runner's file-level distribution puts it beside the other dry-run
tests."""
import dataclasses

import pytest

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.flops import analytic_flops_per_device
from repro_torch.launch import dryrun


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "zamba2-7b",
                                  "deepseek-v2-lite-16b"])
def test_train_traces(arch):
    n = dryrun.min_depth(ARCHS[arch])
    r = dryrun.run_one(arch, "train_4k", False, n_layers=n, verbose=False)
    assert r["status"] == "ok", r
    assert r["n_layers"] == n
    assert r["flops_analytic_per_dev"] == analytic_flops_per_device(
        dataclasses.replace(ARCHS[arch], n_layers=n), SHAPES["train_4k"], 256)
    assert r["cost_analysis"]["flops"] > 0
    mem = r["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert r["collectives"]["all-gather"]["count"] > 0
