"""The host-side launch plan of the wkv6 kernel: how many blocks a row's
value columns split into (``column_groups``), and which forced splits the
kernel takes (``launch_plan``, ``check_groups``).

The plan is pure Python, so it is checked here on the CPU; the kernel that
follows it runs only on the card (``tests/test_torch_cuda.py`` holds it to
the plain version, and every split to the planned one bitwise). The
wrapper's CPU path, which never plans, is checked to ignore the plan but
to refuse a split the card would refuse.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.kernels import wkv6 as kw  # noqa: E402

H100_SMS = 132


def _columns(hd, G):
    """The columns each of a row's G blocks owns, as the kernel cuts them
    (block g: [g C, (g + 1) C), C = hd / G), each cut into the consumer
    warps' runs of CONSUMER_COLUMNS."""
    C = hd // G
    W = kw.CONSUMER_COLUMNS
    return [[col0 + W * w + jj for w in range(C // W) for jj in range(W)]
            for col0 in range(0, hd, C)]


@settings(max_examples=200, deadline=None)
@given(BH=st.integers(1, 4096), hd=st.sampled_from(kw.HEAD_DIMS),
       n_sm=st.integers(1, 264))
def test_groups_cover_every_column_once(BH, hd, n_sm):
    """G is a power of two that leaves every block a whole number of
    consumer warps, and the blocks' columns cover the row's hd columns
    once each."""
    G = kw.column_groups(BH, hd, n_sm)
    assert G in kw.GROUPS
    assert hd % (G * kw.CONSUMER_COLUMNS) == 0
    cols = [c for block in _columns(hd, G) for c in block]
    assert sorted(cols) == list(range(hd))


@settings(max_examples=200, deadline=None)
@given(BH=st.integers(1, 4096), hd=st.sampled_from(kw.HEAD_DIMS),
       n_sm=st.integers(1, 264))
def test_groups_fill_one_wave(BH, hd, n_sm):
    """The most groups that keep BH * G blocks within one wave: one more
    doubling would pass n_sm SMs or the head_dim's limit; G is 1 when BH
    alone fills the card."""
    G = kw.column_groups(BH, hd, n_sm)
    assert G == 1 or BH * G <= n_sm
    more = 2 * G
    assert (more not in kw.GROUPS or hd % (more * kw.CONSUMER_COLUMNS)
            or BH * more > n_sm)


def test_groups_depend_on_bh_hd_and_sm_count_only():
    """The split is a function of (BH, hd, n_sm): not of S, the dtype or
    the state, so a row's arithmetic, which does not depend on G anyway,
    is planned the same for every call shape it comes in."""
    assert list(inspect.signature(kw.column_groups).parameters) == [
        "BH", "hd", "n_sm"]
    assert list(inspect.signature(kw.launch_plan).parameters) == [
        "BH", "hd", "n_sm", "groups"]
    for BH in (1, 3, 40, 80, 160):
        for hd in kw.HEAD_DIMS:
            assert kw.launch_plan(BH, hd, H100_SMS) == kw.column_groups(
                BH, hd, H100_SMS)


@pytest.mark.parametrize("BH,hd,G", [
    (80, 64, 1),      # rwkv6-3b prefill, batch 2: 80 rows fill 80 SMs
    (40, 64, 2),      # batch 1: 80 blocks
    (160, 64, 1),     # batch 4: two waves of rows already
    (3, 32, 2),       # the reduced config (8 WKV heads of 32) at 3 rows
    (1, 64, 4),       # one row: 4 blocks of 16 columns
    (16, 32, 2)])
def test_groups_at_the_main_shapes(BH, hd, G):
    assert kw.column_groups(BH, hd, H100_SMS) == G


@pytest.mark.parametrize("hd,groups", [(64, 3), (64, 8), (32, 4), (32, 0)])
def test_launch_plan_refuses_a_split_the_kernel_does_not_take(hd, groups):
    with pytest.raises(ValueError, match="groups"):
        kw.launch_plan(80, hd, H100_SMS, groups)


@pytest.mark.parametrize("hd,groups", [(64, 1), (64, 2), (64, 4), (32, 1),
                                       (32, 2)])
def test_launch_plan_takes_every_split_the_kernel_does(hd, groups):
    """A forced split the kernel takes is launched as given, whatever the
    plan would pick at that BH."""
    for BH in (1, 80, 160):
        assert kw.launch_plan(BH, hd, H100_SMS, groups) == groups


def _cpu_inputs(hd):
    rng = np.random.default_rng(0)
    r, k, v = (torch.from_numpy(rng.standard_normal((2, 32, hd)).astype(
        np.float32)) for _ in range(3))
    w = torch.from_numpy(rng.uniform(-5, -1e-4, (2, 32, hd)).astype(
        np.float32))
    u = torch.from_numpy(rng.standard_normal((2, hd)).astype(np.float32))
    return r, k, v, w, u


def test_cpu_path_runs_the_plain_version_whatever_the_split():
    """A CPU tensor takes wkv6_plain: no plan, no launch, the same bits for
    every split the kernel takes."""
    r, k, v, w, u = _cpu_inputs(32)
    before = kw.launches.count
    yp, sp = kw.wkv6_plain(r, k, v, w, u)
    runs = [kw.wkv6(r, k, v, w, u)]
    runs += [kw._wkv6(r, k, v, w, u, None, G) for G in (None, 1, 2)]
    assert kw.launches.count == before
    for got in runs:
        assert torch.equal(got[0], yp) and torch.equal(got[1], sp)


@pytest.mark.parametrize("hd,groups", [(64, 3), (64, 8), (32, 4), (32, 0)])
def test_cpu_path_refuses_a_split_the_kernel_does_not_take(hd, groups):
    """The CPU path checks a forced split as the card does, so a test
    that passes here with a split passes there with it."""
    r, k, v, w, u = _cpu_inputs(hd)
    with pytest.raises(ValueError, match="groups"):
        kw._wkv6(r, k, v, w, u, None, groups)


def test_public_wrapper_takes_no_split():
    """Only the plan picks the split on the path: ``wkv6`` has no knob
    for it."""
    assert list(inspect.signature(kw.wkv6).parameters) == [
        "r", "k", "v", "w_log", "u", "state"]
