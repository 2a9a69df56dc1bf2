"""The port's host quantizers (torch ops on every core) against the JAX
package's numpy ones, bitwise, on the cases a rounding rule or a scale
rule would show: exact halves after the divide (round half to even), a
zero channel (scale 1.0), the clip at the limit, and 1-D and 3-D leaves.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.kernels import dequant as ref_dq  # noqa: E402
from repro_torch.kernels import dequant as dq  # noqa: E402


@pytest.mark.parametrize("shape", [(96, 40), (7,), (3, 5, 18)])
def test_host_quantizers_bitwise_on_ties_and_zero_channels(shape):
    rng = np.random.default_rng(11)
    a = rng.standard_normal(shape).astype(np.float32)
    grid = a.reshape(-1, shape[-1]) if a.ndim > 1 else a.reshape(1, -1)
    if grid.shape[1] > 2:
        grid[:, 0] = 0.0                                  # zero channel
        # halves after dividing by the scale: max 127 (int8) and 7 (int4)
        # multiples, so x / scale lands on k + 0.5
        grid[:, 1] = (np.arange(grid.shape[0]) % 15 - 7) + 0.5
        grid[0, 1] = 127.0
        grid[:, 2] = (np.arange(grid.shape[0]) % 15 - 7) + 0.5
        grid[0, 2] = 7.0
    a = grid.reshape(shape)
    for ours, theirs in ((dq.quantize_int8, ref_dq.quantize_int8),
                         (dq.quantize_int4, ref_dq.quantize_int4)):
        q, s = ours(a)
        rq, rs = theirs(a)
        assert q.dtype == np.int8 and s.dtype == np.float32
        np.testing.assert_array_equal(q, np.asarray(rq))
        np.testing.assert_array_equal(s, np.asarray(rs))


@pytest.mark.parametrize("shape", [(64, 33), (2, 16, 9)])
def test_host_quantizers_bitwise_where_the_largest_magnitude_is_negative(
        shape):
    """max|x| taken as max(max x, -min x): channels whose largest
    magnitude is negative, signed zeros only, and one where both signs
    reach it, each against the reference's |x| maximum."""
    rng = np.random.default_rng(12)
    a = rng.standard_normal(shape).astype(np.float32)
    grid = a.reshape(-1, shape[-1])
    grid[:, 0] = -np.abs(grid[:, 0]) - 1.0              # all negative
    grid[:, 1] = np.where(np.arange(grid.shape[0]) % 2, -0.0, 0.0)
    grid[:, 2] = 0.25
    grid[0, 2], grid[-1, 2] = -3.0, 3.0                 # both signs at max
    grid[0, 3] = -9.0                                   # a negative outlier
    a = grid.reshape(shape)
    for ours, theirs in ((dq.quantize_int8, ref_dq.quantize_int8),
                         (dq.quantize_int4, ref_dq.quantize_int4)):
        q, s = ours(a)
        rq, rs = theirs(a)
        np.testing.assert_array_equal(q, np.asarray(rq))
        np.testing.assert_array_equal(s, np.asarray(rs))
