"""Parity at real widths on the CUDA GPU (marker ``chip``; the
chip_device fixture skips them elsewhere).  Run on the card with
``JAX_PLATFORMS=cuda python -m pytest -m chip tests/test_chip.py``."""
import jax.numpy as jnp
import numpy as np
import pytest

from gaml_tpu.ops.extend import _dp_rows
from gaml_tpu.ops.extend_pallas import dp_kernel

from test_extend_pallas import random_batch

pytestmark = pytest.mark.chip


@pytest.mark.parametrize("accept", [False, True])
def test_kernel_matches_dp_rows_on_card(chip_device, accept):
    """The compiled kernel against the jnp DP at a production chunk
    (64k candidates, rmax 96)."""
    rng = np.random.default_rng(5)
    n, rmax = 64 * 1024, 96
    args = tuple(map(jnp.asarray, random_batch(rng, n, rmax, "random")))
    c_ref, a_ref = _dp_rows(*args, rmax)
    c_ref, a_ref = np.asarray(c_ref)[:, 3], np.asarray(a_ref)[:, 3]
    out = dp_kernel(*args, rmax, accept=accept)
    c = np.asarray(out[0] if accept else out)
    np.testing.assert_array_equal(c, np.minimum(c_ref, 7))
    if accept:
        live = c_ref <= 6
        np.testing.assert_array_equal(np.asarray(out[1])[live],
                                      a_ref[live])


def test_rescore_kernel_matches_jnp_on_card(chip_device):
    """The fused rescore with the kernel against the jnp route on a
    100 bp world: candidate count and zero reads exact, the float32 score
    within 1e-5 relative (summation order differs)."""
    from test_candgen_device import make_bundle, sample_world

    from gaml_tpu.ops.rescore_device import DeviceRescorer

    genome, reads = sample_world(seed=4, genome_len=40_000, n_reads=10_000,
                                 read_len=100)
    dev = DeviceRescorer(make_bundle(reads))
    args = dict(cap=16384, log_match=np.log(0.96), log_mismatch=np.log(0.01),
                total_len=len(genome), min_prob_per_base=-0.7,
                min_prob_start=-10.0)
    s_k, z_k, n_k = dev.rescore([genome], use_pallas=True, **args)
    s_j, z_j, n_j = dev.rescore([genome], use_pallas=False, **args)
    assert int(n_k) == int(n_j) <= 16384
    assert int(z_k) == int(z_j)
    np.testing.assert_allclose(float(s_k), float(s_j), rtol=1e-5)
