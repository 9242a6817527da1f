"""The Pallas GPU extension kernel (ops.extend_pallas): interpret-mode
parity with the jnp DP, its padding and row bounds, its CUDA lowering,
and the platform rule that picks it."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaml_tpu.core import dna
from gaml_tpu.ops.extend import (PAD, _dp_rows, extend_kernel,
                                 extend_staged, stage_candidates)
from gaml_tpu.ops.extend_pallas import BLOCK, dp_kernel

from fixtures import random_seq
from test_extend_kernel import random_case, seeds_of


def random_batch(rng, n, rmax, rows):
    """Direction-view DP inputs: half the candidates are near-perfect
    diagonal matches (so many are ok), the rest random.  ``rows`` picks
    the row counts: "random", "zero" (no live rows) or "full" (rmax)."""
    read = rng.integers(0, 4, (n, rmax)).astype(np.uint8)
    gwin = rng.integers(0, 4, (n, rmax + 2 * PAD)).astype(np.uint8)
    gwin[: n // 2, PAD:PAD + rmax] = read[: n // 2]
    err = rng.random((n, rmax)) < 0.02
    view = gwin[:, PAD:PAD + rmax]
    view[err] = (view[err] + 1) % 4
    gwin[rng.random(gwin.shape) < 0.01] = 8     # genome sentinel
    if rows == "zero":
        rlen = np.zeros(n, np.int32)
    elif rows == "full":
        rlen = np.full(n, rmax, np.int32)
    else:
        rlen = rng.integers(0, rmax + 1, n).astype(np.int32)
    read[np.arange(rmax)[None, :] >= rlen[:, None]] = 6  # read sentinel
    glen = rng.integers(0, rmax + 2 * PAD, n).astype(np.int32)
    return read, rlen, gwin, glen


@pytest.mark.parametrize("rmax,n,rows,block", [
    (32, 128, "random", BLOCK),
    (32, 96, "random", 64),       # n < block: padded to one block
    (64, 300, "random", BLOCK),   # n not a block multiple
    (64, 512, "full", 256),
    (96, 256, "zero", BLOCK),
    (96, 200, "full", BLOCK),
    (96, 1000, "random", BLOCK),
    (96, 640, "random", 64),
])
def test_kernel_matches_dp_rows(rmax, n, rows, block):
    """Cost (saturated at 7) and accept offset equal _dp_rows wherever
    they are consumed: the ok predicate everywhere, costs and offsets
    wherever the cost is unsaturated."""
    rng = np.random.default_rng(rmax * 7 + n)
    read, rlen, gwin, glen = random_batch(rng, n, rmax, rows)
    args = tuple(map(jnp.asarray, (read, rlen, gwin, glen)))
    c_ref, a_ref = _dp_rows(*args, rmax)
    c_ref, a_ref = np.asarray(c_ref)[:, 3], np.asarray(a_ref)[:, 3]

    c_f = np.asarray(dp_kernel(*args, rmax, accept=False, interpret=True,
                               block=block))
    c_b, a_b = dp_kernel(*args, rmax, accept=True, interpret=True,
                         block=block)
    c_b, a_b = np.asarray(c_b), np.asarray(a_b)
    assert c_f.shape == c_b.shape == a_b.shape == (n,)
    np.testing.assert_array_equal(c_f, np.minimum(c_ref, 7))
    np.testing.assert_array_equal(c_b, np.minimum(c_ref, 7))
    live = c_ref <= 6
    np.testing.assert_array_equal(a_b[live], a_ref[live])
    if rows == "zero":
        assert (c_f == 0).all() and (a_b == 0).all()
    elif rows != "full":
        assert 0 < (c_ref <= 3).sum() < n


@pytest.mark.parametrize("seed", range(4))
def test_pallas_matches_jnp(seed):
    """Staged real candidates (seeded reads against a genome window):
    the kernel route of extend_staged returns the jnp route's ok, and
    its errs and begin wherever ok."""
    rng = np.random.default_rng(seed)
    seq = dna.encode_seq(random_seq(rng, 350))
    g0s, r0s, reads = [], [], []
    for _ in range(40):
        read = random_case(rng, seq)
        seeds = seeds_of(read, seq)
        if not seeds:
            continue
        g0, r0 = seeds[int(rng.integers(0, len(seeds)))]
        g0s.append(g0)
        r0s.append(r0)
        reads.append(read)
    assert len(reads) > 10
    st = stage_candidates(seq, np.array(g0s, np.int32),
                          np.array(r0s, np.int32), reads)
    ok_j, errs_j, begin_j = extend_staged(st, use_pallas=False)
    ok_p, errs_p, begin_p = extend_staged(st, use_pallas=True,
                                          interpret=True)
    np.testing.assert_array_equal(ok_j, ok_p)
    np.testing.assert_array_equal(errs_j[ok_j], errs_p[ok_p])
    np.testing.assert_array_equal(begin_j[ok_j], begin_p[ok_p])


@pytest.mark.parametrize("accept", [False, True])
def test_kernel_lowers_for_cuda(accept):
    """The kernel lowers through Pallas's Triton route for CUDA at the
    production width (a 64k-candidate chunk, rmax 96, 100 bp reads) —
    catches primitives the GPU lowering rejects without a card."""
    n, rmax = 64 * 1024, 96
    args = (jax.ShapeDtypeStruct((n, rmax), jnp.int32),
            jax.ShapeDtypeStruct((n,), jnp.int32),
            jax.ShapeDtypeStruct((n, rmax + 2 * PAD), jnp.int32),
            jax.ShapeDtypeStruct((n,), jnp.int32))
    fn = functools.partial(dp_kernel, rmax=rmax, accept=accept)
    text = jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "gaml_extend_dp" in text


def test_fused_rescore_lowers_for_cuda():
    """The whole single-dispatch rescore (candgen + staging + kernel +
    dedup + reduction) lowers for CUDA at the bench world's shapes."""
    from test_candgen_device import make_bundle, sample_world

    from gaml_tpu.ops.rescore_device import (DeviceRescorer,
                                             _rescore_full_impl)

    genome, reads = sample_world(seed=4, genome_len=3000, n_reads=300,
                                 read_len=100)
    dev = DeviceRescorer(make_bundle(reads))
    p2d, fxd, seg_base, seg_len, g_total, nseg, s_pad = dev.stage([genome])
    gen = dev.gen
    cap = 131072
    args = (p2d, fxd, jnp.asarray(seg_base), jnp.asarray(seg_len),
            jnp.int32(nseg), jnp.int32(g_total), gen.sf, gen.off, gen.rids,
            gen.seed2, gen.row_of_dev, dev.ext.fwd_words, dev.ext.rc_words,
            dev.lens_dev, jnp.int32(dev.n_reads), jnp.float32(-0.04),
            jnp.float32(-4.6), jnp.int32(len(genome)), jnp.float32(-0.7),
            jnp.float32(-10.0))
    fn = functools.partial(_rescore_full_impl, read_len=dev.read_len,
                           cap=cap, s_pad=s_pad, rmax=dev.ext.rmax,
                           use_kernel=True, interpret=False)
    text = jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    assert text.count("gaml_extend_dp") >= 2


class _FakeDevice:
    def __init__(self, platform):
        self.platform = platform


@pytest.mark.parametrize("plat,expect", [("gpu", True), ("cpu", False),
                                         ("rocm", None), ("metal", None)])
def test_route_choice(monkeypatch, plat, expect):
    """gpu -> Pallas kernel, cpu -> jnp DP, any other platform raises."""
    from gaml_tpu.utils import device

    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice(plat)])
    if expect is None:
        with pytest.raises(RuntimeError, match="no device route"):
            device.use_kernel()
    else:
        assert device.use_kernel() is expect


def test_default_route_follows_platform(monkeypatch):
    """extend_staged with no explicit route asks the platform: on 'gpu'
    it runs the kernel (spied here, in interpret mode)."""
    import gaml_tpu.ops.extend_pallas as ep
    from gaml_tpu.utils import device

    rng = np.random.default_rng(9)
    seq = dna.encode_seq(random_seq(rng, 300))
    read = random_case(rng, seq)
    seeds = seeds_of(read, seq)
    assert seeds
    st = stage_candidates(seq, np.array([seeds[0][0]], np.int32),
                          np.array([seeds[0][1]], np.int32), [read])
    calls = []
    real = ep.dp_kernel

    def spy(*a, **kw):
        calls.append(kw["accept"])
        kw["interpret"] = True
        return real(*a, **kw)

    monkeypatch.setattr(ep, "dp_kernel", spy)
    monkeypatch.setattr(device, "use_kernel", lambda: True)
    extend_kernel.clear_cache()
    try:
        ok_k, errs_k, begin_k = extend_staged(st)
    finally:
        extend_kernel.clear_cache()
    assert sorted(calls) == [False, True]
    ok_j, errs_j, begin_j = extend_staged(st, use_pallas=False)
    np.testing.assert_array_equal(ok_k, ok_j)
