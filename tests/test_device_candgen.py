"""Native candidate generation + vectorized staging for the device
backend: must match the Python gen_candidates / python-staged batch path
exactly (candidate generation off Python)."""
import numpy as np

from gaml_tpu.align.aligner import gen_candidates, spell_subpath
from gaml_tpu.native import get_lib, query_windows_batch

from fixtures import make_linear_graph, sample_reads
from test_scoring import make_readset

import pytest

pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="native library unavailable")


def _world(tmp_path):
    rng = np.random.default_rng(42)
    gr, seqs = make_linear_graph(rng, [500, 90, 450, 120, 400])
    genome = "".join(seqs)
    reads = sample_reads(rng, genome, 60, 30, err_rate=0.02)
    rs = make_readset(tmp_path, reads, "qw")
    return gr, rs


def test_query_matches_python_gen_candidates(tmp_path):
    gr, rs = _world(tmp_path)
    bundle = rs.aligner.native_bundle
    assert bundle is not None
    windows = [(0,), (0, 2), (2, 4, 6), (4, 6, 8), (8,)]
    seqs = [np.ascontiguousarray(spell_subpath(gr, w)[0], dtype=np.uint8)
            for w in windows]
    native = query_windows_batch(bundle, seqs)
    for seq, (rid, g0, r0, orient) in zip(seqs, native):
        cands = gen_candidates(rs.aligner.index, rs.aligner.read_seqs, seq,
                               rs.aligner._read_cache)
        assert len(cands) == len(rid)
        for i, (c, _read) in enumerate(cands):
            assert (c.read_id, c.genome_pos, c.read_pos, c.orientation) == \
                (rid[i], g0[i], r0[i], orient[i]), (i, c)


def test_native_batch_path_matches_python_batch_path(tmp_path):
    gr, rs = _world(tmp_path)
    aligner = rs.aligner
    windows = [(0,), (0, 2), (2, 4, 6), (4, 6, 8), (8,), (6, 8)]
    native_out = aligner.align_subpaths_batch(gr, list(windows))
    bundle = aligner.native_bundle
    aligner.native_bundle = None
    try:
        py_out = aligner.align_subpaths_batch(gr, list(windows))
    finally:
        aligner.native_bundle = bundle
    for w, (a, b) in zip(windows, zip(native_out, py_out)):
        assert np.array_equal(a.position, b.position), w
        assert np.array_equal(a.edit_dist, b.edit_dist), w
        assert np.array_equal(a.read_id, b.read_id), w
        assert np.array_equal(a.orientation, b.orientation), w


def test_device_extender_matches_host_staging(tmp_path):
    """The device-resident stage+extend (gathers on device) must be
    bit-equal to the host-staged extension path."""
    from gaml_tpu.ops.extend import extend_staged, stage_candidates_uniform
    from gaml_tpu.ops.extend_device import DeviceExtender

    gr, rs = _world(tmp_path)
    bundle = rs.aligner.native_bundle
    windows = [(0,), (0, 2), (2, 4, 6), (4, 6, 8), (0, 2, 4, 6, 8)]
    seqs = [np.ascontiguousarray(spell_subpath(gr, w)[0], dtype=np.uint8)
            for w in windows]
    qs = query_windows_batch(bundle, seqs)
    counts = np.array([len(q[0]) for q in qs])
    rid = np.concatenate([q[0] for q in qs])
    g0 = np.concatenate([q[1] for q in qs])
    r0 = np.concatenate([q[2] for q in qs])
    orient = np.concatenate([q[3] for q in qs])
    seq_idx = np.repeat(np.arange(len(qs)), counts)
    seq_lens = np.array([len(s) for s in seqs], dtype=np.int64)
    seq_base = np.zeros(len(seqs), dtype=np.int64)
    np.cumsum(seq_lens[:-1], out=seq_base[1:])
    seq_buf = np.concatenate(seqs)
    rows = bundle.row_of[rid]

    st = stage_candidates_uniform(seq_buf, seq_base, seq_lens, seq_idx,
                                  g0, r0, rows, orient, bundle.codes_fwd,
                                  bundle.codes_rc, read_ids=rid)
    ok_h, errs_h, begin_h = extend_staged(st, use_pallas=False)

    ext = DeviceExtender(bundle.codes_fwd, bundle.codes_rc)
    ok_d, errs_d, begin_d = ext.run(seq_buf, seq_base, seq_lens, seq_idx,
                                    g0, r0, rows, orient, use_pallas=False)
    assert np.array_equal(ok_h, ok_d)
    # errs/begin travel back as one packed int32 per candidate; they are
    # defined (and bit-equal) exactly where ok — downstream consumers
    # (aligner dedup, candidates_to_score) mask by ok before use
    assert np.array_equal(errs_h[ok_h], errs_d[ok_d])
    assert np.array_equal(begin_h[ok_h], begin_d[ok_d])


def test_device_extender_sorted_dynamic_matches_host(tmp_path, monkeypatch):
    """The kernel route of DeviceExtender (candidates sorted by r0, the
    GPU kernel in interpret mode) must agree with the host-staged exact
    path on every consumed value: ok everywhere, errs/begin wherever ok.
    Exercises multi-chunk dispatch + the scatter back to caller order on
    both the packed and return_device routes."""
    from gaml_tpu.ops.extend import extend_staged, stage_candidates_uniform
    from gaml_tpu.ops.extend_device import DeviceExtender

    rng = np.random.default_rng(3)
    gr, seqs_l = make_linear_graph(rng, [900, 80, 700, 90, 600])
    genome = "".join(seqs_l)
    reads = sample_reads(rng, genome, 9000, 30, err_rate=0.03)
    rs = make_readset(tmp_path, reads, "sorted_dyn")
    bundle = rs.aligner.native_bundle
    windows = [(0, 2, 4, 6, 8), (4, 6), (0, 2)]
    seqs = [np.ascontiguousarray(spell_subpath(gr, w)[0], dtype=np.uint8)
            for w in windows]
    qs = query_windows_batch(bundle, seqs)
    counts = np.array([len(q[0]) for q in qs])
    rid = np.concatenate([q[0] for q in qs])
    g0 = np.concatenate([q[1] for q in qs])
    r0 = np.concatenate([q[2] for q in qs])
    orient = np.concatenate([q[3] for q in qs])
    seq_idx = np.repeat(np.arange(len(qs)), counts)
    seq_lens = np.array([len(s) for s in seqs], dtype=np.int64)
    seq_base = np.zeros(len(seqs), dtype=np.int64)
    np.cumsum(seq_lens[:-1], out=seq_base[1:])
    seq_buf = np.concatenate(seqs)
    rows = bundle.row_of[rid]
    chunk = 4096
    assert len(rid) > chunk  # several chunks

    st = stage_candidates_uniform(seq_buf, seq_base, seq_lens, seq_idx,
                                  g0, r0, rows, orient, bundle.codes_fwd,
                                  bundle.codes_rc, read_ids=rid)
    ok_h, errs_h, begin_h = extend_staged(st, use_pallas=False)

    monkeypatch.setenv("GAML_DEV_CHUNK", str(chunk))  # multi-chunk
    ext = DeviceExtender(bundle.codes_fwd, bundle.codes_rc)
    ok_d, errs_d, begin_d = ext.run(seq_buf, seq_base, seq_lens, seq_idx,
                                    g0, r0, rows, orient, use_pallas=True,
                                    interpret=True)
    assert np.array_equal(ok_h, ok_d)
    assert np.array_equal(errs_h[ok_h], errs_d[ok_d])
    assert np.array_equal(begin_h[ok_h], begin_d[ok_d])

    okD, errsD, beginD = ext.run(seq_buf, seq_base, seq_lens, seq_idx,
                                 g0, r0, rows, orient, use_pallas=True,
                                 return_device=True, interpret=True)
    okD = np.asarray(okD)[:len(rid)]
    assert np.array_equal(ok_h, okD)
    assert np.array_equal(errs_h[ok_h], np.asarray(errsD)[:len(rid)][okD])
    assert np.array_equal(begin_h[ok_h],
                          np.asarray(beginD)[:len(rid)][okD])


def test_sorted_dynamic_kernels_bit_exact():
    """Row bounds come from each block's own rlen: a block whose rows
    are all short stops early, and a block sorted by rlen or shuffled
    gives the same per-candidate results (interpret mode), equal to
    _dp_rows under the kernel's saturated contract."""
    import jax.numpy as jnp

    from gaml_tpu.ops.extend import PAD, _dp_rows
    from gaml_tpu.ops.extend_pallas import BLOCK, dp_kernel

    rng = np.random.default_rng(0)
    n, rmax = 4 * BLOCK, 32
    read_np = rng.integers(0, 5, (n, rmax)).astype(np.uint8)
    gwin_np = rng.integers(0, 5, (n, rmax + 2 * PAD)).astype(np.uint8)
    gwin_np[: n // 2, PAD:PAD + rmax] = read_np[: n // 2]
    gwin_np[gwin_np == 4] = 8  # genome sentinel
    read_np[read_np == 4] = 6  # read sentinel
    rlen_np = rng.integers(0, rmax + 1, n).astype(np.int32)
    glen_np = rng.integers(0, rmax + PAD, n).astype(np.int32)

    c_ref, a_ref = _dp_rows(jnp.asarray(read_np), jnp.asarray(rlen_np),
                            jnp.asarray(gwin_np), jnp.asarray(glen_np),
                            rmax)
    c_ref, a_ref = np.asarray(c_ref)[:, 3], np.asarray(a_ref)[:, 3]

    for perm in (np.arange(n), np.argsort(rlen_np, kind="stable"),
                 rng.permutation(n)):
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        c, a = dp_kernel(jnp.asarray(read_np[perm]),
                         jnp.asarray(rlen_np[perm]),
                         jnp.asarray(gwin_np[perm]),
                         jnp.asarray(glen_np[perm]), rmax, accept=True,
                         interpret=True)
        c, a = np.asarray(c)[inv], np.asarray(a)[inv]
        assert np.array_equal(c, np.minimum(c_ref, 7))
        m = c_ref <= 6
        assert m.sum() > n // 4
        assert np.array_equal(a[m], a_ref[m])


def test_stage_uniform_matches_stage_candidates(tmp_path):
    from gaml_tpu.ops.extend import stage_candidates, stage_candidates_uniform

    gr, rs = _world(tmp_path)
    bundle = rs.aligner.native_bundle
    windows = [(0, 2), (2, 4, 6)]
    seqs = [np.ascontiguousarray(spell_subpath(gr, w)[0], dtype=np.uint8)
            for w in windows]
    qs = query_windows_batch(bundle, seqs)
    counts = np.array([len(q[0]) for q in qs])
    rid = np.concatenate([q[0] for q in qs])
    g0 = np.concatenate([q[1] for q in qs])
    r0 = np.concatenate([q[2] for q in qs])
    orient = np.concatenate([q[3] for q in qs])
    seq_idx = np.repeat(np.arange(len(qs)), counts)
    seq_lens = np.array([len(s) for s in seqs], dtype=np.int64)
    seq_base = np.zeros(len(seqs), dtype=np.int64)
    np.cumsum(seq_lens[:-1], out=seq_base[1:])
    seq_buf = np.concatenate(seqs)
    rows = bundle.row_of[rid]
    st_u = stage_candidates_uniform(seq_buf, seq_base, seq_lens, seq_idx,
                                    g0, r0, rows, orient, bundle.codes_fwd,
                                    bundle.codes_rc, read_ids=rid)
    # reference staging via per-candidate python loop
    oriented = [bundle.codes_rc[rows[i]] if orient[i] else
                bundle.codes_fwd[rows[i]] for i in range(len(rid))]
    st_p = stage_candidates(seqs, g0, r0, oriented, rmax=st_u["rmax"],
                            nb=len(st_u["valid"]), read_ids=rid,
                            seq_idx=seq_idx)
    for key in ("read_f", "rlen_f", "gwin_f", "glen_f", "read_b", "rlen_b",
                "gwin_b", "glen_b", "g0", "r0", "read_len", "valid",
                "at_start", "read_id"):
        assert np.array_equal(st_u[key], st_p[key]), key


def test_cold_executable_cost_model_routing(tmp_path, monkeypatch):
    """With a cold fused executable the bulk precompute serves results
    natively (bit-identical) while a background thread warms the device
    path; once warm, bulk batches route to the device."""
    import time

    from gaml_tpu.scoring.readset import ReadSet
    from fixtures import make_linear_graph, sample_reads, write_fastq

    rng = np.random.default_rng(5)
    gr, seqs = make_linear_graph(rng, [700, 90, 650])
    genome = "".join(seqs)
    reads = sample_reads(rng, genome, 40, 30)
    fq = tmp_path / "coldwarm.fq"
    write_fastq(str(fq), reads)
    rs = ReadSet(str(tmp_path / "coldwarm"), str(fq), 0.96, 0.01,
                 backend="device")
    rs.preprocess_reads()
    rs.prepare_read_index()
    monkeypatch.delenv("GAML_DEV_EAGER", raising=False)
    monkeypatch.setattr(rs, "_dev_min_bases", 1)  # everything is "bulk"

    calls = []
    real = rs.aligner.align_subpaths_batch

    def spy(graph, paths, defer=False):
        calls.append(len(paths))
        return real(graph, paths, defer=defer)

    monkeypatch.setattr(rs.aligner, "align_subpaths_batch", spy)

    paths = [[0, 2, 4]]
    rs.precompute_alignment_for_paths(paths, gr)
    # first bulk call went native; a warm-up thread got the batch
    for _ in range(400):
        if rs._device_ready(gr, [(0,)]):
            break
        time.sleep(0.05)
    assert rs._dev_warm_done
    n_before = len(calls)
    rs.aligment_cache.clear()
    rs._precompute_memo.clear()
    rs._stage_memo = {}
    rs.precompute_alignment_for_paths([[4, 2, 0]], gr)
    assert len(calls) > n_before  # warm: bulk routed to the device path


def test_warmup_failure_raises_instead_of_pinning_native():
    """A warm-up that raises is a broken device route: the next
    device_ready call for the key raises it (no retries, no silent
    native pin), and every later call keeps raising."""
    from gaml_tpu.utils import warmup

    key = ("test_warmup_raise", 1)
    calls = []

    def bad():
        calls.append("bad")
        raise RuntimeError("compile failed")

    assert warmup.device_ready(key, bad) is False
    for th in list(warmup._THREADS):
        th.join(5)
    for _ in range(2):
        with pytest.raises(warmup.WarmupError, match="compile failed"):
            warmup.device_ready(key, bad)
    assert calls == ["bad"]


def test_warmup_success_goes_device():
    """A warm-up that succeeds flips its key to ready exactly once, and
    a failure recorded by an explicit prewarm raises like a thread's."""
    from gaml_tpu.utils import warmup

    key = ("test_warmup_ok", 1)
    calls = []
    assert warmup.device_ready(key, lambda: calls.append(1)) is False
    for th in list(warmup._THREADS):
        th.join(5)
    assert warmup.device_ready(key, lambda: calls.append(2)) is True
    assert calls == [1]

    key2 = ("test_warmup_marked", 1)
    warmup.mark_failed(key2, ValueError("prewarm broke"))
    with pytest.raises(warmup.WarmupError, match="prewarm broke"):
        warmup.device_ready(key2, lambda: None)
