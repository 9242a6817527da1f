"""The fused window-bytes-in/score-out device rescore
(ops.rescore_device) must match the staged reference pipeline
(native query -> DeviceExtender -> candidates_to_score)."""
import numpy as np
import pytest

import jax.numpy as jnp

from gaml_tpu.native import get_lib, query_windows_batch
from gaml_tpu.ops.rescore_device import DeviceRescorer
from gaml_tpu.ops.score import candidates_to_score, reduce_read_probs

from test_candgen_device import make_bundle, sample_world

pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="native library unavailable")

MATCH, MISMATCH = np.log(0.96), np.log(0.01)
MPB, MPS = -0.7, -10.0


def reference_read_probs(bundle, ext, seq, n_reads, read_len):
    """Per-window read probabilities via the round-4 staged pipeline."""
    (rid, g0, r0, orient), = query_windows_batch(bundle, [seq])
    n = len(rid)
    if n == 0:
        return np.zeros(n_reads, np.float32)
    seq_lens = np.array([len(seq)], dtype=np.int64)
    seq_base = np.zeros(1, dtype=np.int64)
    seq_idx = np.zeros(n, dtype=np.int64)
    ok_d, errs_d, begin_d = ext.run(
        seq, seq_base, seq_lens, seq_idx, g0, r0, bundle.row_of[rid],
        orient, use_pallas=False, return_device=True)
    n_pad = ok_d.shape[0]
    valid = np.zeros(n_pad, dtype=bool)
    valid[:n] = True
    rid_p = np.zeros(n_pad, dtype=np.int32)
    rid_p[:n] = rid
    rlen_p = np.full(n_pad, read_len, dtype=np.int32)
    lens_all = jnp.full((n_reads,), read_len, dtype=jnp.int32)
    _s, _z, probs = candidates_to_score(
        ok_d, errs_d, begin_d, jnp.asarray(valid), jnp.asarray(rid_p),
        jnp.asarray(rlen_p), lens_all, jnp.float32(MATCH),
        jnp.float32(MISMATCH), jnp.int32(len(seq)), jnp.float32(MPB),
        jnp.float32(MPS), n_reads=n_reads)
    return np.asarray(probs)


def check(seqs, seed=0, n_reads=300, read_len=40, genome_len=3000):
    genome, reads = sample_world(seed=seed, genome_len=genome_len,
                                 n_reads=n_reads, read_len=read_len)
    if seqs is None:
        seqs = [genome]
    bundle = make_bundle(reads)
    dev = DeviceRescorer(bundle)
    total_len = sum(len(s) for s in seqs)
    score_d, zeros_d, n_tot = dev.rescore(
        seqs, cap=4096, log_match=MATCH, log_mismatch=MISMATCH,
        total_len=total_len, min_prob_per_base=MPB, min_prob_start=MPS)
    assert int(n_tot) <= 4096, "test world overflowed the cap"

    probs = np.zeros(n_reads, np.float32)
    for s in seqs:
        probs += reference_read_probs(bundle, dev.ext, s, n_reads,
                                      read_len)
    lens_all = jnp.full((n_reads,), read_len, dtype=jnp.int32)
    score_h, zeros_h, _p = reduce_read_probs(
        jnp.asarray(probs), lens_all, jnp.int32(total_len),
        jnp.float32(MPB), jnp.float32(MPS))
    assert int(zeros_d) == int(zeros_h)
    np.testing.assert_allclose(float(score_d), float(score_h), rtol=2e-6)
    return genome, reads


def test_single_window_score_matches_staged_pipeline():
    check(None)


def test_multi_window_score_matches_staged_pipeline():
    genome, _ = sample_world(seed=11, genome_len=4000)
    # windows overlap, so duplicate (window, pos, read) alignments exist
    # in different segments and must NOT dedup across segments
    check([genome[:1500], genome[1300:2900], genome[2600:]], seed=11,
          genome_len=4000)


def test_sorted_pallas_path_matches():
    """The GPU configuration (r0 counting sort + the Pallas kernel +
    rank-keyed dedup), kernel in interpret mode, must score identically
    to the plain jnp path."""
    genome, reads = sample_world(seed=21, genome_len=3000, n_reads=400)
    bundle = make_bundle(reads)
    dev = DeviceRescorer(bundle)
    args = dict(cap=4096, log_match=MATCH, log_mismatch=MISMATCH,
                total_len=len(genome), min_prob_per_base=MPB,
                min_prob_start=MPS)
    s_ref, z_ref, n_ref = dev.rescore([genome], use_pallas=False, **args)
    s_pal, z_pal, n_pal = dev.rescore([genome], use_pallas=True,
                                      interpret=True, **args)
    assert int(n_ref) == int(n_pal) <= 4096
    assert int(z_ref) == int(z_pal)
    np.testing.assert_allclose(float(s_pal), float(s_ref), rtol=2e-6)


def test_batched_jobs_match_single_rescores():
    """k independent assemblies scored in ONE dispatch (seg_job
    grouping) must match k separate rescores."""
    genome, reads = sample_world(seed=31, genome_len=2500, n_reads=250)
    bundle = make_bundle(reads)
    dev = DeviceRescorer(bundle)
    w1, w2, w3 = genome[:1200], genome[900:2100], genome[1800:]
    args = dict(cap=8192, log_match=MATCH, log_mismatch=MISMATCH,
                min_prob_per_base=MPB, min_prob_start=MPS)
    singles = []
    for w in ((w1,), (w2, w3)):
        tl = sum(len(x) for x in w)
        s, z, n = dev.rescore(list(w), total_len=tl, **args)
        assert int(n) <= 8192
        singles.append((float(s), int(z)))
    sb, zb, nb = dev.rescore(
        [w1, w2, w3], seg_job=np.array([0, 1, 1], np.int32), n_jobs=2,
        total_len=[len(w1), len(w2) + len(w3)], **args)
    assert int(nb) <= 8192
    sb, zb = np.asarray(sb), np.asarray(zb)
    for j, (s, z) in enumerate(singles):
        assert int(zb[j]) == z
        np.testing.assert_allclose(float(sb[j]), s, rtol=2e-6)


def test_overflow_detectable():
    genome, reads = sample_world(seed=2, genome_len=2000, n_reads=200)
    bundle = make_bundle(reads)
    dev = DeviceRescorer(bundle)
    _s, _z, n_tot = dev.rescore(
        [genome], cap=16, log_match=MATCH, log_mismatch=MISMATCH,
        total_len=len(genome), min_prob_per_base=MPB, min_prob_start=MPS)
    assert int(n_tot) > 16
