"""Native C++ kernels vs the Python implementations — bit-identical."""
import os

import numpy as np
import pytest

from gaml_tpu import native
from gaml_tpu.core import dna

from fixtures import make_linear_graph, random_seq

pytestmark = pytest.mark.skipif(native.get_lib() is None,
                                reason="native lib unavailable")


def _py_window_fingerprints(codes, read_len):
    os.environ["GAML_TPU_NO_NATIVE"] = "1"
    try:
        # bypass the native dispatch by calling the numpy body directly
        from gaml_tpu.index import maxhash as mh
        from numpy.lib.stride_tricks import sliding_window_view

        k = mh.K_INDEX_KMER
        if len(codes) < k or len(codes) < read_len:
            return []
        h = mh.hash_kmers(mh.pack_kmers(codes, k))
        w = read_len - k + 1
        if w <= 0:
            return []
        wins = sliding_window_view(h, w)
        maxv = wins.max(axis=1)
        argm = wins.argmax(axis=1)
        out = []
        last = None
        for s in range(len(wins)):
            v = int(maxv[s])
            if last is None or v != last:
                out.append((v, int(s + argm[s] + k - 1)))
                last = v
        return out
    finally:
        del os.environ["GAML_TPU_NO_NATIVE"]


@pytest.mark.parametrize("seed", range(5))
def test_native_maxhash_matches_python(seed):
    rng = np.random.default_rng(seed)
    codes = dna.encode_seq(random_seq(rng, 500))
    for read_len in (20, 35, 101):
        assert native.maxhash_window_query(codes, read_len) == \
            _py_window_fingerprints(codes, read_len)


@pytest.mark.parametrize("seed", range(5))
def test_native_process_hit_matches_python(seed):
    from gaml_tpu.align.bfs import process_hit

    rng = np.random.default_rng(100 + seed)
    seq = dna.encode_seq(random_seq(rng, 400))
    triples = []
    for _ in range(60):
        rlen = int(rng.integers(25, 60))
        pos = int(rng.integers(0, len(seq) - rlen))
        read = seq[pos:pos + rlen].copy()
        for _ in range(int(rng.integers(0, 4))):
            i = int(rng.integers(0, len(read)))
            roll = rng.random()
            if roll < 0.6:
                read[i] = (read[i] + 1 + int(rng.integers(0, 3))) % 4
            elif roll < 0.8 and len(read) > 25:
                read = np.delete(read, i)
            else:
                read = np.insert(read, i, int(rng.integers(0, 4)))
        # pick an exact seed if any
        hay = seq.tobytes()
        for rp in range(len(read) - 15 + 1):
            gp = hay.find(read[rp:rp + 15].tobytes())
            if gp >= 0:
                triples.append((gp, rp, read))
                break
    assert triples
    got = native.process_hit_batch(seq, triples)
    for (g0, r0, read), res in zip(triples, got):
        expect = process_hit(g0, r0, read, seq)
        if expect is None:
            assert res is None
        else:
            assert res == (expect[0], expect[1])


def test_native_reachability_matches_python():
    rng = np.random.default_rng(9)
    gr, _ = make_linear_graph(rng, [600, 50, 700, 60, 800])
    gr.add_arc(0, 4)  # extra edge

    import copy

    gr_py = copy.deepcopy(gr)
    os.environ["GAML_TPU_NO_NATIVE"] = "1"
    try:
        import gaml_tpu.native as nat

        # force python fallback by monkeypatching get_lib via env is not
        # enough (lib cached); call the python bodies through a fresh path
        nat_lib = nat._lib
        nat._lib = None
        nat._tried = True
        gr_py.calc_reachability_limit(200)
        gr_py.calc_reachability_big(500)
        nat._lib = nat_lib
    finally:
        del os.environ["GAML_TPU_NO_NATIVE"]

    gr.calc_reachability_limit(200)
    gr.calc_reachability_big(500)
    assert gr.reach_limit == gr_py.reach_limit
    assert gr.reach_big == gr_py.reach_big


@pytest.mark.parametrize("min_cost", [False, True])
def test_align_windows_batch_matches_serial(tmp_path, min_cost):
    """OpenMP batch alignment == serial align_window per window (both
    extensions: the 0-1 BFS and the min-cost DP)."""
    from fixtures import sample_reads, write_fastq
    from gaml_tpu.scoring.readset import ReadSet

    rng = np.random.default_rng(7)
    genome = random_seq(rng, 3000)
    reads = sample_reads(rng, genome, 300, 60, err_rate=0.01)
    fq = tmp_path / "b.fastq"
    write_fastq(str(fq), reads)
    rs = ReadSet("b", str(fq), 0.96, 0.01)
    rs.preprocess_reads()
    rs.prepare_read_index()
    bundle = rs.aligner.native_bundle
    assert bundle is not None
    seqs = [dna.encode_seq(genome[a:a + ln])
            for a, ln in ((0, 200), (100, 400), (700, 90), (1500, 800),
                          (40, 61), (2900, 100))]
    offsets = [5, 0, 17, 3, 0, 2]
    batch = native.align_windows_batch(bundle, seqs, offsets,
                                       min_cost=min_cost)
    assert len(batch) == len(seqs)
    for seq, off, got in zip(seqs, offsets, batch):
        exp = native.align_window(bundle, seq, off, min_cost=min_cost)
        for a, b in zip(got, exp):
            np.testing.assert_array_equal(a, b)


def _indel_reads(rng, genome, n, read_len, err):
    """Reads with substitutions, insertions and deletions (rate ``err``
    each), both strands — the cases where the 0-1 BFS and the min-cost
    DP can disagree."""
    out = []
    for _ in range(n):
        p = int(rng.integers(0, len(genome) - 2 * read_len))
        r, g = [], p
        while len(r) < read_len:
            u = rng.random()
            if u < err:
                r.append("ACGT"[int(rng.integers(0, 4))])
                g += 1
            elif u < 2 * err:
                r.append("ACGT"[int(rng.integers(0, 4))])
            elif u < 3 * err:
                g += 1
            else:
                r.append(genome[g])
                g += 1
        s = "".join(r)
        out.append(dna.revcomp_str(s) if rng.random() < 0.5 else s)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_min_cost_window_matches_device_route(tmp_path, seed):
    """align_window(min_cost=True) is bit-identical to the device
    backend's route (native candidate query -> staged jnp banded DP ->
    first-wins (position, read) dedup), so the device backend's results
    never depend on which route served a batch."""
    from fixtures import write_fastq
    from gaml_tpu.ops.extend import extend_staged, stage_candidates_uniform
    from gaml_tpu.scoring.readset import ReadSet

    rng = np.random.default_rng(seed)
    genome = random_seq(rng, 4000)
    fq = tmp_path / "mc.fastq"
    write_fastq(str(fq), _indel_reads(rng, genome, 600, 60, 0.02))
    rs = ReadSet(str(tmp_path / "mc"), str(fq), 0.96, 0.01)
    rs.preprocess_reads()
    rs.prepare_read_index()
    bundle = rs.aligner.native_bundle
    seq = dna.encode_seq(genome)
    offset = 7

    (rid, g0, r0, orient), = native.query_windows_batch(bundle, [seq])
    n = len(rid)
    st = stage_candidates_uniform(
        seq, np.zeros(1, np.int64), np.array([len(seq)]),
        np.zeros(n, np.int64), g0, r0, bundle.row_of[rid], orient,
        bundle.codes_fwd, bundle.codes_rc, read_ids=rid)
    ok, errs, begin = extend_staged(st, use_pallas=False)
    pos = begin.astype(np.int64) + 1 + offset
    seen, want = set(), []
    for i in np.nonzero(ok)[0]:  # emission order: first insert wins
        if (pos[i], rid[i]) not in seen:
            seen.add((pos[i], rid[i]))
            want.append((pos[i], rid[i], errs[i], orient[i]))
    want.sort(key=lambda t: (t[0], t[1]))
    got = native.align_window(bundle, seq, offset, min_cost=True)
    assert len(want) > 150
    np.testing.assert_array_equal(got[0], [w[0] for w in want])
    np.testing.assert_array_equal(got[2], [w[1] for w in want])
    np.testing.assert_array_equal(got[1], [w[2] for w in want])
    np.testing.assert_array_equal(got[3], [w[3] for w in want])
    # the BFS charges some indel alignments more (never less): the
    # world exercises the difference
    bfs = native.align_window(bundle, seq, offset)
    cost = {(p, r): e for p, r, e in zip(bfs[0], bfs[2], bfs[1])}
    fewer = [cost.get((p, r), e) - e for p, r, e in
             zip(got[0], got[2], got[1])]
    assert min(fewer) >= 0 and max(fewer) > 0


def test_coverage_sweep_matches_python():
    from gaml_tpu.scoring.paired import _coverage_sweep

    rng = np.random.default_rng(11)
    for trial in range(10):
        n = int(rng.integers(0, 200))
        pos = rng.integers(0, 5000, n).astype(np.int32)
        typ = rng.choice([1, 3], n).astype(np.int32)
        events = list(zip(pos.tolist(), typ.tolist()))
        exp = _coverage_sweep(events, 300.0, 25.0, 70.0)
        got = native.coverage_sweep(pos, typ, 70.0, 300.0 + 5 * 25.0)
        assert got == exp


def test_read_index_build_matches_numpy():
    """Native one-pass ingestion == the numpy pipeline (pack_kmers_batch,
    revcomp_kmers, maxhash_of_reads_batch, seed-position precompute)."""
    from gaml_tpu.index.maxhash import (
        HASH_XOR, maxhash_of_reads_batch, pack_kmers_batch, revcomp_kmers)

    rng = np.random.default_rng(5)
    n, L = 300, 80
    codes = rng.integers(0, 4, (n, L)).astype(np.uint8)
    codes[7, 3] = 4  # one read with an N
    codes[100, 0] = 4
    fp, ok, kmers, rc, seed = native.read_index_build(codes, 15)

    exp_kmers = pack_kmers_batch(codes, 15)
    np.testing.assert_array_equal(kmers, exp_kmers)
    exp_rc = revcomp_kmers(exp_kmers, 15)[:, ::-1]
    np.testing.assert_array_equal(rc, exp_rc)
    np.testing.assert_array_equal(fp, maxhash_of_reads_batch(codes))
    exp_ok = ~(codes >= 4).any(axis=1)
    np.testing.assert_array_equal(ok.astype(bool), exp_ok)
    # seed positions: first fingerprint k-mer in each orientation
    hashes = exp_kmers ^ np.uint32(HASH_XOR)
    target = hashes.max(axis=1) ^ np.uint32(HASH_XOR)
    target_rc = revcomp_kmers(target, 15)
    pos_f = np.argmax(exp_kmers == target[:, None], axis=1)
    pos_r = np.argmax(exp_rc == target_rc[:, None], axis=1)
    np.testing.assert_array_equal(seed[:, 0], pos_f)
    np.testing.assert_array_equal(seed[:, 1], pos_r)


def test_reduce_floored_logs_matches_numpy():
    rng = np.random.default_rng(6)
    for n in (0, 1, 5, 1000):
        logp = np.log(rng.random(n) * 1e-4 + 1e-30)
        logp[rng.random(n) < 0.1] = -np.inf
        logt = -10.0 + -0.7 * rng.integers(50, 150, n).astype(np.float64)
        c = np.log(2 * 12345.0)
        s, z = native.reduce_floored_logs(logp, logt, c)
        adj = logp - c
        assert z == int(np.count_nonzero(adj < logt))
        assert s == pytest.approx(float(np.sum(np.maximum(adj, logt))),
                                  rel=1e-12, abs=1e-12)


def test_banded_forward_host_matches_jnp():
    """Native host banded forward == the jnp kernel (same band), ~1e-5."""
    import jax.numpy as jnp

    from gaml_tpu.ops.forward import banded_forward

    rng = np.random.default_rng(21)
    glen, b, rmax, width = 700, 5, 256, 64
    genome = rng.integers(0, 4, glen).astype(np.uint8)
    reads = np.full((b, rmax), 6, dtype=np.uint8)
    rlens = np.zeros(b, dtype=np.int32)
    centers = np.zeros((b, rmax + 1), dtype=np.int32)
    gstarts = np.zeros(b, dtype=np.int32)
    glens = np.full(b, glen, dtype=np.int32)
    for i in range(b):
        L = int(rng.integers(50, rmax))
        start = int(rng.integers(0, glen - L))
        r = genome[start:start + L].copy()
        errs = rng.random(L) < 0.1
        r[errs] = (r[errs] + 1) % 4
        reads[i, :L] = r
        rlens[i] = L
        c = start + np.arange(rmax + 1)
        centers[i] = np.minimum(c, glen - 1)
    lm, lx = float(np.log(0.85)), float(np.log(0.05))
    host = native.banded_forward_host(genome, reads, rlens, centers,
                                      gstarts, glens, lm, lx, width)
    dev = np.asarray(banded_forward(
        jnp.asarray(genome), jnp.asarray(reads), jnp.asarray(rlens),
        jnp.asarray(centers), jnp.asarray(gstarts), jnp.asarray(glens),
        lm, lx, rmax, width))
    np.testing.assert_allclose(host, dev, rtol=2e-4, atol=1e-3)
