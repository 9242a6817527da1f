"""PacBio subsystem: anchors, cached walk scoring, gap estimation."""
import numpy as np
import pytest

from gaml_tpu.core import dna
from gaml_tpu.scoring.pacbio import PacbioReadSet
from gaml_tpu.scoring.pacbio_score import calc_score_for_pacbio

from fixtures import make_linear_graph, random_seq, write_fastq
from test_forward_kernel import noisy_copy

PB_MATCH = 0.85
PB_MISMATCH = (1 - PB_MATCH) / 2  # reference convention: 1-2*(1-m) floor


def make_pb_readset(tmp_path, graph, seqs, rng, n_reads=12, rlen=600,
                    err=0.1, name="pb"):
    genome = "".join(seqs)
    reads = []
    for _ in range(n_reads):
        p = int(rng.integers(0, max(1, len(genome) - rlen)))
        r = noisy_copy(rng, dna.encode_seq(genome[p:p + rlen]), err=err)
        if rng.random() < 0.5:
            r = dna.revcomp(r)
        reads.append(dna.decode_seq(r))
    fq = tmp_path / f"{name}.fq"
    write_fastq(str(fq), reads, prefix="pb")
    rs = PacbioReadSet(str(tmp_path / name), str(fq), PB_MATCH, 0.05)
    rs.preprocess_reads()
    rs.compute_anchors(graph, persist=False)
    return rs, reads


def test_anchors_cover_spanned_nodes(tmp_path):
    rng = np.random.default_rng(0)
    gr, seqs = make_linear_graph(rng, [400, 60, 500])
    rs, reads = make_pb_readset(tmp_path, gr, seqs, rng, n_reads=10,
                                rlen=700, err=0.08)
    # long reads spanning the junction anchor on both long nodes
    assert rs.anchors_cache.get(0) or rs.anchors_cache.get(1)
    assert rs.anchors_cache.get(4) or rs.anchors_cache.get(5)
    # reverse index consistent with begin anchors
    for node, rids in rs.anchors_begin.items():
        for rid in rids:
            assert node in rs.anchors_reverse[rid]


def test_read_probabilities_cache_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    gr, seqs = make_linear_graph(rng, [400, 60, 500])
    rs, _ = make_pb_readset(tmp_path, gr, seqs, rng, n_reads=6, rlen=500)
    walk = [0, 2, 4]
    pos1, tl1 = rs.get_read_probabilities(gr, walk)
    # second call must come purely from cache and agree
    pos2, tl2 = rs.get_read_probabilities(gr, walk)
    assert tl1 == tl2 == sum(len(s) for s in seqs)
    assert pos1 == pos2
    n_hits = sum(len(p) for p in pos1)
    assert n_hits >= 4  # most reads align somewhere


def test_pacbio_scorer_prefers_true_walk(tmp_path):
    rng = np.random.default_rng(2)
    gr, seqs = make_linear_graph(rng, [500, 80, 500, 80, 500])
    rs, _ = make_pb_readset(tmp_path, gr, seqs, rng, n_reads=14, rlen=800,
                            err=0.08)
    true_walk = [[0, 2, 4, 6, 8]]
    # scrambled: long nodes in wrong order
    wrong_walk = [[4, 2, 0], [8, 6]]
    s_true, z_true, _ = calc_score_for_pacbio(gr, true_walk, rs)
    rs2, _ = make_pb_readset(tmp_path, gr, seqs, rng, n_reads=14, rlen=800,
                             err=0.08, name="pb2")
    s_wrong, z_wrong, _ = calc_score_for_pacbio(gr, wrong_walk, rs2)
    assert np.isfinite(s_true)
    assert s_true > s_wrong


def test_get_gap_estimates_distance(tmp_path):
    rng = np.random.default_rng(3)
    gr, seqs = make_linear_graph(rng, [500, 500])
    gap_true = 150
    bridge = seqs[0] + random_seq(rng, gap_true) + seqs[1]
    # read spanning end of node0 across the gap into node1
    read_seq = bridge[200:900]
    fq = tmp_path / "gap.fq"
    write_fastq(str(fq), [read_seq], prefix="g")
    rs = PacbioReadSet(str(tmp_path / "gaprs"), str(fq), PB_MATCH, 0.05)
    rs.preprocess_reads()
    est = rs.get_gap(gr, 0, 2, 0)
    assert est >= 0
    assert abs(est - gap_true) < 40


def test_production_band_vs_exact_reference_band(tmp_path):
    """The production chain-guided band scorer must agree with the exact
    reference CIGAR-band DP (diagnostics.exact_pacbio — itself pinned
    bit-close to the reference binary in test_reference_differential) on
    per-walk scores: both bands capture the dominant alignment mass."""
    from gaml_tpu.diagnostics.exact_pacbio import ExactPacbioReadSet

    rng = np.random.default_rng(11)
    gr, seqs = make_linear_graph(rng, [900, 120, 1200])
    rs_prod, reads = make_pb_readset(tmp_path, gr, seqs, rng, n_reads=10,
                                     rlen=400, err=0.08, name="pbe")
    rs_exact = ExactPacbioReadSet(str(tmp_path / "pbe_x"),
                                  str(tmp_path / "pbe.fq"),
                                  PB_MATCH, 0.05)
    rs_exact.preprocess_reads()
    rs_exact.compute_anchors(gr, persist=False)
    paths = [[0, 2, 4]]
    sp, zp, tlp = calc_score_for_pacbio(gr, paths, rs_prod)
    se, ze, tle = calc_score_for_pacbio(gr, paths, rs_exact)
    assert tlp == tle
    assert sp == pytest.approx(se, rel=0.02), (sp, se)


def _device_route_on(monkeypatch):
    """Take the GPU platform's forward-DP route on the CPU: the route is
    plain jnp (ops.forward.banded_forward), so the same code runs."""
    monkeypatch.setattr(PacbioReadSet, "_device_route",
                        staticmethod(lambda: True))


def _spy_forward(monkeypatch, calls, fail=False):
    import gaml_tpu.ops.forward as fwd

    real = fwd.banded_forward

    def spy(genome, reads, *a):
        calls.append((tuple(reads.shape), int(genome.shape[0]), a[-2:]))
        if fail:
            raise RuntimeError("device compile failed")
        return real(genome, reads, *a)

    monkeypatch.setattr(fwd, "banded_forward", spy)


def _assert_matches_native(pos_nat, pos_dev):
    for p_n, p_d in zip(pos_nat, pos_dev):
        assert len(p_n) == len(p_d)
        for (sp_n, lp_n), (sp_d, lp_d) in zip(p_n, p_d):
            assert sp_n == sp_d
            # f32 device accumulation vs the f64 native kernel
            assert lp_d == pytest.approx(lp_n, rel=1e-4, abs=1e-3)


def test_forward_batch_chunked_device_route(tmp_path, monkeypatch):
    """The device route chunks every forward batch to ONE fixed
    (GAML_PB_CHUNK, rmax-class) dispatch shape (tail rounds up, read axis
    pads to the read set's longest read, walk buffer pads to its bucket)
    and reassembles chunk outputs in job order — scores must match the
    native f64 route and every dispatch must carry the same shape (one
    compiled executable for the whole run)."""
    rng = np.random.default_rng(21)
    gr, seqs = make_linear_graph(rng, [900, 120, 1200])
    rs_nat, _ = make_pb_readset(tmp_path, gr, seqs, np.random.default_rng(9),
                                n_reads=160, rlen=400, err=0.08, name="pbc_n")
    rs_dev, _ = make_pb_readset(tmp_path, gr, seqs, np.random.default_rng(9),
                                n_reads=160, rlen=400, err=0.08, name="pbc_d")
    walk = [0, 2, 4]
    pos_nat, tl_nat = rs_nat.get_read_probabilities(gr, walk)

    calls = []
    _spy_forward(monkeypatch, calls)
    _device_route_on(monkeypatch)
    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", "0")
    monkeypatch.setenv("GAML_DEV_EAGER", "1")
    monkeypatch.setenv("GAML_PB_CHUNK", "32")

    pos_dev, tl_dev = rs_dev.get_read_probabilities(gr, walk)
    assert calls, "device route never dispatched"
    assert len(set(calls)) == 1, set(calls)
    (shape, g_pad, (rmax_cls, width)), = set(calls)
    assert shape == (32, rmax_cls) and rmax_cls % 128 == 0
    assert rmax_cls >= max(len(r) for r in rs_dev.read_seq)
    assert g_pad == PacbioReadSet.seq_bucket(sum(len(x) for x in seqs))
    assert width == rs_dev.forward_width
    assert len(calls) >= 2  # the anchored batch exceeded one chunk
    assert rs_dev.dp_cells.get("device", 0) > 0
    assert not rs_dev.dp_cells.get("native")
    assert tl_dev == tl_nat
    _assert_matches_native(pos_nat, pos_dev)


def test_device_route_after_prewarm_matches_native(tmp_path, monkeypatch):
    """Without GAML_DEV_EAGER the warm-up router gates the device route:
    after prewarm_device marks the read set's executables ready, walk
    batches go to the device (no native cells) and match the native
    f64 route."""
    from gaml_tpu.utils import warmup

    rng = np.random.default_rng(77)
    gr, seqs = make_linear_graph(rng, [800, 120, 900])
    rs_nat, _ = make_pb_readset(tmp_path, gr, seqs, np.random.default_rng(5),
                                n_reads=60, rlen=300, err=0.08, name="pbr_n")
    rs_dev, _ = make_pb_readset(tmp_path, gr, seqs, np.random.default_rng(5),
                                n_reads=60, rlen=300, err=0.08, name="pbr_d")
    walk = [0, 2, 4]
    pos_nat, tl_nat = rs_nat.get_read_probabilities(gr, walk)

    _device_route_on(monkeypatch)
    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", "0")
    monkeypatch.delenv("GAML_DEV_EAGER", raising=False)
    monkeypatch.setenv("GAML_PB_CHUNK", "16")
    monkeypatch.setenv("GAML_PB_PREWARM_SMAX", "32768")

    rs_dev.prewarm_device()
    assert rs_dev.dp_cells == {}
    key = rs_dev._warm_key(16, rs_dev._dev_rmax_class,
                           sum(len(x) for x in seqs), rs_dev.forward_width)
    assert warmup._STATE.get(key) is True

    pos_dev, tl_dev = rs_dev.get_read_probabilities(gr, walk)
    assert rs_dev.dp_cells.get("device", 0) > 0
    assert not rs_dev.dp_cells.get("native")
    assert tl_dev == tl_nat
    _assert_matches_native(pos_nat, pos_dev)


def test_prewarm_failure_raises(tmp_path, monkeypatch):
    """A device compile that fails in the prewarm raises there, and a
    later batch that needs the executable raises too — it is never
    served natively for the rest of the run."""
    from gaml_tpu.utils import warmup

    rng = np.random.default_rng(41)
    gr, seqs = make_linear_graph(rng, [600, 80, 700])
    rs, _ = make_pb_readset(tmp_path, gr, seqs, rng, n_reads=8, rlen=300,
                            name="pbf")
    calls = []
    _spy_forward(monkeypatch, calls, fail=True)
    _device_route_on(monkeypatch)
    monkeypatch.setenv("GAML_PB_CHUNK", "8")
    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", "0")
    monkeypatch.delenv("GAML_DEV_EAGER", raising=False)
    monkeypatch.setenv("GAML_PB_PREWARM_SMAX", "32768")
    with pytest.raises(RuntimeError, match="device compile failed"):
        rs.prewarm_device()
    with pytest.raises(warmup.WarmupError):
        rs.get_read_probabilities(gr, [0, 2, 4])


def test_f32_route_anneal_quality_bound(tmp_path, monkeypatch):
    """Enforce the PARITY.md device-route divergence bound at anneal
    scale: the same seeded anneal run on the exact f64 native forward
    kernel and on the f32 jnp kernel (the device route's accumulation
    class — ~1e-5 per-batch drift can flip accept decisions) must reach
    quality-equivalent final assemblies and near-identical best scores."""
    import sys as sys_mod

    from gaml_tpu.core.io import output_paths_to_file
    from gaml_tpu.optimize.anneal import Optimizer
    from gaml_tpu.optimize.settings import AssemblySettings
    from gaml_tpu.scoring.calculator import ProbCalculator
    from gaml_tpu.scoring.config import SingleReadConfig

    rng = np.random.default_rng(8)
    gr, seqs = make_linear_graph(
        rng, [2200, 150, 2500, 120, 2300, 200, 2400])
    genome = "".join(seqs)

    def run(tag, f32):
        rs, _ = make_pb_readset(tmp_path, gr, seqs,
                                np.random.default_rng(4), n_reads=30,
                                rlen=1000, err=0.08, name=f"f32b_{tag}")
        cfg = SingleReadConfig(penalty_constant=0.0001, step=100)
        pc = ProbCalculator([], [], [(cfg, rs)], gr)
        settings = AssemblySettings(
            threshold=500, max_iterations=120, seed=47,
            output_prefix=str(tmp_path / f"o{tag}"))
        opt = Optimizer(gr, pc, settings, advice_pacbio=[rs],
                        longest_read=1000, log=lambda *a: None)
        opt.prepare()
        if f32:
            import gaml_tpu.native as native

            monkeypatch.setattr(native, "get_lib", lambda: None)
            monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", "0")
        paths = [[i] for i in range(0, gr.num_nodes, 2)
                 if gr.node_len(i) > 500]
        best = opt.run(paths, write_outputs=False)
        assert (rs.dp_cells.get("jnp", 0) > 0) == f32
        output_paths_to_file(best, gr, 47, 500,
                             str(tmp_path / f"fin{tag}"))
        sys_mod.path.insert(0, str(REPO_TOOLS))
        from asm_quality import assembly_quality

        q = assembly_quality(genome, str(tmp_path / f"fin{tag}.fasta"))
        return float(opt.best_prob), q

    s64, q64 = run("64", False)
    s32, q32 = run("32", True)
    # f32 accept flips may alter the trajectory, but the final assembly
    # must be equivalent and the best score within the drift band
    assert abs(s32 - s64) < 0.05, (s32, s64)
    assert abs(q32["kmer_recall"] - q64["kmer_recall"]) <= 0.005, (q32, q64)
    assert q32["kmer_junk"] <= q64["kmer_junk"] + 0.001
    assert q64["ng50"] == 0 or \
        0.95 <= q32["ng50"] / q64["ng50"] <= 1.06, (q32, q64)


import os as _os_p  # noqa: E402

REPO_TOOLS = _os_p.path.join(_os_p.path.dirname(_os_p.path.dirname(
    _os_p.path.abspath(__file__))), "tools")


def test_prewarm_device_marks_router_ready(tmp_path, monkeypatch):
    """prewarm_device dispatches exactly one full dummy chunk per walk
    bucket eagerly, marks each warm-up-router key ready, leaves the
    routing env vars alone and clears the profiling counters; off the
    device route (the CPU platform) it is a no-op."""
    from gaml_tpu.utils import warmup

    rng = np.random.default_rng(33)
    gr, seqs = make_linear_graph(rng, [600, 80, 700])
    rs, _ = make_pb_readset(tmp_path, gr, seqs, rng, n_reads=6, rlen=300,
                            name="pbw")
    calls = []
    _spy_forward(monkeypatch, calls)
    monkeypatch.setenv("GAML_PB_CHUNK", "4")
    monkeypatch.setenv("GAML_PB_PREWARM_SMAX", "131072")

    rs.prewarm_device()  # CPU platform: no device route
    assert not calls

    _device_route_on(monkeypatch)
    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", "999999999")
    eager_before = os_mod.environ.get("GAML_DEV_EAGER")
    rs.prewarm_device()
    assert [c[1] for c in calls] == [32768, 131072]
    assert {c[0] for c in calls} == {(4, rs._dev_rmax_class)}
    for g_pad in (32768, 131072):
        key = ("pb_forward", 4, rs._dev_rmax_class, g_pad,
               rs.forward_width)
        assert warmup._STATE.get(key) is True
    assert rs.dp_cells == {}
    assert os_mod.environ.get("GAML_PB_DEVICE_MIN_CELLS") == "999999999"
    assert os_mod.environ.get("GAML_DEV_EAGER") == eager_before


import os as os_mod  # noqa: E402


def test_score_batch_pacbio_union_prefill(tmp_path):
    """score_batch fills the union of all candidates' missing PacBio
    windows in ONE forward-DP batch; scores must equal the sequential
    per-candidate path exactly (per-job kernel outputs are independent
    of batch membership)."""
    from gaml_tpu.scoring.calculator import ProbCalculator
    from gaml_tpu.scoring.config import SingleReadConfig

    rng = np.random.default_rng(17)
    gr, seqs = make_linear_graph(rng, [700, 90, 800])
    rs_seq, _ = make_pb_readset(tmp_path, gr, seqs, np.random.default_rng(4),
                                n_reads=8, rlen=400, name="pbsb_a")
    rs_bat, _ = make_pb_readset(tmp_path, gr, seqs, np.random.default_rng(4),
                                n_reads=8, rlen=400, name="pbsb_b")
    cfg = SingleReadConfig(penalty_constant=1e-4, step=100)
    cands = [[[0, 2, 4]], [[0, 2], [4]], [[4, 2, 0]]]

    pc_seq = ProbCalculator([], [], [(cfg, rs_seq)], gr)
    want = [pc_seq.score(c) for c in cands]

    calls = []
    orig = rs_bat._forward_batch

    def counting(seq, jobs, extents=None):
        calls.append(len(jobs))
        return orig(seq, jobs, extents)

    rs_bat._forward_batch = counting
    pc_bat = ProbCalculator([], [], [(cfg, rs_bat)], gr)
    got = pc_bat.score_batch(cands)
    assert got == want, (got, want)
    # the union prefill serves every candidate: exactly one fill batch
    assert len(calls) == 1, calls
