"""Sharded paired-end scoring vs the host incremental (live-path) scorer.

SURVEY.md section 5.8: the paired pipeline's pair
products + floored reduction run under shard_map with psum/psum_scatter
over the mesh "reads" axis; scores must equal the production host scorer
(calc_score_for_paths_incremental, reference graph.cc:1952-1989) on the
8-virtual-device CPU mesh, with NO silent position-count truncation.
"""
import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from gaml_tpu.parallel.paired_sharded import (
    calc_score_for_paths_paired_sharded,
    stage_paired_rows,
)
from gaml_tpu.scoring.paired import (
    ScoringState,
    calc_score_for_paths_incremental,
)

from fixtures import make_linear_graph
from test_scoring import make_pairs, make_readset


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _world(tmp_path, seed=0, n_pairs=60):
    rng = np.random.default_rng(seed)
    gr, seqs = make_linear_graph(rng, [600, 90, 500, 120, 550])
    genome = "".join(seqs)
    L, im, istd = 28, 220, 20
    m1, m2 = make_pairs(rng, genome, n_pairs, L, im, istd)
    rs1 = make_readset(tmp_path, m1, f"sp1_{seed}")
    rs2 = make_readset(tmp_path, m2, f"sp2_{seed}")
    return gr, rs1, rs2, im, istd


def _host_score(gr, rs1, rs2, im, istd, paths, **kw):
    return calc_score_for_paths_incremental(
        gr, paths, rs1, rs2, im, istd, ScoringState(), **kw)


WALKSETS = [
    [[0, 2, 4, 6, 8]],
    [[0, 2, 4], [6, 8]],
    [[0, 2, -35, 6, 8]],          # gap entry
    [[0, 2, 4, 6, 8], [0, 2]],    # duplicated prefix walk
    [[8, 6], [0]],                # reversed-ish fragments
]


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_paired_matches_host(tmp_path, x64, mesh_shape):
    gr, rs1, rs2, im, istd = _world(tmp_path)
    devices = np.asarray(jax.devices()[:8]).reshape(mesh_shape)
    mesh = Mesh(devices, ("reads", "cand"))
    kw = dict(no_cov_penalty=1e-4, exp_cov_move=150, use_all_to_cov=True)
    for paths in WALKSETS:
        host = _host_score(gr, rs1, rs2, im, istd, paths, **kw)
        dev = calc_score_for_paths_paired_sharded(
            gr, paths, rs1, rs2, im, istd, mesh, **kw)
        assert dev[1] == host[1], paths          # zero_reads
        assert dev[2] == host[2], paths          # total_len
        assert dev[0] == pytest.approx(host[0], rel=1e-9, abs=1e-9), paths


def test_sharded_paired_no_events_path(tmp_path, x64):
    """penalty == 0 skips device event extraction; score still matches."""
    gr, rs1, rs2, im, istd = _world(tmp_path, seed=3)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(8, 1),
                ("reads", "cand"))
    paths = [[0, 2, 4, 6, 8]]
    host = _host_score(gr, rs1, rs2, im, istd, paths)
    dev = calc_score_for_paths_paired_sharded(
        gr, paths, rs1, rs2, im, istd, mesh)
    assert dev[0] == pytest.approx(host[0], rel=1e-9)
    assert dev[1] == host[1]


def test_prob_calculator_sharded_paired(tmp_path, x64):
    """ProbCalculator.enable_sharded_paired routes paired sets through the
    mesh scorer; scores match the host incremental path."""
    from gaml_tpu.scoring.calculator import ProbCalculator
    from gaml_tpu.scoring.config import PairedReadConfig

    gr, rs1, rs2, im, istd = _world(tmp_path, seed=5)
    cfg = PairedReadConfig(insert_mean=im, insert_std=istd,
                           penalty_constant=1e-4, step=150)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2),
                ("reads", "cand"))
    pc_host = ProbCalculator([], [(cfg, (rs1, rs2))], [], gr)
    pc_dev = ProbCalculator([], [(cfg, (rs1, rs2))], [], gr)
    pc_dev.enable_sharded_paired(mesh)
    for paths in ([[0, 2, 4, 6, 8]], [[0, 2, 4], [6, 8]], [[0, 2, -20, 8]]):
        zh, zd = [], []
        sh, tlh = pc_host.calc_prob(paths, zh)
        sd, tld = pc_dev.calc_prob(paths, zd)
        assert tld == tlh
        assert zd == zh
        assert sd == pytest.approx(sh, rel=1e-9, abs=1e-9)


def test_stage_rows_no_truncation(tmp_path, x64):
    """Every (walk, read) row is staged with ALL its positions — the
    fix for a silent drop past k_cap=12."""
    gr, rs1, rs2, im, istd = _world(tmp_path, seed=7, n_pairs=40)
    paths = [[0, 2, 4, 6, 8], [0, 2, 4]]
    buckets, walk_events, total_len = stage_paired_rows(gr, paths, rs1, rs2,
                                                        row_align=4)
    assert len(walk_events) == 2
    # independently collect the live-path positions per walk
    from gaml_tpu.parallel.paired_sharded import _collect_walk_rows

    expect = {}
    for w, path in enumerate(paths):
        g1, g2, _ev = _collect_walk_rows(gr, path, rs1, rs2)
        c1 = dict(zip(g1[0].tolist(), g1[2].tolist()))
        c2 = dict(zip(g2[0].tolist(), g2[2].tolist()))
        for rid in set(c1) & set(c2):
            expect[(w, rid)] = (c1[rid], c2[rid])
    staged = {}
    for b in buckets:
        for row in range(b["pos1"].shape[0]):
            if not b["mask"][row]:
                assert (b["pos1"][row] == -1).all()
                continue
            key = (int(b["walk"][row]), int(b["rid"][row]))
            assert key not in staged
            staged[key] = (int((b["pos1"][row] >= 0).sum()),
                           int((b["pos2"][row] >= 0).sum()))
    assert staged == expect
    assert sum(v[0] for v in staged.values()) > 0


def test_collect_walk_rows_python_fallback(tmp_path, x64, monkeypatch):
    """The pure-Python position collection (no native library) must match
    the native grouped collection row for row."""
    import gaml_tpu.parallel.paired_sharded as ps

    gr, rs1, rs2, im, istd = _world(tmp_path, seed=13, n_pairs=30)
    path = [0, 2, 4, 6, 8]
    g1n, g2n, evn = ps._collect_walk_rows(gr, path, rs1, rs2)
    monkeypatch.setattr("gaml_tpu.native.get_lib", lambda: None)
    g1p, g2p, evp = ps._collect_walk_rows(gr, path, rs1, rs2)
    assert evn == evp
    for gn, gp in ((g1n, g1p), (g2n, g2p)):
        assert np.array_equal(gn[0], gp[0])          # rids
        assert np.array_equal(gn[2], gp[2])          # counts
        # per-read position lists identical (offsets may differ)
        for rid, st_n, ct, st_p in zip(gn[0], gn[1], gn[2], gp[1]):
            for col in (3, 4, 5):
                assert np.array_equal(gn[col][st_n:st_n + ct],
                                      gp[col][st_p:st_p + ct]), rid


def test_incremental_sharded_matches_host_sequence(tmp_path, x64):
    """The mesh-backed incremental scorer — signed
    per-walk deltas psum_scatter'd into DeviceScoringState — tracks the
    host incremental scorer across a whole move sequence (adds, erases,
    duplicated walks, gaps), per-step and with persistent state."""
    from gaml_tpu.parallel.paired_sharded import (
        calc_score_for_paths_incremental_sharded)

    gr, rs1, rs2, im, istd = _world(tmp_path, seed=11)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(8, 1),
                ("reads", "cand"))
    kw = dict(no_cov_penalty=1e-4, exp_cov_move=150, use_all_to_cov=True)
    st_host = ScoringState()
    st_dev = ScoringState()
    sequence = [
        [[0, 2, 4, 6, 8]],
        [[0, 2, 4], [6, 8]],                 # break
        [[0, 2, 4], [6, 8], [0, 2, 4]],      # duplicate walk added
        [[0, 2, 4], [6, 8]],                 # duplicate erased again
        [[0, 2, -35, 6, 8]],                 # gap walk replaces both
        [[0, 2, 4, 6, 8]],                   # back to the start walk
    ]
    for paths in sequence:
        host = calc_score_for_paths_incremental(
            gr, paths, rs1, rs2, im, istd, st_host, **kw)
        dev = calc_score_for_paths_incremental_sharded(
            gr, paths, rs1, rs2, im, istd, st_dev, mesh, **kw)
        assert dev[2] == host[2], paths          # total_len
        assert dev[1] == host[1], paths          # zero_reads
        assert dev[0] == pytest.approx(host[0], rel=1e-9, abs=1e-9), paths
        assert st_dev.bad_bases == st_host.bad_bases, paths
    # the device running totals match the host state after the sequence
    np.testing.assert_allclose(st_dev.device.to_host(), st_host.probs,
                               rtol=1e-9, atol=1e-300)


def test_incremental_sharded_stages_only_changes(tmp_path, x64,
                                                 monkeypatch):
    """Per-move staging cost is O(changed walks): after the first call,
    a one-walk move stages exactly the erased + added walks."""
    import gaml_tpu.parallel.paired_sharded as ps

    gr, rs1, rs2, im, istd = _world(tmp_path, seed=17)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(8, 1),
                ("reads", "cand"))
    st = ScoringState()
    base = [[0, 2], [4], [6, 8]]
    ps.calc_score_for_paths_incremental_sharded(
        gr, base, rs1, rs2, im, istd, st, mesh)

    staged = []
    real = ps.stage_paired_rows

    def spy(graph, paths, *a, **k):
        staged.append([list(p) for p in paths])
        return real(graph, paths, *a, **k)

    monkeypatch.setattr(ps, "stage_paired_rows", spy)
    moved = [[0, 2], [4, 6, 8]]              # erase [4] + [6,8], add [4,6,8]
    ps.calc_score_for_paths_incremental_sharded(
        gr, moved, rs1, rs2, im, istd, st, mesh)
    flat = sorted(sum(staged, []))
    assert flat == sorted([[4], [6, 8], [4, 6, 8]])
    staged.clear()
    ps.calc_score_for_paths_incremental_sharded(
        gr, moved, rs1, rs2, im, istd, st, mesh)   # no-op move
    assert staged == []


def test_prob_calculator_incremental_sharded(tmp_path, x64):
    """ProbCalculator wiring: enable_sharded_paired(incremental=True)
    routes per-move scoring through the mesh deltas; trajectory matches
    the host incremental calculator across a walk-set sequence."""
    from gaml_tpu.scoring.calculator import ProbCalculator
    from gaml_tpu.scoring.config import PairedReadConfig

    gr, rs1, rs2, im, istd = _world(tmp_path, seed=23)
    cfg = PairedReadConfig(insert_mean=im, insert_std=istd,
                           penalty_constant=1e-4, step=150)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2),
                ("reads", "cand"))
    pc_host = ProbCalculator([], [(cfg, (rs1, rs2))], [], gr)
    pc_dev = ProbCalculator([], [(cfg, (rs1, rs2))], [], gr)
    pc_dev.enable_sharded_paired(mesh, incremental=True)
    for paths in ([[0, 2, 4, 6, 8]], [[0, 2, 4], [6, 8]],
                  [[0, 2, -20, 8]], [[0, 2, 4, 6, 8]]):
        zh, zd = [], []
        sh, tlh = pc_host.calc_prob(paths, zh)
        sd, tld = pc_dev.calc_prob(paths, zd)
        assert tld == tlh
        assert zd == zh
        assert sd == pytest.approx(sh, rel=1e-9, abs=1e-9)


def test_mesh_backed_anneal_trajectory_matches_host(tmp_path, x64):
    """The incremental mesh scorer drives a REAL anneal: fixed-seed runs
    with the host incremental calculator and the mesh-backed incremental
    calculator accept the same moves and land on the same best walks."""
    from gaml_tpu.optimize.anneal import Optimizer
    from gaml_tpu.optimize.settings import AssemblySettings
    from gaml_tpu.scoring.calculator import ProbCalculator
    from gaml_tpu.scoring.config import PairedReadConfig
    from test_optimizer import build_world

    gr, pc_host, _genome = build_world(tmp_path, seed=29, n_pairs=30)
    gr2, pc_dev, _ = build_world(tmp_path, seed=29, n_pairs=30)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(8, 1),
                ("reads", "cand"))
    pc_dev.enable_sharded_paired(mesh, incremental=True)

    def run(gr_, pc_, prefix):
        settings = AssemblySettings(threshold=500,
                                    output_prefix=str(tmp_path / prefix),
                                    max_iterations=25, seed=7)
        opt = Optimizer(gr_, pc_, settings, longest_read=250,
                        log=lambda *a: None)
        best = opt.run([[0], [4], [8]])
        return best, opt.best_prob

    best_h, prob_h = run(gr, pc_host, "host")
    best_d, prob_d = run(gr2, pc_dev, "dev")
    assert [list(w) for w in best_d] == [list(w) for w in best_h]
    assert prob_d == pytest.approx(prob_h, rel=1e-9, abs=1e-9)
