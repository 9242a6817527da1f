"""Sharded PacBio reduction vs the host scorer (SURVEY section 5.8 —
the last model family without a mesh story in round 1)."""
import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from gaml_tpu.parallel.pacbio_sharded import calc_score_for_pacbio_sharded
from gaml_tpu.scoring.pacbio_score import calc_score_for_pacbio

from fixtures import make_linear_graph
from test_pacbio import PB_MATCH, make_pb_readset


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
def test_sharded_pacbio_matches_host(tmp_path, x64, mesh_shape):
    rng = np.random.default_rng(21)
    gr, seqs = make_linear_graph(rng, [900, 120, 1100, 90, 800])
    rs, _reads = make_pb_readset(tmp_path, gr, seqs, rng, n_reads=14,
                                 rlen=500, err=0.08, name=f"ps{mesh_shape[0]}")
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(mesh_shape),
                ("reads", "cand"))
    for paths in ([[0, 2, 4, 6, 8]], [[0, 2, 4], [6, 8]], [[0, 2, -30, 8]]):
        host = calc_score_for_pacbio(gr, paths, rs, no_cov_penalty=1e-4,
                                     exp_cov_move=100)
        dev = calc_score_for_pacbio_sharded(gr, paths, rs, mesh,
                                            no_cov_penalty=1e-4,
                                            exp_cov_move=100)
        assert dev[1] == host[1], paths
        assert dev[2] == host[2], paths
        assert dev[0] == pytest.approx(host[0], rel=1e-9, abs=1e-9), paths


def test_sharded_pacbio_forward_on_mesh(tmp_path, x64):
    """The forward-DP compute itself runs under the mesh: a fresh read set
    with ShardedPacbioScorer.forward_batch installed as its forward
    executor fills its cache entirely via the sharded kernel, and the
    score matches the host-kernel path to reassociation accuracy."""
    from gaml_tpu.parallel.pacbio_sharded import ShardedPacbioScorer

    rng = np.random.default_rng(33)
    gr, seqs = make_linear_graph(rng, [900, 120, 1100, 90, 800])
    rs_host, _ = make_pb_readset(tmp_path, gr, seqs, rng, n_reads=12,
                                 rlen=450, err=0.08, name="fwdh")
    rng = np.random.default_rng(33)
    gr2, seqs2 = make_linear_graph(rng, [900, 120, 1100, 90, 800])
    rs_mesh, _ = make_pb_readset(tmp_path, gr2, seqs2, rng, n_reads=12,
                                 rlen=450, err=0.08, name="fwdm")
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(8, 1),
                ("reads", "cand"))
    scorer = ShardedPacbioScorer(mesh)
    rs_mesh.forward_dispatch = scorer.forward_batch
    paths = [[0, 2, 4], [6, 8]]
    host = calc_score_for_pacbio(gr, paths, rs_host, no_cov_penalty=1e-4,
                                 exp_cov_move=100)
    dev = calc_score_for_pacbio_sharded(gr2, paths, rs_mesh, mesh,
                                        no_cov_penalty=1e-4,
                                        exp_cov_move=100, scorer=scorer)
    assert rs_mesh.dp_cells.get("mesh", 0) > 0
    assert "native" not in rs_mesh.dp_cells and "jnp" not in rs_mesh.dp_cells
    assert dev[1] == host[1]
    assert dev[2] == host[2]
    assert dev[0] == pytest.approx(host[0], rel=1e-6, abs=1e-6)


def test_sharded_forward_batch_matches_unsharded(x64):
    """forward_batch under shard_map is bit-identical per job to the
    unsharded jnp kernel (the job axis is purely data-parallel)."""
    from gaml_tpu.ops.forward import banded_forward
    from gaml_tpu.parallel.pacbio_sharded import ShardedPacbioScorer
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    G, B, rmax, width = 3000, 11, 256, 64
    genome = rng.integers(0, 4, G).astype(np.uint8)
    reads = np.full((B, rmax), 6, np.uint8)
    rlens = rng.integers(100, rmax, B).astype(np.int32)
    centers = np.zeros((B, rmax + 1), np.int32)
    for i in range(B):
        L = int(rlens[i])
        p = int(rng.integers(0, G - L - 10))
        reads[i, :L] = genome[p:p + L]
        centers[i, :L + 1] = p + np.arange(L + 1)
        centers[i, L + 1:] = p + L
    gstarts = np.zeros(B, np.int32)
    glens = np.full(B, G, np.int32)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(8, 1),
                ("reads", "cand"))
    sc = ShardedPacbioScorer(mesh)
    lm, lmm = float(np.log(0.85)), float(np.log(0.05))
    got = sc.forward_batch(genome, reads, rlens, centers, gstarts, glens,
                           lm, lmm, rmax, width)
    # unsharded reference on the SAME padded target buffer
    g_pad = 4096
    g = np.full(g_pad, 9, np.uint8)
    g[:G] = genome
    want = np.asarray(banded_forward(
        jnp.asarray(g), jnp.asarray(reads), jnp.asarray(rlens),
        jnp.asarray(centers), jnp.asarray(gstarts), jnp.asarray(glens),
        lm, lmm, rmax, width))
    np.testing.assert_array_equal(got, want)


def test_prob_calculator_pacbio_forward_on_mesh(tmp_path, x64):
    """enable_sharded_pacbio installs the mesh forward executor on the
    read sets; calc_prob scores match the host calculator."""
    from gaml_tpu.scoring.calculator import ProbCalculator
    from gaml_tpu.scoring.config import SingleReadConfig

    rng = np.random.default_rng(55)
    gr, seqs = make_linear_graph(rng, [900, 120, 1100, 90, 800])
    rs_host, _ = make_pb_readset(tmp_path, gr, seqs, rng, n_reads=10,
                                 rlen=400, err=0.08, name="pch")
    rng = np.random.default_rng(55)
    gr2, seqs2 = make_linear_graph(rng, [900, 120, 1100, 90, 800])
    rs_mesh, _ = make_pb_readset(tmp_path, gr2, seqs2, rng, n_reads=10,
                                 rlen=400, err=0.08, name="pcm")
    cfg = SingleReadConfig(penalty_constant=1e-4, step=100)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2),
                ("reads", "cand"))
    pc_host = ProbCalculator([], [], [(cfg, rs_host)], gr)
    pc_dev = ProbCalculator([], [], [(cfg, rs_mesh)], gr2)
    pc_dev.enable_sharded_pacbio(mesh)
    for paths in ([[0, 2, 4, 6, 8]], [[0, 2, 4], [6, 8]]):
        zh, zd = [], []
        sh, tlh = pc_host.calc_prob(paths, zh)
        sd, tld = pc_dev.calc_prob(paths, zd)
        assert tld == tlh
        assert zd == zh
        assert sd == pytest.approx(sh, rel=1e-6, abs=1e-6)
    assert rs_mesh.dp_cells.get("mesh", 0) > 0
