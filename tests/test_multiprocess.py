"""The REAL scoring pipeline under multiprocess JAX (SURVEY.md section
4(e)): two OS processes, each indexing only its
own read shard, run the sharded single-end scorer over one global mesh;
the psum-merged score must equal the single-process score.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import mp_common as mc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _single_process_paired_expected():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from gaml_tpu.parallel.paired_sharded import ShardedPairedScorer

    mesh = Mesh(np.asarray(jax.devices()[:mc.N_ROWS]).reshape(mc.N_ROWS, 1),
                ("reads", "cand"))
    scorer = ShardedPairedScorer(mesh, np.log(0.96), np.log(0.01),
                                 np.log(0.96), np.log(0.01),
                                 mc.PAIRED_IM, mc.PAIRED_ISTD,
                                 dtype=jnp.float32, collect_events=False)
    blk = mc.paired_row_block(0, mc.PAIRED_ROWS)
    n_pad = ((mc.PAIRED_N_READS + mc.N_ROWS - 1) // mc.N_ROWS) * mc.N_ROWS
    local, _ev = scorer.bucket_products(blk, n_pad, -0.7, -10.0)
    lens = np.full(n_pad, 2 * mc.PAIRED_L, dtype=np.float32)
    lmask = np.zeros(n_pad, bool)
    lmask[:mc.PAIRED_N_READS] = True
    from jax.sharding import NamedSharding, PartitionSpec as P

    shp = NamedSharding(mesh, P("reads"))
    s, z = scorer.reduce(local, jax.device_put(jnp.asarray(lens), shp),
                         jax.device_put(jnp.asarray(lmask), shp),
                         n_pad, mc.PAIRED_N_READS, 1000.0, -0.7, -10.0)
    return float(s), int(z)


def _single_process_inc_expected():
    """Expected incremental result: block A scored alone (the +A +B -B
    sequence in the child must cancel B's contribution)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from gaml_tpu.parallel.paired_sharded import ShardedPairedScorer

    mesh = Mesh(np.asarray(jax.devices()[:mc.N_ROWS]).reshape(mc.N_ROWS, 1),
                ("reads", "cand"))
    scorer = ShardedPairedScorer(mesh, np.log(0.96), np.log(0.01),
                                 np.log(0.96), np.log(0.01),
                                 mc.PAIRED_IM, mc.PAIRED_ISTD,
                                 dtype=jnp.float32, collect_events=False)
    blk = mc.paired_inc_block("A", 0, mc.PAIRED_BLK)
    n_pad = ((mc.PAIRED_N_READS + mc.N_ROWS - 1) // mc.N_ROWS) * mc.N_ROWS
    local, _ev = scorer.bucket_products(blk, n_pad, -0.7, -10.0)
    lens = np.full(n_pad, 2 * mc.PAIRED_L, dtype=np.float32)
    lmask = np.zeros(n_pad, bool)
    lmask[:mc.PAIRED_N_READS] = True
    shp = NamedSharding(mesh, P("reads"))
    s, z = scorer.reduce(local, jax.device_put(jnp.asarray(lens), shp),
                         jax.device_put(jnp.asarray(lmask), shp),
                         n_pad, mc.PAIRED_N_READS, 1000.0, -0.7, -10.0)
    return float(s), int(z)


def _single_process_pacbio_expected():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from gaml_tpu.parallel.pacbio_sharded import ShardedPacbioScorer

    mesh = Mesh(np.asarray(jax.devices()[:mc.N_ROWS]).reshape(mc.N_ROWS, 1),
                ("reads", "cand"))
    scorer = ShardedPacbioScorer(mesh, dtype=jnp.float32)
    rid, lp, _mask = mc.pacbio_rows(0, mc.PB_ROWS)
    s, z = scorer.score(rid, lp, mc.PB_N_READS,
                        np.full(mc.PB_N_READS, mc.PB_READ_LEN),
                        mc.PB_TOTAL_LEN, -0.7, -10.0)
    return float(s), int(z)


def _single_process_expected():
    import jax
    from jax.sharding import Mesh

    seq, reads = mc.build_world()
    nb = mc.round_nb(max(mc.local_nb(seq, reads, [r])
                         for r in range(mc.N_ROWS)))
    staged, lens_mask, n_reads_local = mc.stage_for_rows(
        seq, reads, list(range(mc.N_ROWS)), nb)
    mesh = Mesh(np.asarray(jax.devices()[:mc.N_ROWS]).reshape(mc.N_ROWS, 1),
                ("reads", "cand"))
    from gaml_tpu.parallel.sharded import sharded_single_end_score

    score, zeros = sharded_single_end_score(
        mesh, staged, lens_mask, float(np.log(mc.MATCH)),
        float(np.log(mc.MISMATCH)), mc.GENOME_LEN, -0.7, -10.0, mc.RMAX,
        n_reads_local, mc.N_READS)
    return float(score), int(zeros)


def test_two_process_pipeline_matches_single(tmp_path):
    expected_score, expected_zeros = _single_process_expected()
    exp_paired_score, exp_paired_zeros = _single_process_paired_expected()
    exp_pb_score, exp_pb_zeros = _single_process_pacbio_expected()

    port = _free_port()
    nproc = 2
    procs = []
    outs = []
    for p in range(nproc):
        out = tmp_path / f"mp_out_{p}.json"
        outs.append(out)
        env = dict(os.environ)
        env.pop("PYTEST_CURRENT_TEST", None)
        env.update({
            "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
            "JAX_PLATFORMS": "cpu",
            "GAML_MP_COORD": f"127.0.0.1:{port}",
            "GAML_MP_NPROC": str(nproc),
            "GAML_MP_PROC": str(p),
            "GAML_MP_OUT": str(out),
        })
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "mp_child.py")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    for proc in procs:
        stdout, _ = proc.communicate(timeout=540)
        logs.append(stdout.decode(errors="replace"))
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log[-3000:]

    results = [json.loads(out.read_text()) for out in outs]
    # forward-DP job outputs are per-process local slices (different
    # jobs); everything else is replicated psum-merged state
    fwd_vals = [r.pop("fwd_vals") for r in results]
    assert len(fwd_vals[0]) + len(fwd_vals[1]) == mc.PB_FWD_JOBS
    # both processes hold the same replicated psum-merged result
    assert results[0] == results[1]
    assert results[0]["zeros"] == expected_zeros
    assert results[0]["score"] == pytest.approx(expected_score, rel=1e-6)
    # paired model (pair products + psum_scatter + floored reduction)
    assert results[0]["paired_zeros"] == exp_paired_zeros
    assert results[0]["paired_score"] == pytest.approx(exp_paired_score,
                                                       rel=1e-6)
    # PacBio model (sharded log-sum-exp + floored psum reduction)
    assert results[0]["pacbio_zeros"] == exp_pb_zeros
    assert results[0]["pacbio_score"] == pytest.approx(exp_pb_score,
                                                       rel=1e-6)
    # PacBio forward DP under the mesh: each process's sharded per-job
    # outputs equal the unsharded kernel on the same jobs
    assert results[0]["fwd_ok"] and results[1]["fwd_ok"]
    # incremental bucket_apply: +A +B -B into device-resident totals ==
    # scoring A alone (f32 cancellation tolerance), replicated across
    # processes
    exp_inc_score, exp_inc_zeros = _single_process_inc_expected()
    assert results[0]["inc_zeros"] == exp_inc_zeros
    assert results[0]["inc_score"] == pytest.approx(exp_inc_score,
                                                    rel=2e-5)


def test_cli_distributed_wiring(tmp_path):
    """`gaml-tpu --distributed` / GAML_COORD initializes jax.distributed
    before the run (single-process here; the scoring pipeline's
    multiprocess behavior is covered above)."""
    import numpy as np

    from fixtures import lastgraph_text, random_seq, write_fastq
    from test_scoring import make_pairs

    rng = np.random.default_rng(0)
    seqs = [random_seq(rng, 700), random_seq(rng, 80), random_seq(rng, 800)]
    (tmp_path / "LastGraph").write_text(lastgraph_text(seqs, [(1, 2), (2, 3)]))
    genome = "".join(seqs)
    m1, m2 = make_pairs(rng, genome, 20, 30, 250, 25)
    write_fastq(str(tmp_path / "m1.fq"), m1)
    write_fastq(str(tmp_path / "m2.fq"), m2)
    cfg = tmp_path / "run.cfg"
    cfg.write_text(f"""graph={tmp_path}/LastGraph
max_iterations=3
output_prefix={tmp_path}/out
seed=3

[lib]
type=paired
filename1={tmp_path}/m1.fq
filename2={tmp_path}/m2.fq
insert_mean=250
insert_std=25
cache_prefix={tmp_path}/c
""")
    port = _free_port()
    env = dict(os.environ)
    env.pop("PYTEST_CURRENT_TEST", None)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "GAML_COORD": f"127.0.0.1:{port}",
        "GAML_NPROC": "1",
        "GAML_PROC_ID": "0",
        "PYTHONPATH": REPO,
    })
    proc = subprocess.run(
        [sys.executable, "-m", "gaml_tpu.cli", str(cfg)],
        env=env, cwd=tmp_path, capture_output=True, timeout=540)
    assert proc.returncode == 0, proc.stdout.decode()[-2000:]
    assert (tmp_path / "out.fasta").exists()
