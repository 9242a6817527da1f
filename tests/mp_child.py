"""Multiprocess JAX worker: index own read shard, stage locally, score on
the GLOBAL mesh, write the psum-merged replicated result.

Env: GAML_MP_COORD, GAML_MP_NPROC, GAML_MP_PROC, GAML_MP_OUT.
XLA_FLAGS / JAX_PLATFORMS must be set by the spawner (before python
starts).
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=os.environ["GAML_MP_COORD"],
        num_processes=int(os.environ["GAML_MP_NPROC"]),
        process_id=int(os.environ["GAML_MP_PROC"]))
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import mp_common as mc

    n_dev = len(jax.devices())
    assert n_dev == mc.N_ROWS, (n_dev, mc.N_ROWS)
    n_local = len(jax.local_devices())
    proc = int(os.environ["GAML_MP_PROC"])
    my_rows = list(range(proc * n_local, (proc + 1) * n_local))

    seq, reads = mc.build_world()
    # each process indexes ONLY its own rows' reads
    nb_local = mc.local_nb(seq, reads, my_rows)
    nb_all = multihost_utils.process_allgather(
        np.array([nb_local], dtype=np.int64))
    nb = mc.round_nb(int(nb_all.max()))

    staged_local, (lens_l, mask_l), n_reads_local = mc.stage_for_rows(
        seq, reads, my_rows, nb)

    mesh = Mesh(np.asarray(jax.devices()).reshape(mc.N_ROWS, 1),
                ("reads", "cand"))
    sh2 = NamedSharding(mesh, P("reads", "cand"))
    sh1 = NamedSharding(mesh, P("reads"))
    staged = {k: jax.make_array_from_process_local_data(sh2, v)
              for k, v in staged_local.items()}
    lens_g = jax.make_array_from_process_local_data(sh1, lens_l)
    mask_g = jax.make_array_from_process_local_data(sh1, mask_l)

    from gaml_tpu.parallel.sharded import sharded_single_end_score

    score, zeros = sharded_single_end_score(
        mesh, staged, (lens_g, mask_g), float(np.log(mc.MATCH)),
        float(np.log(mc.MISMATCH)), mc.GENOME_LEN, -0.7, -10.0, mc.RMAX,
        n_reads_local, mc.N_READS)
    # paired model on the same global mesh: each process builds only its
    # own reads-shard slice of the pair rows and the per-read reduction
    # inputs (parallel.paired_sharded shard_maps)
    from gaml_tpu.parallel.paired_sharded import ShardedPairedScorer

    scorer = ShardedPairedScorer(mesh, np.log(0.96), np.log(0.01),
                                 np.log(0.96), np.log(0.01),
                                 mc.PAIRED_IM, mc.PAIRED_ISTD,
                                 collect_events=False)
    rows_per_shard = mc.PAIRED_ROWS // mc.N_ROWS
    lo = proc * n_local * rows_per_shard
    hi = (proc + 1) * n_local * rows_per_shard
    blk = mc.paired_row_block(lo, hi)
    shp = NamedSharding(mesh, P("reads"))
    args = [jax.make_array_from_process_local_data(shp, blk[k])
            for k in ("pos1", "ed1", "or1", "pos2", "ed2", "or2",
                      "rid", "len1", "len2", "mask")]
    np_dt = np.float32
    args += [jnp.asarray(-0.7, dtype=np_dt), jnp.asarray(-10.0, dtype=np_dt)]
    n_pad = ((mc.PAIRED_N_READS + mc.N_ROWS - 1) // mc.N_ROWS) * mc.N_ROWS
    local = scorer.bucket_fn((mc.PAIRED_ROWS, mc.PAIRED_K), n_pad)(*args)
    lens = np.full(n_pad, 2 * mc.PAIRED_L, dtype=np_dt)
    lmask = np.zeros(n_pad, bool)
    lmask[:mc.PAIRED_N_READS] = True
    n_loc2 = n_pad // mc.N_ROWS
    sl2 = slice(proc * n_local * n_loc2, (proc + 1) * n_local * n_loc2)
    lens_g = jax.make_array_from_process_local_data(shp, lens[sl2])
    mask_g = jax.make_array_from_process_local_data(shp, lmask[sl2])
    ps, pz = scorer.reduce_fn(n_pad, mc.PAIRED_N_READS)(
        local, lens_g, mask_g, jnp.asarray(1000.0, dtype=np_dt),
        jnp.asarray(-0.7, dtype=np_dt), jnp.asarray(-10.0, dtype=np_dt))

    # PacBio model on the same global mesh: each process builds only its
    # own reads-shard slice of the (rid, logprob) hit rows; the sharded
    # log-sum-exp + floored reduction psum-merges across processes
    from gaml_tpu.parallel.pacbio_sharded import ShardedPacbioScorer

    pb_scorer = ShardedPacbioScorer(mesh, dtype=jnp.float32)
    pb_pad = ((mc.PB_N_READS + mc.N_ROWS - 1) // mc.N_ROWS) * mc.N_ROWS
    rows_ps = mc.PB_ROWS // mc.N_ROWS
    rid_l, lp_l, mask_l2 = mc.pacbio_rows(proc * n_local * rows_ps,
                                          (proc + 1) * n_local * rows_ps)
    floors, lmask_pb = mc.pacbio_reduction_inputs(pb_pad)
    n_loc3 = pb_pad // mc.N_ROWS
    sl3 = slice(proc * n_local * n_loc3, (proc + 1) * n_local * n_loc3)
    pb_args = (
        jax.make_array_from_process_local_data(shp, rid_l),
        jax.make_array_from_process_local_data(shp, lp_l),
        jax.make_array_from_process_local_data(shp, mask_l2),
        jax.make_array_from_process_local_data(shp, floors[sl3]),
        jax.make_array_from_process_local_data(shp, lmask_pb[sl3]),
        jnp.asarray(mc.PB_TOTAL_LEN, dtype=np_dt),
        jnp.asarray(mc.PB_N_READS, dtype=jnp.int32))
    pbs, pbz = pb_scorer.score_fn(mc.PB_ROWS, pb_pad, mc.PB_N_READS)(*pb_args)

    # PacBio forward DP on the mesh (forward_batch's shard_map): each
    # process stages only its own rows' jobs; per-job outputs must equal
    # the unsharded kernel on the same jobs (pure data parallelism)
    genome, reads_f, rlens_f, centers_f, gst_f, gl_f = mc.pb_forward_world()
    jobs_ps = mc.PB_FWD_JOBS // mc.N_ROWS
    slf = slice(proc * n_local * jobs_ps, (proc + 1) * n_local * jobs_ps)
    fwd_fn = pb_scorer.forward_fn(mc.PB_FWD_JOBS, len(genome),
                                  mc.PB_FWD_RMAX, mc.PB_FWD_WIDTH)
    fwd_out = fwd_fn(
        jnp.asarray(genome),
        jax.make_array_from_process_local_data(shp, reads_f[slf]),
        jax.make_array_from_process_local_data(shp, rlens_f[slf]),
        jax.make_array_from_process_local_data(shp, centers_f[slf]),
        jax.make_array_from_process_local_data(shp, gst_f[slf]),
        jax.make_array_from_process_local_data(shp, gl_f[slf]),
        jnp.asarray(mc.PB_FWD_LM, dtype=jnp.float32),
        jnp.asarray(mc.PB_FWD_LMM, dtype=jnp.float32))
    from gaml_tpu.ops.forward import banded_forward

    exp_local = np.asarray(banded_forward(
        jnp.asarray(genome), jnp.asarray(reads_f[slf]),
        jnp.asarray(rlens_f[slf]), jnp.asarray(centers_f[slf]),
        jnp.asarray(gst_f[slf]), jnp.asarray(gl_f[slf]),
        jnp.asarray(mc.PB_FWD_LM, dtype=jnp.float32),
        jnp.asarray(mc.PB_FWD_LMM, dtype=jnp.float32),
        mc.PB_FWD_RMAX, mc.PB_FWD_WIDTH))
    pairs = [(s.index[0].start or 0, np.asarray(s.data).ravel())
             for s in fwd_out.addressable_shards]
    fwd_local = np.concatenate(
        [d for _i, d in sorted(pairs, key=lambda t: t[0])])
    fwd_ok = bool(np.allclose(fwd_local, exp_local, rtol=1e-6, atol=1e-6))

    # incremental bucket_apply: +A +B -B into device-resident totals must
    # equal scoring block A alone (modulo f32 add/sub cancellation — the
    # reference's sequential += / -= has the same cancellation class)
    blk_ps = mc.PAIRED_BLK // mc.N_ROWS
    lo2b = proc * n_local * blk_ps
    hi2b = (proc + 1) * n_local * blk_ps
    apply_fn = scorer.bucket_fn((mc.PAIRED_BLK, mc.PAIRED_K), n_pad,
                                apply=True)
    from gaml_tpu.parallel.paired_sharded import pack_bucket

    def blk_packed(which):
        # pack the LOCAL row block, then lift to one global mesh array
        b = mc.paired_inc_block(which, lo2b, hi2b)
        return jax.make_array_from_process_local_data(shp, pack_bucket(b))

    mppb = jnp.asarray(-0.7, dtype=np_dt)
    mps = jnp.asarray(-10.0, dtype=np_dt)
    probs = jax.make_array_from_process_local_data(
        shp, np.zeros(n_pad // mc.N_ROWS * n_local, dtype=np_dt))
    args_a = blk_packed("A")
    args_b = blk_packed("B")
    for sign, packed in ((1.0, args_a), (1.0, args_b), (-1.0, args_b)):
        probs = apply_fn(probs, jnp.asarray(sign, dtype=np_dt), packed,
                         mppb, mps)
    incs, incz = scorer.reduce_fn(n_pad, mc.PAIRED_N_READS)(
        probs, lens_g, mask_g, jnp.asarray(1000.0, dtype=np_dt), mppb, mps)

    out = {"score": float(score), "zeros": int(zeros), "nb": nb,
           "paired_score": float(ps), "paired_zeros": int(pz),
           "pacbio_score": float(pbs), "pacbio_zeros": int(pbz),
           "fwd_ok": fwd_ok, "fwd_vals": [float(x) for x in fwd_local],
           "inc_score": float(incs), "inc_zeros": int(incz)}
    with open(os.environ["GAML_MP_OUT"], "w") as f:
        json.dump(out, f)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
