"""Flagship device models: jittable likelihood forward steps.

These wrap the ops-layer kernels into "model" objects with a stable
forward signature — the unit the driver compile-checks (__graft_entry__)
and the building block the parallel layer shards.  Three model families
mirror the reference's read-set kinds:

- SingleEndModel: candidates -> banded extension -> dedup -> floored
  mean-log score (reference CalcScoreForPaths single, graph.cc:1650-1743);
- PairedEndModel: dense per-read position lists -> innie pair products with
  the insert-size Gaussian -> floored mean-log score (reference
  graph.cc:1991-2127);
- the PacBio banded-forward kernel is exposed via ops.forward and
  scoring.pacbio (its batches are staged per walk).
"""
from __future__ import annotations

import functools


import numpy as np


class LikelihoodModel:
    """Shared config for the device likelihood models."""

    def __init__(self, match_prob: float = 0.96, mismatch_prob: float = 0.01,
                 min_prob_per_base: float = -0.7, min_prob_start: float = -10.0):
        self.match_prob = match_prob
        self.mismatch_prob = mismatch_prob
        self.min_prob_per_base = min_prob_per_base
        self.min_prob_start = min_prob_start

    @property
    def log_match(self) -> float:
        return float(np.log(self.match_prob))

    @property
    def log_mismatch(self) -> float:
        return float(np.log(self.mismatch_prob))


class SingleEndModel(LikelihoodModel):
    def forward_fn(self, rmax: int, n_reads: int):
        """Returns the jittable forward step (positional array args; see
        ops.score.single_end_forward)."""
        from ..ops.score import single_end_forward

        return functools.partial(single_end_forward, rmax=rmax,
                                 n_reads=n_reads)

    def score_candidates(self, seq, cands, n_reads: int, read_lens,
                         total_len: int):
        """Host convenience: stage + run the forward step on one candidate
        batch.  Returns (score, zero_reads, read_probs)."""
        import jax.numpy as jnp

        from ..ops.extend import stage_candidates

        g0s = np.array([c.genome_pos for c, _ in cands], dtype=np.int32)
        r0s = np.array([c.read_pos for c, _ in cands], dtype=np.int32)
        rids = np.array([c.read_id for c, _ in cands], dtype=np.int32)
        st = stage_candidates(seq, g0s, r0s, [r for _, r in cands],
                              read_ids=rids)
        fn = self.forward_fn(st["rmax"], n_reads)
        args = (
            jnp.asarray(st["read_f"]), jnp.asarray(st["rlen_f"]),
            jnp.asarray(st["gwin_f"]), jnp.asarray(st["glen_f"]),
            jnp.asarray(st["read_b"]), jnp.asarray(st["rlen_b"]),
            jnp.asarray(st["gwin_b"]), jnp.asarray(st["glen_b"]),
            jnp.asarray(st["g0"]), jnp.asarray(st["r0"]),
            jnp.asarray(st["valid"]), jnp.asarray(st["read_id"]),
            jnp.asarray(st["read_len"]), jnp.asarray(st["at_start"]),
            jnp.asarray(np.asarray(read_lens, dtype=np.int32)),
            jnp.float32(self.log_match), jnp.float32(self.log_mismatch),
            jnp.int32(total_len), jnp.float32(self.min_prob_per_base),
            jnp.float32(self.min_prob_start),
        )
        score, zeros, probs = fn(*args)
        return float(score), int(zeros), np.asarray(probs)


class PairedEndModel(LikelihoodModel):
    def __init__(self, insert_mean: float, insert_std: float, **kw):
        super().__init__(**kw)
        self.insert_mean = insert_mean
        self.insert_std = insert_std

    def score_positions(self, positions1, positions2, n_reads: int,
                        len1, len2, total_len: int, k_cap: int = None):
        """Dense-stage two mates' position lists and run the device pair
        product (ops.pair).  Returns (score, zero_reads, read_probs).

        k_cap defaults to the TRUE maximum per-read position count — no
        silent truncation; pass a smaller cap only to trade accuracy for
        shape (the bucketed production path is parallel.paired_sharded)."""
        import jax.numpy as jnp

        from ..ops.pair import paired_score_device, stage_positions_dense

        if k_cap is None:
            k_cap = max(
                [len(p) for p in positions1] + [len(p) for p in positions2]
                + [1])
        p1, e1, o1, d1 = stage_positions_dense(positions1, n_reads, k_cap)
        p2, e2, o2, d2 = stage_positions_dense(positions2, n_reads, k_cap)
        if d1 or d2:
            import logging

            logging.getLogger(__name__).warning(
                "PairedEndModel k_cap=%d dropped %d positions", k_cap,
                d1 + d2)
        score, zeros, probs = paired_score_device(
            jnp.asarray(p1), jnp.asarray(e1), jnp.asarray(o1),
            jnp.asarray(np.asarray(len1, np.int32)),
            jnp.asarray(p2), jnp.asarray(e2), jnp.asarray(o2),
            jnp.asarray(np.asarray(len2, np.int32)),
            self.log_match, self.log_mismatch, float(self.insert_mean),
            float(self.insert_std), total_len, self.min_prob_per_base,
            self.min_prob_start)
        return float(score), int(zeros), np.asarray(probs)
