"""Device likelihood pipeline (single-end model).

This is the flagship jittable computation: a batch of seed candidates runs
through the banded-extension kernel, per-candidate alignment probabilities
``mm^ed * m^(L-ed)`` are deduplicated by (read, position) and segment-summed
into per-read totals, which reduce to the GAML score
(mean floored log of read_prob / (2*total_len); reference
graph.cc:1482-1537).

Everything is static-shape: candidates are padded with ``valid`` masks, the
dedup is a sort + neighbor-compare instead of a hash set, and the reduction
is a masked segment-sum — the static-shape form of the reference's
hash-map + per-read loops.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .extend import extend_kernel

INT32_BIG = jnp.int32(2**31 - 1)


def dedup_alignments(read_id, begin, good):
    """Drop duplicate (read, begin) alignments (set<Aligment> semantics,
    graph.cc:895-897) with int32-safe keys: lexsort by (read_id, begin)
    pushing invalid entries to the end, keep the first of each run.
    Returns (order, keep_mask_in_sorted_order)."""
    rid_key = jnp.where(good, read_id, INT32_BIG)
    pos_key = jnp.where(good, begin, INT32_BIG)
    order = jnp.lexsort((pos_key, rid_key))
    rid_s = rid_key[order]
    pos_s = pos_key[order]
    first = jnp.concatenate([
        jnp.array([True]),
        (rid_s[1:] != rid_s[:-1]) | (pos_s[1:] != pos_s[:-1])])
    return order, good[order] & first


def dedup_sort_payload(read_id, begin, good, payloads):
    """One stable multi-key sort carrying payloads (replaces the two-pass
    lexsort + post-gathers): sorts by (read_id, begin) with invalid rows
    pushed to the end, returns (rid_sorted, keep_mask, sorted_payloads).
    First-of-run in stable order = the reference's first-wins map insert."""
    rid_key = jnp.where(good, read_id, INT32_BIG)
    pos_key = jnp.where(good, begin, INT32_BIG)
    out = jax.lax.sort((rid_key, pos_key, good.astype(jnp.int32))
                       + tuple(payloads), num_keys=2, is_stable=True)
    rid_s, pos_s, good_s = out[0], out[1], out[2]
    first = jnp.concatenate([
        jnp.array([True]),
        (rid_s[1:] != rid_s[:-1]) | (pos_s[1:] != pos_s[:-1])])
    return rid_s, (good_s == 1) & first, out[3:]


@functools.partial(jax.jit, static_argnames=("n_reads",))
def candidates_to_score(ok, errs, begin, valid, read_id, read_len,
                        read_lens_all, log_match, log_mismatch,
                        total_len, min_prob_per_base, min_prob_start,
                        n_reads: int):
    """Reduce per-candidate alignment results to the assembly score.

    ok/errs/begin: extension outputs [N]; valid: padding mask [N];
    read_id/read_len: per-candidate read metadata [N];
    read_lens_all: [n_reads] true per-read lengths (for the floor of reads
    with no alignments).  Returns (score, zero_reads, read_probs)."""
    good = ok & valid
    rid_s, good_s, (errs_s, rlen_s) = dedup_sort_payload(
        read_id, begin, good, (errs, read_len))

    p = jnp.exp(errs_s * log_mismatch + (rlen_s - errs_s) * log_match)
    p = jnp.where(good_s, p, 0.0)
    read_probs = jax.ops.segment_sum(
        p, jnp.where(good_s, rid_s, n_reads), num_segments=n_reads + 1)[:-1]
    return reduce_read_probs(read_probs, read_lens_all, total_len,
                             min_prob_per_base, min_prob_start)


def reduce_read_probs(read_probs, lens, total_len, min_prob_per_base,
                      min_prob_start):
    """GetTotalProb on device (graph.cc:1518-1537).  ``lens`` must carry
    each read's length (reads with no alignments still need a length for
    the floor; caller may pass the true length array instead of the
    segment_max fallback)."""
    tl = jnp.maximum(total_len, 1)
    probs = read_probs / (2.0 * tl)
    thresholds = jnp.exp(min_prob_start + min_prob_per_base * lens)
    floored = probs < thresholds
    zero_reads = jnp.sum(floored.astype(jnp.int32))
    probs = jnp.where(floored, thresholds, probs)
    score = jnp.sum(jnp.log(probs)) / probs.shape[0]
    return score, zero_reads, read_probs


def single_end_forward(read_f, rlen_f, gwin_f, glen_f,
                       read_b, rlen_b, gwin_b, glen_b,
                       g0, r0, valid, read_id, read_len, at_start,
                       read_lens_all, log_match, log_mismatch, total_len,
                       min_prob_per_base, min_prob_start,
                       rmax: int, n_reads: int):
    """Full single-chip forward step: extension + reduction.

    This is what __graft_entry__.entry() exposes."""
    ok, errs, d_back = extend_kernel(read_f, rlen_f, gwin_f, glen_f,
                                     read_b, rlen_b, gwin_b, glen_b, rmax)
    begin = g0 - r0 - d_back
    ok = jnp.where(at_start, ok & (r0 < 6), ok)
    errs = jnp.where(at_start, errs + r0, errs)
    begin = jnp.where(at_start, -1, begin)
    score, zero_reads, read_probs = candidates_to_score(
        ok, errs, begin, valid, read_id, read_len, read_lens_all,
        log_match, log_mismatch, total_len, min_prob_per_base,
        min_prob_start, n_reads)
    return score, zero_reads, read_probs
