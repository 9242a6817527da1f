"""Full single-end device rescore: window bytes in, score out.

Chains the device-resident pipeline end to end with NO per-candidate
traffic in either direction:

  candgen (ops.candgen_device, graph.cc:1289-1348 semantics)
    -> r0 counting sort (tight per-block row bounds for the GPU kernel)
    -> fused staging + banded-extension DP (ops.extend_device)
    -> first-wins (window, position, read) dedup  (graph.cc:895-897)
    -> per-read probability segment-sum + GetTotalProb reduction
       (graph.cc:1482-1537)

A rescore ships the 2-bit-packed window buffer (~G/4 bytes) up and three
scalars (score, zero_reads, candidate count) down.  The candidate count
lets callers detect capacity overflow and retry with a larger bucket —
results are unusable when n_total > cap.

Dedup parity note: the reference keeps the FIRST duplicate in candidate
emission order (set<Aligment> insert).  The r0 sort destroys that
order, so instead of un-permuting, the dedup sort carries each
candidate's emission rank as a third key — the winner of every
(window, position, read) group is exactly the reference's.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .candgen_device import K, DeviceCandGen, _bucket_pow2
from .extend_device import DeviceExtender, make_fused_body

INT32_BIG = 2**31 - 1

_RESCORE_JIT = None


def _rescore(*args, **kw):
    global _RESCORE_JIT
    if _RESCORE_JIT is None:
        import jax

        _RESCORE_JIT = jax.jit(
            _rescore_impl,
            static_argnames=("L", "rmax", "use_kernel", "interpret",
                             "n_jobs"))
    return _RESCORE_JIT(*args, **kw)


def _sort_by_r0(r0f, L, cap):
    """Gather index [cap] (sorted slot -> original candidate) of a stable
    COUNTING sort by r0: r0 has <= 256 distinct values (seed positions
    within a read), so one [nbins, cap] cumsum replaces a comparison
    sort."""
    import jax.numpy as jnp

    iota = jnp.arange(cap, dtype=jnp.int32)
    nbins = max(L - K + 1, 1)  # r0 in [0, L-K]; pad fill = L-K
    keys = jnp.clip(r0f, 0, nbins - 1)
    hist = jnp.zeros(nbins, jnp.int32).at[keys].add(1)
    offs = jnp.concatenate([jnp.zeros(1, jnp.int32),
                            jnp.cumsum(hist)[:-1]])
    # stable rank within each key: running count along the candidate axis
    oh = (keys[None, :] == jnp.arange(nbins, dtype=jnp.int32)[:, None])
    cum = jnp.cumsum(oh.astype(jnp.int32), axis=1)
    rank = cum.reshape(-1)[keys * cap + iota] - 1
    pos = offs[keys] + rank          # element j lands at sorted slot pos
    return jnp.zeros(cap, jnp.int32).at[pos].set(iota)


def _staged_inputs(rid, g0, r0, orient, seg, n_tot, seg_base, seg_len,
                   row_of, L, use_kernel):
    """Per-candidate fused-body inputs in kernel order: returns
    (ranks, (base, glen, g0, r0, rows, orient), rid, seg, valid) where
    ranks maps each slot to its candidate's emission rank.  Pad slots
    stage as zero-length reads against empty windows (r0 = L-K also
    sorts them to the tail)."""
    import jax.numpy as jnp

    cap = rid.shape[0]
    iota = jnp.arange(cap, dtype=jnp.int32)
    valid = iota < n_tot
    r0f = jnp.where(valid, r0, L - K)
    g0f = jnp.where(valid, g0, 0)
    base = jnp.where(valid, seg_base[jnp.clip(seg, 0,
                                              seg_base.shape[0] - 1)], 0)
    glen = jnp.where(valid, seg_len[jnp.clip(seg, 0,
                                             seg_len.shape[0] - 1)], 0)
    rows = row_of[jnp.clip(rid, 0, row_of.shape[0] - 1)]
    cols = (base, glen, g0f, r0f, rows, orient)
    if not use_kernel:
        return iota, cols, rid, seg, valid
    gidx = _sort_by_r0(r0f, L, cap)
    return (gidx, tuple(x[gidx] for x in cols), rid[gidx], seg[gidx],
            valid[gidx])


def _rescore_impl(fwd_words, rc_words, codes_u8, rid, g0, r0, orient, seg,
                  n_tot, seg_base, seg_len, row_of, read_lens_all,
                  n_reads, log_match, log_mismatch, total_len,
                  min_prob_per_base, min_prob_start, L: int, rmax: int,
                  use_kernel: bool, interpret: bool, seg_job=None,
                  n_jobs: int = 1):
    """Candidates -> assembly score(s).  ``seg_job`` maps each window
    segment to a scoring JOB (default: all segments are one assembly —
    the walk-set semantic); with k jobs, k INDEPENDENT rescores run in
    this single dispatch and score/zero_reads come back as [n_jobs]
    vectors (``total_len`` is then a [n_jobs] vector too)."""
    import jax
    import jax.numpy as jnp

    cap = rid.shape[0]
    iota = jnp.arange(cap, dtype=jnp.int32)
    ranks, cols, rids_s, segs, vals = _staged_inputs(
        rid, g0, r0, orient, seg, n_tot, seg_base, seg_len, row_of, L,
        use_kernel)
    body = make_fused_body(L, rmax, use_kernel, interpret)
    ok, errs, begin, _pk = body(fwd_words, rc_words, codes_u8, *cols)

    good = ok & vals
    # dedup by (window, read, begin), winner = smallest emission rank:
    # ONE packed key (seg<<20 | rid), begin, rank — plus the sort
    # permutation to carry errs along afterwards
    key1 = jnp.where(good, (segs << 20) | rids_s, INT32_BIG)
    pos_key = jnp.where(good, begin, INT32_BIG)
    k1s, posk, _rk, perm = jax.lax.sort(
        (key1, pos_key, ranks, iota), num_keys=3)
    first = jnp.concatenate([
        jnp.array([True]),
        (k1s[1:] != k1s[:-1]) | (posk[1:] != posk[:-1])])
    keep = (k1s != INT32_BIG) & first
    ridk = k1s & 0xFFFFF
    errs_s = errs[perm]
    rlen_s = read_lens_all[jnp.clip(ridk, 0,
                                    read_lens_all.shape[0] - 1)]

    p = jnp.exp(errs_s * log_mismatch + (rlen_s - errs_s) * log_match)
    p = jnp.where(keep, p, 0.0)
    n_rows_pad = read_lens_all.shape[0]
    if seg_job is None:
        jobk = jnp.zeros_like(ridk)
    else:
        # dedup key1 packs (seg << 20 | rid); recover each kept row's
        # segment and map it to its job
        jobk = seg_job[jnp.clip(k1s >> 20, 0, seg_job.shape[0] - 1)]
    bins = jnp.where(keep, jobk * n_rows_pad + ridk,
                     n_jobs * n_rows_pad)
    read_probs = jax.ops.segment_sum(
        p, bins, num_segments=n_jobs * n_rows_pad + 1)[:-1].reshape(
        n_jobs, n_rows_pad)

    # GetTotalProb (graph.cc:1518-1537) over the PADDED read axis: pad
    # rows are masked out of both the floor count and the mean
    live = (jnp.arange(n_rows_pad) < n_reads)[None, :]
    tl = jnp.maximum(total_len, 1).reshape(-1, 1).astype(jnp.float32)
    probs = read_probs / (2.0 * tl)
    thresholds = jnp.exp(min_prob_start + min_prob_per_base
                         * read_lens_all)[None, :]
    floored = live & (probs < thresholds)
    zero_reads = jnp.sum(floored.astype(jnp.int32), axis=1)
    probs = jnp.where(floored, thresholds, probs)
    score = jnp.sum(jnp.where(live, jnp.log(probs), 0.0), axis=1) \
        / jnp.maximum(n_reads, 1)
    if seg_job is None:
        return score[0], zero_reads[0], read_probs[0]
    return score, zero_reads, read_probs


_FULL_JIT = None


def _rescore_full(*args, **kw):
    """Single-dispatch rescore: candgen + staging + DP + dedup + score
    in ONE executable."""
    global _FULL_JIT
    if _FULL_JIT is None:
        import jax

        _FULL_JIT = jax.jit(
            _rescore_full_impl,
            static_argnames=("read_len", "cap", "s_pad", "rmax",
                             "use_kernel", "interpret", "n_jobs"))
    return _FULL_JIT(*args, **kw)


def _rescore_full_impl(packed2, fixpos, seg_base, seg_len, n_seg,
                       g_total, sf, off, rids, seed2, row_of, fwd_words,
                       rc_words, read_lens_all, n_reads, log_match,
                       log_mismatch, total_len, min_prob_per_base,
                       min_prob_start, read_len: int, cap: int,
                       s_pad: int, rmax: int, use_kernel: bool,
                       interpret: bool, seg_job=None, n_jobs: int = 1):
    from .candgen_device import _candgen_impl

    codes_u8, rid, g0, r0, orient, seg, n_tot = _candgen_impl(
        packed2, fixpos, seg_base, seg_len, n_seg, g_total, sf, off,
        rids, seed2, row_of, read_len=read_len, cap=cap, s_pad=s_pad)
    return _rescore_impl(
        fwd_words, rc_words, codes_u8, rid, g0, r0, orient, seg, n_tot,
        seg_base, seg_len, row_of, read_lens_all, n_reads,
        log_match, log_mismatch, total_len, min_prob_per_base,
        min_prob_start, L=read_len, rmax=rmax, use_kernel=use_kernel,
        interpret=interpret, seg_job=seg_job, n_jobs=n_jobs) + (n_tot,)


_EXTEND_FULL_JIT = None


def _extend_full(*args, **kw):
    """Single-dispatch candgen + extension (the aligner batch path)."""
    global _EXTEND_FULL_JIT
    if _EXTEND_FULL_JIT is None:
        import jax

        _EXTEND_FULL_JIT = jax.jit(
            _extend_full_impl,
            static_argnames=("read_len", "cap", "s_pad", "rmax",
                             "use_kernel", "interpret"))
    return _EXTEND_FULL_JIT(*args, **kw)


def _extend_full_impl(packed2, fixpos, seg_base, seg_len, n_seg, g_total,
                      sf, off, rids, seed2, row_of, fwd_words, rc_words,
                      read_len: int, cap: int, s_pad: int, rmax: int,
                      use_kernel: bool, interpret: bool):
    from .candgen_device import _candgen_impl

    codes_u8, rid, g0, r0, orient, seg, n_tot = _candgen_impl(
        packed2, fixpos, seg_base, seg_len, n_seg, g_total, sf, off,
        rids, seed2, row_of, read_len=read_len, cap=cap, s_pad=s_pad)
    packed, meta = _extend_cands_impl(
        fwd_words, rc_words, codes_u8, rid, g0, r0, orient, seg, n_tot,
        seg_base, seg_len, row_of, L=read_len, rmax=rmax,
        use_kernel=use_kernel, interpret=interpret)
    return packed, meta, n_tot


def _extend_cands_impl(fwd_words, rc_words, codes_u8, rid, g0, r0, orient,
                       seg, n_tot, seg_base, seg_len, row_of, L: int,
                       rmax: int, use_kernel: bool, interpret: bool):
    """Banded extension over device-generated candidates, results
    restored to the candgen emission order: returns (packed [cap] — the
    ops.extend_device result word — and meta [cap] =
    rid<<11 | seg<<1 | orient).  The host fetches 8 B/candidate and
    uploads no per-candidate metadata."""
    import jax.numpy as jnp

    cap = rid.shape[0]
    ranks, cols, _rid, _seg, _valid = _staged_inputs(
        rid, g0, r0, orient, seg, n_tot, seg_base, seg_len, row_of, L,
        use_kernel)
    body = make_fused_body(L, rmax, use_kernel, interpret)
    _ok, _e, _b, pk = body(fwd_words, rc_words, codes_u8, *cols)
    packed = jnp.zeros(cap, jnp.int32).at[ranks].set(pk) if use_kernel \
        else pk
    meta = (rid << 11) | (seg << 1) | orient
    return packed, meta


def _route(use_pallas) -> bool:
    if use_pallas is None:
        from ..utils.device import use_kernel

        return use_kernel()
    return bool(use_pallas)


class DeviceRescorer:
    """Window-bytes-in, score-out rescore engine for one read set.

    Combines the resident candgen index (DeviceCandGen) and the resident
    read-code matrices (DeviceExtender).  ``rescore`` dispatches the
    whole pipeline asynchronously and returns device handles."""

    def __init__(self, bundle, read_lens_all: np.ndarray = None,
                 ext: DeviceExtender = None):
        import jax
        import jax.numpy as jnp

        self.gen = DeviceCandGen(bundle)
        self.ext = ext if ext is not None else \
            DeviceExtender(bundle.codes_fwd, bundle.codes_rc)
        self.read_len = int(bundle.read_len)
        self.n_reads = int(len(bundle.row_of))
        if read_lens_all is None:
            read_lens_all = np.full(self.n_reads, self.read_len, np.int32)
        # pad the read axis to the extender's row bucket so executables
        # are shared across read sets (shape rule, ops.extend_device)
        n_pad = max(_bucket_pow2(self.n_reads, 1024), 1024)
        lens = np.zeros(n_pad, dtype=np.int32)
        lens[:self.n_reads] = read_lens_all
        self.lens_dev = jax.device_put(jnp.asarray(lens))

    def stage(self, seqs: List[np.ndarray]):
        """Start the window batch's device upload (see
        DeviceCandGen.stage_upload) for a later ``rescore(staged=...)``."""
        return self.gen.stage_upload(seqs)

    def rescore(self, seqs: List[np.ndarray] = None, cap: int = 0,
                log_match: float = 0.0, log_mismatch: float = 0.0,
                total_len=1, min_prob_per_base: float = 0.0,
                min_prob_start: float = 0.0, use_pallas: bool = None,
                staged=None, seg_job: np.ndarray = None,
                n_jobs: int = 1, interpret: bool = False):
        """Returns device handles (score, zero_reads, n_total), computed
        by ONE device dispatch (candgen + DP + dedup + score fused — see
        _rescore_full).  The result is valid only when
        int(n_total) <= cap; callers retry with a doubled cap otherwise.

        ``seg_job`` + ``n_jobs``: score k INDEPENDENT assemblies in
        this one dispatch (seg_job [nseg_pad] maps window segments to
        jobs; total_len becomes a [n_jobs] vector; score/zeros come
        back as [n_jobs] arrays).

        ``use_pallas`` defaults to the platform's route (utils.device):
        the Pallas GPU kernel on ``gpu``, the jnp DP on ``cpu``;
        ``interpret`` runs the kernel on the CPU (tests)."""
        import jax.numpy as jnp

        use_pallas = _route(use_pallas)
        if staged is None:
            staged = self.stage(seqs)
        p2d, fxd, seg_base, seg_len, g_total, nseg, s_pad = staged
        gen = self.gen
        if seg_job is not None:
            sj = np.zeros(len(seg_base), np.int32)
            sj[:len(seg_job)] = seg_job
            seg_job = jnp.asarray(sj)
            tl = jnp.asarray(np.asarray(total_len, np.int32).reshape(-1))
        else:
            tl = jnp.int32(total_len)
        score, zeros, _probs, n_tot = _rescore_full(
            p2d, fxd, jnp.asarray(seg_base), jnp.asarray(seg_len),
            jnp.int32(nseg), jnp.int32(g_total), gen.sf, gen.off,
            gen.rids, gen.seed2, gen.row_of_dev, self.ext.fwd_words,
            self.ext.rc_words, self.lens_dev,
            jnp.int32(self.n_reads), jnp.float32(log_match),
            jnp.float32(log_mismatch), tl,
            jnp.float32(min_prob_per_base), jnp.float32(min_prob_start),
            read_len=self.read_len, cap=cap, s_pad=s_pad,
            rmax=self.ext.rmax, use_kernel=use_pallas, interpret=interpret,
            seg_job=seg_job, n_jobs=n_jobs)
        return score, zeros, n_tot

    def extend(self, seqs: List[np.ndarray], cap: int,
               use_pallas: bool = None, interpret: bool = False):
        """Candgen + banded extension for a window batch; dispatches
        everything and returns a zero-arg closure producing
        (ok, errs, begin, rid, orient, seg — numpy [n] in the native
        query's emission order — or None on cap overflow, with the true
        count as second element): ``fetch() -> (arrays | None, n)``."""
        import jax.numpy as jnp

        from .extend_device import unpack_results

        use_pallas = _route(use_pallas)
        staged = self.gen.stage_upload(seqs)
        p2d, fxd, seg_base, seg_len, g_total, nseg, s_pad = staged
        gen = self.gen
        packed, meta, n_tot = _extend_full(
            p2d, fxd, jnp.asarray(seg_base), jnp.asarray(seg_len),
            jnp.int32(nseg), jnp.int32(g_total), gen.sf, gen.off,
            gen.rids, gen.seed2, gen.row_of_dev, self.ext.fwd_words,
            self.ext.rc_words, read_len=self.read_len, cap=cap,
            s_pad=s_pad, rmax=self.ext.rmax, use_kernel=use_pallas,
            interpret=interpret)

        def fetch():
            n = int(n_tot)
            if n > cap:
                return None, n
            pk = np.asarray(packed)[:n]
            mt = np.asarray(meta)[:n]
            ok, errs, begin = unpack_results(pk)
            return (ok, errs, begin, mt >> 11, mt & 1,
                    (mt >> 1) & 0x3FF), n

        return fetch
