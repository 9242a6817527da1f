"""Device-resident candidate generation: the max-hash window query ON
the chip.

Reference semantics (all bit-exact, validated against the native C++
query in tests/test_candgen_device.py):

- ``GetMinHashWithPoses`` (graph.cc:1289-1323): slide a read-length
  window over the sequence, take the max k-mer hash per window with the
  *first* (earliest) k-mer winning ties, collapse runs of equal
  fingerprints;
- ``GetReadCandsWithPoses`` (graph.cc:1325-1348): both strands — the
  reverse-complemented sequence is queried the same way and hits carry
  negative positions;
- candidate expansion through the fingerprint index with per-read
  precomputed seed positions, emitted stable-sorted by read id
  (reference rid-ascending map iteration; gaml_native.cc
  collect_window_cands reproduces it and so does this kernel).

Why it exists: with host candidate generation a device rescore ships
~20 B of metadata per candidate (~1.7 MB at 85k candidates).  With the
fingerprint index resident on device, a rescore ships only the
2-bit-packed window (~G/4 bytes) and a handful of scalars; candidates
are generated, staged, extended, deduplicated and reduced to the score
without any per-candidate traffic in either direction.

Static shapes throughout.  The sliding (max,
first-pos) uses a doubling sparse table (log2(w) elementwise combines)
instead of the reference's monotonic deque; the fingerprint lookup is a
vectorized binary search over the resident sorted fingerprint array; the
variable-length candidate expansion is an exclusive-scan + per-slot
binary search into a fixed capacity, with the true count returned so
callers can detect overflow and retry with a larger bucket.

Segmented windows: many subpath windows can be packed into ONE buffer
(the per-position segment map keeps sliding windows from crossing
segment boundaries and restarts fingerprint-run collapsing per segment),
so a whole move batch of windows costs one dispatch.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..index.maxhash import HASH_XOR, K_INDEX_KMER

K = K_INDEX_KMER
INT32_BIG = 2**31 - 1
_FP_PAD = INT32_BIG  # sentinel > any 30-bit fingerprint


def _bucket_pow2(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _bucket_mantissa(n: int, lo: int) -> int:
    """Smallest m * 2^k >= n with 3-bit mantissa m in [8, 15] — <= 12.5%
    padding vs pow2's <= 100%.  Used for the per-rescore upload shape
    (every padded byte is uploaded; executables per bucket are cheap)."""
    n = max(n, lo, 8)
    k = max(0, n.bit_length() - 4)
    m = -(-n // (1 << k))
    if m > 15:
        k += 1
        m = (m + 1) // 2
    return m << k


# ------------------------------------------------------------------ jit body
_CANDGEN_JIT = None


def _candgen(*args, **kw):
    """Lazy-jitted dispatch (jax imported on first use, matching the
    rest of the ops layer)."""
    global _CANDGEN_JIT
    if _CANDGEN_JIT is None:
        import jax

        _CANDGEN_JIT = jax.jit(_candgen_impl,
                               static_argnames=("read_len", "cap",
                                                "s_pad"))
    return _CANDGEN_JIT(*args, **kw)


def _candgen_impl(packed2, fixpos, seg_base, seg_len, n_seg, g_total,
                  sf, off, rids, seed2, row_of, read_len: int, cap: int,
                  s_pad: int = 0):
    """Candidate generation for one packed (possibly multi-segment)
    window buffer.

    packed2:  [s_pad//4] uint8 — 2-bit packed codes (N packed as 0);
    fixpos:   [f_pad] int32 — positions holding non-ACGT codes (fill =
              s_pad, dropped by the scatter);
    seg_base/seg_len: [nseg_pad] int32 (pads: base=g_total, len=0);
    n_seg, g_total: int32 scalars;
    sf:       [n_fp_pad] int32 sorted unique fingerprints (pad INT32_BIG);
    off:      [n_fp_pad+1] int32 CSR offsets (pads repeat the last);
    rids:     [n_entry_pad] int32 read ids per fingerprint;
    seed2:    [n_rows, 2] int32 per-read seed k-mer positions (fwd, rc);
    row_of:   [max_rid+1] int32.

    Returns (codes u8 [s_pad], rid, g0, r0, orient, seg — all [cap]
    int32 in the reference emission order, n_total int32).  ``g0`` is in
    LOCAL segment coordinates; slots >= n_total are padding."""
    import jax
    import jax.numpy as jnp

    s_pad = s_pad or packed2.shape[0] * 4
    L = read_len
    w = L - K + 1  # k-mers per window (static)

    # ---- unpack codes + restore non-ACGT positions (scratch slot
    # s_pad); the upload bucket is tighter than the pow2 compute bucket
    # (mantissa bucketing keeps the upload small), so
    # zero-pad up to s_pad//4 words here
    packed2 = jnp.concatenate(
        [packed2,
         jnp.zeros((s_pad // 4 - packed2.shape[0],), jnp.uint8)])
    shifts = jnp.arange(4, dtype=jnp.int32) * 2
    codes = ((packed2[:, None].astype(jnp.int32) >> shifts[None, :]) & 3)\
        .reshape(s_pad)
    codes = jnp.concatenate([codes, jnp.zeros(1, jnp.int32)])
    codes = codes.at[fixpos].set(4, mode="drop")[:s_pad]

    # ---- per-position segment id: scatter each segment's id at its
    # base, then a running max (no per-position binary search — gathers
    # are the device's scarcest resource in this kernel)
    j = jnp.arange(s_pad, dtype=jnp.int32)
    nseg_pad = seg_base.shape[0]
    seg_ids = jnp.arange(nseg_pad, dtype=jnp.int32)
    pid0 = jnp.zeros(s_pad + 1, jnp.int32).at[
        jnp.where(seg_ids < n_seg, seg_base, s_pad)].max(
        seg_ids, mode="drop")[:s_pad]
    pid = jax.lax.associative_scan(jnp.maximum, pid0)
    segb = seg_base[pid]
    segl = seg_len[pid]

    # ---- per-segment reverse complement buffer (reference builds rcseq
    # per window; identical layout here, so the same segment map serves)
    src = jnp.clip(segb + segl - 1 - (j - segb), 0, s_pad - 1)
    in_seg = (j < g_total) & (j - segb < segl)
    rcv = codes[src]
    rc_codes = jnp.where(in_seg, jnp.where(rcv < 4, 3 - rcv, rcv), 0)

    def kmer_hashes(buf):
        """h[t] = hash of the k-mer STARTING at t (tail garbage masked
        by window validity)."""
        v = jnp.where(buf < 4, buf, 0).astype(jnp.int32)
        v = jnp.concatenate([v, jnp.zeros(K, jnp.int32)])
        acc = jnp.zeros(s_pad, jnp.int32)
        for i in range(K):
            acc = (acc << 2) | v[i:i + s_pad]
        return acc ^ jnp.int32(HASH_XOR)

    def window_max(h):
        """(fp, kstart) per window start s: max over k-mer starts
        [s, s+w), first k-mer wins ties — sparse-table formulation of
        the reference's strict-less monotonic deque."""
        val, pos = h, jnp.arange(s_pad, dtype=jnp.int32)

        def combine(v1, p1, v2, p2):
            left = v1 >= v2  # tie -> left = earlier position
            return jnp.where(left, v1, v2), jnp.where(left, p1, p2)

        def shifted(a, sh, fill):
            return jnp.concatenate(
                [a[sh:], jnp.full((sh,), fill, a.dtype)])

        size = 1
        while size * 2 <= w:
            val, pos = combine(val, pos, shifted(val, size, -1),
                               shifted(pos, size, 0))
            size *= 2
        if size < w:
            sh = w - size
            val, pos = combine(val, pos, shifted(val, sh, -1),
                               shifted(pos, sh, 0))
        return val, pos

    # window validity: the full [s, s+L) window lies inside one segment
    pid_pad = jnp.concatenate(
        [pid, jnp.full((L,), -1, jnp.int32)])
    wv = (pid_pad[L - 1:L - 1 + s_pad] == pid) & (j + L - 1 < g_total) \
        & (segl >= L)

    n_fp = sf.shape[0]
    # fingerprint-run capacity: runs change roughly every w/2 positions
    # (~2/w per window on random sequence), so s_pad//8 is ~5x headroom;
    # n_runs is range-checked below and overflow reports n_total > cap
    # so callers retry/fall back exactly like candidate-cap overflow
    rq = max(4096, s_pad // 8)

    def strand(buf):
        """Collapse each strand's fingerprint runs to a compact [rq]
        table FIRST, then look up only the runs — the index binary
        search touches ~s_pad/40 queries instead of s_pad."""
        h = kmer_hashes(buf)
        fp, kp = window_max(h)
        prev_fp = jnp.concatenate([jnp.full((1,), -1, jnp.int32), fp[:-1]])
        prev_pid = jnp.concatenate([jnp.full((1,), -1, jnp.int32),
                                    pid[:-1]])
        newrun = wv & ((j == 0) | (pid != prev_pid) | (fp != prev_fp))
        rpos = jnp.cumsum(newrun.astype(jnp.int32)) - 1
        n_runs = rpos[-1] + 1
        tgt = jnp.where(newrun, rpos, rq)

        def compact(x, fill):
            return jnp.full(rq + 1, fill, jnp.int32).at[tgt].set(
                x, mode="drop")[:rq]

        fp_c = compact(fp, -1)
        kp_c = compact(kp, 0)
        s_c = compact(j, 0)
        idx = jnp.searchsorted(sf, fp_c, side="left").astype(jnp.int32)
        idc = jnp.clip(idx, 0, n_fp - 1)
        found = (sf[idc] == fp_c) & (idx < n_fp) & (fp_c >= 0)
        cnt = jnp.where(found, off[idc + 1] - off[idc], 0)
        return cnt, off[idc], kp_c, s_c, n_runs

    cnt_f, lo_f, kp_f, s_f, nr_f = strand(codes)
    cnt_r, lo_r, kp_r, s_r, nr_r = strand(rc_codes)

    counts = jnp.concatenate([cnt_f, cnt_r])
    lo_all = jnp.concatenate([lo_f, lo_r])
    kp_all = jnp.concatenate([kp_f, kp_r])
    s_all = jnp.concatenate([s_f, s_r])
    csum = jnp.cumsum(counts)
    n_total = csum[-1]
    # run-table overflow (pathological fingerprint churn): flag through
    # the same overflow channel the candidate cap uses
    n_total = jnp.where((nr_f > rq) | (nr_r > rq),
                        jnp.int32(cap + 1) + n_total, n_total)

    # expansion: scatter each run's index at its first output slot and
    # forward-max — every slot learns its run without a binary search
    t = jnp.arange(cap, dtype=jnp.int32)
    base_slot = csum - counts
    run_ids = jnp.arange(2 * rq, dtype=jnp.int32)
    rix0 = jnp.zeros(cap + 1, jnp.int32).at[
        jnp.where(counts > 0, base_slot, cap)].max(
        run_ids, mode="drop")[:cap]
    rix = jax.lax.associative_scan(jnp.maximum, rix0)
    kk = t - base_slot[rix]
    rid = rids[jnp.clip(lo_all[rix] + kk, 0, rids.shape[0] - 1)]
    orient = (rix >= rq).astype(jnp.int32)
    s = s_all[rix]
    seg = pid[s]
    kp = kp_all[rix]
    loc = kp - seg_base[seg]
    g0 = jnp.where(orient == 1, seg_len[seg] - loc - K, loc)
    row = row_of[jnp.clip(rid, 0, row_of.shape[0] - 1)]
    r0 = seed2[jnp.clip(row, 0, seed2.shape[0] - 1), orient]

    valid = t < n_total
    # reference emission order: per segment, stable-sorted by rid over
    # (fwd hits in window order, then rc hits) — a stable (seg, rid)
    # sort of this kernel's natural expansion order.  One packed key
    # (seg<<20 | rid; engine guards seg < 1024, rid < 2^20) and one
    # packed payload keep the sort at three operands.
    key = jnp.where(valid, (seg << 20) | rid, INT32_BIG)
    pay = (g0 << 9) | (r0 << 1) | orient
    key_s, g0r0_s, rid_s = jax.lax.sort(
        (key, pay, rid), num_keys=1, is_stable=True)
    live = jnp.arange(cap) < n_total
    seg_s = jnp.where(live, key_s >> 20, 0)
    rid_s = jnp.where(live, rid_s, 0)
    g0_s = g0r0_s >> 9
    r0_s = (g0r0_s >> 1) & 0xFF
    or_s = g0r0_s & 1
    return (codes.astype(jnp.uint8), rid_s, g0_s, r0_s, or_s, seg_s,
            n_total)


# ------------------------------------------------------------------ engine
class DeviceCandGen:
    """Per-read-set device candidate-generation engine.

    Residency (uploaded once, passed as jit ARGUMENTS so executables are
    shared across read sets — see ops.extend_device rule 1): the sorted
    fingerprint CSR index, per-read seed positions, and the rid->row
    map, all padded to power-of-two buckets.
    """

    def __init__(self, bundle):
        import jax
        import jax.numpy as jnp

        self.read_len = int(bundle.read_len)
        # packed-field limits of the emission sort (see _candgen_impl)
        assert self.read_len - K <= 255, "read_len > 270 unsupported"
        assert len(bundle.row_of) < (1 << 20), "rid field: < 2^20 reads"
        n_fp = len(bundle.fp_sorted)
        n_fp_pad = _bucket_pow2(max(n_fp, 1), 1024)
        sf = np.full(n_fp_pad, _FP_PAD, dtype=np.int32)
        sf[:n_fp] = bundle.fp_sorted.astype(np.int64).astype(np.int32)
        off = np.full(n_fp_pad + 1, int(bundle.fp_off[-1]), dtype=np.int32)
        off[:n_fp + 1] = bundle.fp_off.astype(np.int32)
        n_ent_pad = _bucket_pow2(max(len(bundle.fp_rids), 1), 1024)
        rids = np.zeros(n_ent_pad, dtype=np.int32)
        rids[:len(bundle.fp_rids)] = bundle.fp_rids
        n_rows_pad = _bucket_pow2(max(bundle.seed_pos.shape[0], 1), 1024)
        seed2 = np.zeros((n_rows_pad, 2), dtype=np.int32)
        seed2[:bundle.seed_pos.shape[0]] = bundle.seed_pos
        row_pad = _bucket_pow2(max(len(bundle.row_of), 1), 1024)
        row_of = np.zeros(row_pad, dtype=np.int32)
        row_of[:len(bundle.row_of)] = bundle.row_of
        put = jax.device_put
        self.sf = put(jnp.asarray(sf))
        self.off = put(jnp.asarray(off))
        self.rids = put(jnp.asarray(rids))
        self.seed2 = put(jnp.asarray(seed2))
        self.row_of_dev = put(jnp.asarray(row_of))

    # ------------------------------------------------------------- packing
    @staticmethod
    def pack_windows(seqs: List[np.ndarray], s_pad_min: int = 4096
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray, int]:
        """Host-side staging of a window batch into one 2-bit packed
        buffer.  Returns (packed2 u8 [u_pad] — the UPLOAD bucket, a
        tighter mantissa bucket than the pow2 compute bucket s_pad; the
        jit zero-pads on device —, fixpos i32 [f_pad], seg_base i32
        [nseg_pad], seg_len i32 [nseg_pad], g_total, s_pad)."""
        lens = np.array([len(s) for s in seqs], dtype=np.int64)
        g_total = int(lens.sum())
        s_pad = _bucket_pow2(max(g_total, 1), s_pad_min)
        u_pad = min(_bucket_mantissa(-(-max(g_total, 1) // 4), 1024),
                    s_pad // 4)
        buf = np.zeros(4 * u_pad, dtype=np.uint8)
        at = 0
        for sq in seqs:
            buf[at:at + len(sq)] = sq
            at += len(sq)
        fix = np.flatnonzero(buf >= 4).astype(np.int32)
        f_pad = _bucket_pow2(max(len(fix), 1), 16)
        fixpos = np.full(f_pad, s_pad, dtype=np.int32)
        fixpos[:len(fix)] = fix
        c = np.where(buf < 4, buf, 0).astype(np.uint8)
        packed2 = (c[0::4] | (c[1::4] << 2) | (c[2::4] << 4)
                   | (c[3::4] << 6))
        nseg_pad = _bucket_pow2(max(len(seqs), 1), 8)
        seg_base = np.full(nseg_pad, g_total, dtype=np.int32)
        seg_len = np.zeros(nseg_pad, dtype=np.int32)
        seg_base[:len(seqs)] = np.concatenate(
            ([0], np.cumsum(lens[:-1]))).astype(np.int32)
        seg_len[:len(seqs)] = lens.astype(np.int32)
        return packed2, fixpos, seg_base, seg_len, g_total, s_pad

    # --------------------------------------------------------------- query
    def stage_upload(self, seqs: List[np.ndarray]):
        """Pack a window batch on host and START its device upload
        (async device_put).  Callers pipelining several rescores stage
        all their windows first so the transfers overlap earlier
        dispatches' device compute instead of serializing with it."""
        import jax

        packed2, fixpos, seg_base, seg_len, g_total, s_pad = \
            self.pack_windows(seqs)
        return (jax.device_put(packed2), jax.device_put(fixpos),
                seg_base, seg_len, g_total, len(seqs), s_pad)

    def query(self, seqs: List[np.ndarray] = None, cap: int = 0,
              return_layout: bool = False, staged=None):
        """Dispatch candidate generation for a window batch; returns
        device arrays (codes u8 [s_pad], rid, g0, r0, orient, seg [cap],
        n_total scalar) — fetch n_total to detect cap overflow.  With
        ``return_layout`` also returns the host (seg_base, seg_len)
        arrays (per-candidate g0 is in local segment coordinates).
        ``staged``: a stage_upload result to use instead of ``seqs``."""
        import jax.numpy as jnp

        if staged is None:
            staged = self.stage_upload(seqs)
        p2d, fxd, seg_base, seg_len, g_total, nseg, s_pad = staged
        out = _candgen(
            p2d, fxd, jnp.asarray(seg_base), jnp.asarray(seg_len),
            jnp.int32(nseg), jnp.int32(g_total),
            self.sf, self.off, self.rids, self.seed2, self.row_of_dev,
            read_len=self.read_len, cap=cap, s_pad=s_pad)
        return out + (seg_base, seg_len) if return_layout else out

    def query_host(self, seqs: List[np.ndarray], cap: int = 0):
        """Blocking host-side view for tests/debug: returns a list of
        (rid, g0, r0, orient) per segment, native query layout."""
        total_guess = cap or max(
            1024, _bucket_pow2(4 * sum(len(s) for s in seqs) + 1024, 1024))
        while True:
            codes, rid, g0, r0, orient, seg, n_tot = \
                self.query(seqs, cap=total_guess)
            n = int(n_tot)
            if n <= total_guess:
                break
            total_guess = _bucket_pow2(n, 1024)
        rid = np.asarray(rid)[:n]
        g0 = np.asarray(g0)[:n]
        r0 = np.asarray(r0)[:n]
        orient = np.asarray(orient)[:n]
        seg = np.asarray(seg)[:n]
        out = []
        for i in range(len(seqs)):
            m = seg == i
            out.append((rid[m].astype(np.int32), g0[m].astype(np.int32),
                        r0[m].astype(np.int32),
                        orient[m].astype(np.int32)))
        return out
