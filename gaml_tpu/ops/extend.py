"""Device banded-extension kernel (short reads).

Batched replacement for the reference's per-candidate 0-1 BFS
(ProcessHit, graph.cc:753-837).  The BFS explores a *restricted* alignment
graph: on a matching character only the diagonal move exists; on a mismatch
three cost-1 moves (substitution, genome-skip, read-skip).  With the error
cap of 3 the diagonal drift is bounded by +-3, so the whole search collapses
into a banded min-plus DP with band 7 — a static-shape scan that vectorizes
over tens of thousands of candidates at once.

Both extension directions reduce to the same "forward" DP after a coordinate
flip (reverse the read prefix and the genome prefix), including the boundary
rules:
- a match consuming the last genome char is only allowed if it completes
  the read (graph.cc:778, graph.cc:819);
- genome-advancing mismatch moves must stay inside the genome;
- a seed at genome position 0 skips the backward phase: accept iff
  read_pos < 6 with read_pos errors and begin_pos = -1 (graph.cc:797-798).

The begin position reported by the BFS is tie-broken by its deque order:
substitution > genome-skip > read-skip at the earliest divergence.  We
replicate it with a greedy walk over the cost-to-accept table (verified
against the BFS oracle in tests/test_extend_kernel.py).

Returned edit distances are forward + backward minima — like the reference,
the *total* may exceed 3 (up to 6) because each direction is capped
independently.
"""
from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

PAD = 4          # gwin padding; diagonal drift is at most 3
BAND = 7         # offsets d in [-3, 3]
INF = 100
ERROR_LIMIT = 3
K = 15
SENT_READ = 6    # read padding sentinel
SENT_GEN = 8     # out-of-genome sentinel (never equals any read code)


INVALID_A = 100


def _dp_rows(read_arr, rlen_eff, gwin, glen_eff, rmax: int):
    """Cost-to-accept DP with in-scan accept-offset propagation.

    read_arr: [N, rmax] direction-view read codes; rlen_eff: [N];
    gwin: [N, rmax + 2*PAD] with gwin[n, j] = genome_view[j - PAD];
    glen_eff: [N].

    Carries per row both the min cost-to-accept C[r][d] and the *preferred
    accept offset* A[r][d]: the band offset the reference BFS's
    deque-ordered search would reach acceptance at, propagated by the
    tie-break (forced match > substitution > genome-skip > read-skip).
    Returns (c0, a0): both [N, BAND] at row 0; start state is d=0
    (index 3).
    """
    n = read_arr.shape[0]
    d_off = jnp.arange(-3, 4, dtype=jnp.int32)  # [BAND]

    def shift_dm1(x, fill):
        return jnp.concatenate(
            [jnp.full((n, 1), fill, x.dtype), x[:, :-1]], axis=1)

    def shift_dp1(x, fill):
        return jnp.concatenate(
            [x[:, 1:], jnp.full((n, 1), fill, x.dtype)], axis=1)

    def row_step(carry, r):
        c_next, a_next = carry
        # chars on diagonals d=-3..3 at row r: j = r + d + PAD
        chars = jax.lax.dynamic_slice_in_dim(gwin, r + PAD - 3, BAND, axis=1)
        rchar = jax.lax.dynamic_slice_in_dim(read_arr, r, 1, axis=1)  # [N,1]
        match = chars == rchar
        g_plus_in = (r + d_off[None, :] + 1) < glen_eff[:, None]
        last_row = (r + 1) == rlen_eff[:, None]

        diag = jnp.where(match & (g_plus_in | last_row), c_next, INF)
        sub = jnp.where(~match & g_plus_in, c_next + 1, INF)
        # read-skip: (r, d) -> (r+1, d-1), so read c_next at d-1
        c_next_dm1 = shift_dm1(c_next, INF)
        rskip = jnp.where(~match, c_next_dm1 + 1, INF)
        c_row = jnp.minimum(jnp.minimum(diag, sub), rskip)
        # genome-skip within the row: (r, d) -> (r, d+1); relax 3x
        gskip_ok = (~match) & g_plus_in
        for _ in range(3):
            c_row = jnp.where(gskip_ok,
                              jnp.minimum(c_row, shift_dp1(c_row, INF) + 1),
                              c_row)
        in_accept = r >= rlen_eff[:, None]
        c_row = jnp.where(in_accept, 0, c_row)

        # tie-break move selection consistent with the final costs
        take_sub = (~match) & g_plus_in & (c_next == c_row - 1)
        take_gskip = (~match) & ~take_sub & gskip_ok & \
            (shift_dp1(c_row, INF) == c_row - 1)
        take_rskip = (~match) & ~take_sub & ~take_gskip & \
            (c_next_dm1 == c_row - 1)
        a_row = jnp.where(match, a_next,
                          jnp.where(take_sub, a_next,
                                    jnp.where(take_rskip,
                                              shift_dm1(a_next, INVALID_A),
                                              INVALID_A)))
        for _ in range(4):
            a_row = jnp.where(take_gskip, shift_dp1(a_row, INVALID_A), a_row)
        a_row = jnp.where(in_accept, d_off[None, :], a_row)
        return (c_row, a_row), None

    c_init = jnp.zeros((n, BAND), dtype=jnp.int32)
    a_init = jnp.broadcast_to(d_off[None, :], (n, BAND)).astype(jnp.int32)
    rows = jnp.arange(rmax - 1, -1, -1, dtype=jnp.int32)
    (c0, a0), _ = jax.lax.scan(row_step, (c_init, a_init), rows)
    return c0, a0


def extend_both(read_f, rlen_f, gwin_f, glen_f, read_b, rlen_b, gwin_b,
                glen_b, rmax: int, use_kernel: bool = False,
                interpret: bool = False):
    """Two-direction extension: (ok, errs, d_back) per candidate.

    d_back is the backward accept offset (begin = g0 - r0 - d_back);
    candidates with g0 == 0 are handled by the caller (rlen_b set to 0
    there, d unused).  ``use_kernel`` runs the Pallas GPU kernel
    (ops.extend_pallas; ``interpret`` runs it on the CPU), otherwise the
    jnp scan.  Costs agree wherever they are consumed: ok everywhere,
    errs and d_back wherever ok (the kernel saturates costs at 7)."""
    if use_kernel:
        from .extend_pallas import dp_kernel

        errs_f = dp_kernel(read_f, rlen_f, gwin_f, glen_f, rmax,
                           accept=False, interpret=interpret)
        errs_b, d_back = dp_kernel(read_b, rlen_b, gwin_b, glen_b, rmax,
                                   accept=True, interpret=interpret)
    else:
        cf, _ = _dp_rows(read_f, rlen_f, gwin_f, glen_f, rmax)
        cb, ab = _dp_rows(read_b, rlen_b, gwin_b, glen_b, rmax)
        errs_f, errs_b, d_back = cf[:, 3], cb[:, 3], ab[:, 3]
    ok = (errs_f <= ERROR_LIMIT) & (errs_b <= ERROR_LIMIT)
    return ok, errs_f + errs_b, d_back


extend_kernel = jax.jit(extend_both,
                        static_argnames=("rmax", "use_kernel", "interpret"))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def stage_candidates(seq: np.ndarray, g0s: np.ndarray, r0s: np.ndarray,
                     reads: List[np.ndarray], rmax: int = None,
                     nb: int = None, read_ids: np.ndarray = None,
                     seq_idx: np.ndarray = None):
    """Build the kernel's direction-view arrays on host.

    ``seq`` is either one genome window (all candidates share it) or a list
    of windows with per-candidate ``seq_idx`` — the multi-subpath batched
    form.  Returns a dict of numpy arrays (kernel inputs + candidate
    metadata), padded to nb candidates and rmax rows."""
    n = len(reads)
    multi = seq_idx is not None
    seqs = seq if multi else None
    glen = 0 if multi else len(seq)
    rlens = np.array([len(r) for r in reads], dtype=np.int32)
    if rmax is None:
        rmax_needed = int(max(int((rlens - r0s - K).max(initial=1)),
                              int(r0s.max(initial=1)), 1))
        rmax = _round_up(rmax_needed, 32)
    if nb is None:
        nb = _round_up(max(n, 1), 128)

    read_f = np.full((nb, rmax), SENT_READ, dtype=np.uint8)
    read_b = np.full((nb, rmax), SENT_READ, dtype=np.uint8)
    gwin_f = np.full((nb, rmax + 2 * PAD), SENT_GEN, dtype=np.uint8)
    gwin_b = np.full((nb, rmax + 2 * PAD), SENT_GEN, dtype=np.uint8)
    rlen_f = np.zeros(nb, dtype=np.int32)
    rlen_b = np.zeros(nb, dtype=np.int32)
    glen_f = np.zeros(nb, dtype=np.int32)
    glen_b = np.zeros(nb, dtype=np.int32)

    for i, read in enumerate(reads):
        if multi:
            seq = seqs[seq_idx[i]]
            glen = len(seq)
        g0, r0, rl = int(g0s[i]), int(r0s[i]), int(rlens[i])
        # forward view: read suffix after the seed vs genome from seed end
        fl = rl - r0 - K
        rlen_f[i] = fl
        read_f[i, :fl] = read[r0 + K:]
        gl = glen - (g0 + K)
        glen_f[i] = gl
        lo = g0 + K - PAD
        src = seq[max(0, lo):min(glen, lo + rmax + 2 * PAD)]
        dst0 = max(0, -lo)
        gwin_f[i, dst0:dst0 + len(src)] = src
        # backward view: reversed read prefix vs reversed genome prefix
        if g0 > 0:
            rlen_b[i] = r0
            read_b[i, :r0] = read[r0 - 1::-1] if r0 > 0 else read[:0]
            glen_b[i] = g0
            # genome_view[g'] = seq[g0 - 1 - g'] at j = g' + PAD; j < PAD
            # (g' < 0) is unreachable from the start state, left as sentinel
            rev = seq[:g0][::-1]
            m = min(len(rev), rmax + PAD)
            gwin_b[i, PAD:PAD + m] = rev[:m]
        # g0 == 0: backward skipped; rlen_b stays 0 -> errs_b = 0 from DP

    g0_pad = np.zeros(nb, dtype=np.int32)
    r0_pad = np.zeros(nb, dtype=np.int32)
    rlen_pad = np.zeros(nb, dtype=np.int32)
    g0_pad[:n] = g0s
    r0_pad[:n] = r0s
    rlen_pad[:n] = rlens
    valid = np.zeros(nb, dtype=bool)
    valid[:n] = True
    rid_pad = np.zeros(nb, dtype=np.int32)
    if read_ids is not None:
        rid_pad[:n] = read_ids
    return {
        "read_f": read_f, "rlen_f": rlen_f, "gwin_f": gwin_f, "glen_f": glen_f,
        "read_b": read_b, "rlen_b": rlen_b, "gwin_b": gwin_b, "glen_b": glen_b,
        "g0": g0_pad, "r0": r0_pad, "read_len": rlen_pad, "valid": valid,
        "at_start": g0_pad == 0 if n else np.zeros(nb, dtype=bool),
        "read_id": rid_pad, "rmax": rmax, "n": n,
    }


def stage_candidates_uniform(seq_buf: np.ndarray, seq_base: np.ndarray,
                             seq_lens: np.ndarray, seq_idx: np.ndarray,
                             g0s: np.ndarray, r0s: np.ndarray,
                             rows: np.ndarray, orient: np.ndarray,
                             codes_fwd: np.ndarray, codes_rc: np.ndarray,
                             read_ids: np.ndarray = None,
                             rmax: int = None, nb: int = None):
    """Fully-vectorized staging for uniform-length reads straight from
    candidate arrays (the native query_windows_batch output) and the
    bundle's read-code matrices — no per-candidate Python loop.

    seq_buf: concatenated window sequences; seq_base/seq_lens: per-window
    offset/length; seq_idx: per-candidate window index; rows: per-candidate
    row into codes_fwd/codes_rc; orient: 0 fwd / 1 rc.  Bit-identical
    arrays to stage_candidates over the same candidates (tested)."""
    n = len(g0s)
    L = codes_fwd.shape[1] if codes_fwd.ndim == 2 else 0
    if rmax is None:
        rmax_needed = max(int((L - r0s - K).max(initial=1)),
                          int(r0s.max(initial=1)), 1)
        rmax = _round_up(rmax_needed, 32)
    if nb is None:
        nb = _round_up(max(n, 1), 128)

    read_f = np.full((nb, rmax), SENT_READ, dtype=np.uint8)
    read_b = np.full((nb, rmax), SENT_READ, dtype=np.uint8)
    gwin_f = np.full((nb, rmax + 2 * PAD), SENT_GEN, dtype=np.uint8)
    gwin_b = np.full((nb, rmax + 2 * PAD), SENT_GEN, dtype=np.uint8)
    rlen_f = np.zeros(nb, dtype=np.int32)
    rlen_b = np.zeros(nb, dtype=np.int32)
    glen_f = np.zeros(nb, dtype=np.int32)
    glen_b = np.zeros(nb, dtype=np.int32)

    if n:
        g0s = np.asarray(g0s, dtype=np.int64)
        r0s = np.asarray(r0s, dtype=np.int64)
        oriented = np.where((orient == 1)[:, None], codes_rc[rows],
                            codes_fwd[rows])  # [n, L]
        glens = seq_lens[seq_idx]
        bases = seq_base[seq_idx]
        at_start = g0s == 0
        j = np.arange(rmax)

        # forward: read suffix after the seed vs genome from seed end
        cols = (r0s + K)[:, None] + j[None, :]
        sel = cols < L
        read_f[:n] = np.where(
            sel, np.take_along_axis(oriented, np.minimum(cols, L - 1),
                                    axis=1), SENT_READ)
        rlen_f[:n] = (L - r0s - K).astype(np.int32)
        glen_f[:n] = (glens - (g0s + K)).astype(np.int32)
        jj = np.arange(rmax + 2 * PAD)
        p = (g0s + K - PAD)[:, None] + jj[None, :]
        inb = (p >= 0) & (p < glens[:, None])
        pg = np.minimum(np.maximum(bases[:, None] + p, 0), len(seq_buf) - 1)
        gwin_f[:n] = np.where(inb, seq_buf[pg], SENT_GEN)

        # backward: reversed read prefix vs reversed genome prefix
        bsel = ~at_start
        cols_b = r0s[:, None] - 1 - j[None, :]
        sel_b = (cols_b >= 0) & bsel[:, None]
        read_b[:n] = np.where(
            sel_b, np.take_along_axis(oriented, np.maximum(cols_b, 0),
                                      axis=1), SENT_READ)
        rlen_b[:n] = np.where(bsel, r0s, 0).astype(np.int32)
        glen_b[:n] = np.where(bsel, g0s, 0).astype(np.int32)
        pb = g0s[:, None] - 1 - (jj[None, :] - PAD)
        inb_b = (jj[None, :] >= PAD) & (pb >= 0) & bsel[:, None]
        pgb = np.minimum(np.maximum(bases[:, None] + pb, 0),
                         len(seq_buf) - 1)
        gwin_b[:n] = np.where(inb_b, seq_buf[pgb], SENT_GEN)

    g0_pad = np.zeros(nb, dtype=np.int32)
    r0_pad = np.zeros(nb, dtype=np.int32)
    rlen_pad = np.zeros(nb, dtype=np.int32)
    g0_pad[:n] = g0s
    r0_pad[:n] = r0s
    rlen_pad[:n] = L
    valid = np.zeros(nb, dtype=bool)
    valid[:n] = True
    rid_pad = np.zeros(nb, dtype=np.int32)
    if read_ids is not None:
        rid_pad[:n] = read_ids
    return {
        "read_f": read_f, "rlen_f": rlen_f, "gwin_f": gwin_f, "glen_f": glen_f,
        "read_b": read_b, "rlen_b": rlen_b, "gwin_b": gwin_b, "glen_b": glen_b,
        "g0": g0_pad, "r0": r0_pad, "read_len": rlen_pad, "valid": valid,
        "at_start": g0_pad == 0 if n else np.zeros(nb, dtype=bool),
        "read_id": rid_pad, "rmax": rmax, "n": n,
    }


def _run_staged(st, use_kernel: bool, interpret: bool = False):
    """Extension kernel over a staged dict -> (ok, errs, d_back) numpy
    arrays over the padded batch."""
    ok, errs, d_back = extend_kernel(
        jnp.asarray(st["read_f"]), jnp.asarray(st["rlen_f"]),
        jnp.asarray(st["gwin_f"]), jnp.asarray(st["glen_f"]),
        jnp.asarray(st["read_b"]), jnp.asarray(st["rlen_b"]),
        jnp.asarray(st["gwin_b"]), jnp.asarray(st["glen_b"]),
        rmax=st["rmax"], use_kernel=use_kernel, interpret=interpret)
    return np.asarray(ok), np.asarray(errs), np.asarray(d_back)


def _finish(ok, errs, d_back, g0s, r0s, n):
    """Slice to the n real candidates and apply the genome-start special
    case (graph.cc:797-798) -> (ok, errs, begin)."""
    ok = ok[:n]
    errs = errs[:n].astype(np.int32)
    d_back = d_back[:n]
    g0s = np.asarray(g0s)[:n].astype(np.int64)
    r0s = np.asarray(r0s)[:n].astype(np.int64)
    begin = (g0s - r0s - d_back).astype(np.int32)
    at_start = g0s == 0
    ok = np.where(at_start, ok & (r0s < 6), ok)
    errs = np.where(at_start, errs + r0s, errs).astype(np.int32)
    begin = np.where(at_start, -1, begin)
    return ok, errs, begin


def extend_staged(st, use_pallas: bool = None, interpret: bool = False):
    """Run the extension kernel on a staged dict; returns (ok, errs, begin)
    numpy arrays for the n real candidates.  ``use_pallas`` defaults to
    the platform's route (utils.device)."""
    n = st["n"]
    if n == 0:
        return (np.zeros(0, bool), np.zeros(0, np.int32),
                np.zeros(0, np.int32))
    if use_pallas is None:
        from ..utils.device import use_kernel

        use_pallas = use_kernel()
    ok, errs, d_back = _run_staged(st, bool(use_pallas), interpret)
    return _finish(ok, errs, d_back, st["g0"], st["r0"], n)


def batch_extend_arrays(seq: np.ndarray, g0s: np.ndarray, r0s: np.ndarray,
                        reads: List[np.ndarray]):
    """Host staging + kernel run.  Returns (ok, errs, begin) numpy arrays
    replicating ProcessHit outputs (modulo the documented min-cost
    improvement)."""
    n = len(reads)
    if n == 0:
        return (np.zeros(0, bool), np.zeros(0, np.int32), np.zeros(0, np.int32))
    st = stage_candidates(seq, g0s, r0s, reads)
    ok, errs, d_back = _run_staged(st, use_kernel=False)
    return _finish(ok, errs, d_back, g0s, r0s, n)


def batch_extend_multi(seqs: List[np.ndarray], seq_idx: np.ndarray,
                       g0s: np.ndarray, r0s: np.ndarray,
                       reads: List[np.ndarray], use_pallas: bool = None):
    """Batched extension across many subpath windows in ONE device call
    (the device-backend precompute path without the native bundle).
    Returns (ok, errs, begin) over all candidates."""
    n = len(reads)
    if n == 0:
        return (np.zeros(0, bool), np.zeros(0, np.int32),
                np.zeros(0, np.int32))
    st = stage_candidates(seqs, g0s, r0s, reads, seq_idx=seq_idx)
    return extend_staged(st, use_pallas=use_pallas)


def batch_extend_host(seq: np.ndarray, cands) -> List[Tuple[bool, int, int]]:
    """SubpathAligner device backend: cands is [(Candidate, oriented_read)].
    Returns [(ok, errs, begin)] matching the oracle's contract."""
    g0s = np.array([c.genome_pos for c, _ in cands], dtype=np.int32)
    r0s = np.array([c.read_pos for c, _ in cands], dtype=np.int32)
    reads = [r for _, r in cands]
    ok, errs, begin = batch_extend_arrays(seq, g0s, r0s, reads)
    return [(bool(ok[i]), int(errs[i]), int(begin[i])) for i in range(len(cands))]
