"""Banded log-space forward-algorithm kernel (long reads).

Computes the total probability mass of all alignments of a read against a
genome region, under the reference's model (AligmentProbability,
graph.cc:2175-2297): match = match_prob, mismatch = mismatch_prob, each
inserted/deleted base = mismatch_prob; alignment may start at any genome
position (read position 0 is free) and ends when the read is consumed; the
result is the sum over band cells in the final read row.

The reference materializes a ragged band from a BLASR CIGAR; here the band
is a fixed-width window (W lanes) following a per-row guide column from
minimizer chaining (align.longread.guide_path) — a static-shape scan over
read positions, vectorized over a batch of reads on the VPU.  The within-
row left-gap dependency is an affine recurrence solved with an associative
scan in the (log) affine-composition semiring.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG = -1e30


def _affine_combine(left, right):
    """Compose affine maps x -> a*x + b in log space; scan is oriented so
    ``right`` is the later element."""
    la1, lb1 = left
    la2, lb2 = right
    return la1 + la2, jnp.logaddexp(la2 + lb1, lb2)


@functools.partial(jax.jit, static_argnames=("rmax", "width"))
def banded_forward(genome, reads, rlens, centers, gstarts, glens,
                   log_match, log_mismatch, rmax: int, width: int):
    """Gather-free banded forward DP (the device route's formulation).

    The guide path is consumed as per-row steps delta in {0,1,2} (host
    clips raw center jumps; the band catches up at <=2 columns/row), so
    the previous row and the rolling genome-char window advance by
    *statically selected shifts* — per row the only memory traffic beyond
    the carries is a [B, 2] fetch of the chars entering the band's right
    edge.  Same signature/semantics as the reference formulation
    (banded_forward_gather), which remains for cross-validation.
    """
    b = reads.shape[0]
    glen_total = genome.shape[0]
    # effective centers: cumulative clipped steps from centers[:,0]
    raw_steps = jnp.clip(jnp.diff(centers, axis=1), 0, 2)  # [B, rmax]
    base0 = centers[:, 0] - width // 2

    def g_at(idx):
        safe = jnp.clip(idx, 0, glen_total - 1)
        ch = genome[safe]
        return jnp.where((idx >= 0) & (idx < glen_total), ch, 9)

    offs = jnp.arange(width)
    # cw[o] = genome char consumed by diag/left at lane o = genome[base+o-1]
    cw0 = g_at(base0[:, None] + offs[None, :] - 1)
    g0_cells = base0[:, None] + offs[None, :]
    in0 = (g0_cells >= gstarts[:, None]) & \
          (g0_cells < (gstarts + glens)[:, None])
    m0 = jnp.where(in0, 0.0, NEG)

    def shiftl(x, k, fills):
        # shift lanes left by k, filling the right edge from fills[:, -k:]
        if k == 0:
            return x
        return jnp.concatenate([x[:, k:], fills[:, -k:]], axis=1)

    def row_step(carry, j):
        m_prev, cw, base = carry
        delta = jax.lax.dynamic_slice_in_dim(raw_steps, j - 1, 1, axis=1)[:, 0]
        base_new = base + delta

        # chars entering the right edge of the cw window
        fetch = jnp.stack([g_at(base_new + width - 3),
                           g_at(base_new + width - 2)], axis=1)
        cw_variants = [cw, shiftl(cw, 1, fetch), shiftl(cw, 2, fetch)]
        cw_new = jnp.where((delta == 0)[:, None], cw_variants[0],
                           jnp.where((delta == 1)[:, None], cw_variants[1],
                                     cw_variants[2]))

        neg_fill = jnp.full((b, 3), NEG)
        # m_prev at lane offset o+delta (up) and o+delta-1 (diag)
        m_shifts = [shiftl(m_prev, k, neg_fill) if k >= 0 else
                    jnp.concatenate([jnp.full((b, 1), NEG), m_prev[:, :-1]],
                                    axis=1)
                    for k in (-1, 0, 1, 2)]

        def sel(kvec):  # kvec in {-1,0,1,2} per batch item
            out = m_shifts[0]
            for i, k in enumerate((-1, 0, 1, 2)):
                out = jnp.where((kvec == k)[:, None], m_shifts[i], out)
            return out

        up = sel(delta)
        diag = sel(delta - 1)

        rchar = jax.lax.dynamic_slice_in_dim(reads, j - 1, 1, axis=1)[:, 0]
        s_diag = jnp.where(cw_new == rchar[:, None], log_match, log_mismatch)
        s_diag = jnp.where(cw_new >= 8, NEG, s_diag)

        g_cells = base_new[:, None] + offs[None, :]
        in_target = (g_cells >= gstarts[:, None]) & \
                    (g_cells < (gstarts + glens)[:, None])
        base_val = jnp.logaddexp(diag + s_diag, up + log_mismatch)
        base_val = jnp.where(in_target, base_val, NEG)

        gap_cost = jnp.where(in_target & (cw_new < 8), log_mismatch, NEG)
        _, x = jax.lax.associative_scan(_affine_combine, (gap_cost, base_val),
                                        axis=1)
        m_cur = x
        active = (j <= rlens)[:, None]
        m_cur = jnp.where(active, m_cur, m_prev)
        cw_new = jnp.where(active, cw_new, cw)
        base_new = jnp.where(j <= rlens, base_new, base)
        return (m_cur, cw_new, base_new), None

    rows = jnp.arange(1, rmax + 1)
    (m_final, _, _), _ = jax.lax.scan(row_step, (m0, cw0, base0), rows)
    out = jax.scipy.special.logsumexp(m_final, axis=1)
    return jnp.where(rlens > 0, out, NEG)


@functools.partial(jax.jit, static_argnames=("rmax", "width"))
def banded_forward_gather(genome, reads, rlens, centers, gstarts, glens,
                          log_match, log_mismatch, rmax: int, width: int):
    """Batched banded forward DP.

    genome: [G] uint8 buffer (concatenated targets); reads: [B, rmax] uint8
    (SENT padding); rlens: [B]; centers: [B, rmax+1] guide genome columns
    (absolute in the buffer); gstarts/glens: [B] target extent in the
    buffer (cells outside are -inf).  Returns logprob [B] (natural log).
    """
    b = reads.shape[0]
    offs = jnp.arange(width)

    def g_at(idx):
        # gather genome chars with bounds -> sentinel 9
        safe = jnp.clip(idx, 0, genome.shape[0] - 1)
        ch = genome[safe]
        return jnp.where((idx >= 0) & (idx < genome.shape[0]), ch, 9)

    def row0_mask(center0, gstart, glen):
        g = center0 - width // 2 + offs
        return (g >= gstart) & (g < gstart + glen)

    init_center = centers[:, 0]
    m0 = jnp.where(row0_mask(init_center[:, None], gstarts[:, None],
                             glens[:, None]), 0.0, NEG)

    def row_step(carry, j):
        m_prev = carry  # [B, W] log mass at row j-1
        c_prev = centers[:, j - 1]
        c_cur = centers[:, j]
        base_cur = c_cur - width // 2       # genome pos of offset 0
        g_cells = base_cur[:, None] + offs[None, :]
        in_target = (g_cells >= gstarts[:, None]) & \
                    (g_cells < (gstarts + glens)[:, None])

        rchar = jax.lax.dynamic_slice_in_dim(reads, j - 1, 1, axis=1)[:, 0]
        gchar_diag = g_at(g_cells - 1)  # genome char consumed by diag/left
        s_diag = jnp.where(gchar_diag == rchar[:, None], log_match, log_mismatch)
        s_diag = jnp.where(gchar_diag >= 8, NEG, s_diag)  # outside buffer

        # previous-row gathers: prev offset = o - 1 + delta (diag),
        # o + delta (up), delta = base_cur - base_prev
        delta = (c_cur - c_prev)[:, None]
        idx_diag = offs[None, :] - 1 + delta
        idx_up = offs[None, :] + delta
        def gather_prev(idx):
            safe = jnp.clip(idx, 0, width - 1)
            v = jnp.take_along_axis(m_prev, safe, axis=1)
            return jnp.where((idx >= 0) & (idx < width), v, NEG)
        diag = gather_prev(idx_diag) + s_diag
        up = gather_prev(idx_up) + log_mismatch  # read char vs gap
        base = jnp.logaddexp(diag, up)
        base = jnp.where(in_target, base, NEG)

        # left within-row: x[o] = logaddexp(base[o], x[o-1] + gap_cost[o])
        # where gap_cost consumes genome char at g-1 -> log_mismatch, or
        # blocked outside the target
        gap_cost = jnp.where(in_target & (gchar_diag < 8), log_mismatch, NEG)
        la = gap_cost
        lb = base
        _, x = jax.lax.associative_scan(_affine_combine, (la, lb), axis=1)
        m_cur = x

        active = (j <= rlens)[:, None]
        m_cur = jnp.where(active, m_cur, m_prev)
        return m_cur, None

    rows = jnp.arange(1, rmax + 1)
    m_final, _ = jax.lax.scan(row_step, m0, rows)
    # m_final holds row rlens (frozen by the active mask)
    out = jax.scipy.special.logsumexp(m_final, axis=1)
    return jnp.where(rlens > 0, out, NEG)


def forward_full_numpy(genome: np.ndarray, read: np.ndarray,
                       match_prob: float, mismatch_prob: float) -> float:
    """Unbanded float64 oracle of the same model: log total mass of
    alignments consuming the whole read, free start/end genome positions.
    Used to validate the banded kernel."""
    glen, rlen = len(genome), len(read)
    lm = np.log(match_prob)
    lx = np.log(mismatch_prob)
    m = np.full((rlen + 1, glen + 1), -np.inf)
    m[0, :] = 0.0
    for j in range(1, rlen + 1):
        rc = read[j - 1]
        sc = np.where(genome == rc, lm, lx)
        m[j, 0] = m[j - 1, 0] + lx  # read char vs gap at genome edge
        prev_diag = m[j - 1, :-1] + sc
        prev_up = m[j - 1, 1:] + lx
        base = np.logaddexp(prev_diag, prev_up)
        row = np.full(glen + 1, -np.inf)
        row[0] = m[j, 0]
        for g in range(1, glen + 1):
            row[g] = np.logaddexp(base[g - 1], row[g - 1] + lx)
        m[j] = row
    return float(np.logaddexp.reduce(m[rlen]))
