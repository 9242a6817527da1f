"""Banded-extension DP as a Pallas kernel for NVIDIA GPUs (Triton route).

Same recurrence as ops.extend._dp_rows (cost-to-accept plus the preferred
accept offset of the reference BFS, ProcessHit, graph.cc:753-837), in SWAR
form: the whole 7-slot band of one candidate lives in 4-bit fields of one
int32, so every band shift is a bit shift inside a register and a row step
is a few dozen integer operations.  Costs saturate at 7, which is exact
wherever the true cost is <= 6 — above everything downstream consumes:
``ok`` needs cost <= ERROR_LIMIT (3) per direction, and errs/begin are read
only for ok candidates (ops/score.py zeroes non-ok payloads; the aligner
postprocess filters by ok before touching errs/begin).

One program takes BLOCK consecutive candidates and walks the rows from the
block's largest row count down to 0; rows r >= rlen are accept rows whose
output equals the loop's initial state, so skipping them is exact.
Callers that sort candidates by row count (ops.extend_device,
ops.rescore_device) give each block a tight bound.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .extend import INVALID_A

# candidates per program and warps per program: one candidate per
# thread.  On an H100 every block of 32..256 candidates timed within
# run-to-run spread; 32 with one warp had the lowest median, and small
# blocks keep each block's row bound tight.
BLOCK = 32
NUM_WARPS = 1

L7 = 0x1111111          # 7 fields of 1
H7 = 0x8888888          # 7 field MSBs (spare bit keeps compares carry-free)
INF7 = 0x7777777        # 7 fields of 7 (saturated INF)
M28 = 0x0FFFFFFF
DCONST = 0x6543210      # field d holds value d


def pack_bandchars(gwin_t, rmax: int):
    """bandchars[r, c] = sum_d remap(gwin[r+1+d, c]) << 4d (d = 0..6):
    the 7 band characters of row r packed into one int32.  Sentinel code
    8 remaps to 6 so every code fits a 4-bit field (6 never equals a
    remapped read code: read sentinel 6 remaps to 4)."""
    g = jnp.where(gwin_t >= 6, gwin_t - 2, gwin_t).astype(jnp.int32)
    out = jnp.zeros((rmax,) + gwin_t.shape[1:], jnp.int32)
    for d in range(7):
        out = out | (jax.lax.dynamic_slice_in_dim(g, 1 + d, rmax, 0)
                     << (4 * d))
    return out


def _swar_min(a, b):
    """Per-4bit-field min; fields must be <= 7 (spare MSB)."""
    d = (a | H7) - b
    ge = d & H7                       # MSB set iff a >= b
    full = (ge >> 3) * 15             # 0xF where a >= b
    return (b & full) | (a & ~full)


def _sat_add1(w):
    """+1 per field, saturating at 7 (fields <= 7 on input)."""
    s = w + L7
    ov = s & H7
    return s - (ov >> 3)


def _swar_eqmask(u, v):
    """0xF per field where u == v (field values <= 8 on u, <= 7 on v).
    The one false-positive shape (u=8 vs v=0) cannot occur at any field
    the callers consult: every take condition carries a ~match factor and
    ~match forces c_row >= 1 at non-accept cells (accept cells overwrite
    a wholesale)."""
    z = u ^ v
    e = H7 & ~((z | H7) - L7)
    return (e >> 3) * 15


def _row_step(r, bc, rc, rlen, glen, c, a=None):
    """One DP row over the 7 packed band slots: match/substitution/
    genome-skip/read-skip with the boundary rules of ops.extend, and —
    when ``a`` is given — the preferred-accept-offset propagation
    (forced match > substitution > genome-skip > read-skip), offsets
    packed as d+3 in 0..6 with 7 = INVALID.  The offset is exact wherever
    the final cost is <= 6: every cell on a surviving chain has cost <=
    its start cost, so all consulted comparisons are unsaturated."""
    x = bc ^ rc
    eq = H7 & ~((x | H7) - L7)
    fm = (eq >> 3) * 15               # 0xF per matching field
    t = jnp.clip(glen - r + 2, 0, 7)
    ge = H7 & ((DCONST | H7) - t * L7)
    fgpi = ((H7 ^ ge) >> 3) * 15      # g_plus_in per field
    lr_full = jnp.where(rlen == r + 1, -1, 0)
    acc_full = jnp.where(r >= rlen, -1, 0)

    dcond = fm & (fgpi | lr_full)
    diag = (c & dcond) | (INF7 & ~dcond)
    scond = fgpi & ~fm
    sub = (_sat_add1(c) & scond) | (INF7 & ~scond)
    c_dm1 = ((c << 4) | 0x7) & M28
    rskip = (_sat_add1(c_dm1) & ~fm & M28) | (INF7 & fm)
    c_row = _swar_min(_swar_min(diag, sub), rskip)
    for _ in range(3):
        up = (c_row >> 4) | (0x7 << 24)
        m = _swar_min(c_row, _sat_add1(up))
        c_row = (m & scond) | (c_row & ~scond)
    c_row = c_row & ~acc_full
    if a is None:
        return c_row, None

    # take masks against the (accept-zeroed) row
    fsub = scond & _swar_eqmask(c + L7, c_row)
    c_up = (c_row >> 4) | (0x7 << 24)
    fgsk = scond & ~fsub & _swar_eqmask(c_up + L7, c_row)
    frsk = (~fm & M28) & ~fsub & ~fgsk & _swar_eqmask(c_dm1 + L7, c_row)
    a_dm1 = ((a << 4) | 0x7) & M28
    keep = fm | fsub
    a_row = (a & keep) | (a_dm1 & frsk & ~keep) | \
        (INF7 & ~keep & ~frsk & M28)
    for _ in range(4):
        a_up = (a_row >> 4) | (0x7 << 24)
        a_row = (a_up & fgsk) | (a_row & ~fgsk)
    a_row = (DCONST & acc_full) | (a_row & ~acc_full)
    return c_row, a_row


def _kernel(bc_ref, rc_ref, rlen_ref, glen_ref, c_ref, a_ref=None):
    rlen = rlen_ref[...]
    glen = glen_ref[...]
    nrows = jnp.max(rlen)
    accept = a_ref is not None

    def body(k, carry):
        r = nrows - 1 - k
        c, a = _row_step(r, bc_ref[r, :], rc_ref[r, :], rlen, glen,
                         carry[0], carry[1] if accept else None)
        return (c, a) if accept else (c,)

    init = (jnp.zeros_like(rlen),)
    if accept:
        init += (jnp.full_like(rlen, DCONST),)
    out = jax.lax.fori_loop(0, nrows, body, init)
    c_ref[...] = (out[0] >> 12) & 0xF     # field 3 = band offset d = 0
    if accept:
        a_ref[...] = (out[1] >> 12) & 0xF


@functools.partial(jax.jit, static_argnames=("rmax", "accept", "interpret",
                                             "block"))
def dp_kernel(read, rlen, gwin, glen, rmax: int, accept: bool,
              interpret: bool = False, block: int = BLOCK):
    """The d=0 start state of the banded DP for each candidate, with the
    inputs of ops.extend._dp_rows: read [N, rmax], rlen [N],
    gwin [N, rmax + 2*PAD], glen [N].

    Returns the cost saturated at 7 (int32 [N]) and, with ``accept``, the
    preferred accept offset (int32 [N], INVALID_A where none is
    preferred).  ``interpret`` runs the kernel on the CPU and ``block``
    overrides BLOCK; both are test hooks."""
    n = read.shape[0]
    n_pad = -(-n // block) * block

    def pad(x, fill):
        if n_pad == n:
            return x
        widths = [(0, n_pad - n)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths, constant_values=fill)

    # padded candidates have zero rows: cost 0, offset 0, sliced off below
    read_t = pad(read.astype(jnp.int32), 0).T
    gwin_t = pad(gwin.astype(jnp.int32), 0).T
    bc = pack_bandchars(gwin_t, rmax)
    rc = jnp.where(read_t >= 6, read_t - 2, read_t) * L7
    nout = 2 if accept else 1
    outs = pl.pallas_call(
        _kernel,
        grid=(n_pad // block,),
        in_specs=[pl.BlockSpec((rmax, block), lambda i: (0, i)),
                  pl.BlockSpec((rmax, block), lambda i: (0, i)),
                  pl.BlockSpec((block,), lambda i: (i,)),
                  pl.BlockSpec((block,), lambda i: (i,))],
        out_specs=[pl.BlockSpec((block,), lambda i: (i,))] * nout,
        out_shape=[jax.ShapeDtypeStruct((n_pad,), jnp.int32)] * nout,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="gaml_extend_dp",
    )(bc, rc, pad(rlen.astype(jnp.int32), 0),
      pad(glen.astype(jnp.int32), 0))
    c = outs[0][:n]
    if not accept:
        return c
    a = outs[1][:n]
    return c, jnp.where(a == 7, INVALID_A, a - 3)
