"""Device-resident staging + extension for the device backend.

The per-read code matrices are *resident* on the device (uploaded once
per read set, 4-bit packed), and a rescore ships only:

- the concatenated window sequence bytes (the walk content actually being
  scored), and
- 20 bytes per candidate of metadata (window index, g0, r0, row, orient).

Staging (read-suffix/prefix views, genome windows) happens on device as
gathers inside the same jit that runs the banded-extension DP, so XLA
fuses it all into one dispatch.  Outputs (ok, errs, begin) are bit-equal
to the host-staged path (ops.extend.stage_candidates_uniform +
extend_staged) — tested in tests/test_device_candgen.py.

Two compile-cost rules shape the API:

1. The jitted body is **shape-parametric and module-level**: the resident
   read matrices are passed as *arguments*, never closure-captured.  A
   captured device array becomes a literal constant of the XLA program —
   the executable would embed the whole read matrix, and neither the
   in-process nor the persistent compile cache could share work across
   read sets.  With arguments, every read set whose padded shapes match
   reuses ONE executable.
2. Shapes are bucketed (candidates to powers of two >= 512, sequence
   bytes to powers of two >= 4096, read-matrix rows to powers of two
   >= 1024) so the compile count stays logarithmic.

The host-return path fetches ONE packed int32 per candidate
((begin+64)<<6 | min(errs,31)<<1 | ok) instead of three arrays.
"""
from __future__ import annotations

import os

import numpy as np

from .extend import K, PAD, SENT_GEN, SENT_READ, extend_both


def _bucket_pow2(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


BPW = 8          # bases per packed int32 word (4-bit fields; codes 0..8)
FIELD = 4        # bits per base field
PACK_BIAS = 64   # begin offset in the packed result word


def _pack_words_np(bytes2d: np.ndarray) -> np.ndarray:
    b = bytes2d.astype(np.int32).reshape(
        bytes2d.shape[:-1] + (bytes2d.shape[-1] // BPW, BPW))
    out = b[..., 0]
    for k in range(1, BPW):
        out = out | (b[..., k] << (FIELD * k))
    return out


_FUSED_FNS = {}


def _get_fused(L: int, rmax: int, use_kernel: bool,
               interpret: bool = False):
    """The shared jitted fused stage+DP body for one (L, rmax) bucket.

    Signature: fused(fwd_words [R, W] i32, rc_words [R, W] i32,
                     seq_buf [s_pad] u8, base/glen_c/g0/r0/rows/orient
                     [n_pad] i32) -> (ok, errs, begin, packed), all
    [n_pad].  R, W, n_pad and s_pad are traced from the argument shapes,
    so one jitted function serves every read set with matching buckets.
    With ``use_kernel`` the caller passes candidates sorted by r0, so
    every kernel block sees a tight row bound in both directions."""
    key = (L, rmax, bool(use_kernel), bool(interpret))
    fn = _FUSED_FNS.get(key)
    if fn is None:
        import jax

        fn = _FUSED_FNS[key] = jax.jit(
            make_fused_body(L, rmax, use_kernel, interpret))
    return fn


def make_fused_body(L: int, rmax: int, use_kernel: bool,
                    interpret: bool = False):
    """Unjitted fused stage+DP body (shape-parametric: n_pad/s_pad come
    from the argument shapes).  Exposed so larger jits — the full
    device rescore in ops.rescore_device — can inline it."""
    import jax.numpy as jnp

    def pack_words(bytes2d):
        """[.., BPW*k] uint8 -> [.., k] int32, BPW bases per word in
        FIELD-bit fields (the HBM gather then moves BPW x fewer
        elements)."""
        b = bytes2d.astype(jnp.int32).reshape(
            bytes2d.shape[:-1] + (bytes2d.shape[-1] // BPW, BPW))
        out = b[..., 0]
        for k in range(1, BPW):
            out = out | (b[..., k] << (FIELD * k))
        return out

    def unpack_phase(w, ph, out_len):
        """bytes[i, t] = field (ph[i] + t) of the word stream w[i, :]:
        rotate each row's words by its phase IN THE PACKED DOMAIN (two
        vector shifts on [N, nw] words), then unpack with static field
        offsets — no per-row selection over the unpacked bytes.  Safe
        because packed fields are codes <= 4 (3 bits), so shifted words
        never touch the sign bit."""
        ph4 = (FIELD * ph)[:, None]
        wn = jnp.concatenate([w[:, 1:], jnp.zeros_like(w[:, :1])],
                             axis=1)
        rot = (w >> ph4) | jnp.where(
            ph4 == 0, 0, wn << (FIELD * BPW - ph4))
        mask = (1 << FIELD) - 1
        b = jnp.stack([(rot >> (FIELD * k)) & mask for k in range(BPW)],
                      axis=2).reshape(w.shape[0], BPW * w.shape[1])
        return b[:, 0:out_len]

    def gather_slices(words, starts, out_len, lo: int = None,
                      hi: int = None):
        """bytes[i, t] = src[i, starts[i] + t] for t < out_len, where
        ``words`` is the packed view of src.  words: [N, W] (per-row)
        or [W] (shared).  Out-of-range reads are arbitrary (callers
        mask); word indices are clamped.

        Per-row sources sum masked static column slices over the
        word-offset range [lo, hi] (small and statically known from
        L/rmax); the shared 1-D source becomes a sliding word matrix
        built from static shifts plus ONE row gather."""
        nw = out_len // BPW + 2
        base = starts // BPW
        ph = (starts % BPW).astype(jnp.int32)
        if words.ndim == 1:
            nrow = words.shape[0] - nw + 1
            cols = jnp.stack([words[m:m + nrow] for m in range(nw)],
                             axis=1)
            w = cols[jnp.clip(base, 0, nrow - 1)]
        else:
            W = words.shape[1]
            lo = 0 if lo is None else max(lo, 0)
            hi = W - 1 if hi is None else min(hi, W - 1)
            wordsp = jnp.concatenate(
                [words, jnp.zeros((words.shape[0], nw), jnp.int32)],
                axis=1)
            basec = jnp.clip(base, lo, hi)[:, None]
            w = jnp.zeros((words.shape[0], nw), jnp.int32)
            for m in range(lo, hi + 1):
                w = w + jnp.where(basec == m, wordsp[:, m:m + nw], 0)
        return unpack_phase(w, ph, out_len)

    wlen = rmax + 2 * PAD
    # left sentinel pads so every gather start is non-negative; the
    # padded bytes land only at masked positions
    wpad_r = rmax // BPW + 1
    wpad_g = wlen // BPW + 1

    def fused(fwd_words, rc_words, seq_buf, base, glen_c, g0, r0, rows,
              orient):
        s_pad = seq_buf.shape[0]
        # r0/orient may arrive as uint8 (compact transfer; r0 < L <= 255
        # buckets) — widen before any arithmetic to avoid u8 overflow
        r0 = r0.astype(jnp.int32)
        orient = orient.astype(jnp.int32)
        j = jnp.arange(rmax)
        jj = jnp.arange(wlen)
        owords = jnp.where((orient == 1)[:, None], rc_words[rows],
                           fwd_words[rows])
        pad_b = (-s_pad) % BPW + BPW
        bw = pack_words(jnp.concatenate(
            [seq_buf, jnp.zeros((pad_b,), jnp.uint8)])[None, :])[0]

        # forward: read suffix after the seed vs genome from seed end
        cols = (r0 + K)[:, None] + j[None, :]
        sel = cols < L
        read_f = jnp.where(sel, gather_slices(owords, r0 + K, rmax,
                                              lo=K // BPW, hi=L // BPW),
                           SENT_READ)
        rlen_f = (L - r0 - K).astype(jnp.int32)
        glen_f = (glen_c - (g0 + K)).astype(jnp.int32)
        p = (g0 + K - PAD)[:, None] + jj[None, :]
        inb = (p >= 0) & (p < glen_c[:, None])
        gwin_f = jnp.where(
            inb, gather_slices(bw, base + g0 + K - PAD, wlen), SENT_GEN)

        # backward: reversed read prefix vs reversed genome prefix.
        # read_b[j] = oriented[r0-1-j]: gather the forward slice
        # starting at r0-rmax and flip; gwin_b[jj] = buf[g0-1-(jj-PAD)]:
        # gather from base+g0+PAD-wlen and flip.  Left-padded packed
        # sources keep the (possibly negative) starts in range.
        at_start = g0 == 0
        bsel = ~at_start
        cols_b = r0[:, None] - 1 - j[None, :]
        sel_b = (cols_b >= 0) & bsel[:, None]
        owords_pad = jnp.concatenate(
            [jnp.zeros((owords.shape[0], wpad_r), jnp.int32), owords],
            axis=1)
        read_b = jnp.where(
            sel_b,
            gather_slices(owords_pad, r0 - rmax + BPW * wpad_r,
                          rmax, lo=(BPW * wpad_r - rmax) // BPW,
                          hi=(L - K - rmax + BPW * wpad_r) // BPW
                          )[:, ::-1],
            SENT_READ)
        rlen_b = jnp.where(bsel, r0, 0).astype(jnp.int32)
        glen_b = jnp.where(bsel, g0, 0).astype(jnp.int32)
        pb = g0[:, None] - 1 - (jj[None, :] - PAD)
        inb_b = (jj[None, :] >= PAD) & (pb >= 0) & bsel[:, None]
        bw_pad = jnp.concatenate(
            [jnp.zeros((wpad_g,), jnp.int32), bw])
        gwin_b = jnp.where(
            inb_b,
            gather_slices(bw_pad,
                          base + g0 + PAD - wlen + BPW * wpad_g,
                          wlen)[:, ::-1],
            SENT_GEN)

        ok, errs, d_back = extend_both(
            read_f, rlen_f, gwin_f, glen_f, read_b, rlen_b, gwin_b, glen_b,
            rmax, use_kernel=use_kernel, interpret=interpret)
        begin = g0 - r0 - d_back
        ok = jnp.where(at_start, ok & (r0 < 6), ok)
        errs = jnp.where(at_start, errs + r0, errs)
        begin = jnp.where(at_start, -1, begin)
        errs = errs.astype(jnp.int32)
        begin = begin.astype(jnp.int32)
        packed = ((jnp.clip(begin, -PACK_BIAS, 1 << 24) + PACK_BIAS) << 6) \
            | (jnp.clip(errs, 0, 31) << 1) | ok.astype(jnp.int32)
        return ok, errs, begin, packed

    return fused


def unpack_results(packed: np.ndarray):
    """Host inverse of the packed result word -> (ok, errs, begin)."""
    ok = (packed & 1).astype(bool)
    errs = ((packed >> 1) & 31).astype(np.int32)
    begin = ((packed >> 6) - PACK_BIAS).astype(np.int32)
    return ok, errs, begin


_ROWS_PAD_SEEN = [1024]  # process-wide max rows bucket (see __init__)


class DeviceExtender:
    """Per-read-set device extension engine with resident read matrices."""

    def __init__(self, codes_fwd: np.ndarray, codes_rc: np.ndarray):
        import jax
        import jax.numpy as jnp

        self.L = int(codes_fwd.shape[1])
        rmax_needed = max(self.L - K, 1)
        self.rmax = ((rmax_needed + 31) // 32) * 32
        # packed 4-bit-per-base views, rows padded to a power of two so
        # read sets of similar size share one executable; built once on
        # host and resident on device (the staging gathers then move BPW x
        # fewer elements than byte gathers).  Later read sets pad up to
        # the LARGEST bucket seen in this process (a few extra MB of
        # resident upload buys executable reuse: every distinct row count
        # otherwise costs its own compile).
        # GAML_DEV_ROWS_PAD pins the bucket explicitly.
        n_rows = int(codes_fwd.shape[0])
        env_pad = int(os.environ.get("GAML_DEV_ROWS_PAD", "0"))
        self.n_rows_pad = max(_bucket_pow2(max(n_rows, 1), 1024),
                              _ROWS_PAD_SEEN[0], env_pad)
        _ROWS_PAD_SEEN[0] = self.n_rows_pad
        pad_to4 = (-self.L) % BPW + BPW

        def pack_resident(codes):
            buf = np.zeros((self.n_rows_pad, self.L + pad_to4), np.uint8)
            buf[:n_rows, :self.L] = codes
            return jax.device_put(jnp.asarray(_pack_words_np(buf)))

        self.fwd_words = pack_resident(codes_fwd)
        self.rc_words = pack_resident(codes_rc)

    # --------------------------------------------------------------- run
    def run(self, seq_buf: np.ndarray, seq_base: np.ndarray,
            seq_lens: np.ndarray, seq_idx: np.ndarray, g0: np.ndarray,
            r0: np.ndarray, rows: np.ndarray, orient: np.ndarray,
            use_pallas: bool = None, return_device: bool = False,
            defer: bool = False, interpret: bool = False):
        """Returns (ok, errs, begin) for the N candidates — numpy arrays,
        or padded device arrays (length >= n) when return_device so a
        downstream on-device reduction avoids the round trip.

        With ``defer`` the dispatches still happen eagerly (JAX is async)
        but the blocking result fetch is packaged into the returned
        zero-arg closure — callers pipelining several read sets' batches
        dispatch ALL of them first and fetch at the end.

        ``use_pallas`` defaults to the platform's route (utils.device);
        the kernel route sorts candidates by r0 so every kernel block
        sees a tight live-row range in both directions (forward rows
        L-K-r0 descend, backward rows r0 ascend).

        Batches larger than GAML_DEV_CHUNK candidates are dispatched as a
        sequence of fixed-shape chunks sharing ONE uploaded window buffer:
        compile time grows with the candidate-axis length, so chunking
        bounds compile cost at one executable per (chunk, s_pad) bucket
        and pipelines the rest."""
        import jax.numpy as jnp

        n = len(g0)
        if n == 0:
            empty = (np.zeros(0, bool), np.zeros(0, np.int32),
                     np.zeros(0, np.int32))
            return (lambda: empty) if defer else empty
        if use_pallas is None:
            from ..utils.device import use_kernel

            use_pallas = use_kernel()
        chunk = int(os.environ.get("GAML_DEV_CHUNK", str(64 * 1024)))
        s_pad = _bucket_pow2(len(seq_buf) + 1, 4096)
        # multi-chunk batches round the tail UP to the full chunk shape:
        # one executable serves every chunk
        n_pad = chunk if n > chunk else _bucket_pow2(n, 512)

        buf = np.zeros(s_pad, dtype=np.uint8)
        buf[:len(seq_buf)] = seq_buf
        buf_dev = jnp.asarray(buf)

        cols = [seq_base[seq_idx], seq_lens[seq_idx], np.asarray(g0),
                np.asarray(r0), np.asarray(rows), np.asarray(orient)]
        order = None
        if use_pallas:
            order = np.argsort(np.asarray(r0), kind="stable")
            cols = [c[order] for c in cols]
        base_a, glen_a, g0_a, r0_a, rows_a, orient_a = cols
        # pad slots: g0 = 0 and r0 = L-K stage zero-row reads in both
        # directions (and sort to the tail of the r0 order)
        r0_fill = max(self.L - K, 0)
        # r0/orient transfer as uint8 when they fit (the body widens)
        r0_dt = np.uint8 if max(self.L, r0_fill) <= 255 else np.int32
        fn = _get_fused(self.L, self.rmax, use_pallas, interpret)

        outs = []  # (nc, (ok, errs, begin, packed))
        for c0 in range(0, n, chunk):
            c1 = min(c0 + chunk, n)
            nc = c1 - c0

            def pad(a, fill=0, dtype=np.int32):
                out = np.full(n_pad, fill, dtype=dtype)
                out[:nc] = a[c0:c1]
                return jnp.asarray(out)

            outs.append((nc, fn(
                self.fwd_words, self.rc_words, buf_dev, pad(base_a),
                pad(glen_a), pad(g0_a), pad(r0_a, r0_fill, r0_dt),
                pad(rows_a), pad(orient_a, 0, np.uint8))))

        inv = None
        if order is not None:
            inv = np.empty(n, dtype=np.int64)
            inv[order] = np.arange(n)

        def finish():
            if return_device:
                if len(outs) == 1 and inv is None:
                    return outs[0][1][:3]
                res = [jnp.concatenate([o[1][k][:o[0]] for o in outs])
                       for k in range(3)]
                if inv is not None:
                    gj = jnp.asarray(inv.astype(np.int32))
                    res = [jnp.take(x, gj) for x in res]
                return tuple(res)
            packed = np.concatenate(
                [np.asarray(o[1][3])[:o[0]] for o in outs])
            if inv is not None:
                packed = packed[inv]
            return unpack_results(packed)

        return finish if defer else finish()
