"""Multi-chip paired-end likelihood scoring (live-path semantics).

The production paired scorer is the *incremental* one (reference
CalcScoreForPathsNew, graph.cc:1952-1989): per-walk position collection
via GetPositionsOnlyPath (graph.cc:535-598, with the trailing-window
``pos < max_pos - 5`` filter), the innie pair products with the
rs2-length-twice event threshold quirk (graph.cc:1855-1857), per-walk
coverage sweeps, and the floored mean-log reduction over per-read totals
(GetTotalProb, graph.cc:1495-1516).  This module reproduces those exact
semantics as a full rescore with the O(rows * K^2) pair products and the
O(n_reads) reduction on a device mesh:

- host: window precompute + per-walk position collection (identical code
  paths to scoring/paired.py) + the tiny per-walk event sweeps;
- device: rows = (walk, read) pairs with positions in both mates, bucketed
  by position count (NO silent truncation — the widest bucket is sized to
  the true maximum), sharded over the mesh "reads" axis; each bucket's
  pair products segment-sum into per-read totals merged with
  ``psum_scatter``; the floored log reduction merges shard partials with
  ``psum``;
- coverage events (qualifying pairs, max/min positions) come back as
  device arrays and feed the host per-walk sweeps.

Scores match the host incremental scorer to float-reassociation accuracy
(the device sums per-read contributions in segment order, the host in
emission order); tests pin 1e-9 relative on CPU meshes with x64.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

_BUCKET_KS = (4, 16, 64)  # position-count classes; above the last, K = max
# rows with more positions than this are split into sub-rows (grid chunks
# over the two mates' position lists — an exact partition of the K x K pair
# products), so no bucket is ever wider than this
_SPLIT_K = int(os.environ.get("GAML_PAIR_SPLIT_K", "128"))
# cap on rows_pad * K * K cells per bucket dispatch; wide classes are
# chunked along the row axis (uniform chunk shapes share one compile)
_MAX_CELLS = int(os.environ.get("GAML_PAIR_BUCKET_CELLS", str(1 << 22)))


def _collect_walk_rows(graph, path, read_set1, read_set2):
    """One walk's (rid, plist1, plist2) rows + host scaffold events,
    exactly as calc_score_for_path_inc collects them (reference
    graph.cc:1794-1853)."""
    from ..core.paths import path_len, split_at_gaps
    from ..native import get_lib

    events: List[Tuple[int, int]] = [(0, 1)]
    ctgs, gaps = split_at_gaps(list(path))
    ctgs_with_st = []
    cur_len = 0
    for i, ctg in enumerate(ctgs):
        if i > 0:
            cur_len += gaps[i - 1]
            events.append((cur_len, 1))
        ctgs_with_st.append((ctg, cur_len))
        cur_len += path_len(graph, ctg)

    if get_lib() is not None:
        from ..native import collect_positions_ptr

        g1 = collect_positions_ptr(
            read_set1.stage_position_windows(graph, ctgs_with_st),
            n_reads=read_set1.get_number_of_reads())
        g2 = collect_positions_ptr(
            read_set2.stage_position_windows(graph, ctgs_with_st),
            n_reads=read_set2.get_number_of_reads())
        return g1, g2, events

    positions1: Dict[int, list] = {}
    positions2: Dict[int, list] = {}
    for ctg, st in ctgs_with_st:
        read_set1.get_positions_only_path(graph, ctg, st, positions1)
        read_set2.get_positions_only_path(graph, ctg, st, positions2)

    def grouped(positions):
        rids = np.array(sorted(positions), dtype=np.int32)
        cnts = np.array([len(positions[r]) for r in rids.tolist()],
                        dtype=np.int32)
        starts = np.zeros(len(rids), dtype=np.int64)
        if len(rids):
            starts[1:] = np.cumsum(cnts[:-1])
        total = int(cnts.sum()) if len(rids) else 0
        pos = np.zeros(total, np.int32)
        ed = np.zeros(total, np.int32)
        orient = np.zeros(total, np.int32)
        k = 0
        for r in rids.tolist():
            for al in positions[r]:
                pos[k] = al.position
                ed[k] = al.edit_dist
                orient[k] = al.orientation
                k += 1
        return rids, starts, cnts, pos, ed, orient

    return grouped(positions1), grouped(positions2), events


def _ragged_fill(dense, starts, cnts, flat):
    """dense[row, :cnts[row]] = flat[starts[row] : starts[row]+cnts[row]]."""
    if len(cnts) == 0 or cnts.sum() == 0:
        return
    rows_idx = np.repeat(np.arange(len(cnts)), cnts)
    cum = np.zeros(len(cnts), dtype=np.int64)
    cum[1:] = np.cumsum(cnts[:-1])
    cols = np.arange(int(cnts.sum())) - np.repeat(cum, cnts)
    src = np.repeat(starts, cnts) + cols
    dense[rows_idx, cols] = flat[src]


def stage_paired_rows(graph, paths, read_set1, read_set2,
                      row_align: int = 8):
    """Stage every walk's pair rows into count-class buckets.

    Returns (buckets, walk_events, total_len).  Each bucket: dense
    [rows_pad, K] int32 arrays pos1/ed1/or1/pos2/ed2/or2 plus per-row
    rid / walk / len1 / len2 / mask.  Every (walk, read-in-both-mates)
    row appears in exactly one bucket with ALL its positions."""
    from ..core.paths import path_len

    read_set1.precompute_alignment_for_paths(paths, graph)
    read_set2.precompute_alignment_for_paths(paths, graph)

    lens1 = read_set1.read_lens_array().astype(np.int32)
    lens2 = read_set2.read_lens_array().astype(np.int32)
    per_walk = []
    walk_events = []
    total_len = 0
    for w, path in enumerate(paths):
        g1, g2, events = _collect_walk_rows(graph, path, read_set1, read_set2)
        walk_events.append(events)
        total_len += path_len(graph, path)
        rid1, st1, ct1 = g1[0], g1[1], g1[2]
        rid2, st2, ct2 = g2[0], g2[1], g2[2]
        common, i1, i2 = np.intersect1d(rid1, rid2, assume_unique=True,
                                        return_indices=True)
        per_walk.append((w, common, st1[i1], ct1[i1], g1[3], g1[4], g1[5],
                         st2[i2], ct2[i2], g2[3], g2[4], g2[5]))

    # global sub-row table.  A row is (walk, rid, mate-1 slice, mate-2
    # slice); rows with more than _SPLIT_K positions in either mate are
    # split into grid sub-rows — chunks over the two position lists whose
    # cartesian products exactly partition the full K1 x K2 pair set, so
    # segment-summing sub-row products by rid reproduces the unsplit sums
    # and the per-position event flags are unchanged.
    walk_idx: List[np.ndarray] = []  # index into per_walk, per sub-row
    rid_l: List[np.ndarray] = []
    st1_l: List[np.ndarray] = []
    ct1_l: List[np.ndarray] = []
    st2_l: List[np.ndarray] = []
    ct2_l: List[np.ndarray] = []
    for pw in per_walk:
        (w, common, st1, ct1, _p1, _e1, _o1, st2, ct2, _p2, _e2, _o2) = pw
        big = np.nonzero((ct1 > _SPLIT_K) | (ct2 > _SPLIT_K))[0]
        if len(big) == 0:
            walk_idx.append(np.full(len(common), w, np.int32))
            rid_l.append(common.astype(np.int32))
            st1_l.append(st1.astype(np.int64))
            ct1_l.append(ct1.astype(np.int32))
            st2_l.append(st2.astype(np.int64))
            ct2_l.append(ct2.astype(np.int32))
            continue
        keep = np.ones(len(common), bool)
        keep[big] = False
        walk_idx.append(np.full(int(keep.sum()), w, np.int32))
        rid_l.append(common[keep].astype(np.int32))
        st1_l.append(st1[keep].astype(np.int64))
        ct1_l.append(ct1[keep].astype(np.int32))
        st2_l.append(st2[keep].astype(np.int64))
        ct2_l.append(ct2[keep].astype(np.int32))
        for r in big.tolist():
            n1 = -(-int(ct1[r]) // _SPLIT_K)
            n2 = -(-int(ct2[r]) // _SPLIT_K)
            a = np.repeat(np.arange(n1), n2)
            bo = np.tile(np.arange(n2), n1)
            walk_idx.append(np.full(n1 * n2, w, np.int32))
            rid_l.append(np.full(n1 * n2, common[r], np.int32))
            st1_l.append(st1[r] + a * _SPLIT_K)
            ct1_l.append(np.minimum(_SPLIT_K,
                                    ct1[r] - a * _SPLIT_K).astype(np.int32))
            st2_l.append(st2[r] + bo * _SPLIT_K)
            ct2_l.append(np.minimum(_SPLIT_K,
                                    ct2[r] - bo * _SPLIT_K).astype(np.int32))

    def cat(parts, dtype):
        return np.concatenate(parts).astype(dtype) if parts else \
            np.zeros(0, dtype)

    walk_all = cat(walk_idx, np.int32)
    rid_all = cat(rid_l, np.int32)
    st1_all = cat(st1_l, np.int64)
    ct1_all = cat(ct1_l, np.int32)
    st2_all = cat(st2_l, np.int64)
    ct2_all = cat(ct2_l, np.int32)
    counts = np.maximum(ct1_all, ct2_all)
    kmax = int(counts.max()) if len(counts) else 0

    classes: List[Tuple[int, np.ndarray]] = []
    prev = 0
    for k in _BUCKET_KS:
        ids = np.nonzero((counts > prev) & (counts <= k))[0]
        if len(ids):
            classes.append((k, ids))
        prev = k
    if kmax > prev:
        classes.append((kmax, np.nonzero(counts > prev)[0]))

    pos_by_walk = {pw[0]: (pw[4], pw[5], pw[6], pw[9], pw[10], pw[11])
                   for pw in per_walk}

    buckets = []
    for k, all_ids in classes:
        # chunk the class so one dispatch never materializes more than
        # _MAX_CELLS K x K cells; all chunks share one padded shape so the
        # class costs a single compile
        rows_cap = max(row_align, (_MAX_CELLS // max(k * k, 1))
                       // row_align * row_align)
        n_chunks = max(1, -(-len(all_ids) // rows_cap))
        r_pad = min(rows_cap,
                    ((len(all_ids) - 1) // (n_chunks * row_align) + 1)
                    * row_align) if n_chunks > 1 else \
            ((len(all_ids) + row_align - 1) // row_align) * row_align
        for c0 in range(0, len(all_ids), r_pad):
            ids = all_ids[c0:c0 + r_pad]
            r = len(ids)
            b = {"pos1": np.full((r_pad, k), -1, np.int32),
                 "ed1": np.zeros((r_pad, k), np.int32),
                 "or1": np.zeros((r_pad, k), np.int32),
                 "pos2": np.full((r_pad, k), -1, np.int32),
                 "ed2": np.zeros((r_pad, k), np.int32),
                 "or2": np.zeros((r_pad, k), np.int32),
                 "rid": np.full(r_pad, 0, np.int32),
                 "walk": np.full(r_pad, -1, np.int32),
                 "len1": np.zeros(r_pad, np.int32),
                 "len2": np.zeros(r_pad, np.int32),
                 "mask": np.zeros(r_pad, bool)}
            b["rid"][:r] = rid_all[ids]
            b["walk"][:r] = walk_all[ids]
            b["len1"][:r] = lens1[rid_all[ids]]
            b["len2"][:r] = lens2[rid_all[ids]]
            b["mask"][:r] = True
            # scatter the ragged position lists of the selected rows, per
            # walk (rows of one walk share that walk's flat position arrays)
            sel_walk = walk_all[ids]
            for w in np.unique(sel_walk).tolist():
                in_walk = np.nonzero(sel_walk == w)[0]
                pos1_a, ed1_a, or1_a, pos2_a, ed2_a, or2_a = pos_by_walk[w]
                for mate, st_a, ct_a, pos_a, ed_a, or_a in (
                        ("1", st1_all, ct1_all, pos1_a, ed1_a, or1_a),
                        ("2", st2_all, ct2_all, pos2_a, ed2_a, or2_a)):
                    sts = st_a[ids[in_walk]]
                    cts = ct_a[ids[in_walk]]
                    sub_pos = np.zeros((len(in_walk), k), np.int32) - 1
                    sub_ed = np.zeros((len(in_walk), k), np.int32)
                    sub_or = np.zeros((len(in_walk), k), np.int32)
                    _ragged_fill(sub_pos, sts, cts, pos_a)
                    _ragged_fill(sub_ed, sts, cts, ed_a)
                    _ragged_fill(sub_or, sts, cts, or_a)
                    b["pos" + mate][in_walk] = sub_pos
                    b["ed" + mate][in_walk] = sub_ed
                    b["or" + mate][in_walk] = sub_or
            buckets.append(b)
    return buckets, walk_events, total_len


def pack_bucket(bucket) -> np.ndarray:
    """One-transfer bucket layout: [rows, 6K + 4] int32 — the six
    [rows, K] blocks (pos1, ed1, or1, pos2, ed2, or2) then the
    rid/len1/len2/mask columns (mask as 0/1).  The reads axis stays the
    leading dimension, so the packed array shards over the mesh "reads"
    axis exactly like the ten arrays it replaces; multiprocess callers
    pack their local row block and build one global array from it."""
    return np.concatenate(
        [np.asarray(bucket[k], dtype=np.int32)
         for k in ("pos1", "ed1", "or1", "pos2", "ed2", "or2")]
        + [np.asarray(bucket["rid"], dtype=np.int32)[:, None],
           np.asarray(bucket["len1"], dtype=np.int32)[:, None],
           np.asarray(bucket["len2"], dtype=np.int32)[:, None],
           np.asarray(bucket["mask"]).astype(np.int32)[:, None]],
        axis=1)


class ShardedPairedScorer:
    """Pair products + floored reduction on a device mesh ("reads" axis).

    dtype: float64 on CPU meshes for bit-close host parity (requires
    jax_enable_x64), float32 opt-in for throughput."""

    def __init__(self, mesh, log_m1, log_mm1, log_m2, log_mm2,
                 insert_mean: float, insert_std: float, dtype=None,
                 collect_events: bool = True):
        import jax
        import jax.numpy as jnp

        self.mesh = mesh
        self.nr = mesh.shape["reads"]
        self.params = (float(log_m1), float(log_mm1), float(log_m2),
                       float(log_mm2), float(insert_mean), float(insert_std))
        if dtype is None:
            dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        self.dtype = dtype
        self.collect_events = collect_events
        self._bucket_fns = {}
        self._reduce_fns = {}

    # ------------------------------------------------------ bucket products
    def _make_bucket(self, n_pad: int, apply: bool = False):
        """apply=False: shard_fn(bucket args) -> per-read totals (sharded).
        apply=True: shard_fn(probs, sign, bucket args) -> updated probs —
        the incremental path's fused products + psum_scatter + signed
        accumulate, ONE dispatch per bucket with the probs buffer donated."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        (log_m1, log_mm1, log_m2, log_mm2, im, istd) = self.params
        dtype = self.dtype
        collect_events = self.collect_events
        nr = self.nr

        def shard_fn(pos1, ed1, or1, pos2, ed2, or2, rid, len1, len2, mask,
                     mppb, mps):
            v = (pos1 >= 0)[:, :, None] & (pos2 >= 0)[:, None, :]
            x_pos = pos1[:, :, None]
            y_pos = pos2[:, None, :]
            x_first = x_pos < y_pos
            geom_ok = jnp.where(
                x_first,
                (or1[:, :, None] == 0) & (or2[:, None, :] == 1),
                (or1[:, :, None] == 1) & (or2[:, None, :] == 0))
            dist = jnp.where(x_first,
                             y_pos - x_pos + len2[:, None, None],
                             x_pos - y_pos + len1[:, None, None]).astype(dtype)
            z = (dist - im) / istd
            insprob = jnp.exp(-z * z / 2.0) / (np.sqrt(2 * np.pi) * istd)
            lp1 = (ed1 * log_mm1 + (len1[:, None] - ed1) * log_m1)
            lp2 = (ed2 * log_mm2 + (len2[:, None] - ed2) * log_m2)
            p = jnp.exp(lp1[:, :, None].astype(dtype) +
                        lp2[:, None, :].astype(dtype)) * insprob
            valid = v & geom_ok & mask[:, None, None]
            p = jnp.where(valid, p, 0.0)
            row_probs = jnp.sum(p, axis=(1, 2))
            full = jax.ops.segment_sum(row_probs, jnp.where(mask, rid, 0),
                                       num_segments=n_pad)
            # merge all shards' row contributions; each shard keeps its
            # reads-slice of the per-read totals
            local = jax.lax.psum_scatter(full, "reads", scatter_dimension=0,
                                         tiled=True)
            if not collect_events:
                return local
            # incremental event-threshold quirk: rs2's length twice
            # (reference graph.cc:1855-1857)
            thr_ev = jnp.exp(mps + mppb * (len2 + len2).astype(dtype))
            qual = valid & (p > thr_ev[:, None, None])
            # the coverage sweep consumes only the SET of qualifying
            # event positions per walk (duplicates are gap-0 no-ops), and
            # every event value is one of the row's own positions — so
            # compress the K x K event matrix to per-position flag bits:
            # "this position is the max (bit set) / min of some
            # qualifying pair".  Transfer shrinks from 2*K*K int32 to K
            # uint8 per row and host extraction becomes pure numpy.
            x_is_max = x_pos >= y_pos
            f1max = jnp.any(qual & x_is_max, axis=2)
            f1min = jnp.any(qual & ~x_is_max, axis=2)
            f2max = jnp.any(qual & ~x_is_max, axis=1)
            f2min = jnp.any(qual & x_is_max, axis=1)
            flags = (f1max.astype(jnp.uint8) |
                     (f1min.astype(jnp.uint8) << 1) |
                     (f2max.astype(jnp.uint8) << 2) |
                     (f2min.astype(jnp.uint8) << 3))
            return local, flags

        def unpack(packed):
            # single-transfer bucket form: [rows, 6K + 4] int32 with the
            # six [rows, K] position/edit/orientation blocks then
            # rid/len1/len2/mask columns (mask as 0/1).  One host->device
            # transfer per bucket instead of ten
            kk = (packed.shape[1] - 4) // 6
            parts = [packed[:, i * kk:(i + 1) * kk] for i in range(6)]
            rid = packed[:, 6 * kk]
            len1 = packed[:, 6 * kk + 1]
            len2 = packed[:, 6 * kk + 2]
            mask = packed[:, 6 * kk + 3] == 1
            return parts + [rid, len1, len2, mask]

        if apply:
            def shard_apply(probs, sign, packed, *args):
                out = shard_fn(*unpack(packed), *args)
                local = out[0] if collect_events else out
                newp = probs + sign * local
                return (newp, out[1]) if collect_events else newp

            in_specs = tuple([P("reads"), P(), P("reads")] + [P()] * 2)
            out_specs = (P("reads"), P("reads")) if collect_events \
                else P("reads")
            return jax.jit(jax.shard_map(shard_apply, mesh=self.mesh,
                                         in_specs=in_specs,
                                         out_specs=out_specs,
                                         check_vma=False),
                           donate_argnums=(0,))

        in_specs = tuple([P("reads")] * 10 + [P()] * 2)
        out_specs = P("reads") if not collect_events else \
            (P("reads"), P("reads"))
        return jax.jit(jax.shard_map(shard_fn, mesh=self.mesh,
                                     in_specs=in_specs, out_specs=out_specs,
                                     check_vma=False))

    def bucket_fn(self, shape, n_pad: int, apply: bool = False):
        """The jitted shard_map for one bucket shape — multiprocess
        callers build global mesh arrays themselves and invoke this
        directly (numpy inputs are only valid single-process).  The
        apply=True form takes (probs, sign, packed_bucket, mppb, mps)
        with the bucket in pack_bucket's single-array layout."""
        key = (tuple(shape), n_pad, apply)
        fn = self._bucket_fns.get(key)
        if fn is None:
            fn = self._bucket_fns[key] = self._make_bucket(n_pad, apply)
        return fn

    def bucket_apply(self, probs, sign: float, bucket, n_pad: int,
                     min_prob_per_base: float, min_prob_start: float):
        """Fused incremental delta: probs += sign * (this bucket's
        psum_scatter'd per-read pair totals).  Returns (new_probs,
        event_flags-or-None); probs' buffer is donated.  The bucket
        ships as ONE packed array (pack_bucket)."""
        import jax.numpy as jnp

        fn = self.bucket_fn(bucket["pos1"].shape, n_pad, apply=True)
        out = fn(probs, jnp.asarray(sign, dtype=self.dtype),
                 jnp.asarray(pack_bucket(bucket)),
                 jnp.asarray(min_prob_per_base, dtype=self.dtype),
                 jnp.asarray(min_prob_start, dtype=self.dtype))
        if self.collect_events:
            return out
        return out, None

    def bucket_products(self, bucket, n_pad: int, min_prob_per_base: float,
                        min_prob_start: float):
        """Returns (read_probs_sharded [n_pad], event_flags [rows, K]) —
        flags None unless collect_events.  Flag bits per (row, position):
        0 = pos1 is the max of a qualifying pair, 1 = pos1 is the min,
        2 = pos2 is the max, 3 = pos2 is the min."""
        import jax.numpy as jnp

        fn = self.bucket_fn(bucket["pos1"].shape, n_pad)
        args = [jnp.asarray(bucket[k]) for k in
                ("pos1", "ed1", "or1", "pos2", "ed2", "or2", "rid",
                 "len1", "len2", "mask")]
        args += [jnp.asarray(min_prob_per_base, dtype=self.dtype),
                 jnp.asarray(min_prob_start, dtype=self.dtype)]
        out = fn(*args)
        if self.collect_events:
            return out
        return out, None

    # ----------------------------------------------------------- reduction
    def _make_reduce(self, n_pad: int, n_reads: int):
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        dtype = self.dtype

        def shard_fn(probs, lens, mask, total_len, mppb, mps):
            tl = jnp.maximum(total_len, 1).astype(dtype)
            p = probs / (2.0 * tl)
            thresholds = jnp.exp(mps + mppb * lens)
            floored = (p < thresholds) & mask
            zero_local = jnp.sum(floored.astype(jnp.int32))
            p = jnp.where(p < thresholds, thresholds, p)
            log_local = jnp.sum(jnp.where(mask, jnp.log(p), 0.0))
            return (jax.lax.psum(log_local, "reads") / n_reads,
                    jax.lax.psum(zero_local, "reads"))

        return jax.jit(jax.shard_map(
            shard_fn, mesh=self.mesh,
            in_specs=(P("reads"), P("reads"), P("reads"), P(), P(), P()),
            out_specs=(P(), P()), check_vma=False))

    def reduce_fn(self, n_pad: int, n_reads: int):
        """Jitted reduction shard_map (multiprocess-callable), cached per
        (n_pad, n_reads) so alternating read-set sizes don't recompile."""
        key = (n_pad, n_reads)
        fn = self._reduce_fns.get(key)
        if fn is None:
            fn = self._reduce_fns[key] = self._make_reduce(n_pad, n_reads)
        return fn

    def reduce(self, read_probs, lens, mask, n_pad, n_reads, total_len,
               min_prob_per_base, min_prob_start):
        import jax.numpy as jnp

        s, z = self.reduce_fn(n_pad, n_reads)(
            read_probs, lens, mask,
            jnp.asarray(float(total_len), dtype=self.dtype),
            jnp.asarray(min_prob_per_base, dtype=self.dtype),
            jnp.asarray(min_prob_start, dtype=self.dtype))
        return float(s), int(z)


def calc_score_for_paths_paired_sharded(
        graph, paths, read_set1, read_set2, insert_mean: float,
        insert_std: float, mesh, no_cov_penalty: float = 0.0,
        exp_cov_move: float = 0.75, use_all_to_cov: bool = False,
        min_prob_per_base: float = -0.7, min_prob_start: float = -10.0,
        scorer: Optional[ShardedPairedScorer] = None, dtype=None):
    """Full paired rescore with live incremental-path semantics, pair
    products + reduction on the mesh.  Returns (score, zero_reads,
    total_len) — equal to calc_score_for_paths_incremental from a fresh
    ScoringState up to float reassociation."""
    import jax.numpy as jnp

    from ..scoring.paired import _coverage_sweep, _pair_lens

    assert read_set1.get_number_of_reads() == read_set2.get_number_of_reads()
    n = read_set1.get_number_of_reads()
    nr = mesh.shape["reads"]
    if scorer is None:
        scorer = ShardedPairedScorer(
            mesh, np.log(read_set1.match_prob), np.log(read_set1.mismatch_prob),
            np.log(read_set2.match_prob), np.log(read_set2.mismatch_prob),
            insert_mean, insert_std, dtype=dtype)

    buckets, walk_events, total_len = stage_paired_rows(
        graph, paths, read_set1, read_set2, row_align=nr)

    n_pad = ((n + nr - 1) // nr) * nr
    from jax.sharding import NamedSharding, PartitionSpec as P

    shard = NamedSharding(mesh, P("reads"))
    import jax

    read_probs = None
    ev_by_walk: Dict[int, List[Tuple[int, int]]] = {}
    ev_parts: List[np.ndarray] = []  # (walk, pos) pairs, deduped at the end
    for b in buckets:
        local, flags_dev = scorer.bucket_products(
            b, n_pad, min_prob_per_base, min_prob_start)
        read_probs = local if read_probs is None else read_probs + local
        if flags_dev is not None:
            flags = np.asarray(flags_dev)
            walks = b["walk"]
            bits = (1, 4) if not use_all_to_cov else (1, 2, 4, 8)
            mates = {1: "pos1", 2: "pos1", 4: "pos2", 8: "pos2"}
            for bit in bits:
                rows, cols = np.nonzero(flags & bit)
                if len(rows):
                    ev_parts.append(np.stack(
                        [walks[rows], b[mates[bit]][rows, cols]], axis=1))
    if ev_parts:
        uniq = np.unique(np.concatenate(ev_parts), axis=0)
        w_arr, p_arr = uniq[:, 0], uniq[:, 1]
        cuts = np.nonzero(np.diff(w_arr))[0] + 1
        for w_grp, p_grp in zip(np.split(w_arr, cuts), np.split(p_arr, cuts)):
            ev_by_walk[int(w_grp[0])] = [(int(p), 3) for p in p_grp.tolist()]

    if read_probs is None:
        read_probs = jax.device_put(
            jnp.zeros(n_pad, dtype=scorer.dtype), shard)

    lens_pair = _pair_lens(read_set1, read_set2)
    lens_buf = np.zeros(n_pad)
    lens_buf[:n] = lens_pair
    mask_buf = np.zeros(n_pad, dtype=bool)
    mask_buf[:n] = True
    score, zero_reads = scorer.reduce(
        read_probs, jax.device_put(jnp.asarray(lens_buf, dtype=scorer.dtype),
                                   shard),
        jax.device_put(jnp.asarray(mask_buf), shard),
        n_pad, n, total_len, min_prob_per_base, min_prob_start)

    bad_bases = 0
    for w, events in enumerate(walk_events):
        ev = events + ev_by_walk.get(w, [])
        bad_bases += _coverage_sweep(ev, insert_mean, insert_std,
                                     exp_cov_move)
    return score - bad_bases * no_cov_penalty, zero_reads, total_len


def _flag_event_positions(bucket, flags: np.ndarray,
                          use_all_to_cov: bool) -> np.ndarray:
    """Qualifying-pair event positions from one bucket's per-position flag
    bits (deduplicated; the sweep treats duplicate positions as gap-0
    no-ops).  Bits: 0 = pos1 is a qualifying pair's max, 1 = its min,
    2 = pos2 max, 3 = pos2 min (incremental semantics graph.cc:1885-1890)."""
    bits = (1, 4) if not use_all_to_cov else (1, 2, 4, 8)
    mates = {1: "pos1", 2: "pos1", 4: "pos2", 8: "pos2"}
    parts = []
    for bit in bits:
        rows, cols = np.nonzero(flags & bit)
        if len(rows):
            parts.append(bucket[mates[bit]][rows, cols])
    if not parts:
        return np.zeros(0, np.int32)
    return np.unique(np.concatenate(parts))


def calc_score_for_paths_incremental_sharded(
        graph, paths, read_set1, read_set2, insert_mean: float,
        insert_std: float, scoring_state, mesh, no_cov_penalty: float = 0.0,
        exp_cov_move: float = 0.75, use_all_to_cov: bool = False,
        min_prob_per_base: float = -0.7, min_prob_start: float = -10.0,
        scorer: Optional[ShardedPairedScorer] = None, dtype=None, keys=None):
    """Mesh-backed *incremental* paired rescore.

    Reference CalcScoreForPathsNew semantics (graph.cc:1952-1989): the walk
    multiset is diffed on host (GetChanges, graph.cc:1745-1764), but the
    changed walks' pair products are computed ON THE MESH and their signed
    per-read deltas psum_scatter'd straight into the device-resident
    running totals (DeviceScoringState.probs) — no full restage, no host
    delta computation.  Per-move cost is O(changed walks), independent of
    the total walk count.

    Determinism contract: each changed walk is staged ALONE (its bucket
    decomposition depends only on its own rows), so an added walk's later
    erase replays bit-identical bucket sums with the opposite sign — the
    same cancellation class as the reference's sequential
    ``probs[read] += p`` / ``-= p``.

    Returns (score, zero_reads, total_len); matches the host incremental
    scorer to float-reassociation accuracy (1e-9 pinned on x64 CPU
    meshes in tests/test_paired_sharded.py)."""
    from ..scoring.paired import _coverage_sweep, _pair_lens, _state_derived
    from .device_state import DeviceScoringState

    assert read_set1.get_number_of_reads() == read_set2.get_number_of_reads()
    n = read_set1.get_number_of_reads()
    nr = mesh.shape["reads"]
    state = scoring_state
    if scorer is None:
        scorer = ShardedPairedScorer(
            mesh, np.log(read_set1.match_prob),
            np.log(read_set1.mismatch_prob), np.log(read_set2.match_prob),
            np.log(read_set2.mismatch_prob), insert_mean, insert_std,
            dtype=dtype, collect_events=no_cov_penalty != 0.0)
    device = getattr(state, "device", None)
    if device is None:
        device = DeviceScoringState(mesh, n, _pair_lens(read_set1, read_set2),
                                    dtype=scorer.dtype)
        if len(state.probs):
            device.from_host(state.probs)
        state.device = device

    new_tuples = keys if keys is not None else \
        [p if type(p) is tuple else tuple(p) for p in paths]
    counter, old_total = _state_derived(state, graph)
    remaining = counter.copy()
    added: List[tuple] = []
    get = remaining.get
    for key in new_tuples:
        c = get(key, 0)
        if c > 0:
            remaining[key] = c - 1
        else:
            added.append(key)
    erased = [key for key, cnt in remaining.items() for _ in range(cnt)]

    total = old_total
    if added or erased:
        lens_np = graph.lens_np()

        def plen(t):
            a = np.asarray(t, dtype=np.int64)
            return int(np.where(a >= 0, lens_np[np.maximum(a, 0)],
                                -a).sum()) if len(a) else 0

        for p in added:
            total += plen(p)
        for p in erased:
            total -= plen(p)

    # one batched miss-fill for the whole new walk set (erased walks'
    # windows are already cached: they were precomputed when added)
    read_set1.precompute_alignment_for_paths(paths, graph, keys=new_tuples)
    read_set2.precompute_alignment_for_paths(paths, graph, keys=new_tuples)

    for group, sign in ((erased, -1.0), (added, +1.0)):
        for walk in group:
            buckets, walk_events, _wl = stage_paired_rows(
                graph, [list(walk)], read_set1, read_set2, row_align=nr)
            # dispatch every bucket's fused delta first (async), then
            # fetch ALL event-flag arrays in one blocking call (a
            # per-bucket fetch would serialize the move on round trips)
            flag_handles = []
            for b in buckets:
                device.probs, flags_dev = scorer.bucket_apply(
                    device.probs, sign, b, device.n_pad,
                    min_prob_per_base, min_prob_start)
                if flags_dev is not None:
                    flag_handles.append((b, flags_dev))
            if scorer.collect_events:
                import jax

                fetched = jax.device_get([f for _b, f in flag_handles])
                ev_pos: List[np.ndarray] = [
                    _flag_event_positions(b, np.asarray(fl),
                                          use_all_to_cov)
                    for (b, _h), fl in zip(flag_handles, fetched)]
                ev = list(walk_events[0])
                if ev_pos:
                    for p in np.unique(np.concatenate(ev_pos)).tolist():
                        ev.append((int(p), 3))
                state.bad_bases += int(sign) * _coverage_sweep(
                    ev, insert_mean, insert_std, exp_cov_move)

    score, zero_reads = device.reduce(total, min_prob_per_base,
                                      min_prob_start)

    for key in added:
        counter[key] += 1
    for key in erased:
        c = counter[key] - 1
        if c:
            counter[key] = c
        else:
            del counter[key]
    state.old_paths = new_tuples
    state._counter = counter
    state._total_len = total
    state._derived_tag = state.old_paths
    return score - state.bad_bases * no_cov_penalty, zero_reads, total
