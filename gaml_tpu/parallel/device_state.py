"""Device-resident incremental scoring state.

The host incremental scorer (scoring/paired.py, reference ScoringState
graph.h:612-619) keeps per-read running pair probabilities in a numpy
array and reduces them on every move.  For very large read sets that
per-iteration O(n_reads) host pass and the host<->device traffic dominate;
this module keeps the running totals *on the device mesh*, sharded over
the "reads" axis:

- ``apply``: scatter-add a (read_id, delta) chunk — the add/erase output
  of the incremental scorer — into the sharded totals.  Each shard applies
  only the deltas that land in its slice; chunks are padded to power-of-two
  buckets so XLA compiles a handful of shapes.
- ``reduce``: the floored mean-log reduction (reference GetTotalProb,
  graph.cc:1495-1516) evaluated shard-locally and merged with psum,
  returning replicated (score, zero_reads) scalars.

float64 by default (bit-comparable with the host scorer); float32 opt-in for
throughput when the caller accepts the precision trade.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _bucket(n: int, lo: int = 256) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class DeviceScoringState:
    """Sharded per-read running totals + floored-log reduction."""

    def __init__(self, mesh: Mesh, n_reads: int, read_lens: np.ndarray,
                 dtype=jnp.float64):
        if "reads" not in mesh.axis_names:
            raise ValueError("mesh must have a 'reads' axis")
        self.mesh = mesh
        self.n_reads = n_reads
        self.dtype = dtype
        nr = mesh.shape["reads"]
        rest = [a for a in mesh.axis_names if a != "reads"]
        self._nr = nr
        self.n_pad = ((n_reads + nr - 1) // nr) * nr
        self.shard = NamedSharding(mesh, P("reads"))
        self.repl = NamedSharding(mesh, P())
        probs = np.zeros(self.n_pad, dtype=np.float64)
        self.probs = jax.device_put(jnp.asarray(probs, dtype=dtype),
                                    self.shard)
        lens = np.zeros(self.n_pad, dtype=np.float64)
        lens[:n_reads] = np.asarray(read_lens, dtype=np.float64)
        self.lens = jax.device_put(jnp.asarray(lens, dtype=dtype), self.shard)
        mask = np.zeros(self.n_pad, dtype=bool)
        mask[:n_reads] = True
        self.mask = jax.device_put(jnp.asarray(mask), self.shard)
        self._apply_fns = {}
        self._reduce_fn = None
        self._rest_axes = tuple(rest)

    # ------------------------------------------------------------- apply
    def _make_apply(self):
        n_local = self.n_pad // self._nr

        def shard_apply(probs, rids, deltas):
            # probs: [n_local] (this shard); rids/deltas replicated.
            idx = jax.lax.axis_index("reads")
            lo = idx * n_local
            local = rids - lo
            ok = (local >= 0) & (local < n_local) & (rids >= 0)
            local = jnp.where(ok, local, 0)
            deltas = jnp.where(ok, deltas, 0.0)
            return probs.at[local].add(deltas, mode="drop")

        return jax.jit(jax.shard_map(
            shard_apply, mesh=self.mesh,
            in_specs=(P("reads"), P(), P()), out_specs=P("reads"),
            check_vma=False))

    def apply(self, rid_arr: np.ndarray, p_arr: np.ndarray,
              sign: int = 1) -> None:
        """Scatter-add one delta chunk (rids may repeat; adds accumulate)."""
        n = len(rid_arr)
        if n == 0:
            return
        cap = _bucket(n)
        rids = np.full(cap, -1, dtype=np.int32)
        rids[:n] = rid_arr
        deltas = np.zeros(cap, dtype=np.float64)
        deltas[:n] = p_arr if sign > 0 else -np.asarray(p_arr)
        fn = self._apply_fns.get(cap)
        if fn is None:
            fn = self._apply_fns[cap] = self._make_apply()
        self.probs = fn(self.probs,
                        jax.device_put(jnp.asarray(rids), self.repl),
                        jax.device_put(jnp.asarray(deltas, dtype=self.dtype),
                                       self.repl))

    # ------------------------------------------------------------ reduce
    def _make_reduce(self):
        n_reads = self.n_reads

        def shard_reduce(probs, lens, mask, total_len, mppb, mps):
            tl = jnp.maximum(total_len, 1).astype(probs.dtype)
            p = probs / (2.0 * tl)
            thresholds = jnp.exp(mps + mppb * lens)
            floored = (p < thresholds) & mask
            zero_local = jnp.sum(floored.astype(jnp.int32))
            p = jnp.where(p < thresholds, thresholds, p)
            log_local = jnp.sum(jnp.where(mask, jnp.log(p), 0.0))
            # non-"reads" mesh axes hold replicas: no merge needed there
            log_total = jax.lax.psum(log_local, "reads")
            zero_total = jax.lax.psum(zero_local, "reads")
            return log_total / n_reads, zero_total

        return jax.jit(jax.shard_map(
            shard_reduce, mesh=self.mesh,
            in_specs=(P("reads"), P("reads"), P("reads"), P(), P(), P()),
            out_specs=(P(), P()), check_vma=False))

    def reduce(self, total_len: int, min_prob_per_base: float,
               min_prob_start: float):
        """(score, zero_reads) — reference GetTotalProb semantics."""
        if self._reduce_fn is None:
            self._reduce_fn = self._make_reduce()
        s, z = self._reduce_fn(
            self.probs, self.lens, self.mask,
            jnp.asarray(float(total_len), dtype=self.dtype),
            jnp.asarray(min_prob_per_base, dtype=self.dtype),
            jnp.asarray(min_prob_start, dtype=self.dtype))
        return float(s), int(z)

    # -------------------------------------------------------- host sync
    def to_host(self) -> np.ndarray:
        """Gather the running totals (e.g. for checkpointing)."""
        return np.asarray(self.probs)[:self.n_reads].astype(np.float64)

    def from_host(self, probs: np.ndarray) -> None:
        buf = np.zeros(self.n_pad, dtype=np.float64)
        buf[:self.n_reads] = probs
        self.probs = jax.device_put(jnp.asarray(buf, dtype=self.dtype),
                                    self.shard)
