#!/usr/bin/env python3
"""Smoke test of gaml-tpu's device route on an NVIDIA GPU.

    python chip_smoke.py               # one card: all phases below
    python chip_smoke.py --four-cards  # four cards: the mesh path only

One process drives the card (a JAX process reserves most of its memory).
Phases, each printed on its own lines and each fatal on failure:

1. device check: a CUDA GPU (platform, kind, count), the card's name and
   power limit from nvidia-smi, and the native host library;
2. compile-only: the Pallas extension kernel at the rescore's width,
   with its memory analysis;
3. kernel parity and timing: the kernel against the jnp DP (bit-equal on
   every consumed value), the native min-cost window aligner (bit-equal
   alignments) and the native 0-1 BFS oracle, on the real candidates of
   the bench world (400 kb genome, 100k x 100 bp reads);
4. fused rescore on the bench world, both DP routes: candidate count and
   zero reads exact against the native serial aligner, the score within
   1e-5 relative;
5. long-read forward DP at the long-read deployment's shape (1 Mb genome,
   3 kb reads at 10% error, 256-job chunks) against the native f64
   kernel, and its rate in DP cells/s;
6. the main path: the CLI on a reference-shaped paired deployment (2.8 Mb
   genome, 150k fragment pairs at 180+-20, 30k jump pairs at 3700+-350
   as advice), once with every alignment batch on the device and once
   with every batch on the native aligner; the itnum traces (time field
   stripped) must be identical and the device must serve every batch of
   the device run (none on the host, none after a cap overflow).

--four-cards runs the same deployment with --paired-device-inc
--device-state on a 4-device ("reads", "cand") mesh (float64) and
compares its per-iteration likelihoods with the single-card host scorer.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# the bench world (bench.py) and the DP shapes it produces
BENCH_GENOME, BENCH_READS, READ_LEN = 400_000, 100_000, 100
LOG_M, LOG_MM = float(np.log(0.96)), float(np.log(0.01))
MPB, MPS = -0.7, -10.0
SCORE_RTOL = 1e-5      # float32 device sums vs the float64 host reference
FORWARD_RTOL = 1e-4    # float32 forward DP vs the f64 native kernel
MESH_ATOL = 1.5e-6     # float64 mesh vs host: the trace prints 6 decimals


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    """nvidia-smi's name and power limit for each card (a child process
    that stays off JAX)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def timed(fn, reps: int = 10) -> float:
    """Median wall seconds of fn() to completion (one warm-up call)."""
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


# ------------------------------------------------------------------ phase 1
def phase_device(n_cards: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no CUDA GPU (JAX platform "
                         f"{devs[0].platform!r})")
    if len(devs) != n_cards:
        raise SystemExit(f"chip_smoke: needs exactly {n_cards} GPU(s), "
                         f"JAX sees {len(devs)}")
    log(f"[1 device] platform={devs[0].platform} "
        f"kind={devs[0].device_kind} count={len(devs)}")
    log(f"[1 device] nvidia-smi: {card_info()}")
    sys.path.insert(0, REPO)
    import gaml_tpu.native as native
    from gaml_tpu.utils.device import enable_compile_cache

    log(f"[1 device] compile cache: {enable_compile_cache()} "
        f"(JAX_COMPILATION_CACHE_DIR="
        f"{os.environ.get('JAX_COMPILATION_CACHE_DIR')!r})")
    lib = native.get_lib()
    if lib is None:
        raise RuntimeError(f"native library not loaded: {native.load_error}")
    log(f"[1 device] native library: {lib._name}")
    return devs


# ------------------------------------------------------------------ phase 2
def phase_compile(n: int, rmax: int):
    import functools

    import jax
    import jax.numpy as jnp

    from gaml_tpu.ops.extend import PAD
    from gaml_tpu.ops.extend_pallas import dp_kernel

    shapes = (jax.ShapeDtypeStruct((n, rmax), jnp.int32),
              jax.ShapeDtypeStruct((n,), jnp.int32),
              jax.ShapeDtypeStruct((n, rmax + 2 * PAD), jnp.int32),
              jax.ShapeDtypeStruct((n,), jnp.int32))
    for accept in (False, True):
        t0 = time.perf_counter()
        compiled = jax.jit(functools.partial(
            dp_kernel, rmax=rmax, accept=accept)).lower(*shapes).compile()
        log(f"[2 compile] dp_kernel n={n} rmax={rmax} accept={accept} "
            f"compile={time.perf_counter() - t0:.2f}s "
            f"memory_analysis={compiled.memory_analysis()}")


# ------------------------------------------------------------------ phase 3
def bench_world(genome_len=BENCH_GENOME, n_reads=BENCH_READS):
    from bench import build_bundle, build_world

    genome, reads = build_world(genome_len, n_reads, READ_LEN)
    return genome, reads, build_bundle(reads)


def phase_kernel(genome, bundle, interpret=False, reps=10):
    """Kernel vs jnp DP (bit-equal on consumed values) vs the native
    0-1 BFS oracle, on the world's real candidates in the production
    (r0-sorted) order."""
    import jax.numpy as jnp

    from gaml_tpu.native import (align_window, process_hit_batch,
                                 query_windows_batch)
    from gaml_tpu.ops.extend import (_finish, extend_kernel,
                                     stage_candidates_uniform)

    (rid, g0, r0, orient), = query_windows_batch(bundle, [genome])
    order = np.argsort(r0, kind="stable")
    rid, g0, r0, orient = (x[order] for x in (rid, g0, r0, orient))
    n = len(rid)
    rows = bundle.row_of[rid]
    st = stage_candidates_uniform(
        genome, np.zeros(1, np.int64), np.array([len(genome)]),
        np.zeros(n, np.int64), g0, r0, rows, orient, bundle.codes_fwd,
        bundle.codes_rc, read_ids=rid)
    args = [jnp.asarray(st[k]) for k in (
        "read_f", "rlen_f", "gwin_f", "glen_f", "read_b", "rlen_b",
        "gwin_b", "glen_b")]

    def run(kernel):
        return extend_kernel(*args, rmax=st["rmax"], use_kernel=kernel,
                             interpret=interpret)

    ok_k, errs_k, d_k = (np.asarray(x)[:n] for x in run(True))
    ok_j, errs_j, d_j = (np.asarray(x)[:n] for x in run(False))
    if not (np.array_equal(ok_k, ok_j)
            and np.array_equal(errs_k[ok_k], errs_j[ok_j])
            and np.array_equal(d_k[ok_k], d_j[ok_j])):
        raise AssertionError("kernel != jnp DP on consumed values")
    t_k, t_j = timed(lambda: run(True), reps), timed(lambda: run(False),
                                                     reps)
    log(f"[3 kernel] candidates={n} rmax={st['rmax']} ok={int(ok_k.sum())} "
        f"kernel == jnp DP on ok/errs/begin: yes")
    log(f"[3 kernel] DP alone, both directions: pallas={t_k * 1e3:.3f} ms "
        f"xla_dp_rows={t_j * 1e3:.3f} ms (median of {reps})")

    codes = np.where((orient == 1)[:, None], bundle.codes_rc[rows],
                     bundle.codes_fwd[rows])
    res = process_hit_batch(genome, [(int(g0[i]), int(r0[i]), codes[i])
                                     for i in range(n)])
    ok_o = np.array([r is not None for r in res])
    errs_o = np.array([r[0] if r else -1 for r in res])
    begin_o = np.array([r[1] if r else -1 for r in res])
    ok_f, errs_f, begin_f = _finish(ok_k, errs_k, d_k, g0, r0, n)
    both = ok_f & ok_o
    same = both & (errs_f == errs_o) & (begin_f == begin_o)
    # the device DP computes the true min cost over the BFS's alignment
    # graph (tests/test_extend_kernel.py): it accepts every candidate the
    # BFS accepts, with errs <= the BFS's
    if (ok_o & ~ok_f).any() or (errs_f[both] > errs_o[both]).any():
        raise AssertionError("kernel rejects or over-costs a BFS alignment")
    n_fewer = int((both & (errs_f < errs_o)).sum())
    log(f"[3 kernel] vs native 0-1 BFS oracle: ok equal on "
        f"{int((ok_f == ok_o).sum())}/{n}, errs+begin equal on "
        f"{int(same.sum())}/{int(ok_o.sum())} BFS-accepted; {n_fewer} with "
        f"fewer errors than the BFS (min-cost by design)")
    # float64 host reduction of the kernel's alignments in emission order
    # (first-wins (begin, read) dedup): the rescore's exact reference
    emit = np.empty(n, np.int64)
    emit[order] = np.arange(n)
    ok_e, errs_e, begin_e, rid_e = (x[emit] for x in (ok_f, errs_f, begin_f,
                                                     rid))
    keys = set()
    keep = np.zeros(n, bool)
    for i in np.nonzero(ok_e)[0]:
        k = (int(rid_e[i]), int(begin_e[i]))
        if k not in keys:
            keys.add(k)
            keep[i] = True
    # the same alignments as the aligner emits them, sorted by (pos, rid),
    # against the native min-cost window aligner: bit-for-bit
    pos_k = begin_e[keep] + 1
    by_pos = np.lexsort((rid_e[keep], pos_k))
    kern = [x[by_pos] for x in (pos_k, errs_e[keep], rid_e[keep],
                                orient[emit][keep])]
    nat = align_window(bundle, genome, 0, min_cost=True)
    if not all(np.array_equal(k, m) for k, m in zip(kern, nat)):
        raise AssertionError("kernel alignments != native min-cost DP")
    log(f"[3 kernel] vs native min-cost DP (align_window min_cost=True): "
        f"{len(nat[0])} alignments, pos/errs/rid/orient bit-equal")
    return t_k, t_j, reduce_f64(errs_e[keep], rid_e[keep],
                                len(bundle.row_of), len(genome))


# ------------------------------------------------------------------ phase 4
def reduce_f64(errs, rid, n_reads, total_len):
    """GetTotalProb (graph.cc:1518-1537) in float64 on the host:
    (score, zero_reads) of deduplicated alignments."""
    p = np.exp(errs * LOG_MM + (READ_LEN - errs) * LOG_M)
    probs = np.bincount(rid, p, minlength=n_reads) / (2.0 * total_len)
    thr = np.exp(MPS + MPB * READ_LEN)
    floored = probs < thr
    return (float(np.mean(np.log(np.where(floored, thr, probs)))),
            int(floored.sum()))


def phase_rescore(genome, bundle, n_reads, ref_min_cost, interpret=False,
                  iters=10, reps=5):
    """The fused rescore on both DP routes against the native serial
    aligner (candidate count and zero reads exact) and against the f64
    host reduction of the same min-cost alignments (score within
    SCORE_RTOL: float32 sums in another order)."""
    import jax.numpy as jnp

    from gaml_tpu.native import align_window, query_windows_batch
    from gaml_tpu.ops.rescore_device import DeviceRescorer

    _pos, ed, rid, _orient = align_window(bundle, genome, 0)
    s_bfs, z_ref = reduce_f64(ed, rid, n_reads, len(genome))
    (q_rid, *_rest), = query_windows_batch(bundle, [genome])
    n_ref = len(q_rid)
    s_ref, z_min = ref_min_cost
    if z_min != z_ref:
        raise AssertionError(f"zero reads: min-cost {z_min} vs BFS {z_ref}")
    cap = -(-int(n_ref * 1.15) // 4096) * 4096
    dev = DeviceRescorer(bundle)
    kw = dict(cap=cap, log_match=LOG_M, log_mismatch=LOG_MM,
              total_len=len(genome), min_prob_per_base=MPB,
              min_prob_start=MPS, interpret=interpret)
    times = {}
    for name, kernel in (("pallas", True), ("xla_dp_rows", False)):
        s, z, nt = dev.rescore([genome], use_pallas=kernel, **kw)
        s, z, nt = float(s), int(z), int(nt)
        if nt != n_ref or z != z_ref:
            raise AssertionError(f"{name}: candidates {nt} vs {n_ref}, "
                                 f"zero reads {z} vs {z_ref}")
        rel = abs(s - s_ref) / abs(s_ref)
        if rel > SCORE_RTOL:
            raise AssertionError(f"{name}: score {s} vs {s_ref}")

        def window():
            stages = [dev.stage([genome]) for _ in range(iters)]
            return jnp.stack([dev.rescore(staged=x, use_pallas=kernel,
                                          **kw)[0] for x in stages])

        times[name] = timed(window, reps) / iters
        log(f"[4 rescore] {name}: candidates={nt} (native {n_ref}) "
            f"zero_reads={z} (native {z_ref}) score={s:.7f} "
            f"(f64 host {s_ref:.7f}, rel {rel:.1e} <= {SCORE_RTOL}; "
            f"native BFS {s_bfs:.7f}) "
            f"pipelined={times[name] * 1e3:.3f} ms/rescore "
            f"= {n_reads / times[name]:.0f} reads/s")
    return times


# ------------------------------------------------------------------ phase 5
def long_read_jobs(rng, genome, n_jobs, read_len, err=0.1):
    """Noisy reads (40% substitutions, 30% insertions, 30% deletions of
    the error budget, as examples/pacbio_run.py) with their true genome
    path as the guide centers."""
    jobs = []
    for _ in range(n_jobs):
        g = int(rng.integers(0, len(genome) - 2 * read_len))
        read, centers = [], [g]
        while len(read) < read_len:
            u = rng.random()
            if u < err * 0.4:
                read.append(int(rng.integers(0, 4)))
                g += 1
            elif u < err * 0.7:
                read.append(int(rng.integers(0, 4)))
            elif u < err:
                g += 1
                continue
            else:
                read.append(int(genome[g]))
                g += 1
            centers.append(g)
        jobs.append((np.array(read, np.uint8), np.array(centers, np.int32)))
    return jobs


def phase_forward(genome_len=1_000_000, n_jobs=512, read_len=3000,
                  device_route=True, reps=3):
    import jax.numpy as jnp

    from gaml_tpu.native import banded_forward_host
    from gaml_tpu.ops.forward import banded_forward
    from gaml_tpu.scoring.pacbio import PacbioReadSet

    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    jobs = long_read_jobs(rng, genome, n_jobs, read_len)
    rs = PacbioReadSet("chip_smoke_pb", "", 0.85, 0.05)
    rs.read_seq = [r for r, _ in jobs]
    if rs._device_route() != device_route:
        raise AssertionError("forward DP is not on the device route")
    lm, lmm = float(np.log(rs.match_prob)), float(np.log(rs.mismatch_prob))
    width = rs.forward_width

    t0 = time.perf_counter()
    got = np.array(rs._forward_batch(genome, jobs, force_device=True))
    t_first = time.perf_counter() - t0
    if device_route and not rs.dp_cells.get("device"):
        raise AssertionError(f"forward DP not served by the device: "
                             f"{rs.dp_cells}")
    rmax = -(-read_len // 128) * 128
    reads = np.full((n_jobs, rmax), 6, np.uint8)
    centers = np.zeros((n_jobs, rmax + 1), np.int32)
    rlens = np.zeros(n_jobs, np.int32)
    for i, (r, c) in enumerate(jobs):
        reads[i, :len(r)], rlens[i] = r, len(r)
        centers[i, :len(c)], centers[i, len(c):] = c, c[-1]
    ref = banded_forward_host(genome, reads, rlens, centers,
                              np.zeros(n_jobs, np.int32),
                              np.full(n_jobs, genome_len, np.int32),
                              lm, lmm, width)
    rel = np.abs(got - ref) / np.abs(ref)
    if not np.all(np.isfinite(got)) or rel.max() > FORWARD_RTOL:
        raise AssertionError(f"forward DP rel err {rel.max():.2e}")
    cells = int(rlens.sum()) * width
    t_route = timed(lambda: rs._forward_batch(genome, jobs,
                                              force_device=True), reps)
    chunk = rs._chunk()
    g_dev = jnp.asarray(np.concatenate([genome, np.full(
        rs.seq_bucket(genome_len) - genome_len, 9, np.uint8)]))
    c_args = [jnp.asarray(x[:chunk]) for x in (
        reads, rlens, centers, np.zeros(n_jobs, np.int32),
        np.full(n_jobs, genome_len, np.int32))]
    t_dp = timed(lambda: banded_forward(g_dev, *c_args, lm, lmm, rmax,
                                        width), reps)
    chunk_cells = int(rlens[:chunk].sum()) * width
    log(f"[5 forward] jobs={n_jobs} read_len={read_len} width={width} "
        f"chunk={chunk} max rel err vs native f64 {rel.max():.2e} "
        f"(<= {FORWARD_RTOL}); first batch (compile) {t_first:.1f}s")
    log(f"[5 forward] route: {cells / t_route:.4g} cells/s "
        f"({t_route * 1e3:.1f} ms per {n_jobs} jobs); DP alone: "
        f"{chunk_cells / t_dp:.4g} cells/s ({t_dp * 1e3:.2f} ms/chunk)")
    return cells / t_route, chunk_cells / t_dp


# ------------------------------------------------------------------ phase 6
def write_deployment(out_dir, genome_mb=2.8, n_frag=150_000, n_adv=30_000,
                     seed=13):
    """The reference example.cfg's shape (examples/aureus_like_run.py):
    a fragmented 2.8 Mb graph as LastGraph, a 180+-20 fragment library and
    a 3700+-350 jump library (advice), 100 bp reads, as FASTQ."""
    from gaml_tpu.core import dna

    rng = np.random.default_rng(seed)
    genome_len = int(genome_mb * 1_000_000)
    lut = np.frombuffer(b"ACGTN", np.uint8)
    chain, nodes, arcs = [], [], []
    remaining = genome_len
    while remaining > 0:
        ln = int(rng.integers(1200, 6000)) if len(chain) % 2 == 0 \
            else int(rng.integers(60, 300))
        ln = min(ln, remaining)
        chain.append(rng.integers(0, 4, ln).astype(np.uint8))
        nodes.append(chain[-1])
        if len(nodes) > 1:
            arcs.append((len(nodes) - 1, len(nodes)))
        remaining -= ln
    n_chain = len(nodes)
    for _ in range(n_chain // 4):  # dead-end side branches
        src = int(rng.integers(1, n_chain))
        nodes.append(rng.integers(0, 4, 90).astype(np.uint8))
        arcs.append((src, len(nodes)))
    genome = np.concatenate(chain)
    lines = [f"{len(nodes)}\t0\t0\t1"]
    for i, s in enumerate(nodes):
        lines += [f"NODE\t{i + 1}", lut[s].tobytes().decode(),
                  lut[dna.revcomp(s)].tobytes().decode()]
    lines += [f"ARC\t{a}\t{b}" for a, b in arcs]
    with open(os.path.join(out_dir, "LastGraph"), "w") as f:
        f.write("\n".join(lines) + "\n")

    comp = np.array([3, 2, 1, 0, 4], np.uint8)

    def pairs(name, n, mean, std, err=0.005):
        ins = np.clip(rng.normal(mean, std, n).astype(np.int64),
                      2 * READ_LEN, genome_len - 1)
        p = rng.integers(0, genome_len - ins)
        idx = np.arange(READ_LEN)
        m1 = genome[p[:, None] + idx[None, :]]
        m2 = comp[genome[(p + ins - READ_LEN)[:, None] + idx[None, :]]
                  ][:, ::-1]
        for k, m in ((1, m1), (2, m2)):
            e = rng.random(m.shape) < err
            m[e] = (m[e] + rng.integers(1, 4, int(e.sum()))) % 4
            text = lut[m]
            qual = "I" * READ_LEN
            with open(os.path.join(out_dir, f"{name}_{k}.fq"), "w") as f:
                f.write("".join(
                    f"@{name}{i}/{k}\n{text[i].tobytes().decode()}\n+\n"
                    f"{qual}\n" for i in range(n)))

    pairs("frag", n_frag, 180, 20)
    pairs("jump", n_adv, 3700, 350)


def write_config(out_dir, tag, iters):
    path = os.path.join(out_dir, f"{tag}.cfg")
    with open(path, "w") as f:
        f.write(f"""graph={out_dir}/LastGraph
t0=0.02
max_iterations={iters}
seed=47
output_prefix={out_dir}/out_{tag}

[frag]
cache_prefix={out_dir}/{tag}_frag
type=paired
filename1={out_dir}/frag_1.fq
filename2={out_dir}/frag_2.fq
insert_mean=180
insert_std=20
penalty_step=30
penalty_constant=0.00007

[jump]
cache_prefix={out_dir}/{tag}_jump
type=paired
filename1={out_dir}/jump_1.fq
filename2={out_dir}/jump_2.fq
insert_mean=3700
insert_std=350
penalty_step=3000
penalty_constant=0.00013
advice=true
""")
    return path


def run_cli(cfg, args, env):
    """gaml_tpu.cli.main in this process; returns (itnum lines, seconds,
    full log)."""
    from gaml_tpu.cli import main

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main([cfg] + args)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli {args} exited {rc}:\n{buf.getvalue()}")
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("itnum")]
    return lines, dt, buf.getvalue()


def strip_time(lines):
    """itnum N temp T time HH:MM:SS ...: drop the time field."""
    out = []
    for ln in lines:
        f = ln.split()
        out.append(" ".join(f[:5] + f[6:]))
    return out


class BatchCounter:
    """Counts alignment batches by what served them
    (tests/test_device_candgen.py's spying, at class level): ``device``,
    ``native`` (the router sent the batch to the host), and ``overflow``
    (the device candidate generator overflowed its cap and the aligner
    redid the batch on the host)."""

    def __init__(self):
        from gaml_tpu.ops.extend_device import DeviceExtender
        from gaml_tpu.ops.rescore_device import DeviceRescorer
        from gaml_tpu.scoring.readset import ReadSet

        self.counts = {"device": 0, "native": 0, "overflow": 0}
        self._patches = [(DeviceRescorer, "extend", self._count_fetch),
                         (DeviceExtender, "run", self._count("device")),
                         (ReadSet, "_precompute_native_batch",
                          self._count("native"))]

    def _count(self, kind):
        def wrap(real):
            def spy(*a, **kw):
                self.counts[kind] += 1
                return real(*a, **kw)
            return spy
        return wrap

    def _count_fetch(self, real):
        """DeviceRescorer.extend returns fetch(); its None result is a cap
        overflow, which the aligner serves natively."""
        def spy(*a, **kw):
            fetch = real(*a, **kw)

            def counted():
                res, n = fetch()
                self.counts["device" if res is not None else "overflow"] += 1
                return res, n
            return counted
        return spy

    def __enter__(self):
        self._saved = []
        for cls, name, wrap in self._patches:
            real = getattr(cls, name)
            self._saved.append((cls, name, real))
            setattr(cls, name, wrap(real))
        return self

    def __exit__(self, *exc):
        for cls, name, real in self._saved:
            setattr(cls, name, real)


def phase_main_path(out_dir, iters, scale=1.0):
    n_frag, n_adv = int(150_000 * scale), int(30_000 * scale)
    t0 = time.perf_counter()
    write_deployment(out_dir, genome_mb=2.8 * scale, n_frag=n_frag,
                     n_adv=n_adv)
    log(f"[6 main] deployment {2.8 * scale:.2f} Mb, {n_frag} frag + "
        f"{n_adv} jump pairs written in {time.perf_counter() - t0:.1f}s")
    eager = {"GAML_DEV_EAGER": "1"}
    with BatchCounter() as cnt:
        dev_lines, t_dev, _ = run_cli(
            write_config(out_dir, "device", iters), ["--backend", "device"],
            dict(eager, GAML_DEV_MIN_BASES="0"))
    dev_counts = dict(cnt.counts)
    with BatchCounter() as cnt:
        nat_lines, t_nat, _ = run_cli(
            write_config(out_dir, "native", iters), ["--backend", "device"],
            dict(eager, GAML_DEV_MIN_BASES=str(10 ** 15)))
    nat_counts = dict(cnt.counts)
    log(f"[6 main] device route: {len(dev_lines)} itnum lines in "
        f"{t_dev:.1f}s, batches {dev_counts}")
    log(f"[6 main] native route: {len(nat_lines)} itnum lines in "
        f"{t_nat:.1f}s, batches {nat_counts}")
    if len(dev_lines) < iters:
        raise AssertionError(f"only {len(dev_lines)} iterations ran")
    a, b = strip_time(dev_lines), strip_time(nat_lines)
    if a != b:
        diff = next(i for i, (x, y) in enumerate(zip(a + [""], b + [""]))
                    if x != y)
        raise AssertionError(f"itnum traces differ at line {diff}:\n"
                             f"device: {a[diff:diff + 1]}\n"
                             f"native: {b[diff:diff + 1]}")
    # GAML_DEV_MIN_BASES=0 with GAML_DEV_EAGER=1 routes every batch to the
    # device: any batch the host served (routed or after a cap overflow)
    # is a failure of the device route
    if dev_counts["device"] == 0 or dev_counts["native"] or \
            dev_counts["overflow"] or nat_counts["device"] or \
            nat_counts["overflow"]:
        raise AssertionError("the device did not serve every batch of the "
                             f"device run: {dev_counts} / {nat_counts}")
    log(f"[6 main] itnum traces identical ({len(a)} lines); last: {a[-1]}")


def phase_four_cards(out_dir, iters, scale=1.0):
    """The paired deployment on the 4-device mesh (device alignment,
    incremental pair products + device-resident per-read state, float64)
    vs the host scorer fed by the native aligner (bit-identical
    alignments)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    n_frag, n_adv = int(150_000 * scale), int(30_000 * scale)
    write_deployment(out_dir, genome_mb=2.8 * scale, n_frag=n_frag,
                     n_adv=n_adv)
    mesh_lines, t_mesh, _ = run_cli(
        write_config(out_dir, "mesh", iters),
        ["--backend", "device", "--paired-device-inc", "--device-state"],
        {"GAML_DEV_EAGER": "1", "GAML_DEV_MIN_BASES": "0"})
    peaks = []
    for d in jax.devices():
        stats = d.memory_stats() or {}  # None on the CPU backend
        peaks.append(stats.get("peak_bytes_in_use"))
        log(f"[4 cards] {d} bytes_in_use={stats.get('bytes_in_use')} "
            f"peak_bytes_in_use={peaks[-1]}")
    if any(p == 0 for p in peaks):
        raise AssertionError(f"a card held no data during the run: {peaks}")
    host_lines, t_host, _ = run_cli(
        write_config(out_dir, "host", iters), ["--backend", "device"],
        {"GAML_DEV_EAGER": "1", "GAML_DEV_MIN_BASES": str(10 ** 15)})
    log(f"[4 cards] mesh run {len(mesh_lines)} iterations in "
        f"{t_mesh:.1f}s; host run {len(host_lines)} in {t_host:.1f}s")
    if len(mesh_lines) < iters or len(mesh_lines) != len(host_lines):
        raise AssertionError("iteration counts differ")
    worst = 0.0
    for x, y in zip(mesh_lines, host_lines):
        # itnum N temp T time HH:MM:SS new prob NEW CUR BEST len L ...
        fx, fy = x.split(), y.split()
        if fx[:4] != fy[:4] or fx[11:] != fy[11:]:
            raise AssertionError(f"traces diverge:\n{x}\n{y}")
        for u, v in zip(fx[8:11], fy[8:11]):
            worst = max(worst, abs(float(u) - float(v)))
    if worst > MESH_ATOL:
        raise AssertionError(f"likelihoods differ by {worst:.2e}")
    log(f"[4 cards] per-iteration likelihoods agree: max abs diff "
        f"{worst:.2e} <= {MESH_ATOL}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU mesh path and its reference")
    ap.add_argument("--iters", type=int, default=40,
                    help="anneal iterations of the CLI runs")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1
    devs = phase_device(n_cards)
    with tempfile.TemporaryDirectory(prefix="gaml_smoke_") as out_dir:
        if args.four_cards:
            phase_four_cards(out_dir, args.iters)
        else:
            cap_width = 131072
            phase_compile(cap_width, 96)
            genome, _reads, bundle = bench_world()
            _tk, _tj, ref = phase_kernel(genome, bundle)
            phase_rescore(genome, bundle, BENCH_READS, ref)
            phase_forward()
            phase_main_path(out_dir, args.iters)
    log(f"[done] nvidia-smi: {card_info()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
