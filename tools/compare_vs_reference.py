"""Head-to-head benchmark: the real reference binary vs gaml-tpu on the
same dataset with the same annealing budget.

Their likelihoods are directly comparable (scorer parity is established by
tests/test_reference_differential.py).  Prints both sides' start/best
likelihood and wall time.

Pinned protocol: the dataset is a pure function
of the checked-in generator and seed 99; with runs > 1 the two binaries
alternate within one invocation (ref, ours, ref, ours, ...) so shared-box
drift hits both sides equally, and the summary reports per-run times,
medians, and min-max dispersion.

    python tools/compare_vs_reference.py [genome_kb] [n_pairs] [iters] \
        [out_dir] [runs]
"""
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

import numpy as np


def main():
    genome_kb = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    n_pairs = int(sys.argv[2]) if len(sys.argv) > 2 else 15000
    iters = int(sys.argv[3]) if len(sys.argv) > 3 else 1000
    out_dir = sys.argv[4] if len(sys.argv) > 4 else "/tmp/gaml_vs_ref"
    os.makedirs(out_dir, exist_ok=True)

    from fixtures import lastgraph_text, write_fastq
    from test_scoring import make_pairs

    rng = np.random.default_rng(99)
    # chain of long nodes with short connectors + branch noise
    node_seqs = []
    arcs = []
    chain_idx = []
    remaining = genome_kb * 1000
    while remaining > 0:
        ln = int(rng.integers(1500, 4000)) if len(node_seqs) % 2 == 0 \
            else int(rng.integers(60, 200))
        ln = min(ln, remaining)
        node_seqs.append("".join("ACGT"[i] for i in rng.integers(0, 4, ln)))
        chain_idx.append(len(node_seqs))  # 1-based velvet id
        remaining -= ln
    for a, b in zip(chain_idx, chain_idx[1:]):
        arcs.append((a, b))
    for _ in range(len(chain_idx) // 4):
        src = chain_idx[int(rng.integers(0, len(chain_idx) - 1))]
        node_seqs.append("".join("ACGT"[i] for i in rng.integers(0, 4, 80)))
        arcs.append((src, len(node_seqs)))
    genome = "".join(node_seqs[i - 1] for i in chain_idx)

    lg = f"{out_dir}/LastGraph"
    with open(lg, "w") as f:
        f.write(lastgraph_text(node_seqs, arcs))
    im, istd, L = 300, 25, 100
    m1, m2 = make_pairs(rng, genome, n_pairs, L, im, istd)
    write_fastq(f"{out_dir}/m1.fq", m1)
    write_fastq(f"{out_dir}/m2.fq", m2)
    cfg_path = f"{out_dir}/run.cfg"
    with open(cfg_path, "w") as f:
        f.write(f"""graph={lg}
max_iterations={iters}
output_prefix={out_dir}/refout

[lib]
type=paired
filename1={out_dir}/m1.fq
filename2={out_dir}/m2.fq
insert_mean={im}
insert_std={istd}
cache_prefix={out_dir}/cache
""")

    runs = int(sys.argv[5]) if len(sys.argv) > 5 else 1

    ref_bin = "/tmp/gaml_refbuild/gaml"
    if not os.path.exists(ref_bin):
        subprocess.run(["bash", "tools/build_reference.sh"], check=True,
                       cwd=os.path.join(os.path.dirname(__file__), ".."))

    def run_ref():
        # fresh caches per run: the reference would otherwise reuse files
        for fn in os.listdir(out_dir):
            if fn.startswith("cache"):
                os.remove(os.path.join(out_dir, fn))
        t0 = time.time()
        proc = subprocess.run(["stdbuf", "-o0", ref_bin, cfg_path],
                              capture_output=True, timeout=36000,
                              cwd=out_dir)
        dt = time.time() - t0
        text = proc.stdout.decode()
        iters_lines = re.findall(
            r"itnum (\d+) .* new prob (-?[\d.]+) (-?[\d.]+) (-?[\d.]+)",
            text)
        best = float(iters_lines[-1][3]) if iters_lines else float("nan")
        n_it = int(iters_lines[-1][0]) if iters_lines else 0
        return dt, best, n_it, proc.returncode

    from gaml_tpu.config import load_config, prepare_read_sets
    from gaml_tpu.core.io import load_lastgraph
    from gaml_tpu.optimize.anneal import Optimizer
    from gaml_tpu.optimize.settings import AssemblySettings
    from gaml_tpu.scoring.calculator import ProbCalculator

    def run_ours():
        configs, rs_cfgs = load_config(cfg_path)
        single, paired, pacbio = prepare_read_sets(rs_cfgs)
        gr = load_lastgraph(lg)
        for _c, (rs1, rs2) in paired:
            for rs in (rs1, rs2):
                rs.preprocess_reads()
                rs.prepare_read_index()
        pc = ProbCalculator(single, paired, pacbio, gr)
        settings = AssemblySettings.from_config(configs)
        settings.output_prefix = f"{out_dir}/ourout"
        opt = Optimizer(gr, pc, settings, longest_read=im,
                        log=lambda *a: None)
        paths = [[i] for i in range(0, gr.num_nodes, 2)
                 if gr.node_len(i) > 500]
        t0 = time.time()
        best = opt.run(paths, write_outputs=False)
        dt = time.time() - t0
        from gaml_tpu.core.io import output_paths_to_file

        output_paths_to_file(best, gr, 47, settings.threshold,
                             settings.output_prefix)
        return dt, float(opt.best_prob), opt.itnum

    ref_times, our_times = [], []
    ref_bests, our_bests = [], []
    for k in range(runs):
        rt, rb, ri, rc = run_ref()
        ref_times.append(rt)
        ref_bests.append(rb)
        print(f"run {k}: reference best={rb} iters={ri} time={rt:.2f}s "
              f"rc={rc}", flush=True)
        ot, ob, oi = run_ours()
        our_times.append(ot)
        our_bests.append(ob)
        print(f"run {k}: ours      best={ob:.6f} iters={oi} "
              f"time={ot:.2f}s", flush=True)

    rmed = float(np.median(ref_times))
    omed = float(np.median(our_times))
    print(f"summary: runs={runs} "
          f"ref_time median={rmed:.2f}s [{min(ref_times):.2f},"
          f"{max(ref_times):.2f}] "
          f"our_time median={omed:.2f}s [{min(our_times):.2f},"
          f"{max(our_times):.2f}] "
          f"speedup(median)={rmed / max(omed, 1e-9):.2f}x "
          f"best_delta={our_bests[-1] - ref_bests[-1]:+.4f} "
          f"(positive = ours better)", flush=True)

    # assembly-quality equivalence (BASELINE.md "final contigs equivalent
    # to reference output"): both binaries' last-written FASTAs vs truth
    from asm_quality import assembly_quality

    for side, fasta in (("reference", f"{out_dir}/refout.fasta"),
                        ("ours", f"{out_dir}/ourout.fasta")):
        if os.path.exists(fasta):
            q = assembly_quality(genome, fasta)
            print(f"quality {side}: contigs={q['n_contigs']} "
                  f"total={q['total_len']} N50={q['n50']} NG50={q['ng50']} "
                  f"kmer_recall={q['kmer_recall']} "
                  f"kmer_junk={q['kmer_junk']}", flush=True)
        else:
            print(f"quality {side}: {fasta} missing", flush=True)


if __name__ == "__main__":
    main()
