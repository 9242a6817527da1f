"""TRUE differential parity: build the actual reference C++ (via
tools/build_reference.sh, Boost stubbed) and compare its printed
``start prob ... len ...`` — the full likelihood of the starting walk set —
against our scorer on identical synthetic inputs.

This is the SURVEY §4(b) golden-parity surface measured against the real
reference implementation rather than against formulas.
"""
import re
import subprocess

import numpy as np
import pytest

from gaml_tpu.config import load_config, prepare_read_sets
from gaml_tpu.core.io import load_lastgraph
from gaml_tpu.scoring.calculator import ProbCalculator

from fixtures import lastgraph_text, random_seq, write_fastq
from test_scoring import make_pairs

REF_BIN = "/tmp/gaml_refbuild/gaml"


@pytest.fixture(scope="module")
def reference_binary():
    try:
        out = subprocess.run(["bash", "tools/build_reference.sh"],
                             capture_output=True, timeout=300, cwd="/root/repo")
    except (OSError, subprocess.TimeoutExpired):
        pytest.skip("reference build failed")
    if out.returncode != 0:
        pytest.skip(f"reference build failed: {out.stderr.decode()[-500:]}")
    return REF_BIN


def run_reference(cfg_path, cwd):
    # stdbuf: the reference may segfault in a *later* move (its own UB on
    # tiny graphs, e.g. the missing return in SplitOnNode/moves.cc:1127);
    # we only need the start-prob line, flushed unbuffered.
    out = subprocess.run(["stdbuf", "-o0", "-e0", REF_BIN, str(cfg_path)],
                         capture_output=True, timeout=300, cwd=cwd)
    text = out.stdout.decode()
    m = re.search(r"start prob (-?[\d.]+) len (\d+)", text)
    assert m, text[-2000:]
    return float(m.group(1)), int(m.group(2))


def make_world(tmp_path, rng, node_lens, arcs):
    seqs = [random_seq(rng, n) for n in node_lens]
    lg = tmp_path / "LastGraph"
    lg.write_text(lastgraph_text(seqs, arcs))
    return seqs, lg


def our_start_prob(cfg_path):
    configs, rs_cfgs = load_config(str(cfg_path))
    single, paired, pacbio = prepare_read_sets(rs_cfgs)
    gr = load_lastgraph(configs["graph"])
    for _cfg, rs in single:
        rs.preprocess_reads()
        rs.prepare_read_index()
    for _cfg, (rs1, rs2) in paired:
        for rs in (rs1, rs2):
            rs.preprocess_reads()
            rs.prepare_read_index()
    pc = ProbCalculator(single, paired, pacbio, gr)
    paths = [[i] for i in range(0, gr.num_nodes, 2) if gr.node_len(i) > 500]
    zeros = []
    score, total_len = pc.calc_prob(paths, zeros)
    return score, total_len, zeros


def sample_long_reads(rng, genome, n, lo, hi, err=0.08):
    """PacBio-like reads: substitutions + indels, both strands."""
    from gaml_tpu.core import dna as _dna

    reads = []
    g = np.frombuffer(genome.encode(), dtype=np.uint8)
    codes = _dna.encode_seq(genome)
    for _ in range(n):
        L = int(rng.integers(lo, hi))
        p = int(rng.integers(0, len(genome) - L + 1))
        r = list(codes[p:p + L])
        out = []
        for c in r:
            u = rng.random()
            if u < err * 0.4:
                out.append(int(rng.integers(0, 4)))      # substitution
            elif u < err * 0.7:
                out.append(int(c))
                out.append(int(rng.integers(0, 4)))      # insertion
            elif u < err:
                continue                                  # deletion
            else:
                out.append(int(c))
        arr = np.array(out, dtype=np.uint8)
        if rng.random() < 0.5:
            arr = _dna.revcomp(arr)
        reads.append(_dna.decode_seq(arr))
    _ = g
    return reads


def test_reference_pacbio_start_prob(tmp_path, reference_binary):
    """PacBio differential via the fake-blasr shim: the reference binary
    and our exact scorer consume identical shim alignments; the printed
    start likelihood must match to printf precision.  Pins the CIGAR-band
    forward DP (graph.cc:2175-2297), ParseAligment (graph.cc:2945-3021),
    the window cache assembly (graph.cc:2299-2503), anchors
    (graph.cc:2505-2576), and the PacBio reduction + coverage sweep
    (graph.cc:3040-3261)."""
    from fixtures import write_fastq

    rng = np.random.default_rng(777)
    seqs, lg = make_world(tmp_path, rng, [900, 120, 3200, 90, 700],
                          [(1, 2), (2, 3), (3, 4), (4, 5)])
    genome = "".join(seqs)
    reads = sample_long_reads(rng, genome, 14, 280, 600)
    write_fastq(str(tmp_path / "pb.fq"), reads, prefix="pb")
    cfg = tmp_path / "ref.cfg"
    cfg.write_text(f"""graph={lg}
max_iterations=0
output_prefix={tmp_path}/refout
blasr_path=/root/repo/tools/fake_blasr_bin

[lib]
type=pacbio
filename={tmp_path}/pb.fq
penalty_constant=0.0001
cache_prefix={tmp_path}/pbcache
""")
    ref_score, ref_len = run_reference(cfg, tmp_path)

    from gaml_tpu.diagnostics.exact_pacbio import ExactPacbioReadSet
    from gaml_tpu.scoring.config import SingleReadConfig

    configs, rs_cfgs = load_config(str(cfg))
    gr = load_lastgraph(configs["graph"])
    mismatch = 0.01
    rs = ExactPacbioReadSet(str(tmp_path / "pbcache"),
                            str(tmp_path / "pb.fq"),
                            1.0 - 4 * mismatch, mismatch)
    rs.preprocess_reads()
    rs.normalize_cache(gr)
    rs.compute_anchors(gr, persist=False)
    scfg = SingleReadConfig(penalty_constant=0.0001, step=50)
    pc = ProbCalculator([], [], [(scfg, rs)], gr)
    paths = [[i] for i in range(0, gr.num_nodes, 2) if gr.node_len(i) > 500]
    zeros = []
    our_score, our_len = pc.calc_prob(paths, zeros)
    assert our_len == ref_len
    assert our_score == pytest.approx(ref_score, abs=2e-6)
    # not a trivial all-floored pass: most reads must carry real mass
    assert zeros[0][0] <= len(reads) // 3, zeros


def test_reference_paired_start_prob(tmp_path, reference_binary):
    rng = np.random.default_rng(1234)
    seqs, lg = make_world(tmp_path, rng, [700, 90, 800, 70, 650],
                          [(1, 2), (2, 3), (3, 4), (4, 5)])
    genome = "".join(seqs)
    m1, m2 = make_pairs(rng, genome, 60, 30, 300, 25)
    write_fastq(str(tmp_path / "m1.fq"), m1)
    write_fastq(str(tmp_path / "m2.fq"), m2)
    cfg = tmp_path / "ref.cfg"
    cfg.write_text(f"""graph={lg}
max_iterations=0
output_prefix={tmp_path}/refout

[lib]
type=paired
filename1={tmp_path}/m1.fq
filename2={tmp_path}/m2.fq
insert_mean=300
insert_std=25
cache_prefix={tmp_path}/cache
""")
    ref_score, ref_len = run_reference(cfg, tmp_path)
    our_score, our_len, zeros = our_start_prob(cfg)
    assert our_len == ref_len
    assert our_score == pytest.approx(ref_score, abs=2e-6)


def test_reference_paired_unequal_mate_lengths(tmp_path, reference_binary):
    """L1 != L2 makes the incremental threshold quirk (rs2 length twice)
    observable; distances also mix both lengths."""
    rng = np.random.default_rng(555)
    seqs, lg = make_world(tmp_path, rng, [800, 100, 900],
                          [(1, 2), (2, 3), (1, 3)])
    genome = "".join(seqs)
    L1, L2, im, istd = 30, 44, 280, 30
    m1, m2 = [], []
    for _ in range(50):
        ins = max(L1 + L2 + 10, min(int(rng.normal(im, istd)), len(genome)))
        p = int(rng.integers(0, len(genome) - ins + 1))
        m1.append(genome[p:p + L1])
        from gaml_tpu.core import dna as _dna

        m2.append(_dna.revcomp_str(genome[p + ins - L2:p + ins]))
    write_fastq(str(tmp_path / "u1.fq"), m1)
    write_fastq(str(tmp_path / "u2.fq"), m2)
    cfg = tmp_path / "uneq.cfg"
    cfg.write_text(f"""graph={lg}
max_iterations=0
output_prefix={tmp_path}/uo

[lib]
type=paired
filename1={tmp_path}/u1.fq
filename2={tmp_path}/u2.fq
insert_mean={im}
insert_std={istd}
cache_prefix={tmp_path}/uc
""")
    ref_score, ref_len = run_reference(cfg, tmp_path)
    our_score, our_len, _ = our_start_prob(cfg)
    assert our_len == ref_len
    assert our_score == pytest.approx(ref_score, abs=2e-6)


def test_reference_branchy_noisy(tmp_path, reference_binary):
    """Branching graph + 2% errors: multiplicity in candidates and
    error-bearing extensions."""
    rng = np.random.default_rng(991)
    seqs, lg = make_world(
        tmp_path, rng, [700, 90, 90, 650, 120, 600],
        [(1, 2), (1, 3), (2, 4), (3, 4), (4, 5), (5, 6), (1, 6)])
    genome = seqs[0] + seqs[1] + seqs[3] + seqs[4] + seqs[5]
    m1, m2 = make_pairs(rng, genome, 70, 32, 260, 30)

    def noisy(reads):
        out = []
        for r in reads:
            chars = list(r)
            for i in range(len(chars)):
                if rng.random() < 0.02:
                    chars[i] = "ACGT"[int(rng.integers(0, 4))]
            out.append("".join(chars))
        return out

    write_fastq(str(tmp_path / "b1.fq"), noisy(m1))
    write_fastq(str(tmp_path / "b2.fq"), noisy(m2))
    cfg = tmp_path / "branchy.cfg"
    cfg.write_text(f"""graph={lg}
max_iterations=0
output_prefix={tmp_path}/bo

[lib]
type=paired
filename1={tmp_path}/b1.fq
filename2={tmp_path}/b2.fq
insert_mean=260
insert_std=30
cache_prefix={tmp_path}/bc
""")
    ref_score, ref_len = run_reference(cfg, tmp_path)
    our_score, our_len, _ = our_start_prob(cfg)
    assert our_len == ref_len
    assert our_score == pytest.approx(ref_score, abs=2e-6)


def test_reference_starting_assembly_bootstrap(tmp_path, reference_binary):
    """No graph= key: both sides build the k=101 graph from the scaffold
    FASTA (multi-node walks incl. gap entries) and score the clipped
    walks — exercising graph_from_assembly parity end to end."""
    rng = np.random.default_rng(31)
    part1 = random_seq(rng, 1500)
    part2 = random_seq(rng, 1300)
    scaffold = part1 + "N" * 40 + part2
    fa = tmp_path / "asm.fasta"
    fa.write_text(f">scf1\n{scaffold}\n")
    genome = part1 + part2
    reads = []
    for _ in range(60):
        p = int(rng.integers(0, len(genome) - 36))
        reads.append(genome[p:p + 36])
    write_fastq(str(tmp_path / "s.fq"), reads)
    cfg = tmp_path / "boot.cfg"
    cfg.write_text(f"""starting_assembly={fa}
max_iterations=0
output_prefix={tmp_path}/bo2

[lib]
type=single
filename={tmp_path}/s.fq
cache_prefix={tmp_path}/bc2
""")
    ref_score, ref_len = run_reference(cfg, tmp_path)

    # our side mirrors the reference main: bootstrap graph + clip + missing
    from gaml_tpu.assembly_import import add_missing_big_nodes, clip_paths
    from gaml_tpu.core.graph import Graph
    from gaml_tpu.graph_from_assembly import get_graph_from_assembly

    configs, rs_cfgs = load_config(str(cfg))
    single, paired, pacbio = prepare_read_sets(rs_cfgs)
    gr = Graph()
    paths = get_graph_from_assembly(str(fa), gr)
    paths = clip_paths(paths, gr)
    add_missing_big_nodes(paths, gr)
    for _cfg, rs in single:
        rs.preprocess_reads()
        rs.prepare_read_index()
    pc = ProbCalculator(single, paired, pacbio, gr)
    zeros = []
    our_score, our_len = pc.calc_prob(paths, zeros)
    assert our_len == ref_len
    assert our_score == pytest.approx(ref_score, abs=2e-6)


def test_reference_adversarial_walkset_full_rescore(tmp_path,
                                                    reference_binary):
    """Adversarial walk-set differential: the
    bootstrap path feeds the reference a multi-walk set containing gap
    entries, an EXACT duplicate walk, and a reverse-complement reuse of
    another walk's nodes — so the incremental paired scorer's add path
    (CalcScoreForPathInc over every walk incl. duplicates,
    graph.cc:1794-1920 via GetChanges graph.cc:1745-1764), the per-walk
    gap events, and the rs2-length threshold quirk are all compared
    against the C++ on one likelihood."""
    rng = np.random.default_rng(4242)
    p1 = random_seq(rng, 1400)
    p2 = random_seq(rng, 1200)
    p3 = random_seq(rng, 1100)
    from gaml_tpu.core import dna as _dna

    rc_p1 = _dna.revcomp_str(p1)
    scf_a = p1 + "N" * 40 + p2
    scf_c = rc_p1 + "N" * 25 + p3
    fa = tmp_path / "adv.fasta"
    # scaffold B is an exact duplicate of A -> duplicated walk (multiset)
    fa.write_text(f">scfA\n{scf_a}\n>scfB\n{scf_a}\n>scfC\n{scf_c}\n")

    genome1 = p1 + p2
    genome2 = p3
    L, im, istd = 34, 260, 25
    m1, m2 = make_pairs(rng, genome1, 70, L, im, istd)
    m1b, m2b = make_pairs(rng, genome2, 30, L, im, istd)
    write_fastq(str(tmp_path / "am1.fq"), list(m1) + list(m1b))
    write_fastq(str(tmp_path / "am2.fq"), list(m2) + list(m2b))
    singles = [genome1[p:p + 36] for p in
               rng.integers(0, len(genome1) - 36, 40)]
    write_fastq(str(tmp_path / "as.fq"), singles)

    cfg = tmp_path / "adv.cfg"
    cfg.write_text(f"""starting_assembly={fa}
max_iterations=0
output_prefix={tmp_path}/advout

[plib]
type=paired
filename1={tmp_path}/am1.fq
filename2={tmp_path}/am2.fq
insert_mean={im}
insert_std={istd}
penalty_constant=0.0001
cache_prefix={tmp_path}/apc

[slib]
type=single
filename={tmp_path}/as.fq
penalty_constant=0.0001
cache_prefix={tmp_path}/asc
""")
    ref_score, ref_len = run_reference(cfg, tmp_path)

    from gaml_tpu.assembly_import import add_missing_big_nodes, clip_paths
    from gaml_tpu.core.graph import Graph
    from gaml_tpu.graph_from_assembly import get_graph_from_assembly

    configs, rs_cfgs = load_config(str(cfg))
    single, paired, pacbio = prepare_read_sets(rs_cfgs)
    gr = Graph()
    paths = get_graph_from_assembly(str(fa), gr)
    paths = clip_paths(paths, gr)
    add_missing_big_nodes(paths, gr)
    # the adversarial structure must actually be present
    keys = [tuple(p) for p in paths]
    assert len(keys) > len(set(keys)), "expected a duplicated walk"
    assert any(any(e < 0 for e in p) for p in paths), "expected gap entries"
    for _cfg, rs in single:
        rs.preprocess_reads()
        rs.prepare_read_index()
    for _cfg, (rs1, rs2) in paired:
        for rs in (rs1, rs2):
            rs.preprocess_reads()
            rs.prepare_read_index()
    pc = ProbCalculator(single, paired, pacbio, gr)
    zeros = []
    our_score, our_len = pc.calc_prob(paths, zeros)
    assert our_len == ref_len
    assert our_score == pytest.approx(ref_score, abs=2e-6)


def test_reference_single_start_prob(tmp_path, reference_binary):
    from fixtures import sample_reads

    rng = np.random.default_rng(77)
    seqs, lg = make_world(tmp_path, rng, [900, 80, 750],
                          [(1, 2), (2, 3)])
    genome = "".join(seqs)
    reads = sample_reads(rng, genome, 50, 36, err_rate=0.01)
    write_fastq(str(tmp_path / "r.fq"), reads)
    cfg = tmp_path / "ref_single.cfg"
    cfg.write_text(f"""graph={lg}
max_iterations=0
output_prefix={tmp_path}/refout2

[lib]
type=single
filename={tmp_path}/r.fq
cache_prefix={tmp_path}/cache2
""")
    ref_score, ref_len = run_reference(cfg, tmp_path)
    our_score, our_len, zeros = our_start_prob(cfg)
    assert our_len == ref_len
    assert our_score == pytest.approx(ref_score, abs=2e-6)


def test_reference_incremental_erase_path(tmp_path, reference_binary):
    """Erase-path differential: successive
    starting_assembly configs form the walk-set sequence
    [A, A, C] -> [A, C] -> [C] -> [A, C]; the reference binary scores each
    set FRESH (start prob), while OUR side reuses one ProbCalculator whose
    paired ScoringState crosses a duplicated-walk erase, a full erase, and
    a re-add-after-erase (GetChanges erase semantics,
    graph.cc:1745-1764,1936-1950; EraseFromScoringState bad_bases and
    per-read subtraction).  Scaffolds share no 101-mers, so dropping one
    never changes the others' bootstrap subgraphs — the walk *sequences*
    are identical across runs and the likelihoods directly comparable."""
    rng = np.random.default_rng(31337)
    p1 = random_seq(rng, 1400)
    p2 = random_seq(rng, 1200)
    p3 = random_seq(rng, 1100)
    p4 = random_seq(rng, 1000)
    scf_a = p1 + "N" * 40 + p2
    # C must stay breakable even when it is the ONLY walk (step 3): the
    # reference's move loop counts only *successful* moves toward
    # max_iterations, so a lone unbreakable walk spins forever
    scf_c = p3 + "N" * 30 + p4

    genome1 = p1 + p2
    L, im, istd = 34, 260, 25
    m1, m2 = make_pairs(rng, genome1, 70, L, im, istd)
    m1b, m2b = make_pairs(rng, p3 + p4, 30, L, im, istd)
    write_fastq(str(tmp_path / "em1.fq"), list(m1) + list(m1b))
    write_fastq(str(tmp_path / "em2.fq"), list(m2) + list(m2b))

    def cfg_for(step, scaffolds):
        fa = tmp_path / f"er{step}.fasta"
        fa.write_text("".join(f">s{i}\n{s}\n"
                              for i, s in enumerate(scaffolds)))
        cfg = tmp_path / f"er{step}.cfg"
        cfg.write_text(f"""starting_assembly={fa}
max_iterations=0
output_prefix={tmp_path}/erout{step}

[plib]
type=paired
filename1={tmp_path}/em1.fq
filename2={tmp_path}/em2.fq
insert_mean={im}
insert_std={istd}
penalty_constant=0.0001
cache_prefix={tmp_path}/epc{step}
""")
        return fa, cfg

    steps = [("1", [scf_a, scf_a, scf_c]),   # duplicated walk present
             ("2", [scf_a, scf_c]),          # erase the duplicate
             ("3", [scf_c]),                 # erase A entirely
             ("4", [scf_a, scf_c])]          # re-add A after its erase

    from gaml_tpu.assembly_import import add_missing_big_nodes, clip_paths
    from gaml_tpu.core.graph import Graph
    from gaml_tpu.graph_from_assembly import get_graph_from_assembly

    # bootstrap OUR graph + walks once, from the step-1 FASTA
    fa1, cfg1 = cfg_for(*steps[0])
    gr = Graph()
    paths1 = get_graph_from_assembly(str(fa1), gr)
    paths1 = clip_paths(paths1, gr)
    add_missing_big_nodes(paths1, gr)
    assert len(paths1) == 3
    assert paths1[0] == paths1[1], "scaffold B must bootstrap to a dup walk"
    p_a, _p_b, p_c = paths1
    our_sets = {"1": [p_a, p_a, p_c], "2": [p_a, p_c], "3": [p_c],
                "4": [p_a, p_c]}

    configs, rs_cfgs = load_config(str(cfg1))
    single, paired, pacbio = prepare_read_sets(rs_cfgs)
    for _cfg, (rs1, rs2) in paired:
        for rs in (rs1, rs2):
            rs.preprocess_reads()
            rs.prepare_read_index()
    pc = ProbCalculator(single, paired, pacbio, gr)

    for step, scaffolds in steps:
        _fa, cfg = cfg_for(step, scaffolds)
        ref_score, ref_len = run_reference(cfg, tmp_path)
        our_score, our_len = pc.calc_prob(our_sets[step])
        assert our_len == ref_len, step
        assert our_score == pytest.approx(ref_score, abs=2e-6), step
    # the state really crossed erases: bad_bases and probs are reused
    st = pc.paired_scoring_states[0]
    assert [list(w) for w in st.old_paths] == [list(w) for w in
                                               our_sets["4"]]
