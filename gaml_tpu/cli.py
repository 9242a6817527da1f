"""Command-line driver (reference main, gaml.cc:935-1023).

Usage: gaml-tpu <config file> [--backend bfs|device] [--resume prefix]
"""
from __future__ import annotations

import argparse
import os
import sys

from .config import load_config, prepare_read_sets
from .core.io import load_lastgraph, output_paths_to_file
from .optimize.anneal import Optimizer
from .optimize.settings import AssemblySettings
from .scoring.calculator import ProbCalculator


def get_longest_read(single, paired, pacbio) -> int:
    """Reference GetLongestRead (gaml.cc:911-933): max read length over
    single/pacbio sets; paired sets contribute their insert mean."""
    longest = 0
    for _cfg, rs in single:
        for i in range(rs.get_number_of_reads()):
            longest = max(longest, rs.get_read_len(i))
    for _cfg, rs in pacbio:
        for i in range(rs.get_number_of_reads()):
            longest = max(longest, rs.get_read_len(i))
    for cfg, _pair in paired:
        longest = max(longest, int(cfg.insert_mean))
    return longest


def prepare_reads(single, paired, pacbio, graph) -> None:
    """Reference PrepareReads (gaml.cc:883-909)."""
    for _cfg, rs in pacbio:
        rs.load_alignments()
        rs.preprocess_reads()
        rs.normalize_cache(graph)
        rs.compute_anchors(graph)
    for _cfg, (rs1, rs2) in paired:
        for rs in (rs1, rs2):
            rs.load_alignments()
            rs.preprocess_reads()
            rs.prepare_read_index()
    for _cfg, rs in single:
        rs.load_alignments()
        rs.preprocess_reads()
        rs.prepare_read_index()


def starting_paths_from_config(configs, graph, settings):
    """Starting walk set (reference gaml.cc:970-1006)."""
    if "starting_assembly" in configs:
        if "graph" in configs:
            from .assembly_import import get_paths

            paths = get_paths(graph, configs["starting_assembly"])
        else:
            from .graph_from_assembly import get_graph_from_assembly

            # connect_bootstrap_graph=1 wires edges from the interval
            # adjacency (the reference leaves the bootstrap graph
            # edge-less, so reroute/extend moves have nothing to sample)
            connect = configs.get("connect_bootstrap_graph", "0") == "1"
            paths = get_graph_from_assembly(configs["starting_assembly"],
                                            graph, connect=connect)
        from .assembly_import import add_missing_big_nodes, clip_paths

        paths = clip_paths(paths, graph)
        add_missing_big_nodes(paths, graph)
        output_paths_to_file(paths, graph, 61, 500, "starting3")
        return paths
    return [[i] for i in range(0, graph.num_nodes, 2)
            if graph.node_len(i) > settings.threshold]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gaml-tpu")
    ap.add_argument("config")
    ap.add_argument("--backend", default="bfs", choices=["bfs", "device"],
                    help="short-read extension backend: bfs = bit-exact "
                         "reference semantics (native-accelerated), device "
                         "= min-cost kernel on the JAX device (GPU "
                         "Pallas kernel; plain jnp on CPU)")
    ap.add_argument("--resume", default="",
                    help="resume from <prefix>.ckpt")
    ap.add_argument("--paired-device", action="store_true",
                    help="score paired read sets on the device mesh "
                         "(sharded pair products + psum reduction, "
                         "parallel.paired_sharded) instead of the host "
                         "incremental scorer")
    ap.add_argument("--paired-device-inc", action="store_true",
                    help="incremental mesh paired scoring: diff the walk "
                         "multiset on host, compute only changed walks' "
                         "pair products on the mesh, and psum_scatter "
                         "signed deltas into device-resident running "
                         "totals (anneal-rate mesh path)")
    ap.add_argument("--device-state", action="store_true",
                    help="keep the paired incremental scorer's per-read "
                         "running totals resident on the device mesh "
                         "(parallel.device_state), sharded over 'reads'")
    ap.add_argument("--pacbio-device", action="store_true",
                    help="run the PacBio per-read reduction on the device "
                         "mesh (parallel.pacbio_sharded)")
    ap.add_argument("--distributed", default="",
                    help="multi-host mode: coordinator address "
                         "host:port (or set GAML_COORD); requires "
                         "GAML_NPROC and GAML_PROC_ID")
    args = ap.parse_args(argv)

    coord = args.distributed or os.environ.get("GAML_COORD", "")
    if coord:
        nproc = os.environ.get("GAML_NPROC")
        proc_id = os.environ.get("GAML_PROC_ID")
        if nproc is None or proc_id is None:
            print("--distributed/GAML_COORD requires GAML_NPROC and "
                  "GAML_PROC_ID environment variables (process count and "
                  "this process's 0-based id)", file=sys.stderr)
            return 1
        import jax

        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(nproc),
            process_id=int(proc_id))

    from .utils.device import enable_compile_cache

    enable_compile_cache()
    configs, read_set_configs = load_config(args.config)
    if "graph" not in configs and "starting_assembly" not in configs:
        print("Missing graph in config", file=sys.stderr)
        return 1

    single, paired, pacbio = prepare_read_sets(read_set_configs,
                                               backend=args.backend)
    settings = AssemblySettings.from_config(configs)

    if "graph" in configs:
        graph = load_lastgraph(configs["graph"])
    else:
        from .core.graph import Graph

        graph = Graph()

    paths = starting_paths_from_config(configs, graph, settings)

    pc = ProbCalculator(single, paired, pacbio, graph)
    advice_paired = [pair for cfg, pair in paired if cfg.advice]
    advice_pacbio = [rs for cfg, rs in pacbio if cfg.advice]

    prepare_reads(single, paired, pacbio, graph)
    longest_read = get_longest_read(single, paired, pacbio)

    if (args.paired_device or args.paired_device_inc) and paired:
        from .parallel.sharded import make_mesh

        pc.enable_sharded_paired(make_mesh(),
                                 incremental=args.paired_device_inc)
    if args.pacbio_device and pacbio:
        from .parallel.sharded import make_mesh

        pc.enable_sharded_pacbio(make_mesh())
    elif args.backend == "device" and pacbio:
        # single-chip device routing for the long-read forward DP: batches
        # above the cell threshold (scoring/pacbio.py) go to the device.
        # The executables compile in the BACKGROUND while early moves
        # are served by the exact native kernels;
        # GAML_PB_PREWARM_SYNC=1 makes the prewarm blocking.
        for _cfg, rs in pacbio:
            if os.environ.get("GAML_PB_PREWARM_SYNC") == "1":
                rs.prewarm_device()
            else:
                rs.prewarm_device_async()
    if args.device_state and paired:
        # needs read lengths: after prepare_reads
        from .parallel.sharded import make_mesh

        pc.enable_device_scoring_state(make_mesh())

    opt = Optimizer(graph, pc, settings, advice_paired, advice_pacbio,
                    longest_read)
    if args.resume:
        from .optimize.checkpoint import load_checkpoint

        paths = load_checkpoint(opt, args.resume)
    opt.run(paths)
    return 0


if __name__ == "__main__":
    sys.exit(main())
