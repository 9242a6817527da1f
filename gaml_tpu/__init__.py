"""gaml_tpu — a maximum-likelihood genome assembler on JAX.

Re-implements the full capability surface of the GAML assembler (reference:
C++ single-threaded, external Bowtie2/BLASR/MUMmer subprocesses) with an
accelerator device path (an NVIDIA GPU; the CPU runs the same code):

- device side (JAX/Pallas): batched seed verification + banded edit-distance
  extension for short reads, banded log-space forward DP for long (PacBio)
  reads, fused likelihood reductions, data-parallel sharding over a device
  mesh with psum-merged partial likelihoods;
- host side (Python + C++ native extension): graph model, reachability
  precomputes, max-hash read index, move engine, simulated annealing driver,
  config/IO, checkpointing.

Likelihood semantics bit-match the reference scorers
(reference: graph.cc:1482-2127, graph.cc:3040-3261, prob_calculator.h:63-109).
"""

__version__ = "0.1.0"
