"""usearch12_tpu — sequence search & clustering with JAX device paths.

A from-scratch JAX/XLA re-design of the capabilities of USEARCH 12
(rcedgar/usearch12): UDB k-mer indexed global/local search with USORT
word-count candidate ranking, banded affine Needleman-Wunsch alignment,
greedy UCLUST clustering, UNOISE3 denoising, UCHIME3 chimera detection,
SINTAX taxonomy, and FASTQ preprocessing.

Architecture:
  - The host runtime (C, native/) runs parsing, ranking, HSP chaining
    and the exact accept/terminate logic; outputs match the reference
    byte for byte.
  - Batched fixed-shape device work runs in JAX on a GPU: the banded DP
    of inter-HSP holes by anti-diagonals (ops/wavefront_nw.py), SINTAX
    boots as int8 matmuls, CSR candidate ranking.  device.gate decides
    whether a device path may run.
  - Several devices shard the UDB targets over a jax.sharding.Mesh;
    per-shard top candidates merge with deterministic tie-breaking
    (lowest target index first) so greedy semantics and outputs are
    reproducible.
"""

__version__ = "0.1.0"

