"""meshclust2_tpu — an alignment-free DNA sequence clustering framework on JAX.

A from-scratch rebuild of the capabilities of MeShClust2
(BioinformaticsToolsmith/MeShClust2): alignment-free mean-shift clustering of
DNA sequences driven by a runtime-trained GLM identity classifier over k-mer
histogram features.

Architecture (device-first, not a port):
  io/        FASTA parsing, IUPAC encoding, CLSTR + weights.txt serialization  [host]
  kmer/      k-mer histogram construction ([N, 4^k] count matrices)            [host+device]
  features/  the 33 alignment-free feature formulas (host float64 oracle)      [host]
  ops/       batched pairwise feature kernels (XLA), double-float arithmetic   [device]
  glm/       closed-form GLM solve, logistic link, accuracy metrics            [host]
  model/     trained-classifier model: weights serialization + compiled
             device/host classifier                                            [host+device]
  mutate/    semi-synthetic mutation engine (single + block mutations)         [host]
  train/     training driver: template selection, calibration, BestFirst /
             Greedy feature-set selection                                      [host+device]
  cluster/   mean-shift engine: length-binned pool, accumulation phase,
             update/merge phase                                                [host-driven, device-scored]
  parallel/  jax.sharding Mesh setup and sharded scoring                       [device]

Reference behavior is documented per-module with file:line citations into the
upstream C++ so parity can be audited; the implementation itself is new and
designed for XLA execution on a GPU (or XLA:CPU under JAX_PLATFORMS=cpu).
"""

__version__ = "0.1.0"
