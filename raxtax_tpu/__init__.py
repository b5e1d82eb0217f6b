"""raxtax-tpu: a GPU k-mer taxonomic classifier in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of
noahares/raxtax: a non-Bayesian SINTAX-style classifier for DNA barcoding
sequences. The inverted-index scatter-add of the reference becomes packed
bit-matrix popcount kernels on the device; the analytic top-hit probability model
and lineage aggregation become histogram-collapsed f64 host math plus device
segment reductions; scaling is via `jax.sharding` meshes (queries
data-parallel, reference bit matrix model-parallel).
"""

__version__ = "0.1.0"
