"""Neural ADMIXTURE in JAX — an ancestry-inference engine for NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas implementation of the Neural ADMIXTURE method
(rapid population clustering with autoencoders): a shared encoder producing
simplex-constrained admixture proportions Q and per-K linear decoders whose
weights are the allele-frequency matrices P, trained with summed binary
cross-entropy against dosage-scaled genotypes.

Feature-parity target: AI-sandbox/neural-admixture (see SURVEY.md). The
compute path is JAX/XLA with a fused Pallas (Triton) op for the training
step on the GPU; genotypes stay 2-bit-packed in device memory; scaling is
expressed with jax.sharding over a (data, snp) device mesh.
"""

__version__ = "0.1.0"

from . import io, models, ops, parallel, train, utils  # noqa: F401,E402
