"""desman_tpu — GPU strain deconvolution in JAX with DESMAN's capabilities.

A ground-up JAX/XLA/Pallas re-design (not a port) of chrisquince/DESMAN
(Quince et al., Genome Biology 2017, 18:181): variant filtering, the
tau/gamma/eta Gibbs sampler, model selection over the number of strains, and
accessory-gene assignment, built for GPU meshes. See SURVEY.md for the
reference analysis this is built against.
"""

from .io import CountsData, read_counts_csv
from .sampler import (
    SamplerConfig, SamplerResult, run_chain, run_chain_pt, run_chains,
)

__version__ = "0.1.0"

__all__ = [
    "CountsData",
    "read_counts_csv",
    "SamplerConfig",
    "SamplerResult",
    "run_chain",
    "run_chain_pt",
    "run_chains",
]
