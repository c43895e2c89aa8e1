"""gDDIM core: the Stage-I coefficient pipeline and the serving bank."""
from .coeffs import (SamplerCoeffs, SamplerConfig, CoeffCache, FactoredBank,
                     factor_coeff, build_sampler_coeffs, bucket_size,
                     time_grid, ALGORITHMS, ALG_GDDIM, ALG_GMM, ALG_ACCEL,
                     GMM_RHO, GMM_SCALE, GMM_C, GMM_SALT, effective_q,
                     algorithm_coeff_stacks)

__all__ = [
    "SamplerCoeffs", "SamplerConfig", "CoeffCache", "FactoredBank",
    "factor_coeff", "build_sampler_coeffs", "bucket_size", "time_grid",
    "ALGORITHMS", "ALG_GDDIM", "ALG_GMM", "ALG_ACCEL",
    "GMM_RHO", "GMM_SCALE", "GMM_C", "GMM_SALT",
    "effective_q", "algorithm_coeff_stacks",
]
