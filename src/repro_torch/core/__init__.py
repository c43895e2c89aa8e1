"""gDDIM core: the Stage-I coefficient pipeline, the serving bank and the
Stage-II samplers."""
from .coeffs import (SamplerCoeffs, SamplerConfig, CoeffCache, FactoredBank,
                     factor_coeff, build_sampler_coeffs, bucket_size,
                     time_grid, ALGORITHMS, ALG_GDDIM, ALG_GMM, ALG_ACCEL,
                     GMM_RHO, GMM_SCALE, GMM_C, GMM_SALT, effective_q,
                     algorithm_coeff_stacks, ddim_closed_form_check)
from .gddim import (sample_gddim, sample_gddim_stochastic, sample_em,
                    sample_heun, sample_ancestral_bdm, sample_rk45_np)

__all__ = [
    "SamplerCoeffs", "SamplerConfig", "CoeffCache", "FactoredBank",
    "factor_coeff", "build_sampler_coeffs", "bucket_size", "time_grid",
    "ALGORITHMS", "ALG_GDDIM", "ALG_GMM", "ALG_ACCEL",
    "GMM_RHO", "GMM_SCALE", "GMM_C", "GMM_SALT",
    "effective_q", "algorithm_coeff_stacks", "ddim_closed_form_check",
    "sample_gddim", "sample_gddim_stochastic", "sample_em", "sample_heun",
    "sample_ancestral_bdm", "sample_rk45_np",
]
