from scasml_gp.gp.kernels import (
    PHI_OPS,
    PHI_SETS,
    GradCoeffs,
    PairStats,
    grad_coeffs,
    kernel_gamma,
    kernel_gammas,
    split_gamma,
    op_block,
    pair_stats,
)
from scasml_gp.gp.gram import (
    gram_matrix,
    logdet_quad,
    regularized_factorization,
)
from scasml_gp.gp.marginal import (
    MarginalFitResult,
    fit_gp_marginal_likelihood,
)
from scasml_gp.gp.cole_hopf import GPHJBColeHopf
from scasml_gp.gp.semigroup import GPAllenCahnSemigroup
from scasml_gp.gp.posterior import PosteriorOut, posterior_eval
from scasml_gp.gp.solver import (
    GP,
    AllenCahnForm,
    GPAllenCahn,
    GPForm,
    GPGradDependentNonlinear,
    GPSineNonlinear,
    GradDependentForm,
)
from scasml_gp.gp.state import GPState, load_state, save_state
from scasml_gp.gp.variance import (
    cross_phi,
    factor_for_variance,
    posterior_variance,
)

__all__ = [
    "PHI_OPS",
    "PHI_SETS",
    "GradCoeffs",
    "PairStats",
    "grad_coeffs",
    "kernel_gamma",
    "kernel_gammas",
    "split_gamma",
    "op_block",
    "pair_stats",
    "gram_matrix",
    "logdet_quad",
    "regularized_factorization",
    "MarginalFitResult",
    "fit_gp_marginal_likelihood",
    "PosteriorOut",
    "posterior_eval",
    "GP",
    "GPForm",
    "GradDependentForm",
    "AllenCahnForm",
    "GPGradDependentNonlinear",
    "GPAllenCahn",
    "GPSineNonlinear",
    "GPHJBColeHopf",
    "GPAllenCahnSemigroup",
    "GPState",
    "load_state",
    "save_state",
    "cross_phi",
    "factor_for_variance",
    "posterior_variance",
]
