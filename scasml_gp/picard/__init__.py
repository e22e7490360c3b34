from scasml_gp.picard.schedule import (
    PicardTables,
    approx_parameters,
    count_evaluations_full_history,
    count_evaluations_quadrature,
    inverse_gamma,
    leggauss,
)
from scasml_gp.picard.core import (
    PicardModel,
    build_full_history_uz,
    build_quadrature_uz,
)
from scasml_gp.picard.mlp import MLP, MLPFullHistory, MLP_full_history
from scasml_gp.picard.scasml import (
    ScaSML,
    ScaSMLFullHistory,
    ScaSML_full_history,
)

__all__ = [
    "PicardTables",
    "approx_parameters",
    "count_evaluations_full_history",
    "count_evaluations_quadrature",
    "inverse_gamma",
    "leggauss",
    "PicardModel",
    "build_full_history_uz",
    "build_quadrature_uz",
    "MLP",
    "MLPFullHistory",
    "MLP_full_history",
    "ScaSML",
    "ScaSMLFullHistory",
    "ScaSML_full_history",
]
