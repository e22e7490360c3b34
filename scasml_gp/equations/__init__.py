from scasml_gp.equations.base import Equation, HypercubeGeometry
from scasml_gp.equations.grad_dependent import GradDependentNonlinear
from scasml_gp.equations.extra import AllenCahn, HJB, SineNonlinear

EQUATIONS = {
    "GradDependentNonlinear": GradDependentNonlinear,
    "AllenCahn": AllenCahn,
    "HJB": HJB,
    "SineNonlinear": SineNonlinear,
}

__all__ = [
    "Equation",
    "HypercubeGeometry",
    "GradDependentNonlinear",
    "AllenCahn",
    "HJB",
    "SineNonlinear",
    "EQUATIONS",
]
