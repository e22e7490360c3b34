"""The gradient-dependent semilinear heat equation with closed-form solution.

Same closed forms as the reference ``Grad_Dependent_Nonlinear``
(reference ``equations/equations.py:232-417``):

    sigma = 0.25
    mu    = -1/d - sigma^2/2
    f(x_t, u, z) = sigma * u * sum(z)
    u*(x, t)     = 1 - 1 / (1 + exp(t + sum_i x_i))
    domain       = [-0.5, 0.5]^d x [0, 0.5]

but computed in the session compute dtype (fp32/bf16) instead of the
reference's float16 casts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from scasml_gp.equations.base import Equation


class GradDependentNonlinear(Equation):
    """High-dimensional gradient-dependent semilinear PDE with exact solution."""

    def __init__(self, n_input: int, n_output: int = 1):
        super().__init__(n_input, n_output)
        self.uncertainty = 1e-1      # reference equations.py:245
        self.norm_estimation = 1.0   # reference equations.py:246

    def sigma(self, x_t=0):
        return 0.25                  # reference equations.py:288

    def mu(self, x_t=0):
        sigma = self.sigma()
        return -1.0 / self.dim - sigma**2 / 2.0   # reference equations.py:263-276

    def f(self, x_t: jax.Array, u: jax.Array, z: jax.Array) -> jax.Array:
        # f = sigma * u * sum_i z_i     (reference equations.py:291-304)
        return self.sigma() * u * jnp.sum(z, axis=1, keepdims=True)

    def terminal_constraint(self, x_t: jax.Array) -> jax.Array:
        # g(x, t) = 1 - 1/(1 + e^{t + sum x})  (reference equations.py:249-261);
        # evaluated at arbitrary t it doubles as the lateral Dirichlet data.
        s = x_t[:, -1] + jnp.sum(x_t[:, :-1], axis=1)
        return jax.nn.sigmoid(s)[:, None]

    def exact_solution(self, x_t: jax.Array) -> jax.Array:
        # u*(x,t) = 1 - 1/(1+e^{t+sum x}) = sigmoid(t + sum x)
        # (reference equations.py:307-323)
        s = x_t[:, -1] + jnp.sum(x_t[:, :-1], axis=1)
        return jax.nn.sigmoid(s)[:, None]

    def exact_solution_derivative(self, x_t: jax.Array) -> jax.Array:
        # du*/dx_i = e^s/(1+e^s)^2 = sigmoid(s)(1-sigmoid(s)), identical for
        # every i (reference equations.py:326-342 returns the common value).
        s = x_t[:, -1] + jnp.sum(x_t[:, :-1], axis=1)
        p = jax.nn.sigmoid(s)
        return (p * (1.0 - p))[:, None]
