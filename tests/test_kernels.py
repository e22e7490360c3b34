"""Validate every closed-form kernel derivative block against nested autodiff.

This is the unit-level check the reference only carries in comments
(models/GP.py:460-485): each analytic operator block must match the
corresponding jax.grad nesting applied to the base RBF, per point pair —
for both the isotropic (reference) kernel and the separable space/time
generalization (gs != gt).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scasml_gp.gp.kernels import (
    DIV,
    DT,
    ID,
    LAP,
    grad_coeffs,
    kernel_gamma,
    kernel_gammas,
    op_block,
    pair_stats,
    sq_dists,
)

DIM = 4
G_ISO = kernel_gamma(0.25, DIM)
G_SEP = kernel_gammas(0.25, DIM, time_scale=0.3)
G_RIDGE = kernel_gammas(0.25, DIM, time_scale=0.7, ridge_scale=8.0)
OPS = [ID, LAP, DT, DIV]
GAMMAS = [("iso", G_ISO), ("sep", G_SEP), ("ridge", G_RIDGE)]


def make_kappa(gamma):
    if np.isscalar(gamma):
        gs = gt = gamma
        gr = 0.0
    elif len(gamma) == 2:
        gs, gt = gamma
        gr = 0.0
    else:
        gs, gt, gr = gamma

    def kappa(x, y):
        d_sp = x[:-1] - y[:-1]
        d_t = x[-1] - y[-1]
        return jnp.exp(
            -0.5 * (gs * jnp.sum(d_sp**2)
                    + gr * jnp.sum(d_sp) ** 2
                    + gt * d_t**2)
        )

    return kappa


def apply_op(fun, op, argnum):
    """Apply ID / spatial-LAP / time-DT / spatial-DIV to argument `argnum`."""
    if op == ID:
        return fun
    if op == DT:
        def dt_fun(x, y):
            g = jax.grad(fun, argnums=argnum)(x, y)
            return g[-1]
        return dt_fun
    if op == DIV:
        def div_fun(x, y):
            g = jax.grad(fun, argnums=argnum)(x, y)
            return jnp.sum(g[:-1])
        return div_fun
    if op == LAP:
        def lap_fun(x, y):
            h = jax.hessian(fun, argnums=argnum)(x, y)
            return jnp.trace(h[:-1, :-1])
        return lap_fun
    raise ValueError(op)


@pytest.fixture(scope="module")
def points():
    key = jax.random.PRNGKey(0)
    kx, ky = jax.random.split(key)
    x = jax.random.uniform(kx, (5, DIM + 1), minval=-0.5, maxval=0.5)
    y = jax.random.uniform(ky, (6, DIM + 1), minval=-0.5, maxval=0.5)
    return x, y


@pytest.mark.parametrize("gname,gamma", GAMMAS)
@pytest.mark.parametrize("a", OPS)
@pytest.mark.parametrize("b", OPS)
def test_op_block_matches_autodiff(points, gname, gamma, a, b):
    x, y = points
    st = pair_stats(x, y, gamma)
    analytic = op_block(a, b, st, gamma, DIM)

    fun = apply_op(apply_op(make_kappa(gamma), b, 1), a, 0)
    expected = jax.vmap(
        lambda xi: jax.vmap(lambda yj: fun(xi, yj))(y)
    )(x)
    np.testing.assert_allclose(
        np.asarray(analytic), np.asarray(expected), rtol=2e-4, atol=2e-5
    )


@pytest.mark.parametrize("gname,gamma", GAMMAS)
@pytest.mark.parametrize("b", OPS)
def test_grad_coeffs_match_autodiff(points, gname, gamma, b):
    x, y = points
    st = pair_stats(x, y, gamma)
    co = grad_coeffs(b, st, gamma, DIM)

    fam = apply_op(make_kappa(gamma), b, 1)
    expected = jax.vmap(
        lambda xi: jax.vmap(lambda yj: jax.grad(fam, argnums=0)(xi, yj))(y)
    )(x)  # (n, m, DIM+1)

    delta = x[:, None, :] - y[None, :, :]
    sp_mask = jnp.concatenate([jnp.ones(DIM), jnp.zeros(1)])
    e_t = jnp.concatenate([jnp.zeros(DIM), jnp.ones(1)])
    analytic = (
        co.a_sp[..., None] * delta * sp_mask
        + (co.b_s * st.s)[..., None] * sp_mask
        + (co.a_t * st.dt)[..., None] * e_t
        + co.c[..., None] * sp_mask
        + co.e[..., None] * e_t
    )
    np.testing.assert_allclose(
        np.asarray(analytic), np.asarray(expected), rtol=2e-4, atol=2e-5
    )


def test_pair_stats_definitions(points):
    x, y = points
    st = pair_stats(x, y, G_ISO)
    delta = np.asarray(x)[:, None, :] - np.asarray(y)[None, :, :]
    np.testing.assert_allclose(
        np.asarray(st.dt), delta[..., -1], rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(st.s), delta[..., :-1].sum(-1), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(st.q), (delta[..., :-1] ** 2).sum(-1), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(st.kappa),
        np.exp(-0.5 * G_ISO * (delta**2).sum(-1)),
        rtol=1e-5,
        atol=1e-6,
    )


def test_separable_reduces_to_isotropic(points):
    x, y = points
    st_iso = pair_stats(x, y, G_ISO)
    st_sep = pair_stats(x, y, (G_ISO, G_ISO))
    np.testing.assert_allclose(
        np.asarray(st_iso.kappa), np.asarray(st_sep.kappa), rtol=1e-6
    )
    for a in OPS:
        for b in OPS:
            np.testing.assert_allclose(
                np.asarray(op_block(a, b, st_iso, G_ISO, DIM)),
                np.asarray(op_block(a, b, st_sep, (G_ISO, G_ISO), DIM)),
                rtol=1e-6, atol=1e-7,
            )


@pytest.mark.parametrize("spread", [1.0, 1e-2])
def test_sq_dists_matches_float64_differences(spread):
    """|x - y|^2 through the cancelling |x|^2 + |y|^2 - 2 x.y, also for
    points close together (spread 1e-2 around a common centre)."""
    k = jax.random.split(jax.random.PRNGKey(3), 2)
    x = 1.0 + spread * jax.random.normal(k[0], (32, 20))
    y = 1.0 + spread * jax.random.normal(k[1], (24, 20))
    got = np.asarray(sq_dists(x, y), np.float64)
    xd, yd = np.asarray(x, np.float64), np.asarray(y, np.float64)
    want = ((xd[:, None, :] - yd[None, :, :]) ** 2).sum(-1)
    scale = 2.0 * (xd**2).sum(1).max()  # the size of the cancelling terms
    assert got.min() >= 0.0
    assert np.max(np.abs(got - want)) <= 1e-6 * scale
