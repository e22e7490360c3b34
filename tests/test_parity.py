"""Validate the closed-form parity blocks (gp/parity.py) against a literal
nested-autodiff re-implementation of the reference's biased operators
(reference models/GP.py:28-179: frozen-subset Hutchinson Laplacian + the
coordinate-roll quirk), and the parity train path end to end."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scasml_gp.config import GPConfig
from scasml_gp.equations.grad_dependent import GradDependentNonlinear
from scasml_gp.gp.parity import (
    DIV,
    DT,
    ID,
    LAPS,
    make_parity_posterior,
    parity_block,
    parity_factorization,
    parity_gram_matrix,
    subset_indices,
)
from scasml_gp.gp.solver import GPGradDependentNonlinear

D = 7
SUBSET = subset_indices(D, 3)
GAMMA = 0.9


# --- literal reference semantics (models/GP.py:28-179), per point pair -----

def kappa(x_t, y_t):
    return jnp.exp(-GAMMA / 2.0 * jnp.sum((x_t - y_t) ** 2))


def laplacian_op(f):
    """models/GP.py:28-39 with the frozen subset made explicit."""
    idx_set = jnp.asarray(SUBSET)

    def hvp(x, i):
        return jax.grad(lambda z: jax.grad(f)(z)[i])(x)

    def laplacian(x):
        vals = jnp.stack([hvp(x, i)[i] for i in SUBSET])
        return jnp.mean(vals) * D

    return laplacian


def dt_x(x_t, y_t):
    return jax.grad(kappa, argnums=0)(x_t, y_t)[-1]


def dt_y(x_t, y_t):
    return jax.grad(kappa, argnums=1)(x_t, y_t)[-1]


def div_x(x_t, y_t):
    return jnp.sum(jax.grad(kappa, argnums=0)(x_t, y_t)[:-1])


def div_y(x_t, y_t):
    return jnp.sum(jax.grad(kappa, argnums=1)(x_t, y_t)[:-1])


def lap_y(x_t, y_t):
    """models/GP.py:100-108: splits y_t[0] off as 'time' (the roll quirk)."""
    t_y = y_t[0:1]
    y = y_t[1:]
    return laplacian_op(lambda yy: kappa(x_t, jnp.concatenate((yy, t_y))))(y)


def lap_x(x_t, y_t):
    t_x = x_t[0:1]
    x = x_t[1:]
    return laplacian_op(lambda xx: kappa(jnp.concatenate((xx, t_x)), y_t))(x)


def lap_x_of(fn):
    """LAPS_x composed around an (x_t, y_t) function (models/GP.py:152-180)."""

    def block(x_t, y_t):
        t_x = x_t[0:1]
        x = x_t[1:]
        return laplacian_op(
            lambda xx: fn(jnp.concatenate((xx, t_x)), y_t)
        )(x)

    return block


def lap_y_of(fn):
    def block(x_t, y_t):
        t_y = y_t[0:1]
        y = y_t[1:]
        return laplacian_op(
            lambda yy: fn(x_t, jnp.concatenate((yy, t_y)))
        )(y)

    return block


REF_BLOCKS = {
    (ID, ID): kappa,
    (ID, DT): dt_y,
    (DT, ID): dt_x,
    (ID, DIV): div_y,
    (DIV, ID): div_x,
    (ID, LAPS): lap_y,
    (LAPS, ID): lap_x,
    (DT, DT): lambda x, y: jax.grad(dt_x, argnums=1)(x, y)[-1],
    (DT, DIV): lambda x, y: jnp.sum(jax.grad(dt_x, argnums=1)(x, y)[:-1]),
    (DIV, DT): lambda x, y: jax.grad(div_x, argnums=1)(x, y)[-1],
    (DIV, DIV): lambda x, y: jnp.sum(jax.grad(div_x, argnums=1)(x, y)[:-1]),
    (DT, LAPS): lap_y_of(dt_x),
    (DIV, LAPS): lap_y_of(div_x),
    (LAPS, DT): lap_x_of(dt_y),
    (LAPS, DIV): lap_x_of(div_y),
    (LAPS, LAPS): lap_x_of(lap_y),
}


@pytest.fixture(scope="module")
def pts():
    kx, ky = jax.random.split(jax.random.PRNGKey(3))
    x = jax.random.uniform(kx, (4, D + 1), minval=-0.5, maxval=0.5)
    y = jax.random.uniform(ky, (3, D + 1), minval=-0.5, maxval=0.5)
    return x, y


@pytest.mark.parametrize("key", sorted(REF_BLOCKS, key=str))
def test_parity_block_matches_reference_autodiff(pts, key):
    x, y = pts
    ref_fn = REF_BLOCKS[key]
    ref = jax.vmap(
        lambda xi: jax.vmap(lambda yj: ref_fn(xi, yj))(y)
    )(x)
    ours = parity_block(key[0], key[1], x, y, GAMMA, SUBSET, D)
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=2e-4,
                               atol=1e-5)


def test_parity_gradient_cross_kernel(pts):
    """grad_x of each y-family (reference dx_t_kernel_x_t_phi,
    models/GP.py:296-323) via the parity posterior with one-hot weights."""
    x, y = pts
    x_bdy = y[:2]
    n_dom = y.shape[0]
    fams = [
        ("dom_id", kappa, 0),
        ("bdy_id", kappa, n_dom),
        ("lap", lap_y, n_dom + 2),
        ("dt", dt_y, 2 * n_dom + 2),
        ("div", div_y, 3 * n_dom + 2),
    ]
    posterior = make_parity_posterior(SUBSET)
    phi_dim = 4 * n_dom + 2
    for name, fn, offset in fams:
        src = x_bdy if name == "bdy_id" else y
        for j in range(src.shape[0]):
            r = jnp.zeros((phi_dim,)).at[offset + j].set(1.0)
            out = posterior(x, y, x_bdy, r, GAMMA, D, want_grad=True)
            ref_val = jax.vmap(lambda xi: fn(xi, src[j]))(x)
            ref_grad = jax.vmap(
                lambda xi: jax.grad(fn, argnums=0)(xi, src[j])
            )(x)
            np.testing.assert_allclose(
                np.asarray(out.u), np.asarray(ref_val), rtol=2e-4, atol=1e-5,
                err_msg=f"u for family {name}",
            )
            np.testing.assert_allclose(
                np.asarray(out.grad), np.asarray(ref_grad), rtol=2e-4,
                atol=1e-5, err_msg=f"grad for family {name}",
            )


def test_parity_ops_cross_kernels(pts):
    """DT/DIV/LAPS applied on the x side of every family (reference
    laplacian/dt/div_x_t_kernel_x_t_phi, models/GP.py:326-411)."""
    x, y = pts
    x_bdy = y[:2]
    n_dom = y.shape[0]
    posterior = make_parity_posterior(SUBSET)
    phi_dim = 4 * n_dom + 2

    # one-hot on the LAP family column j=1 — the hardest composition (K33)
    j = 1
    r = jnp.zeros((phi_dim,)).at[n_dom + 2 + j].set(1.0)
    out = posterior(x, y, x_bdy, r, GAMMA, D, want_ops=True)
    ref_dt = jax.vmap(lambda xi: lap_y_of(dt_x)(xi, y[j]))(x)
    # dt_x_t_laplacian_y(x, y) vs our dt_u row: our DT row uses
    # parity_block(DT, LAPS) == reference dt_x_t_laplacian_y_t ✓
    np.testing.assert_allclose(np.asarray(out.dt_u), np.asarray(ref_dt),
                               rtol=2e-4, atol=1e-5)
    ref_div = jax.vmap(lambda xi: lap_y_of(div_x)(xi, y[j]))(x)
    np.testing.assert_allclose(np.asarray(out.div_u), np.asarray(ref_div),
                               rtol=2e-4, atol=1e-5)
    ref_lap = jax.vmap(lambda xi: lap_x_of(lap_y)(xi, y[j]))(x)
    np.testing.assert_allclose(np.asarray(out.lap_u), np.asarray(ref_lap),
                               rtol=2e-4, atol=1e-5)


def test_parity_gram_symmetric(pts):
    x, y = pts
    K = parity_gram_matrix(x, y, GAMMA, SUBSET, D)
    np.testing.assert_allclose(np.asarray(K), np.asarray(K.T), rtol=0,
                               atol=1e-5)


def test_parity_factorization_inverse(pts):
    x, y = pts
    K = parity_gram_matrix(x, y, GAMMA, SUBSET, D)
    K_pert, C = parity_factorization(K, 1e-2)
    np.testing.assert_allclose(C @ K_pert, np.eye(K.shape[0]), atol=5e-4)


@pytest.mark.parametrize("fp16", [False, True])
def test_parity_train_end_to_end(fp16):
    eq = GradDependentNonlinear(n_input=D + 1)
    cfg = GPConfig(laplacian="subset", laplacian_subset_size=3,
                   parity_fp16=fp16, gn_steps=6)
    gp = GPGradDependentNonlinear(eq, cfg)
    key = jax.random.PRNGKey(0)
    x_dom, x_bdy = eq.generate_data(120, 40, key=key)
    gp.GPsolver(x_dom, x_bdy)
    xt, _ = eq.generate_test_data(80, 20, key=jax.random.PRNGKey(1))
    pred = gp.predict(xt)
    exact = eq.exact_solution(xt)[:, 0]
    assert np.all(np.isfinite(np.asarray(pred)))
    rel = float(
        jnp.linalg.norm(pred[:, 0] - exact) / jnp.linalg.norm(exact)
    )
    # biased-kernel GP on a small train set: just needs to be a real fit
    assert rel < 0.5, rel
    # gradient + residual paths run and are finite
    g = gp.compute_gradient(xt)
    eps = gp.compute_PDE_loss(xt)
    assert np.all(np.isfinite(np.asarray(g)))
    assert np.all(np.isfinite(np.asarray(eps)))


def test_parity_rejects_non_isotropic():
    eq = GradDependentNonlinear(n_input=D + 1)
    with pytest.raises(ValueError, match="isotropic"):
        GPGradDependentNonlinear(
            eq, GPConfig(laplacian="subset", ridge_scale=1.0)
        )
