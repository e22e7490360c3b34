"""Config-driven experiment runner.

Replaces the reference's eight near-identical driver scripts
(``results*/Grad_Dependent_Nonlinear/{20,40,60,80}d/experiment_run.py`` —
verified by diff to vary only in n_input/paths/solver classes; SURVEY.md §2
D1) with one CLI:

    python -m scasml_gp.harness.runner --dim 20 --variant quadrature \
        --harness SimpleUniform --save-path results

or programmatically via :func:`run(config)`.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from scasml_gp.config import RunConfig
from scasml_gp.equations import EQUATIONS
from scasml_gp.gp.cole_hopf import GPHJBColeHopf
from scasml_gp.gp.semigroup import GPAllenCahnSemigroup
from scasml_gp.gp.solver import (
    GPGradDependentNonlinear,
    GPSineNonlinear,
)
from scasml_gp.harness.computing_budget import ComputingBudget
from scasml_gp.harness.convergence_rate import ConvergenceRate
from scasml_gp.harness.inference_scaling import InferenceScaling
from scasml_gp.harness.repeated import RepeatedExperiment
from scasml_gp.harness.simple_scaling import SimpleScaling
from scasml_gp.harness.simple_uniform import SimpleUniform
from scasml_gp.picard.mlp import MLP, MLPFullHistory
from scasml_gp.picard.scasml import ScaSML, ScaSMLFullHistory

HARNESSES = {
    "SimpleUniform": SimpleUniform,
    "RepeatedExperiment": RepeatedExperiment,
    "ConvergenceRate": ConvergenceRate,
    "InferenceScaling": InferenceScaling,
    "SimpleScaling": SimpleScaling,
    "ComputingBudget": ComputingBudget,
}

GP_CLASSES = {
    "GradDependentNonlinear": GPGradDependentNonlinear,
    # round 5: the space-time collocation GPAllenCahn is ill-posed for this
    # terminal-value problem (rel-L2 0.86-1.23 — worse than predicting
    # zero; attribution in reports/allen_cahn_attribution.md).  The
    # reaction-semigroup surrogate replaces it as the Allen-Cahn default
    # (rel-L2 0.007 at d=20 / 0.002 at d=100, within MC-oracle noise).
    "AllenCahn": GPAllenCahnSemigroup,
    "HJB": GPHJBColeHopf,
    "SineNonlinear": GPSineNonlinear,
}


def build_solvers(config: RunConfig):
    """(equation, gp, mlp, scasml) per the config's PDE/dim/variant.

    A non-trivial ``config.mesh`` builds the 2-D ('data', 'model') device
    mesh and hands it to every solver: GP training points go sharded over
    'model' (GSPMD distributes the Gram tiles), rollout batches over 'data'.
    ``config.precision`` sets the bf16-operand Gram / bf16 path-storage
    policy (VERDICT.md Next-round #3)."""
    eq_cls = EQUATIONS[config.equation]
    eq = eq_cls(n_input=config.n_input)
    mesh = None
    if config.mesh.data * config.mesh.model > 1 or config.mesh.data == -1:
        from scasml_gp.parallel.mesh import make_mesh

        mesh = make_mesh(config.mesh.data, config.mesh.model)
    gp = GP_CLASSES[config.equation](
        eq, config.gp, precision=config.precision, mesh=mesh
    )
    chunk = config.picard.batch_chunk
    kw = dict(batch_chunk=chunk, precision=config.precision, mesh=mesh,
              debug_checks=config.picard.debug_checks)
    if config.picard.variant == "full_history":
        mlp = MLPFullHistory(eq, **kw)
        scasml = ScaSMLFullHistory(eq, gp, **kw)
    else:
        mlp = MLP(eq, **kw)
        scasml = ScaSML(eq, gp, **kw)
    return eq, gp, mlp, scasml


def run(config: RunConfig, solvers=None, **test_kwargs):
    """Execute one run of the config's harness.  ``solvers`` is the
    (eq, gp, mlp, scasml) of :func:`build_solvers`, built here when not
    given; a caller that passes them keeps the trained surrogate."""
    eq, gp, mlp, scasml = solvers or build_solvers(config)
    harness_cls = HARNESSES[config.harness]
    harness = harness_cls(eq, gp, mlp, scasml, wandb=config.wandb)
    # variant-level directory mirrors the reference's results/ vs
    # results_full_history/ split
    save_path = (
        f"{config.save_path}/{config.equation}/{config.dim}d/"
        f"{config.picard.variant}"
    )
    kwargs = dict(seed=config.seed)
    if config.harness in ("SimpleUniform", "RepeatedExperiment"):
        kwargs.update(
            rhomax=config.picard.rho,
            num_domain=config.test_domain,
            num_boundary=config.test_boundary,
            train_domain=config.num_domain,
            train_boundary=config.num_boundary,
        )
    if config.picard.variant == "full_history" and config.harness not in (
        "SimpleScaling",
    ):
        kwargs["M"] = config.picard.M
    kwargs.update(test_kwargs)
    return harness.test(save_path, **kwargs)


def resolve_tune(tune_flag, ridge_scale, time_scale, fit_ml, equation):
    """Auto-tune policy for the CLI (VERDICT round-2 #2): flagless runs tune
    — the winning kernel is the default.  An explicit kernel flag
    (--ridge-scale/--time-scale), --no-tune, --fit-ml, or an equation
    without a standard GPConfig-driven surrogate (HJB's Cole-Hopf GP has
    its own width/prior selection, gp/cole_hopf.py) opts out."""
    if tune_flag is not None:
        return tune_flag
    explicit_kernel = ridge_scale != 0.0 or time_scale != 1.0
    # AllenCahn's semigroup surrogate (gp/semigroup.py) has its own
    # terminal-fit selection, like HJB's Cole-Hopf GP — no GPConfig grid.
    return (
        not explicit_kernel
        and not fit_ml
        and equation in ("GradDependentNonlinear", "SineNonlinear")
    )


def configure(argv=None):
    """(RunConfig, run kwargs) for the command line ``argv``: the config
    file or flags, with the kernel tuned first when the flags ask for it
    (flagless runs of the standard GP equations do)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", help="JSON RunConfig file")
    parser.add_argument("--equation", default="GradDependentNonlinear")
    parser.add_argument("--dim", type=int, default=20)
    parser.add_argument("--variant", default="quadrature",
                        choices=["quadrature", "full_history"])
    parser.add_argument("--harness", default="SimpleUniform",
                        choices=sorted(HARNESSES))
    parser.add_argument("--save-path", default="results")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--num-domain", type=int, default=1000,
                        help="GP training interior points (large values "
                             "auto-select the distributed row-sharded "
                             "trainer, gp/distributed.py)")
    parser.add_argument("--num-boundary", type=int, default=200,
                        help="GP training boundary points")
    parser.add_argument("--test-domain", type=int, default=1000)
    parser.add_argument("--test-boundary", type=int, default=200)
    parser.add_argument("--train-backend", default="auto",
                        choices=["auto", "dense", "distributed"],
                        help="GP trainer: dense inverse-based Newton, "
                             "distributed dual-CG Gauss-Newton, or auto by "
                             "problem size (GPConfig.dense_phi_max)")
    parser.add_argument("--rho", type=int, default=2)
    parser.add_argument("--M", type=int, default=3)
    parser.add_argument("--batch-chunk", type=int, default=None)
    parser.add_argument("--debug-checks", action="store_true",
                        help="instrument the rollouts with checkify float "
                             "checks: a non-finite value raises a localized "
                             "error instead of propagating to the NaN mask")
    parser.add_argument("--mesh-data", type=int, default=1,
                        help="devices on the 'data' mesh axis (batch/MC "
                             "sharding); -1 = all remaining devices")
    parser.add_argument("--mesh-model", type=int, default=1,
                        help="devices on the 'model' mesh axis (Gram-row "
                             "sharding)")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 precision policy: bf16-operand Gram "
                             "matmuls + bf16 rollout path storage (fp32 "
                             "accumulation everywhere)")
    parser.add_argument("--wandb", action="store_true",
                        help="stream metrics to wandb (no-op if unavailable)")
    parser.add_argument("--profile-dir", default=None,
                        help="dump a cProfile .prof + XLA trace of the solve "
                             "phase into this directory")
    parser.add_argument("--ridge-scale", type=float, default=0.0,
                        help="ridge kernel precision multiplier (0 = reference kernel)")
    parser.add_argument("--time-scale", type=float, default=1.0)
    parser.add_argument("--tune", dest="tune", action="store_true",
                        default=None,
                        help="select (ridge_scale, gamma_scale) by held-out "
                             "collocation validation before the run.  This is "
                             "the DEFAULT for the standard GP equations "
                             "(VERDICT round-2 #2: the tuned kernel beats the "
                             "reference at every d and costs seconds); pass "
                             "--no-tune or an explicit --ridge-scale/"
                             "--time-scale for raw reference-parity "
                             "hyperparameters")
    parser.add_argument("--no-tune", dest="tune", action="store_false",
                        help="disable the default hyperparameter tuning")
    parser.add_argument("--fit-ml", action="store_true",
                        help="fit (gamma_scale, time_scale, ridge_scale, nugget) "
                             "by batched marginal-likelihood descent on-device "
                             "(gp/marginal.py) before the run")
    args = parser.parse_args(argv)

    if args.config:
        if args.tune or args.fit_ml:
            parser.error("--tune/--fit-ml are CLI-path options; with "
                         "--config, set the GP hyperparameters in the JSON")
        with open(args.config) as fh:
            config = RunConfig.from_json(fh.read())
    else:
        config = RunConfig(
            equation=args.equation,
            dim=args.dim,
            harness=args.harness,
            save_path=args.save_path,
            seed=args.seed,
            wandb=args.wandb,
            num_domain=args.num_domain,
            num_boundary=args.num_boundary,
            test_domain=args.test_domain,
            test_boundary=args.test_boundary,
        )
        from scasml_gp.config import MeshConfig, PrecisionPolicy

        config = dataclasses.replace(
            config,
            gp=dataclasses.replace(
                config.gp, ridge_scale=args.ridge_scale,
                time_scale=args.time_scale,
                train_backend=args.train_backend,
            ),
            picard=dataclasses.replace(
                config.picard, variant=args.variant, rho=args.rho, M=args.M,
                batch_chunk=args.batch_chunk,
                debug_checks=args.debug_checks,
            ),
            mesh=MeshConfig(data=args.mesh_data, model=args.mesh_model),
            precision=(
                PrecisionPolicy(gram="bfloat16", rollout="bfloat16")
                if args.bf16 else PrecisionPolicy()
            ),
        )
        do_tune = resolve_tune(
            args.tune, args.ridge_scale, args.time_scale, args.fit_ml,
            config.equation,
        )
        if do_tune or args.fit_ml:
            import jax

            eq = EQUATIONS[config.equation](n_input=config.n_input)
            # Tuning trains once per grid candidate at the run's full size:
            # past dense_phi_max, tune_gp routes candidates through the
            # distributed dual-CG trainer (gamma/nugget are traced there
            # too, so the grid still shares one compiled program).
            x_dom, x_bdy = eq.generate_data(
                config.num_domain, config.num_boundary,
                key=jax.random.PRNGKey(config.seed),
            )
            if args.fit_ml:
                from scasml_gp.gp.marginal import fit_gp_marginal_likelihood
                from scasml_gp.gp.tuning import tune_gp

                if config.dim > 20:
                    print(
                        "warning: --fit-ml at d > 20 is a grid-seeded "
                        "REFINER, not a standalone fitter — the profile-MAP "
                        "NLML descent converges to over-smooth kernels at "
                        "high d and the validation guard falls back to the "
                        "grid winner (measured attribution: "
                        "reports/ml_tuner_diagnosis.md)",
                        file=sys.stderr,
                    )

                # Seed the ML restarts from the grid winner (and keep it in
                # the candidate table), so --fit-ml can never ship a config
                # that validates worse than the grid recommendation.
                grid = tune_gp(
                    GP_CLASSES[config.equation], eq, x_dom, x_bdy,
                    base=config.gp,
                    ridge_scales=(0.0, 10.0, 30.0, 100.0),
                )
                result = fit_gp_marginal_likelihood(
                    GP_CLASSES[config.equation], eq, x_dom, x_bdy,
                    base=config.gp,
                    seed_configs=(grid.config,),
                )
                print(f"ML-fitted GP config: {result.config} "
                      f"(NLML {result.nlml:.1f}; grid seed "
                      f"{grid.config.ridge_scale})", file=sys.stderr)
            else:
                from scasml_gp.gp.tuning import tune_gp

                # same 16-point (ridge, gamma) grid as the campaign runner:
                # ridge resolves the high-d mean direction, gamma_scale is
                # the big lever at low d; the compile-shared tuner makes
                # the grid seconds-cheap
                result = tune_gp(
                    GP_CLASSES[config.equation], eq, x_dom, x_bdy,
                    base=config.gp,
                    ridge_scales=(0.0, 10.0, 30.0, 100.0, 300.0),
                    gamma_scales=(1.0, 0.3, 0.1, 0.05),
                )
                print(f"tuned GP config: {result.config}", file=sys.stderr)
            config = dataclasses.replace(config, gp=result.config)
    extra = {"profile_dir": args.profile_dir} if args.profile_dir else {}
    return config, extra


def main(argv=None):
    config, extra = configure(argv)
    result = run(config, **extra)
    print("done:", config.harness, file=sys.stderr)
    return result


if __name__ == "__main__":
    main()
