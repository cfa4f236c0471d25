"""Shared Gauss-Newton / Levenberg-Marquardt SE(3) least-squares driver.

Counterpart of `fast_gicp`'s `LsqRegistration`
(`fast_apdgicp/include/fast_gicp/gicp/impl/lsq_registration_impl.hpp:55-173`):
the same adaptive-lambda LM with inner retry iterations and rot/trans epsilon
convergence, expressed as bounded `lax.while_loop`s so one compiled program
serves every (source, target) pair and `vmap`s across pairs.

The cost callbacks follow the reference split:
  linearize(T)        -> (y0, H, b, aux)   # rebuilds correspondences
  compute_error(T, aux) -> y               # reuses aux (corr + mahalanobis)
and the update is left-multiplicative with the reference's
[exp(d_rot), d_trans] (NOT full SE(3) exp) delta (`:140-142`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..core import lie


class LMConfig(NamedTuple):
    """Defaults mirror `lsq_registration_impl.hpp:11-22`."""

    max_iterations: int = 64
    lm_max_iterations: int = 10
    rotation_epsilon: float = 2e-3
    transformation_epsilon: float = 5e-4
    lm_init_lambda_factor: float = 1e-9


class LMResult(NamedTuple):
    T: jax.Array  # (4, 4) final transform
    H: jax.Array  # (6, 6) final Hessian (J^T W J)
    error: jax.Array  # () final cost
    converged: jax.Array  # () bool
    iterations: jax.Array  # () int


def _is_converged(delta_T, cfg: LMConfig):
    """Parity with `lsq_registration_impl.hpp:83-92`."""
    R = delta_T[:3, :3] - jnp.eye(3, dtype=delta_T.dtype)
    t = delta_T[:3, 3]
    r_delta = jnp.max(jnp.abs(R)) / cfg.rotation_epsilon
    t_delta = jnp.max(jnp.abs(t)) / cfg.transformation_epsilon
    return jnp.maximum(r_delta, t_delta) < 1.0


def lm_optimize(
    linearize: Callable,
    compute_error: Callable,
    T0,
    cfg: LMConfig = LMConfig(),
) -> LMResult:
    dtype = T0.dtype
    eye6 = jnp.eye(6, dtype=dtype)

    def solve_delta(H, b, lam):
        d = jnp.linalg.solve(H + lam * eye6, -b)
        return lie.se3_exp_split(d), d

    def lm_step(T, lam, H_final):
        y0, H, b, aux = linearize(T)

        lam0 = jnp.where(
            lam < 0.0, cfg.lm_init_lambda_factor * jnp.max(jnp.abs(jnp.diag(H))), lam
        )

        def inner_cond(s):
            i, lam_i, nu, done, _, _, _, _ = s
            return (~done) & (i < cfg.lm_max_iterations)

        def inner_body(s):
            i, lam_i, nu, done, T_acc, delta_acc, ok, conv_rej = s
            delta_T, d = solve_delta(H, b, lam_i)
            T_new = delta_T @ T
            yi = compute_error(T_new, aux)
            rho = (y0 - yi) / (d @ (lam_i * d - b))
            accept = rho >= 0.0
            # a rejected-but-tiny step means we are at the optimum
            # (`lsq_registration_impl.hpp:156-159` returns success there)
            conv_on_reject = (~accept) & _is_converged(delta_T, cfg)
            lam_next = jnp.where(
                accept,
                lam_i * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
                lam_i * nu,
            )
            nu_next = jnp.where(accept, 2.0, nu * 2.0)
            stop = accept | conv_on_reject
            return (
                i + 1,
                lam_next,
                nu_next,
                stop,
                jnp.where(accept, T_new, T_acc),
                jnp.where(accept, delta_T, delta_acc),
                ok | accept,
                conv_rej | conv_on_reject,
            )

        init = (
            jnp.array(0),
            lam0,
            jnp.asarray(2.0, dtype),
            jnp.array(False),
            T,
            jnp.eye(4, dtype=dtype),
            jnp.array(False),
            jnp.array(False),
        )
        _, lam_out, _, _, T_out, delta_out, accepted, conv_rej = jax.lax.while_loop(
            inner_cond, inner_body, init
        )
        H_out = jnp.where(accepted | conv_rej, H, H_final)
        return T_out, lam_out, delta_out, accepted, conv_rej, H_out, y0

    def outer_cond(s):
        i, T, lam, conv, failed, H_final, _ = s
        return (i < cfg.max_iterations) & (~conv) & (~failed)

    def outer_body(s):
        i, T, lam, conv, failed, H_final, err = s
        T_new, lam_new, delta, accepted, conv_rej, H_new, y0 = lm_step(T, lam, H_final)
        conv_new = (accepted & _is_converged(delta, cfg)) | conv_rej
        return (i + 1, T_new, lam_new, conv_new, ~(accepted | conv_rej), H_new, y0)

    init = (
        jnp.array(0),
        T0,
        jnp.asarray(-1.0, dtype),
        jnp.array(False),
        jnp.array(False),
        jnp.eye(6, dtype=dtype),
        jnp.asarray(jnp.inf, dtype),
    )
    iters, T, lam, conv, failed, H_final, err = jax.lax.while_loop(
        outer_cond, outer_body, init
    )
    return LMResult(T=T, H=H_final, error=err, converged=conv, iterations=iters)


def gn_optimize(linearize: Callable, T0, iterations: int = 8) -> LMResult:
    """Plain Gauss-Newton (`lsq_registration_impl.hpp:107-123`), fixed
    iteration count — the fastest choice when the prior is good (scan-to-scan
    with the ego-velocity motion guess)."""
    dtype = T0.dtype

    def body(T, _):
        y0, H, b, _aux = linearize(T)
        d = jnp.linalg.solve(H + 1e-9 * jnp.eye(6, dtype=dtype), -b)
        T_new = lie.se3_exp_split(d) @ T
        return T_new, (y0, H)

    T, (ys, Hs) = jax.lax.scan(body, T0, None, length=iterations)
    return LMResult(
        T=T,
        H=Hs[-1],
        error=ys[-1],
        converged=jnp.array(True),
        iterations=jnp.asarray(iterations),
    )
