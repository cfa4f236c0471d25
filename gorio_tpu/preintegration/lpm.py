"""LPM (linear preintegration model): gyro + ego-velocity -> PreintMeas.

Counterpart of `ugpm::IterativeIntegrator`
(`4DRadarSLAM/include/VelInt/preint.h:170-742`). The reference builds a
dynamically sorted timeline and integrates rotation/position sequentially with
numeric Jacobians (5 extra full integrations). Here:

  * the timeline is a static uniform grid (`grid_n` points, caller picks the
    frequency; reference inserts fake samples at `min_freq` = 500 Hz),
  * SO(3) integration is a `jax.lax.associative_scan` of 3x3 matrix products
    (log depth instead of a serial loop),
  * the rotation covariance recurrence Sigma' = A Sigma A^T + B Q B^T is the
    same associative scan over affine pairs (A, C),
  * all bias/time-shift Jacobians come from one `jax.jacfwd` through the whole
    integrator (exact, replacing the reference's finite differences with
    delta = 0.01 / 1e-4),
  * queries at arbitrary times compose the prefix at the bracketing grid cell
    with an exact partial step, so query times need not live on the grid.

Everything is jittable and `vmap`s over windows — the reference solves one
window at a time; we batch windows (SURVEY.md §7.4).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import lie
from ..core.gp import linear_interp
from .types import PreintMeas

_COV_MIN_DIAG = 1e-6  # parity: `preint.h:393-405` (minCovDiag)


def _rotation_prefix(w_grid, dt):
    """Prefix rotations R_k = prod_{i<k} exp(w_i dt) (left-endpoint rule,
    parity with `preint.h:421-470`). w_grid (N, 3) -> (N, 3, 3)."""
    steps = lie.so3_exp(w_grid[:-1] * dt)  # (N-1, 3, 3)
    prefix = jax.lax.associative_scan(lambda a, b: a @ b, steps)
    eye = jnp.eye(3, dtype=w_grid.dtype)[None]
    return jnp.concatenate([eye, prefix], axis=0)  # (N,)


def _cov_prefix(w_grid, dt, step_active, gyr_var):
    """Affine-recurrence scan for the rotation covariance
    (`preint.h:456-466`): Sigma_{k+1} = A Sigma A^T + B Q B^T with
    A = exp(w dt)^T, B = J_r(w dt) dt. Steps with step_active=0 contribute
    identity. Returns per-grid-point (A_prefix, C_prefix) applied from 0."""
    wdt = w_grid[:-1] * dt
    A = jnp.swapaxes(lie.so3_exp(wdt), -1, -2)
    B = lie.so3_right_jacobian(wdt) * dt
    C = gyr_var * (B @ jnp.swapaxes(B, -1, -2))
    eye = jnp.eye(3, dtype=w_grid.dtype)
    A = jnp.where(step_active[:, None, None], A, eye)
    C = jnp.where(step_active[:, None, None], C, jnp.zeros((3, 3), w_grid.dtype))

    def comb(first, second):
        A1, C1 = first
        A2, C2 = second
        return A2 @ A1, A2 @ C1 @ jnp.swapaxes(A2, -1, -2) + C2

    Ap, Cp = jax.lax.associative_scan(comb, (A, C))
    eye_b = jnp.broadcast_to(eye, (1, 3, 3))
    zero_b = jnp.zeros((1, 3, 3), w_grid.dtype)
    return (
        jnp.concatenate([eye_b, Ap], axis=0),
        jnp.concatenate([zero_b, Cp], axis=0),
    )


def _bracket(grid_t, t):
    n = grid_t.shape[0]
    j = jnp.clip(jnp.searchsorted(grid_t, t, side="right") - 1, 0, n - 2)
    return j


@partial(jax.jit, static_argnames=("grid_n", "with_jacobians"))
def lpm_preintegrate(
    gyr_t,
    gyr,
    vel_t,
    vel,
    start_t,
    query_t,
    gyr_var,
    vel_var,
    grid_n: int = 512,
    with_jacobians: bool = True,
) -> PreintMeas:
    """Preintegrate over [start_t, query_t[i]] for all queries at once.

    gyr_t (G,), gyr (G,3): angular-rate samples (bias prior already removed)
    vel_t (V,), vel (V,3): body-frame ego-velocity samples
    query_t (Q,): inference times (may precede start_t, as in chunk overlap)
    Returns a PreintMeas batched over Q.
    """
    dtype = gyr.dtype
    start_t = jnp.asarray(start_t, dtype)
    query_t = jnp.asarray(query_t, dtype)

    # Grid spans only [min(start, queries), max(start, queries)]; R_at/P_at
    # extrapolate one partial step beyond the edges, which covers the
    # bracketing measurement samples.
    t_lo = jnp.minimum(jnp.min(query_t), start_t)
    t_hi = jnp.maximum(jnp.max(query_t), start_t)
    span = jnp.maximum(t_hi - t_lo, 1e-6)
    grid_t = t_lo + span * jnp.arange(grid_n, dtype=dtype) / (grid_n - 1)
    dt = span / (grid_n - 1)

    def integrate(bw, bv, tau):
        """Full preintegration as a function of measurement offsets.

        Evaluating the streams at (t + tau) reproduces the reference's
        time-shift convention (`preint.h:333`: gyr_time - delta)."""
        w_grid = linear_interp(grid_t + tau, gyr_t, gyr) + bw  # (N, 3)
        R_pref = _rotation_prefix(w_grid, dt)  # (N, 3, 3)

        def R_at(t):
            j = _bracket(grid_t, t)
            w_j = w_grid[j]
            return R_pref[j] @ lie.so3_exp(w_j * (t - grid_t[j]))

        R_start = R_at(start_t)
        R_startT = R_start.T

        # --- rotation at queries, relative to start ---
        R_q = jax.vmap(R_at)(query_t)  # (Q, 3, 3)
        dR_q = R_startT[None] @ R_q

        # --- velocity reprojection at sample times (`preint.h:271-287`) ---
        # time shift acts on the data timeline: evaluate the stream at t + tau
        v_shifted = linear_interp(vel_t + tau, vel_t, vel) + bv
        dR_vel = jax.vmap(R_at)(vel_t)  # rotation of each sample time
        v_rot = jnp.einsum("nij,nj->ni", R_startT[None] @ dR_vel, v_shifted)

        # cumulative trapezoid over sample times
        seg = 0.5 * (v_rot[1:] + v_rot[:-1]) * (vel_t[1:] - vel_t[:-1])[:, None]
        cum = jnp.concatenate([jnp.zeros((1, 3), dtype), jnp.cumsum(seg, axis=0)], axis=0)

        def P_at(t):
            j = _bracket(vel_t, t)
            w = (t - vel_t[j]) / jnp.maximum(vel_t[j + 1] - vel_t[j], 1e-30)
            v_t = v_rot[j] + jnp.clip(w, -2.0, 2.0) * (v_rot[j + 1] - v_rot[j])
            return cum[j] + (t - vel_t[j]) * 0.5 * (v_rot[j] + v_t)

        P_q = jax.vmap(P_at)(query_t)
        P_0 = P_at(start_t)
        dp_q = P_q - P_0[None]
        return dR_q, dp_q

    zeros3 = jnp.zeros(3, dtype)
    dR_q, dp_q = integrate(zeros3, zeros3, jnp.zeros((), dtype))

    dts = query_t - start_t

    # --- covariance ---
    w_grid0 = linear_interp(grid_t, gyr_t, gyr)
    step_active = (grid_t[1:] > start_t) & (grid_t[1:] <= t_hi + 1e-12)
    Ap, Cp = _cov_prefix(w_grid0, dt, step_active, jnp.asarray(gyr_var, dtype))

    def rot_cov_at(t):
        j = _bracket(grid_t, t)
        # partial step from grid_t[j] to t
        frac = jnp.maximum(t - jnp.maximum(grid_t[j], start_t), 0.0)
        wdt = w_grid0[j] * frac
        A = lie.so3_exp(wdt).T
        B = lie.so3_right_jacobian(wdt) * frac
        Cs = gyr_var * (B @ B.T)
        return A @ Cp[j] @ A.T + Cs

    rot_cov_q = jax.vmap(rot_cov_at)(query_t)
    pos_var_q = jnp.maximum(dts, 0.0) * vel_var  # `preint.h:643`
    cov = jnp.zeros((query_t.shape[0], 6, 6), dtype)
    cov = cov.at[:, 0:3, 0:3].set(rot_cov_q)
    cov = cov.at[:, 3:6, 3:6].set(pos_var_q[:, None, None] * jnp.eye(3, dtype=dtype))
    diag = jnp.einsum("qii->qi", cov)
    cov = cov + jnp.einsum(
        "qi,ij->qij", jnp.maximum(_COV_MIN_DIAG - diag, 0.0), jnp.eye(6, dtype=dtype)
    ) * jnp.eye(6, dtype=dtype)

    if not with_jacobians:
        z33 = jnp.zeros((query_t.shape[0], 3, 3), dtype)
        z3 = jnp.zeros((query_t.shape[0], 3), dtype)
        return PreintMeas(dR_q, dp_q, dts, 0.5 * dts * dts, cov, z33, z3, z33, z33, z3)

    # --- Jacobians by forward-mode autodiff through the whole integrator ---
    dR0T = jnp.swapaxes(dR_q, -1, -2)

    def log_and_p(bw, bv, tau):
        dR, dp = integrate(bw, bv, tau)
        # right-trivialized rotation delta: log(dR0^T dR(eps)); exact at eps=0
        r = lie.so3_log(dR0T @ dR)
        return r, dp

    (d_r_bw, d_p_bw) = jax.jacfwd(log_and_p, argnums=0)(zeros3, zeros3, jnp.zeros((), dtype))
    (d_r_bv, d_p_bv) = jax.jacfwd(log_and_p, argnums=1)(zeros3, zeros3, jnp.zeros((), dtype))
    (d_r_t, d_p_t) = jax.jacfwd(log_and_p, argnums=2)(zeros3, zeros3, jnp.zeros((), dtype))
    del d_r_bv  # rotation does not depend on velocity offsets

    return PreintMeas(
        delta_R=dR_q,
        delta_p=dp_q,
        dt=dts,
        dt_sq_half=0.5 * dts * dts,
        cov=cov,
        d_delta_R_d_bw=d_r_bw,
        d_delta_R_d_t=d_r_t,
        d_delta_p_d_bw=d_p_bw,
        d_delta_p_d_bv=d_p_bv,
        d_delta_p_d_t=d_p_t,
    )
