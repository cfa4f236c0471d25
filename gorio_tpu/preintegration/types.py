"""Preintegrated-measurement containers; parity with `VelInt/types.h:236-311`."""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import lie


class PreintMeas(NamedTuple):
    """Preintegrated gyro + ego-velocity measurement over [start_t, t].

    Mirrors `ugpm::PreintMeas` (`types.h:236-282`):
      delta_R         (..., 3, 3)  rotation from start frame to t
      delta_p         (..., 3)     position change in the start frame
      dt              (...)        t - start_t
      dt_sq_half      (...)        dt^2 / 2
      cov             (..., 6, 6)  [rot, pos] covariance
      d_delta_R_d_bw  (..., 3, 3)  right-trivialized d(log dR)/d(gyro offset)
      d_delta_R_d_t   (..., 3)     ... /d(time shift)
      d_delta_p_d_bw  (..., 3, 3)
      d_delta_p_d_bv  (..., 3, 3)  d(dp)/d(velocity offset)
      d_delta_p_d_t   (..., 3)
    """

    delta_R: jax.Array
    delta_p: jax.Array
    dt: jax.Array
    dt_sq_half: jax.Array
    cov: jax.Array
    d_delta_R_d_bw: jax.Array
    d_delta_R_d_t: jax.Array
    d_delta_p_d_bw: jax.Array
    d_delta_p_d_bv: jax.Array
    d_delta_p_d_t: jax.Array


class PreintPrior(NamedTuple):
    """Bias priors subtracted from the raw streams (`types.h:292-298`)."""

    gyr_bias: jax.Array = np.zeros(3)
    vel_bias: jax.Array = np.zeros(3)


def add_bias_cov(meas: PreintMeas, vel_bias_std=0.3, gyr_bias_std=0.03) -> PreintMeas:
    """Inflate the covariance with bias uncertainty.

    Parity with `VelPreintegration::get` (`preint.h:1744-1757`): J maps
    [bw, bv] through the preintegration Jacobians."""
    dtype = meas.cov.dtype
    batch = meas.cov.shape[:-2]
    J = jnp.zeros(batch + (6, 6), dtype)
    J = J.at[..., 0:3, 0:3].set(jnp.eye(3, dtype=dtype))  # invJr(0) = I
    J = J.at[..., 3:6, 0:3].set(meas.d_delta_p_d_bw)
    J = J.at[..., 3:6, 3:6].set(meas.d_delta_p_d_bv)
    b_cov = jnp.zeros((6, 6), dtype)
    b_cov = b_cov.at[0:3, 0:3].set(jnp.eye(3, dtype=dtype) * gyr_bias_std**2)
    b_cov = b_cov.at[3:6, 3:6].set(jnp.eye(3, dtype=dtype) * vel_bias_std**2)
    return meas._replace(cov=meas.cov + J @ b_cov @ jnp.swapaxes(J, -1, -2))


def combine_preints(prev: PreintMeas, curr: PreintMeas) -> PreintMeas:
    """Combine two consecutive preintegration chunks (overlap-free part).

    Analytic first-order counterpart of `math_utils.h:689` (combinePreints),
    which builds the same maps numerically:
      R_c = R1 R2,  p_c = p1 + R1 p2
      right-trivialized rotation Jacobians:  D_c = R2^T D1 + D2
      position Jacobians: Dp_c = Dp1 + R1 Dp2 - R1 hat(p2) D1
      cov via J blkdiag(cov1, cov2) J^T with the perturbation model of
      `math_utils.h:540-572` (perturbationPropagation/propagatePreintCov).
    """
    R1, p1 = prev.delta_R, prev.delta_p
    R2, p2 = curr.delta_R, curr.delta_p
    R2T = jnp.swapaxes(R2, -1, -2)

    def comb_rotjac(D1, D2):
        return R2T @ D1 + D2

    def comb_posjac(Dp1, Dp2, D1):
        return Dp1 + R1 @ Dp2 - R1 @ lie.hat(p2) @ D1

    d_R_bw = comb_rotjac(prev.d_delta_R_d_bw, curr.d_delta_R_d_bw)
    d_R_t = (
        jnp.einsum("...ij,...j->...i", R2T, prev.d_delta_R_d_t) + curr.d_delta_R_d_t
    )
    d_p_bw = comb_posjac(prev.d_delta_p_d_bw, curr.d_delta_p_d_bw, prev.d_delta_R_d_bw)
    d_p_bv = prev.d_delta_p_d_bv + R1 @ curr.d_delta_p_d_bv
    d_p_t = (
        prev.d_delta_p_d_t
        + jnp.einsum("...ij,...j->...i", R1, curr.d_delta_p_d_t)
        - jnp.einsum(
            "...ij,...j->...i", R1 @ lie.hat(p2), prev.d_delta_R_d_t
        )
    )

    # covariance: eps = [eps_r1, eps_p1, eps_r2, eps_p2] (12,)
    dtype = prev.cov.dtype
    batch = jnp.broadcast_shapes(prev.cov.shape[:-2], curr.cov.shape[:-2])
    J = jnp.zeros(batch + (6, 12), dtype)
    eye3 = jnp.broadcast_to(jnp.eye(3, dtype=dtype), batch + (3, 3))
    J = J.at[..., 0:3, 0:3].set(R2T)
    J = J.at[..., 0:3, 6:9].set(eye3)
    J = J.at[..., 3:6, 0:3].set(-R1 @ lie.hat(p2))
    J = J.at[..., 3:6, 3:6].set(eye3)
    J = J.at[..., 3:6, 9:12].set(R1)
    cov12 = jnp.zeros(batch + (12, 12), dtype)
    cov12 = cov12.at[..., 0:6, 0:6].set(prev.cov)
    cov12 = cov12.at[..., 6:12, 6:12].set(curr.cov)
    cov = J @ cov12 @ jnp.swapaxes(J, -1, -2)

    dt = prev.dt + curr.dt
    return PreintMeas(
        delta_R=R1 @ R2,
        delta_p=p1 + jnp.einsum("...ij,...j->...i", R1, p2),
        dt=dt,
        dt_sq_half=0.5 * dt * dt,
        cov=cov,
        d_delta_R_d_bw=d_R_bw,
        d_delta_R_d_t=d_R_t,
        d_delta_p_d_bw=d_p_bw,
        d_delta_p_d_bv=d_p_bv,
        d_delta_p_d_t=d_p_t,
    )
