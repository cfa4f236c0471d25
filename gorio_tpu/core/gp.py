"""Squared-exponential GP kernel and its analytic time-integrals, batched.

Counterpart of `4DRadarSLAM/include/VelInt/math_utils.h:102-186,378`
(seKernel / seKernelIntegral / seKernelIntegralDt / seKernelIntegral2 / kssInt).
All functions broadcast: `x1 (..., N)`, `x2 (..., M)` -> `(..., N, M)` and are
built from erf/exp so they fuse into a handful of VPU ops under XLA.

The kernels are the heart of the UGPM preintegration: velocity/rotation-rate
states live at `state_time`, and integrated quantities (rotation vector,
position) are linear functionals of the GP via these integrals.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.scipy.special import erf

_SQRT2 = math.sqrt(2.0)
_SQRTPI = math.sqrt(math.pi)


def se_kernel(x1, x2, l2, sf2):
    """k(x1, x2) = sf2 * exp(-(x1-x2)^2 / (2 l2)). Output (..., N, M)."""
    d = x1[..., :, None] - x2[..., None, :]
    return sf2 * jnp.exp(d * d * (-0.5 / l2))


def se_kernel_integral(a, b, x2, l2, sf2):
    """Integral of the SE kernel in its first argument from `a` to `b[i]`:

        K_int[i, j] = \\int_a^{b_i} k(s, x2_j) ds
                    = alpha * (erf(c(b_i - x2_j)) - erf(c(a - x2_j)))

    with c = sqrt(1/(2 l2)), alpha = sf2 * sqrt(pi l2 / 2) * sqrt(2).
    Output (..., N, M). Parity: `math_utils.h:114`."""
    inv_l = jnp.sqrt(1.0 / l2)
    alpha = _SQRT2 * sf2 * _SQRTPI / (2.0 * inv_l)
    c = _SQRT2 * inv_l / 2.0
    upper = erf(c * (b[..., :, None] - x2[..., None, :]))
    lower = erf(c * (a - x2))[..., None, :]
    return alpha * (upper - lower)


def se_kernel_integral_dt(a, b, x2, l2, sf2):
    """d/db of the double-argument integral used for time-shift Jacobians:

        K[i, j] = sf2 (exp(-(b_i - x2_j)^2/(2 l2)) - exp(-(a - x2_j)^2/(2 l2)))

    Parity: `math_utils.h:130`."""
    up = sf2 * jnp.exp(-((b[..., :, None] - x2[..., None, :]) ** 2) / (2.0 * l2))
    lo = (sf2 * jnp.exp(-((a - x2) ** 2) / (2.0 * l2)))[..., None, :]
    return up - lo


def se_kernel_integral2(a, b, x2, l2, sf2):
    """Double integral \\int_a^{b_i} \\int_a^{s} k(u, x2_j) du ds.

    Parity: `math_utils.h:145` (seKernelIntegral2)."""
    inv_l = jnp.sqrt(1.0 / l2)
    alpha = _SQRT2 * sf2 * _SQRTPI / (2.0 * inv_l)
    c = _SQRT2 * inv_l / 2.0

    a_x2 = a - x2  # (..., M)
    a_x2_erf = erf(c * a_x2)
    const = (_SQRT2 * jnp.exp(-(a_x2**2) / (2.0 * l2)) / (_SQRTPI * inv_l) + a_x2_erf * a_x2)[
        ..., None, :
    ]
    b_x2 = b[..., :, None] - x2[..., None, :]
    A = (
        a_x2_erf[..., None, :] * (a - b)[..., :, None]
        + erf(c * b_x2) * b_x2
        + _SQRT2 * jnp.exp(-(b_x2**2) / (2.0 * l2)) / (_SQRTPI * inv_l)
    )
    return alpha * (A - const)


def kss_int(a, b, l2, sf2):
    """Variance of the integrated GP: \\int_a^b \\int_a^b k(s, s') ds ds'.

    Parity: `math_utils.h:378` (kssInt). Scalar-in/scalar-out (broadcasts)."""
    d = a - b
    inv_l = jnp.sqrt(1.0 / l2)
    return (
        2.0 * l2 * sf2 * jnp.exp(-(d**2) / (2.0 * l2))
        - 2.0 * l2 * sf2
        + _SQRT2 * sf2 * _SQRTPI * erf(_SQRT2 * d * inv_l / 2.0) * d / inv_l
    )


def gp_fit_cholesky(K, sz2):
    """Cholesky factor of (K + sz2 I); returns `cho_factor`-style (L, lower)."""
    n = K.shape[-1]
    Kn = K + sz2 * jnp.eye(n, dtype=K.dtype)
    L = jnp.linalg.cholesky(Kn)
    return L


def cho_solve_lower(L, b):
    """Solve (L L^T) x = b for batched lower-triangular L."""
    y = jax.scipy.linalg.solve_triangular(L, b, lower=True)
    return jax.scipy.linalg.solve_triangular(L, y, lower=True, trans=1)


def gp_inv(K, sz2):
    """(K + sz2 I)^{-1} via Cholesky (batched). Mirrors `preint.h:836-837`,
    which forms the explicit inverse; we keep the explicit inverse because the
    UGPM inference reuses K_inv against many right-hand sides and query rows."""
    n = K.shape[-1]
    L = gp_fit_cholesky(K, sz2)
    return cho_solve_lower(L, jnp.eye(n, dtype=K.dtype))


def linear_interp(query_t, data_t, data, extrapolate=True):
    """Piecewise-linear interpolation of irregularly sampled data.

    query_t (..., Q), data_t (N,) sorted, data (N, D) or (N,) ->
    (..., Q, D) / (..., Q). Extrapolates with the boundary segments (the
    reference's `linearInterpolation` in `math_utils.h:487` keeps the last
    segment's slope; we match that behavior)."""
    squeeze = data.ndim == 1
    if squeeze:
        data = data[:, None]
    n = data_t.shape[0]
    idx = jnp.clip(jnp.searchsorted(data_t, query_t, side="right") - 1, 0, n - 2)
    t0 = data_t[idx]
    t1 = data_t[idx + 1]
    d0 = data[idx]
    d1 = data[idx + 1]
    w = ((query_t - t0) / jnp.maximum(t1 - t0, 1e-30))[..., None]
    if not extrapolate:
        w = jnp.clip(w, 0.0, 1.0)
    out = d0 + w * (d1 - d0)
    return out[..., 0] if squeeze else out
