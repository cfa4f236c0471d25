"""Laplace posterior over the factor graph + graph log-density helpers."""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from ..graph.factors import GraphData, retract
from ..graph.solver import SolveResult, graph_chi2, laplace_covariance


def graph_logprob(poses0, graph: GraphData) -> Callable:
    """log p(delta) = -0.5 chi2(poses0 ⊞ delta) over stacked local coords
    (6K,). The density HMC/NUTS/SMC sample (BASELINE.json configs 3-5).

    Needs full-f32 matmuls (`utils/jax_config.configure_jax`): a TF32 matmul
    keeps ~3 digits, which corrupts the tiny 4x4 SE(3) chains inside the
    residuals, and HMC feels it harder than LM does — the leapfrog integrates
    the GRADIENT, so ~3-digit energy noise collapses acceptance."""
    K = poses0.shape[0]

    def logprob(delta):
        poses = jax.vmap(retract)(poses0, delta.reshape(K, 6))
        return -0.5 * graph_chi2(poses, graph)

    return logprob


def whitened_logprob(lp, H, jitter: float = 1e-6):
    """Laplace-whitened density: returns (lp_y, L) with y = L^T x and
    L = chol(H + jitter I), so the posterior curvature at the mode is ~I in
    y — the preconditioning HMC needs on pose-graph posteriors, whose raw
    local-coordinate scales span 1e-2 (anchored pose) to tens of meters
    (far-pose marginals). A DIAGONAL inverse-mass cannot fix the cross-pose
    correlations of a chain graph (measured r5: R-hat ~6 after 256 draws vs
    ~1.3 whitened on the same graph — see bench.py). The Cholesky runs on
    the host in float64: an f32 factor of a kappa~1e6 Hessian perturbs the
    whitened curvature enough to matter.

    Transform samples back with x = solve_triangular(L, y, lower, trans=1).
    """
    import numpy as np

    Hn = np.asarray(H, np.float64)
    Ln = np.linalg.cholesky(Hn + jitter * np.eye(Hn.shape[0]))
    L = jnp.asarray(Ln, jnp.asarray(H).dtype)

    def lp_y(y):
        x = jax.scipy.linalg.solve_triangular(L, y, lower=True, trans=1)
        return lp(x)

    return lp_y, L


def laplace_sample(key, result: SolveResult, n_samples: int):
    """Draw pose-perturbation samples from N(0, H^{-1})."""
    cov = laplace_covariance(result)
    L = jnp.linalg.cholesky(cov + 1e-12 * jnp.eye(cov.shape[0], dtype=cov.dtype))
    z = jax.random.normal(key, (n_samples, cov.shape[0]), cov.dtype)
    return z @ L.T
