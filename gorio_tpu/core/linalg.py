"""Closed-form small-matrix linear algebra, batched.

Closed-form replacements for `jnp.linalg.{eigh, svd, inv}` on 3x3 blocks:
the LAPACK-style iterative lowerings compile slowly and run as loops, while the covariance-shaping steps of GICP/VGICP/NDT/ground-seg only need a
decent spectral basis of symmetric 3x3 matrices. These are the analytic
(trigonometric) eigenvalues plus cross-product eigenvectors, with guarded
fallbacks for (near-)degenerate spectra.
"""

from __future__ import annotations

import jax.numpy as jnp


def inv3(M):
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
    adj = jnp.stack(
        [
            jnp.stack([A, -(b * i - c * h), (b * f - c * e)], -1),
            jnp.stack([B, (a * i - c * g), -(a * f - c * d)], -1),
            jnp.stack([C, -(a * h - b * g), (a * e - b * d)], -1),
        ],
        -2,
    )
    return adj * inv_det[..., None, None]


def sym_eigvals3(A):
    """Eigenvalues of symmetric (..., 3, 3), ascending (..., 3). Analytic
    (Smith's trigonometric method)."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    eye = jnp.eye(3, dtype=A.dtype)
    B = A - q[..., None, None] * eye
    p2 = jnp.sum(B * B, axis=(-1, -2)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    detB = (
        B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
        - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
        + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0])
    )
    r = jnp.clip(detB / (2.0 * p * p * p), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    big = q + 2.0 * p * jnp.cos(phi)
    small = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    mid = 3.0 * q - big - small
    iso = p2 < 1e-24
    lam = jnp.stack(
        [jnp.where(iso, q, small), jnp.where(iso, q, mid), jnp.where(iso, q, big)],
        axis=-1,
    )
    return lam


def _eigvec_for(A, lam_this, lam_a, lam_b, scale):
    """Eigenvector of symmetric A for eigenvalue lam_this: the columns of
    (A - lam_a I)(A - lam_b I) span it; pick the largest. `scale` is the
    spectral scale of A — the validity threshold must be *relative* (column
    norms ~ gap_a * gap_b), otherwise float error in a degenerate pair
    masquerades as a valid direction."""
    eye = jnp.eye(3, dtype=A.dtype)
    M = (A - lam_a[..., None, None] * eye) @ (A - lam_b[..., None, None] * eye)
    norms = jnp.linalg.norm(M, axis=-2)  # column norms (..., 3)
    best = jnp.argmax(norms, axis=-1)
    v = jnp.take_along_axis(M, best[..., None, None].repeat(3, axis=-2), axis=-1)[..., 0]
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    ok = n[..., 0] > 1e-6 * scale * scale
    v = jnp.where(ok[..., None], v / jnp.maximum(n, 1e-30), 0.0)
    return v, ok


def _perp(v, dtype):
    """Any unit vector orthogonal to unit v (branch-free)."""
    ex = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], dtype), v.shape)
    ey = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0], dtype), v.shape)
    a = jnp.cross(v, ex)
    an = jnp.linalg.norm(a, axis=-1, keepdims=True)
    b = jnp.cross(v, ey)
    bn = jnp.linalg.norm(b, axis=-1, keepdims=True)
    return jnp.where(
        an > 0.1, a / jnp.maximum(an, 1e-30), b / jnp.maximum(bn, 1e-30)
    )


def sym_eigh3(A):
    """Symmetric 3x3 eigendecomposition: (evals ascending (..., 3),
    evecs (..., 3, 3) with evecs[..., :, k] the k-th eigenvector).

    Degenerate guard: a repeated eigenvalue pair collapses one cross-product
    eigenvector; the basis is then completed from the well-defined one (any
    orthonormal completion spans the degenerate eigenspace)."""
    dtype = A.dtype
    lam = sym_eigvals3(A)
    l0, l1, l2 = lam[..., 0], lam[..., 1], lam[..., 2]
    scale = jnp.maximum(jnp.max(jnp.abs(lam), axis=-1), 1e-30)
    v2c, ok2 = _eigvec_for(A, l2, l0, l1, scale)  # largest; fails when l1 ~ l2
    v0c, ok0 = _eigvec_for(A, l0, l1, l2, scale)  # smallest; fails when l0 ~ l1
    ez = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], dtype), v2c.shape)
    # v2: direct, else orthogonal to a reliable v0, else arbitrary (isotropic)
    v2 = jnp.where(
        ok2[..., None], v2c, jnp.where(ok0[..., None], _perp(v0c, dtype), ez)
    )
    # v0: direct, else any vector orthogonal to v2
    v0 = jnp.where(ok0[..., None], v0c, _perp(v2, dtype))
    # re-orthogonalize v0 against v2 and normalize (guards the near-degenerate
    # middle ground); fall back to a perpendicular if it collapses
    v0 = v0 - jnp.sum(v0 * v2, axis=-1, keepdims=True) * v2
    n0 = jnp.linalg.norm(v0, axis=-1, keepdims=True)
    v0 = jnp.where(n0 > 1e-6, v0 / jnp.maximum(n0, 1e-30), _perp(v2, dtype))
    v1 = jnp.cross(v2, v0)
    return lam, jnp.stack([v0, v1, v2], axis=-1)
