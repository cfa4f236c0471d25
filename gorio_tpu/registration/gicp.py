"""Batched GICP-family registration: FastGICP / FastAPDGICP equivalents.

Counterpart of `fast_apdgicp/include/fast_gicp/gicp/impl/
fast_gicp_impl.hpp` and `fast_apdgicp_impl.hpp` (SURVEY.md §2 #18/#19) and of
the CUDA pipeline (#21): kNN covariance estimation, per-iteration 1-NN
correspondences, APD polar measurement covariance, fused Mahalanobis +
residual + H/b reduction — all as masked batched array ops feeding the shared
LM driver in `lsq.py`.

Everything is jittable; `vmap` the top-level aligners over pairs to batch
(e.g. loop-closure candidate verification).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import lie
from ..core.pointcloud import PointCloud
from .knn import knn, nn1, nn1_select
from .lsq import LMConfig, LMResult, lm_optimize


class GICPConfig(NamedTuple):
    k_correspondences: int = 20  # `fast_apdgicp_impl.hpp:21`
    # `reg_max_correspondence_distance` (registrations.cpp:44, default 2.5):
    # the nodelets ALWAYS gate correspondences — with no gate, source points
    # in non-overlapping regions (structure entering/leaving the radar wedge)
    # acquire arbitrary far NNs whose Mahalanobis residuals drag the solve
    # into divergence (observed: 8-44 m errors from a truth initial guess)
    max_correspondence_distance: float = 2.5
    # APD polar covariance parameters (`fast_apdgicp.hpp:116-118` defaults,
    # launch files set dist_var=0.86, az=0.5 deg, el=1.0 deg)
    dist_var: float = 0.86
    azimuth_var_deg: float = 0.5
    elevation_var_deg: float = 1.0
    plane_eps: float = 1e-3  # PLANE regularization smallest eigenvalue
    lm: LMConfig = LMConfig()
    mode: str = "apdgicp"  # "gicp" | "apdgicp" | "icp"
    # neighborhood covariance estimator: "knn" (FastGICP
    # `calculate_covariances`) or "rbf" (FastVGICPCuda GPU_RBF_KERNEL,
    # `covariance_estimation_rbf.cu`); "icp" mode forces identity covariances
    # (plain point-to-point ICP, `registrations.cpp:48-56`)
    covariance_method: str = "knn"
    rbf_kernel_width: float = 0.25  # `fast_vgicp_cuda.cu:25`
    rbf_max_dist: float = 3.0  # `fast_vgicp_cuda.cu:26`


def knn_covariances(xyz, mask, k: int = 20, plane_eps: float = 1e-3, block: int = 512):
    """Per-point neighborhood covariances with PLANE regularization.

    Parity with `calculate_covariances` (`fast_apdgicp_impl.hpp:351-411`):
    kNN -> covariance -> spectrum clamped to (1, 1, eps) in the eigenbasis.
    Uses the closed-form symmetric 3x3 eigendecomposition instead of the
    iterative `jnp.linalg.svd` lowering.
    Returns (N, 3, 3)."""
    from ..core.linalg import sym_eigh3

    idx, _ = knn(xyz, xyz, k, ref_mask=mask, block=block)
    neigh = xyz[idx]  # (N, k, 3)
    mean = jnp.mean(neigh, axis=1, keepdims=True)
    centered = neigh - mean
    cov = jnp.einsum("nki,nkj->nij", centered, centered) / k
    lam, V = sym_eigh3(cov)  # ascending
    values = jnp.broadcast_to(jnp.array([plane_eps, 1.0, 1.0], xyz.dtype), lam.shape)
    reg = jnp.einsum("nij,nj,nkj->nik", V, values, V)
    # geo weight: normalized smallest eigenvalue of the raw cov
    # (`fast_apdgicp_impl.hpp:266-269`)
    geo_w = jnp.maximum(lam[:, 0], 0.0) / jnp.maximum(lam[:, 2], 1e-30)
    return reg, geo_w


def apd_polar_cov(pts, dist_var, azimuth_var_deg, elevation_var_deg):
    """Range-dependent polar measurement covariance (the "APD" in APDGICP).

    Parity with `fast_apdgicp_impl.hpp:193-210`: scale
    s = (d*dist_var/400, d*sin(az), d*sin(el)) rotated into the ray frame by
    R = Rz(azimuth) Ry(elevation). pts (..., 3) -> (..., 3, 3)."""
    d = jnp.linalg.norm(pts, axis=-1)
    s_x = d * dist_var / 400.0
    s_y = d * jnp.sin(jnp.deg2rad(azimuth_var_deg))
    s_z = d * jnp.sin(jnp.deg2rad(elevation_var_deg))
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    elevation = jnp.arctan2(jnp.sqrt(x * x + y * y), z)
    azimuth = jnp.arctan2(y, x)
    cy, sy = jnp.cos(azimuth), jnp.sin(azimuth)
    cp, sp = jnp.cos(elevation), jnp.sin(elevation)
    # R = Rz(azimuth) @ Ry(elevation)
    Rz = jnp.stack(
        [
            jnp.stack([cy, -sy, jnp.zeros_like(cy)], -1),
            jnp.stack([sy, cy, jnp.zeros_like(cy)], -1),
            jnp.stack([jnp.zeros_like(cy), jnp.zeros_like(cy), jnp.ones_like(cy)], -1),
        ],
        -2,
    )
    Ry = jnp.stack(
        [
            jnp.stack([cp, jnp.zeros_like(cp), sp], -1),
            jnp.stack([jnp.zeros_like(cp), jnp.ones_like(cp), jnp.zeros_like(cp)], -1),
            jnp.stack([-sp, jnp.zeros_like(cp), cp], -1),
        ],
        -2,
    )
    R = Rz @ Ry
    A = R * jnp.stack([s_x, s_y, s_z], -1)[..., None, :]
    return A @ jnp.swapaxes(A, -1, -2)


def _inv3(M):
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


class GICPProblem(NamedTuple):
    """Precomputed per-pair state (covariances, weights, clusters)."""

    src_xyz: jax.Array
    src_mask: jax.Array
    src_cov: jax.Array  # (N, 3, 3)
    src_geo_w: jax.Array  # (N,)
    src_cluster: jax.Array
    tgt_xyz: jax.Array
    tgt_mask: jax.Array
    tgt_cov: jax.Array
    tgt_cluster: jax.Array


def rbf_regularized_covariances(xyz, mask, kernel_width, max_dist, plane_eps):
    """RBF-kernel covariances + the same PLANE spectral regularization the
    CUDA path applies afterwards (`covariance_regularization.cu`, called from
    `fast_vgicp_cuda.cu:205-218`). Returns (cov (N,3,3), geo_w (N,))."""
    from ..core.linalg import sym_eigh3
    from .knn import rbf_covariances

    _, cov, _ = rbf_covariances(xyz, mask, kernel_width, max_dist)
    lam, V = sym_eigh3(cov)
    values = jnp.broadcast_to(jnp.array([plane_eps, 1.0, 1.0], xyz.dtype), lam.shape)
    reg = jnp.einsum("nij,nj,nkj->nik", V, values, V)
    geo_w = jnp.maximum(lam[:, 0], 0.0) / jnp.maximum(lam[:, 2], 1e-30)
    return reg, geo_w


def _covariances(cloud: PointCloud, cfg):
    """Neighborhood covariances per the config's `covariance_method`. Shared
    by GICP and VGICP (duck-typed over GICPConfig/VGICPConfig)."""
    if getattr(cfg, "mode", "gicp") == "icp":
        eye = jnp.broadcast_to(
            jnp.eye(3, dtype=cloud.xyz.dtype), (cloud.xyz.shape[0], 3, 3)
        )
        return eye, jnp.zeros((cloud.xyz.shape[0],), cloud.xyz.dtype)
    if getattr(cfg, "covariance_method", "knn") == "rbf":
        return rbf_regularized_covariances(
            cloud.xyz, cloud.mask, cfg.rbf_kernel_width, cfg.rbf_max_dist, cfg.plane_eps
        )
    return knn_covariances(cloud.xyz, cloud.mask, cfg.k_correspondences, cfg.plane_eps)


def prepare_gicp(source: PointCloud, target: PointCloud, cfg: GICPConfig) -> GICPProblem:
    src_cov, src_geo = _covariances(source, cfg)
    tgt_cov, _ = _covariances(target, cfg)
    return GICPProblem(
        src_xyz=source.xyz,
        src_mask=source.mask,
        src_cov=src_cov,
        src_geo_w=src_geo,
        src_cluster=source.cluster,
        tgt_xyz=target.xyz,
        tgt_mask=target.mask,
        tgt_cov=tgt_cov,
        tgt_cluster=target.cluster,
    )


def _correspondences(prob: GICPProblem, T, cfg: GICPConfig, n_total: int | None = None):
    """1-NN + Mahalanobis; parity with `update_correspondences`
    (`fast_apdgicp_impl.hpp:160-220`).

    `n_total` overrides the cluster-bonus denominator (the full source
    capacity) when `prob` holds only a shard of the source points
    (parallel/sharded.py) — keeps sharded weights identical to
    single-device."""
    R = T[:3, :3]
    t = T[:3, 3]
    moved = prob.src_xyz @ R.T + t
    idx, sqd = nn1(moved, prob.tgt_xyz, ref_mask=prob.tgt_mask)
    ok = (
        prob.src_mask
        & (sqd < cfg.max_correspondence_distance**2)
        & prob.tgt_mask[idx]
    )
    cov_A = prob.src_cov
    cov_B = prob.tgt_cov[idx]
    if cfg.mode == "apdgicp":
        cov_d = apd_polar_cov(moved, cfg.dist_var, cfg.azimuth_var_deg, cfg.elevation_var_deg)
        cov_A = cov_A + cov_d
        cov_B = cov_B + cov_d
    RCR = cov_B + R @ cov_A @ R.T  # (N, 3, 3) via broadcasting
    mah = _inv3(RCR)
    # weights (`fast_apdgicp_impl.hpp:264-276`): 1 + geo + cluster bonus —
    # APDGICP only; plain FastGICP/ICP cost is unweighted
    if cfg.mode == "apdgicp":
        cl_w = jnp.where(
            (prob.tgt_cluster[idx] == prob.src_cluster) & (prob.src_cluster >= 0.0),
            1.0 / (n_total if n_total is not None else prob.src_xyz.shape[0]),
            0.0,
        )
        w = 1.0 + prob.src_geo_w + cl_w
    else:
        w = jnp.ones_like(prob.src_geo_w)
    return idx, ok, mah, w, moved


def _error_terms(prob: GICPProblem, T, idx, ok, mah, w):
    R = T[:3, :3]
    t = T[:3, 3]
    moved = prob.src_xyz @ R.T + t
    err = prob.tgt_xyz[idx] - moved  # (N, 3)
    m_err = jnp.einsum("nij,nj->ni", mah, err)
    cost = jnp.sum(jnp.where(ok, w * jnp.einsum("ni,ni->n", err, m_err), 0.0))
    return moved, err, m_err, cost


def _sym6(M):
    """(..., 3, 3) symmetric matrix -> components (xx, yy, zz, xy, xz, yz)."""
    return (M[..., 0, 0], M[..., 1, 1], M[..., 2, 2],
            M[..., 0, 1], M[..., 0, 2], M[..., 1, 2])


def _apd_cov6(pts, dist_var, azimuth_var_deg, elevation_var_deg):
    """`apd_polar_cov` in component form (xx, yy, zz, xy, xz, yz) — closed-form
    R diag(s^2) R^T with R = Rz(az) Ry(el); no (N,3,3) intermediates."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    d = jnp.sqrt(x * x + y * y + z * z)
    s1 = (d * dist_var / 400.0) ** 2
    s2 = (d * jnp.sin(jnp.deg2rad(azimuth_var_deg))) ** 2
    s3 = (d * jnp.sin(jnp.deg2rad(elevation_var_deg))) ** 2
    elevation = jnp.arctan2(jnp.sqrt(x * x + y * y), z)
    azimuth = jnp.arctan2(y, x)
    cy, sy = jnp.cos(azimuth), jnp.sin(azimuth)
    cp, sp = jnp.cos(elevation), jnp.sin(elevation)
    cy2, sy2, cp2, sp2 = cy * cy, sy * sy, cp * cp, sp * sp
    xx = s1 * cy2 * cp2 + s2 * sy2 + s3 * cy2 * sp2
    yy = s1 * sy2 * cp2 + s2 * cy2 + s3 * sy2 * sp2
    zz = s1 * sp2 + s3 * cp2
    xy = cy * sy * (s1 * cp2 + s3 * sp2 - s2)
    xz = cy * cp * sp * (s3 - s1)
    yz = sy * cp * sp * (s3 - s1)
    return xx, yy, zz, xy, xz, yz


def _sym_inv6(c):
    """Closed-form inverse of a symmetric 3x3 given/returning 6 components."""
    a, d, f, b, cc, e = c[0], c[1], c[2], c[3], c[4], c[5]  # xx yy zz xy xz yz
    A0 = d * f - e * e
    A1 = cc * e - b * f
    A2 = b * e - cc * d
    det = a * A0 + b * A1 + cc * A2
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
    return (A0 * inv_det, (a * f - cc * cc) * inv_det, (a * d - b * b) * inv_det,
            A1 * inv_det, A2 * inv_det, (b * cc - a * e) * inv_det)


def _mah33(c):
    """6 components -> (..., 3, 3) symmetric matrix."""
    a, d, f, b, cc, e = c
    row0 = jnp.stack([a, b, cc], -1)
    row1 = jnp.stack([b, d, e], -1)
    row2 = jnp.stack([cc, e, f], -1)
    return jnp.stack([row0, row1, row2], -2)


def make_gicp_callbacks(prob: GICPProblem, cfg: GICPConfig):
    """Build (linearize, compute_error) for `lm_optimize`.

    Parity with `FastAPDGICP::linearize` / `compute_error`
    (`fast_apdgicp_impl.hpp:224-346`); note the reference weights the *cost*
    with (1+geo+cl) but not H/b — reproduced here.

    The linearize epilogue (APD covariance, (C_B + R C_A R^T)^-1 Mahalanobis,
    per-point H/b) is written in closed COMPONENT form on (N,) columns,
    reduced by one (C, N) x (N,) matvec, instead of stacking, transposing and
    contracting (N,3,3) blocks; the math itself is ~100 flops/point.
    Equality with the straightforward form is pinned by
    tests/test_registration.py::test_component_linearize_matches_reference."""

    tcov6 = _sym6(prob.tgt_cov)  # componentized once per problem
    scov6 = _sym6(prob.src_cov)
    gate2 = cfg.max_correspondence_distance ** 2
    # target payload rows picked with the NN search (one row gather instead
    # of one gather per field): [xyz, cov6, cluster, mask]
    payload = jnp.concatenate(
        [prob.tgt_xyz] + [c[:, None] for c in tcov6]
        + [prob.tgt_cluster.astype(prob.tgt_xyz.dtype)[:, None],
           prob.tgt_mask.astype(prob.tgt_xyz.dtype)[:, None]], axis=1,
    )

    def linearize(T):
        dtype = T.dtype
        R = T[:3, :3]
        t = T[:3, 3]
        moved = prob.src_xyz @ R.T + t
        idx, sqd, sel = nn1_select(moved, prob.tgt_xyz, payload,
                                   ref_mask=prob.tgt_mask)
        ok = prob.src_mask & (sqd < gate2) & (sel[:, 10] > 0.5)
        okf = ok.astype(dtype)

        A6 = [scov6[k] for k in range(6)]
        B6 = [sel[:, 3 + k] for k in range(6)]
        if cfg.mode == "apdgicp":
            cd = _apd_cov6(moved, cfg.dist_var, cfg.azimuth_var_deg,
                           cfg.elevation_var_deg)
            A6 = [A6[k] + cd[k] for k in range(6)]
            B6 = [B6[k] + cd[k] for k in range(6)]
            cl_w = jnp.where(
                (sel[:, 9] == prob.src_cluster) & (prob.src_cluster >= 0.0),
                1.0 / prob.src_xyz.shape[0], 0.0,
            )
            w = 1.0 + prob.src_geo_w + cl_w
        else:
            w = jnp.ones_like(prob.src_geo_w)

        # RCR = B + R A R^T, unrolled over the symmetric components
        Af = [[A6[0], A6[3], A6[4]], [A6[3], A6[1], A6[5]], [A6[4], A6[5], A6[2]]]
        Bf = [[B6[0], B6[3], B6[4]], [B6[3], B6[1], B6[5]], [B6[4], B6[5], B6[2]]]
        RA = [[sum(R[i, j] * Af[j][k] for j in range(3)) for k in range(3)]
              for i in range(3)]
        def rcr(i, l):
            return Bf[i][l] + sum(RA[i][k] * R[l, k] for k in range(3))
        m = _sym_inv6((rcr(0, 0), rcr(1, 1), rcr(2, 2),
                       rcr(0, 1), rcr(0, 2), rcr(1, 2)))
        m_xx, m_yy, m_zz, m_xy, m_xz, m_yz = m
        M0 = (m_xx, m_xy, m_xz)
        M1 = (m_xy, m_yy, m_yz)
        M2 = (m_xz, m_yz, m_zz)

        ex = sel[:, 0] - moved[:, 0]
        ey = sel[:, 1] - moved[:, 1]
        ez = sel[:, 2] - moved[:, 2]
        me = tuple(Mi[0] * ex + Mi[1] * ey + Mi[2] * ez for Mi in (M0, M1, M2))
        cost_col = w * (ex * me[0] + ey * me[1] + ez * me[2])

        px, py, pz = moved[:, 0], moved[:, 1], moved[:, 2]
        # G = sk(p)^T M rows: G[i] = sk[:,i] . M columns (M symmetric)
        G = [tuple(pz * M1[k] - py * M2[k] for k in range(3)),
             tuple(px * M2[k] - pz * M0[k] for k in range(3)),
             tuple(py * M0[k] - px * M1[k] for k in range(3))]
        # v_j = M @ sk[:, j] == G[j] by symmetry of M (sk^T M = (M sk)^T rows)
        # H_rr[i][j] = sk[:, i] . v_j
        def skdot(i, v):
            if i == 0:
                return pz * v[1] - py * v[2]
            if i == 1:
                return px * v[2] - pz * v[0]
            return py * v[0] - px * v[1]
        Hrr = [[skdot(i, G[j]) for j in range(3)] for i in range(3)]
        br = [skdot(i, me) for i in range(3)]

        # one (C, N) @ (N,) matvec reduces every accumulator at once
        cols = jnp.stack(
            [Hrr[0][0], Hrr[1][1], Hrr[2][2], Hrr[0][1], Hrr[0][2], Hrr[1][2]]
            + [G[i][k] for i in range(3) for k in range(3)]  # -H_rt
            + [m_xx, m_yy, m_zz, m_xy, m_xz, m_yz]  # H_tt
            + br + [me[0], me[1], me[2], cost_col], axis=0,
        )
        s = jax.lax.dot_general(cols, okf, (((1,), (0,)), ((), ())))
        Hrr_m = jnp.stack([jnp.stack([s[0], s[3], s[4]]),
                           jnp.stack([s[3], s[1], s[5]]),
                           jnp.stack([s[4], s[5], s[2]])])
        Hrt_m = -s[6:15].reshape(3, 3)
        Htt_m = jnp.stack([jnp.stack([s[15], s[18], s[19]]),
                           jnp.stack([s[18], s[16], s[20]]),
                           jnp.stack([s[19], s[20], s[17]])])
        H = jnp.block([[Hrr_m, Hrt_m], [Hrt_m.T, Htt_m]])
        b = jnp.concatenate([s[21:24], -s[24:27]])
        cost = s[27]
        aux = (idx, ok, _mah33(m), w)
        return cost, H, b, aux

    def compute_error(T, aux):
        idx, ok, mah, w = aux
        _, _, _, cost = _error_terms(prob, T, idx, ok, mah, w)
        return cost

    return linearize, compute_error


def _gicp_normal_equations(moved, mah, m_err, ok):
    """H (6,6), b (6,) summed over the valid correspondences, straightforward
    (N,3,3) form. J (3x6) rows: d(err)/d[d_rot, d_trans] = [skew(moved), -I];
    H = sum J^T M J."""
    sk = lie.hat(moved)  # (N, 3, 3)
    okf = ok.astype(moved.dtype)
    MS = mah @ sk  # (N, 3, 3) = M @ skew
    H_rr = jnp.einsum("nji,njk,n->ik", sk, MS, okf)
    H_rt = -jnp.einsum("nji,njk,n->ik", sk, mah, okf)
    H_tt = jnp.einsum("nij,n->ij", mah, okf)
    H = jnp.block([[H_rr, H_rt], [H_rt.T, H_tt]])
    b = jnp.concatenate([jnp.einsum("nji,nj,n->i", sk, m_err, okf),
                         -jnp.einsum("ni,n->i", m_err, okf)])
    return H, b


def make_gicp_callbacks_reference(prob: GICPProblem, cfg: GICPConfig):
    """The straightforward (N,3,3) einsum formulation — kept as the equality
    reference for the component-form fast path above."""

    def linearize(T):
        idx, ok, mah, w, _ = _correspondences(prob, T, cfg)
        moved, err, m_err, cost = _error_terms(prob, T, idx, ok, mah, w)
        H, b = _gicp_normal_equations(moved, mah, m_err, ok)
        aux = (idx, ok, mah, w)
        return cost, H, b, aux

    def compute_error(T, aux):
        idx, ok, mah, w = aux
        _, _, _, cost = _error_terms(prob, T, idx, ok, mah, w)
        return cost

    return linearize, compute_error


@partial(jax.jit, static_argnames=("cfg",))
def _gicp_align_jit(source, target, init_T, cfg: GICPConfig) -> LMResult:
    prob = prepare_gicp(source, target, cfg)
    linearize, compute_error = make_gicp_callbacks(prob, cfg)
    return lm_optimize(linearize, compute_error, init_T, cfg.lm)


def gicp_align(
    source: PointCloud,
    target: PointCloud,
    init_T=None,
    cfg: GICPConfig = GICPConfig(),
) -> LMResult:
    """Full APDGICP/GICP alignment source -> target. Returns T mapping source
    points into the target frame. Jitted (an un-jitted eager lax.while_loop
    re-compiles on every call — 3.5 s/align instead of ~10 ms)."""
    if init_T is None:
        init_T = jnp.eye(4, dtype=source.xyz.dtype)
    return _gicp_align_jit(source, target, init_T, cfg)


def fitness_score(source: PointCloud, target: PointCloud, T, max_range: float = 1.0):
    """Mean squared NN distance of inliers; parity with
    `pcl::Registration::getFitnessScore` as used by the loop detector and
    `InformationMatrixCalculator::calc_fitness_score`
    (`information_matrix_calculator.cpp:55-86`)."""
    moved = source.xyz @ T[:3, :3].T + T[:3, 3]
    _, sqd = nn1(moved, target.xyz, ref_mask=target.mask)
    ok = source.mask & (sqd < max_range * max_range)
    n = jnp.maximum(jnp.sum(ok), 1)
    return jnp.sum(jnp.where(ok, sqd, 0.0)) / n, n
