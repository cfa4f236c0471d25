"""Typed pose-graph factors with batched residuals and autodiff Jacobians.

Counterpart of the reference's g2o layer: `GraphSLAM`'s 16
edge-adders (`src/radar_graph_slam/graph_slam.cpp:88-340`) and the custom edge
types in `include/g2o/*.hpp` (SURVEY.md §2 #9/#16). Instead of heap-allocated
edge objects, each factor family is a struct-of-arrays; residuals are `vmap`ed
and Jacobians come from `jacfwd` w.r.t. the two incident local perturbations.

State convention: pose k is T_k = (R_k, t_k); perturbations are
right-multiplicative with the [exp(rot), trans] split used across the
framework: T(delta) = T . [exp(d_rot), d_trans].
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import lie


def retract(T, delta):
    """T . [exp(d_rot), d_trans] — right-multiplicative local update."""
    return T @ lie.se3_exp_split(delta)


# ---------------------------------------------------------------------------
# Factor families (struct-of-arrays, padded with count)
# ---------------------------------------------------------------------------


class BetweenFactors(NamedTuple):
    """SE3-SE3 relative pose factors: odometry, GP-preintegration, loops.

    Parity: `g2o::EdgeSE3` via `GraphSLAM::add_se3_edge` (`graph_slam.cpp:125`).
    residual = log(meas^-1 T_i^-1 T_j) (6,)."""

    i: jax.Array  # (F,) int32
    j: jax.Array  # (F,)
    T_meas: jax.Array  # (F, 4, 4)
    sqrt_info: jax.Array  # (F, 6, 6)
    mask: jax.Array  # (F,) bool
    robust_delta: jax.Array  # (F,) Huber delta; inf = none

    @staticmethod
    def residual(T_i, T_j, T_meas):
        return lie.se3_log(lie.se3_inverse(T_meas) @ (lie.se3_inverse(T_i) @ T_j))


class PriorFactors(NamedTuple):
    """Unary SE3 priors (anchor): residual = log(meas^-1 T_i) (6,).

    Parity: anchor node/edge (`radar_graph_slam_nodelet.cpp:566-579`)."""

    i: jax.Array
    T_meas: jax.Array
    sqrt_info: jax.Array
    mask: jax.Array
    robust_delta: jax.Array

    @staticmethod
    def residual(T_i, T_meas):
        return lie.se3_log(lie.se3_inverse(T_meas) @ T_i)


class PointPriorFactors(NamedTuple):
    """Unary position priors with an axis mask — covers EdgeSE3PriorXYZ
    (GPS 3-dof, `edge_se3_priorxyz.hpp:35-46`: error = t - m), EdgeSE3PriorXY
    (2-dof, axis_mask=[1,1,0]) and EdgeSE3PriorZ ([0,0,1])."""

    i: jax.Array
    p_meas: jax.Array  # (F, 3)
    axis_mask: jax.Array  # (F, 3) 0/1
    sqrt_info: jax.Array  # (F, 3, 3)
    mask: jax.Array
    robust_delta: jax.Array

    @staticmethod
    def residual(T_i, p_meas, axis_mask):
        return (T_i[:3, 3] - p_meas) * axis_mask


class QuatPriorFactors(NamedTuple):
    """Unary orientation priors; parity with EdgeSE3PriorQuat
    (residual = log(R_meas^T R_i))."""

    i: jax.Array
    R_meas: jax.Array  # (F, 3, 3)
    sqrt_info: jax.Array  # (F, 3, 3)
    mask: jax.Array
    robust_delta: jax.Array

    @staticmethod
    def residual(T_i, R_meas):
        return lie.so3_log(jnp.swapaxes(R_meas, -1, -2) @ T_i[:3, :3])


class VecPriorFactors(NamedTuple):
    """Unary direction priors; parity with EdgeSE3PriorVec (a known world
    direction observed in the body frame, e.g. gravity from the IMU):
    residual = R_i^T dir_world - dir_meas (3,)."""

    i: jax.Array
    dir_world: jax.Array  # (F, 3)
    dir_meas: jax.Array  # (F, 3)
    sqrt_info: jax.Array  # (F, 3, 3)
    mask: jax.Array
    robust_delta: jax.Array

    @staticmethod
    def residual(T_i, dir_world, dir_meas):
        return jnp.einsum("ji,j->i", T_i[:3, :3], dir_world) - dir_meas


class GroundPlaneFactors(NamedTuple):
    """Unary ground-plane factors; parity with EdgeSE3Plane semantics with the
    global plane held fixed: the world plane (n_w, d_w) observed in the body
    frame (from `estimators.groundseg`) gives
    residual = [R_i^T n_w - n_meas ; (n_w . t_i + d_w) - d_meas] (4,)."""

    i: jax.Array
    plane_world: jax.Array  # (F, 4) [n_w, d_w]
    plane_meas: jax.Array  # (F, 4) measured in body frame
    sqrt_info: jax.Array  # (F, 4, 4)
    mask: jax.Array
    robust_delta: jax.Array

    @staticmethod
    def residual(T_i, plane_world, plane_meas):
        n_w, d_w = plane_world[:3], plane_world[3]
        r_n = jnp.einsum("ji,j->i", T_i[:3, :3], n_w) - plane_meas[:3]
        r_d = (n_w @ T_i[:3, 3] + d_w) - plane_meas[3]
        return jnp.concatenate([r_n, r_d[None]])


class GraphData(NamedTuple):
    """All factors of a pose graph (fixed shapes; masks mark live entries)."""

    between: BetweenFactors
    priors: PriorFactors
    point_priors: PointPriorFactors
    quat_priors: QuatPriorFactors
    vec_priors: "VecPriorFactors"
    plane_factors: "GroundPlaneFactors"


# ---------------------------------------------------------------------------
# Plane-vertex factor families (g2o::VertexPlane graphs)
# ---------------------------------------------------------------------------
#
# The reference registers five plane-vertex edge types plus the binary
# SE3-plane edge (`graph_slam.cpp:37-51`, `include/g2o/edge_plane_*.hpp`,
# `edge_se3_plane.hpp`). Here a plane variable is a homogeneous 4-vector
# [n, d] with |n| = 1 (the plane is n.x + d = 0); its local chart is 3-dof:
# 2 tangent directions of the unit normal + the offset — the fixed-shape
# equivalent of g2o's spherical-coordinate VertexPlane::oplus.


def plane_tangent_basis(n):
    """(3, 2) orthonormal basis of the tangent space of S^2 at n."""
    # pick the seed axis least aligned with n (branch-free)
    ez = jnp.asarray([0.0, 0.0, 1.0], n.dtype)
    ex = jnp.asarray([1.0, 0.0, 0.0], n.dtype)
    e = jnp.where(jnp.abs(n[2]) < 0.9, ez, ex)
    b1 = jnp.cross(n, e)
    b1 = b1 / jnp.maximum(jnp.linalg.norm(b1), 1e-12)
    b2 = jnp.cross(n, b1)
    return jnp.stack([b1, b2], axis=-1)


def retract_plane(plane, delta):
    """plane [n, d] (4,) + delta (3,) -> [normalize(n + B delta[:2]), d + delta[2]]."""
    n = plane[:3]
    B = plane_tangent_basis(n)
    n_new = n + B @ delta[:2]
    n_new = n_new / jnp.maximum(jnp.linalg.norm(n_new), 1e-12)
    return jnp.concatenate([n_new, (plane[3] + delta[2])[None]])


def transform_plane(T, plane_world):
    """World plane [n, d] expressed in the body frame of pose T (body->world):
    n_b = R^T n, d_b = d + n . t (from n.(R x_b + t) + d = 0)."""
    n, d = plane_world[:3], plane_world[3]
    n_b = jnp.einsum("ji,j->i", T[:3, :3], n)
    return jnp.concatenate([n_b, (d + n @ T[:3, 3])[None]])


class PlanePriorFactors(NamedTuple):
    """Unary priors on a plane vertex. Covers both EdgePlanePriorNormal
    (`edge_plane_prior.hpp:35-48`: error = sign-fixed normal - meas, 3-dof)
    and EdgePlanePriorDistance (`:75-83`: error = meas - distance, 1-dof) in
    one 4-dim residual; the builder zeroes the sqrt_info rows of the unused
    part."""

    i: jax.Array  # (F,) plane index
    n_meas: jax.Array  # (F, 3)
    d_meas: jax.Array  # (F,)
    sqrt_info: jax.Array  # (F, 4, 4)
    mask: jax.Array
    robust_delta: jax.Array

    @staticmethod
    def residual(plane_i, n_meas, d_meas):
        n = plane_i[:3]
        n = n * jnp.where(n @ n_meas < 0, -1.0, 1.0)
        return jnp.concatenate([n - n_meas, (plane_i[3] - d_meas)[None]])


class PlanePlaneFactors(NamedTuple):
    """Binary plane-plane constraints, selected per factor by `kind`:

    kind 0 = identity (`edge_plane_identity.hpp:47-59`): sign-fixed
             (p_j - p_i) - meas, 4-dof;
    kind 1 = parallel (`edge_plane_parallel.hpp:44-57`): sign-fixed
             (n_j - n_i) - meas[:3], 3-dof (row 3 zero);
    kind 2 = perpendicular (`:106-115`): n_i . n_j, 1-dof (rows 1-3 zero)."""

    i: jax.Array
    j: jax.Array
    kind: jax.Array  # (F,) int32
    meas: jax.Array  # (F, 4)
    sqrt_info: jax.Array  # (F, 4, 4)
    mask: jax.Array
    robust_delta: jax.Array

    @staticmethod
    def residual(plane_i, plane_j, kind, meas):
        dtype = plane_i.dtype
        zero = jnp.zeros((), dtype)

        def identity(pi, pj):
            pj = pj * jnp.where(pi @ pj < 0, -1.0, 1.0)
            return (pj - pi) - meas

        def parallel(pi, pj):
            ni, nj = pi[:3], pj[:3]
            nj = nj * jnp.where(ni @ nj < 0, -1.0, 1.0)
            return jnp.concatenate([(nj - ni) - meas[:3], zero[None]])

        def perpendicular(pi, pj):
            ni = pi[:3] / jnp.maximum(jnp.linalg.norm(pi[:3]), 1e-12)
            nj = pj[:3] / jnp.maximum(jnp.linalg.norm(pj[:3]), 1e-12)
            return jnp.concatenate([(ni @ nj)[None], jnp.zeros(3, dtype)])

        return jax.lax.switch(
            jnp.clip(kind, 0, 2), [identity, parallel, perpendicular], plane_i, plane_j
        )


class SE3PlaneFactors(NamedTuple):
    """Binary pose-plane factors: the world plane j observed from pose i.

    Parity: EdgeSE3Plane (`edge_se3_plane.hpp:40-47`,
    `GraphSLAM::add_se3_plane_edge` `graph_slam.cpp:110`): the local plane
    T_i^-1 * plane_j is compared with the body-frame measurement. g2o uses
    Plane3D::ominus (spherical-coordinate difference); here the equivalent
    3-dof chart residual is [B(n_meas)^T (n_b - n_meas), d_b - d_meas]."""

    i: jax.Array  # pose index
    j: jax.Array  # plane index
    plane_meas: jax.Array  # (F, 4) body-frame measurement [n, d]
    sqrt_info: jax.Array  # (F, 3, 3)
    mask: jax.Array
    robust_delta: jax.Array

    @staticmethod
    def residual(T_i, plane_j, plane_meas):
        local = transform_plane(T_i, plane_j)
        n_meas = plane_meas[:3]
        sign = jnp.where(local[:3] @ n_meas < 0, -1.0, 1.0)
        n_b, d_b = local[:3] * sign, local[3] * sign
        B = plane_tangent_basis(n_meas)
        r_n = B.T @ (n_b - n_meas)
        return jnp.concatenate([r_n, (d_b - plane_meas[3])[None]])


class ZBetweenFactors(NamedTuple):
    """Relative-altitude factors between two poses; parity with EdgeSE3Z
    (`edge_se3_z.hpp:44-50`: error = (z_j - z_i) - meas, 1-dof)."""

    i: jax.Array
    j: jax.Array
    z_meas: jax.Array  # (F,)
    sqrt_info: jax.Array  # (F, 1, 1)
    mask: jax.Array
    robust_delta: jax.Array

    @staticmethod
    def residual(T_i, T_j, z_meas):
        return (T_j[2, 3] - T_i[2, 3] - z_meas)[None]


class UTMAlignFactors(NamedTuple):
    """UTM->world alignment observations on a single transform vertex;
    parity with EdgeSE3GtUTM (`edge_se3_gt_utm.hpp:39-45`:
    error = (T_i * [p_utm, 1])[:3] - p_world), the factor behind the
    `gps_traj_align` tool."""

    i: jax.Array
    p_utm: jax.Array  # (F, 3)
    p_world: jax.Array  # (F, 3)
    sqrt_info: jax.Array  # (F, 3, 3)
    mask: jax.Array
    robust_delta: jax.Array

    @staticmethod
    def residual(T_i, p_utm, p_world):
        return T_i[:3, :3] @ p_utm + T_i[:3, 3] - p_world


class PlaneGraphData(NamedTuple):
    """Extension factor set for graphs with plane vertices (and the 1-dof /
    alignment SE3 edges); optimized jointly with `GraphData` by
    `solver.optimize_graph_with_planes`."""

    plane_priors: PlanePriorFactors
    plane_plane: PlanePlaneFactors
    se3_plane: SE3PlaneFactors
    z_between: ZBetweenFactors
    utm_align: UTMAlignFactors


def huber_weight(chi2, delta):
    """IRLS weight of the Huber kernel on the whitened residual norm
    (rho'(e) = 1 for e <= delta, delta/e beyond); factors with delta = inf are
    unweighted. Parity: `GraphSLAM::add_robust_kernel` + g2o robustification."""
    e = jnp.sqrt(jnp.maximum(chi2, 1e-30))
    # keep delta finite inside the division: inf/e in the non-selected branch
    # leaks NaN through `where` in reverse-mode autodiff
    delta_safe = jnp.where(jnp.isinf(delta), 1.0, delta)
    w = jnp.where(e <= delta, 1.0, delta_safe / e)
    return jnp.where(jnp.isinf(delta), 1.0, w)


def _empty_between(capacity, dtype, xp=jnp):
    return BetweenFactors(
        i=xp.zeros((capacity,), xp.int32),
        j=xp.zeros((capacity,), xp.int32),
        T_meas=xp.tile(xp.eye(4, dtype=dtype), (capacity, 1, 1)),
        sqrt_info=xp.tile(xp.eye(6, dtype=dtype), (capacity, 1, 1)),
        mask=xp.zeros((capacity,), bool),
        robust_delta=xp.full((capacity,), xp.inf, dtype),
    )


def _empty_priors(capacity, dtype, xp=jnp):
    return PriorFactors(
        i=xp.zeros((capacity,), xp.int32),
        T_meas=xp.tile(xp.eye(4, dtype=dtype), (capacity, 1, 1)),
        sqrt_info=xp.tile(xp.eye(6, dtype=dtype), (capacity, 1, 1)),
        mask=xp.zeros((capacity,), bool),
        robust_delta=xp.full((capacity,), xp.inf, dtype),
    )


def _empty_point_priors(capacity, dtype, xp=jnp):
    return PointPriorFactors(
        i=xp.zeros((capacity,), xp.int32),
        p_meas=xp.zeros((capacity, 3), dtype),
        axis_mask=xp.ones((capacity, 3), dtype),
        sqrt_info=xp.tile(xp.eye(3, dtype=dtype), (capacity, 1, 1)),
        mask=xp.zeros((capacity,), bool),
        robust_delta=xp.full((capacity,), xp.inf, dtype),
    )


def _empty_quat_priors(capacity, dtype, xp=jnp):
    return QuatPriorFactors(
        i=xp.zeros((capacity,), xp.int32),
        R_meas=xp.tile(xp.eye(3, dtype=dtype), (capacity, 1, 1)),
        sqrt_info=xp.tile(xp.eye(3, dtype=dtype), (capacity, 1, 1)),
        mask=xp.zeros((capacity,), bool),
        robust_delta=xp.full((capacity,), xp.inf, dtype),
    )


def _empty_vec_priors(capacity, dtype, xp=jnp):
    up = xp.asarray([0.0, 0.0, 1.0], dtype=dtype)
    return VecPriorFactors(
        i=xp.zeros((capacity,), xp.int32),
        dir_world=xp.tile(up, (capacity, 1)),
        dir_meas=xp.tile(up, (capacity, 1)),
        sqrt_info=xp.tile(xp.eye(3, dtype=dtype), (capacity, 1, 1)),
        mask=xp.zeros((capacity,), bool),
        robust_delta=xp.full((capacity,), xp.inf, dtype),
    )


def _empty_plane_factors(capacity, dtype, xp=jnp):
    up = xp.asarray([0.0, 0.0, 1.0, 0.0], dtype=dtype)
    return GroundPlaneFactors(
        i=xp.zeros((capacity,), xp.int32),
        # two separate buffers: with xp=np these are mutated in place
        plane_world=xp.tile(up, (capacity, 1)),
        plane_meas=xp.tile(up, (capacity, 1)),
        sqrt_info=xp.tile(xp.eye(4, dtype=dtype), (capacity, 1, 1)),
        mask=xp.zeros((capacity,), bool),
        robust_delta=xp.full((capacity,), xp.inf, dtype),
    )


def _empty_plane_priors(capacity, dtype, xp=jnp):
    up = xp.asarray([0.0, 0.0, 1.0], dtype=dtype)
    return PlanePriorFactors(
        i=xp.zeros((capacity,), xp.int32),
        n_meas=xp.tile(up, (capacity, 1)),
        d_meas=xp.zeros((capacity,), dtype),
        sqrt_info=xp.tile(xp.eye(4, dtype=dtype), (capacity, 1, 1)),
        mask=xp.zeros((capacity,), bool),
        robust_delta=xp.full((capacity,), xp.inf, dtype),
    )


def _empty_plane_plane(capacity, dtype, xp=jnp):
    return PlanePlaneFactors(
        i=xp.zeros((capacity,), xp.int32),
        j=xp.zeros((capacity,), xp.int32),
        kind=xp.zeros((capacity,), xp.int32),
        meas=xp.zeros((capacity, 4), dtype),
        sqrt_info=xp.tile(xp.eye(4, dtype=dtype), (capacity, 1, 1)),
        mask=xp.zeros((capacity,), bool),
        robust_delta=xp.full((capacity,), xp.inf, dtype),
    )


def _empty_se3_plane(capacity, dtype, xp=jnp):
    up = xp.asarray([0.0, 0.0, 1.0, 0.0], dtype=dtype)
    return SE3PlaneFactors(
        i=xp.zeros((capacity,), xp.int32),
        j=xp.zeros((capacity,), xp.int32),
        plane_meas=xp.tile(up, (capacity, 1)),
        sqrt_info=xp.tile(xp.eye(3, dtype=dtype), (capacity, 1, 1)),
        mask=xp.zeros((capacity,), bool),
        robust_delta=xp.full((capacity,), xp.inf, dtype),
    )


def _empty_z_between(capacity, dtype, xp=jnp):
    return ZBetweenFactors(
        i=xp.zeros((capacity,), xp.int32),
        j=xp.zeros((capacity,), xp.int32),
        z_meas=xp.zeros((capacity,), dtype),
        sqrt_info=xp.ones((capacity, 1, 1), dtype),
        mask=xp.zeros((capacity,), bool),
        robust_delta=xp.full((capacity,), xp.inf, dtype),
    )


def _empty_utm_align(capacity, dtype, xp=jnp):
    return UTMAlignFactors(
        i=xp.zeros((capacity,), xp.int32),
        p_utm=xp.zeros((capacity, 3), dtype),
        p_world=xp.zeros((capacity, 3), dtype),
        sqrt_info=xp.tile(xp.eye(3, dtype=dtype), (capacity, 1, 1)),
        mask=xp.zeros((capacity,), bool),
        robust_delta=xp.full((capacity,), xp.inf, dtype),
    )


def empty_plane_graph(
    n_plane_priors: int = 0,
    n_plane_plane: int = 0,
    n_se3_plane: int = 0,
    n_z_between: int = 0,
    n_utm_align: int = 0,
    dtype=jnp.float64,
    xp=jnp,
) -> PlaneGraphData:
    return PlaneGraphData(
        plane_priors=_empty_plane_priors(max(n_plane_priors, 1), dtype, xp),
        plane_plane=_empty_plane_plane(max(n_plane_plane, 1), dtype, xp),
        se3_plane=_empty_se3_plane(max(n_se3_plane, 1), dtype, xp),
        z_between=_empty_z_between(max(n_z_between, 1), dtype, xp),
        utm_align=_empty_utm_align(max(n_utm_align, 1), dtype, xp),
    )


def empty_graph(
    n_between: int,
    n_priors: int = 4,
    n_point_priors: int = 0,
    n_quat_priors: int = 0,
    n_vec_priors: int = 0,
    n_plane_factors: int = 0,
    dtype=jnp.float64,
    xp=jnp,
) -> GraphData:
    """`xp=np` builds host-side numpy buffers — the graph builder fills them
    by plain assignment (no per-factor device dispatches) and converts once."""
    return GraphData(
        between=_empty_between(n_between, dtype, xp),
        priors=_empty_priors(n_priors, dtype, xp),
        point_priors=_empty_point_priors(max(n_point_priors, 1), dtype, xp),
        quat_priors=_empty_quat_priors(max(n_quat_priors, 1), dtype, xp),
        vec_priors=_empty_vec_priors(max(n_vec_priors, 1), dtype, xp),
        plane_factors=_empty_plane_factors(max(n_plane_factors, 1), dtype, xp),
    )
