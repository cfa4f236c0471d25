"""Batched Gauss-Newton / Levenberg-Marquardt pose-graph solver + Laplace.

Counterpart of `GraphSLAM::optimize` (`graph_slam.cpp:353-382`,
g2o `lm_var_cholmod`): factor residuals/Jacobians are evaluated with one
`vmap` per factor family, scatter-added into block normal equations, and the
damped system is solved densely (Cholesky) for graphs up to a few thousand
poses or by Jacobi-preconditioned CG above that. A Laplace posterior
(H^{-1} at the optimum) replaces g2o's marginal covariance machinery.

The whole solve is one jitted program; `vmap` it to optimize many windows
(or SMC particle graphs) in parallel — the reference optimizes one graph at a
time on one core.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import lie
from .factors import (
    BetweenFactors,
    GraphData,
    GroundPlaneFactors,
    PlaneGraphData,
    PlanePlaneFactors,
    PlanePriorFactors,
    PointPriorFactors,
    PriorFactors,
    QuatPriorFactors,
    SE3PlaneFactors,
    UTMAlignFactors,
    VecPriorFactors,
    ZBetweenFactors,
    huber_weight,
    retract,
    retract_plane,
)


class SolveConfig(NamedTuple):
    max_iterations: int = 50
    lm_lambda_init: float = 1e-6
    lm_lambda_factor: float = 10.0
    rel_tol: float = 1e-9
    solver: str = "dense"  # "dense" | "cg" | "direct" (sparse path only)
    cg_iters: int = 100
    # static bound on non-adjacent (loop) edges for the sparse "direct"
    # solver's Woodbury correction; builders size it from the live loop count
    loop_capacity: int = 64
    # Freeze pose 0 (parity: fix_first_node + anchor, `:566-579`). Default off:
    # the builder-level anchor prior fixes the gauge without constraining pose 0
    # to its (possibly corrupted) initial value.
    fix_first: bool = False


class SolveResult(NamedTuple):
    poses: jax.Array  # (K, 4, 4)
    chi2: jax.Array
    iterations: jax.Array
    lm_lambda: jax.Array
    H: jax.Array  # (6K, 6K) Gauss-Newton Hessian at the solution (dense mode)


def _family_terms(poses, factors, res_fn, unary: bool):
    """Per-family residuals r (F, d), Jacobians (F, d, 6[, 6]) and weights."""

    if unary:

        def one(f_i, *meas):
            T_i = poses[f_i]

            def local(di):
                return res_fn(retract(T_i, di), *meas)

            r = local(jnp.zeros(6, poses.dtype))
            J_i = jax.jacfwd(local)(jnp.zeros(6, poses.dtype))
            return r, J_i

        return jax.vmap(one)
    else:

        def one(f_i, f_j, *meas):
            T_i = poses[f_i]
            T_j = poses[f_j]

            def local(dij):
                return res_fn(retract(T_i, dij[:6]), retract(T_j, dij[6:]), *meas)

            r = local(jnp.zeros(12, poses.dtype))
            J = jax.jacfwd(local)(jnp.zeros(12, poses.dtype))
            return r, J[:, :6], J[:, 6:]

        return jax.vmap(one)


def _weighted(r, sqrt_info, robust_delta, mask):
    """Whiten with sqrt_info and robust kernel; masked factors zeroed."""
    rw = jnp.einsum("fij,fj->fi", sqrt_info, r)
    chi2 = jnp.sum(rw * rw, axis=-1)
    w = huber_weight(chi2, robust_delta) * mask.astype(r.dtype)
    return rw, w, jnp.sum(w * chi2)


def build_normal_equations(poses, graph: GraphData):
    """Assemble H (K,K,6,6 block structure flattened later), b (K,6), chi2."""
    K = poses.shape[0]
    dtype = poses.dtype
    Hb = jnp.zeros((K, K, 6, 6), dtype)
    bb = jnp.zeros((K, 6), dtype)
    chi2 = jnp.zeros((), dtype)

    # between factors
    f = graph.between
    r, Ji, Jj = _family_terms(poses, f, BetweenFactors.residual, unary=False)(
        f.i, f.j, f.T_meas
    )
    rw, w, c2 = _weighted(r, f.sqrt_info, f.robust_delta, f.mask)
    Jiw = jnp.einsum("fij,fjk->fik", f.sqrt_info, Ji)
    Jjw = jnp.einsum("fij,fjk->fik", f.sqrt_info, Jj)
    Hb = Hb.at[f.i, f.i].add(jnp.einsum("fji,fjk,f->fik", Jiw, Jiw, w))
    Hb = Hb.at[f.j, f.j].add(jnp.einsum("fji,fjk,f->fik", Jjw, Jjw, w))
    Hb = Hb.at[f.i, f.j].add(jnp.einsum("fji,fjk,f->fik", Jiw, Jjw, w))
    Hb = Hb.at[f.j, f.i].add(jnp.einsum("fji,fjk,f->fik", Jjw, Jiw, w))
    bb = bb.at[f.i].add(jnp.einsum("fji,fj,f->fi", Jiw, rw, w))
    bb = bb.at[f.j].add(jnp.einsum("fji,fj,f->fi", Jjw, rw, w))
    chi2 = chi2 + c2

    def add_unary(Hb, bb, chi2, fac, res_fn, meas):
        r, Ji = _family_terms(poses, fac, res_fn, unary=True)(fac.i, *meas)
        rw, w, c2 = _weighted(r, fac.sqrt_info, fac.robust_delta, fac.mask)
        Jiw = jnp.einsum("fij,fjk->fik", fac.sqrt_info, Ji)
        Hb = Hb.at[fac.i, fac.i].add(jnp.einsum("fji,fjk,f->fik", Jiw, Jiw, w))
        bb = bb.at[fac.i].add(jnp.einsum("fji,fj,f->fi", Jiw, rw, w))
        return Hb, bb, chi2 + c2

    Hb, bb, chi2 = add_unary(
        Hb, bb, chi2, graph.priors, PriorFactors.residual, (graph.priors.T_meas,)
    )
    Hb, bb, chi2 = add_unary(
        Hb,
        bb,
        chi2,
        graph.point_priors,
        PointPriorFactors.residual,
        (graph.point_priors.p_meas, graph.point_priors.axis_mask),
    )
    Hb, bb, chi2 = add_unary(
        Hb,
        bb,
        chi2,
        graph.quat_priors,
        QuatPriorFactors.residual,
        (graph.quat_priors.R_meas,),
    )
    Hb, bb, chi2 = add_unary(
        Hb,
        bb,
        chi2,
        graph.vec_priors,
        VecPriorFactors.residual,
        (graph.vec_priors.dir_world, graph.vec_priors.dir_meas),
    )
    Hb, bb, chi2 = add_unary(
        Hb,
        bb,
        chi2,
        graph.plane_factors,
        GroundPlaneFactors.residual,
        (graph.plane_factors.plane_world, graph.plane_factors.plane_meas),
    )
    return Hb, bb, chi2


def graph_chi2(poses, graph: GraphData):
    """Total robustified chi2 (no Jacobians)."""
    c2 = jnp.zeros((), poses.dtype)
    f = graph.between
    r = jax.vmap(
        lambda i, j, m: BetweenFactors.residual(poses[i], poses[j], m)
    )(f.i, f.j, f.T_meas)
    _, _, c = _weighted(r, f.sqrt_info, f.robust_delta, f.mask)
    c2 += c
    p = graph.priors
    r = jax.vmap(lambda i, m: PriorFactors.residual(poses[i], m))(p.i, p.T_meas)
    _, _, c = _weighted(r, p.sqrt_info, p.robust_delta, p.mask)
    c2 += c
    pp = graph.point_priors
    r = jax.vmap(lambda i, m, a: PointPriorFactors.residual(poses[i], m, a))(
        pp.i, pp.p_meas, pp.axis_mask
    )
    _, _, c = _weighted(r, pp.sqrt_info, pp.robust_delta, pp.mask)
    c2 += c
    q = graph.quat_priors
    r = jax.vmap(lambda i, m: QuatPriorFactors.residual(poses[i], m))(q.i, q.R_meas)
    _, _, c = _weighted(r, q.sqrt_info, q.robust_delta, q.mask)
    c2 += c
    v = graph.vec_priors
    r = jax.vmap(lambda i, dw, dm: VecPriorFactors.residual(poses[i], dw, dm))(
        v.i, v.dir_world, v.dir_meas
    )
    _, _, c = _weighted(r, v.sqrt_info, v.robust_delta, v.mask)
    c2 += c
    pl_ = graph.plane_factors
    r = jax.vmap(lambda i, pw, pm: GroundPlaneFactors.residual(poses[i], pw, pm))(
        pl_.i, pl_.plane_world, pl_.plane_meas
    )
    _, _, c = _weighted(r, pl_.sqrt_info, pl_.robust_delta, pl_.mask)
    c2 += c
    return c2


def _flatten_H(Hb):
    K = Hb.shape[0]
    return jnp.transpose(Hb, (0, 2, 1, 3)).reshape(K * 6, K * 6)


def _solve_dense(H, b, lam, dtype):
    n = H.shape[0]
    A = H + lam * jnp.eye(n, dtype=dtype) * jnp.maximum(jnp.diag(H), 1.0)
    L = jnp.linalg.cholesky(A)
    y = jax.scipy.linalg.solve_triangular(L, -b, lower=True)
    return jax.scipy.linalg.solve_triangular(L, y, lower=True, trans=1)


def _solve_cg(H, b, lam, dtype, iters):
    n = H.shape[0]
    diag = jnp.maximum(jnp.diag(H), 1e-12)
    A = H + lam * jnp.eye(n, dtype=dtype) * jnp.maximum(diag, 1.0)
    Minv = 1.0 / (diag * (1.0 + lam))

    def mv(x):
        return A @ x

    x, _ = jax.scipy.sparse.linalg.cg(mv, -b, M=lambda v: Minv * v, maxiter=iters)
    return x


@partial(jax.jit, static_argnames=("cfg",))
def optimize_graph(poses0, graph: GraphData, cfg: SolveConfig = SolveConfig()) -> SolveResult:
    """LM optimization; gauge fixed by freezing pose 0 (cfg.fix_first)."""
    K = poses0.shape[0]
    dtype = poses0.dtype

    free = jnp.ones((K, 6), dtype)
    if cfg.fix_first:
        free = free.at[0].set(0.0)
    free_flat = free.reshape(-1)

    def lin(poses):
        Hb, bb, chi2 = build_normal_equations(poses, graph)
        H = _flatten_H(Hb)
        b = bb.reshape(-1)
        # gauge fixing: zero rows/cols of fixed vars, unit diagonal
        H = H * free_flat[:, None] * free_flat[None, :]
        H = H + jnp.diag(1.0 - free_flat)
        b = b * free_flat
        return H, b, chi2

    def body(state):
        poses, lam, chi2_prev, it, done, H_last = state
        H, b, chi2 = lin(poses)
        if cfg.solver == "cg":
            delta = _solve_cg(H, b, lam, dtype, cfg.cg_iters)
        else:
            delta = _solve_dense(H, b, lam, dtype)
        delta = delta * free_flat
        poses_new = jax.vmap(retract)(poses, delta.reshape(K, 6))
        chi2_new = graph_chi2(poses_new, graph)
        accept = chi2_new < chi2
        poses_out = jnp.where(accept, poses_new, poses)
        lam_out = jnp.where(accept, lam / cfg.lm_lambda_factor, lam * cfg.lm_lambda_factor)
        rel = jnp.abs(chi2 - chi2_new) / jnp.maximum(chi2, 1e-30)
        done_new = accept & (rel < cfg.rel_tol)
        return poses_out, lam_out, jnp.where(accept, chi2_new, chi2), it + 1, done_new, H

    def cond(state):
        _, _, _, it, done, _ = state
        return (it < cfg.max_iterations) & (~done)

    H0 = jnp.eye(K * 6, dtype=dtype)
    init = (poses0, jnp.asarray(cfg.lm_lambda_init, dtype), jnp.asarray(jnp.inf, dtype), 0, False, H0)
    poses, lam, chi2, iters, _, H = jax.lax.while_loop(cond, body, init)
    return SolveResult(poses=poses, chi2=chi2, iterations=iters, lm_lambda=lam, H=H)


# ---------------------------------------------------------------------------
# Joint pose + plane-vertex optimization (g2o VertexPlane graph parity)
# ---------------------------------------------------------------------------


def _plane_terms(poses, planes, pg: PlaneGraphData):
    """Residual/Jacobian terms of every plane-extension family, as block
    normal-equation contributions: pose-pose (K,K,6,6), pose-plane (K,M,6,3),
    plane-plane (M,M,3,3), gradients (K,6)/(M,3), and chi2."""
    K, M = poses.shape[0], planes.shape[0]
    dtype = poses.dtype
    z6 = jnp.zeros(6, dtype)
    z3 = jnp.zeros(3, dtype)

    Hxx = jnp.zeros((K, K, 6, 6), dtype)
    Hxp = jnp.zeros((K, M, 6, 3), dtype)
    Hpp = jnp.zeros((M, M, 3, 3), dtype)
    bx = jnp.zeros((K, 6), dtype)
    bp = jnp.zeros((M, 3), dtype)
    chi2 = jnp.zeros((), dtype)

    # plane priors (unary on plane)
    f = pg.plane_priors

    def pp_one(fi, nm, dm):
        p = planes[fi]
        r = PlanePriorFactors.residual(p, nm, dm)
        J = jax.jacfwd(lambda d: PlanePriorFactors.residual(retract_plane(p, d), nm, dm))(z3)
        return r, J

    r, J = jax.vmap(pp_one)(f.i, f.n_meas, f.d_meas)
    rw, w, c2 = _weighted(r, f.sqrt_info, f.robust_delta, f.mask)
    Jw = jnp.einsum("fij,fjk->fik", f.sqrt_info, J)
    Hpp = Hpp.at[f.i, f.i].add(jnp.einsum("fji,fjk,f->fik", Jw, Jw, w))
    bp = bp.at[f.i].add(jnp.einsum("fji,fj,f->fi", Jw, rw, w))
    chi2 = chi2 + c2

    # plane-plane (identity / parallel / perpendicular)
    f = pg.plane_plane

    def pl2_one(fi, fj, kind, meas):
        pi, pj = planes[fi], planes[fj]

        def local(d):
            return PlanePlaneFactors.residual(
                retract_plane(pi, d[:3]), retract_plane(pj, d[3:]), kind, meas
            )

        r = local(z6)
        J = jax.jacfwd(local)(z6)
        return r, J[:, :3], J[:, 3:]

    r, Ji, Jj = jax.vmap(pl2_one)(f.i, f.j, f.kind, f.meas)
    rw, w, c2 = _weighted(r, f.sqrt_info, f.robust_delta, f.mask)
    Jiw = jnp.einsum("fij,fjk->fik", f.sqrt_info, Ji)
    Jjw = jnp.einsum("fij,fjk->fik", f.sqrt_info, Jj)
    Hpp = Hpp.at[f.i, f.i].add(jnp.einsum("fji,fjk,f->fik", Jiw, Jiw, w))
    Hpp = Hpp.at[f.j, f.j].add(jnp.einsum("fji,fjk,f->fik", Jjw, Jjw, w))
    Hpp = Hpp.at[f.i, f.j].add(jnp.einsum("fji,fjk,f->fik", Jiw, Jjw, w))
    Hpp = Hpp.at[f.j, f.i].add(jnp.einsum("fji,fjk,f->fik", Jjw, Jiw, w))
    bp = bp.at[f.i].add(jnp.einsum("fji,fj,f->fi", Jiw, rw, w))
    bp = bp.at[f.j].add(jnp.einsum("fji,fj,f->fi", Jjw, rw, w))
    chi2 = chi2 + c2

    # se3-plane (pose i observes plane j)
    f = pg.se3_plane

    def sp_one(fi, fj, meas):
        T, p = poses[fi], planes[fj]

        def local(d):
            return SE3PlaneFactors.residual(retract(T, d[:6]), retract_plane(p, d[6:]), meas)

        d0 = jnp.zeros(9, dtype)
        r = local(d0)
        J = jax.jacfwd(local)(d0)
        return r, J[:, :6], J[:, 6:]

    r, Jx, Jp = jax.vmap(sp_one)(f.i, f.j, f.plane_meas)
    rw, w, c2 = _weighted(r, f.sqrt_info, f.robust_delta, f.mask)
    Jxw = jnp.einsum("fij,fjk->fik", f.sqrt_info, Jx)
    Jpw = jnp.einsum("fij,fjk->fik", f.sqrt_info, Jp)
    Hxx = Hxx.at[f.i, f.i].add(jnp.einsum("fji,fjk,f->fik", Jxw, Jxw, w))
    Hpp = Hpp.at[f.j, f.j].add(jnp.einsum("fji,fjk,f->fik", Jpw, Jpw, w))
    Hxp = Hxp.at[f.i, f.j].add(jnp.einsum("fji,fjk,f->fik", Jxw, Jpw, w))
    bx = bx.at[f.i].add(jnp.einsum("fji,fj,f->fi", Jxw, rw, w))
    bp = bp.at[f.j].add(jnp.einsum("fji,fj,f->fi", Jpw, rw, w))
    chi2 = chi2 + c2

    # z-between (pose-pose, 1-dof)
    f = pg.z_between
    r, Ji, Jj = _family_terms(poses, f, ZBetweenFactors.residual, unary=False)(
        f.i, f.j, f.z_meas
    )
    rw, w, c2 = _weighted(r, f.sqrt_info, f.robust_delta, f.mask)
    Jiw = jnp.einsum("fij,fjk->fik", f.sqrt_info, Ji)
    Jjw = jnp.einsum("fij,fjk->fik", f.sqrt_info, Jj)
    Hxx = Hxx.at[f.i, f.i].add(jnp.einsum("fji,fjk,f->fik", Jiw, Jiw, w))
    Hxx = Hxx.at[f.j, f.j].add(jnp.einsum("fji,fjk,f->fik", Jjw, Jjw, w))
    Hxx = Hxx.at[f.i, f.j].add(jnp.einsum("fji,fjk,f->fik", Jiw, Jjw, w))
    Hxx = Hxx.at[f.j, f.i].add(jnp.einsum("fji,fjk,f->fik", Jjw, Jiw, w))
    bx = bx.at[f.i].add(jnp.einsum("fji,fj,f->fi", Jiw, rw, w))
    bx = bx.at[f.j].add(jnp.einsum("fji,fj,f->fi", Jjw, rw, w))
    chi2 = chi2 + c2

    # UTM alignment (unary on pose)
    f = pg.utm_align
    r, Ji = _family_terms(poses, f, UTMAlignFactors.residual, unary=True)(
        f.i, f.p_utm, f.p_world
    )
    rw, w, c2 = _weighted(r, f.sqrt_info, f.robust_delta, f.mask)
    Jiw = jnp.einsum("fij,fjk->fik", f.sqrt_info, Ji)
    Hxx = Hxx.at[f.i, f.i].add(jnp.einsum("fji,fjk,f->fik", Jiw, Jiw, w))
    bx = bx.at[f.i].add(jnp.einsum("fji,fj,f->fi", Jiw, rw, w))
    chi2 = chi2 + c2

    return Hxx, Hxp, Hpp, bx, bp, chi2


def plane_graph_chi2(poses, planes, pg: PlaneGraphData):
    """Robustified chi2 of the plane-extension families only."""
    c2 = jnp.zeros((), poses.dtype)
    f = pg.plane_priors
    r = jax.vmap(lambda i, nm, dm: PlanePriorFactors.residual(planes[i], nm, dm))(
        f.i, f.n_meas, f.d_meas
    )
    _, _, c = _weighted(r, f.sqrt_info, f.robust_delta, f.mask)
    c2 += c
    f = pg.plane_plane
    r = jax.vmap(
        lambda i, j, k, m: PlanePlaneFactors.residual(planes[i], planes[j], k, m)
    )(f.i, f.j, f.kind, f.meas)
    _, _, c = _weighted(r, f.sqrt_info, f.robust_delta, f.mask)
    c2 += c
    f = pg.se3_plane
    r = jax.vmap(lambda i, j, m: SE3PlaneFactors.residual(poses[i], planes[j], m))(
        f.i, f.j, f.plane_meas
    )
    _, _, c = _weighted(r, f.sqrt_info, f.robust_delta, f.mask)
    c2 += c
    f = pg.z_between
    r = jax.vmap(lambda i, j, m: ZBetweenFactors.residual(poses[i], poses[j], m))(
        f.i, f.j, f.z_meas
    )
    _, _, c = _weighted(r, f.sqrt_info, f.robust_delta, f.mask)
    c2 += c
    f = pg.utm_align
    r = jax.vmap(lambda i, pu, pw: UTMAlignFactors.residual(poses[i], pu, pw))(
        f.i, f.p_utm, f.p_world
    )
    _, _, c = _weighted(r, f.sqrt_info, f.robust_delta, f.mask)
    c2 += c
    return c2


class PlaneSolveResult(NamedTuple):
    poses: jax.Array  # (K, 4, 4)
    planes: jax.Array  # (M, 4)
    chi2: jax.Array
    iterations: jax.Array
    lm_lambda: jax.Array
    H: jax.Array  # (6K+3M, 6K+3M)


@partial(jax.jit, static_argnames=("cfg",))
def optimize_graph_with_planes(
    poses0,
    planes0,
    graph: GraphData,
    plane_graph: PlaneGraphData,
    cfg: SolveConfig = SolveConfig(),
) -> PlaneSolveResult:
    """Joint LM over SE3 poses and plane vertices — the full g2o vertex set
    (`VertexSE3` + `VertexPlane`, `graph_slam.cpp:88-123`) in one dense
    batched solve. State x = [6K pose coords | 3M plane coords]."""
    K = poses0.shape[0]
    M = planes0.shape[0]
    dtype = poses0.dtype
    D = 6 * K + 3 * M

    free = jnp.ones((D,), dtype)
    if cfg.fix_first:
        free = free.at[:6].set(0.0)

    def lin(poses, planes):
        Hb, bb, chi2 = build_normal_equations(poses, graph)
        Hxx, Hxp, Hpp, bx, bp, c2p = _plane_terms(poses, planes, plane_graph)
        Hpose = _flatten_H(Hb + Hxx)
        Hplane = jnp.transpose(Hpp, (0, 2, 1, 3)).reshape(3 * M, 3 * M)
        Hcross = jnp.transpose(Hxp, (0, 2, 1, 3)).reshape(6 * K, 3 * M)
        H = jnp.block([[Hpose, Hcross], [Hcross.T, Hplane]])
        b = jnp.concatenate([(bb + bx).reshape(-1), bp.reshape(-1)])
        H = H * free[:, None] * free[None, :]
        H = H + jnp.diag(1.0 - free)
        b = b * free
        return H, b, chi2 + c2p

    def full_chi2(poses, planes):
        return graph_chi2(poses, graph) + plane_graph_chi2(poses, planes, plane_graph)

    def body(state):
        poses, planes, lam, chi2_prev, it, done, H_last = state
        H, b, chi2 = lin(poses, planes)
        if cfg.solver == "cg":
            delta = _solve_cg(H, b, lam, dtype, cfg.cg_iters)
        else:
            delta = _solve_dense(H, b, lam, dtype)
        delta = delta * free
        poses_new = jax.vmap(retract)(poses, delta[: 6 * K].reshape(K, 6))
        planes_new = jax.vmap(retract_plane)(planes, delta[6 * K :].reshape(M, 3))
        chi2_new = full_chi2(poses_new, planes_new)
        accept = chi2_new < chi2
        poses_out = jnp.where(accept, poses_new, poses)
        planes_out = jnp.where(accept, planes_new, planes)
        lam_out = jnp.where(accept, lam / cfg.lm_lambda_factor, lam * cfg.lm_lambda_factor)
        rel = jnp.abs(chi2 - chi2_new) / jnp.maximum(chi2, 1e-30)
        done_new = accept & (rel < cfg.rel_tol)
        return poses_out, planes_out, lam_out, jnp.where(accept, chi2_new, chi2), it + 1, done_new, H

    def cond(state):
        _, _, _, _, it, done, _ = state
        return (it < cfg.max_iterations) & (~done)

    H0 = jnp.eye(D, dtype=dtype)
    init = (
        poses0,
        planes0,
        jnp.asarray(cfg.lm_lambda_init, dtype),
        jnp.asarray(jnp.inf, dtype),
        0,
        False,
        H0,
    )
    poses, planes, lam, chi2, iters, _, H = jax.lax.while_loop(cond, body, init)
    return PlaneSolveResult(
        poses=poses, planes=planes, chi2=chi2, iterations=iters, lm_lambda=lam, H=H
    )


def laplace_covariance(result: SolveResult):
    """Gaussian (Laplace) posterior covariance over the stacked local
    coordinates: H^{-1} at the optimum (fixed vars get unit variance rows)."""
    n = result.H.shape[0]
    H = result.H + 1e-9 * jnp.eye(n, dtype=result.H.dtype)
    L = jnp.linalg.cholesky(H)
    inv = jax.scipy.linalg.cho_solve((L, True), jnp.eye(n, dtype=result.H.dtype))
    return inv
