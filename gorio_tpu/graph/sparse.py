"""Structure-exploiting pose-graph solver: block-sparse CG with a
block-tridiagonal (chain) preconditioner.

Counterpart of g2o's sparse backends (`graph_slam.cpp:353-382`,
solver `lm_var_cholmod`): where CHOLMOD exploits the fill-in pattern of a
SLAM chain with sparse Cholesky, this solver never materializes H at all —
the normal equations live as block arrays

    Hdiag (K,6,6)   one 6x6 block per pose (all unary + binary self terms)
    Hoff  (E,6,6)   one 6x6 block per *binary* factor e: H[i_e, j_e]
                    (the transpose block H[j,i] is implied)

and the damped system is solved by conjugate gradients whose matvec is two
segment scatter-adds — O(E) work/memory instead of the dense solver's O(K^2)
assembly + O(K^3) Cholesky (`solver.py:build_normal_equations`).

The preconditioner is the exact block-tridiagonal slice of H (consecutive
(k, k+1) blocks + all diagonal blocks), factorized by a block-Thomas
recursion (`lax.scan` of 6x6 ops). A SLAM graph is a chain of odometry /
preintegration factors plus a few loop closures and unary priors: the unary
terms land in Hdiag and the chain blocks in the tridiagonal, so M^-1 H =
I + (low rank from loop closures) and CG converges in roughly
(#loop closures + 1) iterations regardless of K.

The joint pose+plane variant appends the (3M) plane coordinates as a
block-diagonal tail (planes: dense 3Mx3M, M is tiny — one floor plane),
with pose-plane cross blocks applied in the matvec but left out of the
preconditioner (another low-rank correction).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

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
    retract,
    retract_plane,
)
from .solver import (
    SolveConfig,
    _family_terms,
    _weighted,
    graph_chi2,
    plane_graph_chi2,
)


class SparseSolveResult(NamedTuple):
    poses: jax.Array  # (K, 4, 4)
    chi2: jax.Array
    iterations: jax.Array
    lm_lambda: jax.Array
    H_diag: jax.Array  # (K, 6, 6) diagonal blocks of H at the solution


class SparsePlaneSolveResult(NamedTuple):
    poses: jax.Array
    planes: jax.Array  # (M, 4)
    chi2: jax.Array
    iterations: jax.Array
    lm_lambda: jax.Array
    H_diag: jax.Array


# ---------------------------------------------------------------------------
# Block normal equations
# ---------------------------------------------------------------------------


def build_block_normal_equations(poses, graph: GraphData):
    """Assemble (Hdiag (K,6,6), Hoff (E,6,6), b (K,6), chi2) — the block-CSR
    form of `solver.build_normal_equations` without the (K,K,6,6) tensor."""
    K = poses.shape[0]
    dtype = poses.dtype
    Hdiag = jnp.zeros((K, 6, 6), dtype)
    b = jnp.zeros((K, 6), dtype)
    chi2 = jnp.zeros((), dtype)

    f = graph.between
    r, Ji, Jj = _family_terms(poses, f, BetweenFactors.residual, unary=False)(
        f.i, f.j, f.T_meas
    )
    rw, w, c2 = _weighted(r, f.sqrt_info, f.robust_delta, f.mask)
    Jiw = jnp.einsum("fij,fjk->fik", f.sqrt_info, Ji)
    Jjw = jnp.einsum("fij,fjk->fik", f.sqrt_info, Jj)
    Hdiag = Hdiag.at[f.i].add(jnp.einsum("fji,fjk,f->fik", Jiw, Jiw, w))
    Hdiag = Hdiag.at[f.j].add(jnp.einsum("fji,fjk,f->fik", Jjw, Jjw, w))
    Hoff = jnp.einsum("fji,fjk,f->fik", Jiw, Jjw, w)  # H[i_e, j_e]
    b = b.at[f.i].add(jnp.einsum("fji,fj,f->fi", Jiw, rw, w))
    b = b.at[f.j].add(jnp.einsum("fji,fj,f->fi", Jjw, rw, w))
    chi2 = chi2 + c2

    def add_unary(Hdiag, b, chi2, fac, res_fn, meas):
        r, Ji = _family_terms(poses, fac, res_fn, unary=True)(fac.i, *meas)
        rw, w, c2 = _weighted(r, fac.sqrt_info, fac.robust_delta, fac.mask)
        Jiw = jnp.einsum("fij,fjk->fik", fac.sqrt_info, Ji)
        Hdiag = Hdiag.at[fac.i].add(jnp.einsum("fji,fjk,f->fik", Jiw, Jiw, w))
        b = b.at[fac.i].add(jnp.einsum("fji,fj,f->fi", Jiw, rw, w))
        return Hdiag, b, chi2 + c2

    Hdiag, b, chi2 = add_unary(
        Hdiag, b, chi2, graph.priors, PriorFactors.residual, (graph.priors.T_meas,)
    )
    Hdiag, b, chi2 = add_unary(
        Hdiag, b, chi2, graph.point_priors, PointPriorFactors.residual,
        (graph.point_priors.p_meas, graph.point_priors.axis_mask),
    )
    Hdiag, b, chi2 = add_unary(
        Hdiag, b, chi2, graph.quat_priors, QuatPriorFactors.residual,
        (graph.quat_priors.R_meas,),
    )
    Hdiag, b, chi2 = add_unary(
        Hdiag, b, chi2, graph.vec_priors, VecPriorFactors.residual,
        (graph.vec_priors.dir_world, graph.vec_priors.dir_meas),
    )
    Hdiag, b, chi2 = add_unary(
        Hdiag, b, chi2, graph.plane_factors, GroundPlaneFactors.residual,
        (graph.plane_factors.plane_world, graph.plane_factors.plane_meas),
    )
    return Hdiag, Hoff, b, chi2


# ---------------------------------------------------------------------------
# Block-tridiagonal preconditioner (block-Thomas)
# ---------------------------------------------------------------------------


def _chain_upper_blocks(Hoff, fi, fj, K, dtype):
    """(K-1, 6, 6) consecutive blocks C[k] = H[k, k+1], gathered from the
    per-factor off-diagonal blocks (non-chain factors contribute nothing)."""
    C = jnp.zeros((K, 6, 6), dtype)
    fwd = (fj == fi + 1)
    C = C.at[fi].add(jnp.where(fwd[:, None, None], Hoff, 0.0))
    rev = (fi == fj + 1)  # factor stored as (k+1, k): H[k, k+1] = Hoff^T
    C = C.at[fj].add(jnp.where(rev[:, None, None], jnp.swapaxes(Hoff, 1, 2), 0.0))
    return C[: K - 1]


def _inv3c(M):
    """Closed-form batched 3x3 inverse (adjugate / det) — no LU custom call."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    Cq = d * h - e * g
    det = a * A + b * B + c * Cq
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
    r0 = jnp.stack([A, -(b * i - c * h), (b * f - c * e)], -1)
    r1 = jnp.stack([B, (a * i - c * g), -(a * f - c * d)], -1)
    r2 = jnp.stack([Cq, -(a * h - b * g), (a * e - b * d)], -1)
    return jnp.stack([r0, r1, r2], -2) * inv_det[..., None, None]


def inv6_spd(M):
    """Closed-form batched inverse of an SPD 6x6 via the 3x3-block Schur
    complement — pure fused arithmetic instead of an LU custom call inside
    the block-Thomas scans."""
    P = M[..., :3, :3]
    Q = M[..., :3, 3:]
    S = M[..., 3:, 3:]
    Pinv = _inv3c(P)
    PinvQ = Pinv @ Q
    Sc = S - jnp.swapaxes(Q, -1, -2) @ PinvQ
    Scinv = _inv3c(Sc)
    TR = -PinvQ @ Scinv
    TL = Pinv - TR @ jnp.swapaxes(PinvQ, -1, -2)
    top = jnp.concatenate([TL, TR], axis=-1)
    bot = jnp.concatenate([jnp.swapaxes(TR, -1, -2), Scinv], axis=-1)
    X = jnp.concatenate([top, bot], axis=-2)
    # one Newton-Schulz step squares the residual of the adjugate-based
    # inverse (mixed info scales: anchor priors at 1e6 vs edges at 1e1)
    eye = jnp.broadcast_to(jnp.eye(6, dtype=M.dtype), X.shape)
    return X @ (2.0 * eye - M @ X)


def block_tridiag_factor(A, C):
    """Block-Thomas factorization of the SPD block tridiagonal (A_k, C_k):
    returns Dinv (K,6,6) with D_0 = A_0,
    D_k = A_k - C_{k-1}^T D_{k-1}^{-1} C_{k-1}."""

    def step(Dinv_prev, inputs):
        Ak, Ck_prev = inputs
        Dk = Ak - Ck_prev.T @ Dinv_prev @ Ck_prev
        Dinv = inv6_spd(Dk)
        return Dinv, Dinv

    Dinv0 = inv6_spd(A[0])
    _, Dinvs = jax.lax.scan(step, Dinv0, (A[1:], C))
    return jnp.concatenate([Dinv0[None], Dinvs])


def block_tridiag_solve(Dinv, C, b):
    """Solve the block-tridiagonal system given the block-Thomas factors.

    `b` may be (K, 6) or (K, 6, R) — every op is a matmul, so extra trailing
    right-hand-side columns ride along for free (used by the Woodbury loop
    correction below)."""

    def fwd(z_prev, inputs):
        bk, Ck_prev, Dinv_prev = inputs
        z = bk - Ck_prev.T @ (Dinv_prev @ z_prev)
        return z, z

    z0 = b[0]
    _, zs = jax.lax.scan(fwd, z0, (b[1:], C, Dinv[:-1]))
    z = jnp.concatenate([z0[None], zs])

    def bwd(x_next, inputs):
        zk, Ck, Dinvk = inputs
        x = Dinvk @ (zk - Ck @ x_next)
        return x, x

    xK = Dinv[-1] @ z[-1]
    _, xs = jax.lax.scan(bwd, xK, (z[:-1], C, Dinv[:-1]), reverse=True)
    return jnp.concatenate([xs, xK[None]])


# ---------------------------------------------------------------------------
# SPIKE partitioned block-tridiagonal solve (parallel-in-K)
# ---------------------------------------------------------------------------
#
# The block-Thomas recurrences above are K-sequential — at K~1000 the scan
# latency dominates the whole LM iteration. The
# SPIKE scheme partitions the chain into S groups of m rows, factorizes and
# solves every group's interior tridiagonal IN PARALLEL (one vmapped m-step
# scan instead of a K-step scan), couples the groups through a reduced
# block-tridiagonal system over the 2S interface unknowns (each group's
# first/last rows), and back-substitutes in parallel: sequential depth
# ~2m + S instead of ~2K.


def _inv6_gen(M):
    """Closed-form general 6x6 inverse (3x3-block Schur, no pivoting — the
    SPIKE interface blocks are near-identity, far from needing pivots)."""
    P = M[..., :3, :3]
    Q = M[..., :3, 3:]
    Rb = M[..., 3:, :3]
    S = M[..., 3:, 3:]
    Pinv = _inv3c(P)
    PinvQ = Pinv @ Q
    Sc = S - Rb @ PinvQ
    Scinv = _inv3c(Sc)
    TR = -PinvQ @ Scinv
    BL = -Scinv @ (Rb @ Pinv)
    TL = Pinv - PinvQ @ BL
    top = jnp.concatenate([TL, TR], axis=-1)
    bot = jnp.concatenate([BL, Scinv], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _inv12_gen(M):
    """Closed-form general 12x12 inverse via 6x6-block Schur on `_inv6_gen`."""
    P = M[..., :6, :6]
    Q = M[..., :6, 6:]
    Rb = M[..., 6:, :6]
    S = M[..., 6:, 6:]
    Pinv = _inv6_gen(P)
    PinvQ = Pinv @ Q
    Sc = S - Rb @ PinvQ
    Scinv = _inv6_gen(Sc)
    TR = -PinvQ @ Scinv
    BL = -Scinv @ (Rb @ Pinv)
    TL = Pinv - PinvQ @ BL
    top = jnp.concatenate([TL, TR], axis=-1)
    bot = jnp.concatenate([BL, Scinv], axis=-1)
    X = jnp.concatenate([top, bot], axis=-2)
    eye = jnp.broadcast_to(jnp.eye(12, dtype=M.dtype), X.shape)
    return X @ (2.0 * eye - M @ X)


def _general_block_tridiag_solve(M, L, U, h):
    """Non-symmetric block-tridiagonal solve (LU-Thomas): block rows
    M_s u_s + L_s u_{s-1} + U_s u_{s+1} = h_s. M/L/U (S,d,d), h (S,d,R)."""

    def fwd(carry, inputs):
        G_prev, y_prev = carry
        Ms, Ls, Us, hs = inputs
        D = Ms - Ls @ G_prev
        Dinv = _inv12_gen(D)
        G = Dinv @ Us
        y = Dinv @ (hs - Ls @ y_prev)
        return (G, y), (G, y)

    D0inv = _inv12_gen(M[0])
    G0 = D0inv @ U[0]
    y0 = D0inv @ h[0]
    _, (Gs, ys) = jax.lax.scan(fwd, (G0, y0), (M[1:], L[1:], U[1:], h[1:]))
    G = jnp.concatenate([G0[None], Gs])
    y = jnp.concatenate([y0[None], ys])

    def bwd(x_next, inputs):
        Gs_, ys_ = inputs
        x = ys_ - Gs_ @ x_next
        return x, x

    _, xs = jax.lax.scan(bwd, y[-1], (G[:-1], y[:-1]), reverse=True)
    return jnp.concatenate([xs, y[-1][None]])


def solve_block_tridiag_spike(A, C, b, m=32):
    """Exact solve of the SPD block tridiagonal (A (K,6,6), C (K-1,6,6))
    against b (K,6,R), partitioned into K//m groups. Requires m | K and
    K >= 2m; callers fall back to the sequential Thomas otherwise."""
    K = A.shape[0]
    R = b.shape[-1]
    dtype = A.dtype
    S = K // m
    Ag = A.reshape(S, m, 6, 6)
    # within-group couplings C[s*m + j], j = 0..m-2; interface C[s*m - 1]
    Cpad = jnp.concatenate([C, jnp.zeros((1, 6, 6), dtype)])  # (K, 6, 6)
    Cg = Cpad.reshape(S, m, 6, 6)
    Cg_int = Cg[:, : m - 1]
    Cint = Cg[: S - 1, m - 1]  # (S-1, 6, 6): couples group s row m-1 to s+1 row 0

    Dinv_g = jax.vmap(block_tridiag_factor)(Ag, Cg_int)

    # per-group RHS block: [b | spike V (6 cols) | spike W (6 cols)]
    eye6 = jnp.eye(6, dtype=dtype)
    rhs = jnp.zeros((S, m, 6, R + 12), dtype)
    rhs = rhs.at[:, :, :, :R].set(b.reshape(S, m, 6, R))
    # V_s = D_s^-1 e_{m-1} Cint[s]   (coupling to group s+1's first row)
    rhs = rhs.at[: S - 1, m - 1, :, R : R + 6].set(Cint)
    # W_s = D_s^-1 e_0 Cint[s-1]^T   (coupling to group s-1's last row)
    rhs = rhs.at[1:, 0, :, R + 6 :].set(jnp.swapaxes(Cint, 1, 2))

    sol = jax.vmap(block_tridiag_solve)(Dinv_g, Cg_int, rhs)  # (S, m, 6, R+12)
    g = sol[:, :, :, :R]
    V = sol[:, :, :, R : R + 6]
    W = sol[:, :, :, R + 6 :]

    # reduced system over u_s = (x_{s,0}, x_{s,m-1}) (12-blocks):
    #   u_s + L_s u_{s-1} + U_s u_{s+1} = h_s
    # with L_s = [[0, W_s[0]], [0, W_s[m-1]]], U_s = [[V_s[0], 0],
    # [V_s[m-1], 0]] (W_0 = 0, V_{S-1} = 0 already by construction).
    z2 = jnp.zeros((S, 6, 6), dtype)
    Lred = jnp.concatenate(
        [jnp.concatenate([z2, W[:, 0]], -1), jnp.concatenate([z2, W[:, m - 1]], -1)], -2
    )
    Ured = jnp.concatenate(
        [jnp.concatenate([V[:, 0], z2], -1), jnp.concatenate([V[:, m - 1], z2], -1)], -2
    )
    Mred = jnp.broadcast_to(jnp.eye(12, dtype=dtype), (S, 12, 12))
    hred = jnp.concatenate([g[:, 0], g[:, m - 1]], -2)  # (S, 12, R)
    u = _general_block_tridiag_solve(Mred, Lred, Ured, hred)  # (S, 12, R)
    y = u[:, :6]  # x_{s,0}
    z = u[:, 6:]  # x_{s,m-1}

    # parallel back-substitution: x_s = g_s - V_s y_{s+1} - W_s z_{s-1}
    y_next = jnp.concatenate([y[1:], jnp.zeros((1, 6, R), dtype)])
    z_prev = jnp.concatenate([jnp.zeros((1, 6, R), dtype), z[: S - 1]])
    x = g - jnp.einsum("smij,sjr->smir", V, y_next) - jnp.einsum(
        "smij,sjr->smir", W, z_prev
    )
    return x.reshape(K, 6, R)


# ---------------------------------------------------------------------------
# Exact direct solve: block-tridiagonal + Woodbury loop-closure correction
# ---------------------------------------------------------------------------
#
# H of a SLAM graph = T (block tridiagonal: all diagonal blocks + consecutive
# chain blocks) + the off-diagonal blocks of the L non-adjacent ("loop")
# edges. Those are a rank-12L correction: H = T + U W U^T with
# U = [.. S_i | S_j ..] block selectors and W = blockdiag([[0, H_ij],
# [H_ij^T, 0]]). Woodbury:
#   H^-1 b = T^-1 b - T^-1 U (I + W U^T T^-1 U)^-1 W U^T T^-1 b
# One block-Thomas factorization, one multi-RHS tridiagonal solve (12L + 1
# columns ride one scan), and one small dense (12L)^2 solve — EXACT, unlike
# CG in f32, whose residual stagnates around 1e-3 (and 0.2+ on loop-heavy
# graphs), wrecking LM convergence. g2o/CHOLMOD parity path
# (`graph_slam.cpp:353`): this is the fixed-shape equivalent of its sparse
# Cholesky on a chain-plus-loops sparsity pattern.


def solve_tridiag_woodbury(A, C, poses, between, b, loop_capacity):
    """Exact solve of H x = b where H = A/C's block tridiagonal + the L
    non-adjacent ("loop") between edges.

    The loop edges enter in PSD form: each edge's FULL whitened contribution
    is g_e^T g_e with g_e = sqrt(w_e) [S_e J_i | S_e J_j] (6 rows), so
    H = T' + G^T G with T' = the tridiagonal MINUS the loop edges' diagonal
    blocks. Woodbury then needs the SPD capacitance I + G T'^-1 G^T — a
    (6L)^2 CHOLESKY instead of the (12L)^2 LU of the indefinite off-diagonal
    formulation (Cholesky at half dimension is cheaper than LU), and half the multi-RHS width through the tridiagonal
    solve.

    A (K,6,6) damped diagonal blocks (INCLUDING loop-edge diagonal
    contributions — they are subtracted here), C (K-1,6,6) chain
    off-diagonals, `poses`/`between` the current linearization state,
    b (K,6) or (K,6,Rb) multi-RHS (every extra column rides the same
    factorization — the joint pose+plane solver feeds the pose-plane
    coupling columns through here for its plane Schur complement).
    `loop_capacity` is the static bound on loop edges; callers size it from
    the live loop count."""
    from .factors import BetweenFactors

    squeeze = b.ndim == 2
    if squeeze:
        b = b[..., None]
    Rb = b.shape[-1]
    K = b.shape[0]
    dtype = b.dtype
    Lcap = loop_capacity
    fi = jnp.asarray(between.i)
    fj = jnp.asarray(between.j)
    is_loop = jnp.asarray(between.mask) & (fj != fi + 1) & (fi != fj + 1)
    (sel,) = jnp.nonzero(is_loop, size=Lcap, fill_value=0)
    lmask = is_loop[sel]
    li = fi[sel]
    lj = fj[sel]

    # recompute the selected edges' whitened Jacobians (vmapped; O(Lcap))
    r, Ji, Jj = _family_terms(poses, None, BetweenFactors.residual, unary=False)(
        li, lj, between.T_meas[sel]
    )
    sq = between.sqrt_info[sel]
    rw, w, _ = _weighted(r, sq, between.robust_delta[sel], lmask)
    sw = jnp.sqrt(w)[:, None, None]
    Giw = sw * jnp.einsum("eij,ejk->eik", sq, Ji)  # (L, 6, 6) rows of g_e at col li
    Gjw = sw * jnp.einsum("eij,ejk->eik", sq, Jj)

    # T' = tridiagonal minus the loop edges' diagonal contributions
    A = A.at[li].add(-jnp.einsum("eji,ejk->eik", Giw, Giw))
    A = A.at[lj].add(-jnp.einsum("eji,ejk->eik", Gjw, Gjw))

    R = 6 * Lcap
    # RHS block: [b | G^T] — G^T columns live at rows li (Giw^T) and lj (Gjw^T)
    rows6 = jnp.arange(6)
    cols = Rb + 6 * jnp.arange(Lcap)[:, None, None] + rows6[None, None, :]
    rhs = jnp.zeros((K, 6, Rb + R), dtype)
    rhs = rhs.at[:, :, :Rb].set(b)
    rhs = rhs.at[li[:, None, None], rows6[None, :, None], cols].add(
        jnp.swapaxes(Giw, 1, 2)
    )
    rhs = rhs.at[lj[:, None, None], rows6[None, :, None], cols].add(
        jnp.swapaxes(Gjw, 1, 2)
    )

    if K % 32 == 0 and K >= 64:
        # parallel-in-K partitioned solve (sequential depth ~2m+S, not ~2K)
        sol = solve_block_tridiag_spike(A, C, rhs, m=32)
    else:
        Dinv = block_tridiag_factor(A, C)
        sol = block_tridiag_solve(Dinv, C, rhs)  # (K, 6, Rb+R)
    x0 = sol[:, :, :Rb]
    Y = sol[:, :, Rb:]  # (K, 6, R) = T'^-1 G^T

    def G_apply(V):  # V (K, 6, n) -> G V (L, 6, n) -> (R, n)
        return (
            jnp.einsum("eij,ejn->ein", Giw, V[li]) +
            jnp.einsum("eij,ejn->ein", Gjw, V[lj])
        ).reshape(R, -1)

    cap = jnp.eye(R, dtype=dtype) + G_apply(Y)  # SPD capacitance
    Gx0 = G_apply(x0)  # (R, Rb)
    Lc = jnp.linalg.cholesky(cap)
    z = jax.scipy.linalg.cho_solve((Lc, True), Gx0)
    out = x0 - jnp.einsum("kir,rn->kin", Y, z)
    return out[..., 0] if squeeze else out


# ---------------------------------------------------------------------------
# Pose-only solver
# ---------------------------------------------------------------------------


def _damped(Hdiag, lam):
    d = jnp.diagonal(Hdiag, axis1=1, axis2=2)  # (K, 6)
    damp = lam * jnp.maximum(d, 1.0)
    ii = jnp.arange(6)
    return Hdiag.at[:, ii, ii].add(damp)


@partial(jax.jit, static_argnames=("cfg",))
def optimize_graph_sparse(
    poses0, graph: GraphData, cfg: SolveConfig = SolveConfig()
) -> SparseSolveResult:
    """LM over the block-sparse normal equations. Semantics match
    `optimize_graph` (same factors, damping, accept rule); only the linear
    solve differs: preconditioned CG instead of dense Cholesky."""
    K = poses0.shape[0]
    dtype = poses0.dtype
    f = graph.between

    def lin(poses):
        Hdiag, Hoff, b, chi2 = build_block_normal_equations(poses, graph)
        if cfg.fix_first:
            eye = jnp.eye(6, dtype=dtype)
            Hdiag = Hdiag.at[0].set(eye)
            touch0 = (f.i == 0) | (f.j == 0)
            Hoff = jnp.where(touch0[:, None, None], 0.0, Hoff)
            b = b.at[0].set(0.0)
        return Hdiag, Hoff, b, chi2

    def solve(poses, Hdiag, Hoff, b, lam):
        A = _damped(Hdiag, lam)
        C = _chain_upper_blocks(Hoff, f.i, f.j, K, dtype)
        if cfg.solver == "direct":
            # under fix_first an edge touching pose 0 degenerates to a diag
            # contribution at its free endpoint (already inside A): exclude
            # it from the low-rank correction
            fw = f if not cfg.fix_first else f._replace(
                mask=f.mask & (f.i != 0) & (f.j != 0)
            )
            return solve_tridiag_woodbury(
                A, C, poses, fw, -b, cfg.loop_capacity
            )
        Dinv = block_tridiag_factor(A, C)

        def mv(x):
            y = jnp.einsum("kij,kj->ki", A, x)
            y = y.at[f.i].add(jnp.einsum("eij,ej->ei", Hoff, x[f.j]))
            y = y.at[f.j].add(jnp.einsum("eji,ej->ei", Hoff, x[f.i]))
            return y

        x, _ = jax.scipy.sparse.linalg.cg(
            mv, -b, M=lambda v: block_tridiag_solve(Dinv, C, v), maxiter=cfg.cg_iters
        )
        return x

    def body(state):
        poses, lam, chi2_prev, it, done, Hd_last = state
        Hdiag, Hoff, b, chi2 = lin(poses)
        delta = solve(poses, Hdiag, Hoff, b, lam)
        if cfg.fix_first:
            delta = delta.at[0].set(0.0)
        poses_new = jax.vmap(retract)(poses, delta)
        chi2_new = graph_chi2(poses_new, graph)
        accept = chi2_new < chi2
        poses_out = jnp.where(accept, poses_new, poses)
        lam_out = jnp.where(accept, lam / cfg.lm_lambda_factor, lam * cfg.lm_lambda_factor)
        rel = jnp.abs(chi2 - chi2_new) / jnp.maximum(chi2, 1e-30)
        done_new = accept & (rel < cfg.rel_tol)
        return poses_out, lam_out, jnp.where(accept, chi2_new, chi2), it + 1, done_new, Hdiag

    def cond(state):
        _, _, _, it, done, _ = state
        return (it < cfg.max_iterations) & (~done)

    Hd0 = jnp.broadcast_to(jnp.eye(6, dtype=dtype), (K, 6, 6))
    init = (
        poses0, jnp.asarray(cfg.lm_lambda_init, dtype), jnp.asarray(jnp.inf, dtype),
        0, False, Hd0,
    )
    poses, lam, chi2, iters, _, Hd = jax.lax.while_loop(cond, body, init)
    return SparseSolveResult(
        poses=poses, chi2=chi2, iterations=iters, lm_lambda=lam, H_diag=Hd
    )


# ---------------------------------------------------------------------------
# Joint pose + plane solver
# ---------------------------------------------------------------------------


def _plane_block_terms(poses, planes, pg: PlaneGraphData):
    """Block contributions of the plane-extension families:
    pose diag (K,6,6), pose-pose off blocks for z_between (E2,6,6),
    dense plane block (3M,3M), pose-plane cross blocks (F,6,3),
    gradients, chi2. Mirrors `solver._plane_terms` without (K,K,...)."""
    K, M = poses.shape[0], planes.shape[0]
    dtype = poses.dtype
    z3 = jnp.zeros(3, dtype)
    z6 = jnp.zeros(6, dtype)

    Hx = jnp.zeros((K, 6, 6), dtype)
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

    # plane-plane (M is tiny: keep dense)
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

    # se3-plane: pose i observes plane j -> cross blocks
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
    Hx = Hx.at[f.i].add(jnp.einsum("fji,fjk,f->fik", Jxw, Jxw, w))
    Hpp = Hpp.at[f.j, f.j].add(jnp.einsum("fji,fjk,f->fik", Jpw, Jpw, w))
    Hxp = jnp.einsum("fji,fjk,f->fik", Jxw, Jpw, w)  # (F, 6, 3) cross blocks
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
    Hx = Hx.at[f.i].add(jnp.einsum("fji,fjk,f->fik", Jiw, Jiw, w))
    Hx = Hx.at[f.j].add(jnp.einsum("fji,fjk,f->fik", Jjw, Jjw, w))
    Hz_off = jnp.einsum("fji,fjk,f->fik", Jiw, Jjw, w)  # (E2, 6, 6)
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
    Hx = Hx.at[f.i].add(jnp.einsum("fji,fjk,f->fik", Jiw, Jiw, w))
    bx = bx.at[f.i].add(jnp.einsum("fji,fj,f->fi", Jiw, rw, w))
    chi2 = chi2 + c2

    return Hx, Hz_off, Hpp, Hxp, bx, bp, chi2


@partial(jax.jit, static_argnames=("cfg",))
def optimize_graph_with_planes_sparse(
    poses0,
    planes0,
    graph: GraphData,
    plane_graph: PlaneGraphData,
    cfg: SolveConfig = SolveConfig(),
) -> SparsePlaneSolveResult:
    """Joint LM over poses + plane vertices on the block-sparse system.
    The plane tail (3M coords) rides CG as a block-diagonal extension; the
    pose-plane cross blocks are exact in the matvec, absent from the
    preconditioner (one floor plane = rank-3 correction)."""
    K = poses0.shape[0]
    M = planes0.shape[0]
    dtype = poses0.dtype
    fb = graph.between
    fz = plane_graph.z_between
    fsp = plane_graph.se3_plane
    ii6 = jnp.arange(6)
    ii3 = jnp.arange(3)

    def lin(poses, planes):
        Hdiag, Hoff, b, chi2 = build_block_normal_equations(poses, graph)
        Hx, Hz_off, Hpp, Hxp, bx, bp, c2p = _plane_block_terms(poses, planes, plane_graph)
        Hdiag = Hdiag + Hx
        b = b + bx
        if cfg.fix_first:
            eye = jnp.eye(6, dtype=dtype)
            Hdiag = Hdiag.at[0].set(eye)
            Hoff = jnp.where(((fb.i == 0) | (fb.j == 0))[:, None, None], 0.0, Hoff)
            Hz_off = jnp.where(((fz.i == 0) | (fz.j == 0))[:, None, None], 0.0, Hz_off)
            Hxp_ = jnp.where((fsp.i == 0)[:, None, None], 0.0, Hxp)
            b = b.at[0].set(0.0)
        else:
            Hxp_ = Hxp
        return Hdiag, Hoff, Hz_off, Hpp, Hxp_, b, bp, chi2 + c2p

    def solve(poses, Hdiag, Hoff, Hz_off, Hpp, Hxp, b, bp, lam):
        A = _damped(Hdiag, lam)
        # damped dense plane block (3M, 3M)
        Hpp_d = jnp.transpose(Hpp, (0, 2, 1, 3)).reshape(3 * M, 3 * M)
        dp = jnp.diag(Hpp_d)
        Hpp_d = Hpp_d + jnp.diag(lam * jnp.maximum(dp, 1.0))
        C_direct = _chain_upper_blocks(Hoff, fb.i, fb.j, K, dtype)
        C_direct = C_direct + _chain_upper_blocks(Hz_off, fz.i, fz.j, K, dtype)
        if cfg.solver == "direct":
            # exact: pose block via tridiag+Woodbury (multi-RHS carries the
            # pose-plane coupling columns), then a dense Schur complement
            # over the 3M plane coordinates. Non-adjacent z_between edges are
            # not folded into the correction (the pipeline never creates
            # them); use solver="cg" for such graphs.
            M3 = 3 * M
            Gp = jnp.zeros((K, 6, M3), dtype)
            colp = 3 * fsp.j[:, None, None] + jnp.arange(3)[None, None, :]
            Gp = Gp.at[fsp.i[:, None, None], jnp.arange(6)[None, :, None], colp].add(Hxp)
            fw = fb if not cfg.fix_first else fb._replace(
                mask=fb.mask & (fb.i != 0) & (fb.j != 0)
            )
            B = jnp.concatenate([(-b)[..., None], Gp], -1)
            X = solve_tridiag_woodbury(A, C_direct, poses, fw, B, cfg.loop_capacity)
            contrib = jnp.einsum("fij,fin->fjn", Hxp, X[fsp.i])  # (F, 3, 1+M3)
            GtX = jnp.zeros((M3, 1 + M3), dtype).at[
                (3 * fsp.j)[:, None, None] + jnp.arange(3)[None, :, None],
                jnp.arange(1 + M3)[None, None, :],
            ].add(contrib)
            S = Hpp_d - GtX[:, 1:]
            rhs_p = -bp.reshape(-1) - GtX[:, 0]
            dpl = jnp.linalg.solve(S, rhs_p)
            dx = X[:, :, 0] - jnp.einsum("kin,n->ki", X[:, :, 1:], dpl)
            return dx, dpl.reshape(M, 3)
        Hpp_inv = jnp.linalg.inv(
            Hpp_d + 1e-12 * jnp.eye(3 * M, dtype=dtype)
        )
        # chain preconditioner over poses: between + chain z_between blocks
        C = C_direct
        Dinv = block_tridiag_factor(A, C)

        def mv(xt):
            x, xp = xt  # (K,6), (M,3)
            y = jnp.einsum("kij,kj->ki", A, x)
            y = y.at[fb.i].add(jnp.einsum("eij,ej->ei", Hoff, x[fb.j]))
            y = y.at[fb.j].add(jnp.einsum("eji,ej->ei", Hoff, x[fb.i]))
            y = y.at[fz.i].add(jnp.einsum("eij,ej->ei", Hz_off, x[fz.j]))
            y = y.at[fz.j].add(jnp.einsum("eji,ej->ei", Hz_off, x[fz.i]))
            y = y.at[fsp.i].add(jnp.einsum("fij,fj->fi", Hxp, xp[fsp.j]))
            yp = (Hpp_d @ xp.reshape(-1)).reshape(M, 3)
            yp = yp.at[fsp.j].add(jnp.einsum("fij,fi->fj", Hxp, x[fsp.i]))
            return (y, yp)

        def precond(vt):
            v, vp = vt
            return (
                block_tridiag_solve(Dinv, C, v),
                (Hpp_inv @ vp.reshape(-1)).reshape(M, 3),
            )

        (x, xp), _ = jax.scipy.sparse.linalg.cg(
            mv, (-b, -bp), M=precond, maxiter=cfg.cg_iters
        )
        return x, xp

    def full_chi2(poses, planes):
        return graph_chi2(poses, graph) + plane_graph_chi2(poses, planes, plane_graph)

    def body(state):
        poses, planes, lam, chi2_prev, it, done, Hd_last = state
        Hdiag, Hoff, Hz_off, Hpp, Hxp, b, bp, chi2 = lin(poses, planes)
        dx, dp = solve(poses, Hdiag, Hoff, Hz_off, Hpp, Hxp, b, bp, lam)
        if cfg.fix_first:
            dx = dx.at[0].set(0.0)
        poses_new = jax.vmap(retract)(poses, dx)
        planes_new = jax.vmap(retract_plane)(planes, dp)
        chi2_new = full_chi2(poses_new, planes_new)
        accept = chi2_new < chi2
        poses_out = jnp.where(accept, poses_new, poses)
        planes_out = jnp.where(accept, planes_new, planes)
        lam_out = jnp.where(accept, lam / cfg.lm_lambda_factor, lam * cfg.lm_lambda_factor)
        rel = jnp.abs(chi2 - chi2_new) / jnp.maximum(chi2, 1e-30)
        done_new = accept & (rel < cfg.rel_tol)
        return (
            poses_out, planes_out, lam_out, jnp.where(accept, chi2_new, chi2),
            it + 1, done_new, Hdiag,
        )

    def cond(state):
        _, _, _, _, it, done, _ = state
        return (it < cfg.max_iterations) & (~done)

    Hd0 = jnp.broadcast_to(jnp.eye(6, dtype=dtype), (K, 6, 6))
    init = (
        poses0, planes0, jnp.asarray(cfg.lm_lambda_init, dtype),
        jnp.asarray(jnp.inf, dtype), 0, False, Hd0,
    )
    poses, planes, lam, chi2, iters, _, Hd = jax.lax.while_loop(cond, body, init)
    return SparsePlaneSolveResult(
        poses=poses, planes=planes, chi2=chi2, iterations=iters, lm_lambda=lam, H_diag=Hd
    )
