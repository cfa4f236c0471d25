"""NDT (normal distributions transform) registration, P2D, batched.

Counterpart of `pclomp::NormalDistributionsTransform` +
`pclomp::VoxelGridCovariance` (`ndt_omp/include/pclomp/*`, SURVEY.md §2
#23-24) and of `NDTCuda` (#21): the voxel Gaussian map is built with one
sort + segment-reduce pass (mean/cov per voxel, eigenvalue inflation), the
KDTREE/DIRECT7/DIRECT1 neighbor search becomes a vectorized sorted-key lookup
of the 7 (or 1) face-adjacent voxels, and the Newton optimization uses
autodiff gradient + Hessian of the summed NDT score with a candidate-step
line search replacing More-Thuente (evaluating a fixed fan of step lengths in
parallel is cheaper on the device than a serial bracketing loop).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import lie
from ..core.pointcloud import PointCloud
from .lsq import LMResult


class NDTConfig(NamedTuple):
    """Defaults mirror `ndt_omp.h` / `ndt_omp_impl.hpp` and the align app."""

    resolution: float = 1.0
    outlier_ratio: float = 0.55
    step_size: float = 0.1
    max_iterations: int = 35
    transformation_epsilon: float = 1e-4
    min_points_per_voxel: int = 6
    eig_mult: float = 0.01  # min_covar_eigvalue_mult_
    neighborhood: str = "direct7"  # "direct1" | "direct7" | "direct27"
    voxel_capacity: int = 8192
    # dense lookup-table cells; scenes whose occupied bounding box exceeds
    # this wrap (collisions verify against `keys` and read as misses)
    table_size: int = 1 << 21
    # coarse-to-fine schedule (r4, `ndt_align_multires`): a short coarse pass
    # on a `coarse_scale`x-resolution map escapes the fine grid's rough
    # score basin in a few large steps, then a capped fine pass polishes.
    # On the ndt_omp benchmark pair it gives equal-or-better
    # score/fitness and strictly better rotation recovery over a 10-trial
    # perturbation battery. The reference has no
    # counterpart (single fixed resolution, `ndt_omp_impl.hpp:130-180`).
    coarse_scale: float = 2.0
    coarse_iterations: int = 4
    coarse_neighborhood: str = "direct1"
    fine_iterations: int = 8


class VoxelGaussianMap(NamedTuple):
    keys: jax.Array  # (V,) sorted int32 voxel keys (padding = sentinel)
    means: jax.Array  # (V, 3)
    inv_covs: jax.Array  # (V, 3, 3)
    valid: jax.Array  # (V,)
    origin: jax.Array  # (3,) shared grid origin for queries
    # dense lookup table: one gather replaces the 15-step binary search that
    # dominated the align profile (13.7 of 17.2 ms per correspondence pass)
    table: jax.Array  # (T+1,) int32 voxel index per linear cell, -1 = empty
    table_dims: jax.Array  # (2,) [dy, dz] linearization strides (dynamic values)
    # packed per-voxel payload [mu(3), c00,c01,c02,c11,c12,c22, 0...] so each
    # correspondence needs ONE contiguous-row gather (symmetric inv-cov in 6
    # entries: 40% less random-gather traffic than (3,3) + separate means)
    packed: jax.Array  # (V, 16)


_BITS = 10  # int32-safe without x64; 1024 cells/axis
# np.int32 keeps the arithmetic int32 under weak typing.
_SENTINEL = np.int32(2**30)


def _voxel_key_3d(ijk):
    return (ijk[..., 0] << (2 * _BITS)) | (ijk[..., 1] << _BITS) | ijk[..., 2]


def _point_ijk(xyz, resolution, origin):
    ijk = jnp.floor((xyz - origin) / resolution).astype(jnp.int32)
    return jnp.clip(ijk, 1, (1 << _BITS) - 2)  # 1-voxel margin for neighbors


@partial(jax.jit, static_argnames=("cfg",))
def build_voxel_map(cloud: PointCloud, cfg: NDTConfig = NDTConfig()) -> VoxelGaussianMap:
    """Parity: `VoxelGridCovariance::applyFilter` — per-voxel mean/cov with
    eigenvalue inflation, min-point gating."""
    n = cloud.capacity
    dtype = cloud.xyz.dtype
    V = cfg.voxel_capacity
    from ..core.pointcloud import masked_min_corner

    origin = masked_min_corner(cloud.xyz, cloud.mask, pad=2.0 * cfg.resolution)
    ijk = _point_ijk(cloud.xyz, cfg.resolution, origin)
    key = jnp.where(cloud.mask, _voxel_key_3d(ijk), _SENTINEL)
    order = jnp.argsort(key)
    key_s = key[order]
    xyz_s = cloud.xyz[order]
    mask_s = cloud.mask[order]
    is_head = jnp.concatenate([jnp.array([True]), key_s[1:] != key_s[:-1]])
    seg = jnp.cumsum(is_head.astype(jnp.int32)) - 1
    w = mask_s.astype(dtype)
    cnt = jax.ops.segment_sum(w, seg, num_segments=n)
    mean = jax.ops.segment_sum(xyz_s * w[:, None], seg, num_segments=n)
    mean = mean / jnp.maximum(cnt, 1.0)[:, None]
    centered = (xyz_s - mean[seg]) * w[:, None]
    cov = jax.ops.segment_sum(
        centered[:, :, None] * centered[:, None, :], seg, num_segments=n
    )
    cov = cov / jnp.maximum(cnt - 1.0, 1.0)[:, None, None]
    head_key = jax.ops.segment_min(jnp.where(mask_s, key_s, _SENTINEL), seg, num_segments=n)
    valid = cnt >= cfg.min_points_per_voxel

    # eigenvalue inflation (`voxel_grid_covariance_omp_impl.hpp`); closed-form
    # 3x3 eigh + inverse (the LAPACK lowerings run as loops)
    from ..core.linalg import inv3, sym_eigh3

    evals, evecs = sym_eigh3(cov + 1e-12 * jnp.eye(3, dtype=dtype))
    lam_max = evals[:, 2:3]
    evals_inf = jnp.maximum(evals, cfg.eig_mult * lam_max)
    cov_inf = jnp.einsum("vij,vj,vkj->vik", evecs, evals_inf, evecs)
    inv_cov = inv3(cov_inf + 1e-9 * jnp.eye(3, dtype=dtype))

    # keep first V voxels (sorted by key; padding key huge)
    take = min(V, n)
    keys_out = jnp.where(valid, head_key, _SENTINEL)[:take]
    order2 = jnp.argsort(keys_out)
    keys_sorted = keys_out[order2]
    valid_sorted = valid[:take][order2]

    # dense table: decode voxel ijk from the keys, linearize against the
    # occupied bounding box, scatter voxel indices (dump slot T for invalid)
    T = cfg.table_size
    ki = keys_sorted >> (2 * _BITS)
    kj = (keys_sorted >> _BITS) & ((1 << _BITS) - 1)
    kk = keys_sorted & ((1 << _BITS) - 1)
    dy = jnp.max(jnp.where(valid_sorted, kj, 0)) + 2
    dz = jnp.max(jnp.where(valid_sorted, kk, 0)) + 2
    lin = ((ki * dy + kj) * dz + kk) % T
    slot = jnp.where(valid_sorted, lin, T)
    table = jnp.full((T + 1,), -1, jnp.int32).at[slot].set(
        jnp.arange(take, dtype=jnp.int32)
    )
    means_s = mean[:take][order2]
    inv_s = inv_cov[:take][order2]
    packed = jnp.zeros((take, 16), dtype)
    packed = packed.at[:, 0:3].set(means_s)
    packed = packed.at[:, 3].set(inv_s[:, 0, 0])
    packed = packed.at[:, 4].set(inv_s[:, 0, 1])
    packed = packed.at[:, 5].set(inv_s[:, 0, 2])
    packed = packed.at[:, 6].set(inv_s[:, 1, 1])
    packed = packed.at[:, 7].set(inv_s[:, 1, 2])
    packed = packed.at[:, 8].set(inv_s[:, 2, 2])
    # the voxel key in two float-exact halves (<= 2^15 each) + validity:
    # correspondence verification then needs ONLY the packed-row gather
    # (key match against the query subsumes the `valid`/`keys` gathers)
    key_chk = jnp.where(valid_sorted, keys_sorted, _SENTINEL)
    packed = packed.at[:, 9].set((key_chk >> 15).astype(dtype))
    packed = packed.at[:, 10].set((key_chk & 0x7FFF).astype(dtype))
    return VoxelGaussianMap(
        keys=keys_sorted,
        means=means_s,
        inv_covs=inv_s,
        valid=valid_sorted,
        origin=origin,
        table=table,
        table_dims=jnp.stack([dy, dz]),
        packed=packed,
    )


_NEIGHBOR_OFFSETS = {
    "direct1": [(0, 0, 0)],
    "direct7": [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)],
    "direct27": [
        (i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)
    ],
    # KDTREE mode (`ndt_omp_impl.hpp:234-235`): radiusSearch over occupied
    # voxel centroids with radius = resolution. Candidate voxels are the 27
    # neighbors; a centroid-distance gate (applied in `_neighbor_gate`)
    # reproduces the radius semantics without a tree.
    "kdtree": [
        (i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)
    ],
}


def _neighbor_gate(found, query_xyz, mu, cfg: "NDTConfig"):
    """Extra centroid-radius gate for the KDTREE neighbor mode; identity for
    the DIRECT modes (whose voxel-offset membership is the whole criterion)."""
    if cfg.neighborhood != "kdtree":
        return found
    d2 = jnp.sum((query_xyz[:, None, :] - mu) ** 2, axis=-1)
    return found & (d2 <= jnp.asarray(cfg.resolution**2, d2.dtype))


def _gauss_coeffs(cfg: NDTConfig, dtype):
    """d1/d2 from outlier ratio and resolution (`ndt_omp_impl.hpp:55-77`)."""
    gauss_c1 = 10.0 * (1.0 - cfg.outlier_ratio)
    gauss_c2 = cfg.outlier_ratio / (cfg.resolution**3)
    gauss_d3 = -jnp.log(gauss_c2)
    d1 = -jnp.log(gauss_c1 + gauss_c2) - gauss_d3
    d2 = -2.0 * jnp.log((-jnp.log(gauss_c1 * jnp.exp(-0.5) + gauss_c2) - gauss_d3) / d1)
    return jnp.asarray(d1, dtype), jnp.asarray(d2, dtype)


def _lookup(vmap_keys, query_keys):
    """Sorted-key exact lookup (binary search): returns (idx, found).
    Kept as the fallback for the dense-table path below."""
    pos = jnp.searchsorted(vmap_keys, query_keys)
    pos = jnp.clip(pos, 0, vmap_keys.shape[0] - 1)
    found = vmap_keys[pos] == query_keys
    return pos, found


def _table_lookup(keys, table, table_dims, table_size, ijk):
    """One-gather voxel lookup via the dense table; collisions/out-of-box
    cells verify against `keys` and read as misses. ijk (..., 3) int32."""
    key = _voxel_key_3d(ijk)
    dy, dz = table_dims[0], table_dims[1]
    lin = ((ijk[..., 0] * dy + ijk[..., 1]) * dz + ijk[..., 2]) % table_size
    idx = table[lin]
    found = idx >= 0
    idx_safe = jnp.where(found, idx, 0)
    found = found & (keys[idx_safe] == key)
    return idx_safe, found


@partial(jax.jit, static_argnames=("cfg",))
def ndt_score(source: PointCloud, vmap: VoxelGaussianMap, T, cfg: NDTConfig = NDTConfig()):
    """Summed NDT score (negated likelihood; lower is better) of source under
    the target voxel map at pose T."""
    d1, d2 = _gauss_coeffs(cfg, source.xyz.dtype)
    moved = source.xyz @ T[:3, :3].T + T[:3, 3]
    ijk = _point_ijk(moved, cfg.resolution, vmap.origin)
    offsets = jnp.asarray(_NEIGHBOR_OFFSETS[cfg.neighborhood], jnp.int32)  # (O, 3)
    idx, found = _table_lookup(
        vmap.keys, vmap.table, vmap.table_dims, cfg.table_size,
        ijk[:, None, :] + offsets[None, :, :],
    )
    found = found & vmap.valid[idx] & source.mask[:, None]
    found = _neighbor_gate(found, moved, vmap.means[idx], cfg)
    diff = moved[:, None, :] - vmap.means[idx]  # (N, O, 3)
    md2 = jnp.einsum("noi,noij,noj->no", diff, vmap.inv_covs[idx], diff)
    # gauss_d1 < 0, so each matched pair contributes a negative score; the
    # reference maximizes -d1*exp (likelihood, `ndt_omp_impl.hpp:252`) — we
    # keep the equivalent minimization convention (lower = better).
    score = d1 * jnp.exp(-0.5 * d2 * md2)
    return jnp.sum(jnp.where(found, score, 0.0))


def _unpack(P):
    """Packed rows -> (mu (..., 3), C (..., 3, 3))."""
    mu = P[..., 0:3]
    c00, c01, c02 = P[..., 3], P[..., 4], P[..., 5]
    c11, c12, c22 = P[..., 6], P[..., 7], P[..., 8]
    C = jnp.stack(
        [
            jnp.stack([c00, c01, c02], -1),
            jnp.stack([c01, c11, c12], -1),
            jnp.stack([c02, c12, c22], -1),
        ],
        -2,
    )
    return mu, C


def _gather_correspondences(source, vmap, T, cfg):
    """Neighbor-voxel gather at pose T: (found, mu, c6) with c6 the 6
    symmetric inverse-covariance components, each (N, O, ...).

    TWO random gathers total per correspondence — the dense table cell and
    the packed payload row; key verification and validity ride inside the
    payload (cols 9/10 hold the voxel key in float-exact halves), replacing
    the separate `keys`/`valid` gathers that made the gather pass ~70% of an
    NDT iteration (measured in-program r4)."""
    moved = source.xyz @ T[:3, :3].T + T[:3, 3]
    ijk3 = _point_ijk(moved, cfg.resolution, vmap.origin)
    offsets = jnp.asarray(_NEIGHBOR_OFFSETS[cfg.neighborhood], jnp.int32)
    ijk = ijk3[:, None, :] + offsets[None, :, :]
    key = _voxel_key_3d(ijk)
    dy, dz = vmap.table_dims[0], vmap.table_dims[1]
    lin = ((ijk[..., 0] * dy + ijk[..., 1]) * dz + ijk[..., 2]) % cfg.table_size
    idx = vmap.table[lin]
    found = idx >= 0
    idx = jnp.where(found, idx, 0)
    P = vmap.packed[idx]  # (N, O, 16)
    key_hi = (key >> 15).astype(P.dtype)
    key_lo = (key & 0x7FFF).astype(P.dtype)
    found = found & (P[..., 9] == key_hi) & (P[..., 10] == key_lo)
    found = found & source.mask[:, None]
    mu, c6 = _unpack6(P)
    found = _neighbor_gate(found, moved, mu, cfg)
    return found, mu, c6


def _unpack6(P):
    """Packed rows -> (mu (..., 3), inv-cov components (xx, yy, zz, xy, xz,
    yz))."""
    return P[..., 0:3], (P[..., 3], P[..., 6], P[..., 8],
                         P[..., 4], P[..., 5], P[..., 7])


def _md2_comp(moved, mu, c):
    """Mahalanobis x^T C x in component form; moved (N, 3) broadcasts over
    the neighbor axis of mu/c (N, O, ...)."""
    e0 = moved[:, None, 0] - mu[..., 0]
    e1 = moved[:, None, 1] - mu[..., 1]
    e2 = moved[:, None, 2] - mu[..., 2]
    xx, yy, zz, xy, xz, yz = c
    q0 = xx * e0 + xy * e1 + xz * e2
    q1 = xy * e0 + yy * e1 + yz * e2
    q2 = xz * e0 + yz * e1 + zz * e2
    return e0 * q0 + e1 * q1 + e2 * q2, (e0, e1, e2), (q0, q1, q2)


def _score_cached(source, found, mu, c6, d1, d2, T):
    moved = source.xyz @ T[:3, :3].T + T[:3, 3]
    md2, _, _ = _md2_comp(moved, mu, c6)
    return jnp.sum(jnp.where(found, d1 * jnp.exp(-0.5 * d2 * md2), 0.0))


@partial(jax.jit, static_argnames=("cfg",))
def ndt_align_with_map(
    source: PointCloud,
    vmap_t: VoxelGaussianMap,
    init_T,
    cfg: NDTConfig = NDTConfig(),
) -> LMResult:
    """Newton iterations on the NDT score with parallel step-length search,
    against a prebuilt voxel map (the reference builds the map in
    `setInputTarget`, outside the timed `align()`).

    Parity: `computeTransformation`/`computeDerivatives` + `computeStepLengthMT`
    (`ndt_omp_impl.hpp:130-320,773-860`). Derivatives are the closed-form
    per-point gradient/Hessian of the exponential score (one fused batched
    pass, no autodiff; the rotation-curvature "point hessian" term is dropped
    — Gauss-Newton flavor — which the step-length search absorbs).
    Correspondence gathers are frozen during the line search, like the
    reference freezing correspondences inside `computeStepLengthMT`."""
    dtype = source.xyz.dtype
    d1, d2 = _gauss_coeffs(cfg, dtype)
    # the NDT score is nonconvex: its Hessian goes indefinite well inside the
    # convergence basin (observed on the ndt_omp benchmark pair), where the
    # damped-solve direction stops descending at moderate step lengths. The
    # parallel ladder therefore reaches down to 3e-3 — the analogue of
    # More-Thuente interval contraction (`ndt_omp_impl.hpp:773-860`), but as
    # one batched evaluation instead of a serial loop.
    alphas = jnp.asarray([1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 0.003], dtype)
    # candidate scoring only ranks steps; a strided quarter of the points is
    # statistically plenty and cuts the line-search bandwidth 4x
    ls_stride = 4
    src_ls = jax.tree.map(lambda x: x[::ls_stride], source)

    def derivatives(found, mu, c6, T):
        """g (6,), H (6,6) of the summed score at T (left-mult delta).

        Closed component form on (N, O) columns reduced by ONE
        (C, N*O) x (N*O,) matvec instead of an (N, O, 6, 6) einsum (the same
        form as the GICP linearize)."""
        moved = source.xyz @ T[:3, :3].T + T[:3, 3]
        md2, _, (q0, q1, q2) = _md2_comp(moved, mu, c6)
        e = jnp.exp(-0.5 * d2 * md2)
        coef = jnp.where(found, -d2 * d1 * e, 0.0)  # > 0 per matched pair
        score = jnp.sum(jnp.where(found, d1 * e, 0.0))
        m0 = moved[:, None, 0]
        m1 = moved[:, None, 1]
        m2 = moved[:, None, 2]
        xx, yy, zz, xy, xz, yz = c6
        # u = J^T C x with J = [-hat(m) | I]: u_rot = m x q, u_t = q
        u0 = m1 * q2 - m2 * q1
        u1 = m2 * q0 - m0 * q2
        u2 = m0 * q1 - m1 * q0
        # W = hat(m) C: columns w_j = m x Ccol_j (Ccol_0 = (xx,xy,xz) ...)
        def crossc(a0, a1, a2):
            return (m1 * a2 - m2 * a1, m2 * a0 - m0 * a2, m0 * a1 - m1 * a0)

        W0 = crossc(xx, xy, xz)  # column 0 of hatC, as 3 rows
        W1 = crossc(xy, yy, yz)
        W2 = crossc(xz, yz, zz)
        # rows of W: W[i][j] = Wj[i]
        def rr_col(i):  # rr[:, i] entries via rows of hat(m)
            return (
                -m2 * W1[i] + m1 * W2[i],
                m2 * W0[i] - m0 * W2[i],
                -m1 * W0[i] + m0 * W1[i],
            )

        r0 = rr_col(0)
        r1 = rr_col(1)
        r2 = rr_col(2)
        u = (u0, u1, u2, q0, q1, q2)
        cols = jnp.stack(
            [
                # rr upper (6): (0,0) (1,1) (2,2) (0,1) (0,2) (1,2)
                r0[0], r1[1], r2[2], r1[0], r2[0], r2[1],
                # rt = hat(m) C rows x cols (9): rt[i][j] = Wj[i]
                W0[0], W1[0], W2[0], W0[1], W1[1], W2[1], W0[2], W1[2], W2[2],
                # tt = C upper (6)
                xx, yy, zz, xy, xz, yz,
                # u (6)
                u0, u1, u2, q0, q1, q2,
                # u u^T upper (21)
            ]
            + [u[i] * u[j] for i in range(6) for j in range(i, 6)],
            axis=0,
        )  # (48, N, O)
        s = jax.lax.dot_general(
            cols.reshape(cols.shape[0], -1), coef.reshape(-1),
            (((1,), (0,)), ((), ())),
        )
        rr_m = jnp.stack([jnp.stack([s[0], s[3], s[4]]),
                          jnp.stack([s[3], s[1], s[5]]),
                          jnp.stack([s[4], s[5], s[2]])])
        rt_m = s[6:15].reshape(3, 3)
        tt_m = jnp.stack([jnp.stack([s[15], s[18], s[19]]),
                          jnp.stack([s[18], s[16], s[20]]),
                          jnp.stack([s[19], s[20], s[17]])])
        g = s[21:27]
        uu_flat = s[27:48]
        iu = jnp.asarray(
            [[0, 1, 2, 3, 4, 5], [1, 6, 7, 8, 9, 10], [2, 7, 11, 12, 13, 14],
             [3, 8, 12, 15, 16, 17], [4, 9, 13, 16, 18, 19],
             [5, 10, 14, 17, 19, 20]], jnp.int32)
        uu = uu_flat[iu]
        H = jnp.block([[rr_m, rt_m], [rt_m.T, tt_m]]) - d2 * uu
        return score, g, H

    def body(state):
        T, it, done, last_score = state
        found, mu, c6 = _gather_correspondences(source, vmap_t, T, cfg)
        found_ls = found[::ls_stride]
        mu_ls = mu[::ls_stride]
        c6_ls = tuple(c[::ls_stride] for c in c6)

        # Inner frozen-correspondence Newton steps: the gather is ~2/3 of an
        # iteration's cost, so each gather is amortized over several Newton
        # steps with the correspondences held fixed — the same freeze the
        # reference applies inside `computeStepLengthMT`, extended to whole
        # steps (classic ICP inner iterations). Acceptance uses the FULL
        # frozen-correspondence objective: strided scores only RANK steps
        # (subsample-level "improvements" walked the pose off the optimum).
        def inner(carry, _):
            Ti, any_improved, _last_norm = carry
            score_now, g, H = derivatives(found, mu, c6, Ti)
            # Modified Newton: damp by a Gershgorin lower bound (cheap; the
            # NDT Hessian goes indefinite well inside the basin)
            absH = jnp.abs(H)
            gersh_lo = jnp.min(
                jnp.diag(H) - (jnp.sum(absH, axis=1) - jnp.abs(jnp.diag(H)))
            )
            floor = 1e-4 * jnp.maximum(jnp.max(jnp.diag(absH)), 1.0)
            shift = jnp.maximum(floor, floor - gersh_lo)
            d = -jnp.linalg.solve(H + shift * jnp.eye(6, dtype=dtype), g)
            d_norm = jnp.linalg.norm(d)
            d_capped = jnp.where(d_norm > 1.0, d / jnp.maximum(d_norm, 1e-12), d)
            g_dir = -g / jnp.maximum(jnp.linalg.norm(g), 1e-12)
            cand = jnp.concatenate(
                [alphas[:, None] * d_capped[None, :], alphas[:4, None] * g_dir[None, :]]
            )
            scores_ls = jax.vmap(
                lambda dd: _score_cached(
                    src_ls, found_ls, mu_ls, c6_ls, d1, d2, lie.se3_exp_split(dd) @ Ti
                )
            )(cand)
            best = jnp.argmin(scores_ls)
            T_best = lie.se3_exp_split(cand[best]) @ Ti
            score_best = _score_cached(source, found, mu, c6, d1, d2, T_best)
            improved = score_best < score_now
            T_new = jnp.where(improved, T_best, Ti)
            # norm of the APPLIED update (0 when rejected): feeds the
            # reference's transformation_epsilon stop (`ndt_omp_impl.hpp:173`
            # `delta_p_norm < transformation_epsilon_` ends the Newton loop)
            step_norm = jnp.where(
                improved, jnp.linalg.norm(cand[best]), jnp.zeros((), dtype)
            )
            return (T_new, any_improved | improved,
                    jnp.maximum(_last_norm, step_norm)), jnp.where(
                improved, score_best, score_now
            )

        (T_new, any_imp, max_norm), scores_seq = jax.lax.scan(
            inner, (T, False, jnp.zeros((), dtype)), None, length=3
        )
        # stop on: no inner step improved, OR every applied Newton update in
        # this outer iteration shrank below transformation_epsilon (the
        # reference's `delta_p_norm < transformation_epsilon_` convergence
        # test, `ndt_omp_impl.hpp:159`, taken over the inner block — without
        # it the loop burns ~2x the iterations polishing digits that move
        # neither fitness nor the recovered pose)
        done_new = (~any_imp) | (max_norm < cfg.transformation_epsilon)
        return T_new, it + 1, done_new, scores_seq[-1]

    def cond(state):
        _, it, done, _ = state
        return (it < cfg.max_iterations) & (~done)

    init_score = ndt_score(source, vmap_t, init_T, cfg)
    T, iters, _, final_score = jax.lax.while_loop(
        cond, body, (init_T, 0, False, init_score)
    )
    found, mu, c6 = _gather_correspondences(source, vmap_t, T, cfg)
    _, _, H = derivatives(found, mu, c6, T)
    return LMResult(
        T=T, H=H, error=final_score, converged=jnp.array(True), iterations=iters
    )


def ndt_align(
    source: PointCloud,
    target: PointCloud,
    init_T=None,
    cfg: NDTConfig = NDTConfig(),
) -> LMResult:
    """Build the target voxel map + align (the one-shot convenience API)."""
    if init_T is None:
        init_T = jnp.eye(4, dtype=source.xyz.dtype)
    vmap_t = build_voxel_map(target, cfg)
    return ndt_align_with_map(source, vmap_t, init_T, cfg)


def coarse_cfg(cfg: NDTConfig) -> NDTConfig:
    """Derived config for the coarse stage of `ndt_align_multires`."""
    return cfg._replace(
        resolution=cfg.resolution * cfg.coarse_scale,
        neighborhood=cfg.coarse_neighborhood,
        max_iterations=cfg.coarse_iterations,
    )


@partial(jax.jit, static_argnames=("cfg",))
def ndt_align_multires(
    source: PointCloud,
    vmap_coarse: VoxelGaussianMap,
    vmap_fine: VoxelGaussianMap,
    init_T,
    cfg: NDTConfig = NDTConfig(),
) -> LMResult:
    """Coarse-to-fine NDT: a few Newton iterations against the
    `coarse_scale`x-resolution map (smooth, wide basin — large steps), then a
    capped fine pass at `cfg.resolution`.

    Rationale (measured on the ndt_omp benchmark pair, see NDTConfig): the
    1 m-resolution NDT score is rough enough that the single-resolution
    Newton loop creeps in ~1 cm accepted steps for ~20 iterations; the
    coarse stage crosses that terrain in 4 steps, and the fine stage then
    converges in <8. Both maps come from `build_voxel_map` on the same
    target (coarse via `coarse_cfg(cfg)`), mirroring `setInputTarget`'s
    untimed map build."""
    rc = ndt_align_with_map(source, vmap_coarse, init_T, coarse_cfg(cfg))
    # fine-stage budget: `fine_iterations` (the schedule's own knob), never
    # exceeding the caller's `max_iterations` — a caller asking for FEWER
    # total iterations than the schedule default is respected; raising the
    # fine budget is done via `fine_iterations` (see `select_registration`)
    rf = ndt_align_with_map(
        source, vmap_fine, rc.T,
        cfg._replace(max_iterations=min(cfg.max_iterations, cfg.fine_iterations)),
    )
    return rf._replace(iterations=rc.iterations + rf.iterations)


def ndt_align_cf(
    source: PointCloud,
    target: PointCloud,
    init_T=None,
    cfg: NDTConfig = NDTConfig(),
) -> LMResult:
    """One-shot coarse-to-fine convenience: builds both maps + aligns."""
    if init_T is None:
        init_T = jnp.eye(4, dtype=source.xyz.dtype)
    vm_c = build_voxel_map(target, coarse_cfg(cfg))
    vm_f = build_voxel_map(target, cfg)
    return ndt_align_multires(source, vm_c, vm_f, init_T, cfg)


# ---- D2D NDT (distribution-to-distribution) --------------------------------


@partial(jax.jit, static_argnames=("cfg",))
def ndt_d2d_align_with_maps(
    vmap_s: VoxelGaussianMap,
    vmap_t: VoxelGaussianMap,
    init_T,
    cfg: NDTConfig = NDTConfig(),
) -> LMResult:
    """Distribution-to-distribution NDT: align the source voxel Gaussians to
    the target voxel Gaussians.

    Parity: `NDTCuda` in D2D mode (`fast_apdgicp/src/fast_gicp/cuda/
    ndt_compute_derivatives.cu`, SURVEY.md §2 #21): each matched voxel pair
    contributes exp score on x = T(mu_a) - mu_b under the combined covariance
    (C_b + R C_a R^T)^-1. Gauss-Newton flavor: the Mahalanobis matrix is
    frozen at the current T inside each linearization (like the GICP family),
    and the candidate-step line search absorbs the dropped curvature terms."""
    dtype = vmap_s.means.dtype
    d1, d2 = _gauss_coeffs(cfg, dtype)
    from ..core.linalg import inv3

    means_a = vmap_s.means
    cov_a = inv3(vmap_s.inv_covs + 1e-12 * jnp.eye(3, dtype=dtype))
    mask_a = vmap_s.valid
    offsets = jnp.asarray(_NEIGHBOR_OFFSETS[cfg.neighborhood], jnp.int32)

    def correspondences(T):
        moved = means_a @ T[:3, :3].T + T[:3, 3]
        ijk = _point_ijk(moved, cfg.resolution, vmap_t.origin)
        idx, found = _table_lookup(
            vmap_t.keys, vmap_t.table, vmap_t.table_dims, cfg.table_size,
            ijk[:, None, :] + offsets[None, :, :],
        )
        found = found & vmap_t.valid[idx] & mask_a[:, None]
        mu_b = vmap_t.means[idx]  # (V, O, 3)
        cov_b = inv3(vmap_t.inv_covs[idx] + 1e-12 * jnp.eye(3, dtype=dtype))
        R = T[:3, :3]
        comb = cov_b + (R @ cov_a @ R.T)[:, None, :, :]
        M = inv3(comb + 1e-9 * jnp.eye(3, dtype=dtype))
        return found, mu_b, M

    def score_at(found, mu_b, M, T):
        moved = means_a @ T[:3, :3].T + T[:3, 3]
        x = moved[:, None, :] - mu_b
        md2 = jnp.einsum("voi,voij,voj->vo", x, M, x)
        return jnp.sum(jnp.where(found, d1 * jnp.exp(-0.5 * d2 * md2), 0.0))

    def derivatives(found, mu_b, M, T):
        moved = means_a @ T[:3, :3].T + T[:3, 3]
        x = moved[:, None, :] - mu_b
        Mx = jnp.einsum("voij,voj->voi", M, x)
        md2 = jnp.einsum("voi,voi->vo", x, Mx)
        e = jnp.exp(-0.5 * d2 * md2)
        coef = jnp.where(found, -d2 * d1 * e, 0.0)
        hm = lie.hat(moved)  # (V, 3, 3)
        u_rot = jnp.einsum("vij,voj->voi", hm, Mx)
        u = jnp.concatenate([u_rot, Mx], axis=-1)
        g = jnp.einsum("vo,voi->i", coef, u)
        MhmT = jnp.einsum("voij,vkj->voik", M, hm)
        rr = jnp.einsum("vij,vojk->voik", hm, MhmT)
        rt = jnp.einsum("vij,vojk->voik", hm, M)
        JTJ = jnp.concatenate(
            [
                jnp.concatenate([rr, rt], axis=-1),
                jnp.concatenate([jnp.swapaxes(rt, -1, -2), M], axis=-1),
            ],
            axis=-2,
        )
        # PSD Gauss-Newton Hessian only (coef > 0): the -d2 u u^T curvature
        # term makes H indefinite at the voxel-pair counts of D2D and sends
        # the Newton step uphill; GN keeps a guaranteed descent direction
        H = jnp.einsum("vo,voij->ij", coef, JTJ)
        return g, H

    # wide log fan: D2D's exponential score has a narrow basin (voxel-scale),
    # so candidate steps span 3 decades for both the GN and gradient rays
    alphas = jnp.asarray([1.0, 0.3, 0.1, 0.03, 0.01, 0.003, 0.001], dtype)

    def body(state):
        T, it, done, last = state
        found, mu_b, M, = correspondences(T)
        g, H = derivatives(found, mu_b, M, T)
        lam = 1e-4 * jnp.maximum(jnp.max(jnp.abs(jnp.diag(H))), 1.0)
        d = -jnp.linalg.solve(H + lam * jnp.eye(6, dtype=dtype), g)
        dn = jnp.linalg.norm(d)
        d = jnp.where(dn > 1.0, d / jnp.maximum(dn, 1e-12), d)
        # gradient-descent fallback candidates guard against an indefinite H
        # (the exponential score is nonconvex), like the P2D search above
        g_dir = -g / jnp.maximum(jnp.linalg.norm(g), 1e-12)
        cand = jnp.concatenate(
            [alphas[:, None] * d[None, :], alphas[:, None] * g_dir[None, :]]
        )
        score_now = score_at(found, mu_b, M, T)
        scores = jax.vmap(lambda dd: score_at(found, mu_b, M, lie.se3_exp_split(dd) @ T))(cand)
        best = jnp.argmin(scores)
        improved = scores[best] < score_now
        step = jnp.where(improved, cand[best], jnp.zeros(6, dtype))
        T_new = jnp.where(improved, lie.se3_exp_split(cand[best]) @ T, T)
        done_new = (~improved) | (jnp.linalg.norm(step) < cfg.transformation_epsilon)
        return T_new, it + 1, done_new, jnp.where(improved, scores[best], last)

    def cond(state):
        _, it, done, _ = state
        return (it < cfg.max_iterations) & (~done)

    f0, m0, M0 = correspondences(init_T)
    init_score = score_at(f0, m0, M0, init_T)
    T, iters, _, final_score = jax.lax.while_loop(cond, body, (init_T, 0, False, init_score))
    found, mu_b, M = correspondences(T)
    _, H = derivatives(found, mu_b, M, T)
    return LMResult(T=T, H=H, error=final_score, converged=jnp.array(True), iterations=iters)


def ndt_d2d_align(
    source: PointCloud,
    target: PointCloud,
    init_T=None,
    cfg: NDTConfig = NDTConfig(),
) -> LMResult:
    """Voxelize both clouds, then D2D-align their Gaussians."""
    if init_T is None:
        init_T = jnp.eye(4, dtype=source.xyz.dtype)
    return ndt_d2d_align_with_maps(
        build_voxel_map(source, cfg), build_voxel_map(target, cfg), init_T, cfg
    )
