"""Voxelized GICP (VGICP): distribution-to-distribution over a voxel map.

Counterpart of `FastVGICP` (`fast_apdgicp/include/fast_gicp/
fast_vgicp.hpp` + impl, SURVEY.md §2 #20) and of the CUDA voxel pipeline
(#21 `FastVGICPCuda`): the target becomes a Gaussian voxel map (mean +
covariance per voxel, additive accumulation of the per-point regularized
covariances), correspondences are DIRECT1/7/27 voxel lookups of each
transformed source point, and the Mahalanobis distance uses
(C_voxel + T C_src T^T)^{-1}. Reuses the sorted-key voxel machinery from
`ndt.py` and the LM driver from `lsq.py`.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import lie
from ..core.pointcloud import PointCloud, masked_min_corner
from .gicp import _covariances, _inv3
from .lsq import LMConfig, LMResult, lm_optimize
from .ndt import _BITS, _NEIGHBOR_OFFSETS, _SENTINEL, _point_ijk, _table_lookup, _voxel_key_3d


class VGICPConfig(NamedTuple):
    resolution: float = 1.0
    k_correspondences: int = 20
    plane_eps: float = 1e-3
    neighborhood: str = "direct1"  # reference default DIRECT1 for fast_vgicp
    voxel_capacity: int = 8192
    min_points_per_voxel: int = 1
    table_size: int = 1 << 21
    lm: LMConfig = LMConfig()
    # "knn" (FastVGICP CPU) or "rbf" (FastVGICPCuda GPU_RBF_KERNEL)
    covariance_method: str = "knn"
    rbf_kernel_width: float = 0.25
    rbf_max_dist: float = 3.0


class GaussianVoxelMap(NamedTuple):
    keys: jax.Array
    means: jax.Array  # (V, 3)
    covs: jax.Array  # (V, 3, 3) accumulated regularized covariances
    counts: jax.Array  # (V,)
    valid: jax.Array
    origin: jax.Array
    table: jax.Array  # dense lookup table (see ndt.VoxelGaussianMap)
    table_dims: jax.Array


@partial(jax.jit, static_argnames=("cfg",))
def build_gaussian_voxel_map(cloud: PointCloud, cfg: VGICPConfig = VGICPConfig()) -> GaussianVoxelMap:
    """Additive voxel accumulation of per-point (PLANE-regularized) covariances
    — parity with `FastVGICP::create_voxelmap` (additive mode)."""
    n = cloud.capacity
    dtype = cloud.xyz.dtype
    pt_cov, _ = _covariances(cloud, cfg)
    origin = masked_min_corner(cloud.xyz, cloud.mask, pad=2.0 * cfg.resolution)
    ijk = _point_ijk(cloud.xyz, cfg.resolution, origin)
    key = jnp.where(cloud.mask, _voxel_key_3d(ijk), _SENTINEL)
    order = jnp.argsort(key)
    key_s = key[order]
    xyz_s = cloud.xyz[order]
    cov_s = pt_cov[order]
    mask_s = cloud.mask[order]
    is_head = jnp.concatenate([jnp.array([True]), key_s[1:] != key_s[:-1]])
    seg = jnp.cumsum(is_head.astype(jnp.int32)) - 1
    w = mask_s.astype(dtype)
    cnt = jax.ops.segment_sum(w, seg, num_segments=n)
    mean = jax.ops.segment_sum(xyz_s * w[:, None], seg, num_segments=n)
    mean = mean / jnp.maximum(cnt, 1.0)[:, None]
    cov = jax.ops.segment_sum(cov_s * w[:, None, None], seg, num_segments=n)
    cov = cov / jnp.maximum(cnt, 1.0)[:, None, None]
    head_key = jax.ops.segment_min(jnp.where(mask_s, key_s, _SENTINEL), seg, num_segments=n)
    valid = cnt >= cfg.min_points_per_voxel
    take = min(cfg.voxel_capacity, n)
    keys_out = jnp.where(valid, head_key, _SENTINEL)[:take]
    order2 = jnp.argsort(keys_out)
    keys_sorted = keys_out[order2]
    valid_sorted = valid[:take][order2]
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
    return GaussianVoxelMap(
        keys=keys_sorted,
        means=mean[:take][order2],
        covs=cov[:take][order2],
        counts=cnt[:take][order2],
        valid=valid_sorted,
        origin=origin,
        table=table,
        table_dims=jnp.stack([dy, dz]),
    )


@partial(jax.jit, static_argnames=("cfg",))
def _vgicp_align_jit(source, target, init_T, cfg: VGICPConfig) -> LMResult:
    dtype = source.xyz.dtype
    vmap_t = build_gaussian_voxel_map(target, cfg)
    src_cov, _ = _covariances(source, cfg)
    offsets = jnp.asarray(_NEIGHBOR_OFFSETS[cfg.neighborhood], jnp.int32)

    def correspondences(T):
        R = T[:3, :3]
        moved = source.xyz @ R.T + T[:3, 3]
        ijk = _point_ijk(moved, cfg.resolution, vmap_t.origin)
        idx, found = _table_lookup(
            vmap_t.keys, vmap_t.table, vmap_t.table_dims, cfg.table_size,
            ijk[:, None, :] + offsets[None, :, :],
        )
        found = found & vmap_t.valid[idx] & source.mask[:, None]
        cov_T = R @ src_cov @ R.T  # (N, 3, 3)
        RCR = vmap_t.covs[idx] + cov_T[:, None]  # (N, O, 3, 3)
        mah = _inv3(RCR)
        return idx, found, mah, moved

    def error_terms(T, idx, found, mah):
        moved = source.xyz @ T[:3, :3].T + T[:3, 3]
        err = vmap_t.means[idx] - moved[:, None, :]  # (N, O, 3)
        m_err = jnp.einsum("noij,noj->noi", mah, err)
        cost = jnp.sum(jnp.where(found, jnp.einsum("noi,noi->no", err, m_err), 0.0))
        return moved, err, m_err, cost

    def linearize(T):
        idx, found, mah, _ = correspondences(T)
        moved, err, m_err, cost = error_terms(T, idx, found, mah)
        sk = lie.hat(moved)  # (N, 3, 3)
        okf = found.astype(dtype)
        MS = jnp.einsum("noij,njk->noik", mah, sk)
        H_rr = jnp.einsum("nji,nojk,no->ik", sk, MS, okf)
        H_rt = -jnp.einsum("nji,nojk,no->ik", sk, mah, okf)
        H_tt = jnp.einsum("noij,no->ij", mah, okf)
        H = jnp.block([[H_rr, H_rt], [H_rt.T, H_tt]])
        b_r = jnp.einsum("nji,noj,no->i", sk, m_err, okf)
        b_t = -jnp.einsum("noi,no->i", m_err, okf)
        b = jnp.concatenate([b_r, b_t])
        return cost, H, b, (idx, found, mah)

    def compute_error(T, aux):
        idx, found, mah = aux
        return error_terms(T, idx, found, mah)[3]

    return lm_optimize(linearize, compute_error, init_T, cfg.lm)


def vgicp_align(
    source: PointCloud,
    target: PointCloud,
    init_T=None,
    cfg: VGICPConfig = VGICPConfig(),
) -> LMResult:
    """Jitted voxelized-GICP alignment (see gicp_align note on eager loops)."""
    if init_T is None:
        init_T = jnp.eye(4, dtype=source.xyz.dtype)
    return _vgicp_align_jit(source, target, init_T, cfg)
