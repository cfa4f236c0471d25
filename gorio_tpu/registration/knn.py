"""Brute-force nearest-neighbor search, blocked.

Replaces the reference's kd-trees (pcl::search::KdTree + nanoflann, SURVEY.md
§2 #13/#18) and the CUDA brute-force kNN (`fast_apdgicp/src/fast_gicp/cuda/
brute_force_knn.cu`): distances are computed block-by-block as
|q|^2 + |r|^2 - 2 q.r^T (one matmul per block) with masked padding, then
reduced with argmin / top_k. O(N*M) flops, exact, and free of data-dependent
control flow at SLAM scan sizes (2-30k points). `block` bounds the (block, M)
distance tile held in device memory.

The expansion needs full-f32 matmuls (`utils/jax_config.configure_jax`):
with points up to ~50 m out, q.r reaches ~2500 m^2, and a float32 matmul that
rounds its operands to TF32 (about 3 decimal digits, the GPU default) would
put errors of order 1 m^2 on distances compared against 0.01 m^2 voxel leaves
and metre-scale correspondence gates.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

_BIG = 1.0e12


def _block_dists(q_blk, ref, ref_valid_bias):
    """Squared distances (B, M) with invalid refs pushed to +inf."""
    qq = jnp.sum(q_blk * q_blk, axis=-1, keepdims=True)
    rr = jnp.sum(ref * ref, axis=-1)[None, :]
    d2 = qq + rr - 2.0 * (q_blk @ ref.T)
    return jnp.maximum(d2, 0.0) + ref_valid_bias[None, :]


@partial(jax.jit, static_argnames=("block",))
def nn1(query, ref, ref_mask=None, block: int = 1024):
    """1-NN: returns (idx (N,), sqdist (N,)). Exact."""
    n = query.shape[0]
    pad = (-n) % block
    q = jnp.concatenate([query, jnp.zeros((pad, 3), query.dtype)], axis=0)
    bias = jnp.zeros((ref.shape[0],), query.dtype)
    if ref_mask is not None:
        bias = jnp.where(ref_mask, 0.0, _BIG)

    def one_block(q_blk):
        idx = jnp.argmin(_block_dists(q_blk, ref, bias), axis=-1)
        # the winner's distance from coordinate differences: the expansion
        # cancels to ~1e-3 m^2 in float32 at 50 m, the difference does not
        diff = q_blk - ref[idx]
        return idx, jnp.sum(diff * diff, axis=-1) + bias[idx]

    idx, d2 = jax.lax.map(one_block, q.reshape(-1, block, 3))
    return idx.reshape(-1)[:n], d2.reshape(-1)[:n]


def nn1_select(query, ref, payload, ref_mask=None, block: int = 1024):
    """1-NN plus the winner's payload row: (idx (N,), sqdist (N,), payload[idx]
    (N, P)) — one row gather feeds the GICP linearize every field it needs.

    A fused Pallas Triton kernel for this (the running argmin in registers,
    the payload row loaded by index) was measured on an H100: 1.6-2x faster
    than this form alone, but no faster per frame of the fused frontend at
    the pipeline's 2,048 points, so it was removed (PERF.md, "Kernel
    decisions")."""
    idx, d2 = nn1(query, ref, ref_mask=ref_mask, block=block)
    return idx, d2, payload.astype(query.dtype)[idx]


@partial(jax.jit, static_argnames=("k", "block"))
def knn(query, ref, k: int, ref_mask=None, block: int = 512):
    """k-NN: returns (idx (N,k), sqdist (N,k)), ascending by distance."""
    n = query.shape[0]
    pad = (-n) % block
    q = jnp.concatenate([query, jnp.zeros((pad, 3), query.dtype)], axis=0)
    bias = jnp.zeros((ref.shape[0],), query.dtype)
    if ref_mask is not None:
        bias = jnp.where(ref_mask, 0.0, _BIG)

    def one_block(q_blk):
        d2 = _block_dists(q_blk, ref, bias)
        neg, idx = jax.lax.top_k(-d2, k)
        return idx, -neg

    idx, d2 = jax.lax.map(one_block, q.reshape(-1, block, 3))
    return idx.reshape(-1, k)[:n], d2.reshape(-1, k)[:n]


@partial(jax.jit, static_argnames=("block",))
def rbf_covariances(xyz, mask=None, kernel_width: float = 0.25, max_dist: float = 3.0,
                    block: int = 512):
    """RBF-kernel-weighted neighborhood mean/covariance per point.

    Counterpart of the CUDA `covariance_estimation_rbf`
    (`fast_apdgicp/src/fast_gicp/cuda/covariance_estimation_rbf.cu:67-110`,
    used by `FastVGICPCuda` with `NearestNeighborMethod::GPU_RBF_KERNEL`):
    every neighbor within `max_dist` contributes with weight
    w = exp(-kernel_width * d^2); the weighted second moment about the
    weighted mean is the covariance. Defaults mirror
    `fast_vgicp_cuda.cu:25-26` (kernel_width 0.25, max_dist 3.0). All-pairs
    blocked accumulation — three matmuls per block instead of a kd-tree.
    Returns (mean (N,3), cov (N,3,3), sum_w (N,))."""
    n = xyz.shape[0]
    pad = (-n) % block
    q = jnp.concatenate([xyz, jnp.zeros((pad, 3), xyz.dtype)], axis=0)
    bias = jnp.zeros((n,), xyz.dtype)
    if mask is not None:
        bias = jnp.where(mask, 0.0, _BIG)
    kw = jnp.asarray(kernel_width, xyz.dtype)
    md2 = jnp.asarray(max_dist, xyz.dtype) ** 2
    # second moments E[x x^T] need the 6 unique products of ref coordinates
    rx = xyz
    r2 = jnp.stack(
        [rx[:, 0] * rx[:, 0], rx[:, 0] * rx[:, 1], rx[:, 0] * rx[:, 2],
         rx[:, 1] * rx[:, 1], rx[:, 1] * rx[:, 2], rx[:, 2] * rx[:, 2]],
        axis=-1,
    )  # (N, 6)

    def one_block(q_blk):
        d2 = _block_dists(q_blk, xyz, bias)
        w = jnp.where(d2 <= md2, jnp.exp(-kw * d2), 0.0)  # (B, N)
        sum_w = jnp.sum(w, axis=-1)
        m1 = w @ rx  # (B, 3) weighted positions
        m2 = w @ r2  # (B, 6) second moments
        return sum_w, m1, m2

    sum_w, m1, m2 = jax.lax.map(one_block, q.reshape(-1, block, 3))
    sum_w = sum_w.reshape(-1)[:n]
    m1 = m1.reshape(-1, 3)[:n]
    m2 = m2.reshape(-1, 6)[:n]
    sw = jnp.maximum(sum_w, 1e-12)
    mean = m1 / sw[:, None]
    exx = jnp.stack(
        [jnp.stack([m2[:, 0], m2[:, 1], m2[:, 2]], -1),
         jnp.stack([m2[:, 1], m2[:, 3], m2[:, 4]], -1),
         jnp.stack([m2[:, 2], m2[:, 4], m2[:, 5]], -1)],
        axis=-2,
    ) / sw[:, None, None]
    cov = exx - mean[:, :, None] * mean[:, None, :]
    return mean, cov, sum_w


@partial(jax.jit, static_argnames=("block",))
def radius_count(query, ref, radius, ref_mask=None, block: int = 1024):
    """Number of valid refs within `radius` of each query (self included when
    query is in ref). Exact; replaces kd-tree radiusSearch for
    `pcl::RadiusOutlierRemoval` semantics."""
    n = query.shape[0]
    pad = (-n) % block
    q = jnp.concatenate([query, jnp.zeros((pad, 3), query.dtype)], axis=0)
    bias = jnp.zeros((ref.shape[0],), query.dtype)
    if ref_mask is not None:
        bias = jnp.where(ref_mask, 0.0, _BIG)
    r2 = jnp.asarray(radius, query.dtype) ** 2

    def one_block(q_blk):
        d2 = _block_dists(q_blk, ref, bias)
        return jnp.sum((d2 <= r2).astype(jnp.int32), axis=-1)

    cnt = jax.lax.map(one_block, q.reshape(-1, block, 3))
    return cnt.reshape(-1)[:n]
