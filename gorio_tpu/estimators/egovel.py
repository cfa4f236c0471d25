"""Doppler radar ego-velocity estimation — fully vectorized RANSAC + LSQ.

Counterpart of the REVE-derived estimator
(`4DRadarSLAM/src/radar_ego_velocity_estimator.cpp:60-303`,
`include/radar_ego_velocity_estimator.h:31-60`).

Model: each static radar return at unit direction r_hat measures the radial
speed y = r_hat . v_ego. The reference runs sequential RANSAC (sample 5 points,
Cholesky-solve a 3-dof LSQ, count inliers, refit). Here *all* hypotheses are
drawn and solved as one batch (`vmap` over a (iters, 5) index array), the
inlier counting is one (iters, N) masked matmul, and the refit is a masked
normal-equation solve — no data-dependent control flow, so the whole estimator
is a single fused XLA program and `vmap`s across scans.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.pointcloud import PointCloud


class EgoVelConfig(NamedTuple):
    """Parity with `radar_ego_velocity_estimator.h:31-60` defaults."""

    min_dist: float = 1.0
    max_dist: float = 400.0
    min_db: float = 0.0
    elevation_thresh_deg: float = 22.5
    azimuth_thresh_deg: float = 56.5
    doppler_velocity_correction_factor: float = 1.0
    thresh_zero_velocity: float = 0.05
    allowed_outlier_percentage: float = 0.30
    sigma_zero_velocity_x: float = 1.0e-3
    sigma_zero_velocity_y: float = 3.2e-3
    sigma_zero_velocity_z: float = 1.0e-2
    sigma_offset_radar_x: float = 0.0
    sigma_offset_radar_y: float = 0.0
    sigma_offset_radar_z: float = 0.0
    max_sigma_x: float = 0.2
    max_sigma_y: float = 0.2
    max_sigma_z: float = 0.2
    use_ransac: bool = True
    outlier_prob: float = 0.05
    success_prob: float = 0.995
    n_ransac_points: int = 5
    inlier_thresh: float = 0.5
    # Hypotheses rejecting more than this fraction of points fall back to
    # "all points are inliers" (`radar_ego_velocity_estimator.cpp:216-221`
    # hard-codes 0.05). Only used by reinsert_mode="reference".
    outlier_reinsert_ratio: float = 0.05
    # "consensus" (default): rank hypotheses by genuine consensus size, refit
    # on the winning inlier set, then `refine_rounds` of trimmed refinement.
    # "reference" reproduces `radar_ego_velocity_estimator.cpp:216-221`
    # bit for bit: any hypothesis rejecting > outlier_reinsert_ratio of the
    # points keeps ALL points as inliers. That heuristic poisons the refit
    # whenever > 5% of the gated returns are genuinely dynamic (every
    # hypothesis collapses to the same contaminated all-points fit, and the
    # weakly-observable v_z blows up) — see tests/test_egovel.py.
    reinsert_mode: str = "consensus"
    refine_rounds: int = 2
    # consensus mode draws at least this many hypotheses: the formula below
    # assumes outlier_prob=0.05 (-> 3 iterations), far too few when a dynamic
    # object occupies >5% of the gated FOV. Extra hypotheses are nearly free
    # here (one vmapped batch + one (iters, N) matmul).
    min_ransac_iters: int = 16

    @property
    def ransac_iter(self) -> int:
        """Parity with `radar_ego_velocity_estimator.h:137-141` (setRansacIter)."""
        base = int(
            math.log(1.0 - self.success_prob)
            / math.log(1.0 - (1.0 - self.outlier_prob) ** self.n_ransac_points)
        )
        if self.reinsert_mode == "consensus":
            return max(base, self.min_ransac_iters)
        return base


class EgoVelResult(NamedTuple):
    v: jax.Array  # (3,) ego velocity in radar frame
    sigma: jax.Array  # (3,) per-axis std
    inlier_mask: jax.Array  # (N,) bool — static (non-dynamic) returns
    valid_mask: jax.Array  # (N,) bool — points that passed the gates
    ok: jax.Array  # () bool
    zero_velocity: jax.Array  # () bool


def _gate(cloud: PointCloud, cfg: EgoVelConfig):
    """FOV/range/SNR gating; parity with `radar_ego_velocity_estimator.cpp:75-97`."""
    x, y, z = cloud.xyz[:, 0], cloud.xyz[:, 1], cloud.xyz[:, 2]
    r = jnp.linalg.norm(cloud.xyz, axis=-1)
    azimuth = jnp.arctan2(y, x)
    elevation = jnp.arctan2(jnp.sqrt(x * x + y * y), z) - jnp.pi / 2
    valid = (
        cloud.mask
        & (r > cfg.min_dist)
        & (r < cfg.max_dist)
        & (cloud.intensity > cfg.min_db)
        & (jnp.abs(azimuth) < jnp.deg2rad(cfg.azimuth_thresh_deg))
        & (jnp.abs(elevation) < jnp.deg2rad(cfg.elevation_thresh_deg))
    )
    r_safe = jnp.maximum(r, 1e-9)
    dirs = cloud.xyz / r_safe[:, None]
    return valid, dirs


def _masked_lstsq(H, y, w):
    """Solve argmin ||w*(H v - y)|| with 3 unknowns; returns (v, HtH_inv, ok)."""
    Hw = H * w[:, None]
    yw = y * w
    HtH = Hw.T @ Hw
    Hty = Hw.T @ yw
    # LDLT-equivalent: solve with jitter for degenerate masks
    jitter = 1e-9 * jnp.trace(HtH) + 1e-12
    A = HtH + jitter * jnp.eye(3, dtype=H.dtype)
    v = jnp.linalg.solve(A, Hty)
    return v, A, HtH


def estimate_ego_velocity(
    cloud: PointCloud, cfg: EgoVelConfig = EgoVelConfig(), key: jax.Array | None = None
) -> EgoVelResult:
    """Single-scan ego-velocity estimate; jittable & vmappable over scans.

    Parity with `RadarEgoVelocityEstimator::estimate` →
    `solve3DFullRansac` → `solve3DFull`
    (`radar_ego_velocity_estimator.cpp:60,172,252`)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    dtype = cloud.xyz.dtype
    valid, dirs = _gate(cloud, cfg)
    n = cloud.capacity
    y = cloud.doppler * cfg.doppler_velocity_correction_factor
    w_valid = valid.astype(dtype)
    n_valid = jnp.sum(w_valid)

    # --- zero-velocity detection (outlier-trimmed quantile of |doppler|) ---
    # reference: nth_element at (1 - allowed_outlier_percentage) of the valid
    # points (`radar_ego_velocity_estimator.cpp:102-108`)
    abs_dop = jnp.where(valid, jnp.abs(y), jnp.inf)
    sorted_dop = jnp.sort(abs_dop)
    q_idx = jnp.clip(
        (n_valid * (1.0 - cfg.allowed_outlier_percentage)).astype(jnp.int32), 0, n - 1
    )
    trimmed = sorted_dop[q_idx]
    zero_vel = trimmed < cfg.thresh_zero_velocity

    # --- batched RANSAC ---
    iters = cfg.ransac_iter
    k = cfg.n_ransac_points
    # Sample hypothesis index sets, restricted to valid points. With-replacement
    # sampling is fine: duplicate rows make a near-singular (jittered) solve
    # whose hypothesis simply scores poorly.
    p = w_valid / jnp.maximum(n_valid, 1.0)
    idx = jax.random.choice(key, n, shape=(iters, k), replace=True, p=p)
    H_all = dirs  # (N, 3)

    def solve_hyp(ids):
        Hs = H_all[ids]  # (k, 3)
        ys = y[ids]
        ws = w_valid[ids]
        v, _, _ = _masked_lstsq(Hs, ys, ws)
        return v

    v_hyp = jax.vmap(solve_hyp)(idx)  # (iters, 3)
    err = jnp.abs(y[None, :] - v_hyp @ H_all.T)  # (iters, N)
    inl = (err < cfg.inlier_thresh) & valid[None, :]
    n_inl = jnp.sum(inl, axis=1)
    if cfg.reinsert_mode == "reference":
        n_outl = n_valid.astype(jnp.int32) - n_inl
        # outlier-ratio sanity reinsertion (`radar_ego_velocity_estimator.cpp:
        # 216-221`): a hypothesis rejecting >5% of points keeps all valid
        # points as inliers.
        ratio = n_outl.astype(dtype) / jnp.maximum(n_valid, 1.0)
        reinsert = ratio > cfg.outlier_reinsert_ratio
        inl = jnp.where(reinsert[:, None], valid[None, :], inl)
        n_inl = jnp.sum(inl, axis=1)
        # Rank non-reinserted hypotheses above reinserted ones. (The
        # reference's sequential loop lets a reinserted "all points" set beat
        # every genuine consensus set; that defeats RANSAC whenever
        # > reinsert_ratio of the scene is dynamic. We keep the fallback — if
        # every hypothesis reinserts, the estimate degrades to the all-points
        # fit — but never let it shadow a clean consensus.)
        score = n_inl + jnp.where(reinsert, 0, n + 1)
        best = jnp.argmax(score)
        inlier_mask = inl[best]
    else:
        # consensus mode: the largest genuine consensus wins, then fixed-round
        # trimmed refinement (refit -> reclassify at inlier_thresh -> refit)
        # converges onto the static set. No blanket reinsertion: with real
        # dynamics in the FOV the rejected points are signal about the scene,
        # not noise to be averaged back in.
        best = jnp.argmax(n_inl)
        inlier_mask = inl[best]
        for _ in range(cfg.refine_rounds):
            v_r, _, _ = _masked_lstsq(H_all, y, inlier_mask.astype(dtype))
            err_r = jnp.abs(y - H_all @ v_r)
            inlier_mask = (err_r < cfg.inlier_thresh) & valid

    # --- refit on best inliers with sigma estimation ---
    w_in = inlier_mask.astype(dtype)
    n_in = jnp.sum(w_in)
    v_fit, A, HtH = _masked_lstsq(H_all, y, w_in)
    e = (H_all @ v_fit - y) * w_in
    dof = jnp.maximum(n_in - 3.0, 1.0)
    HtH_inv = jnp.linalg.inv(A)
    C = (e @ e) * HtH_inv / dof
    sigma = jnp.sqrt(jnp.maximum(jnp.diag(C), 0.0)) + jnp.array(
        [cfg.sigma_offset_radar_x, cfg.sigma_offset_radar_y, cfg.sigma_offset_radar_z], dtype
    )
    sigma_ok = (
        (sigma[0] < cfg.max_sigma_x) & (sigma[1] < cfg.max_sigma_y) & (sigma[2] < cfg.max_sigma_z)
    )

    zero_sigma = jnp.array(
        [cfg.sigma_zero_velocity_x, cfg.sigma_zero_velocity_y, cfg.sigma_zero_velocity_z], dtype
    )
    zero_inliers = valid & (jnp.abs(y) < cfg.thresh_zero_velocity)

    v_out = jnp.where(zero_vel, jnp.zeros(3, dtype), v_fit)
    sigma_out = jnp.where(zero_vel, zero_sigma, sigma)
    inlier_out = jnp.where(zero_vel, zero_inliers, inlier_mask)
    ok = (n_valid > 2) & (zero_vel | sigma_ok)
    return EgoVelResult(
        v=v_out,
        sigma=sigma_out,
        inlier_mask=inlier_out,
        valid_mask=valid,
        ok=ok,
        zero_velocity=zero_vel,
    )
