"""Ground segmentation — batched Patchwork++ (Go-RIO variant).

Counterpart of the modified Patchwork++ in
`4DRadarSLAM/include/patchworkpp/patchworkpp.hpp` (SURVEY.md §2 #6):

  * CZM binning (`pc2czm`, `:1160`) becomes a per-point (zone, ring, sector)
    -> patch-id computation; Go-RIO's radar CZM is tiny (zones with
    rings {4,4,2,2} x sectors {3,1,1,3} = 24 patches, `Params`:165-166),
  * per-patch R-GPF plane fits (`extract_piecewiseground`, `:1024-1127`)
    become masked segment-reduce covariance + batched 3x3 eigh over ALL
    patches at once, iterated `num_iter` times,
  * seed selection (lowest-point representatives, `extract_initial_seeds`)
    uses a (P, N) masked top-k — exact, since P is tiny,
  * the Go-RIO covariance-weighted whole-ground refinement
    (`estimate_plane_cov`, `:497-585`, Ceres) becomes a few IRLS
    normal-equation solves with the same per-point polar covariances,
  * under-ground multipath removal (`:867-879`) masks points > 1 m below the
    refined plane.

A-GLE / TGR adaptive thresholds (`:894-1010`) are carried as an explicit
per-ring `AGLEState` the caller threads through frames (the reference mutates
per-ring member vectors `update_elevation_[r]` / `update_flatness_[r]`);
`update_agle` reproduces the per-ring mean+k*std update rules (ring 0 also
re-estimates the sensor height, `:903-905`), with a fixed-memory EMA standing
in for the reference's bounded sample buffers.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.pointcloud import PointCloud
from .covariances import polar_covariances


class GroundSegConfig(NamedTuple):
    """Defaults mirror `patchworkpp.hpp` Params (`:126-167`, Go-RIO values)."""

    sensor_height: float = 0.7
    num_iter: int = 4
    num_lpr: int = 20
    num_min_pts: int = 10
    th_seeds: float = 0.5
    th_dist: float = 1.0
    max_range: float = 50.0
    min_range: float = 1.0
    uprightness_thr: float = 0.5
    adaptive_seed_selection_margin: float = -1.2
    num_zones: int = 4
    rings_per_zone: tuple = (4, 4, 2, 2)
    sectors_per_zone: tuple = (3, 1, 1, 3)
    enable_RNR: bool = True
    rnr_ver_angle_thr: float = -15.0
    rnr_intensity_thr: float = 0.1
    # Go-RIO radar height gate for ground candidates (`:1102,1106`)
    radar_height_gate: float = 0.5
    underground_dist: float = -1.0  # `:874`
    refine_iters: int = 3
    # A-GLE / TGR (`patchworkpp.hpp:244`: num_rings_of_interest_ =
    # elevation_thr_.size(), 4 in the launch configs; `:986` line gate)
    num_rings_of_interest: int = 4
    line_variable_thresh: float = 8.0
    enable_TGR: bool = True

    @property
    def num_patches(self) -> int:
        return sum(r * s for r, s in zip(self.rings_per_zone, self.sectors_per_zone))

    @property
    def num_rings(self) -> int:
        return sum(self.rings_per_zone)


class GroundSegResult(NamedTuple):
    ground_mask: jax.Array  # (N,)
    nonground_mask: jax.Array  # (N,)
    removed_mask: jax.Array  # (N,) under-ground artifacts
    plane: jax.Array  # (4,) refined [nx, ny, nz, d], |n|=1, nz>0
    patch_normal: jax.Array  # (P, 3)
    patch_mean_z: jax.Array  # (P,)
    patch_valid: jax.Array  # (P,)
    patch_flatness: jax.Array  # (P,) smallest cov eigenvalue of the patch fit
    patch_stored: jax.Array  # (P,) A-GLE storage mask (`patchworkpp.hpp:794-800`)


class AGLEState(NamedTuple):
    """Per-ring adaptive ground-likelihood state (`patchworkpp.hpp:894-950`).

    The reference keeps per-ring sample buffers `update_elevation_[r]` /
    `update_flatness_[r]` (bounded by `max_*_storage_`) and recomputes
    thresholds as mean + k*std each frame. Here the running per-ring moments
    are EMA-tracked (fixed memory, jit-friendly); the derived thresholds
    follow the same rules: elevation ring 0 = mean + 3*std (and sensor_height
    = -mean, `:903-905`), rings 1+ = mean + 2*std (`:907`), flatness =
    mean + std (`:934`). Shapes are (num_rings_of_interest,).
    """

    elevation_thr: jax.Array  # (R,) derived elevation gates
    flatness_thr: jax.Array  # (R,) derived flatness gates
    elev_mean: jax.Array  # (R,) running elevation mean
    elev_var: jax.Array  # (R,) running elevation variance
    flat_mean: jax.Array  # (R,)
    flat_var: jax.Array  # (R,)
    count: jax.Array  # (R,) per-ring update counts
    sensor_height: jax.Array  # () adaptive; NaN until ring 0 has data

    @staticmethod
    def init(dtype=jnp.float64, rings: int = 4, cfg: "GroundSegConfig" = None):
        if cfg is not None:
            rings = cfg.num_rings_of_interest
        cold_elev = (1.0 - (cfg.sensor_height if cfg is not None else 0.7))
        return AGLEState(
            elevation_thr=jnp.full((rings,), cold_elev, dtype),
            flatness_thr=jnp.zeros(rings, dtype),
            elev_mean=jnp.zeros(rings, dtype),
            elev_var=jnp.zeros(rings, dtype),
            flat_mean=jnp.zeros(rings, dtype),
            flat_var=jnp.zeros(rings, dtype),
            count=jnp.zeros(rings, dtype),
            sensor_height=jnp.asarray(jnp.nan, dtype),
        )


def ring_of_patch(cfg: GroundSegConfig) -> np.ndarray:
    """Static (P,) concentric ring index per patch (the `concentric_idx`
    counter in `estimate_ground`'s zone/ring/sector loop, `:718-855`)."""
    out = np.zeros(cfg.num_patches, np.int32)
    offset, cring = 0, 0
    for z in range(cfg.num_zones):
        nr, ns = cfg.rings_per_zone[z], cfg.sectors_per_zone[z]
        for r in range(nr):
            out[offset + r * ns : offset + (r + 1) * ns] = cring + r
        offset += nr * ns
        cring += nr
    return out


def _zone_boundaries(cfg: GroundSegConfig):
    """Patchwork++ standard radial zone split."""
    mn, mx = cfg.min_range, cfg.max_range
    return [mn, (7 * mn + mx) / 8.0, (3 * mn + mx) / 4.0, (mn + mx) / 2.0, mx]


def _patch_ids(xyz, cfg: GroundSegConfig):
    """(zone, ring, sector) -> flat patch id; out-of-range -> P (dropped)."""
    r = jnp.linalg.norm(xyz[:, :2], axis=-1)
    theta = jnp.arctan2(xyz[:, 1], xyz[:, 0]) + jnp.pi  # [0, 2pi)
    bounds = _zone_boundaries(cfg)
    P = cfg.num_patches
    pid = jnp.full(xyz.shape[0], P, jnp.int32)
    offset = 0
    for z in range(cfg.num_zones):
        lo, hi = bounds[z], bounds[z + 1]
        in_zone = (r >= lo) & (r < hi)
        nr, ns = cfg.rings_per_zone[z], cfg.sectors_per_zone[z]
        ring = jnp.clip(((r - lo) / (hi - lo) * nr).astype(jnp.int32), 0, nr - 1)
        sector = jnp.clip((theta / (2 * jnp.pi) * ns).astype(jnp.int32), 0, ns - 1)
        pid = jnp.where(in_zone, offset + ring * ns + sector, pid)
        offset += nr * ns
    return pid


def _plane_from_masked(xyz, w, pid, P):
    """Per-patch PCA plane from weighted points: returns normal (P,3),
    d (P,), mean (P,3), count (P,), cov eigenvalues ascending (P,3)."""
    cnt = jax.ops.segment_sum(w, pid, num_segments=P + 1)[:P]
    mean = jax.ops.segment_sum(xyz * w[:, None], pid, num_segments=P + 1)[:P]
    mean = mean / jnp.maximum(cnt, 1.0)[:, None]
    centered = xyz - mean[jnp.clip(pid, 0, P - 1)]
    outer = centered[:, :, None] * centered[:, None, :] * w[:, None, None]
    cov = jax.ops.segment_sum(outer, pid, num_segments=P + 1)[:P]
    cov = cov / jnp.maximum(cnt, 1.0)[:, None, None]
    evals, evecs = jnp.linalg.eigh(cov + 1e-12 * jnp.eye(3, dtype=xyz.dtype))
    normal = evecs[:, :, 0]  # smallest eigenvalue
    normal = normal * jnp.where(normal[:, 2:3] < 0, -1.0, 1.0)
    d = -jnp.einsum("pi,pi->p", normal, mean)
    return normal, d, mean, cnt, evals


@partial(jax.jit, static_argnames=("cfg",))
def estimate_ground(
    cloud: PointCloud, cfg: GroundSegConfig = GroundSegConfig(), agle: AGLEState | None = None
) -> GroundSegResult:
    xyz = cloud.xyz
    n = cloud.capacity
    dtype = xyz.dtype
    P = cfg.num_patches

    # adaptive sensor height: ring-0 A-GLE re-estimates it each frame
    # (`patchworkpp.hpp:903-905`); NaN until warm -> config value
    if agle is not None:
        sh = jnp.where(
            jnp.isfinite(agle.sensor_height),
            agle.sensor_height.astype(dtype),
            jnp.asarray(cfg.sensor_height, dtype),
        )
    else:
        sh = jnp.asarray(cfg.sensor_height, dtype)

    valid = cloud.mask
    # RNR (`patchworkpp.hpp:657`): steep-downward low-intensity returns
    if cfg.enable_RNR:
        r2d = jnp.linalg.norm(xyz[:, :2], axis=-1)
        ver_deg = jnp.rad2deg(jnp.arctan2(xyz[:, 2], jnp.maximum(r2d, 1e-9)))
        noise = (
            (ver_deg < cfg.rnr_ver_angle_thr)
            & (cloud.intensity < cfg.rnr_intensity_thr)
            & (xyz[:, 2] < -sh - 0.8)
        )
        valid = valid & ~noise

    pid = jnp.where(valid, _patch_ids(xyz, cfg), P)

    # --- seeds: mean of the num_lpr lowest z per patch + th_seeds ----------
    z = xyz[:, 2]
    # adaptive seed margin: drop points far below -sensor_height (`:1177-1183`)
    seed_ok = z > cfg.adaptive_seed_selection_margin * sh
    # Go-RIO radar gate: ground candidates must sit near/below sensor height
    seed_ok = seed_ok & (z < -sh + cfg.radar_height_gate)
    big = jnp.asarray(1e9, dtype)
    z_mat = jnp.where(
        (pid[None, :] == jnp.arange(P, dtype=jnp.int32)[:, None]) & seed_ok[None, :],
        z[None, :],
        big,
    )  # (P, N)
    low_k, _ = jax.lax.top_k(-z_mat, cfg.num_lpr)  # (P, num_lpr) of -z
    low_k = -low_k
    k_valid = low_k < big / 2
    lpr = jnp.sum(jnp.where(k_valid, low_k, 0.0), axis=1) / jnp.maximum(
        jnp.sum(k_valid, axis=1), 1
    )
    ground = valid & seed_ok & (z < lpr[jnp.clip(pid, 0, P - 1)] + cfg.th_seeds) & (pid < P)

    # --- R-GPF iterations (`:1024-1127`) ----------------------------------
    normal = jnp.zeros((P, 3), dtype)
    dplane = jnp.zeros((P,), dtype)
    evals = jnp.zeros((P, 3), dtype)
    cnt = jnp.zeros((P,), dtype)
    mean = jnp.zeros((P, 3), dtype)
    for _ in range(cfg.num_iter):
        w = ground.astype(dtype)
        normal, dplane, mean, cnt, evals = _plane_from_masked(xyz, w, pid, P)
        dist = jnp.einsum("ni,ni->n", normal[jnp.clip(pid, 0, P - 1)], xyz) + dplane[
            jnp.clip(pid, 0, P - 1)
        ]
        ground = (
            valid
            & (pid < P)
            & (jnp.abs(dist) < cfg.th_dist)
            & (z < -sh + cfg.radar_height_gate)
        )

    # --- patch classification (uprightness + per-ring elevation A-GLE) + TGR
    # Mirrors the decision chain at `patchworkpp.hpp:780-826` with the stats
    # of `:756-760`: flatness = smallest cov eigenvalue, line_variable =
    # largest/middle, heading = mean . normal.
    flat = evals[:, 0]
    line_var = evals[:, 2] / jnp.maximum(evals[:, 1], 1e-12)
    heading_out = jnp.einsum("pi,pi->p", mean, normal) < 0.0
    upright = jnp.abs(normal[:, 2]) > cfg.uprightness_thr
    enough = cnt >= cfg.num_min_pts

    R = cfg.num_rings_of_interest
    ring_idx = jnp.asarray(ring_of_patch(cfg))  # (P,) static
    near = ring_idx < R
    ring_roi = jnp.clip(ring_idx, 0, R - 1)
    if agle is not None:
        elev_thr_p = agle.elevation_thr.astype(dtype)[ring_roi]
        flat_thr_p = agle.flatness_thr.astype(dtype)[ring_roi]
    else:
        elev_thr_p = jnp.full((P,), 1.0 - cfg.sensor_height, dtype)
        flat_thr_p = jnp.zeros((P,), dtype)
    not_elev = mean[:, 2] < elev_thr_p
    is_flat = flat < flat_thr_p

    # A-GLE storage mask (`:794-800`): upright near-zone patches passing the
    # elevation gate feed the per-ring threshold update + ringwise flatness
    stored = upright & enough & not_elev & near

    # decision chain (`:803-826`)
    patch_is_ground = upright & enough & (~near | (heading_out & (not_elev | is_flat)))
    candidate = upright & enough & near & heading_out & ~(not_elev | is_flat)

    if cfg.enable_TGR:
        # temporal ground revert (`:952-1010`): per-ring mean/std of this
        # frame's stored flatness; sigmoid revert probability, line-gate
        n_r = jax.ops.segment_sum(stored.astype(dtype), ring_roi, num_segments=R)
        f_sum = jax.ops.segment_sum(jnp.where(stored, flat, 0.0), ring_roi, num_segments=R)
        f_mean = f_sum / jnp.maximum(n_r, 1.0)
        f_sq = jax.ops.segment_sum(
            jnp.where(stored, (flat - f_mean[ring_roi]) ** 2, 0.0), ring_roi, num_segments=R
        )
        f_std = jnp.sqrt(f_sq / jnp.maximum(n_r - 1.0, 1.0))
        mu = f_mean + 1.5 * f_std  # (`:980`)
        mu_p = mu[ring_roi]
        prob_flat = 1.0 / (1.0 + jnp.exp((flat - mu_p) / jnp.maximum(mu_p / 10.0, 1e-12)))
        # big flat patches always revert (`:983`)
        prob_flat = jnp.where(
            (cnt > 1500.0) & (flat < cfg.th_dist**2), 1.0, prob_flat
        )
        prob_line = jnp.where(line_var > cfg.line_variable_thresh, 0.0, 1.0)  # (`:986-990`)
        tgr_revert = candidate & (n_r[ring_roi] > 0) & (prob_line * prob_flat > 0.5)
        patch_is_ground = patch_is_ground | tgr_revert
    ground = ground & patch_is_ground[jnp.clip(pid, 0, P - 1)]

    # --- Go-RIO whole-ground covariance-weighted refinement ----------------
    cov_polar = polar_covariances(xyz)  # (N, 3, 3), same model as APDGICP
    wg = ground.astype(dtype)
    n_g = jnp.maximum(jnp.sum(wg), 1.0)
    gmean = jnp.sum(xyz * wg[:, None], axis=0) / n_g
    gc = (xyz - gmean) * wg[:, None]
    gcov = gc.T @ gc / n_g
    evals, evecs = jnp.linalg.eigh(gcov + 1e-12 * jnp.eye(3, dtype=dtype))
    nvec = evecs[:, 0]
    nvec = nvec * jnp.where(nvec[2] < 0, -1.0, 1.0)
    dref = -nvec @ gmean
    plane = jnp.concatenate([nvec, dref[None]])
    for _ in range(cfg.refine_iters):
        nv = plane[:3]
        sig2 = jnp.einsum("i,nij,j->n", nv, cov_polar, nv) + 1e-6
        wts = wg / sig2
        # linear LSQ on (n, d): minimize sum w (n.p + d)^2 s.t. scale fixed by
        # renormalizing after the solve (Gauss-Newton on the normalized cost)
        A = jnp.concatenate([xyz, jnp.ones((n, 1), dtype)], axis=1)
        H = A.T @ (A * wts[:, None])
        # smallest eigenvector of H = homogeneous LSQ solution
        ev, evec = jnp.linalg.eigh(H + 1e-9 * jnp.eye(4, dtype=dtype))
        sol = evec[:, 0]
        nrm = jnp.linalg.norm(sol[:3])
        sol = sol / jnp.maximum(nrm, 1e-12)
        sol = sol * jnp.where(sol[2] < 0, -1.0, 1.0)
        plane = sol

    # --- under-ground multipath removal (`:867-879`) -----------------------
    signed = xyz @ plane[:3] + plane[3]
    removed = valid & (signed < cfg.underground_dist)
    ground_final = ground & ~removed
    nonground = valid & ~ground_final & ~removed

    return GroundSegResult(
        ground_mask=ground_final,
        nonground_mask=nonground,
        removed_mask=removed | (cloud.mask & ~valid),
        plane=plane,
        patch_normal=normal,
        patch_mean_z=mean[:, 2],
        patch_valid=patch_is_ground,
        patch_flatness=flat,
        patch_stored=stored,
    )


@partial(jax.jit, static_argnames=("cfg",))
def update_agle(
    state: AGLEState,
    result: GroundSegResult,
    cfg: GroundSegConfig = GroundSegConfig(),
    decay: float = 0.95,
) -> AGLEState:
    """Per-ring EMA counterpart of the reference's elevation/flatness storage
    (`update_elevation_thr`, `patchworkpp.hpp:894-922`: ring 0 thr = mean +
    3*std and sensor_height = -mean, rings 1+ thr = mean + 2*std;
    `update_flatness_thr`, `:925-950`: thr = mean + std). Rings with no
    stored patches this frame keep their previous state (the reference's
    `continue` on an empty buffer)."""
    R = cfg.num_rings_of_interest
    dtype = state.elev_mean.dtype
    ring_idx = jnp.asarray(ring_of_patch(cfg))
    ring_roi = jnp.clip(ring_idx, 0, R - 1)
    stored = result.patch_stored & (ring_idx < R)

    def ring_stats(vals):
        n_r = jax.ops.segment_sum(stored.astype(dtype), ring_roi, num_segments=R)
        s = jax.ops.segment_sum(jnp.where(stored, vals, 0.0).astype(dtype), ring_roi, num_segments=R)
        m = s / jnp.maximum(n_r, 1.0)
        sq = jax.ops.segment_sum(
            jnp.where(stored, (vals.astype(dtype) - m[ring_roi]) ** 2, 0.0), ring_roi, num_segments=R
        )
        v = sq / jnp.maximum(n_r, 1.0)
        return n_r, m, v

    n_r, em, ev = ring_stats(result.patch_mean_z)
    _, fm, fv = ring_stats(result.patch_flatness)

    has = n_r > 0
    warm = state.count > 0
    blend = jnp.where(warm, decay, 0.0)

    def ema(old, new):
        return jnp.where(has, blend * old + (1.0 - blend) * new, old)

    elev_mean = ema(state.elev_mean, em)
    elev_var = ema(state.elev_var, ev)
    flat_mean = ema(state.flat_mean, fm)
    flat_var = ema(state.flat_var, fv)
    count = state.count + has.astype(dtype)

    k_elev = jnp.where(jnp.arange(R) == 0, 3.0, 2.0).astype(dtype)
    elev_thr = jnp.where(
        count > 0, elev_mean + k_elev * jnp.sqrt(elev_var), state.elevation_thr
    )
    flat_thr = jnp.where(count > 0, flat_mean + jnp.sqrt(flat_var), state.flatness_thr)
    sensor_h = jnp.where(count[0] > 0, -elev_mean[0], state.sensor_height)
    return AGLEState(
        elevation_thr=elev_thr,
        flatness_thr=flat_thr,
        elev_mean=elev_mean,
        elev_var=elev_var,
        flat_mean=flat_mean,
        flat_var=flat_var,
        count=count,
        sensor_height=sensor_h,
    )
