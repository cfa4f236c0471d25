"""Intensity Scan Context as pure array ops.

Counterpart of `SCManager`
(`4DRadarSLAM/src/radar_graph_slam/Scancontext.cpp`,
`include/scan_context/Scancontext.h:108-130`): the 40-ring x 20-sector
max-intensity polar descriptor becomes a `segment_max` scatter, the ring-key
kd-tree (nanoflann, rebuilt every 10 frames) becomes a batched L2 `top_k`
against the whole database, and the shifted cosine distance evaluates ALL
sector shifts as one gather + einsum (20 shifts cost next to nothing, so the
reference's fast-align/10%-search-ratio heuristics are unnecessary).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.pointcloud import PointCloud


class ScanContextConfig(NamedTuple):
    """Defaults mirror `Scancontext.h:108-130`."""

    num_ring: int = 40
    num_sector: int = 20
    max_radius: float = 80.0
    azimuth_max_deg: float = 56.5  # radar FOV
    lidar_height: float = 1.2
    num_exclude_recent: int = 10
    num_candidates: int = 3
    dist_threshold: float = 0.5


@partial(jax.jit, static_argnames=("cfg",))
def make_scancontext(cloud: PointCloud, cfg: ScanContextConfig = ScanContextConfig()):
    """Descriptor (num_ring, num_sector): max intensity per polar bin.

    Parity: `makeScancontext` (`Scancontext.cpp:160-215`), including the
    atan2(x, y) - pi/2 azimuth convention and ceil-based 1-indexed binning."""
    R, S = cfg.num_ring, cfg.num_sector
    x, y = cloud.xyz[:, 0], cloud.xyz[:, 1]
    rng = jnp.sqrt(x * x + y * y)
    azim_deg = jnp.rad2deg(jnp.arctan2(x, y) - jnp.pi / 2)
    ok = (
        cloud.mask
        & (jnp.abs(azim_deg) <= cfg.azimuth_max_deg)
        & (rng <= cfg.max_radius)
    )
    ring = jnp.clip(jnp.ceil(rng / cfg.max_radius * R).astype(jnp.int32), 1, R) - 1
    sector = (
        jnp.clip(
            jnp.ceil(
                (azim_deg + cfg.azimuth_max_deg) / (2 * cfg.azimuth_max_deg) * S
            ).astype(jnp.int32),
            1,
            S,
        )
        - 1
    )
    flat = jnp.where(ok, ring * S + sector, R * S)
    inten = jnp.where(ok, cloud.intensity, -jnp.inf)
    desc = jax.ops.segment_max(inten, flat, num_segments=R * S + 1)[: R * S]
    desc = jnp.where(jnp.isfinite(desc), desc, 0.0)
    return desc.reshape(R, S)


def ring_key(desc):
    """Row-wise mean (`makeRingkeyFromScancontext`)."""
    return jnp.mean(desc, axis=-1)


def sector_key(desc):
    """Column-wise mean (`makeSectorkeyFromScancontext`)."""
    return jnp.mean(desc, axis=-2)


@jax.jit
def sc_distance(desc1, desc2):
    """Min over all sector shifts of the column-wise cosine distance.

    Parity: `distanceBtnScanContext` + `distDirectSC`
    (`Scancontext.cpp:104-159`) but brute-force over every shift (exact,
    superset of the reference's restricted search). Returns (dist, shift)."""
    S = desc1.shape[-1]
    shifts = jnp.arange(S)
    # desc2 shifted by s: column j of shifted = column (j - s) mod S
    cols = (shifts[:, None] * 0 + jnp.arange(S)[None, :] - shifts[:, None]) % S
    d2s = desc2[:, cols]  # (R, S_shift, S) -> transpose to (S_shift, R, S)
    d2s = jnp.transpose(d2s, (1, 0, 2))
    dots = jnp.einsum("rs,krs->ks", desc1, d2s)
    n1 = jnp.linalg.norm(desc1, axis=0)  # (S,)
    n2 = jnp.linalg.norm(d2s, axis=1)  # (K, S)
    eff = (n1[None, :] > 0) & (n2 > 0)
    sim = jnp.where(eff, dots / jnp.maximum(n1[None, :] * n2, 1e-12), 0.0)
    n_eff = jnp.maximum(jnp.sum(eff, axis=1), 1)
    dist = 1.0 - jnp.sum(sim, axis=1) / n_eff
    best = jnp.argmin(dist)
    return dist[best], best


class ScanContextDB(NamedTuple):
    """Fixed-capacity descriptor database (replaces the kd-tree + vectors)."""

    descs: jax.Array  # (C, R, S)
    ring_keys: jax.Array  # (C, R)
    count: jax.Array  # () int32

    @staticmethod
    def create(capacity: int, cfg: ScanContextConfig = ScanContextConfig(), dtype=jnp.float32):
        return ScanContextDB(
            descs=jnp.zeros((capacity, cfg.num_ring, cfg.num_sector), dtype),
            ring_keys=jnp.zeros((capacity, cfg.num_ring), dtype),
            count=jnp.zeros((), jnp.int32),
        )

    def add(self, desc):
        i = self.count
        return ScanContextDB(
            descs=self.descs.at[i].set(desc),
            ring_keys=self.ring_keys.at[i].set(ring_key(desc)),
            count=i + 1,
        )

    def grow(self, factor: int = 2):
        """Double the capacity (host-side; triggers one recompile per pow2
        bucket). Without this, `.at[i].set` past capacity silently DROPS the
        descriptor (XLA out-of-bounds scatter semantics) while `count` keeps
        growing — long trajectories would silently lose loop closure."""
        reps = factor - 1
        return ScanContextDB(
            descs=jnp.concatenate(
                [self.descs] + [jnp.zeros_like(self.descs)] * reps, axis=0
            ),
            ring_keys=jnp.concatenate(
                [self.ring_keys] + [jnp.zeros_like(self.ring_keys)] * reps, axis=0
            ),
            count=self.count,
        )


@partial(jax.jit, static_argnames=("cfg", "k"))
def detect_loop_topk(
    db: ScanContextDB, query_desc, cfg: ScanContextConfig = ScanContextConfig(),
    cand_mask=None, k: int = 2,
):
    """Top-`k` loop candidates by full shifted-cosine distance (same search
    as `detect_loop`; the reference keeps only the single best of its
    ring-key candidates, `Scancontext.cpp:352-360`). Verifying several
    candidates costs one WIDER registration batch — one dispatch —
    and recovers revisits whose descriptor-best match fails verification or
    an acceptance gate. Returns (matches (k,), yaws (k,), dists (k,)),
    ordered best-first; entries above the distance threshold are -1."""
    qk = ring_key(query_desc)
    n = db.ring_keys.shape[0]
    idxs = jnp.arange(n)
    eligible = idxs < jnp.maximum(db.count - cfg.num_exclude_recent, 0)
    if cand_mask is not None:
        eligible = eligible & cand_mask
    d2 = jnp.sum((db.ring_keys - qk[None, :]) ** 2, axis=-1)
    d2 = jnp.where(eligible, d2, jnp.inf)
    _, cand = jax.lax.top_k(-d2, cfg.num_candidates)
    dists, shifts = jax.vmap(lambda c: sc_distance(query_desc, db.descs[c]))(cand)
    dists = jnp.where(jnp.isinf(d2[cand]), jnp.inf, dists)
    order = jnp.argsort(dists)[: min(k, cfg.num_candidates)]
    top_d = dists[order]
    ok = top_d < cfg.dist_threshold
    matches = jnp.where(ok, cand[order], -1)
    sector_angle = 2 * cfg.azimuth_max_deg / cfg.num_sector
    half = cfg.num_sector // 2
    shift = shifts[order]
    signed_shift = jnp.where(shift > half, shift - cfg.num_sector, shift)
    yaws = jnp.deg2rad(signed_shift.astype(query_desc.dtype) * sector_angle)
    return matches, yaws, top_d


@partial(jax.jit, static_argnames=("cfg",))
def detect_loop(db: ScanContextDB, query_desc, cfg: ScanContextConfig = ScanContextConfig(),
                cand_mask=None):
    """Find the best loop candidate for `query_desc`.

    Parity: `detectLoopClosureID` (`Scancontext.cpp:272-374`): ring-key NN
    (batched L2 instead of kd-tree; always up to date, no 10-frame rebuild
    staleness), top `num_candidates`, shifted-cosine verification, threshold.
    Returns (match_index (-1 if none), yaw_diff_rad, distance).

    `cand_mask` (db capacity,) restricts the search to pre-gated candidates —
    a deliberate improvement over the reference, whose SC search runs over
    the whole history and then discards the single global match if it fails
    a `find_candidates` gate (`loop_detector.cpp:139-189` + `:192-244`): with
    the gates applied INSIDE the search, an ineligible global best no longer
    shadows an eligible true revisit (measured r4: ~60% of candidate
    rejections were exactly this shadowing)."""
    qk = ring_key(query_desc)
    n = db.ring_keys.shape[0]
    idxs = jnp.arange(n)
    eligible = idxs < jnp.maximum(db.count - cfg.num_exclude_recent, 0)
    if cand_mask is not None:
        eligible = eligible & cand_mask
    d2 = jnp.sum((db.ring_keys - qk[None, :]) ** 2, axis=-1)
    d2 = jnp.where(eligible, d2, jnp.inf)
    _, cand = jax.lax.top_k(-d2, cfg.num_candidates)
    dists, shifts = jax.vmap(lambda c: sc_distance(query_desc, db.descs[c]))(cand)
    dists = jnp.where(jnp.isinf(d2[cand]), jnp.inf, dists)
    best = jnp.argmin(dists)
    ok = dists[best] < cfg.dist_threshold
    match = jnp.where(ok, cand[best], -1)
    # yaw: shift s means desc2 rotated by s sectors over the (limited) FOV
    sector_angle = 2 * cfg.azimuth_max_deg / cfg.num_sector
    shift = shifts[best]
    half = cfg.num_sector // 2
    signed_shift = jnp.where(shift > half, shift - cfg.num_sector, shift)
    yaw = jnp.deg2rad(signed_shift.astype(query_desc.dtype) * sector_angle)
    return match, yaw, dists[best]


# ---- observability: descriptor images (parity: makeSCImage/getColorImage +
# ---- the pair publish in loop_detector.cpp:301-312) ------------------------


def sc_image(desc, upscale: int = 8) -> np.ndarray:
    """uint8 grayscale image of one descriptor (rings x sectors), intensity
    normalized to 0-255 and nearest-neighbor upscaled for visibility."""
    d = np.asarray(desc, dtype=np.float64)
    rng = d.max() - d.min()
    img = np.zeros_like(d) if rng <= 0 else (d - d.min()) / rng
    img = (img * 255.0).astype(np.uint8)
    return np.kron(img, np.ones((upscale, upscale), np.uint8))


def sc_pair_image(desc_cur, desc_prev, upscale: int = 8) -> np.ndarray:
    """The two matched descriptors stacked with a separator row — the
    framework's counterpart of the cur/prev Scan-Context images the reference
    publishes on a loop acceptance."""
    a = sc_image(desc_cur, upscale)
    b = sc_image(desc_prev, upscale)
    sep = np.full((2, a.shape[1]), 255, np.uint8)
    return np.concatenate([a, sep, b], axis=0)


def save_pgm(path, img: np.ndarray) -> None:
    """Dependency-free binary PGM writer for the images above."""
    img = np.asarray(img, np.uint8)
    with open(path, "wb") as fh:
        fh.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        fh.write(img.tobytes())
