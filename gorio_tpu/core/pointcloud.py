"""Fixed-shape point-cloud containers and batched geometry ops.

The reference pipes `pcl::PointCloud<PointXYZINormal>` with dynamic sizes
between stages, storing Doppler in `curvature` and the DBSCAN cluster rank in
`normal_x` (`preprocessing_nodelet_ntu.cpp:64,407,566`). XLA needs static
shapes, so the container is a pytree of padded arrays plus a
validity mask; every op is mask-aware.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class PointCloud(NamedTuple):
    """Padded radar point cloud.

    xyz:       (N, 3) float   positions (padding rows hold `pad_value`)
    intensity: (N,)   float   SNR / power (dB)
    doppler:   (N,)   float   radial Doppler velocity (reference: `curvature`)
    cluster:   (N,)   float   cluster rank id, -1 = none (reference: `normal_x`)
    mask:      (N,)   bool    True for real points
    """

    xyz: jax.Array
    intensity: jax.Array
    doppler: jax.Array
    cluster: jax.Array
    mask: jax.Array

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def count(self):
        return jnp.sum(self.mask.astype(jnp.int32))


# Padding rows are parked far away so masked brute-force NN never picks them.
PAD_COORD = 1.0e6


def make_cloud(xyz, intensity=None, doppler=None, cluster=None, mask=None, capacity=None):
    """Build a PointCloud, padding/truncating to `capacity` (default: len(xyz)).

    Host (numpy) input is padded on the host and uploaded once: padding it
    with eager device ops would compile a program for every point count."""
    xp = jnp if isinstance(xyz, jax.Array) else np
    xyz = xp.asarray(xyz)
    n = xyz.shape[0]
    if capacity is None:
        capacity = n
    dtype = xyz.dtype

    def _pad1(x, fill):
        x = xp.asarray(x, dtype=dtype) if x is not None else xp.full((n,), fill, dtype)
        if x.shape[0] >= capacity:
            return x[:capacity]
        return xp.concatenate([x, xp.full((capacity - x.shape[0],), fill, dtype)])

    if n >= capacity:
        xyz_p = xyz[:capacity]
    else:
        xyz_p = xp.concatenate([xyz, xp.full((capacity - n, 3), PAD_COORD, dtype)], axis=0)
    if mask is None:
        mask_p = xp.arange(capacity) < n
    else:
        mask = xp.asarray(mask, dtype=bool)
        mask_p = _pad1(mask.astype(dtype), 0.0) > 0.5
    return PointCloud(
        xyz=jnp.asarray(xp.where(mask_p[:, None], xyz_p, PAD_COORD)),
        intensity=jnp.asarray(_pad1(intensity, 0.0)),
        doppler=jnp.asarray(_pad1(doppler, 0.0)),
        cluster=jnp.asarray(_pad1(cluster, -1.0)),
        mask=jnp.asarray(mask_p),
    )


def filter_cloud(cloud: PointCloud, keep) -> PointCloud:
    """Mask out points (no re-packing; shapes stay static)."""
    new_mask = cloud.mask & keep
    return cloud._replace(
        mask=new_mask,
        xyz=jnp.where(new_mask[:, None], cloud.xyz, PAD_COORD),
    )


def compact_cloud(cloud: PointCloud) -> PointCloud:
    """Move valid points to the front (stable), padding at the back.

    Useful before ops whose cost depends on a prefix length."""
    order = jnp.argsort(~cloud.mask, stable=True)
    return PointCloud(
        xyz=cloud.xyz[order],
        intensity=cloud.intensity[order],
        doppler=cloud.doppler[order],
        cluster=cloud.cluster[order],
        mask=cloud.mask[order],
    )


def distance_filter(cloud: PointCloud, min_dist, max_dist, min_z=-1e30, max_z=1e30):
    """Range/z gating; parity with `preprocessing_nodelet_ntu.cpp:639`."""
    d = jnp.linalg.norm(cloud.xyz, axis=-1)
    keep = (d > min_dist) & (d < max_dist) & (cloud.xyz[:, 2] > min_z) & (cloud.xyz[:, 2] < max_z)
    return filter_cloud(cloud, keep)


VOXEL_BITS = 10  # 1024 cells per axis; int32-safe with or without jax x64
VOXEL_SENTINEL = np.int32(2**30)


def voxel_key(xyz, resolution, origin):
    """int32 voxel key per point: 10 bits per axis relative to `origin`
    ((3,) array, usually the masked min corner). Out-of-range cells clamp to
    the boundary voxel. int32 keeps the op correct without x64."""
    ijk = jnp.floor((xyz - origin) / resolution).astype(jnp.int32)
    ijk = jnp.clip(ijk, 0, (1 << VOXEL_BITS) - 1)
    return (
        (ijk[..., 0] << (2 * VOXEL_BITS)) | (ijk[..., 1] << VOXEL_BITS) | ijk[..., 2]
    )


def masked_min_corner(xyz, mask, pad=1.0):
    """Min corner of the valid points (static-shape reduction)."""
    big = jnp.full((3,), 1e9, xyz.dtype)
    mn = jnp.min(jnp.where(mask[:, None], xyz, big), axis=0)
    return mn - pad


def voxel_downsample(cloud: PointCloud, resolution, capacity=None):
    """Voxel-grid centroid downsampling with static output shape.

    Replacement for `pcl::VoxelGrid` / octree downsampling
    (`map_cloud_generator.cpp:41-49`): sort by voxel key, segment-mean per
    run of equal keys, keep first-in-voxel representatives.
    """
    if capacity is None:
        capacity = cloud.capacity
    origin = masked_min_corner(cloud.xyz, cloud.mask)
    key = jnp.where(cloud.mask, voxel_key(cloud.xyz, resolution, origin), VOXEL_SENTINEL)
    order = jnp.argsort(key)
    key_s = key[order]
    xyz_s = cloud.xyz[order]
    inten_s = cloud.intensity[order]
    dop_s = cloud.doppler[order]
    clus_s = cloud.cluster[order]
    mask_s = cloud.mask[order]

    is_head = jnp.concatenate([jnp.array([True]), key_s[1:] != key_s[:-1]])
    seg_id = jnp.cumsum(is_head.astype(jnp.int32)) - 1
    num_seg = cloud.capacity  # upper bound
    w = mask_s.astype(xyz_s.dtype)
    sums = jax.ops.segment_sum(xyz_s * w[:, None], seg_id, num_segments=num_seg)
    cnts = jax.ops.segment_sum(w, seg_id, num_segments=num_seg)
    inten_m = jax.ops.segment_max(jnp.where(mask_s, inten_s, -jnp.inf), seg_id, num_segments=num_seg)
    dop_sum = jax.ops.segment_sum(dop_s * w, seg_id, num_segments=num_seg)
    clus_first = jax.ops.segment_max(jnp.where(mask_s, clus_s, -jnp.inf), seg_id, num_segments=num_seg)
    valid_seg = cnts > 0
    centroid = sums / jnp.maximum(cnts, 1.0)[:, None]

    out = PointCloud(
        xyz=jnp.where(valid_seg[:, None], centroid, PAD_COORD),
        intensity=jnp.where(valid_seg, inten_m, 0.0),
        doppler=dop_sum / jnp.maximum(cnts, 1.0),
        cluster=jnp.where(valid_seg, clus_first, -1.0),
        mask=valid_seg,
    )
    if capacity != num_seg:
        out = jax.tree.map(lambda x: x[:capacity], out)
    return out


def random_cloud(key, n, extent=30.0, structured=True, dtype=jnp.float32, capacity=None):
    """Synthetic radar-like scan: planar ground + a few wall/box clusters.

    Used by tests and the benchmark in place of the reference's bundled PCDs
    (`ndt_omp/data/*.pcd`)."""
    keys = jax.random.split(key, 6)
    n_ground = n // 3
    n_rest = n - n_ground
    gx = jax.random.uniform(keys[0], (n_ground, 2), minval=-extent, maxval=extent, dtype=dtype)
    gz = -1.8 + 0.03 * jax.random.normal(keys[1], (n_ground,), dtype=dtype)
    ground = jnp.concatenate([gx, gz[:, None]], axis=-1)
    if structured:
        # clusters of points on vertical planes (building walls, poles)
        n_clusters = 12
        centers = jax.random.uniform(keys[2], (n_clusters, 3), minval=-extent, maxval=extent, dtype=dtype)
        centers = centers.at[:, 2].set(jnp.abs(centers[:, 2]) * 0.15)
        assign = jax.random.randint(keys[3], (n_rest,), 0, n_clusters)
        local = jax.random.normal(keys[4], (n_rest, 3), dtype=dtype) * jnp.array([2.0, 0.12, 1.2], dtype)
        rest = centers[assign] + local
    else:
        rest = jax.random.uniform(keys[2], (n_rest, 3), minval=-extent, maxval=extent, dtype=dtype)
    xyz = jnp.concatenate([ground, rest], axis=0)
    inten = 10.0 + 20.0 * jax.random.uniform(keys[5], (n,), dtype=dtype)
    return make_cloud(xyz, intensity=inten, capacity=capacity)
