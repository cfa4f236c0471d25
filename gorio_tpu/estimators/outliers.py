"""Statistical / radius outlier removal, batched and masked.

Counterpart of the reference's `pcl::StatisticalOutlierRemoval` /
`pcl::RadiusOutlierRemoval` stage (`preprocessing_nodelet_ntu.cpp:153-172`
configuration, applied at `:626-636`): instead of per-point kd-tree queries,
the neighbor statistics come from the blocked brute-force distance kernel
(one matmul per block), exact and fully parallel over points.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.pointcloud import PointCloud, filter_cloud
from ..registration.knn import knn, radius_count


@partial(jax.jit, static_argnames=("mean_k",))
def statistical_outlier_mask(cloud: PointCloud, mean_k: int = 20, stddev_mul: float = 1.0):
    """Keep-mask of `pcl::StatisticalOutlierRemoval` semantics: a point stays
    if its mean distance to the `mean_k` nearest neighbors is within
    `global_mean + stddev_mul * global_std` over the cloud
    (`preprocessing_nodelet_ntu.cpp:154-162`, defaults mean_k=20, stddev=1.0).
    """
    dtype = cloud.xyz.dtype
    # k+1 because the query point is its own 0-distance neighbor
    _, d2 = knn(cloud.xyz, cloud.xyz, k=mean_k + 1, ref_mask=cloud.mask)
    mean_dist = jnp.mean(jnp.sqrt(jnp.maximum(d2[:, 1:], 0.0)), axis=-1)
    w = cloud.mask.astype(dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mu = jnp.sum(mean_dist * w) / n
    var = jnp.sum((mean_dist - mu) ** 2 * w) / jnp.maximum(n - 1.0, 1.0)
    thresh = mu + stddev_mul * jnp.sqrt(var)
    return cloud.mask & (mean_dist <= thresh)


def statistical_outlier_removal(cloud: PointCloud, mean_k: int = 20, stddev_mul: float = 1.0):
    return filter_cloud(cloud, statistical_outlier_mask(cloud, mean_k, stddev_mul))


@jax.jit
def radius_outlier_mask(cloud: PointCloud, radius: float = 2.0, min_neighbors: int = 2):
    """Keep-mask of `pcl::RadiusOutlierRemoval` semantics: a point stays if at
    least `min_neighbors` other valid points lie within `radius`
    (`preprocessing_nodelet_ntu.cpp:163-172`, defaults radius=2, min=2)."""
    cnt = radius_count(cloud.xyz, cloud.xyz, radius, ref_mask=cloud.mask)
    return cloud.mask & (cnt - 1 >= min_neighbors)  # -1: self


def radius_outlier_removal(cloud: PointCloud, radius: float = 2.0, min_neighbors: int = 2):
    return filter_cloud(cloud, radius_outlier_mask(cloud, radius, min_neighbors))


def remove_outliers(cloud: PointCloud, method: str = "statistical", **kw) -> PointCloud:
    """Factory mirroring the `outlier_removal_method` param
    (`preprocessing_nodelet_ntu.cpp:153`): STATISTICAL | RADIUS | NONE."""
    method = method.lower()
    if method == "statistical":
        return statistical_outlier_removal(cloud, **kw)
    if method == "radius":
        return radius_outlier_removal(cloud, **kw)
    if method in ("none", ""):
        return cloud
    raise ValueError(f"unknown outlier removal method: {method}")
