"""Preprocessing front-end: filters -> ego-velocity -> deskew -> ground seg ->
clustering, as one per-frame function.

Counterpart of `PreprocessingNodelet::cloud_callback`
(`apps/preprocessing_nodelet_ntu.cpp:370-579`, SURVEY.md §3.1): the stages are
composed masked array ops on the fixed-capacity cloud; the host threads the
A-GLE state between frames.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.pointcloud import PointCloud, distance_filter, filter_cloud
from ..estimators.clustering import DBSCANConfig, dbscan_cluster
from ..estimators.deskew import deskew
from ..estimators.egovel import EgoVelConfig, EgoVelResult, estimate_ego_velocity
from ..estimators.groundseg import AGLEState, GroundSegConfig, estimate_ground


class PreprocessConfig(NamedTuple):
    power_threshold: float = 0.0  # intensity gate (`:383`)
    min_distance: float = 0.5
    max_distance: float = 100.0
    min_z: float = -40.0
    max_z: float = 100.0
    # statistical/radius outlier removal (`:153-172`, applied `:626`)
    outlier_method: str = "none"  # "statistical" | "radius" | "none"
    statistical_mean_k: int = 20
    statistical_stddev: float = 1.0
    radius_radius: float = 2.0
    radius_min_neighbors: int = 2
    enable_dynamic_object_removal: bool = True  # keep ego-vel inliers (`:464-478`)
    enable_deskew: bool = True
    enable_ground_seg: bool = True
    enable_clustering: bool = True
    scan_period: float = 0.1
    egovel: EgoVelConfig = EgoVelConfig()
    groundseg: GroundSegConfig = GroundSegConfig()
    dbscan: DBSCANConfig = DBSCANConfig()


class ProcessedFrame(NamedTuple):
    cloud: PointCloud  # filtered cloud with cluster ids in `cluster`
    ego: EgoVelResult
    ground_mask: jax.Array
    plane: jax.Array


def preprocess_frame(
    cloud: PointCloud,
    omega,
    cfg: PreprocessConfig = PreprocessConfig(),
    agle: Optional[AGLEState] = None,
    key=None,
):
    """Returns (ProcessedFrame, new_agle). `omega` is the latest gyro sample
    (for deskew); `key` seeds the ego-velocity RANSAC."""
    from ..estimators.groundseg import update_agle

    # power + distance gates (`:381-412`, `:639`), then outlier removal (`:626`)
    cloud = filter_cloud(cloud, cloud.intensity > cfg.power_threshold)
    cloud = distance_filter(cloud, cfg.min_distance, cfg.max_distance, cfg.min_z, cfg.max_z)
    if cfg.outlier_method == "statistical":
        from ..estimators.outliers import statistical_outlier_removal

        cloud = statistical_outlier_removal(cloud, cfg.statistical_mean_k, cfg.statistical_stddev)
    elif cfg.outlier_method == "radius":
        from ..estimators.outliers import radius_outlier_removal

        cloud = radius_outlier_removal(cloud, cfg.radius_radius, cfg.radius_min_neighbors)

    ego = estimate_ego_velocity(cloud, cfg.egovel, key=key)
    if cfg.enable_dynamic_object_removal:
        # only trust the inlier classification when the estimate passed its
        # sigma gates: culling by a failed fit would throw away the static
        # scene and starve registration downstream
        cloud = filter_cloud(cloud, jnp.where(ego.ok, ego.inlier_mask, cloud.mask))

    if cfg.enable_deskew:
        cloud = deskew(cloud, omega, cfg.scan_period)

    if cfg.enable_ground_seg:
        seg = estimate_ground(cloud, cfg.groundseg, agle)
        cloud = filter_cloud(cloud, ~seg.removed_mask)
        ground_mask = seg.ground_mask
        plane = seg.plane
        new_agle = update_agle(agle, seg, cfg.groundseg) if agle is not None else None
    else:
        ground_mask = jnp.zeros(cloud.capacity, bool)
        plane = jnp.asarray([0.0, 0.0, 1.0, 0.0], cloud.xyz.dtype)
        new_agle = agle

    if cfg.enable_clustering:
        cloud = dbscan_cluster(cloud, cfg.dbscan)

    return ProcessedFrame(cloud=cloud, ego=ego, ground_mask=ground_mask, plane=plane), new_agle
