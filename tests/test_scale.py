"""End-to-end backend scale: 1200 keyframes through the block-sparse solve.

The reference's g2o/CHOLMOD backend handles thousands of poses in
milliseconds (`graph_slam.cpp:353`); round 2's dense solver took 52 s at 297
keyframes. This drives the REAL `RadarGraphSLAM.optimize()` path (keyframe
ingestion, SC descriptor DB growth past its initial capacity, edge
information, pow2 pose padding, sparse CG routing) at 4x that scale.
"""

import time

import numpy as np
import jax.numpy as jnp
import pytest

from gorio_tpu.core.pointcloud import make_cloud
from gorio_tpu.pipeline.slam import RadarGraphSLAM, SLAMConfig


@pytest.mark.slow
def test_backend_scales_to_1200_keyframes():
    rng = np.random.default_rng(0)
    K = 1200
    cfg = SLAMConfig(
        enable_preintegration=False,
        enable_loop_closure=False,  # loop detection timing is covered elsewhere
        keyframe_delta_trans=0.0,
        keyframe_delta_angle=0.0,
    )
    slam = RadarGraphSLAM(cfg)
    base_cloud = make_cloud(
        jnp.asarray(rng.normal(scale=5.0, size=(128, 3))), capacity=128
    )
    T = np.eye(4)
    for k in range(K):
        step = np.eye(4)
        step[:3, 3] = [0.5, 0.02 * np.sin(k * 0.1), 0.0]
        c, s = np.cos(0.005), np.sin(0.005)
        step[:2, :2] = [[c, -s], [s, c]]
        T = T @ step
        kf_pose = T.copy()
        kf_pose[:3, 3] += rng.normal(scale=0.02, size=3)
        slam.add_frame(0.1 * k, base_cloud, kf_pose)
        # skip per-edge information registration cost: inject directly
        if slam.keyframes[-1].index > 0:
            slam.keyframes[-1].edge_info = np.eye(6) * 100.0
    assert len(slam.keyframes) == K

    t0 = time.perf_counter()
    opt = slam.optimize()
    dt_first = time.perf_counter() - t0  # includes the bucket's compile
    t0 = time.perf_counter()
    opt = slam.optimize()
    dt_warm = time.perf_counter() - t0
    assert opt is not None and np.all(np.isfinite(opt))
    # warm full-graph solve at 1200 keyframes must stay interactive on 2 CPU
    # cores; round-2's dense path was 52 s at 297
    assert dt_warm < 20.0, f"warm solve {dt_warm:.1f}s"
    # trajectory stays near the odometry (only a prior + between chain)
    stamps, poses = slam.trajectory()
    err = np.linalg.norm(poses[-1][:3, 3] - T[:3, 3])
    assert err < 1.0, err
