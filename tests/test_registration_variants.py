"""VGICP, registration factory, chunked preintegration facade, submap
odometry, Pallas dispatch fallback."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gorio_tpu.core import lie
from gorio_tpu.io.synthetic import make_world, render_radar_scan, sample_imu, simulate_trajectory
from gorio_tpu.preintegration import preintegrate
from gorio_tpu.registration import select_registration
from gorio_tpu.registration.vgicp import VGICPConfig, vgicp_align

TRANS_TOL = 0.08
ROT_TOL = np.deg2rad(1.0)


@pytest.fixture(scope="module")
def scan_pair():
    from scipy.spatial.transform import Rotation

    world = make_world(seed=31, n_landmarks=6000)
    R1 = Rotation.from_euler("ZYX", [0.05, 0.0, 0.0]).as_matrix()
    p1 = np.array([0.4, 0.2, 0.0])
    target = render_radar_scan(world, np.eye(3), np.zeros(3), np.zeros(3), capacity=2048, seed=1)
    source = render_radar_scan(world, R1, p1, np.zeros(3), capacity=2048, seed=2)
    T_true = np.eye(4)
    T_true[:3, :3] = R1
    T_true[:3, 3] = p1
    return source, target, jnp.asarray(T_true)


def _errors(T_est, T_true):
    dT = np.asarray(lie.se3_inverse(T_est) @ T_true)
    return (
        np.linalg.norm(dT[:3, 3]),
        float(lie.rotation_geodesic_angle(jnp.asarray(dT[:3, :3]), jnp.eye(3))),
    )


def test_vgicp_align(scan_pair):
    source, target, T_true = scan_pair
    res = vgicp_align(source, target, cfg=VGICPConfig(resolution=1.0, neighborhood="direct7"))
    te, re_ = _errors(res.T, T_true)
    assert te < TRANS_TOL, te
    assert re_ < ROT_TOL, re_


@pytest.mark.parametrize(
    "method", ["FAST_APDGICP", "FAST_GICP", "FAST_VGICP", "FAST_VGICP_CUDA", "NDT_OMP"]
)
def test_factory_methods(scan_pair, method):
    source, target, T_true = scan_pair
    kwargs = {}
    if "VGICP" in method:
        kwargs = dict(resolution=1.0, neighborhood="direct7")
    if "NDT" in method:
        kwargs = dict(resolution=2.0, min_points_per_voxel=3)
    align = select_registration(method, **kwargs)
    # NDT gets a motion prior (pipeline usage); GICP-family runs cold
    init = jnp.asarray(np.asarray(T_true)) if "NDT" in method else None
    res = align(source, target, init_T=init)
    te, re_ = _errors(res.T, T_true)
    assert te < (0.15 if "NDT" in method else TRANS_TOL), (method, te)
    assert re_ < np.deg2rad(2.0), (method, re_)


@pytest.mark.slow
def test_chunked_preintegration_matches_single():
    traj = simulate_trajectory(seed=12, duration=4.0)
    imu = sample_imu(traj, gyr_rate=200.0, vel_rate=20.0, gyr_std=0.0, vel_std=0.0, seed=13)
    args = (
        jnp.asarray(imu.gyr_t), jnp.asarray(imu.gyr),
        jnp.asarray(imu.vel_t), jnp.asarray(imu.vel),
    )
    queries = jnp.asarray([1.1, 2.3, 3.4])
    single = preintegrate(*args, 0.5, queries, 1e-6, 1e-6, quantum=-1.0, grid_n=1024)
    chunked = preintegrate(*args, 0.5, queries, 1e-6, 1e-6, quantum=1.0, grid_n=1024)
    for i in range(3):
        ang = float(lie.rotation_geodesic_angle(single.delta_R[i], chunked.delta_R[i]))
        assert ang < 2e-3, (i, ang)
        np.testing.assert_allclose(
            np.asarray(chunked.delta_p[i]), np.asarray(single.delta_p[i]), atol=2e-2
        )
    np.testing.assert_allclose(np.asarray(chunked.dt), np.asarray(single.dt), atol=1e-9)


@pytest.mark.slow
def test_submap_odometry_runs():
    from gorio_tpu.pipeline.odometry import OdometryConfig, ScanMatchingOdometry

    world = make_world(seed=33, n_landmarks=6000)
    traj = simulate_trajectory(seed=34, duration=3.0, forward_speed=2.0)
    odo = ScanMatchingOdometry(
        OdometryConfig(enable_scan_to_map=True, max_submap_frames=3, submap_capacity=4096)
    )
    stamps = np.arange(0.2, 2.8, 0.25)
    T0 = None
    errs = []
    for i, t in enumerate(stamps):
        R, p = traj.interp_pose(np.array([t]))
        gt = np.eye(4)
        gt[:3, :3] = R[0]
        gt[:3, 3] = p[0]
        if T0 is None:
            T0 = gt
        v = np.stack([np.interp(t, traj.t, traj.v_body[:, k]) for k in range(3)])
        cloud = render_radar_scan(world, R[0], p[0], v, capacity=1536, seed=300 + i)
        pose = odo.step(float(t), cloud, v)
        # odometry lives in the first-scan frame: compare against T0^-1 gt
        rel_gt = np.linalg.inv(T0) @ gt
        errs.append(np.linalg.norm(pose[:3, 3] - rel_gt[:3, 3]))
    assert len(odo._submap_frames) >= 2
    assert errs[-1] < 0.3, errs[-1]


def test_rbf_covariances_match_bruteforce():
    from gorio_tpu.registration.knn import rbf_covariances

    rng = np.random.default_rng(7)
    n, n_valid = 96, 80
    xyz = rng.normal(scale=1.5, size=(n, 3))
    mask = np.arange(n) < n_valid
    kw, md = 0.25, 3.0
    mean, cov, sw = rbf_covariances(
        jnp.asarray(xyz), jnp.asarray(mask), kernel_width=kw, max_dist=md, block=32
    )
    # brute-force reference (covariance_estimation_rbf.cu semantics)
    d2 = ((xyz[:, None, :] - xyz[None, :, :]) ** 2).sum(-1)
    w = np.where((d2 <= md**2) & mask[None, :], np.exp(-kw * d2), 0.0)
    sw_np = w.sum(-1)
    mean_np = (w @ xyz) / sw_np[:, None]
    exx = np.einsum("qn,ni,nj->qij", w, xyz, xyz) / sw_np[:, None, None]
    cov_np = exx - np.einsum("qi,qj->qij", mean_np, mean_np)
    np.testing.assert_allclose(np.asarray(sw)[:n_valid], sw_np[:n_valid], rtol=1e-10)
    np.testing.assert_allclose(np.asarray(mean)[:n_valid], mean_np[:n_valid], atol=1e-10)
    np.testing.assert_allclose(np.asarray(cov)[:n_valid], cov_np[:n_valid], atol=1e-10)


@pytest.mark.parametrize("method,kwargs", [
    ("ICP", {}),
    ("FAST_GICP", dict(covariance_method="rbf")),
    ("FAST_VGICP_CUDA", dict(resolution=1.0, neighborhood="direct7", covariance_method="rbf")),
])
def test_factory_new_variants(scan_pair, method, kwargs):
    source, target, T_true = scan_pair
    align = select_registration(method, **kwargs)
    res = align(source, target)
    te, re_ = _errors(res.T, T_true)
    assert te < 0.15, (method, te)
    assert re_ < np.deg2rad(2.0), (method, re_)


def test_ndt_kdtree_neighborhood(scan_pair):
    source, target, T_true = scan_pair
    align = select_registration("NDT_OMP", resolution=2.0, min_points_per_voxel=3,
                                neighborhood="kdtree")
    res = align(source, target, init_T=T_true)
    te, re_ = _errors(res.T, T_true)
    assert te < 0.15, te
    assert re_ < np.deg2rad(2.0), re_
