"""Scan-matching odometry front-end.

Counterpart of `ScanMatchingOdometryNodelet`
(`apps/scan_matching_odometry_nodelet.cpp`): per synced (ego-velocity, cloud)
pair, align the new scan to the current keyframe scan with the cumulative
ego-velocity transform as the initial guess (`guess = prev_trans * egovel_cum`,
`:458-462`), sanity-threshold the result against the ego-velocity prediction
(`:497-570` fallback), and refresh the keyframe target on the delta gates
(`:578-600`). The registration itself is one jitted APDGICP/NDT program; the
thin sequential state machine lives on the host (the scan-to-scan recursion is
inherently serial — SURVEY.md §7 "hard parts").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.pointcloud import PointCloud
from ..estimators.egovel import EgoVelConfig, estimate_ego_velocity
from ..estimators.groundseg import GroundSegConfig, estimate_ground
from .preprocessing import PreprocessConfig, preprocess_frame
from ..registration.gicp import GICPConfig, gicp_align, prepare_gicp, make_gicp_callbacks
from ..registration.lsq import lm_optimize
from ..registration.ndt import NDTConfig, ndt_align


class OdometryConfig(NamedTuple):
    """Defaults mirror the nodelet params (`:116-127`)."""

    keyframe_delta_trans: float = 0.25
    keyframe_delta_angle: float = 0.15
    keyframe_delta_time: float = 1.0
    max_acceptable_trans: float = 1.0
    max_acceptable_angle: float = 1.0  # rad
    max_diff_trans: float = 1.0
    max_diff_angle: float = 1.0
    max_egovel_cum: float = 1.0
    # loose IMU roll/pitch fusion at keyframe acceptance (`:135-138`, `:580`)
    enable_imu_fusion: bool = False
    imu_fusion_ratio: float = 0.1
    # IMU-thresholding fallback (`:511-550`): a rejected transform is
    # replaced by [IMU delta roll/pitch + last radar-delta yaw] rotation and
    # the ego-velocity translation, instead of the rotation-stale prediction.
    # Takes effect automatically when IMU orientation samples were pushed.
    enable_imu_thresholding: bool = True
    # external fused-pose (MSF) hook in the motion guess (`:83-84`, `:450-462`:
    # guess = prev_trans_s2s * egovel_cum * msf_delta)
    enable_imu_frontend: bool = False
    # ScanMatchingStatus.inlier_fraction (`:677-689`): fraction of aligned
    # source points with a target NN closer than max_correspondence_dist
    compute_inlier_fraction: bool = True
    inlier_max_correspondence_dist: float = 0.5
    scan_period: float = 0.1
    registration: str = "apdgicp"  # "apdgicp" | "gicp" | "ndt"
    gicp: GICPConfig = GICPConfig()
    ndt: NDTConfig = NDTConfig()
    egovel: EgoVelConfig = EgoVelConfig()  # used by the fused frontend
    groundseg: GroundSegConfig = GroundSegConfig()  # fused ground/floor seg
    # scan-to-submap mode (`:602-618`): register against the merged last-N
    # keyframe clouds instead of the single last keyframe
    enable_scan_to_map: bool = False
    max_submap_frames: int = 5
    submap_resolution: float = 0.25
    submap_capacity: int = 8192


def _rot_angle(R) -> float:
    """Geodesic angle of a rotation matrix (host-side numpy: the per-frame
    gates must not dispatch to the device)."""
    return float(np.arccos(np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)))


def _r2ypr(R):
    """ZYX Euler (yaw, pitch, roll) of R; parity `ros_utils.hpp:29-42`."""
    y = np.arctan2(R[1, 0], R[0, 0])
    p = np.arctan2(-R[2, 0], R[0, 0] * np.cos(y) + R[1, 0] * np.sin(y))
    r = np.arctan2(
        R[0, 2] * np.sin(y) - R[1, 2] * np.cos(y),
        -R[0, 1] * np.sin(y) + R[1, 1] * np.cos(y),
    )
    return y, p, r


def _rpy_to_mat(roll, pitch, yaw):
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll) (tf createQuaternionFromRPY order)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    Ry = np.array([[cp, 0, sp], [0, 1.0, 0], [-sp, 0, cp]])
    Rx = np.array([[1.0, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


# ---------------------------------------------------------------------------
# Fused frontend: ego-velocity + motion guess + registration in ONE device
# program per frame. The unfused path (`ScanMatchingOdometry.step`) makes
# ~6-10 host<->device round trips per frame (cloud buffer uploads, the
# ego-velocity dispatch, scalar pulls). Here the host uploads
# ONE packed (capacity, 5) array + ONE small state vector, dispatches ONE
# program, and pulls T + a 9-float stats vector.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=())
def _inlier_fraction(src_xyz, src_mask, tgt_xyz, tgt_mask, T, max_dist):
    """`publish_scan_matching_status` inlier count (`:677-689`): aligned
    source points whose 1-NN in the target is within max_correspondence_dist."""
    from ..registration.knn import nn1

    moved = src_xyz @ T[:3, :3].T + T[:3, 3]
    _, d2 = nn1(moved, tgt_xyz, tgt_mask)
    inl = (d2 < max_dist * max_dist) & src_mask
    return jnp.sum(inl) / jnp.maximum(jnp.sum(src_mask), 1)


def _cloud_from_packed(packed, count):
    """Device-side PointCloud from a packed [x, y, z, intensity, doppler]
    array + valid count (single upload instead of 5 buffer transfers)."""
    cap = packed.shape[0]
    return PointCloud(
        xyz=packed[:, :3],
        intensity=packed[:, 3],
        doppler=packed[:, 4],
        cluster=jnp.zeros((cap,), jnp.int32),
        mask=jnp.arange(cap) < count,
    )


class FusedStepOut(NamedTuple):
    host: jax.Array  # (25,) [T.ravel() (16), converged, error, v(3),
    # sigma(3), zero_vel]; with ground seg fused in, (30,) with
    # [n_ground, plane(4)] appended — ONE device->host pull per frame
    cloud: PointCloud  # the built source cloud (device-resident, reusable
    # as the next keyframe target with no transfer)


def _fused_ingest_core(packed, host_state, egocfg, gscfg, ppcfg):
    """Shared cloud-build + per-scan estimation used by both fused programs.

    With `ppcfg` set, runs the FULL preprocessing chain of
    `PreprocessingNodelet::cloud_callback` (power/distance gates, outlier
    removal, ego-velocity, dynamic-object removal, deskew, ground seg +
    under-ground removal, DBSCAN cluster ids — `preprocess_frame`) inside the
    same device program; otherwise just the ego-velocity estimate (plus
    optional standalone ground seg via `gscfg`).

    Returns (cloud_for_registration, ego, ground_parts)."""
    count = host_state[16].astype(jnp.int32)
    seed = host_state[18].astype(jnp.uint32)
    idx = host_state[19].astype(jnp.uint32)
    cloud = _cloud_from_packed(packed, count)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), idx)
    dtype = packed.dtype
    if ppcfg is not None:
        pf, _ = preprocess_frame(cloud, host_state[20:23], ppcfg, key=key)
        parts = []
        if ppcfg.enable_ground_seg:
            parts = [
                jnp.sum(pf.ground_mask).astype(dtype)[None],
                pf.plane.astype(dtype),
            ]
        return pf.cloud, pf.ego, parts
    ego = estimate_ego_velocity(cloud, egocfg, key=key)
    parts = []
    if gscfg is not None:
        seg = estimate_ground(cloud, gscfg)
        parts = [jnp.sum(seg.ground_mask).astype(dtype)[None], seg.plane.astype(dtype)]
    return cloud, ego, parts


@partial(jax.jit, static_argnames=("cfg", "gscfg", "ppcfg"))
def fused_frontend_step(
    packed,
    host_state,
    kf_cloud: PointCloud,
    cfg: OdometryConfig,
    gscfg: Optional[GroundSegConfig] = None,
    ppcfg: Optional[PreprocessConfig] = None,
) -> FusedStepOut:
    """One jitted program: [full preprocessing ->] Doppler ego-velocity RANSAC
    -> cumulative motion guess (`guess = prev_trans * egovel_cum`, `:458-462`)
    -> scan-to-keyframe registration. `host_state` = [prev_trans.ravel() (16),
    count, dt, seed, frame_idx, omega (3)] (23,), optionally extended with the
    external MSF pose delta [23:39] (`guess = prev_trans * egovel_cum *
    msf_delta`, `:458-462`)."""
    dtype = packed.dtype
    prev_trans = host_state[:16].reshape(4, 4)
    dt = host_state[17]
    cloud, ego, ground_parts = _fused_ingest_core(
        packed, host_state, cfg.egovel, gscfg, ppcfg
    )
    step_T = jnp.eye(4, dtype=dtype).at[:3, 3].set(ego.v.astype(dtype) * dt)
    # guard (`:364`): runaway cumulative motion falls back to identity
    cum_ok = jnp.linalg.norm(step_T[:3, 3]) <= cfg.max_egovel_cum
    egovel_cum = jnp.where(cum_ok, step_T, jnp.eye(4, dtype=dtype))
    guess = prev_trans @ egovel_cum
    if host_state.shape[0] >= 39:
        guess = guess @ host_state[23:39].reshape(4, 4)

    if cfg.registration == "ndt":
        res = ndt_align(cloud, kf_cloud, init_T=guess, cfg=cfg.ndt)
    else:
        res = gicp_align(
            cloud, kf_cloud, init_T=guess, cfg=cfg.gicp._replace(mode=cfg.registration)
        )
    parts = [
        res.T.reshape(-1).astype(dtype),
        res.converged.astype(dtype)[None],
        res.error.astype(dtype)[None],
        ego.v.astype(dtype),
        ego.sigma.astype(dtype),
        ego.zero_velocity.astype(dtype)[None],
    ] + ground_parts
    if cfg.compute_inlier_fraction:
        frac = _inlier_fraction(
            cloud.xyz, cloud.mask, kf_cloud.xyz, kf_cloud.mask, res.T,
            jnp.asarray(cfg.inlier_max_correspondence_dist, dtype),
        )
        parts.append(frac.astype(dtype)[None])
    return FusedStepOut(host=jnp.concatenate(parts), cloud=cloud)


@partial(jax.jit, static_argnames=("egocfg", "gscfg", "ppcfg"))
def fused_ingest(
    packed,
    host_state,
    egocfg: EgoVelConfig,
    gscfg: Optional[GroundSegConfig] = None,
    ppcfg: Optional[PreprocessConfig] = None,
) -> FusedStepOut:
    """First-frame path: build (+preprocess) the cloud + ego-velocity only
    (no registration target yet)."""
    dtype = packed.dtype
    cloud, ego, ground_parts = _fused_ingest_core(packed, host_state, egocfg, gscfg, ppcfg)
    parts = [
        jnp.eye(4, dtype=dtype).reshape(-1),
        jnp.ones(1, dtype),
        jnp.zeros(1, dtype),
        ego.v.astype(dtype),
        ego.sigma.astype(dtype),
        ego.zero_velocity.astype(dtype)[None],
    ] + ground_parts
    return FusedStepOut(host=jnp.concatenate(parts), cloud=cloud)


class OdometryStatus(NamedTuple):
    """Parity: `ScanMatchingStatus.msg` (all fields; `msg/ScanMatchingStatus.msg`,
    filled at `scan_matching_odometry_nodelet.cpp:666-703`)."""

    converged: bool
    matching_error: float
    inlier_fraction: float  # NN-within-0.5m fraction (`:677-689`); NaN if off
    relative_pose: np.ndarray
    prediction_error: Optional[np.ndarray]
    used_prediction: bool
    prediction_label: str = ""  # "" | "imu" (msf) — `prediction_labels` (`:693-702`)


@dataclass
class ScanMatchingOdometry:
    cfg: OdometryConfig = OdometryConfig()
    # state (parity: member vars of the nodelet)
    odom: np.ndarray = field(default_factory=lambda: np.eye(4))
    keyframe_pose: np.ndarray = field(default_factory=lambda: np.eye(4))
    keyframe_cloud: Optional[PointCloud] = None
    keyframe_stamp: float = 0.0
    prev_trans_s2s: np.ndarray = field(default_factory=lambda: np.eye(4))
    egovel_cum: np.ndarray = field(default_factory=lambda: np.eye(4))
    last_stamp: Optional[float] = None
    statuses: list = field(default_factory=list)
    # scan-to-map state: (pose, cloud) of the last N keyframes
    _submap_frames: list = field(default_factory=list)
    # full preprocessing chain fused into the frontend program when set
    preprocess_cfg: Optional[PreprocessConfig] = None
    # IMU attitude queue [(t, roll, pitch)] + world->map rotation from the
    # first IMU sample (yaw zeroed), parity `:196-203`
    _imu_rp: list = field(default_factory=list)
    _global_orient: Optional[np.ndarray] = None
    # external MSF fused poses (stamp, T): `msf_pose_callback` (`:392-397`)
    _msf_pose: Optional[tuple] = None
    _msf_pose_after_update: Optional[tuple] = None

    def push_msf_pose(self, t: float, T: np.ndarray, after_update: bool = False) -> None:
        """Feed an externally fused pose (e.g. an MSF/EKF front-end); mirrors
        the `/msf_core/pose[_after_update]` subscriptions (`:83-84`). Used in
        the motion guess only when `cfg.enable_imu_frontend`."""
        if after_update:
            self._msf_pose_after_update = (float(t), np.asarray(T, np.float64))
        else:
            self._msf_pose = (float(t), np.asarray(T, np.float64))

    def _msf_delta(self) -> tuple:
        """delta = pose_after_update^-1 @ pose (the hdl_graph_slam rule the
        hook descends from), valid only when both stamps postdate the current
        keyframe; returns (4x4, label)."""
        if (
            not self.cfg.enable_imu_frontend
            or self._msf_pose is None
            or self._msf_pose_after_update is None
        ):
            return np.eye(4), ""
        t1, pose = self._msf_pose
        t0, pose0 = self._msf_pose_after_update
        if t1 <= self.keyframe_stamp or t0 <= self.keyframe_stamp:
            return np.eye(4), ""
        return np.linalg.inv(pose0) @ pose, "imu"

    def push_imu(self, t: float, quat_wxyz) -> None:
        """Feed an IMU orientation sample (world frame, [w,x,y,z]); mirrors
        `imu_callback` storing roll/pitch for `transformUpdate` (`:176-204`)."""
        w, x, y, z = (float(v) for v in quat_wxyz)
        R = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
        _, pitch, roll = _r2ypr(R)
        if self._global_orient is None:
            self._global_orient = _rpy_to_mat(roll, pitch, 0.0)
        self._imu_rp.append((t, roll, pitch, R))
        if len(self._imu_rp) > 200:  # imuQueLength
            del self._imu_rp[: len(self._imu_rp) - 200]

    def _transform_update(self, T: np.ndarray, stamp: float) -> np.ndarray:
        """Loose IMU roll/pitch fusion; parity `transformUpdate` (`:288-342`):
        interpolate IMU roll/pitch at stamp+scan_period, rotate into the map
        frame via the initial-orientation matrix, and blend with the odometry
        roll/pitch at `imu_fusion_ratio`, keeping the odometry yaw."""
        if not self._imu_rp or self._global_orient is None:
            return T
        t_q = stamp + self.cfg.scan_period
        ts = [s[0] for s in self._imu_rp]
        i = int(np.searchsorted(ts, t_q))
        if i >= len(ts):
            roll_i, pitch_i = self._imu_rp[-1][1], self._imu_rp[-1][2]
        elif i == 0:
            roll_i, pitch_i = self._imu_rp[0][1], self._imu_rp[0][2]
        else:
            t0, r0, p0 = self._imu_rp[i - 1][:3]
            t1, r1, p1 = self._imu_rp[i][:3]
            a = (t_q - t0) / max(t1 - t0, 1e-9)
            roll_i = (1 - a) * r0 + a * r1
            pitch_i = (1 - a) * p0 + a * p1
        yaw_o, pitch_o, roll_o = _r2ypr(T[:3, :3])
        imu_rot = _rpy_to_mat(roll_i, pitch_i, yaw_o)
        _, pitch_t, roll_t = _r2ypr(self._global_orient.T @ imu_rot)
        k = self.cfg.imu_fusion_ratio
        fused = _rpy_to_mat(
            (1 - k) * roll_o + k * roll_t, (1 - k) * pitch_o + k * pitch_t, yaw_o
        )
        out = T.copy()
        out[:3, :3] = fused
        return out

    def _imu_R_at(self, t: float):
        """Orientation sample nearest to stamp `t` from the pushed IMU queue
        (parity: `get_closest_imu`, `scan_matching_odometry_nodelet.cpp:254-286`)."""
        ts = [s[0] for s in self._imu_rp]
        i = int(np.searchsorted(ts, t))
        if i >= len(ts):
            i = len(ts) - 1
        elif i > 0 and abs(ts[i - 1] - t) < abs(ts[i] - t):
            i -= 1
        return self._imu_rp[i][3]

    def _imu_fallback_delta(self, stamp: float, egovel_trans: np.ndarray):
        """IMU-rotation + egovel-translation replacement for a rejected
        transform; parity `scan_matching_odometry_nodelet.cpp:511-550`:
        rotation = Rz(last radar-delta yaw) Ry(IMU delta pitch) Rx(IMU delta
        roll), translation = the cumulative ego-velocity step. Returns None
        when no IMU orientation stream was pushed (the caller then falls back
        to the rotation-stale motion prediction).

        The IMU delta spans exactly one frame: R at the previous frame's
        stamp vs R at this frame's stamp (the reference refreshes
        `last_frame_imu` every frame, `:531` — caching only at rejection time
        would make the first rejection after a long accepted stretch apply a
        multi-second accumulated roll/pitch as a single-frame delta)."""
        if not self.cfg.enable_imu_thresholding or len(self._imu_rp) < 2:
            return None
        prev_stamp = getattr(self, "_prev_frame_stamp", None)
        if prev_stamp is None:
            return None
        R_now = self._imu_R_at(stamp)
        R_prev = self._imu_R_at(prev_stamp)
        rot_imu = R_prev.T @ R_now
        # Eigen eulerAngles(0,1,2): R = Rx(a) Ry(b) Rz(c)
        roll_imu = np.arctan2(-rot_imu[1, 2], rot_imu[2, 2])
        pitch_imu = np.arcsin(np.clip(rot_imu[0, 2], -1.0, 1.0))
        rd = getattr(self, "_last_radar_delta", np.eye(4))
        yaw_rd = np.arctan2(-rd[0, 1], rd[0, 0])
        mat_est = np.eye(4)
        mat_est[:3, :3] = _rpy_to_mat(roll_imu, pitch_imu, yaw_rd)
        mat_est[:3, 3] = egovel_trans
        return mat_est

    def _rebuild_submap(self):
        """Merge the last-N keyframe clouds into the current keyframe frame
        (`:602-618`); fixed-capacity voxel downsample keeps shapes static."""
        from ..core.pointcloud import make_cloud, voxel_downsample
        import jax.numpy as jnp

        ref_pose_inv = np.linalg.inv(self.keyframe_pose)
        pts = []
        for pose, cloud in self._submap_frames[-self.cfg.max_submap_frames :]:
            T = ref_pose_inv @ pose
            xyz = np.asarray(cloud.xyz)
            m = np.asarray(cloud.mask)
            pts.append((xyz[m] @ T[:3, :3].T + T[:3, 3]).astype(xyz.dtype))
        allpts = np.concatenate(pts, axis=0)
        merged = make_cloud(jnp.asarray(allpts), capacity=max(len(allpts), 1))
        merged = voxel_downsample(merged, self.cfg.submap_resolution)
        # repack to the fixed submap capacity (valid points first)
        xyz = np.asarray(merged.xyz)[np.asarray(merged.mask)]
        self.keyframe_cloud = make_cloud(
            jnp.asarray(xyz[: self.cfg.submap_capacity]), capacity=self.cfg.submap_capacity
        )

    def _align(self, source: PointCloud, target: PointCloud, guess):
        if self.cfg.registration == "ndt":
            return ndt_align(source, target, init_T=jnp.asarray(guess), cfg=self.cfg.ndt)
        cfg = self.cfg.gicp._replace(mode=self.cfg.registration)
        return gicp_align(source, target, init_T=jnp.asarray(guess), cfg=cfg)

    def step_fused(
        self,
        stamp: float,
        packed: np.ndarray,
        count: int,
        seed: int = 0,
        ground: bool = False,
        omega=None,
    ):
        """Single-dispatch frontend step (see `fused_frontend_step`).

        `packed` is the (capacity, 5) [x, y, z, intensity, doppler] frame
        (padding rows arbitrary). Returns (pose (4,4), ego_v (3,)). The same
        sanity gates / keyframe refresh as `step` run host-side on the pulled
        T + stats; the keyframe target swap reuses the device-resident cloud
        returned by the program (no re-upload). `ground=True` also fuses
        Patchwork++ ground segmentation into the same program, exposing
        `last_ground_count` / `last_plane` for the floor constraint.
        Scan-to-submap mode is not fused — use `step` for that."""
        self._frame_idx = getattr(self, "_frame_idx", -1) + 1
        state = np.zeros(39, packed.dtype)
        state[:16] = self.prev_trans_s2s.ravel()
        state[16] = count
        state[17] = 0.0 if self.last_stamp is None else stamp - self.last_stamp
        state[18] = seed
        state[19] = self._frame_idx
        if omega is not None:
            state[20:23] = omega  # latest gyro sample for fused deskew
        msf_delta, msf_label = self._msf_delta()
        state[23:39] = msf_delta.ravel()
        packed_dev = jnp.asarray(packed)
        state_dev = jnp.asarray(state)

        ppcfg = self.preprocess_cfg
        gscfg = self.cfg.groundseg if (ground and ppcfg is None) else None
        has_ground = gscfg is not None or (ppcfg is not None and ppcfg.enable_ground_seg)
        if self.keyframe_cloud is None:
            out = fused_ingest(packed_dev, state_dev, self.cfg.egovel, gscfg, ppcfg)
            host = np.asarray(out.host)
            if has_ground:
                self.last_ground_count = int(host[25])
                self.last_plane = host[26:30].astype(np.float64)
            self.keyframe_cloud = out.cloud
            self.last_cloud = out.cloud
            self.keyframe_stamp = stamp
            self.last_stamp = stamp
            if self.cfg.enable_scan_to_map:
                self._submap_frames.append((self.keyframe_pose.copy(), out.cloud))
            return self.odom.copy(), host[18:21]

        self._prev_frame_stamp = self.last_stamp
        self.last_stamp = stamp
        out = fused_frontend_step(
            packed_dev, state_dev, self.keyframe_cloud, self.cfg, gscfg, ppcfg
        )
        self.last_cloud = out.cloud
        host = np.asarray(out.host)  # the single per-frame device->host pull
        if has_ground:
            self.last_ground_count = int(host[25])
            self.last_plane = host[26:30].astype(np.float64)
        T = host[:16].reshape(4, 4).astype(np.float64)
        converged = host[16] > 0.5
        v = host[18:21]
        if not np.isfinite(v).all():
            # degenerate scan (no gated Doppler returns): zero the velocity so
            # the motion prediction fallback stays finite (parity with the
            # reference's zero-velocity handling, `:427-430`)
            v = np.zeros(3, host.dtype)

        delta = np.linalg.inv(self.prev_trans_s2s) @ T
        dx = float(np.linalg.norm(delta[:3, 3]))
        da = _rot_angle(delta[:3, :3])
        dt = state[17]
        step_T = np.eye(4)
        step_T[:3, 3] = v * dt
        if np.linalg.norm(step_T[:3, 3]) > self.cfg.max_egovel_cum:
            step_T = np.eye(4)
        pred = self.prev_trans_s2s @ step_T
        diff = np.linalg.inv(pred) @ T
        ddx = float(np.linalg.norm(diff[:3, 3]))
        dda = _rot_angle(diff[:3, :3])
        used_prediction = False
        # NaN-safe gating: `nan > thresh` is False, so a diverged (non-finite)
        # registration would slip through the threshold checks and poison the
        # whole trajectory downstream — check finiteness explicitly
        if (
            not converged
            or not np.isfinite(T).all()
            or dx > self.cfg.max_acceptable_trans
            or da > self.cfg.max_acceptable_angle
            or ddx > self.cfg.max_diff_trans
            or dda > self.cfg.max_diff_angle
        ):
            # IMU-rotation + egovel-translation replacement (`:535-550`);
            # falls back to the rotation-stale prediction without IMU
            fb = self._imu_fallback_delta(stamp, step_T[:3, 3])
            T = self.prev_trans_s2s @ fb if fb is not None else pred
            used_prediction = True
        self._last_radar_delta = delta

        self.statuses.append(
            OdometryStatus(
                converged=bool(converged),
                matching_error=float(host[17]),
                inlier_fraction=float(host[-1]) if self.cfg.compute_inlier_fraction else float("nan"),
                relative_pose=delta,
                prediction_error=diff,
                used_prediction=used_prediction,
                prediction_label=msf_label,
            )
        )
        self.prev_trans_s2s = T
        self.odom = self.keyframe_pose @ T

        ddx_kf = float(np.linalg.norm(T[:3, 3]))
        dda_kf = _rot_angle(T[:3, :3])
        ddt_kf = stamp - self.keyframe_stamp
        if (
            ddx_kf > self.cfg.keyframe_delta_trans
            or dda_kf > self.cfg.keyframe_delta_angle
            or ddt_kf > self.cfg.keyframe_delta_time
        ):
            if self.cfg.enable_imu_fusion:
                self.odom = self._transform_update(self.odom, stamp)
            self.keyframe_pose = self.odom.copy()
            self.keyframe_stamp = stamp
            self.prev_trans_s2s = np.eye(4)
            if self.cfg.enable_scan_to_map:
                # submap rebuild is a keyframe-switch-only host path (a few
                # transfers per switch, not per frame)
                self._submap_frames.append((self.keyframe_pose.copy(), out.cloud))
                self._rebuild_submap()
            else:
                self.keyframe_cloud = out.cloud  # device-resident, no transfer
        return self.odom.copy(), v

    def step(self, stamp: float, cloud: PointCloud, ego_vel: np.ndarray) -> np.ndarray:
        """Process one frame; returns the 4x4 odometry pose (map<-body)."""
        if self.keyframe_cloud is None:
            self.keyframe_cloud = cloud
            self.keyframe_stamp = stamp
            self.last_stamp = stamp
            if self.cfg.enable_scan_to_map:
                self._submap_frames.append((self.keyframe_pose.copy(), cloud))
            return self.odom.copy()

        # cumulative ego-velocity delta since the last frame (`:356-365`)
        dt = stamp - self.last_stamp
        self._prev_frame_stamp = self.last_stamp
        self.last_stamp = stamp
        step_T = np.eye(4)
        step_T[:3, 3] = np.asarray(ego_vel) * dt
        egovel_cum = self.egovel_cum @ step_T
        if np.linalg.norm(egovel_cum[:3, 3]) > self.cfg.max_egovel_cum:
            egovel_cum = self.egovel_cum  # guard (`:364`)
        self.egovel_cum = egovel_cum

        msf_delta, msf_label = self._msf_delta()
        guess = self.prev_trans_s2s @ self.egovel_cum @ msf_delta
        res = self._align(cloud, self.keyframe_cloud, guess)
        T = np.asarray(res.T)
        if self.cfg.compute_inlier_fraction:
            inlier_frac = float(
                _inlier_fraction(
                    cloud.xyz, cloud.mask, self.keyframe_cloud.xyz,
                    self.keyframe_cloud.mask, res.T,
                    jnp.asarray(self.cfg.inlier_max_correspondence_dist, cloud.xyz.dtype),
                )
            )
        else:
            inlier_frac = float("nan")

        # sanity thresholding vs the ego-velocity prediction (`:497-570`)
        delta = np.linalg.inv(self.prev_trans_s2s) @ T
        dx = float(np.linalg.norm(delta[:3, 3]))
        da = _rot_angle(delta[:3, :3])
        pred = self.prev_trans_s2s @ self.egovel_cum
        diff = np.linalg.inv(pred) @ T
        ddx = float(np.linalg.norm(diff[:3, 3]))
        dda = _rot_angle(diff[:3, :3])
        used_prediction = False
        # NaN-safe: see step_fused — non-finite T must not pass the gates
        if (
            not bool(res.converged)
            or not np.isfinite(T).all()
            or dx > self.cfg.max_acceptable_trans
            or da > self.cfg.max_acceptable_angle
            or ddx > self.cfg.max_diff_trans
            or dda > self.cfg.max_diff_angle
        ):
            # IMU-rotation + egovel-translation replacement (`:535-550`);
            # rotation-stale prediction without an IMU orientation stream
            fb = self._imu_fallback_delta(stamp, self.egovel_cum[:3, 3])
            T = self.prev_trans_s2s @ fb if fb is not None else pred
            used_prediction = True
        self._last_radar_delta = delta

        self.statuses.append(
            OdometryStatus(
                converged=bool(res.converged),
                matching_error=float(res.error),
                inlier_fraction=inlier_frac,
                relative_pose=delta,
                prediction_error=diff,
                used_prediction=used_prediction,
                prediction_label=msf_label,
            )
        )

        self.prev_trans_s2s = T
        self.egovel_cum = np.eye(4)
        self.odom = self.keyframe_pose @ T

        # keyframe refresh (`:578-600`)
        ddx_kf = float(np.linalg.norm(T[:3, 3]))
        dda_kf = _rot_angle(T[:3, :3])
        ddt_kf = stamp - self.keyframe_stamp
        if (
            ddx_kf > self.cfg.keyframe_delta_trans
            or dda_kf > self.cfg.keyframe_delta_angle
            or ddt_kf > self.cfg.keyframe_delta_time
        ):
            # loose IMU roll/pitch fusion on keyframe acceptance (`:580-584`)
            if self.cfg.enable_imu_fusion:
                self.odom = self._transform_update(self.odom, stamp)
            self.keyframe_pose = self.odom.copy()
            self.keyframe_stamp = stamp
            self.prev_trans_s2s = np.eye(4)
            if self.cfg.enable_scan_to_map:
                self._submap_frames.append((self.keyframe_pose.copy(), cloud))
                self._rebuild_submap()
            else:
                self.keyframe_cloud = cloud

        return self.odom.copy()
