"""Radar graph-SLAM back-end driver.

Counterpart of `RadarGraphSlamNodelet`
(`apps/radar_graph_slam_nodelet.cpp`, SURVEY.md §3.3-3.4): keyframe selection,
GP velocity preintegration between keyframes (`preIntegrationTransform`,
`:363-520`), pose-graph construction (odometry between-factors with
fitness-based information, preintegration between-factors, GPS priors, loop
factors with Huber), periodic optimization, and trajectory/map export.

The host object replaces the nodelet's timer threads + mutex-guarded deques:
`add_frame` is the 10 Hz keyframe path, `optimize` is the 2-3 s timer body.
All numerics (preintegration, registration, graph solve) run as jitted
fixed-shape programs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import lie
from ..core.pointcloud import PointCloud
from ..graph.graph import PoseGraph
from ..graph.solver import SolveConfig, optimize_graph
from ..loopclosure.information import InformationConfig, calc_information_matrix
from ..loopclosure.loop_detector import LoopConfig, LoopDetector
from ..preintegration.lpm import lpm_preintegrate
from ..preintegration.ugpm import UGPMConfig, ugpm_preintegrate
from .keyframes import KeyFrame, KeyframeUpdater


@partial(jax.jit, static_argnames=("mode", "grid_n", "ugpm_cfg"))
def _preint_packed(gyr_pack, vel_pack, meta, mode: str, grid_n: int, ugpm_cfg):
    """Transfer-minimal preintegration dispatch: 3 uploads (packed gyro,
    packed vel, meta [t0, t1, gyr_var, vel_var]) and ONE 48-float pull
    [dR.ravel(9), dp(3), cov.ravel(36)] instead of ~8 round trips."""
    if mode == "ugpm":
        meas = ugpm_preintegrate(
            gyr_pack[:, 0], gyr_pack[:, 1:], vel_pack[:, 0], vel_pack[:, 1:],
            meta[0], meta[1:2], meta[2], meta[3], ugpm_cfg,
        )
    else:
        meas = lpm_preintegrate(
            gyr_pack[:, 0], gyr_pack[:, 1:], vel_pack[:, 0], vel_pack[:, 1:],
            meta[0], meta[1:2], meta[2], meta[3], grid_n=grid_n,
        )
    return jnp.concatenate(
        [meas.delta_R[0].reshape(-1), meas.delta_p[0], meas.cov[0].reshape(-1)]
    )


class SLAMConfig(NamedTuple):
    keyframe_delta_trans: float = 0.25
    keyframe_delta_angle: float = 0.15
    max_keyframes_per_update: int = 10
    enable_preintegration: bool = True
    preint_mode: str = "lpm"  # "lpm" | "ugpm"
    preint_grid_n: int = 256
    preint_window_samples: int = 256  # fixed gyro-sample count per window
    preint_vel_samples: int = 64
    ugpm: UGPMConfig = UGPMConfig()
    gyr_var: float = 1e-4
    vel_var: float = 1e-3
    enable_loop_closure: bool = True
    loop: LoopConfig = LoopConfig()
    info: InformationConfig = InformationConfig()
    loop_robust_delta: float = 1.0  # Huber on loop edges (`:836-852`)
    gps_xy_info: float = 25.0
    gps_z_info: float = 4.0
    # GPS edge gate chain (`flush_gps_queue`, `radar_graph_slam_nodelet.cpp:
    # 1248-1327`): minimum keyframe spacing between edges (`:1259`),
    # covariance gates (`:1293`; the reference compares the raw covariance
    # entries against the *stddev* params — replicated as-is), and the 5 m
    # drift gate (`:1303-1304`: an edge is only added once the estimate has
    # drifted >5 m from the fix)
    gps_edge_intervals: int = 10
    max_gps_edge_stddev_xy: float = 1.0
    max_gps_edge_stddev_z: float = 2.0
    gps_residual_skip_dist: float = 5.0
    gps_robust_delta: float = np.inf  # launch files use Huber 1.0 (`ntu_cp.launch:163`)
    anchor_info: float = 1e6
    solve: SolveConfig = SolveConfig(max_iterations=30)
    # floor constraint: keyframe ground-plane observations tied to one world
    # floor VertexPlane (EdgeSE3Plane; keyframe floor_coeffs, `keyframe.cpp:38`)
    enable_floor_constraint: bool = False
    floor_normal_info: float = 100.0
    floor_distance_info: float = 100.0
    floor_robust_delta: float = 1.0
    # acceptance gate for per-frame ground-plane fits feeding the constraint
    floor_min_ground_points: int = 30
    floor_max_tilt_nz: float = 0.8
    # pad the pose count to the next power of two with unit-prior dummy poses
    # so the jitted solver compiles once per BUCKET, not once per keyframe
    # count (the same bucketing discipline clouds and factor arrays follow)
    pad_poses_pow2: bool = True
    # dense Cholesky above this stacked dimension is slow to COMPILE (and
    # O(D^3) to run); larger solves switch to the block-sparse CG solver
    # with the block-tridiagonal chain preconditioner (graph/sparse.py)
    solve_dense_max_dim: int = 768


class GPSMeasurement(NamedTuple):
    stamp: float
    xyz: np.ndarray  # world/UTM-aligned position
    has_z: bool
    cov: Optional[np.ndarray] = None  # (3,) position covariance diagonal


@dataclass
class RadarGraphSLAM:
    cfg: SLAMConfig = SLAMConfig()
    keyframes: list = field(default_factory=list)
    updater: KeyframeUpdater = None
    loop_detector: LoopDetector = None
    # measurement buffers (parity: imu_queue / twist buffers)
    gyr_t: list = field(default_factory=list)
    gyr: list = field(default_factory=list)
    vel_t: list = field(default_factory=list)
    vel: list = field(default_factory=list)
    gps_queue: list = field(default_factory=list)
    loops: list = field(default_factory=list)
    _opt_poses: Optional[np.ndarray] = None
    trans_odom2map: np.ndarray = field(default_factory=lambda: np.eye(4))
    floor_plane: Optional[np.ndarray] = None  # optimized world floor [n, d]

    def __post_init__(self):
        if self.updater is None:
            self.updater = KeyframeUpdater(
                delta_trans=self.cfg.keyframe_delta_trans,
                delta_angle=self.cfg.keyframe_delta_angle,
                delta_time=np.inf,
            )
        if self.loop_detector is None:
            self.loop_detector = LoopDetector(cfg=self.cfg.loop, info_cfg=self.cfg.info)

    # ---- measurement ingestion ------------------------------------------
    def push_imu(self, t: float, gyro):
        self.gyr_t.append(float(t))
        self.gyr.append(np.asarray(gyro))

    def push_twist(self, t: float, vel):
        self.vel_t.append(float(t))
        self.vel.append(np.asarray(vel))

    def push_gps(self, t: float, xyz, has_z: bool = True, cov=None):
        self.gps_queue.append(
            GPSMeasurement(t, np.asarray(xyz), has_z, None if cov is None else np.asarray(cov))
        )

    def push_nmea(self, t: float, sentence: str, converter=None):
        """NMEA -> UTM -> world prior (parity: nmea_callback + flush_gps_queue)."""
        from ..io.gps import GPSConverter, parse_nmea

        if converter is None:
            if not hasattr(self, "_gps_converter"):
                self._gps_converter = GPSConverter()
            converter = self._gps_converter
        fix = parse_nmea(sentence)
        if fix is None:
            return False
        p = converter.convert(fix)
        if p is None:
            return False
        self.push_gps(t, p, has_z=fix.alt is not None)
        return True

    # ---- keyframe path (`cloud_handler_callback`, `:626-743`) ------------
    def add_frame(
        self,
        stamp: float,
        cloud: PointCloud,
        odom_pose: np.ndarray,
        floor_coeffs: Optional[np.ndarray] = None,
        altitude: Optional[float] = None,
    ) -> bool:
        if not self.updater.decide(odom_pose, stamp):
            return False
        kf = KeyFrame(
            index=len(self.keyframes),
            stamp=stamp,
            odom_scan2scan=np.asarray(odom_pose),
            accum_distance=self.updater.accum_distance,
            cloud=cloud,
            floor_coeffs=None if floor_coeffs is None else np.asarray(floor_coeffs),
            altitude=None if altitude is None else float(altitude),
        )
        if self.cfg.enable_preintegration and self.keyframes:
            prev = self.keyframes[-1]
            meas = self._preintegrate(prev.stamp, stamp)
            if meas is not None:
                kf.trans_integrated = meas[0]
                kf.preint_cov = meas[1]
        self.keyframes.append(kf)
        if self.cfg.enable_loop_closure:
            self.loop_detector.add_keyframe(cloud)
        return True

    def _preintegrate(self, t0: float, t1: float):
        """GP preintegration over [t0, t1] (`preIntegrationTransform`,
        `radar_graph_slam_nodelet.cpp:363-533`).

        Window semantics match the reference: the window start is clamped to
        at most 2 s before the end (`:424-426`). (The reference consumes
        measurement streams from 0.5 s before the window, `:469,484`; here
        the lead-in is 0.2 s — the fixed G/V sample budgets must spend their
        span covering [t0, t1], not history. Note the reference also slerps
        IMU orientation at both window ends (`:431-461`) but the resulting
        `q_imu_odom_increment` is DEAD CODE — the published transform uses
        the GP preintegration's delta_R exclusively (`:515-529`) — so no
        orientation slerp is replicated.)"""
        gyr_t = np.asarray(self.gyr_t)
        vel_t = np.asarray(self.vel_t)
        if gyr_t.size < 4 or vel_t.size < 4:
            return None
        if t1 - t0 > 2.0:
            t0 = t1 - 2.0  # `:424-426`
        pad = 0.2
        G = self.cfg.preint_window_samples
        V = self.cfg.preint_vel_samples
        i_g = int(np.searchsorted(gyr_t, t0 - pad))
        i_v = int(np.searchsorted(vel_t, t0 - pad))
        g_sl = slice(max(0, min(i_g, gyr_t.size - G)), None)
        v_sl = slice(max(0, min(i_v, vel_t.size - V)), None)
        gt = gyr_t[g_sl][:G]
        vt = vel_t[v_sl][:V]
        if gt.size < 4 or vt.size < 4 or gt[-1] < t1 or vt[-1] < t1:
            return None
        gd = np.stack(self.gyr)[g_sl][:G]
        vd = np.stack(self.vel)[v_sl][:V]
        # pad to fixed shapes by repeating the last sample (the integrator
        # interpolates; samples beyond the window are inert)
        if gt.size < G:
            rep = G - gt.size
            gt = np.concatenate([gt, gt[-1] + 1e-3 * (1 + np.arange(rep))])
            gd = np.concatenate([gd, np.repeat(gd[-1:], rep, axis=0)])
        if vt.size < V:
            rep = V - vt.size
            vt = np.concatenate([vt, vt[-1] + 1e-3 * (1 + np.arange(rep))])
            vd = np.concatenate([vd, np.repeat(vd[-1:], rep, axis=0)])

        gyr_pack = np.concatenate([gt[:, None], gd], axis=1)
        vel_pack = np.concatenate([vt[:, None], vd], axis=1)
        meta = np.asarray([t0, t1, self.cfg.gyr_var, self.cfg.vel_var])
        out = np.asarray(
            _preint_packed(
                jnp.asarray(gyr_pack), jnp.asarray(vel_pack), jnp.asarray(meta),
                self.cfg.preint_mode, self.cfg.preint_grid_n, self.cfg.ugpm,
            )
        )
        T = np.eye(4)
        T[:3, :3] = out[:9].reshape(3, 3)
        T[:3, 3] = out[9:12]
        return T, out[12:48].reshape(6, 6)

    def _flush_gps_queue(self, est, keyframes=None) -> None:
        """Associate queued GPS fixes to keyframes and apply the reference's
        gate chain (`flush_gps_queue`, `radar_graph_slam_nodelet.cpp:1248-1327`):

        * keyframe spacing: `index - last_gps_edge_index >= gps_edge_intervals`
        * closest-fix association within 0.2 s
        * covariance gate (raw covariance vs the `max_gps_edge_stddev_*`
          params — the reference's literal comparison)
        * `utm_coord` set once per keyframe (a gated keyframe is not retried)
        * 5 m drift gate: the edge only activates when the current estimate
          has drifted `gps_residual_skip_dist` from the fix

        Consumed fixes older than the newest keyframe are dropped (`:1322`).
        """
        if keyframes is None:
            keyframes = list(self.keyframes)
        if not self.gps_queue or not keyframes:
            return
        cfg = self.cfg
        q_stamps = np.asarray([g.stamp for g in self.gps_queue])
        last_idx = getattr(self, "_last_gps_edge_index", -(10**9))
        for kf in keyframes:
            if kf.index - last_idx < cfg.gps_edge_intervals:
                continue
            if kf.utm_coord is not None:
                continue
            j = int(np.argmin(np.abs(q_stamps - kf.stamp)))
            gps = self.gps_queue[j]
            if abs(gps.stamp - kf.stamp) > 0.2:
                continue
            if gps.cov is not None:
                cx, cy, cz = (float(v) for v in gps.cov)
                if (
                    cx > cfg.max_gps_edge_stddev_xy
                    or cy > cfg.max_gps_edge_stddev_xy
                    or cz > cfg.max_gps_edge_stddev_z
                ):
                    continue
            kf.utm_coord = np.asarray(gps.xyz)
            kf._gps_has_z = bool(gps.has_z) and np.isfinite(gps.xyz[2])
            resid = np.linalg.norm(est(kf)[:3, 3] - np.asarray(gps.xyz))
            if resid < cfg.gps_residual_skip_dist:
                kf._gps_edge = False
                continue
            if gps.cov is not None:
                info = 1.0 / np.maximum(np.asarray(gps.cov, float), 1e-12)
            else:
                info = np.asarray([cfg.gps_xy_info, cfg.gps_xy_info, cfg.gps_z_info])
            kf._gps_edge = True
            kf._gps_info = info
            last_idx = kf.index
        self._last_gps_edge_index = last_idx
        newest = keyframes[-1].stamp
        self.gps_queue = [g for g in self.gps_queue if g.stamp > newest]

    # ---- optimization cycle (`optimization_timer_callback`, `:750-834`) --
    def optimize(self, window: Optional[int] = None) -> Optional[np.ndarray]:
        """One graph-optimization cycle.

        `window=W` runs FIXED-LAG optimization: only the last W keyframes are
        variables; the window's first pose is anchored at its current
        (smoothed) estimate, and loop closures reaching older keyframes enter
        as priors through the frozen pose. Cost per cycle is O(W^3) regardless
        of trajectory length — the long-sequence mode the reference handles by
        queue batching (`max_keyframes_per_update`, `:552`).

        Thread-safety: the keyframe list is SNAPSHOT once up front, so this
        may run on a timer/background thread concurrent with `add_frame`
        (the reference's optimization-timer + mutexed keyframe queue,
        `radar_graph_slam_nodelet.cpp:750`; here the snapshot replaces the
        mutex — frames arriving mid-cycle are picked up next cycle)."""
        keyframes = list(self.keyframes)  # atomic snapshot under the GIL
        K = len(keyframes)
        if K < 2:
            return None
        base = 0 if (window is None or K <= window) else K - window
        kfs = keyframes[base:]

        def est(kf):
            return kf.optimized_pose if kf.optimized_pose is not None else kf.odom_scan2scan

        g = PoseGraph()
        for kf in kfs:
            g.add_pose(est(kf))
        # anchor: keyframe 0's odometry for the full graph; the window-edge
        # pose's current estimate in fixed-lag mode
        anchor = self.keyframes[0].odom_scan2scan if base == 0 else est(kfs[0])
        g.add_prior(0, anchor, info=np.eye(6) * self.cfg.anchor_info)

        for k in range(1, len(kfs)):
            prev, curr = kfs[k - 1], kfs[k]
            rel = np.linalg.inv(prev.odom_scan2scan) @ curr.odom_scan2scan
            if curr.edge_info is None:
                info, _ = calc_information_matrix(
                    curr.cloud, prev.cloud, jnp.asarray(rel), self.cfg.info
                )
                curr.edge_info = np.asarray(info)
            g.add_between(k - 1, k, rel, info=curr.edge_info)
            if curr.trans_integrated is not None:
                # stddev-diag information from the preint covariance (`:596-612`)
                var = np.clip(np.diag(curr.preint_cov), 1e-6, None)
                g.add_between(k - 1, k, curr.trans_integrated, info=np.diag(1.0 / var))

        # loop detection over every keyframe added since the last cycle,
        # flushed in chunks of max_keyframes_per_update (the reference's
        # keyframe-queue batching, `:552` — here it bounds the vmapped batch
        # shapes rather than deferring work)
        if self.cfg.enable_loop_closure and K > 3:
            poses_arr = np.stack([est(kf) for kf in keyframes])
            odom_arr = np.stack([kf.odom_scan2scan for kf in keyframes])
            accum_arr = np.asarray([kf.accum_distance for kf in keyframes])
            clouds = [kf.cloud for kf in keyframes]
            alts = [kf.altitude for kf in keyframes]
            start = getattr(self, "_loop_checked_upto", 0)
            new_idx = [kf.index for kf in keyframes[start:]]
            chunk = max(self.cfg.max_keyframes_per_update, 1)
            for c in range(0, len(new_idx), chunk):
                self.loops.extend(
                    self.loop_detector.detect_batch(
                        new_idx[c : c + chunk], clouds, poses_arr, odom_arr, accum_arr,
                        keyframe_altitudes=alts,
                    )
                )
            self._loop_checked_upto = K
        for loop in self.loops:
            # edge old->new measuring old_T_new = T_rel (`addLoopFactor`)
            i, j = loop.key_old - base, loop.key_new - base
            if j < 0:
                continue  # fully outside the window: already absorbed
            if i >= 0:
                g.add_between(
                    i, j, loop.T_rel,
                    info=loop.information, robust_delta=self.cfg.loop_robust_delta,
                )
            else:
                # old endpoint frozen: T_new ~ T_old_frozen @ T_rel as a prior
                T_prior = est(keyframes[loop.key_old]) @ loop.T_rel
                g.add_prior(
                    j, T_prior,
                    info=loop.information, robust_delta=self.cfg.loop_robust_delta,
                )

        # GPS priors (`flush_gps_queue`, `:1248-1327`): associate by stamp,
        # then run the reference's gate chain (edge spacing, covariance gate,
        # 5 m drift gate) — keyframes that pass carry a persistent utm_coord
        self._flush_gps_queue(est, keyframes)
        for k, kf in enumerate(kfs):
            if kf.utm_coord is None or not getattr(kf, "_gps_edge", False):
                continue
            axes = (1, 1, 1) if kf._gps_has_z else (1, 1, 0)
            g.add_point_prior(
                k, kf.utm_coord, info=np.diag(kf._gps_info), axes=axes,
                robust_delta=self.cfg.gps_robust_delta,
            )

        # floor constraint: tie keyframe ground-plane observations to one
        # world floor plane vertex (EdgeSE3Plane; hdl-heritage floor_coeffs)
        floored = (
            [kf for kf in kfs if kf.floor_coeffs is not None]
            if self.cfg.enable_floor_constraint
            else []
        )
        if floored:
            from ..graph.solver import optimize_graph_with_planes

            if self.floor_plane is not None:
                plane_w = self.floor_plane
            else:
                kf0 = floored[0]
                T0 = est(kf0)
                n_b, d_b = kf0.floor_coeffs[:3], kf0.floor_coeffs[3]
                n_w = T0[:3, :3] @ n_b
                plane_w = np.concatenate([n_w, [d_b - n_w @ T0[:3, 3]]])
            j = g.add_plane(plane_w)
            info3 = np.diag(
                [self.cfg.floor_normal_info, self.cfg.floor_normal_info,
                 self.cfg.floor_distance_info]
            )
            for kf in floored:
                g.add_se3_plane(
                    kf.index - base, j, kf.floor_coeffs, info3,
                    robust_delta=self.cfg.floor_robust_delta,
                )

        if self.cfg.pad_poses_pow2:
            K_real = len(g.poses)
            K_pad = max(4, 1 << (K_real - 1).bit_length())
            for _ in range(K_pad - K_real):
                d = g.add_pose(np.eye(4))
                g.add_prior(d, np.eye(4), info=1.0)

        poses0, graph = g.freeze()
        solve_cfg = self.cfg.solve
        # above the dense cutoff, switch to the block-sparse solver
        # (graph/sparse.py) — the structure-exploiting path g2o gets from
        # CHOLMOD (`graph_slam.cpp:353`). The linear solve is the EXACT
        # tridiag+Woodbury direct method (loop closures are the only
        # non-adjacent between edges, so the low-rank capacity is sized from
        # the live loop count, bucketed to limit recompiles).
        use_sparse = len(g.poses) * 6 > self.cfg.solve_dense_max_dim
        if use_sparse and solve_cfg.solver in ("dense", "direct"):
            n_loop = max(len(self.loops), 1)
            lcap = max(8, 1 << (n_loop - 1).bit_length())
            solve_cfg = solve_cfg._replace(solver="direct", loop_capacity=lcap)
        if floored:
            planes0, pg = g.freeze_planes()
            if use_sparse:
                from ..graph.sparse import optimize_graph_with_planes_sparse

                res = optimize_graph_with_planes_sparse(poses0, planes0, graph, pg, solve_cfg)
            else:
                res = optimize_graph_with_planes(poses0, planes0, graph, pg, solve_cfg)
            self.floor_plane = np.asarray(res.planes[0])
        else:
            if use_sparse:
                from ..graph.sparse import optimize_graph_sparse

                res = optimize_graph_sparse(poses0, graph, solve_cfg)
            else:
                res = optimize_graph(poses0, graph, solve_cfg)
        opt = np.asarray(res.poses)[: len(kfs)]  # drop pow2-padding dummies
        for k, kf in enumerate(kfs):
            kf.optimized_pose = opt[k]
        self._opt_poses = opt
        # map<-odom correction (`trans_odom2map`)
        last = keyframes[-1]
        self.trans_odom2map = last.optimized_pose @ np.linalg.inv(last.odom_scan2scan)
        return opt

    # ---- posterior inference (new capability; BASELINE configs 3-4) ------
    def sample_posterior(
        self,
        key,
        n_chains: int = 4,
        n_samples: int = 200,
        method: str = "hmc",
        window: Optional[int] = None,
    ):
        """Sample the trajectory posterior around the GN solution.

        Builds the frozen factor graph at the current keyframes, runs
        `n_chains` HMC chains (vmapped — shard the chain axis over a mesh for
        pod scale) preconditioned by the GN Hessian diagonal, and returns
        (samples (chains, n, 6K), accept_rates, rhat (6K,), laplace_cov).

        `window=w` samples the SLIDING-WINDOW posterior over the last `w`
        keyframes only: the window's first pose carries a tight anchor at its
        current (smoothed) estimate — the fixed-lag marginal used for online
        inference, where the dof count (6w) stays constant as the trajectory
        grows. Loops with both endpoints inside the window are kept.
        """
        import jax

        from ..inference.hmc import potential_scale_reduction, run_hmc
        from ..inference.laplace import graph_logprob
        from ..graph.solver import laplace_covariance

        kfs = self.keyframes if window is None else self.keyframes[-window:]
        base = self.keyframes[0].index if window is None else kfs[0].index

        g = PoseGraph()
        for kf in kfs:
            init = kf.optimized_pose if kf.optimized_pose is not None else kf.odom_scan2scan
            g.add_pose(init)
        anchor = (
            kfs[0].odom_scan2scan
            if kfs[0].optimized_pose is None
            else kfs[0].optimized_pose
        )
        g.add_prior(0, anchor, info=np.eye(6) * self.cfg.anchor_info)
        for k in range(1, len(kfs)):
            prev, curr = kfs[k - 1], kfs[k]
            rel = np.linalg.inv(prev.odom_scan2scan) @ curr.odom_scan2scan
            # the SAME fitness-based information the GN graph uses (`optimize`)
            # — the sampled posterior must be the posterior of that graph
            if curr.edge_info is None:
                info, _ = calc_information_matrix(
                    curr.cloud, prev.cloud, jnp.asarray(rel), self.cfg.info
                )
                curr.edge_info = np.asarray(info)
            g.add_between(k - 1, k, rel, info=curr.edge_info)
            if curr.trans_integrated is not None:
                var = np.clip(np.diag(curr.preint_cov), 1e-6, None)
                g.add_between(k - 1, k, curr.trans_integrated, info=np.diag(1.0 / var))
        for loop in self.loops:
            i, j = loop.key_old - base, loop.key_new - base
            if i < 0 or j < 0 or i >= len(kfs) or j >= len(kfs):
                continue
            g.add_between(
                i, j, loop.T_rel,
                info=loop.information, robust_delta=self.cfg.loop_robust_delta,
            )
        poses0, graph = g.freeze()
        res = optimize_graph(poses0, graph, self.cfg.solve)
        lp = graph_logprob(res.poses, graph)
        n = poses0.shape[0] * 6
        # Laplace-whitened kernel (r5): sample y = L^T x with L = chol(H) —
        # a diagonal inverse-mass cannot precondition the cross-pose
        # correlations of a chain graph (measured: R-hat ~6 vs ~1.3 whitened
        # on the bench posterior, see bench.py). Samples are mapped back to
        # local pose coordinates before returning.
        from ..inference.laplace import whitened_logprob

        lp_y, L_w = whitened_logprob(lp, res.H)
        keys = jax.random.split(key, n_chains)
        samples_y, accepts = jax.vmap(
            lambda k: run_hmc(
                k, lp_y, jnp.zeros(n, poses0.dtype), n_samples=n_samples,
                step_size=0.15, n_leapfrog=16,
            )
        )(keys)
        samples = jax.vmap(jax.vmap(
            lambda y: jax.scipy.linalg.solve_triangular(L_w, y, lower=True, trans=1)
        ))(samples_y)
        rhat = potential_scale_reduction(samples[:, n_samples // 4 :])
        cov = laplace_covariance(res)
        return samples, accepts, rhat, cov

    # ---- outputs ---------------------------------------------------------
    def trajectory(self):
        """(stamps, poses) using optimized poses where available."""
        stamps = np.asarray([kf.stamp for kf in self.keyframes])
        poses = np.stack(
            [
                kf.optimized_pose if kf.optimized_pose is not None else kf.odom_scan2scan
                for kf in self.keyframes
            ]
        )
        return stamps, poses

    def export_markers(self, path: str):
        """Nodes/edges/loops as JSON (counterpart of the rviz MarkerArray,
        `radar_graph_slam_nodelet.cpp:885-1121`) for external visualization."""
        import json

        stamps, poses = self.trajectory()
        data = {
            "nodes": [
                {"id": int(kf.index), "stamp": float(s), "position": p[:3, 3].tolist()}
                for kf, s, p in zip(self.keyframes, stamps, poses)
            ],
            "edges": [
                {"from": k - 1, "to": k, "type": "odometry"}
                for k in range(1, len(self.keyframes))
            ],
            "loops": [
                {"from": int(l.key_old), "to": int(l.key_new), "fitness": float(l.fitness)}
                for l in self.loops
            ],
            # candidate-search sphere radius (the reference's only live use of
            # distance_thresh, `radar_graph_slam_nodelet.cpp:1114`)
            "loop_search_radius": float(self.cfg.loop.distance_thresh) * 2.0,
        }
        with open(path, "w") as fh:
            json.dump(data, fh, indent=1)

    def save(self, directory: str):
        """Dump graph + keyframes (parity: `DumpGraph` service, `:1129-1208`)."""
        os.makedirs(directory, exist_ok=True)
        g = PoseGraph()
        for kf in self.keyframes:
            g.add_pose(kf.optimized_pose if kf.optimized_pose is not None else kf.odom_scan2scan)
        for k in range(1, len(self.keyframes)):
            prev, curr = self.keyframes[k - 1], self.keyframes[k]
            rel = np.linalg.inv(prev.odom_scan2scan) @ curr.odom_scan2scan
            g.add_between(k - 1, k, rel, info=np.eye(6))
        g.save(os.path.join(directory, "graph.g2o"))
        for kf in self.keyframes:
            kf.save(os.path.join(directory, f"{kf.index:06d}"))

    def generate_map(self, resolution: float = 0.1, max_range: float = 50.0):
        """Concatenate pose-transformed keyframe clouds + voxel downsample
        (parity: `MapCloudGenerator::generate`)."""
        from ..core.pointcloud import make_cloud, voxel_downsample

        pts = []
        for kf in self.keyframes:
            T = kf.optimized_pose if kf.optimized_pose is not None else kf.odom_scan2scan
            xyz = np.asarray(kf.cloud.xyz)
            m = np.asarray(kf.cloud.mask)
            r = np.linalg.norm(xyz, axis=-1)
            keep = m & (r < max_range)
            pts.append(xyz[keep] @ T[:3, :3].T + T[:3, 3])
        allpts = np.concatenate(pts, axis=0)
        cloud = make_cloud(allpts)
        return voxel_downsample(cloud, resolution, capacity=allpts.shape[0])
