"""Command-line tools.

Counterparts of the reference's CLI layer (SURVEY.md §2 Utility/CLI):
  slam        — run the full pipeline over a .grf/.npz sequence (replaces the
                launch-file + bag replay flow)
  simulate    — generate a synthetic sequence to .grf files
  evaluate    — ATE/RTE of a TUM trajectory vs ground truth
  align-traj  — estimate the rigid transform between two trajectories by
                timestamp association (Umeyama closed form)
  gt-adjust   — graph-based ground-truth trajectory adjustment: chain of
                Huber-robust between edges + user-specified loop-identity
                edges, LM solve (parity: `src/gt_adjust.cpp`)
  utm-align   — estimate the UTM->world transform as a single-SE3-vertex
                graph solve over timestamp-associated (trajectory, GPS)
                pairs with per-fix covariance (parity: `src/gps_traj_align.cpp`)
  convert     — raw CSV/NPZ logs -> .grf sequence (parity: `src/ford2bag.py`)
  dump-config — write the default typed config tree
  bench       — run the benchmark

Usage: python -m gorio_tpu.cli <command> [args]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def cmd_simulate(args):
    import jax.numpy as jnp

    from .io import native as gn
    from .io.synthetic import make_world, render_radar_scan, sample_imu, simulate_trajectory
    from .io.tum import save_tum

    from .io.synthetic import make_dynamic_objects, sample_gps

    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    traj = simulate_trajectory(
        seed=args.seed, duration=args.duration, circuit=args.circuit, stops=args.stops,
        laps=args.laps, figure8=args.figure8, elev_amp=args.elev_amp,
    )
    imu = sample_imu(traj, seed=args.seed + 1)
    # the landmark field must cover everywhere the trajectory can see: extent
    # = max planar excursion + sensor range (a 40 s straight run travels ~80 m
    # — past the old fixed ±60 m world, leaving all-empty scans at the tail)
    extent = float(np.abs(traj.p[:, :2]).max()) + 45.0
    # --landmarks is calibrated for the default ±60 m world; keep scene
    # DENSITY constant as the extent grows so scan point counts stay stable
    n_landmarks = int(args.landmarks * max(1.0, (extent / 60.0) ** 2))
    world = make_world(seed=args.seed + 2, n_landmarks=n_landmarks, extent=extent)
    dyn = make_dynamic_objects(seed=args.seed + 3, n_objects=args.dynamic) if args.dynamic else None
    stamps = np.arange(0.2, args.duration - 0.2, 1.0 / args.rate)
    for i, t in enumerate(stamps):
        R, p = traj.interp_pose(np.array([t]))
        v = np.stack([np.interp(t, traj.t, traj.v_body[:, k]) for k in range(3)])
        dpts, dvel = dyn.points_at(float(t)) if dyn is not None else (None, None)
        cloud = render_radar_scan(
            world, R[0], p[0], v, capacity=args.capacity, seed=1000 + i,
            dynamic_points=dpts, dynamic_vel=dvel,
            azimuth_fov_deg=None if args.omni else args.fov_azimuth,
            elevation_fov_deg=None if args.omni else args.fov_elevation,
        )
        m = np.asarray(cloud.mask)
        gn.write_frame(
            out / f"{i:06d}.grf",
            float(t),
            np.asarray(cloud.xyz)[m],
            np.asarray(cloud.intensity)[m],
            np.asarray(cloud.doppler)[m],
        )
    np.savez(
        out / "imu.npz", gyr_t=imu.gyr_t, gyr=imu.gyr, vel_t=imu.vel_t, vel=imu.vel,
        gyr_var=imu.gyr_var, vel_var=imu.vel_var,
    )
    if args.gps:
        g_t, g_xyz, g_cov = sample_gps(
            traj, rate=args.gps_rate, noise_xy=args.gps_noise_xy, seed=args.seed + 4
        )
        np.savez(out / "gps.npz", t=g_t, xyz=g_xyz, cov=g_cov)
    gt = np.zeros((traj.t.shape[0], 4, 4))
    gt[:, :3, :3] = traj.R
    gt[:, :3, 3] = traj.p
    gt[:, 3, 3] = 1.0
    save_tum(out / "groundtruth.tum", traj.t, gt)
    print(f"wrote {len(stamps)} frames to {out}")


def cmd_slam(args):
    import jax
    import jax.numpy as jnp

    from .core.pointcloud import make_cloud
    from .estimators.egovel import EgoVelConfig, estimate_ego_velocity
    from .io import native as gn
    from .io.tum import save_tum
    from .pipeline.odometry import OdometryConfig, ScanMatchingOdometry
    from .pipeline.slam import RadarGraphSLAM, SLAMConfig
    from .utils.profiling import StageTimer

    src = Path(args.dataset)
    frames = sorted(src.glob("*.grf"))
    if not frames:
        sys.exit(f"no .grf frames in {src}")
    imu = np.load(src / "imu.npz")

    # typed config tree (parity: the YAML/launch param tiers). CLI flags
    # override the loaded file's corresponding fields.
    if args.config:
        from .config import load_config

        tree = load_config(args.config)
        slam_cfg = tree.slam._replace(
            enable_loop_closure=not args.no_loops,
            preint_mode=args.preint,
            gyr_var=float(imu["gyr_var"]),
            vel_var=float(imu["vel_var"]),
            enable_floor_constraint=args.floor or tree.slam.enable_floor_constraint,
        )
        odo_cfg = tree.odometry._replace(registration=args.registration)
    else:
        slam_cfg = SLAMConfig(
            enable_loop_closure=not args.no_loops,
            preint_mode=args.preint,
            gyr_var=float(imu["gyr_var"]),
            vel_var=float(imu["vel_var"]),
            enable_floor_constraint=args.floor,
        )
        odo_cfg = OdometryConfig(registration=args.registration)

    slam = RadarGraphSLAM(slam_cfg)
    for t, g in zip(imu["gyr_t"], imu["gyr"]):
        slam.push_imu(t, g)
    # twist stream: precomputed samples when the dataset ships them, else the
    # per-scan ego-velocity estimates below feed the backend (parity: the
    # preprocessing nodelet publishing `/eagle_data/twist`)
    online_twists = imu["vel_t"].size == 0
    for t, v in zip(imu["vel_t"], imu["vel"]):
        slam.push_twist(t, v)
    # GPS fixes (parity: navsat ingestion + the flush_gps_queue gate chain);
    # the per-fix covariance feeds the covariance gates and edge information
    gps_path = src / "gps.npz"
    if gps_path.exists() and not args.no_gps:
        gps_npz = np.load(gps_path)
        for t, xyz, cov in zip(gps_npz["t"], gps_npz["xyz"], gps_npz["cov"]):
            slam.push_gps(float(t), xyz, cov=cov)
        print(f"pushed {len(gps_npz['t'])} GPS fixes")

    odo = ScanMatchingOdometry(odo_cfg)
    if args.preprocess:
        from .pipeline.preprocessing import PreprocessConfig

        odo.preprocess_cfg = (
            tree.preprocess if args.config else PreprocessConfig()
        )
    gyr_t_arr = np.asarray(imu["gyr_t"])
    gyr_arr = np.asarray(imu["gyr"])

    def omega_at(t):
        if gyr_t_arr.size == 0:
            return None
        i = np.clip(np.searchsorted(gyr_t_arr, t) - 1, 0, gyr_t_arr.size - 1)
        return gyr_arr[i]

    timer = StageTimer()
    key = jax.random.PRNGKey(0)
    # the ingest runs through the native 2-stage pipeline (decode thread ->
    # pack thread, native/src/pipeline.cc): frames arrive already zero-padded
    # to (capacity, 5), overlapping IO+pack with device compute
    ds = gn.NativePipelineDataset(frames, capacity=args.capacity)
    n = 0
    def accept_floor(n_ground, plane):
        """Confident, roughly-horizontal ground fits only."""
        return (
            slam.cfg.enable_floor_constraint
            and n_ground >= slam.cfg.floor_min_ground_points
            and abs(plane[2]) > slam.cfg.floor_max_tilt_nz
        )

    # `/command "point_distribution"` parity (`preprocessing_nodelet_ntu.cpp:
    # 775-787`): per-frame histogram of point counts in 1 m range bins,
    # averaged over frames; lands in --timing-out
    point_dist = np.zeros(100, np.int64)
    for stamp, n_pts, packed in ds:
        r = np.linalg.norm(packed[:n_pts, :3], axis=1)
        point_dist += np.bincount(
            np.clip(r.astype(np.int64), 0, 99), minlength=100
        )
        floor = None
        if args.fused:
            # single-dispatch frontend: the native pack stage already padded
            # the frame; one program, one pull
            with timer.stage("frontend_fused"):
                pose, v = odo.step_fused(
                    float(stamp), packed, n_pts, ground=args.floor,
                    omega=omega_at(float(stamp)) if args.preprocess else None,
                )
            if online_twists:
                slam.push_twist(float(stamp), v)
            cloud = odo.last_cloud  # device-resident, built inside the program
            has_ground = args.floor or (args.preprocess and odo.preprocess_cfg.enable_ground_seg)
            if has_ground and accept_floor(odo.last_ground_count, odo.last_plane):
                floor = odo.last_plane
        else:
            cloud = make_cloud(
                jnp.asarray(packed[:n_pts, :3]),
                intensity=jnp.asarray(packed[:n_pts, 3]),
                doppler=jnp.asarray(packed[:n_pts, 4]),
                capacity=args.capacity,
            )
            key, sub = jax.random.split(key)
            with timer.stage("ego_velocity"):
                ego = estimate_ego_velocity(cloud, EgoVelConfig(), key=sub)
                v = np.asarray(ego.v)
                if online_twists:
                    slam.push_twist(float(stamp), v)
            with timer.stage("scan_matching"):
                pose = odo.step(float(stamp), cloud, v)
            if args.floor:
                from .estimators.groundseg import GroundSegConfig, estimate_ground

                with timer.stage("ground_seg"):
                    seg = estimate_ground(cloud, GroundSegConfig())
                    n_ground = int(np.asarray(jnp.sum(seg.ground_mask)))
                    plane = np.asarray(seg.plane)
                    if accept_floor(n_ground, plane):
                        floor = plane
        with timer.stage("backend"):
            slam.add_frame(float(stamp), cloud, pose, floor_coeffs=floor)
            if args.optimize_every and len(slam.keyframes) % args.optimize_every == 0:
                slam.optimize(window=args.optimize_window or None)
        n += 1
    with timer.stage("final_optimize"):
        slam.optimize()
    stamps, poses = slam.trajectory()
    save_tum(args.output, stamps, poses)
    print(f"processed {n} frames -> {len(slam.keyframes)} keyframes, "
          f"{len(slam.loops)} loops; trajectory: {args.output}")
    print(timer.report())
    if args.timing_out:
        import statistics as _st

        with open(args.timing_out, "w") as fh:
            json.dump(
                {
                    "stage_median_ms": {
                        k: 1000 * _st.median(v) for k, v in timer.samples.items()
                    },
                    "n_frames": n,
                    "n_keyframes": len(slam.keyframes),
                    "n_loops": len(slam.loops),
                    # per-gate loop-closure rejection counts: which gate
                    # starves recall (diagnostic the reference lacks)
                    "loop_gate_counts": slam.loop_detector.gate_counts,
                    # accepted loops + keyframe stamps: enough to compute
                    # recall vs ground-truth revisit pairs offline
                    # (scripts/recall_benchmark.py -> RECALL.json)
                    "loops": [
                        [int(l.key_new), int(l.key_old), round(float(l.fitness), 4)]
                        for l in slam.loops
                    ],
                    "keyframe_stamps": [round(float(s), 6) for s in stamps],
                    "point_distribution": (point_dist / max(n, 1)).round(2).tolist(),
                },
                fh,
            )
    if args.status_out:
        # ScanMatchingStatus parity (`ScanMatchingStatus.msg` published per
        # frame by the odometry nodelet): convergence, matching error,
        # relative pose, prediction error, whether the fallback fired
        import json as _json

        with open(args.status_out, "w") as fh:
            _json.dump(
                [
                    {
                        "converged": st.converged,
                        "matching_error": st.matching_error,
                        "inlier_fraction": st.inlier_fraction,
                        "prediction_label": st.prediction_label,
                        "relative_pose": np.asarray(st.relative_pose).tolist(),
                        "prediction_error": (
                            None if st.prediction_error is None
                            else np.asarray(st.prediction_error).tolist()
                        ),
                        "used_prediction": st.used_prediction,
                    }
                    for st in odo.statuses
                ],
                fh,
            )
        print(f"statuses: {args.status_out} ({len(odo.statuses)} frames)")
    if args.dump:
        slam.save(args.dump)
    if args.map:
        m = slam.generate_map(resolution=args.map_resolution)
        mm = np.asarray(m.mask)
        np.savez(args.map, xyz=np.asarray(m.xyz)[mm])
        print(f"map: {args.map} ({int(mm.sum())} points)")


def cmd_evaluate(args):
    from .io.tum import ate_rmse, load_tum, rte

    es, ep = load_tum(args.estimate)
    gs, gp = load_tum(args.groundtruth)
    ate = ate_rmse(es, ep, gs, gp)
    r = rte(es, ep, gs, gp)
    print(json.dumps({"ate_rmse_m": ate, "rte_m": r, "n_poses": len(es)}))


def cmd_align_traj(args):
    from .io.tum import load_tum, save_tum, umeyama_alignment

    es, ep = load_tum(args.source)
    gs, gp = load_tum(args.target)
    idx = np.clip(np.searchsorted(gs, es), 0, len(gs) - 1)
    c, R, t = umeyama_alignment(ep[:, :3, 3], gp[idx][:, :3, 3], with_scale=args.scale)
    T = np.eye(4)
    T[:3, :3] = c * R
    T[:3, 3] = t
    print(json.dumps({"scale": c, "T": T.tolist()}))
    if args.output:
        out = ep.copy()
        out[:, :3, 3] = (c * (R @ ep[:, :3, 3].T)).T + t
        out[:, :3, :3] = np.einsum("ij,njk->nik", R, ep[:, :3, :3])
        save_tum(args.output, es, out)


def cmd_gt_adjust(args):
    """Graph-based GT trajectory adjustment (parity: `src/gt_adjust.cpp`):
    consecutive between edges (info I/odom_stddev, Huber) + identity loop
    edges at the user-given index pairs (translation info 1/loop_trans_var,
    rotation 1/loop_rot_var, matching `gt_adjust.cpp:74-78`), LM solve,
    adjusted TUM out."""
    from .graph.graph import PoseGraph
    from .graph.solver import SolveConfig, optimize_graph
    from .io.tum import load_tum, save_tum

    stamps, poses = load_tum(args.input)
    n = len(stamps)
    g = PoseGraph()
    for T in poses:
        g.add_pose(T)
    info_odom = np.eye(6) / args.odom_stddev
    for i in range(1, n):
        rel = np.linalg.inv(poses[i - 1]) @ poses[i]
        g.add_between(i - 1, i, rel, info=info_odom, robust_delta=args.huber)
    # loop edges: identity relative pose between matched indices
    info_loop = np.eye(6)
    info_loop[:3, :3] /= args.loop_rot_var  # [rot, trans] state convention
    info_loop[3:, 3:] /= args.loop_trans_var
    n_loops = 0
    for pair in args.loop or []:
        i, j = (int(x) for x in pair.split(":"))
        if not (0 <= i < n and 0 <= j < n):
            sys.exit(f"loop index pair {pair} out of range (n={n})")
        g.add_between(i, j, np.eye(4), info=info_loop)
        n_loops += 1
    poses0, graph = g.freeze()
    res = optimize_graph(poses0, graph, SolveConfig(max_iterations=args.iters))
    out = np.asarray(res.poses)
    save_tum(args.output, stamps, out)
    print(
        json.dumps(
            {
                "n_poses": n,
                "n_loops": n_loops,
                "chi2": float(res.chi2),
                "iterations": int(res.iterations),
                "output": args.output,
            }
        )
    )


def cmd_utm_align(args):
    """UTM->world transform via a single-SE3-vertex graph solve (parity:
    `src/gps_traj_align.cpp:225-247`): associate trajectory and GPS fixes by
    timestamp (max-difference gate), add one EdgeSE3GtUTM-style factor per
    pair with information diag(1/var), LM-solve the one vertex.

    GPS file: whitespace/comma-separated `stamp east north alt [var_x var_y
    var_z]` rows (# comments skipped)."""
    from .graph.graph import PoseGraph
    from .graph.solver import SolveConfig, optimize_graph_with_planes
    from .io.tum import load_tum

    stamps, poses = load_tum(args.trajectory)
    rows = []
    with open(args.gps) as f:
        for line in f:
            line = line.strip().replace(",", " ")
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            rows.append(v + [args.default_var] * (7 - len(v)))
    if not rows:
        sys.exit("no GPS fixes parsed")
    gps = np.asarray(rows)
    # covariance gate (gps_traj_align.cpp:157-158: skip var_x>3 or var_z>8)
    keep = (gps[:, 4] <= args.max_var_xy) & (gps[:, 6] <= args.max_var_z)
    gps = gps[keep]
    # timestamp association (associate(), max_difference gate)
    idx = np.clip(np.searchsorted(stamps, gps[:, 0]), 0, len(stamps) - 1)
    idx_lo = np.clip(idx - 1, 0, len(stamps) - 1)
    d_hi = np.abs(stamps[idx] - gps[:, 0])
    d_lo = np.abs(stamps[idx_lo] - gps[:, 0])
    idx = np.where(d_lo < d_hi, idx_lo, idx)
    ok = np.abs(stamps[idx] - gps[:, 0]) < args.max_dt
    gps, idx = gps[ok], idx[ok]
    if len(gps) < 3:
        sys.exit(f"only {len(gps)} associated pairs (need >= 3)")
    # recenter the UTM fixes: raw easting/northing are ~1e6 m, which both
    # stiffens the rotation linearization (1e6 m lever arms) and loses
    # centimeters to f32; solve for T mapping (utm - centroid) -> world
    centroid = gps[:, 1:4].mean(axis=0)
    p_utm_c = gps[:, 1:4] - centroid
    p_world = poses[idx, :3, 3]
    # closed-form seed (the initial-guess step gps_traj_align.cpp:200-224
    # sketches), then the graph refines with per-fix covariance weighting
    from .io.tum import umeyama_alignment

    _, R0, t0 = umeyama_alignment(p_utm_c, p_world, with_scale=False)
    T0 = np.eye(4)
    T0[:3, :3] = R0
    T0[:3, 3] = t0
    g = PoseGraph()
    g.add_pose(T0)
    for k in range(len(gps)):
        info = np.diag(1.0 / np.maximum(gps[k, 4:7], 1e-9))
        # T_world_utm maps the (recentered) UTM fix onto the trajectory point
        g.add_utm_align(0, p_utm_c[k], p_world[k], info=info)
    poses0, graph = g.freeze()
    planes0, pg = g.freeze_planes()
    res = optimize_graph_with_planes(
        poses0, planes0, graph, pg, SolveConfig(max_iterations=args.iters, fix_first=False)
    )
    T = np.array(res.poses[0], dtype=np.float64)
    # undo the recentering: T_world_utm = T_c . Translate(-centroid)
    T[:3, 3] = T[:3, 3] - T[:3, :3] @ centroid
    print(json.dumps({"n_pairs": int(len(gps)), "chi2": float(res.chi2), "T_world_utm": T.tolist()}))
    if args.output:
        np.savetxt(args.output, T)


def cmd_convert(args):
    from .io.convert import convert_sequence

    frames = []
    for pat in args.frames:
        from glob import glob

        frames.extend(glob(pat))
    # a broad glob easily swallows the sidecar files — drop them
    side = {str(Path(p).resolve()) for p in (args.imu, args.gt) if p}
    frames = [f for f in frames if str(Path(f).resolve()) not in side]
    if not frames:
        sys.exit("no input frames matched")
    n = convert_sequence(
        frames,
        args.output,
        imu_csv=args.imu,
        gt_tum=args.gt,
        rate=args.rate,
        min_range=args.min_range,
        max_range=args.max_range,
    )
    print(f"converted {n} frames -> {args.output}")


def cmd_stream(args):
    """Wall-clock streaming replay with backpressure + deadline accounting
    (parity: `bag_player.py` + `/read_until` flow control; see
    pipeline/streaming.py)."""
    from .io.tum import save_tum
    from .pipeline.odometry import OdometryConfig, ScanMatchingOdometry
    from .pipeline.preprocessing import PreprocessConfig
    from .pipeline.slam import RadarGraphSLAM, SLAMConfig
    from .pipeline.streaming import stream_sequence

    src = Path(args.dataset)
    frames = sorted(src.glob("*.grf"))
    if not frames:
        sys.exit(f"no .grf frames in {src}")
    imu = np.load(src / "imu.npz")
    slam = RadarGraphSLAM(
        SLAMConfig(
            enable_loop_closure=not args.no_loops,
            preint_mode=args.preint,
            gyr_var=float(imu["gyr_var"]),
            vel_var=float(imu["vel_var"]),
        )
    )
    for t, g in zip(imu["gyr_t"], imu["gyr"]):
        slam.push_imu(t, g)
    for t, v in zip(imu["vel_t"], imu["vel"]):
        slam.push_twist(t, v)
    odo = ScanMatchingOdometry(OdometryConfig(registration=args.registration))
    if args.preprocess:
        odo.preprocess_cfg = PreprocessConfig()
    if args.warmup:
        # compile the fused programs outside the timed stream (first-call XLA
        # compilation would otherwise be charged as multi-second latency)
        from .io.native import NativeDataset

        w = ScanMatchingOdometry(OdometryConfig(registration=args.registration))
        w.preprocess_cfg = odo.preprocess_cfg
        ds = NativeDataset(frames[:2], capacity=args.capacity)
        for stamp, xyz, inten, dop in ds:
            packed = np.zeros((args.capacity, 5), np.float32)
            packed[: len(xyz), :3] = xyz
            packed[: len(xyz), 3] = inten
            packed[: len(xyz), 4] = dop
            w.step_fused(float(stamp), packed, len(xyz), ground=args.floor,
                         omega=np.zeros(3) if args.preprocess else None)
    report = stream_sequence(
        frames, slam, odo, imu={"gyr_t": imu["gyr_t"], "gyr": imu["gyr"]},
        rate_multiplier=args.rate_multiplier, mode=args.mode,
        queue_depth=args.queue_depth, capacity=args.capacity,
        optimize_every=args.optimize_every, optimize_window=args.optimize_window,
        ground=args.floor,
    )
    print(report.to_json())
    if args.report_out:
        with open(args.report_out, "w") as fh:
            fh.write(report.to_json())
    if args.output:
        slam.optimize()
        stamps, poses = slam.trajectory()
        save_tum(args.output, stamps, poses)


def cmd_convert_bag(args):
    """Rosbag -> .grf sequence (dependency-free rosbag v2.0 reader; applies
    the NTU Radar_to_livox extrinsic chain unless --no-ntu-extrinsic)."""
    from .io.rosbag import RosbagReader, convert_rosbag

    if args.list_topics:
        for topic, (msgtype, count) in sorted(RosbagReader(args.bag).topics_summary().items()):
            print(f"{topic:<40} {msgtype:<40} {count}")
        return
    if not args.output:
        sys.exit("--output is required (or use --list-topics)")
    n = convert_rosbag(
        args.bag,
        args.output,
        radar_topic=args.radar_topic,
        imu_topic=args.imu_topic,
        twist_topic=args.twist_topic,
        gps_topic=args.gps_topic,
        power_threshold=args.power_threshold,
        apply_ntu_extrinsic=not args.no_ntu_extrinsic,
        max_frames=args.max_frames,
    )
    print(f"converted {n} radar frames -> {args.output}")


def cmd_align(args):
    """Registration benchmark app: align two PCD scans with every variant and
    print fitness + timing — parity with `ndt_omp/apps/align.cpp` and
    `fast_apdgicp/src/align.cpp` (`gicp_align`)."""
    import time

    import jax.numpy as jnp

    from .core.pointcloud import make_cloud
    from .io.pcd import read_pcd, voxel_centroid_downsample
    from .registration import select_registration
    from .registration.gicp import fitness_score

    def load(path):
        xyz, _ = read_pcd(path)
        xyz = xyz[np.all(np.isfinite(xyz), axis=1)]
        return voxel_centroid_downsample(xyz, res=args.leaf)

    tgt = load(args.target)
    src = load(args.source)
    cap = 1 << int(np.ceil(np.log2(max(len(src), len(tgt)))))
    target = make_cloud(jnp.asarray(tgt), capacity=cap)
    source = make_cloud(jnp.asarray(src), capacity=cap)
    print(f"target: {len(tgt)} pts, source: {len(src)} pts (capacity {cap})")

    methods = args.methods.split(",") if args.methods else [
        "ICP", "GICP", "FAST_GICP", "FAST_APDGICP", "FAST_VGICP",
        "FAST_VGICP_CUDA", "NDT_OMP", "NDT_CUDA_D2D",
    ]
    print(f"{'method':<16} {'fitness':>9} {'first ms':>10} {'warm ms':>9}")
    rows = []
    for name in methods:
        kwargs = {}
        if "NDT" in name:
            kwargs = dict(resolution=args.ndt_resolution)
        align = select_registration(name, **kwargs)
        # time with block_until_ready; fetch values at the end
        t0 = time.perf_counter()
        res = align(source, target)
        res.T.block_until_ready()
        first = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for _ in range(args.repeat):
            res = align(source, target)
        res.T.block_until_ready()
        warm = (time.perf_counter() - t0) * 1e3 / max(args.repeat, 1)
        rows.append((name, first, warm, res.T))
    # fitness AFTER all timing: its async kNN pass would otherwise still be
    # draining on the device stream and contaminate the next method's timings
    for name, first, warm, T in rows:
        fit, _ = fitness_score(source, target, T, max_range=jnp.inf)
        print(f"{name:<16} {float(fit):>9.6f} {first:>10.2f} {warm:>9.2f}")
    if args.print_transform:
        print("final transform (last method):")
        print(np.array_str(np.asarray(rows[-1][3]), precision=5, suppress_small=True))


def cmd_visualize(args):
    """Render a run's artifacts (markers JSON, trajectories, map npz) to a
    top-down PNG — the offline counterpart of the rviz MarkerArray/map topics
    (`radar_graph_slam_nodelet.cpp:885-1121`)."""
    from .utils.viz import render_run

    out = render_run(
        args.output,
        markers_json=args.markers,
        trajectory_tum=args.trajectory,
        groundtruth_tum=args.groundtruth,
        map_npz=args.map,
        title=args.title,
    )
    print(f"wrote {out}")


def cmd_dump_config(args):
    from .config import GorioConfig, save_config

    save_config(GorioConfig(), args.output)
    print(f"wrote {args.output}")


def cmd_bench(args):
    import runpy

    sys.argv = ["bench.py"]
    runpy.run_path(str(Path(__file__).resolve().parents[1] / "bench.py"), run_name="__main__")


def main(argv=None):
    from .utils.jax_config import configure_jax

    configure_jax()
    p = argparse.ArgumentParser(prog="gorio_tpu", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("simulate")
    s.add_argument("--circuit", action="store_true",
                   help="closed-loop trajectory (revisits the start; exercises loop closure)")
    s.add_argument("--laps", type=float, default=1.0,
                   help="circuit laps within --duration (2+ = NTU loop2/loop3-style multi-revisit)")
    s.add_argument("--figure8", action="store_true",
                   help="figure-8 trajectory (two opposite-yaw lobes per lap; "
                   "crossing-point revisits — the held-out loop-closure geometry)")
    s.add_argument("--elev-amp", type=float, default=0.0, dest="elev_amp",
                   help="vertical-velocity amplitude (m/s) for a gentle elevation profile")
    s.add_argument("--output", required=True)
    s.add_argument("--duration", type=float, default=20.0)
    s.add_argument("--rate", type=float, default=5.0)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--landmarks", type=int, default=9000,
                   help="landmark count PER ±60 m world tile (density-calibrated: "
                        "the actual count auto-scales with the trajectory's extent, "
                        "keeping scene density constant — scale it nowhere else)")
    s.add_argument("--capacity", type=int, default=2048)
    s.add_argument("--stops", type=int, default=0,
                   help="number of zero-velocity dwell intervals")
    s.add_argument("--dynamic", type=int, default=0,
                   help="number of moving objects (Doppler-inconsistent clutter)")
    s.add_argument("--gps", action="store_true",
                   help="write gps.npz (noisy fixes with dropout windows + outliers)")
    s.add_argument("--gps-rate", type=float, default=2.0)
    s.add_argument("--gps-noise-xy", type=float, default=0.5)
    s.add_argument("--fov-azimuth", type=float, default=56.5,
                   help="radar azimuth half-FOV in degrees (Eagle-style sensor)")
    s.add_argument("--fov-elevation", type=float, default=22.5,
                   help="radar elevation half-FOV in degrees")
    s.add_argument("--omni", action="store_true",
                   help="legacy omnidirectional render (no FOV restriction)")
    s.set_defaults(fn=cmd_simulate)

    s = sub.add_parser("slam")
    s.add_argument("--config", default=None,
                   help="YAML/JSON GorioConfig tree (see dump-config); flags override")
    s.add_argument("--floor", action="store_true",
                   help="ground-plane floor constraint (EdgeSE3Plane on a world floor vertex)")
    s.add_argument("--optimize-window", type=int, default=0,
                   help="fixed-lag mode: re-optimize only the last N keyframes per cycle")
    s.add_argument("--fused", action="store_true",
                   help="single-dispatch fused frontend (ego-vel + align in one device program)")
    s.add_argument("--status-out", default=None,
                   help="write per-frame ScanMatchingStatus records as JSON")
    s.add_argument("--preprocess", action="store_true",
                   help="run the full preprocessing chain (power/distance gates, outlier removal, "
                        "dynamic-object removal, deskew, ground seg, DBSCAN) — fused into the "
                        "frontend program with --fused")
    s.add_argument("--dataset", required=True)
    s.add_argument("--output", default="trajectory.tum")
    s.add_argument("--registration", default="apdgicp", choices=["apdgicp", "gicp", "ndt"])
    s.add_argument("--preint", default="lpm", choices=["lpm", "ugpm"])
    s.add_argument("--capacity", type=int, default=2048)
    s.add_argument("--optimize-every", type=int, default=0)
    s.add_argument("--no-loops", action="store_true")
    s.add_argument("--no-gps", action="store_true",
                   help="ignore the dataset's gps.npz fixes")
    s.add_argument("--timing-out", default=None,
                   help="write per-stage median timings + counts as JSON")
    s.add_argument("--dump", default=None)
    s.add_argument("--map", default=None)
    s.add_argument("--map-resolution", type=float, default=0.2)
    s.set_defaults(fn=cmd_slam)

    s = sub.add_parser("evaluate")
    s.add_argument("estimate")
    s.add_argument("groundtruth")
    s.set_defaults(fn=cmd_evaluate)

    s = sub.add_parser("align-traj")
    s.add_argument("source")
    s.add_argument("target")
    s.add_argument("--scale", action="store_true")
    s.add_argument("--output", default=None)
    s.set_defaults(fn=cmd_align_traj)

    s = sub.add_parser("convert")
    s.add_argument("frames", nargs="+", help="frame file globs (.csv/.npz/.npy)")
    s.add_argument("--output", required=True)
    s.add_argument("--imu", default=None, help="CSV t,wx,wy,wz[,vx,vy,vz]")
    s.add_argument("--gt", default=None, help="ground-truth TUM file to bundle")
    s.add_argument("--rate", type=float, default=10.0)
    s.add_argument("--min-range", type=float, default=0.0)
    s.add_argument("--max-range", type=float, default=float("inf"))
    s.set_defaults(fn=cmd_convert)

    s = sub.add_parser("stream")
    s.add_argument("--dataset", required=True)
    s.add_argument("--rate-multiplier", type=float, default=1.0,
                   help="replay speed vs the recording clock (1.0 = real time)")
    s.add_argument("--mode", default="block", choices=["block", "drop"],
                   help="backpressure: block the producer (/read_until contract) "
                        "or drop the oldest queued frame (live-sensor behavior)")
    s.add_argument("--queue-depth", type=int, default=4)
    s.add_argument("--capacity", type=int, default=2048)
    s.add_argument("--registration", default="apdgicp", choices=["apdgicp", "gicp", "ndt"])
    s.add_argument("--preint", default="lpm", choices=["lpm", "ugpm"])
    s.add_argument("--preprocess", action="store_true")
    s.add_argument("--floor", action="store_true")
    s.add_argument("--no-loops", action="store_true")
    s.add_argument("--optimize-every", type=int, default=0)
    s.add_argument("--optimize-window", type=int, default=0)
    s.add_argument("--warmup", action="store_true", default=True)
    s.add_argument("--no-warmup", dest="warmup", action="store_false")
    s.add_argument("--report-out", default=None)
    s.add_argument("--output", default=None, help="final optimized TUM trajectory")
    s.set_defaults(fn=cmd_stream)

    s = sub.add_parser("convert-bag")
    s.add_argument("bag", help="rosbag v2.0 file (NTU4DRadLM-style)")
    s.add_argument("--output", default=None)
    s.add_argument("--list-topics", action="store_true",
                   help="print topic/type/count summary and exit")
    s.add_argument("--radar-topic", default="/radar_enhanced_pcl")
    s.add_argument("--imu-topic", default="/imu/data")
    s.add_argument("--twist-topic", default=None)
    s.add_argument("--gps-topic", default=None)
    s.add_argument("--power-threshold", type=float, default=0.0)
    s.add_argument("--no-ntu-extrinsic", action="store_true",
                   help="skip the Radar_to_livox rotation (non-NTU rigs)")
    s.add_argument("--max-frames", type=int, default=None)
    s.set_defaults(fn=cmd_convert_bag)

    s = sub.add_parser("align")
    s.add_argument("target")
    s.add_argument("source")
    s.add_argument("--leaf", type=float, default=0.1, help="voxel downsample leaf (m)")
    s.add_argument("--ndt-resolution", type=float, default=2.0)
    s.add_argument("--methods", default=None, help="comma-separated subset")
    s.add_argument("--repeat", type=int, default=3)
    s.add_argument("--print-transform", action="store_true")
    s.set_defaults(fn=cmd_align)

    s = sub.add_parser("gt-adjust")
    s.add_argument("input", help="TUM trajectory to adjust")
    s.add_argument("output", help="adjusted TUM trajectory")
    s.add_argument(
        "--loop",
        action="append",
        metavar="I:J",
        help="identity loop edge between pose indices (repeatable), e.g. 0:8240",
    )
    s.add_argument("--odom-stddev", type=float, default=0.05)
    s.add_argument("--loop-trans-var", type=float, default=0.5)
    s.add_argument("--loop-rot-var", type=float, default=1.0)
    s.add_argument("--huber", type=float, default=1.0)
    s.add_argument("--iters", type=int, default=64)
    s.set_defaults(fn=cmd_gt_adjust)

    s = sub.add_parser("utm-align")
    s.add_argument("trajectory", help="TUM world-frame trajectory")
    s.add_argument("gps", help="stamp east north alt [var_x var_y var_z] rows")
    s.add_argument("--output", default=None, help="write the 4x4 T_world_utm")
    s.add_argument("--max-dt", type=float, default=0.02)
    s.add_argument("--max-var-xy", type=float, default=3.0)
    s.add_argument("--max-var-z", type=float, default=8.0)
    s.add_argument("--default-var", type=float, default=1.0)
    s.add_argument("--iters", type=int, default=64)
    s.set_defaults(fn=cmd_utm_align)

    s = sub.add_parser("visualize")
    s.add_argument("--output", default="run.png")
    s.add_argument("--markers", default=None, help="export_markers JSON")
    s.add_argument("--trajectory", default=None, help="estimated TUM trajectory")
    s.add_argument("--groundtruth", default=None, help="ground-truth TUM trajectory")
    s.add_argument("--map", default=None, help="map npz (from slam --map)")
    s.add_argument("--title", default=None)
    s.set_defaults(fn=cmd_visualize)

    s = sub.add_parser("dump-config")
    s.add_argument("--output", default="gorio_config.json")
    s.set_defaults(fn=cmd_dump_config)

    s = sub.add_parser("bench")
    s.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
