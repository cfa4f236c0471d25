"""Stored real-time streaming benchmark -> STREAM.json.

Replays the circuit accuracy sequence against the wall clock through the
streaming driver (`pipeline/streaming.py`) in both backpressure modes and
stores frames-on-time %, latency percentiles, and the realtime factor. This
is the counterpart of the reference's rate-1.0 rosbag replay proof
(`launch/rosbag_play_ntu.launch` + `/read_until` flow control).

The stored numbers are a CPU (float64) regression floor, not a device
measurement. On the GPU the same replay runs through the CLI
(`python -m gorio_tpu.cli stream ...`; `chip_smoke.py` phase (e)).

    JAX_PLATFORMS=cpu python scripts/stream_benchmark.py --update
"""

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from gorio_tpu.utils.jax_config import configure_jax  # noqa: E402

configure_jax()
assert jax.default_backend() == "cpu", jax.default_backend()

REPO = Path(__file__).resolve().parent.parent
STREAM_JSON = REPO / "STREAM.json"


def run(rate: float, mode: str, workdir=None, loops: bool = True) -> dict:
    """Wall-clock replay of the recall CIRCUIT sequence with the FULL backend
    in the loop: loop closure enabled and periodic optimization running on
    the async worker thread at the reference's 2-3 s cadence
    (`radar_graph_slam_nodelet.cpp:750-834` — VERDICT r4 item 2: real-time
    and loop closure must be simultaneously true, not proven separately)."""
    import numpy as np

    from gorio_tpu.cli import main
    from gorio_tpu.pipeline.odometry import OdometryConfig, ScanMatchingOdometry
    from gorio_tpu.pipeline.preprocessing import PreprocessConfig
    from gorio_tpu.pipeline.slam import RadarGraphSLAM, SLAMConfig
    from gorio_tpu.pipeline.streaming import stream_sequence

    base = Path(workdir or tempfile.mkdtemp(prefix="gorio_stream_"))
    ds = base / "seq"
    if not (ds / "imu.npz").exists():
        # the stored-accuracy circuit (same generator args as RECALL.json's
        # circuit2): two laps, revisits => real loop-closure work mid-stream
        main([
            "simulate", "--output", str(ds), "--duration", "75", "--rate", "5",
            "--seed", "22", "--circuit", "--laps", "2", "--dynamic", "2",
        ])
    imu = np.load(ds / "imu.npz")
    slam = RadarGraphSLAM(SLAMConfig(
        enable_loop_closure=loops,
        gyr_var=float(imu["gyr_var"]), vel_var=float(imu["vel_var"]),
    ))
    for t, g in zip(imu["gyr_t"], imu["gyr"]):
        slam.push_imu(t, g)
    for t, v in zip(imu["vel_t"], imu["vel"]):
        slam.push_twist(t, v)
    odo = ScanMatchingOdometry(OdometryConfig())
    odo.preprocess_cfg = PreprocessConfig()
    frames = sorted(ds.glob("*.grf"))
    # warm the jitted programs outside the timed stream
    from gorio_tpu.io.native import NativeDataset

    w = ScanMatchingOdometry(OdometryConfig())
    w.preprocess_cfg = odo.preprocess_cfg
    for stamp, xyz, inten, dop in NativeDataset([str(f) for f in frames[:2]], capacity=2048):
        packed = np.zeros((2048, 5), np.float32)
        packed[: len(xyz), :3] = xyz
        packed[: len(xyz), 3] = inten
        packed[: len(xyz), 4] = dop
        w.step_fused(float(stamp), packed, len(xyz), omega=np.zeros(3))
    report = stream_sequence(
        frames, slam, odo, imu={"gyr_t": imu["gyr_t"], "gyr": imu["gyr"]},
        rate_multiplier=rate, mode=mode, capacity=2048,
        # ~3 s cadence at 5 Hz keyframes; async like the reference's timer
        optimize_every=(15 if loops else 0), optimize_async=True,
    )
    out = json.loads(report.to_json())
    # trajectory quality of THIS streamed run (loops must not only fire but
    # help): final (untimed) optimize like the reference's save path, then
    # ATE against the recording's ground truth
    slam.optimize()
    from gorio_tpu.io.tum import ate_rmse, load_tum

    gs, gp = load_tum(ds / "groundtruth.tum")
    st, sp = slam.trajectory()
    out["ate_rmse_m"] = round(float(ate_rmse(st, sp, np.asarray(gs), gp)), 4)
    return out


def main_cli():
    ap = argparse.ArgumentParser()
    ap.add_argument("--update", action="store_true")
    ap.add_argument("--rate", type=float, default=1.0)
    ap.add_argument("--rates", type=str, default="",
                    help="comma-separated extra rate multipliers")
    args = ap.parse_args()
    platform = jax.default_backend()
    with tempfile.TemporaryDirectory(prefix="gorio_stream_") as wd:
        # throwaway pass: the per-run warmup covers the frontend programs but
        # the backend (preintegration batches, the pow2-bucketed graph
        # solves, loop-verification batches) compiles lazily on first
        # contact — without this the FIRST measured mode eats multi-second
        # compile latencies inside the measured window. BLOCK mode on purpose: drop mode loses most
        # frames at rate 8, so the big keyframe-count buckets never compile
        # (measured r5: the first measured run then spent 30-110 s per
        # optimize cycle compiling, starving loop closure and the deadline
        # stats alike).
        run(8.0, "block", wd)
        results = {
            "platform": platform,
            "block_rate1": run(args.rate, "block", wd),
            "drop_rate1": run(args.rate, "drop", wd),
            # frontend-only reference point (r4's configuration): isolates
            # how much of any deadline slip is the backend-in-the-loop
            "frontend_only_block_rate1": run(args.rate, "block", wd, loops=False),
        }
        for r in (float(x) for x in args.rates.split(",") if x):
            results[f"block_rate{r:g}"] = run(r, "block", wd)
    print(json.dumps(results, indent=2))
    if args.update:
        STREAM_JSON.write_text(json.dumps(results, indent=2) + "\n")
        print(f"wrote {STREAM_JSON}", file=sys.stderr)


if __name__ == "__main__":
    main_cli()
