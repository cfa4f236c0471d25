"""Wall-clock streaming replay with backpressure + deadline accounting.

The reference proves real-time operation by replaying NTU4DRadLM bags at
rate 1.0 through `bag_player.py`, whose publisher BLOCKS until the pipeline
signals `/read_until` consumption (flow control:
`/root/reference/4DRadarSLAM/src/radar_graph_slam/bag_player.py`,
`scan_matching_odometry_nodelet.cpp:383-389`). This module is the
counterpart: a producer thread releases frames on the recording's
own wall-clock schedule into a BOUNDED queue feeding the fused frontend +
backend, in one of two modes:

  block — the producer stalls when the queue is full (the `/read_until`
          contract: nothing is lost, the clock slips — measures how far from
          real-time the pipeline runs)
  drop  — the producer drops the oldest queued frame (a live sensor's
          behavior: the clock holds, frames are lost)

Per-frame deadline accounting (latency vs the sensor period) lands in a JSON
report: frames on time, p50/p95/max latency, dropped frames, end-to-end
wall-clock vs recording span. The driver runs `optimize(window)` every
`optimize_every` keyframes inside the loop, so backend cost is charged to
the stream like the reference's optimization timer thread.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class StreamReport:
    n_frames: int = 0
    n_processed: int = 0
    n_dropped: int = 0
    n_keyframes: int = 0
    n_loops: int = 0
    n_opt_cycles: int = 0
    n_opt_skipped: int = 0  # optimize ticks skipped: previous cycle still running
    opt_p50_ms: float = 0.0
    opt_max_ms: float = 0.0
    on_time_frac: float = 0.0
    latency_p50_ms: float = 0.0
    latency_p95_ms: float = 0.0
    latency_max_ms: float = 0.0
    period_ms: float = 0.0
    wall_s: float = 0.0
    recording_s: float = 0.0
    realtime_factor: float = 0.0  # recording span / wall clock (>=1 is RT)
    mode: str = "block"

    def to_json(self) -> str:
        return json.dumps(self.__dict__)


def stream_sequence(
    frames,
    slam,
    odo,
    imu: Optional[dict] = None,
    rate_multiplier: float = 1.0,
    mode: str = "block",
    queue_depth: int = 4,
    capacity: int = 2048,
    optimize_every: int = 0,
    optimize_window: int = 0,
    optimize_async: bool = False,
    ground: bool = False,
) -> StreamReport:
    """Replay `frames` (.grf paths) against wall clock. Returns the report.

    `slam`/`odo` are RadarGraphSLAM / ScanMatchingOdometry instances already
    loaded with measurement streams (gyro/twist/GPS pushed up front, like the
    CLI driver); `imu` optionally maps 'gyr_t'/'gyr' arrays for fused deskew.
    """
    from ..io.native import NativePipelineDataset

    ds = NativePipelineDataset(frames, capacity=capacity, queue_depth=queue_depth)
    q: queue.Queue = queue.Queue(maxsize=max(queue_depth, 1))
    stop = threading.Event()
    n_dropped = 0
    n_frames = 0
    first_stamp = None
    last_stamp = None

    gyr_t = np.asarray(imu["gyr_t"]) if imu is not None else None
    gyr = np.asarray(imu["gyr"]) if imu is not None else None

    def omega_at(t):
        if gyr_t is None or gyr_t.size == 0:
            return None
        i = np.clip(np.searchsorted(gyr_t, t) - 1, 0, gyr_t.size - 1)
        return gyr[i]

    def producer():
        nonlocal n_dropped, n_frames, first_stamp, last_stamp
        t_wall0 = time.monotonic()
        t_rec0 = None
        # the sentinel (or a raised exception) must reach the consumer even
        # when dataset iteration dies mid-stream (e.g. a corrupt .grf) —
        # otherwise the consumer blocks forever on q.get()
        final: object = None
        try:
            for stamp, n_pts, packed in ds:
                if stop.is_set():
                    break
                n_frames += 1
                if t_rec0 is None:
                    t_rec0 = stamp
                    first_stamp = stamp
                last_stamp = stamp
                # release on the recording clock
                release = t_wall0 + (stamp - t_rec0) / rate_multiplier
                delay = release - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                # Latency is accounted from the frame's *scheduled* sensor
                # arrival (`release`), not from queue insertion: in block
                # mode the producer can stall past its schedule while the
                # queue is full, and that stall is latency a robot would see.
                item = (stamp, n_pts, packed.copy(), release)
                if mode == "drop":
                    while True:
                        try:
                            q.put_nowait(item)
                            break
                        except queue.Full:
                            try:
                                q.get_nowait()
                                n_dropped += 1
                            except queue.Empty:
                                pass
                else:  # block: the /read_until contract
                    q.put(item)
        except BaseException as exc:  # propagate to the consumer
            final = exc
        finally:
            q.put(final)

    th = threading.Thread(target=producer, daemon=True)
    t_start = time.monotonic()
    th.start()

    latencies = []
    deadlines_met = 0
    n_processed = 0
    prev_stamp = None
    period_est = []
    # async optimize: the reference runs its optimization timer on its own
    # thread concurrent with 10 Hz ingest (`radar_graph_slam_nodelet.cpp:
    # 750-834`); here a single worker thread plays that role. A tick that
    # fires while the previous cycle is still running is SKIPPED (a timer
    # callback cannot overlap itself) and counted. `slam.optimize` snapshots
    # the keyframe list up front, so the frontend keeps appending safely.
    opt_executor = None
    opt_future = None
    opt_times: list = []
    n_opt = 0
    n_opt_skipped = 0
    if optimize_every and optimize_async:
        from concurrent.futures import ThreadPoolExecutor

        opt_executor = ThreadPoolExecutor(max_workers=1)

    def run_optimize():
        t0 = time.monotonic()
        slam.optimize(window=optimize_window or None)
        opt_times.append(time.monotonic() - t0)

    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            stamp, n_pts, packed, t_release = item
            pose, v = odo.step_fused(
                float(stamp), packed, n_pts, ground=ground,
                omega=omega_at(float(stamp)),
            )
            slam.push_twist(float(stamp), v)
            floor = None
            if ground and getattr(odo, "last_ground_count", 0) >= slam.cfg.floor_min_ground_points \
                    and abs(odo.last_plane[2]) > slam.cfg.floor_max_tilt_nz:
                floor = odo.last_plane
            slam.add_frame(float(stamp), odo.last_cloud, pose, floor_coeffs=floor)
            if optimize_every and len(slam.keyframes) % optimize_every == 0:
                if opt_executor is not None:
                    if opt_future is None or opt_future.done():
                        if opt_future is not None:
                            opt_future.result()  # surface exceptions
                        opt_future = opt_executor.submit(run_optimize)
                        n_opt += 1
                    else:
                        n_opt_skipped += 1
                else:
                    run_optimize()
                    n_opt += 1
            lat = time.monotonic() - t_release
            latencies.append(lat)
            if prev_stamp is not None:
                period_est.append(stamp - prev_stamp)
            prev_stamp = stamp
            n_processed += 1
    finally:
        stop.set()
        th.join(timeout=5)
        if opt_executor is not None:
            if opt_future is not None:
                opt_future.result()
            opt_executor.shutdown(wait=True)

    wall = time.monotonic() - t_start
    period = float(np.median(period_est)) / rate_multiplier if period_est else 0.1
    lat = np.asarray(latencies) if latencies else np.zeros(1)
    on_time = float(np.mean(lat <= period)) if latencies else 0.0
    rec_span = (last_stamp - first_stamp) if (first_stamp is not None and last_stamp) else 0.0
    opt_arr = np.asarray(opt_times) if opt_times else np.zeros(1)
    return StreamReport(
        n_frames=n_frames,
        n_processed=n_processed,
        n_dropped=n_dropped,
        n_keyframes=len(slam.keyframes),
        n_loops=len(slam.loops),
        n_opt_cycles=n_opt,
        n_opt_skipped=n_opt_skipped,
        opt_p50_ms=round(float(np.percentile(opt_arr, 50)) * 1e3, 2) if opt_times else 0.0,
        opt_max_ms=round(float(opt_arr.max()) * 1e3, 2) if opt_times else 0.0,
        on_time_frac=round(on_time, 4),
        latency_p50_ms=round(float(np.percentile(lat, 50)) * 1e3, 2),
        latency_p95_ms=round(float(np.percentile(lat, 95)) * 1e3, 2),
        latency_max_ms=round(float(lat.max()) * 1e3, 2),
        period_ms=round(period * 1e3, 2),
        wall_s=round(wall, 3),
        recording_s=round(rec_span, 3),
        realtime_factor=round(rec_span / rate_multiplier / max(wall, 1e-9), 3),
        mode=mode,
    )
