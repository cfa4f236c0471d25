"""Keyframe records and the keyframe-decision gate.

Counterpart of `KeyFrame`/`KeyFrameSnapshot`
(`include/radar_graph_slam/keyframe.hpp:27,69`, `src/.../keyframe.cpp`) and
`KeyframeUpdater` (`keyframe_updater.hpp:16-90`). Keyframes carry host-side
metadata plus the fixed-shape cloud; save/load mirrors the per-keyframe
directory format (`keyframe.cpp:22-146`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core.pointcloud import PointCloud, make_cloud


@dataclass
class KeyFrame:
    index: int
    stamp: float
    odom_scan2scan: np.ndarray  # (4,4) odometry estimate at creation
    accum_distance: float
    cloud: PointCloud
    odom_scan2map: Optional[np.ndarray] = None
    utm_coord: Optional[np.ndarray] = None
    altitude: Optional[float] = None  # barometer altitude (`keyframe.hpp:52`)
    floor_coeffs: Optional[np.ndarray] = None  # (4,) plane, `keyframe.cpp:38-40`
    acceleration: Optional[np.ndarray] = None  # (3,), `keyframe.cpp:46-48`
    orientation: Optional[np.ndarray] = None  # (4,) quat wxyz, `keyframe.cpp:50-52`
    trans_integrated: Optional[np.ndarray] = None  # GP-preintegrated delta
    preint_cov: Optional[np.ndarray] = None
    optimized_pose: Optional[np.ndarray] = None  # filled after graph solve
    edge_info: Optional[np.ndarray] = None  # cached odometry-edge information

    def save(self, directory: str):
        """Parity: `KeyFrame::save` (`keyframe.cpp:22-59`)."""
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "data"), "w") as fh:
            fh.write(f"stamp {self.stamp}\n")
            est = self.optimized_pose if self.optimized_pose is not None else self.odom_scan2scan
            fh.write("estimate\n")
            for row in np.asarray(est):
                fh.write(" ".join(map(str, row)) + "\n")
            fh.write("odom\n")
            for row in np.asarray(self.odom_scan2scan):
                fh.write(" ".join(map(str, row)) + "\n")
            fh.write(f"accum_distance {self.accum_distance}\n")
            if self.floor_coeffs is not None:
                fh.write("floor_coeffs " + " ".join(map(str, self.floor_coeffs)) + "\n")
            if self.utm_coord is not None:
                fh.write("utm_coord " + " ".join(map(str, self.utm_coord)) + "\n")
            if self.altitude is not None:
                fh.write(f"altitude {self.altitude}\n")
            if self.acceleration is not None:
                fh.write("acceleration " + " ".join(map(str, self.acceleration)) + "\n")
            if self.orientation is not None:
                fh.write("orientation " + " ".join(map(str, self.orientation)) + "\n")
            fh.write(f"id {self.index}\n")
        np.savez_compressed(
            os.path.join(directory, "cloud.npz"),
            xyz=np.asarray(self.cloud.xyz),
            intensity=np.asarray(self.cloud.intensity),
            doppler=np.asarray(self.cloud.doppler),
            cluster=np.asarray(self.cloud.cluster),
            mask=np.asarray(self.cloud.mask),
        )

    @classmethod
    def load(cls, directory: str) -> "KeyFrame":
        """Parity: `KeyFrame::load` (`keyframe.cpp:61-146`)."""
        stamp, est, odom, accum, idx, utm = 0.0, np.eye(4), np.eye(4), 0.0, 0, None
        floor, acc, orient, alt = None, None, None, None
        with open(os.path.join(directory, "data")) as fh:
            lines = fh.read().splitlines()
        i = 0
        while i < len(lines):
            tok = lines[i].split()
            if tok[0] == "stamp":
                stamp = float(tok[1])
            elif tok[0] == "estimate":
                est = np.array([[float(v) for v in lines[i + r + 1].split()] for r in range(4)])
                i += 4
            elif tok[0] == "odom":
                odom = np.array([[float(v) for v in lines[i + r + 1].split()] for r in range(4)])
                i += 4
            elif tok[0] == "accum_distance":
                accum = float(tok[1])
            elif tok[0] == "utm_coord":
                utm = np.array([float(v) for v in tok[1:]])
            elif tok[0] == "altitude":
                alt = float(tok[1])
            elif tok[0] == "floor_coeffs":
                floor = np.array([float(v) for v in tok[1:]])
            elif tok[0] == "acceleration":
                acc = np.array([float(v) for v in tok[1:]])
            elif tok[0] == "orientation":
                orient = np.array([float(v) for v in tok[1:]])
            elif tok[0] == "id":
                idx = int(tok[1])
            i += 1
        d = np.load(os.path.join(directory, "cloud.npz"))
        cloud = PointCloud(
            xyz=d["xyz"], intensity=d["intensity"], doppler=d["doppler"],
            cluster=d["cluster"], mask=d["mask"],
        )
        kf = cls(index=idx, stamp=stamp, odom_scan2scan=odom, accum_distance=accum, cloud=cloud)
        kf.optimized_pose = est
        kf.utm_coord = utm
        kf.altitude = alt
        kf.floor_coeffs = floor
        kf.acceleration = acc
        kf.orientation = orient
        return kf


@dataclass
class KeyframeUpdater:
    """Delta-gated keyframe decision (`keyframe_updater.hpp:37-70`)."""

    delta_trans: float = 0.25
    delta_angle: float = 0.15
    delta_time: float = 1.0
    accum_distance: float = 0.0
    _prev_pose: Optional[np.ndarray] = None
    _prev_time: float = 0.0

    def decide(self, pose: np.ndarray, stamp: float) -> bool:
        if self._prev_pose is None:
            self._prev_pose = np.asarray(pose)
            self._prev_time = stamp
            return True
        delta = np.linalg.inv(self._prev_pose) @ np.asarray(pose)
        dx = float(np.linalg.norm(delta[:3, 3]))
        cos_a = np.clip((np.trace(delta[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        da = float(np.arccos(cos_a))
        dt = stamp - self._prev_time
        if dx < self.delta_trans and da < self.delta_angle and dt < self.delta_time:
            return False
        self.accum_distance += dx
        self._prev_pose = np.asarray(pose)
        self._prev_time = stamp
        return True
