"""Gyro-based scan deskewing.

Counterpart of `PreprocessingNodelet::deskewing`
(`preprocessing_nodelet_ntu.cpp:658-719`): each point i is rotated by the
inverse of the small-angle quaternion q = (1, dt/2 * w) with
dt = scan_period * i / N and w = -omega (latest gyro before the scan stamp).
One batched rotation instead of a per-point loop.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core import lie
from ..core.pointcloud import PointCloud


def deskew(cloud: PointCloud, omega, scan_period: float = 0.1) -> PointCloud:
    """omega: (3,) angular velocity at scan time (body frame, rad/s)."""
    n = cloud.capacity
    dtype = cloud.xyz.dtype
    frac = jnp.arange(n, dtype=dtype) / n
    dt = scan_period * frac
    ang = -jnp.asarray(omega, dtype)  # reference negates the rate (`:691`)
    # exact small-rotation: R(dt) = exp(ang * dt); reference uses the
    # first-order quaternion — at radar rates the difference is < 1e-6 rad
    rotvec = -dt[:, None] * ang[None, :]  # inverse rotation
    R = lie.so3_exp(rotvec)
    xyz = jnp.einsum("nij,nj->ni", R, cloud.xyz)
    return cloud._replace(xyz=jnp.where(cloud.mask[:, None], xyz, cloud.xyz))
