"""Batched SO(3)/SE(3) Lie-group math.

Counterpart of the reference's header-only Lie utilities
(`4DRadarSLAM/include/VelInt/math_utils.h:48-100`, `fast_apdgicp/include/fast_gicp/so3/so3.hpp`):
every op works on arbitrarily batched inputs `(..., 3)` / `(..., 3, 3)` and is
safe under `jit`/`vmap`/`grad` (Taylor fallbacks near the identity instead of
branches).

Conventions: rotation vectors are axis*angle ("rotvec"), rotations act on
column vectors, SE(3) is stored as (R, t) pairs or 4x4 homogeneous matrices.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Below this squared-angle, use Taylor expansions (safe for f32 and f64).
_EPS = 1e-8


def hat(v):
    """Skew-symmetric matrix of (..., 3) -> (..., 3, 3).

    Mirrors `math_utils.h:187` (toSkewSymMat)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(M):
    """Inverse of `hat`: (..., 3, 3) -> (..., 3)."""
    return jnp.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], axis=-1)


def _sinc_coeffs(theta2):
    """Return (A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3) with Taylor
    fallbacks for small angles. theta2 = |r|^2.

    All denominators use the clamped theta2 so the non-selected branch stays
    finite-valued and finite-gradient at 0 (otherwise `where` leaks NaN in
    reverse mode)."""
    t2 = jnp.maximum(theta2, _EPS)
    theta = jnp.sqrt(t2)
    small = theta2 < _EPS
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / t2)
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (t2 * theta))
    return a, b, c


def so3_exp(r):
    """SO(3) exponential map, (..., 3) -> (..., 3, 3). Rodrigues formula.

    Parity: `math_utils.h:55` (expMap)."""
    theta2 = jnp.sum(r * r, axis=-1)
    a, b, _ = _sinc_coeffs(theta2)
    K = hat(r)
    KK = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=r.dtype), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * KK


def so3_log(R):
    """SO(3) logarithm, (..., 3, 3) -> (..., 3) rotation vector.

    Robust around the identity and near angle pi (uses the diagonal of
    R + R^T to recover the axis when sin(theta) ~ 0).
    Parity: `math_utils.h:48` (logMap)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    # keep strictly inside (-1, 1): arccos has an infinite derivative at the
    # endpoints, which leaks NaN through `where` in reverse-mode autodiff.
    # The margin must be representable IN THE INPUT DTYPE: in float32,
    # 1.0 - 1e-14 rounds back to 1.0 and the clip is a no-op — every f32
    # autodiff consumer (f32 HMC, f32 graph solves) got NaN gradients
    # at identity-rotation residuals (found by the r5 ESS benchmark: chains
    # of NaNs). f32 margin 1e-6 => theta saturates ~1.4e-3 at the endpoints;
    # the rotvec value is unaffected near identity (r = scale * vee(R-R^T)
    # with vee ~ 0) and the near-pi branch threshold below is raised to
    # match the saturation.
    _f32 = R.dtype == jnp.float32
    _eps_clip = 1e-6 if _f32 else 1e-14
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0 + _eps_clip, 1.0 - _eps_clip)
    theta = jnp.arccos(cos_t)
    # Generic case: r = theta/(2 sin theta) * vee(R - R^T)
    w = vee(R - jnp.swapaxes(R, -1, -2))  # = 2 sin(theta) * axis
    sin_t = jnp.sin(theta)
    generic_scale = jnp.where(sin_t > 1e-6, theta / jnp.maximum(2.0 * sin_t, 1e-30), 0.5)
    r_generic = generic_scale[..., None] * w

    # Near pi: axis from the largest diagonal of (R + I)/2 = aa^T (at theta=pi
    # exactly, R = 2 aa^T - I); symmetrize first for robustness
    B = 0.25 * (R + jnp.swapaxes(R, -1, -2)) + 0.5 * jnp.broadcast_to(
        jnp.eye(3, dtype=R.dtype), R.shape
    )
    # a_i^2 = (B_ii + 1)/2 relation via R = 2 aa^T - I at theta = pi
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis2 = jnp.maximum((diag + 1.0) * 0.5, 0.0)
    k = jnp.argmax(axis2, axis=-1)
    ax = jnp.sqrt(jnp.maximum(jnp.take_along_axis(axis2, k[..., None], axis=-1)[..., 0], 1e-30))
    rowk = jnp.take_along_axis(B, k[..., None, None].repeat(3, axis=-1), axis=-2)[..., 0, :]
    axis_pi = rowk / jnp.where(ax > 0, ax, 1.0)[..., None]
    # fix column k (diag entry) sign and normalize
    axis_pi = axis_pi / jnp.maximum(jnp.linalg.norm(axis_pi, axis=-1, keepdims=True), 1e-30)
    # sign of axis: resolve with skew part if any, else arbitrary (theta=pi exactly)
    sgn = jnp.where(jnp.sum(axis_pi * w, axis=-1) < 0, -1.0, 1.0)
    r_pi = (theta * sgn)[..., None] * axis_pi

    # (threshold must exceed the sin of the clipped-theta saturation:
    # ~1.4e-5 in f64, ~1.4e-3 with the f32 clip margin)
    near_pi = sin_t <= (3e-3 if _f32 else 1e-4)
    big_angle = theta > 1.0  # only trust the pi-branch for genuinely large angles
    return jnp.where((near_pi & big_angle)[..., None], r_pi, r_generic)


def so3_right_jacobian(r):
    """Right Jacobian J_r of the SO(3) exp map, (..., 3) -> (..., 3, 3).

    J_r(r) = I - (1-cos|r|)/|r|^2 K + (|r|-sin|r|)/|r|^3 K^2, K = hat(r).
    Parity: `math_utils.h:63` (jacobianRighthandSO3)."""
    theta2 = jnp.sum(r * r, axis=-1)
    _, b, c = _sinc_coeffs(theta2)
    K = hat(r)
    KK = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=r.dtype), K.shape)
    return eye - b[..., None, None] * K + c[..., None, None] * KK


def so3_right_jacobian_inv(r):
    """Inverse right Jacobian, (..., 3) -> (..., 3, 3).

    J_r^{-1}(r) = I + K/2 + (1/|r|^2 - (1+cos|r|)/(2|r| sin|r|)) K^2.
    Parity: `math_utils.h:83` (inverseJacobianRighthandSO3)."""
    theta2 = jnp.sum(r * r, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS))
    small = theta2 < _EPS
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / jnp.maximum(theta2, _EPS)
        - (1.0 + jnp.cos(theta)) / jnp.maximum(2.0 * theta * jnp.sin(theta), 1e-30),
    )
    K = hat(r)
    KK = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=r.dtype), K.shape)
    return eye + 0.5 * K + cot_term[..., None, None] * KK


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------

def quat_normalize(q):
    return q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-30)


def quat_to_mat(q):
    """Unit quaternion (..., 4) [w,x,y,z] -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def mat_to_quat(R):
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) [w,x,y,z].

    Branch-free Shepperd's method (selects the numerically best of 4 forms)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, 1e-30))

    # four candidate quaternions, each scaled by 4*component^2
    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)
    mags = jnp.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], axis=-1)
    best = jnp.argmax(mags, axis=-1)
    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # (..., 4, 4)
    q = jnp.take_along_axis(cands, best[..., None, None].repeat(4, axis=-1), axis=-2)[..., 0, :]
    q = q / (2.0 * safe_sqrt(jnp.take_along_axis(mags, best[..., None], axis=-1)))
    # canonical sign: w >= 0
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_slerp(q0, q1, alpha):
    """Spherical interpolation between unit quaternions (batched).

    Used where the reference slerps IMU orientations
    (`radar_graph_slam_nodelet.cpp:431-461`)."""
    dot = jnp.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = jnp.where(dot < 0, -q1, q1)
    dot = jnp.abs(dot)
    dot = jnp.clip(dot, -1.0, 1.0)
    theta = jnp.arccos(dot)
    sin_t = jnp.sin(theta)
    use_lerp = sin_t < 1e-6
    w0 = jnp.where(use_lerp, 1.0 - alpha, jnp.sin((1.0 - alpha) * theta) / jnp.where(use_lerp, 1.0, sin_t))
    w1 = jnp.where(use_lerp, alpha, jnp.sin(alpha * theta) / jnp.where(use_lerp, 1.0, sin_t))
    return quat_normalize(w0 * q0 + w1 * q1)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def se3_matrix(R, t):
    """(R (...,3,3), t (...,3)) -> homogeneous (..., 4, 4)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (4,)
    )[..., None, :]
    return jnp.concatenate([top, bottom], axis=-2)


def se3_inverse(T):
    """Invert (..., 4, 4) homogeneous transforms."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return se3_matrix(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


def se3_apply(T, p):
    """Apply (..., 4, 4) to points (..., N, 3) (or (..., 3))."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    if p.ndim >= 2 and p.shape[-1] == 3 and T.ndim + 1 == p.ndim + 1:
        pass
    return jnp.einsum("...ij,...nj->...ni", R, jnp.atleast_2d(p)) + t[..., None, :]


def se3_exp(xi):
    """se(3) exp: (..., 6) [rot, trans] -> (..., 4, 4).

    Note: the reference's LsqRegistration applies delta as
    (exp(rot), trans) pairs, NOT the full SE(3) exp (see
    `lsq_registration_impl.hpp:115-118`); use `se3_exp_split` for parity."""
    r = xi[..., :3]
    v = xi[..., 3:]
    R = so3_exp(r)
    theta2 = jnp.sum(r * r, axis=-1)
    _, b, c = _sinc_coeffs(theta2)
    K = hat(r)
    KK = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), K.shape)
    V = eye + b[..., None, None] * K + c[..., None, None] * KK
    return se3_matrix(R, jnp.einsum("...ij,...j->...i", V, v))


def se3_exp_split(xi):
    """Rotation-exp + raw translation update used by the reference LM step:
    delta = [exp(d_rot), d_trans] (`lsq_registration_impl.hpp:140-142`)."""
    return se3_matrix(so3_exp(xi[..., :3]), xi[..., 3:])


def se3_log(T):
    """(..., 4, 4) -> (..., 6) [rot, trans] full SE(3) log."""
    r = so3_log(T[..., :3, :3])
    theta2 = jnp.sum(r * r, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS))
    small = theta2 < _EPS
    # V^{-1} = I - K/2 + (1/t^2 - (1+cos)/(2 t sin t)) K^2
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / jnp.maximum(theta2, _EPS)
        - (1.0 + jnp.cos(theta)) / jnp.maximum(2.0 * theta * jnp.sin(theta), 1e-30),
    )
    K = hat(r)
    KK = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), K.shape)
    Vinv = eye - 0.5 * K + cot_term[..., None, None] * KK
    v = jnp.einsum("...ij,...j->...i", Vinv, T[..., :3, 3])
    return jnp.concatenate([r, v], axis=-1)


def rpy_to_mat(roll, pitch, yaw):
    """ZYX euler angles to rotation matrix (parity with ros tf)."""
    cr, sr = jnp.cos(roll), jnp.sin(roll)
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    return jnp.stack(
        [
            jnp.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1),
            jnp.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1),
            jnp.stack([-sp, cp * sr, cp * cr], axis=-1),
        ],
        axis=-2,
    )


def mat_to_ypr(R):
    """Rotation matrix -> (yaw, pitch, roll); parity with `ros_utils.hpp:29` (R2ypr)."""
    yaw = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    pitch = jnp.arcsin(jnp.clip(-R[..., 2, 0], -1.0, 1.0))
    roll = jnp.arctan2(R[..., 2, 1], R[..., 2, 2])
    return yaw, pitch, roll


def rotation_geodesic_angle(Ra, Rb):
    """Angle of Ra^T Rb in radians (batched)."""
    M = jnp.swapaxes(Ra, -1, -2) @ Rb
    tr = M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2]
    return jnp.arccos(jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0))
