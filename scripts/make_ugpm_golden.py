"""Generate the committed UGPM golden fixture (tests/golden/ugpm_golden.npz).

Stores BOTH the raw input streams (gyro / ego-velocity samples) and the f64
UGPM outputs (delta_R, delta_p, cov, bias/time Jacobians) so the regression
test is insulated from changes to the synthetic generators. Mirrors the role
of the reference's two-scan + relative.txt fixture
(/root/reference/fast_apdgicp/src/test/gicp_test.cpp:40-60) for the
preintegration engine (/root/reference/4DRadarSLAM/include/VelInt/preint.h).

Run from the repo root:
    JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 python scripts/make_ugpm_golden.py
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# pin through the config as well and verify: goldens are CPU float64
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
assert jax.default_backend() == "cpu", jax.default_backend()

import numpy as np
import jax.numpy as jnp

from gorio_tpu.io.synthetic import sample_imu, simulate_trajectory
from gorio_tpu.preintegration.ugpm import UGPMConfig, ugpm_preintegrate


def main():
    traj = simulate_trajectory(seed=42, duration=3.0)
    imu = sample_imu(
        traj, gyr_rate=200.0, vel_rate=30.0, gyr_std=0.01, vel_std=0.03, seed=43
    )
    t0, t1 = 1.0, 1.5
    pad = 0.3
    sel_g = (imu.gyr_t >= t0 - pad) & (imu.gyr_t <= t1 + pad)
    sel_v = (imu.vel_t >= t0 - pad) & (imu.vel_t <= t1 + pad)
    gyr_t = np.asarray(imu.gyr_t[sel_g], dtype=np.float64)
    gyr = np.asarray(imu.gyr[sel_g], dtype=np.float64)
    vel_t = np.asarray(imu.vel_t[sel_v], dtype=np.float64)
    vel = np.asarray(imu.vel[sel_v], dtype=np.float64)
    queries = np.array([1.1, 1.25, 1.5], dtype=np.float64)
    cfg = UGPMConfig(window_duration=0.5)

    meas = ugpm_preintegrate(
        jnp.asarray(gyr_t),
        jnp.asarray(gyr),
        jnp.asarray(vel_t),
        jnp.asarray(vel),
        t0,
        jnp.asarray(queries),
        imu.gyr_var,
        imu.vel_var,
        cfg,
    )

    # ground-truth deltas for the documentation fields (not asserted tightly —
    # they carry the model error, the golden outputs carry the numerics)
    R0, p0 = traj.interp_pose(np.array([t0]))
    Rq, pq = traj.interp_pose(queries)
    dR_true = np.einsum("ij,qjk->qik", R0[0].T, Rq)
    dp_true = np.einsum("ij,qj->qi", R0[0].T, pq - p0[0])

    out = dict(
        gyr_t=gyr_t,
        gyr=gyr,
        vel_t=vel_t,
        vel=vel,
        t0=np.float64(t0),
        queries=queries,
        gyr_var=np.float64(imu.gyr_var),
        vel_var=np.float64(imu.vel_var),
        window_duration=np.float64(cfg.window_duration),
        delta_R=np.asarray(meas.delta_R, dtype=np.float64),
        delta_p=np.asarray(meas.delta_p, dtype=np.float64),
        dt=np.asarray(meas.dt, dtype=np.float64),
        cov=np.asarray(meas.cov, dtype=np.float64),
        d_delta_R_d_bw=np.asarray(meas.d_delta_R_d_bw, dtype=np.float64),
        d_delta_R_d_t=np.asarray(meas.d_delta_R_d_t, dtype=np.float64),
        d_delta_p_d_bw=np.asarray(meas.d_delta_p_d_bw, dtype=np.float64),
        d_delta_p_d_bv=np.asarray(meas.d_delta_p_d_bv, dtype=np.float64),
        d_delta_p_d_t=np.asarray(meas.d_delta_p_d_t, dtype=np.float64),
        delta_R_true=dR_true,
        delta_p_true=dp_true,
    )
    dest = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests",
        "golden",
        "ugpm_golden.npz",
    )
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    np.savez_compressed(dest, **out)
    print(f"wrote {dest}")
    print("delta_p[−1] =", out["delta_p"][-1], " true =", dp_true[-1])
    print("cov diag[−1] =", np.diag(out["cov"][-1]))


if __name__ == "__main__":
    main()
