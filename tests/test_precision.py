"""Matmul precision where results decide something, and the run-time
plumbing around the device: the compile cache, the chip smoke test's device
check, and the multi-device dry run against its single-device references.

On the GPU a float32 matmul may run in TF32 (about 3 decimal digits) unless a
precision is asked for. Every entry point, this suite included (conftest.py),
runs under `utils/jax_config.configure_jax`, which sets HIGHEST as the
process-wide default. The CPU computes float32 products exactly, so these
tests check two things the CPU can see: that the float32 searches are
accurate at radar ranges, and that the lowered programs of the main path
carry HIGHEST on every contraction (dropping the setting fails here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gorio_tpu.core.pointcloud import random_cloud
from gorio_tpu.estimators.egovel import estimate_ego_velocity
from gorio_tpu.graph.graph import PoseGraph
from gorio_tpu.graph.solver import optimize_graph
from gorio_tpu.io.synthetic import sample_imu, simulate_trajectory
from gorio_tpu.loopclosure.scancontext import ScanContextDB, detect_loop, sc_distance
from gorio_tpu.pipeline.odometry import OdometryConfig, fused_frontend_step
from gorio_tpu.pipeline.preprocessing import PreprocessConfig
from gorio_tpu.preintegration.ugpm import UGPMConfig, ugpm_preintegrate
from gorio_tpu.registration.gicp import GICPConfig, _gicp_align_jit
from gorio_tpu.registration.knn import knn, nn1, radius_count, rbf_covariances
from gorio_tpu.registration.lsq import lm_optimize

# float32 |q|^2 + |r|^2 - 2 q.r around 50 m: a few ulps of ~2500 m^2. A TF32
# product would be off by ~1 m^2.
D2_TOL = 2e-3


def _offset_points(seed, n=400, m=600):
    """Points ~50 m from the origin, where the distance expansion cancels."""
    rng = np.random.default_rng(seed)
    centre = np.array([48.0, -15.0, 3.0])
    ref = (centre + rng.uniform(-6, 6, size=(m, 3))).astype(np.float32)
    query = (ref[rng.integers(0, m, n)] + rng.normal(scale=0.4, size=(n, 3))).astype(np.float32)
    mask = rng.random(m) > 0.15
    d2 = ((query[:, None].astype(np.float64) - ref[None].astype(np.float64)) ** 2).sum(-1)
    return query, ref, mask, np.where(mask[None], d2, np.inf)


def test_nn1_f32_matches_bruteforce_at_50m():
    q, r, mask, d2 = _offset_points(0)
    idx, got = nn1(jnp.asarray(q), jnp.asarray(r), ref_mask=jnp.asarray(mask))
    order = np.argsort(d2, axis=1)
    rows = np.arange(len(q))
    best, second = d2[rows, order[:, 0]], d2[rows, order[:, 1]]
    assert got.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(got), best, atol=D2_TOL, rtol=0)
    clear = second - best > D2_TOL
    np.testing.assert_array_equal(np.asarray(idx)[clear], order[clear, 0])


def test_knn_f32_matches_bruteforce_at_50m():
    q, r, mask, d2 = _offset_points(1)
    k = 5
    idx, got = knn(jnp.asarray(q), jnp.asarray(r), k, ref_mask=jnp.asarray(mask))
    want = np.sort(d2, axis=1)[:, :k]
    np.testing.assert_allclose(np.asarray(got), want, atol=D2_TOL, rtol=0)
    picked = np.take_along_axis(d2, np.asarray(idx), axis=1)
    np.testing.assert_allclose(picked, want, atol=2 * D2_TOL, rtol=0)


def test_radius_count_f32_matches_bruteforce_at_50m():
    q, r, mask, d2 = _offset_points(2)
    radius = 1.5
    got = np.asarray(radius_count(jnp.asarray(q), jnp.asarray(r), radius,
                                  ref_mask=jnp.asarray(mask)))
    # points within D2_TOL of the sphere may fall either way in float32
    surely_in = (d2 <= radius**2 - D2_TOL).sum(1)
    maybe_in = (d2 <= radius**2 + D2_TOL).sum(1)
    assert np.all(got >= surely_in) and np.all(got <= maybe_in)


def _dot_precisions(lowered):
    return [line for line in lowered.as_text().splitlines() if "dot_general" in line]


_CLOUD = random_cloud(jax.random.PRNGKey(0), 128, capacity=128, dtype=jnp.float32)
_PTS = jnp.zeros((64, 3), jnp.float32)
_DESC = jnp.zeros((40, 20), jnp.float32)
_EYE4 = jnp.eye(4, dtype=jnp.float32)


def _lower_lm():
    """The LM driver alone (pose update, gain ratio) on a toy quadratic."""

    def linearize(T):
        return jnp.sum(T * T), jnp.eye(6, dtype=T.dtype), T[:3].reshape(-1)[:6], ()

    return jax.jit(lambda T: lm_optimize(linearize, lambda T, aux: jnp.sum(T * T), T)).lower(_EYE4)


def _lower_ugpm():
    imu = sample_imu(simulate_trajectory(seed=0, duration=1.0), gyr_rate=100.0,
                     vel_rate=20.0, gyr_std=0.01, vel_std=0.03, seed=1)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    cfg = UGPMConfig(state_freq=20.0, window_duration=0.2, lm_iters=2, init_grid_n=16)
    return jax.jit(ugpm_preintegrate, static_argnames=("cfg",)).lower(
        f32(imu.gyr_t[:48]), f32(imu.gyr[:48]), f32(imu.vel_t[:10]), f32(imu.vel[:10]),
        0.3, f32([0.5]), imu.gyr_var, imu.vel_var, cfg=cfg)


def _lower_frontend():
    state = jnp.zeros(39, jnp.float32).at[:16].set(_EYE4.ravel()).at[23:].set(_EYE4.ravel())
    return fused_frontend_step.lower(jnp.zeros((128, 5), jnp.float32), state, _CLOUD,
                                     OdometryConfig(), None, PreprocessConfig())


def _lower_graph():
    g = PoseGraph(dtype=np.float32)
    for k in range(4):
        T = np.eye(4)
        T[0, 3] = k
        g.add_pose(T)
    g.add_prior(0, np.eye(4), info=np.eye(6))
    for k in range(3):
        d = np.eye(4)
        d[0, 3] = 1.0
        g.add_between(k, k + 1, d, info=np.eye(6))
    return optimize_graph.lower(*g.freeze())


@pytest.mark.parametrize(
    "name,lower",
    [
        ("nn1", lambda: nn1.lower(_PTS, _PTS)),
        ("knn", lambda: knn.lower(_PTS, _PTS, 4)),
        ("rbf_covariances", lambda: rbf_covariances.lower(_PTS)),
        ("egovel_ransac", lambda: jax.jit(estimate_ego_velocity).lower(_CLOUD)),
        ("sc_distance", lambda: sc_distance.lower(_DESC, _DESC)),
        ("sc_detect_loop", lambda: detect_loop.lower(ScanContextDB.create(16), _DESC)),
        ("gicp_align", lambda: _gicp_align_jit.lower(_CLOUD, _CLOUD, _EYE4, GICPConfig())),
        ("lm_optimize", _lower_lm),
        ("ugpm_preintegrate", _lower_ugpm),
        ("fused_frontend_step", _lower_frontend),
        ("optimize_graph", _lower_graph),
    ],
)
def test_decision_contractions_run_at_highest(name, lower):
    dots = _dot_precisions(lower())
    assert dots, f"{name}: no contraction found"
    loose = [d for d in dots if "precision = [HIGHEST, HIGHEST]" not in d]
    assert not loose, f"{name}: contractions without HIGHEST: {loose}"


@pytest.mark.parametrize("env_dir", [None, "/some/where/jax-cache"])
def test_compile_cache_helper(monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and no directory is set in code;
    otherwise the cache is <repo>/.jax_cache. Either way f32 matmuls are
    pinned to full precision."""
    from gorio_tpu.utils import jax_config

    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    updates = {}
    monkeypatch.setattr(jax.config, "update", lambda k, v: updates.__setitem__(k, v))
    used = jax_config.configure_jax()
    repo_cache = str(jax_config.Path(jax_config.__file__).resolve().parents[2] / ".jax_cache")
    assert updates["jax_default_matmul_precision"] == "highest"
    if env_dir is None:
        assert used == repo_cache
        assert updates["jax_compilation_cache_dir"] == repo_cache
    else:
        assert used == env_dir
        assert "jax_compilation_cache_dir" not in updates


def test_chip_smoke_device_check_exits_on_cpu(capsys):
    import chip_smoke

    with pytest.raises(SystemExit) as e:
        chip_smoke.check_device(1)
    assert e.value.code not in (0, None)
    out = capsys.readouterr().out
    assert '"phase": "device"' in out and '"ok": true' not in out


def test_dryrun_multichip_matches_single_device():
    """The four-card path of chip_smoke.py, on four virtual CPU devices."""
    import __graft_entry__

    dev = __graft_entry__.dryrun_multichip(4, reference=True)
    assert set(dev) == set(__graft_entry__.REFERENCE_TOL)
