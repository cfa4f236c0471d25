"""Determinism: the jitted pipeline stages are bitwise reproducible.

The reference's concurrency story is hand-rolled mutexes with at least one
latent unlock bug (SURVEY.md §5 "race detection: none"). The JAX
design is pure-functional: same inputs -> same bits. These tests pin that
property for the hot stages, which is what makes replay debugging and
multi-host consistency checks possible at all."""

import jax
import jax.numpy as jnp
import numpy as np

from gorio_tpu.estimators.egovel import estimate_ego_velocity
from gorio_tpu.io.synthetic import make_world, render_radar_scan
from gorio_tpu.registration.gicp import gicp_align
from gorio_tpu.preintegration.lpm import lpm_preintegrate


def _pair():
    world = make_world(seed=50, n_landmarks=4000)
    a = render_radar_scan(world, np.eye(3), np.zeros(3), np.array([1.0, 0, 0]), capacity=1024, seed=1)
    b = render_radar_scan(world, np.eye(3), np.array([0.3, 0.1, 0.0]), np.array([1.0, 0, 0]), capacity=1024, seed=2)
    return a, b


def test_registration_bitwise_deterministic():
    a, b = _pair()
    r1 = gicp_align(a, b)
    r2 = gicp_align(a, b)
    assert np.array_equal(np.asarray(r1.T), np.asarray(r2.T))
    assert float(r1.error) == float(r2.error)


def test_egovel_bitwise_deterministic():
    a, _ = _pair()
    k = jax.random.PRNGKey(42)
    r1 = estimate_ego_velocity(a, key=k)
    r2 = estimate_ego_velocity(a, key=k)
    assert np.array_equal(np.asarray(r1.v), np.asarray(r2.v))
    assert np.array_equal(np.asarray(r1.inlier_mask), np.asarray(r2.inlier_mask))


def test_preintegration_bitwise_deterministic():
    rng = np.random.default_rng(0)
    gyr_t = jnp.asarray(np.linspace(0, 1, 100))
    gyr = jnp.asarray(rng.normal(scale=0.1, size=(100, 3)))
    vel_t = jnp.asarray(np.linspace(0, 1, 20))
    vel = jnp.asarray(rng.normal(size=(20, 3)))
    m1 = lpm_preintegrate(gyr_t, gyr, vel_t, vel, 0.1, jnp.asarray([0.9]), 1e-4, 1e-3, grid_n=128)
    m2 = lpm_preintegrate(gyr_t, gyr, vel_t, vel, 0.1, jnp.asarray([0.9]), 1e-4, 1e-3, grid_n=128)
    for x1, x2 in zip(jax.tree.leaves(m1), jax.tree.leaves(m2)):
        assert np.array_equal(np.asarray(x1), np.asarray(x2))
