"""Edge information matrices from registration fitness.

Counterpart of `InformationMatrixCalculator`
(`src/radar_graph_slam/information_matrix_calculator.cpp`): fitness = mean
squared NN residual of inliers (one batched 1-NN), then a sigmoid-weighted
interpolation between min/max stddevs.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core.pointcloud import PointCloud
from ..registration.gicp import fitness_score


class InformationConfig(NamedTuple):
    """Defaults mirror the nodelet params (`radar_graph_slam_nodelet.cpp`
    use of information_matrix_calculator + launch defaults)."""

    use_const_inf_matrix: bool = False
    const_stddev_x: float = 0.5
    const_stddev_q: float = 0.1
    var_gain_a: float = 20.0
    min_stddev_x: float = 0.1
    max_stddev_x: float = 5.0
    min_stddev_q: float = 0.05
    max_stddev_q: float = 0.2
    fitness_score_thresh: float = 2.5
    fitness_max_range: float = 1.0  # `calc_fitness_score` default max_range^2


def _weight(a, max_x, min_y, max_y, x):
    """Parity: `information_matrix_calculator.cpp:29-41` (sigmoid ramp)."""
    y = (1.0 - jnp.exp(-a * x)) / (1.0 - jnp.exp(-a * max_x))
    return min_y + (max_y - min_y) * y


def calc_information_matrix(
    source: PointCloud, target: PointCloud, T, cfg: InformationConfig = InformationConfig()
):
    """6x6 information with [rot, trans] ordering (our residual convention);
    parity with `calc_information_matrix` (`:43-53`)."""
    dtype = T.dtype
    if cfg.use_const_inf_matrix:
        inf = jnp.zeros((6, 6), dtype)
        inf = inf.at[:3, :3].set(jnp.eye(3, dtype=dtype) / cfg.const_stddev_q**2)
        inf = inf.at[3:, 3:].set(jnp.eye(3, dtype=dtype) / cfg.const_stddev_x**2)
        return inf, jnp.asarray(0.0, dtype)
    fitness, _ = fitness_score(source, target, T, max_range=cfg.fitness_max_range)
    x = jnp.minimum(fitness, cfg.fitness_score_thresh)
    min_var_x = cfg.min_stddev_x**2
    max_var_x = cfg.max_stddev_x**2
    min_var_q = cfg.min_stddev_q**2
    max_var_q = cfg.max_stddev_q**2
    w_x = _weight(cfg.var_gain_a, cfg.fitness_score_thresh, min_var_x, max_var_x, x)
    w_q = _weight(cfg.var_gain_a, cfg.fitness_score_thresh, min_var_q, max_var_q, x)
    inf = jnp.zeros((6, 6), dtype)
    inf = inf.at[:3, :3].set(jnp.eye(3, dtype=dtype) / w_q)
    inf = inf.at[3:, 3:].set(jnp.eye(3, dtype=dtype) / w_x)
    return inf, fitness
