"""Multi-chip sharded variants of the flagship programs.

These are the REAL kernels — not stand-ins — expressed over a device mesh:

1. `sharded_ugpm_windows`  — data-parallel batched UGPM GP preintegration:
   the vmapped `ugpm_preintegrate` with the window axis sharded over the mesh
   (pure dp; XLA keeps every window's two-stage GP solve on its own device).
   Pod-scale counterpart of `preint.h:1584-1701`'s one-window-at-a-time loop.
2. `sharded_gicp_align`    — tensor-parallel APDGICP/GICP: source points
   sharded over the mesh, target replicated; each device runs the real
   correspondence search + Mahalanobis linearization on its slice and the
   normal equations / costs are `psum`'d, so the replicated LM driver
   (`lm_optimize`, the `LsqRegistration` counterpart) sees exactly the
   single-device H/b. Counterpart of the OpenMP reduction in
   `fast_apdgicp_impl.hpp:247-306` at chip scale.
3. `sharded_optimize_graph` — the pose-graph LM solve with the FACTOR axis
   sharded: each device assembles partial normal equations from its factor
   slice (`build_normal_equations` on a masked shard), H/b/chi2 are all-
   reduced, and the dense solve runs replicated. Counterpart of
   `graph_slam.cpp:353`'s sparse solve, distributed by keyframe-range/factor.

Numerical equality with the single-device programs is asserted by
tests/test_sharded_programs.py (up to reduction reordering, f64).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.pointcloud import PointCloud
from ..graph.factors import GraphData
from ..graph.solver import (
    SolveConfig,
    SolveResult,
    _flatten_H,
    _solve_cg,
    _solve_dense,
    build_normal_equations,
    graph_chi2,
    retract,
)
from ..registration.gicp import (
    GICPConfig,
    GICPProblem,
    _correspondences,
    _error_terms,
    _gicp_normal_equations,
    prepare_gicp,
)
from ..registration.lsq import LMResult, lm_optimize
from ..preintegration.ugpm import UGPMConfig, ugpm_preintegrate


# ---------------------------------------------------------------------------
# 1) data-parallel batched UGPM over windows
# ---------------------------------------------------------------------------


def sharded_ugpm_windows(mesh: Mesh, axis: str = "dp"):
    """Returns a jitted fn(gyr_t (W,G), gyr (W,G,3), vel_t (W,V), vel (W,V,3),
    starts (W,), queries (W,Q), gyr_var, vel_var, cfg) with the window axis W
    sharded over `axis`. W must be a multiple of the mesh axis size."""

    dp = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())

    @partial(jax.jit, static_argnames=("cfg",), out_shardings=dp)
    def run(gyr_t, gyr, vel_t, vel, starts, queries, gyr_var, vel_var, cfg: UGPMConfig):
        return jax.vmap(
            lambda a, b, c, d, s, q: ugpm_preintegrate(
                a, b, c, d, s, q, gyr_var, vel_var, cfg
            )
        )(gyr_t, gyr, vel_t, vel, starts, queries)

    def call(gyr_t, gyr, vel_t, vel, starts, queries, gyr_var, vel_var, cfg):
        args = [
            jax.device_put(jnp.asarray(x), dp)
            for x in (gyr_t, gyr, vel_t, vel, starts, queries)
        ]
        return run(*args, float(gyr_var), float(vel_var), cfg)

    return call


# ---------------------------------------------------------------------------
# 2) tensor-parallel GICP/APDGICP (points sharded, psum'd normal equations)
# ---------------------------------------------------------------------------


def _make_sharded_gicp_callbacks(prob: GICPProblem, cfg: GICPConfig, axis: str, n_total: int):
    """The real `make_gicp_callbacks` linearization on a LOCAL source shard,
    with cost/H/b all-reduced over `axis` so the LM driver sees global
    quantities (replicated across devices)."""

    def linearize(T):
        idx, ok, mah, w, _ = _correspondences(prob, T, cfg, n_total=n_total)
        moved, err, m_err, cost = _error_terms(prob, T, idx, ok, mah, w)
        H, b = _gicp_normal_equations(moved, mah, m_err, ok)
        cost = jax.lax.psum(cost, axis)
        H = jax.lax.psum(H, axis)
        b = jax.lax.psum(b, axis)
        return cost, H, b, (idx, ok, mah, w)

    def compute_error(T, aux):
        idx, ok, mah, w = aux
        _, _, _, cost = _error_terms(prob, T, idx, ok, mah, w)
        return jax.lax.psum(cost, axis)

    return linearize, compute_error


def sharded_gicp_align(mesh: Mesh, cfg: GICPConfig, axis: str = "mp"):
    """Returns a jitted fn(source: PointCloud, target: PointCloud, init_T) ->
    LMResult running the REAL APDGICP/GICP alignment with the source point
    axis sharded over `axis` and the target replicated. The covariance
    preparation runs under pjit (GSPMD partitions the kNN over the same
    sharding); the LM loop runs inside `shard_map` with psum'd normal
    equations. Source capacity must be a multiple of the axis size."""
    n_axis = mesh.shape[axis]
    pt_spec = P(axis)
    repl = P()

    prob_specs = GICPProblem(
        src_xyz=pt_spec,
        src_mask=pt_spec,
        src_cov=pt_spec,
        src_geo_w=pt_spec,
        src_cluster=pt_spec,
        tgt_xyz=repl,
        tgt_mask=repl,
        tgt_cov=repl,
        tgt_cluster=repl,
    )
    out_specs = LMResult(T=repl, H=repl, error=repl, converged=repl, iterations=repl)

    @jax.jit
    def run(source: PointCloud, target: PointCloud, init_T):
        n_total = source.xyz.shape[0]
        prob = prepare_gicp(source, target, cfg)

        def lm_shard(prob_local: GICPProblem, T0):
            linearize, compute_error = _make_sharded_gicp_callbacks(
                prob_local, cfg, axis, n_total
            )
            return lm_optimize(linearize, compute_error, T0, cfg.lm)

        return shard_map(
            lm_shard,
            mesh=mesh,
            in_specs=(prob_specs, repl),
            out_specs=out_specs,
            check_vma=False,
        )(prob, init_T)

    def call(source: PointCloud, target: PointCloud, init_T=None):
        if source.xyz.shape[0] % n_axis:
            raise ValueError(
                f"source capacity {source.xyz.shape[0]} not divisible by mesh axis {n_axis}"
            )
        if init_T is None:
            init_T = jnp.eye(4, dtype=source.xyz.dtype)
        src = jax.tree.map(lambda x: jax.device_put(x, NamedSharding(mesh, pt_spec)), source)
        tgt = jax.tree.map(lambda x: jax.device_put(x, NamedSharding(mesh, repl)), target)
        return run(src, tgt, init_T)

    return call


# ---------------------------------------------------------------------------
# 3) pose-graph LM with the factor axis sharded + all-reduced H/b
# ---------------------------------------------------------------------------


def _pad_family(fam, m: int):
    """Pad every per-factor array of a factor family to a multiple of m.
    Padding rows: mask=0 (contributes nothing), indices 0, robust_delta=inf."""
    f = fam.mask.shape[0]
    target = ((f + m - 1) // m) * m
    pad = target - f
    if pad == 0:
        return fam
    out = {}
    for name, arr in fam._asdict().items():
        width = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
        if name == "robust_delta":
            out[name] = jnp.pad(arr, width, constant_values=jnp.inf)
        else:
            out[name] = jnp.pad(arr, width)
    return type(fam)(**out)


def pad_graph_for(graph: GraphData, n_devices: int) -> GraphData:
    """Pad every factor family's factor axis to a multiple of n_devices so
    the graph shards evenly."""
    return GraphData(*(_pad_family(f, n_devices) for f in graph))


def sharded_optimize_graph(mesh: Mesh, cfg: SolveConfig = SolveConfig(), axis: str = "dp"):
    """Returns fn(poses0 (K,4,4), graph: GraphData) -> SolveResult.

    Every factor family's factor axis is sharded over `axis`; each device
    assembles the normal equations of its factor slice with the real
    `build_normal_equations`, H/b/chi2 are `psum`'d, and the LM loop +
    dense/CG solve run replicated (identical on every device). This is the
    SNIPPETS.md §[1] all-reduce-of-normal-equations pattern on the real
    factor types."""
    n_axis = mesh.shape[axis]
    fam_spec = P(axis)
    repl = P()

    def graph_specs(graph: GraphData) -> GraphData:
        return GraphData(
            *(type(f)(*(fam_spec for _ in f)) for f in graph)
        )

    @jax.jit
    def run(poses0, graph: GraphData):
        K = poses0.shape[0]
        dtype = poses0.dtype
        free = jnp.ones((K, 6), dtype)
        if cfg.fix_first:
            free = free.at[0].set(0.0)
        free_flat = free.reshape(-1)

        def solve_shard(poses0_l, graph_l: GraphData):
            def lin(poses):
                Hb, bb, chi2 = build_normal_equations(poses, graph_l)
                Hb = jax.lax.psum(Hb, axis)
                bb = jax.lax.psum(bb, axis)
                chi2 = jax.lax.psum(chi2, axis)
                H = _flatten_H(Hb)
                b = bb.reshape(-1)
                H = H * free_flat[:, None] * free_flat[None, :]
                H = H + jnp.diag(1.0 - free_flat)
                b = b * free_flat
                return H, b, chi2

            def chi2_of(poses):
                return jax.lax.psum(graph_chi2(poses, graph_l), axis)

            def body(state):
                poses, lam, chi2_prev, it, done, H_last = state
                H, b, chi2 = lin(poses)
                if cfg.solver == "cg":
                    delta = _solve_cg(H, b, lam, dtype, cfg.cg_iters)
                else:
                    delta = _solve_dense(H, b, lam, dtype)
                delta = delta * free_flat
                poses_new = jax.vmap(retract)(poses, delta.reshape(K, 6))
                chi2_new = chi2_of(poses_new)
                accept = chi2_new < chi2
                poses_out = jnp.where(accept, poses_new, poses)
                lam_out = jnp.where(
                    accept, lam / cfg.lm_lambda_factor, lam * cfg.lm_lambda_factor
                )
                rel = jnp.abs(chi2 - chi2_new) / jnp.maximum(chi2, 1e-30)
                done_new = accept & (rel < cfg.rel_tol)
                return poses_out, lam_out, jnp.where(accept, chi2_new, chi2), it + 1, done_new, H

            def cond(state):
                _, _, _, it, done, _ = state
                return (it < cfg.max_iterations) & (~done)

            H0 = jnp.eye(K * 6, dtype=dtype)
            init = (
                poses0_l,
                jnp.asarray(cfg.lm_lambda_init, dtype),
                jnp.asarray(jnp.inf, dtype),
                0,
                False,
                H0,
            )
            poses, lam, chi2, iters, _, H = jax.lax.while_loop(cond, body, init)
            return SolveResult(poses=poses, chi2=chi2, iterations=iters, lm_lambda=lam, H=H)

        return shard_map(
            solve_shard,
            mesh=mesh,
            in_specs=(repl, graph_specs(graph)),
            out_specs=SolveResult(
                poses=repl, chi2=repl, iterations=repl, lm_lambda=repl, H=repl
            ),
            check_vma=False,
        )(poses0, graph)

    def call(poses0, graph: GraphData):
        graph = pad_graph_for(
            jax.tree.map(jnp.asarray, graph, is_leaf=lambda x: x is None), n_axis
        )
        graph = jax.tree.map(
            lambda x: jax.device_put(x, NamedSharding(mesh, fam_spec)), graph
        )
        poses0 = jax.device_put(jnp.asarray(poses0), NamedSharding(mesh, repl))
        return run(poses0, graph)

    return call
