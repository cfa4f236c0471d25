"""Profile the sparse pose-graph solve on the ambient backend: how much of
one LM iteration is normal-equation assembly vs the preconditioned-CG linear
solve, at K=256/1024. Guides the ms-class optimization (VERDICT r3 item 3).
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from gorio_tpu.utils.jax_config import configure_jax  # noqa: E402

configure_jax()

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from scipy.spatial.transform import Rotation

    from gorio_tpu.graph.graph import PoseGraph
    from gorio_tpu.graph.solver import SolveConfig
    from gorio_tpu.graph.sparse import (
        _chain_upper_blocks,
        _damped,
        block_tridiag_factor,
        block_tridiag_solve,
        build_block_normal_equations,
        optimize_graph_sparse,
    )

    print(f"backend: {jax.default_backend()}", file=sys.stderr)
    dtype = jnp.float32

    for K in (256, 1024):
        rng = np.random.default_rng(5)
        Ts = [np.eye(4)]
        for _ in range(K - 1):
            d = np.eye(4)
            d[:3, :3] = Rotation.from_rotvec(rng.normal(scale=0.02, size=3)).as_matrix()
            d[:3, 3] = [1.0, 0.05 * rng.normal(), 0.0]
            Ts.append(Ts[-1] @ d)
        g = PoseGraph(dtype=np.float32)
        for T in Ts:
            # noisy init (realistic: odometry drift)
            N = np.eye(4)
            N[:3, :3] = Rotation.from_rotvec(rng.normal(scale=0.01, size=3)).as_matrix()
            N[:3, 3] = rng.normal(scale=0.05, size=3)
            g.add_pose(T @ N)
        for k in range(1, K):
            g.add_between(k - 1, k, np.linalg.inv(Ts[k - 1]) @ Ts[k], info=np.eye(6) * 100.0)
        g.add_prior(0, Ts[0], info=np.eye(6) * 1e6)
        for _ in range(K // 20):
            i0, j0 = sorted(rng.integers(0, K, size=2))
            if j0 - i0 < 2:
                continue
            g.add_between(int(i0), int(j0), np.linalg.inv(Ts[i0]) @ Ts[j0],
                          info=np.eye(6) * 50.0, robust_delta=1.0)
        poses0, graph = g.freeze(as_numpy=True)
        poses0 = jnp.asarray(poses0, dtype)
        f = graph.between

        build = jax.jit(lambda p: build_block_normal_equations(p, graph))
        out = build(poses0)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(20):
            out = build(poses0)
        jax.block_until_ready(out)
        build_ms = (time.perf_counter() - t0) / 20 * 1e3

        Hdiag, Hoff, b, chi2 = out

        def solve_cg(Hdiag, Hoff, b, iters):
            A = _damped(Hdiag, jnp.asarray(1e-6, dtype))
            C = _chain_upper_blocks(Hoff, f.i, f.j, K, dtype)
            Dinv = block_tridiag_factor(A, C)

            def mv(x):
                y = jnp.einsum("kij,kj->ki", A, x)
                y = y.at[f.i].add(jnp.einsum("eij,ej->ei", Hoff, x[f.j]))
                y = y.at[f.j].add(jnp.einsum("eji,ej->ei", Hoff, x[f.i]))
                return y

            x, _ = jax.scipy.sparse.linalg.cg(
                mv, -b, M=lambda v: block_tridiag_solve(Dinv, C, v), maxiter=iters
            )
            return x

        for iters in (20, 100):
            sj = jax.jit(lambda Hd, Ho, bb: solve_cg(Hd, Ho, bb, iters))
            x = sj(Hdiag, Hoff, b)
            x.block_until_ready()
            t0 = time.perf_counter()
            for _ in range(20):
                x = sj(Hdiag, Hoff, b)
            x.block_until_ready()
            cg_ms = (time.perf_counter() - t0) / 20 * 1e3
            # residual quality
            A = _damped(Hdiag, jnp.asarray(1e-6, dtype))
            C = _chain_upper_blocks(Hoff, f.i, f.j, K, dtype)

            def mv_np(x):
                y = jnp.einsum("kij,kj->ki", A, x)
                y = y.at[f.i].add(jnp.einsum("eij,ej->ei", Hoff, x[f.j]))
                y = y.at[f.j].add(jnp.einsum("eji,ej->ei", Hoff, x[f.i]))
                return y

            r = float(jnp.linalg.norm(mv_np(x) + b) / jnp.linalg.norm(b))
            print(f"K={K}: build {build_ms:.2f} ms | cg({iters}) {cg_ms:.2f} ms "
                  f"rel-residual {r:.2e}", flush=True)

        # block-tridiag factor+solve alone (the preconditioner = exact solve
        # for a pure chain)
        A = _damped(Hdiag, jnp.asarray(1e-6, dtype))
        C = _chain_upper_blocks(Hoff, f.i, f.j, K, dtype)
        fac = jax.jit(lambda A, C: block_tridiag_factor(A, C))
        Dinv = fac(A, C)
        jax.block_until_ready(Dinv)
        t0 = time.perf_counter()
        for _ in range(20):
            Dinv = fac(A, C)
        jax.block_until_ready(Dinv)
        fac_ms = (time.perf_counter() - t0) / 20 * 1e3
        sv = jax.jit(lambda D, C, b: block_tridiag_solve(D, C, b))
        x = sv(Dinv, C, b)
        x.block_until_ready()
        t0 = time.perf_counter()
        for _ in range(20):
            x = sv(Dinv, C, b)
        x.block_until_ready()
        sv_ms = (time.perf_counter() - t0) / 20 * 1e3
        print(f"K={K}: tridiag factor {fac_ms:.2f} ms, tridiag solve {sv_ms:.2f} ms",
              flush=True)

        # full solve for reference
        scfg = SolveConfig(max_iterations=15, cg_iters=100, solver="cg")
        rs = optimize_graph_sparse(poses0, graph, scfg)
        rs.poses.block_until_ready()
        t0 = time.perf_counter()
        rs = optimize_graph_sparse(poses0, graph, scfg)
        rs.poses.block_until_ready()
        full_ms = (time.perf_counter() - t0) * 1e3
        print(f"K={K}: full solve {full_ms:.1f} ms, iters {int(rs.iterations)}, "
              f"chi2 {float(rs.chi2):.3f}", flush=True)


if __name__ == "__main__":
    main()
