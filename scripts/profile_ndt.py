"""Profile NDT align components on the default device, each chained in one
jitted fori_loop so per-call dispatch amortizes (bench.py's protocol). Run
alone: one JAX process per card.

Components timed at the bench.py operating point (reference pair, 0.1 m
downsample, DIRECT7):
  - full align (the headline)
  - correspondence gather pass
  - one derivatives (g/H) evaluation on frozen correspondences
  - one line-search candidate sweep (11 candidates, strided points)
  - one full-objective score on frozen correspondences
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from gorio_tpu.utils.jax_config import configure_jax  # noqa: E402

configure_jax()

import numpy as np
import jax
import jax.numpy as jnp

from bench import REF_PCDS, downsample_np, load_pcd, synth_pair
from gorio_tpu.core.pointcloud import make_cloud
from gorio_tpu.registration import ndt as M
from gorio_tpu.registration.ndt import (
    NDTConfig,
    build_voxel_map,
    ndt_align_with_map,
)


def chain_ms(make_step, x0, n_inner=10, reps=3):
    @jax.jit
    def run(x):
        return jax.lax.fori_loop(0, n_inner, lambda i, v: make_step(v), x)

    out = run(x0)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = run(x0)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / (reps * n_inner) * 1000.0


def main():
    import os

    dtype = jnp.float32
    if all(os.path.exists(p) for p in REF_PCDS):
        tgt_xyz, _i = load_pcd(REF_PCDS[0])
        src_xyz, _i = load_pcd(REF_PCDS[1])
    else:
        (tgt_xyz, _), (src_xyz, _) = synth_pair()
    tgt_d = downsample_np(tgt_xyz)
    src_d = downsample_np(src_xyz)
    cap = 1 << int(np.ceil(np.log2(max(len(tgt_d), len(src_d)))))
    print(f"sizes: tgt={len(tgt_d)} src={len(src_d)} cap={cap}", file=sys.stderr)
    target = make_cloud(jnp.asarray(tgt_d, dtype), capacity=cap)
    source = make_cloud(jnp.asarray(src_d, dtype), capacity=cap)
    cfg = NDTConfig(resolution=1.0, neighborhood="direct7", voxel_capacity=32768)
    vm = build_voxel_map(target, cfg)
    jax.block_until_ready(vm.keys)
    T0 = jnp.eye(4, dtype=dtype)

    r = ndt_align_with_map(source, vm, T0, cfg)
    jax.block_until_ready(r.T)
    print(f"align: iters={int(r.iterations)} score={float(r.error):.1f}")

    def full(T):
        return ndt_align_with_map(source, vm, T0 * (1.0 + 0.0 * T[0, 0]), cfg).T

    print(f"{'full align':<28}{chain_ms(full, T0, n_inner=10):10.3f} ms")

    def gather(T):
        f, mu, c6 = M._gather_correspondences(source, vm, T, cfg)
        # fold into a (4,4) carry so the loop has a real dependency
        s = jnp.sum(mu[:2, :2, 0]) * 0.0
        return T + s

    print(f"{'gather pass':<28}{chain_ms(gather, T0, n_inner=20):10.3f} ms")

    found, mu, c6 = jax.jit(
        lambda: M._gather_correspondences(source, vm, T0, cfg)
    )()
    jax.block_until_ready(found)
    d1, d2 = M._gauss_coeffs(cfg, dtype)

    # one full-objective score on frozen correspondences
    def fscore(T):
        s = M._score_cached(source, found, mu, c6, d1, d2, T)
        return T + 0.0 * s

    print(f"{'frozen full score':<28}{chain_ms(fscore, T0, n_inner=20):10.3f} ms")

    # line-search sweep: 11 candidates on strided quarter
    ls_stride = 4
    src_ls = jax.tree.map(lambda x: x[::ls_stride], source)
    found_ls = found[::ls_stride]
    mu_ls = mu[::ls_stride]
    c6_ls = tuple(c[::ls_stride] for c in c6)
    from gorio_tpu.core import lie

    cand0 = jnp.linspace(0.001, 0.01, 11)[:, None] * jnp.ones((11, 6), dtype)

    def sweep(T):
        scores = jax.vmap(
            lambda dd: M._score_cached(
                src_ls, found_ls, mu_ls, c6_ls, d1, d2, lie.se3_exp_split(dd) @ T
            )
        )(cand0 * (1.0 + 0.0 * T[0, 0]))
        return T + 0.0 * jnp.min(scores)

    print(f"{'line-search sweep (11)':<28}{chain_ms(sweep, T0, n_inner=20):10.3f} ms")

    # derivatives: grab the inner function via a tiny align on 1 iteration?
    # Not exposed; time the component-form reduction inline instead.
    def deriv(T):
        moved = source.xyz @ T[:3, :3].T + T[:3, 3]
        md2, _, (q0, q1, q2) = M._md2_comp(moved, mu, c6)
        e = jnp.exp(-0.5 * d2 * md2)
        coef = jnp.where(found, -d2 * d1 * e, 0.0)
        m0, m1, m2 = moved[:, None, 0], moved[:, None, 1], moved[:, None, 2]
        xx, yy, zz, xy, xz, yz = c6
        u0 = m1 * q2 - m2 * q1
        u1 = m2 * q0 - m0 * q2
        u2 = m0 * q1 - m1 * q0
        u = (u0, u1, u2, q0, q1, q2)
        cols = jnp.stack(
            [u0, u1, u2, q0, q1, q2]
            + [u[i] * u[j] for i in range(6) for j in range(i, 6)],
            axis=0,
        )
        s = jax.lax.dot_general(
            cols.reshape(cols.shape[0], -1), coef.reshape(-1),
            (((1,), (0,)), ((), ())),
        )
        return T + 0.0 * s[0]

    print(f"{'deriv reduction (27 cols)':<28}{chain_ms(deriv, T0, n_inner=20):10.3f} ms")


if __name__ == "__main__":
    main()
