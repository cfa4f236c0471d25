"""Two-process `jax.distributed` demo: cross-host collectives on CPU.

This driver launches TWO OS processes, each a JAX "host" with its own local
CPU devices, connected through `jax.distributed.initialize` — the bring-up
path (`gorio_tpu.parallel.mesh.initialize_distributed`) a real multi-host
deployment uses, with the collectives on the CPU cross-process backend. It
demonstrates the `jax.distributed` wiring, not the GPU: both workers run with
JAX_PLATFORMS=cpu, so neither opens a card (a second JAX process on one card
would fail for want of memory).

Each process contributes its local shard of an SMC particle population; the
collective resampling inside `sharded_smc_step` then runs psum/all_gather
ACROSS PROCESS BOUNDARIES. The demo asserts the global ESS computed on both
hosts agrees.

Run:  python scripts/demo_multihost.py          (driver; spawns 2 workers)
"""

import os
import subprocess
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])  # repo root
import time

N_PROC = 2
DEVS_PER_PROC = 2
PORT = 9911


def worker(rank: int):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={DEVS_PER_PROC}"
    ).strip()

    import jax

    from gorio_tpu.parallel.mesh import initialize_distributed

    pid, pcount = initialize_distributed(
        coordinator=f"localhost:{PORT}", num_processes=N_PROC, process_id=rank
    )
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from gorio_tpu.inference.smc import sharded_smc_step

    assert pcount == N_PROC, f"expected {N_PROC} processes, got {pcount}"
    devs = jax.devices()  # global device list across processes
    assert len(devs) == N_PROC * DEVS_PER_PROC
    mesh = Mesh(np.asarray(devs), ("dp",))

    PPD, D = 256, 8
    NP = PPD * len(devs)

    def log_target(x):
        return -0.5 * jnp.sum(x * x)

    step = jax.jit(sharded_smc_step(mesh, log_target))

    # global arrays from per-process shards
    rng = np.random.default_rng(0)  # same seed -> same global population
    particles_global = rng.normal(size=(NP, D)).astype(np.float32) * 3.0
    logw_global = np.zeros((NP,), np.float32)

    def put_global(host_np, spec):
        sharding = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(
            host_np.shape, sharding, lambda idx: host_np[idx]
        )

    particles = put_global(particles_global, P("dp"))
    logw = put_global(logw_global, P("dp"))
    key = put_global(np.asarray(jax.random.PRNGKey(0)), P())
    std = put_global(np.asarray(0.2, np.float32), P())

    p_new, lw_new, ess = step(key, particles, logw, std)
    jax.block_until_ready(p_new)
    # ess is replicated; every process must agree on the global value
    ess_local = float(np.asarray(jax.device_get(ess)))
    print(f"[proc {pid}/{pcount}] global ESS = {ess_local:.2f} over {NP} particles",
          flush=True)
    assert 0.0 < ess_local <= NP
    jax.distributed.shutdown()


def driver():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"  # the workers never open a card
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for rank in range(N_PROC):
        procs.append(
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(rank)],
                env=env,
                cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            )
        )
    deadline = time.time() + 300
    codes = [None] * N_PROC
    while time.time() < deadline and any(c is None for c in codes):
        for i, p in enumerate(procs):
            if codes[i] is None:
                codes[i] = p.poll()
        time.sleep(0.5)
    for i, p in enumerate(procs):
        if codes[i] is None:
            p.kill()
            codes[i] = -9
    ok = all(c == 0 for c in codes)
    print(f"multihost demo: exit codes {codes} -> {'OK' if ok else 'FAIL'}")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        worker(int(sys.argv[1]))
    else:
        driver()
