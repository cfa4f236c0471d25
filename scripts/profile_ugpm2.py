import sys, time
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from gorio_tpu.utils.jax_config import configure_jax  # noqa: E402

configure_jax()
import numpy as np, jax, jax.numpy as jnp
from gorio_tpu.preintegration import ugpm as U

dtype = jnp.float32
W, G, V = 64, 128, 32
rng = np.random.default_rng(0)
gyr_t = jnp.asarray(np.linspace(0, 1.0, G)[None].repeat(W, 0), dtype)
vel_t = jnp.asarray(np.linspace(0, 1.0, V)[None].repeat(W, 0), dtype)
vel = jnp.asarray(rng.normal(scale=1.0, size=(W, V, 3)), dtype)
starts = jnp.full((W,), 0.2, dtype)
cfg = U.UGPMConfig(window_duration=0.6, lm_iters=10)
fitf = jax.jit(jax.vmap(lambda a,b,c,d,s: U.ugpm_fit(a,b,c,d,s,1e-4,1e-3,cfg)))
batches = [jnp.asarray(rng.normal(scale=0.2, size=(W, G, 3)), dtype) for _ in range(10)]
out = fitf(gyr_t, batches[0], vel_t, vel, starts); out.alpha.block_until_ready()
t0=time.perf_counter()
for b in batches:
    out = fitf(gyr_t, b, vel_t, vel, starts)
out.alpha.block_until_ready()
dt=(time.perf_counter()-t0)/10
print(f"distinct-batch fit: {dt*1000:.2f} ms -> {W/dt:.0f} windows/s")
t0=time.perf_counter()
for _ in range(10):
    out = fitf(gyr_t, batches[0], vel_t, vel, starts)
out.alpha.block_until_ready()
dt=(time.perf_counter()-t0)/10
print(f"same-batch fit:     {dt*1000:.2f} ms -> {W/dt:.0f} windows/s")
