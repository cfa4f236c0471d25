"""Profile ugpm_fit stages on the default device (run alone: one JAX process per card)."""
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
gyr = jnp.asarray(rng.normal(scale=0.2, size=(W, G, 3)), dtype)
vel = jnp.asarray(rng.normal(scale=1.0, size=(W, V, 3)), dtype)
starts = jnp.full((W,), 0.2, dtype)
cfg = U.UGPMConfig(window_duration=0.6, lm_iters=10)
S = cfg.nb_state

def timed(name, f, *a, reps=5):
    out = f(*a); jax.tree.leaves(out)[0].block_until_ready()
    t0=time.perf_counter()
    for _ in range(reps): out = f(*a)
    jax.tree.leaves(out)[0].block_until_ready()
    print(f"{name:<22}{(time.perf_counter()-t0)/reps*1000:9.2f} ms  ({W/( (time.perf_counter()-t0)/reps):.0f} win/s)")
    return out

# full fit
fitf = jax.jit(jax.vmap(lambda a,b,c,d,s: U.ugpm_fit(a,b,c,d,s,1e-4,1e-3,cfg)))
timed("full fit", fitf, gyr_t, gyr, vel_t, vel, starts)
# no correlate
cfg_nc = cfg._replace(correlate=False)
fitnc = jax.jit(jax.vmap(lambda a,b,c,d,s: U.ugpm_fit(a,b,c,d,s,1e-4,1e-3,cfg_nc)))
timed("fit no-correlate", fitnc, gyr_t, gyr, vel_t, vel, starts)
# fewer lm iters
cfg_l3 = cfg._replace(lm_iters=3)
fitl3 = jax.jit(jax.vmap(lambda a,b,c,d,s: U.ugpm_fit(a,b,c,d,s,1e-4,1e-3,cfg_l3)))
timed("fit lm_iters=3", fitl3, gyr_t, gyr, vel_t, vel, starts)
# smaller init grid
cfg_g = cfg._replace(init_grid_n=128)
fitg = jax.jit(jax.vmap(lambda a,b,c,d,s: U.ugpm_fit(a,b,c,d,s,1e-4,1e-3,cfg_g)))
timed("fit init_grid=128", fitg, gyr_t, gyr, vel_t, vel, starts)
