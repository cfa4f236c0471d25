"""GP velocity preintegration: LPM (scan-based) + UGPM (GP solve) + facade.

`preintegrate` is the counterpart of the `VelPreintegration` facade
(`preint.h:22-82,1516-1703`): choose LPM or UGPM, and optionally split long
windows into overlapping chunks of `quantum` seconds combined with
`combine_preints` — the reference's own blockwise mechanism (SURVEY.md §5
"long-context"), which maps to a scan over chunked windows.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from .lpm import lpm_preintegrate  # noqa: F401
from .types import PreintMeas, PreintPrior, add_bias_cov, combine_preints  # noqa: F401
from .ugpm import UGPMConfig, ugpm_fit, ugpm_preintegrate, ugpm_query  # noqa: F401


def preintegrate(
    gyr_t,
    gyr,
    vel_t,
    vel,
    start_t,
    query_t,
    gyr_var,
    vel_var,
    method: str = "lpm",
    quantum: float = -1.0,
    overlap_s: float = 0.1,
    grid_n: int = 512,
    ugpm_cfg: UGPMConfig | None = None,
) -> PreintMeas:
    """Facade over the integrators.

    quantum < 0: one window (parity: `opt.quantum < 0`, `preint.h:1532`).
    quantum > 0: chunked integration with overlap, combined sequentially
    (parity: `preint.h:1584-1701`). Host-side chunk loop (chunk count depends
    on the window length); each chunk is a jitted fixed-shape program.
    """
    query_t = jnp.atleast_1d(jnp.asarray(query_t))

    def run(window_gyr_t, window_gyr, window_vel_t, window_vel, t0, q):
        if method == "ugpm":
            cfg = ugpm_cfg or UGPMConfig(
                window_duration=float(jnp.max(q) - t0) + 1e-3
            )
            return ugpm_preintegrate(
                window_gyr_t, window_gyr, window_vel_t, window_vel, t0, q,
                gyr_var, vel_var, cfg,
            )
        return lpm_preintegrate(
            window_gyr_t, window_gyr, window_vel_t, window_vel, t0, q,
            gyr_var, vel_var, grid_n=grid_n,
        )

    if quantum <= 0:
        return run(gyr_t, gyr, vel_t, vel, start_t, query_t)

    # ---- chunked mode (host loop over chunks, fixed-shape kernels inside) --
    q_np = np.asarray(query_t)
    t_end = float(q_np.max())
    t0 = float(start_t)
    n_chunks = max(1, int(math.ceil((t_end - t0) / quantum)))
    gyr_t_np = np.asarray(gyr_t)
    vel_t_np = np.asarray(vel_t)

    results = [None] * q_np.shape[0]
    prev = None
    for c in range(n_chunks):
        c_start = t0 + c * quantum
        c_end = t0 + (c + 1) * quantum if c < n_chunks - 1 else t_end + 1e-9
        sel = (q_np >= c_start - 1e-12) & (q_np < c_end) if c < n_chunks - 1 else (
            q_np >= c_start - 1e-12
        )
        q_chunk = q_np[sel]
        # chunk-local queries + the chunk end point for chaining
        q_all = np.concatenate([q_chunk, [min(c_end, t_end)]])
        pad = overlap_s
        g_sel = (gyr_t_np >= c_start - pad) & (gyr_t_np <= c_end + pad)
        v_sel = (vel_t_np >= c_start - pad) & (vel_t_np <= c_end + pad)
        if g_sel.sum() < 4 or v_sel.sum() < 2:
            g_sel = slice(None)
            v_sel = slice(None)
        meas = run(
            jnp.asarray(gyr_t_np[g_sel]),
            jnp.asarray(np.asarray(gyr)[g_sel]),
            jnp.asarray(vel_t_np[v_sel]),
            jnp.asarray(np.asarray(vel)[v_sel]),
            c_start,
            jnp.asarray(q_all),
        )
        for out_i, qi in zip(np.nonzero(sel)[0], range(q_chunk.shape[0])):
            m = jax.tree.map(lambda x: x[qi], meas)
            results[out_i] = m if prev is None else combine_preints(prev, m)
        chunk_end_meas = jax.tree.map(lambda x: x[-1], meas)
        prev = chunk_end_meas if prev is None else combine_preints(prev, chunk_end_meas)
    return jax.tree.map(lambda *xs: jnp.stack(xs), *results)
