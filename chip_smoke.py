#!/usr/bin/env python3
"""End-to-end proof that the radar-inertial SLAM pipeline runs on one NVIDIA GPU.

    python chip_smoke.py                # one card: phases (a)-(e) below
    python chip_smoke.py --four-cards   # four cards: the sharded programs only

Phases, in order, each printing one JSON line:
  (a) device    the JAX devices, versions, XLA_FLAGS, and the card's name and
                power limit from nvidia-smi; anything but a GPU stops the run
  (b) native    builds native/ (the frame reader and kd-tree) from source
  (c) kernels   compares the NN search with the exact host kd-tree at
                N=M in {2048, 4096, 16384} (float32, precision pinned; the
                default precision for information), and prints the compiled
                memory of the fused frontend step and the APDGICP align
  (d) offline   `cli slam` + `cli evaluate` on the circuit; ATE must stay
                within the 2.5 m ceiling of tests/test_accuracy_regression.py
  (e) streamed  `cli stream` at rate 1.0, block mode, loops on, the offline
                run's configuration; every frame must be accounted for (ATE
                is reported, not gated)
Phases (c)-(e) run on the circuit sequence, simulated once after (b).
The last line is {"ok": true, "device": {...}}. Any failure exits non-zero
before that line is printed. One process uses the card throughout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# The circuit of scripts/accuracy_benchmark.py and its CPU-f64 result
# (ACCURACY.json): ~370 frames at the pipeline's 2,048-point capacity.
CIRCUIT_SIM = ["--duration", "75", "--rate", "5", "--seed", "22", "--circuit",
               "--laps", "2", "--dynamic", "2"]
CIRCUIT_SLAM = ["--fused", "--preprocess", "--floor", "--preint", "ugpm",
                "--optimize-every", "15"]
CPU_F64 = {"ate_rmse_m": 0.1233, "rte_m": 0.0161, "n_keyframes": 360, "n_loops": 10}
ATE_CEILING_M = 2.5  # tests/test_accuracy_regression.py
NN_SIZES = (2048, 4096, 16384)
NN_TOL_M2 = 1e-3  # d2 tolerance against the kd-tree; also the index-tie margin


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    """The card's name and power limit, from a child process that stays off
    JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip()


def check_device(n_needed: int = 1) -> dict:
    """Phase (a). Exits non-zero unless JAX's default platform is the GPU with
    at least `n_needed` devices. There is no CPU fallback."""
    import jax
    import jaxlib

    devs = jax.devices()
    info = {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "devices": [str(d) for d in devs],
        "jax": jax.__version__,
        "jaxlib": jaxlib.__version__,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }
    emit("device", **info)
    if info["platform"] != "gpu" or info["count"] < n_needed:
        print(f"chip_smoke: needs {n_needed} GPU device(s), found "
              f"{info['count']} {info['platform']}", file=sys.stderr)
        raise SystemExit(2)
    print(f"nvidia-smi: {nvidia_smi()}", flush=True)
    return info


def phase_native() -> None:
    from gorio_tpu.io.native import build_native

    t0 = time.perf_counter()
    lib = build_native(force=True)
    emit("native", library=str(lib.relative_to(REPO)), build_s=time.perf_counter() - t0)


def _cloud_scene(n: int, seed: int):
    """n reference points over a radar's +-50 m scene (up to 50 m out in the
    plane, -3..12 m in height), queries near them (a scan against the
    previous one), and a validity mask with ~10% holes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rad = 50.0 * np.sqrt(rng.random(n))
    ang = rng.uniform(-np.pi, np.pi, n)
    ref = np.stack([rad * np.cos(ang), rad * np.sin(ang), rng.uniform(-3, 12, n)],
                   axis=1).astype(np.float32)
    query = (ref[rng.permutation(n)] + rng.normal(scale=0.3, size=(n, 3))).astype(np.float32)
    mask = rng.random(n) > 0.1
    return query, ref, mask


def _kdtree_truth(query, ref, mask):
    """Exact (idx, d2, runner-up d2) from the host kd-tree over valid refs."""
    import numpy as np

    from gorio_tpu.io.native import NativeKDTree

    valid = np.flatnonzero(mask)
    idx, d2 = NativeKDTree(ref[valid]).knn(query, 2)
    return valid[idx[:, 0]], d2[:, 0].astype(np.float64), d2[:, 1].astype(np.float64)


def _nn_errors(idx, d2, truth) -> dict:
    import numpy as np

    t_idx, t_d2, t_d2b = truth
    clear = (t_d2b - t_d2) > NN_TOL_M2
    return {
        "d2_max_err_m2": float(np.max(np.abs(np.asarray(d2, np.float64) - t_d2))),
        "idx_mismatch_clear": int(np.sum((np.asarray(idx) != t_idx) & clear)),
    }


def phase_kernels(dataset: Path) -> None:
    import jax
    import jax.numpy as jnp

    from gorio_tpu.registration.knn import _BIG, nn1

    def nn1_default_precision(q, r, m):
        """The expansion at the GPU's default precision (TF32), which
        `configure_jax` overrides everywhere else."""
        bias = jnp.where(m, 0.0, _BIG)

        def blk(qb):
            qr = jnp.matmul(qb, r.T, precision=jax.lax.Precision.DEFAULT)
            d2 = jnp.sum(qb * qb, -1)[:, None] + jnp.sum(r * r, -1)[None] - 2.0 * qr
            d2 = jnp.maximum(d2, 0.0) + bias[None]
            i = jnp.argmin(d2, -1)
            return i, jnp.take_along_axis(d2, i[:, None], -1)[:, 0]

        pad = (-q.shape[0]) % 1024
        qp = jnp.concatenate([q, jnp.zeros((pad, 3), q.dtype)]).reshape(-1, 1024, 3)
        i, d = jax.lax.map(blk, qp)
        return i.reshape(-1)[: q.shape[0]], d.reshape(-1)[: q.shape[0]]

    rows, ok = [], True
    for n in NN_SIZES:
        q_np, r_np, m_np = _cloud_scene(n, seed=n)
        truth = _kdtree_truth(q_np, r_np, m_np)
        q, r, m = jnp.asarray(q_np), jnp.asarray(r_np), jnp.asarray(m_np)
        pinned = _nn_errors(*nn1(q, r, ref_mask=m), truth)
        default = _nn_errors(*jax.jit(nn1_default_precision)(q, r, m), truth)
        ok &= pinned["d2_max_err_m2"] <= NN_TOL_M2 and pinned["idx_mismatch_clear"] == 0
        rows.append({"n": n, "pinned": pinned, "default_precision": default})
    emit("kernels", nn_check=rows, **_compiled_memory(dataset),
         precision="float32, Precision.HIGHEST (utils/jax_config.configure_jax)",
         tolerance_m2=NN_TOL_M2, ok=bool(ok))
    if not ok:
        raise SystemExit("NN search disagrees with the kd-tree beyond tolerance")


def _compiled_memory(dataset: Path) -> dict:
    """`memory_analysis()` of the fused frontend step and of the APDGICP
    align, compiled for the card on a real frame pair of the sequence."""
    import jax.numpy as jnp
    import numpy as np

    from gorio_tpu.io.native import NativePipelineDataset
    from gorio_tpu.pipeline import odometry as odo_mod
    from gorio_tpu.pipeline.preprocessing import PreprocessConfig
    from gorio_tpu.registration.gicp import GICPConfig, _gicp_align_jit

    frames = sorted(dataset.glob("*.grf"))[:2]
    (s0, n0, p0), (s1, n1, p1) = [
        (stamp, count, buf.copy())
        for stamp, count, buf in NativePipelineDataset(frames, capacity=2048)]
    cfg, ppcfg = odo_mod.OdometryConfig(), PreprocessConfig()

    def state(count, dt, idx):
        st = np.zeros(39, np.float32)
        st[:16] = np.eye(4).ravel()
        st[16], st[17], st[19] = count, dt, idx
        st[23:39] = np.eye(4).ravel()
        return jnp.asarray(st)

    kf = odo_mod.fused_ingest(jnp.asarray(p0), state(n0, 0.0, 0), cfg.egovel, None, ppcfg).cloud
    args = (jnp.asarray(p1), state(n1, s1 - s0, 1), kf, cfg, None, ppcfg)
    src = odo_mod.fused_frontend_step(*args).cloud
    step = odo_mod.fused_frontend_step.lower(*args).compile().memory_analysis()
    align = _gicp_align_jit.lower(src, kf, jnp.eye(4, dtype=jnp.float32),
                                  GICPConfig()).compile().memory_analysis()
    return {"memory_frontend_step": _mem_dict(step), "memory_apdgicp_align": _mem_dict(align)}


def _mem_dict(m) -> dict:
    keys = ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: int(getattr(m, k)) for k in keys if m is not None and hasattr(m, k)}


class _CompileClock:
    """Sums XLA backend compile seconds reported by JAX's monitoring."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.seconds += duration


def _evaluate(est: Path, gt: Path) -> dict:
    import numpy as np

    from gorio_tpu.io.tum import ate_rmse, load_tum, rte

    es, ep = load_tum(est)
    gs, gp = load_tum(gt)
    return {"ate_rmse_m": float(ate_rmse(es, ep, gs, gp)),
            "rte_m": float(rte(es, ep, gs, gp)), "n_poses": int(len(np.asarray(es)))}


def phase_offline(dataset: Path, clock: _CompileClock, card: str) -> None:
    from gorio_tpu.cli import main as cli

    est, timing = dataset / "est.tum", dataset / "timing.json"
    c0, t0 = clock.seconds, time.perf_counter()
    cli(["slam", "--dataset", str(dataset), "--output", str(est),
         "--timing-out", str(timing)] + CIRCUIT_SLAM)
    wall = time.perf_counter() - t0
    tj = json.loads(timing.read_text())
    acc = _evaluate(est, dataset / "groundtruth.tum")
    emit("offline", card=card, n_frames=tj["n_frames"], n_keyframes=tj["n_keyframes"],
         n_loops=tj["n_loops"], **acc, cpu_f64=CPU_F64,
         stage_median_ms=tj["stage_median_ms"], compile_s=clock.seconds - c0,
         wall_s=wall, ate_ceiling_m=ATE_CEILING_M)
    if not acc["ate_rmse_m"] <= ATE_CEILING_M:
        raise SystemExit(f"offline ATE {acc['ate_rmse_m']:.3f} m above {ATE_CEILING_M} m")


def phase_streamed(dataset: Path, clock: _CompileClock, card: str) -> None:
    from gorio_tpu.cli import main as cli

    est, rep = dataset / "stream.tum", dataset / "stream.json"
    c0, t0 = clock.seconds, time.perf_counter()
    cli(["stream", "--dataset", str(dataset), "--rate-multiplier", "1.0",
         "--mode", "block", "--optimize-every", "15", "--preprocess", "--floor",
         "--preint", "ugpm", "--report-out", str(rep), "--output", str(est)])
    wall = time.perf_counter() - t0
    r = json.loads(rep.read_text())
    n_files = len(list(dataset.glob("*.grf")))
    accounted = r["n_frames"] == n_files and r["n_processed"] + r["n_dropped"] == r["n_frames"]
    emit("streamed", card=card, n_files=n_files, report=r, accounted=accounted,
         **_evaluate(est, dataset / "groundtruth.tum"), compile_s=clock.seconds - c0,
         wall_s=wall)
    if not accounted:
        raise SystemExit("streamed run lost frames")


def run_one_card() -> dict:
    info = check_device(1)
    from gorio_tpu.utils.jax_config import configure_jax

    configure_jax()
    clock = _CompileClock()
    card = nvidia_smi()
    phase_native()
    with tempfile.TemporaryDirectory(prefix="gorio_smoke_") as tmp:
        from gorio_tpu.cli import main as cli

        dataset = Path(tmp) / "circuit"
        cli(["simulate", "--output", str(dataset)] + CIRCUIT_SIM)
        phase_kernels(dataset)
        phase_offline(dataset, clock, card)
        phase_streamed(dataset, clock, card)
    return info


def run_four_cards() -> dict:
    info = check_device(4)
    from gorio_tpu.utils.jax_config import configure_jax

    configure_jax()
    import __graft_entry__

    t0 = time.perf_counter()
    dev = __graft_entry__.dryrun_multichip(4, reference=True)
    emit("four_cards", mesh="dp=2 x mp=2", card=nvidia_smi(), deviation=dev,
         tolerance=__graft_entry__.REFERENCE_TOL, wall_s=time.perf_counter() - t0)
    return info


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded programs on a (2, 2) mesh of four cards")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    info = run_four_cards() if args.four_cards else run_one_card()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"], "count": info["count"]}}),
        flush=True)


if __name__ == "__main__":
    main()
