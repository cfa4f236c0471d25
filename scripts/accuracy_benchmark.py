"""Hard stored accuracy benchmark (VERDICT r1 item 2).

Two deterministic synthetic sequences exercise the FULL stack — fused
single-dispatch frontend with the complete preprocessing chain, UGPM GP
preintegration, ground/floor constraint, loop closure, GPS with dropouts +
outliers, zero-velocity stops, and Doppler-inconsistent dynamic objects:

  straight — 40 s, 5 Hz, 2 zero-velocity dwells, 4 moving objects, GPS
             (2 Hz, 0.5 m noise, a dropout window, 2% outliers), no loops
  circuit  — 60 s closed loop, 2 moving objects, loop closure enabled,
             no GPS (drift must be closed by the loop factors)

This is the repo's substitute for the reference's dataset-replay validation
(`/root/reference/4DRadarSLAM/launch/rosbag_play_ntu.launch:10-22` +
`radar_graph_slam_nodelet.cpp:1329-1351` trajectory comparison): stored
ATE RMSE / RTE / per-stage medians live in ACCURACY.json at the repo root;
tests/test_accuracy_regression.py re-runs a sequence and asserts the stored
bound. Regenerate after intended accuracy changes with:

    JAX_PLATFORMS=cpu python scripts/accuracy_benchmark.py --update
"""

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# Pin the SAME numerics the test suite runs under (conftest.py: CPU + x64):
# stored numbers and regression re-runs must share one configuration.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from gorio_tpu.utils.jax_config import configure_jax  # noqa: E402

configure_jax()
# the pin is silently ineffective if a backend was already initialized —
# stored numbers must share the regression tests' numerics, so abort loudly
assert jax.default_backend() == "cpu", (
    f"benchmark must run on CPU x64 (got {jax.default_backend()}); "
    "a jax backend was initialized before the pin took effect"
)
assert jax.config.jax_enable_x64, "x64 pin did not take effect"

REPO = Path(__file__).resolve().parent.parent
ACCURACY_JSON = REPO / "ACCURACY.json"

SEQUENCES = {
    "straight": {
        "simulate": [
            "--duration", "40", "--rate", "5", "--seed", "21",
            "--stops", "2", "--dynamic", "4", "--gps",
        ],
        # --optimize-every: the reference optimizes on a 2-3 s timer
        # (`radar_graph_slam_nodelet.cpp:750`), not once at the end — loop
        # gates and GPS drift gates see continuously improving estimates
        "slam": ["--fused", "--preprocess", "--floor", "--preint", "ugpm",
                 "--no-loops", "--optimize-every", "15"],
    },
    "circuit": {
        # 2 laps in 75 s: the whole ~75 m second lap revisits the first —
        # loop closure must fire repeatedly (the NTU loop2/loop3 pattern; at
        # the launch-parity 10 m loop interval this admits ~6-7 loops), and
        # the ~75 m lap stays above the 50 m accum_distance gate
        "simulate": [
            "--duration", "75", "--rate", "5", "--seed", "22", "--circuit",
            "--laps", "2", "--dynamic", "2",
        ],
        "slam": ["--fused", "--preprocess", "--floor", "--preint", "ugpm",
                 "--optimize-every", "15"],
    },
    # HELD-OUT sequence (VERDICT r4 weak #6): a geometry family NO detector
    # threshold was ever tuned on — 2.5 figure-8s (opposite-yaw lobes;
    # crossing-point revisits with heading differences and both-lobe
    # approaches the circuits never produce; ~300 m path) plus a gentle
    # elevation profile. Used only for validation of the loop stack, never
    # for gate screening (the replay/sweep tooling operates on circuit2/3).
    "figure8": {
        "simulate": [
            "--duration", "150", "--rate", "5", "--seed", "77", "--figure8",
            "--laps", "2.5", "--elev-amp", "0.12", "--dynamic", "2",
        ],
        "slam": ["--fused", "--preprocess", "--floor", "--preint", "ugpm",
                 "--optimize-every", "15"],
    },
}


def run_sequence(name: str, workdir: str | None = None) -> dict:
    from gorio_tpu.cli import main
    from gorio_tpu.io.tum import ate_rmse, load_tum, rte

    spec = SEQUENCES[name]
    base = Path(workdir or tempfile.mkdtemp(prefix=f"gorio_acc_{name}_"))
    ds = base / name
    main(["simulate", "--output", str(ds)] + spec["simulate"])
    est = ds / "est.tum"
    timing = ds / "timing.json"
    main(
        [
            "slam",
            "--dataset", str(ds),
            "--output", str(est),
            "--timing-out", str(timing),
        ]
        + spec["slam"]
    )
    es, ep = load_tum(est)
    gs, gp = load_tum(ds / "groundtruth.tum")
    with open(timing) as fh:
        tinfo = json.load(fh)
    return {
        "ate_rmse_m": round(float(ate_rmse(es, ep, gs, gp)), 4),
        "rte_m": round(float(rte(es, ep, gs, gp)), 4),
        "n_keyframes": tinfo["n_keyframes"],
        "n_loops": tinfo["n_loops"],
        "stage_median_ms": {k: round(v, 2) for k, v in tinfo["stage_median_ms"].items()},
    }


def main_cli():
    ap = argparse.ArgumentParser()
    ap.add_argument("--update", action="store_true", help="rewrite ACCURACY.json")
    ap.add_argument("--seq", choices=list(SEQUENCES), default=None)
    args = ap.parse_args()

    names = [args.seq] if args.seq else list(SEQUENCES)
    results = {}
    for name in names:
        print(f"== {name} ==", file=sys.stderr)
        results[name] = run_sequence(name)
        print(json.dumps({name: results[name]}), flush=True)

    if args.update:
        stored = {}
        if ACCURACY_JSON.exists():
            stored = json.loads(ACCURACY_JSON.read_text())
        stored.update(results)
        ACCURACY_JSON.write_text(json.dumps(stored, indent=2) + "\n")
        print(f"wrote {ACCURACY_JSON}", file=sys.stderr)
    elif ACCURACY_JSON.exists():
        stored = json.loads(ACCURACY_JSON.read_text())
        ok = True
        for name in names:
            bound = stored[name]["ate_rmse_m"] * 1.5 + 0.02
            got = results[name]["ate_rmse_m"]
            status = "OK" if got <= bound else "REGRESSION"
            if got > bound:
                ok = False
            print(f"{name}: ate {got} vs stored {stored[name]['ate_rmse_m']} "
                  f"(bound {bound:.4f}) {status}", file=sys.stderr)
        sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main_cli()
