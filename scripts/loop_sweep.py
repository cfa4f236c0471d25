"""Gate-policy sweep over recorded loop-replay pickles.

Runs `loop_replay.replay` for a list of LoopConfig override combos against
one or more recordings and prints one JSON line per (recording, combo) with
region recall / precision / gate counts — the screening loop for VERDICT r4
item 1 (raise recall to >=0.6 at precision 1.0). Chosen combos are then
validated with real runs (scripts/recall_benchmark.py).

    JAX_PLATFORMS=cpu python scripts/loop_sweep.py \
        --rec /tmp/rec_c2.pkl [--rec /tmp/rec_c3.pkl] [--combos FILE.json]
"""

import argparse
import json
import os
import pickle
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from gorio_tpu.utils.jax_config import configure_jax  # noqa: E402

configure_jax()

DEFAULT_COMBOS = [
    {},
    {"ellipse_base": 3.0},
    {"ellipse_base": 3.0, "pairwise_nearest": False},
    {"pairwise_nearest": False},
    {"pairwise_nearest": False, "fallback_max_trans": 6.5},
    {"pairwise_nearest": False, "min_loop_interval_dist": 5.0},
    {"pairwise_nearest": False, "fallback_max_trans": 6.5,
     "min_loop_interval_dist": 5.0},
    {"ellipse_base": 3.0, "pairwise_nearest": False,
     "fallback_max_trans": 6.5, "min_loop_interval_dist": 5.0},
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rec", action="append", required=True)
    ap.add_argument("--combos", default=None,
                    help="JSON file with a list of override dicts")
    args = ap.parse_args()
    combos = DEFAULT_COMBOS
    if args.combos:
        combos = json.loads(Path(args.combos).read_text())

    from scripts.loop_replay import classify, replay
    from scripts.recall_benchmark import analyze

    for rec_path in args.rec:
        with open(rec_path, "rb") as fh:
            rec = pickle.load(fh)
        for ov in combos:
            det, loops = replay(rec, ov)
            cls = classify(rec, loops)
            regions = analyze(
                rec["kf_stamps"],
                [(int(l.key_new), int(l.key_old), float(l.fitness)) for l in loops],
                rec["gt_stamps"], rec["gt_pos"],
            )
            print(json.dumps({
                "rec": rec_path,
                "overrides": ov,
                "n_loops": len(loops),
                "n_false": sum(1 for c in cls if not c[3]),
                "recall_regions": regions["recall_regions"],
                "n_regions_covered": regions["n_regions_covered"],
                "n_regions": regions["n_regions"],
                "gate_counts": det.gate_counts,
            }), flush=True)


if __name__ == "__main__":
    main()
