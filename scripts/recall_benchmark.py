"""Loop-closure recall/precision characterization -> RECALL.json.

VERDICT r3 item 5: the circuit accuracy run verifies 3 loops, but nothing
records how many loops a ground-truth-aware analysis *expects*, so recall is
uncharacterized. This script replays the accuracy circuit (plus a harder
3-lap variant), computes ground-truth revisit opportunities, and stores
recall / precision / per-gate rejection counts.

Definitions
-----------
revisit pair   (i, j): keyframes whose GROUND-TRUTH positions are within
               `revisit_radius` while their traveled distance differs by more
               than the detector's `accum_distance_thresh` (same gate the
               reference uses, `loop_detector.cpp:139-152`).
revisit region maximal run of consecutive new-keyframe indices j that have at
               least one revisit partner, split every
               `min_loop_interval_dist` meters of ground-truth travel — the
               detector accepts at most one loop per interval
               (`last_loop_accum` gate), so regions are the honest unit of
               recall: each region is one *opportunity* the detector could
               have taken.
recall         fraction of regions containing EITHER endpoint (key_new or
               key_old) of a true accepted loop. Both endpoints count
               because a region is a physical stretch of trajectory and one
               loop pins both of its places to each other — and because the
               key_new-only variant (r4's metric, kept as
               `recall_key_new_only`) is structurally capped: on a 2-lap
               circuit the first lap's regions can never host a key_new
               (their partners all come LATER in traveled distance), so its
               ceiling is n_regions_reachable_new / n_regions — measured
               EXACTLY 0.600 on circuit2, i.e. a perfect detector could not
               exceed it. Both numbers plus the ceiling are stored.
false accept   accepted loop whose GT endpoint distance exceeds
               `false_radius` (loops between places that were never actually
               co-located).

Run (CPU-pinned, matching the stored accuracy artifacts):

    JAX_PLATFORMS=cpu python scripts/recall_benchmark.py --update
"""

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from gorio_tpu.utils.jax_config import configure_jax  # noqa: E402

configure_jax()
assert jax.default_backend() == "cpu", jax.default_backend()

import numpy as np  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
RECALL_JSON = REPO / "RECALL.json"

SEQUENCES = {
    # the stored-accuracy circuit (same seed/params as ACCURACY.json)
    "circuit2": {
        "simulate": ["--duration", "75", "--rate", "5", "--seed", "22",
                     "--circuit", "--laps", "2", "--dynamic", "2"],
    },
    # harder: 3 laps, longer run, more accumulated drift before closure
    "circuit3": {
        "simulate": ["--duration", "115", "--rate", "5", "--seed", "23",
                     "--circuit", "--laps", "3", "--dynamic", "2"],
    },
    # HELD-OUT figure-8 (VERDICT r4 weak #6): never used for gate screening —
    # see scripts/accuracy_benchmark.py for the rationale
    "figure8": {
        "simulate": ["--duration", "150", "--rate", "5", "--seed", "77",
                     "--figure8", "--laps", "2.5", "--elev-amp", "0.12",
                     "--dynamic", "2"],
    },
}

SLAM_ARGS = ["--fused", "--preprocess", "--floor", "--preint", "ugpm",
             "--optimize-every", "15"]


def gt_at(stamps, gt_stamps, gt_pos):
    """Ground-truth positions interpolated at the keyframe stamps."""
    out = np.stack(
        [np.interp(stamps, gt_stamps, gt_pos[:, k]) for k in range(3)], axis=1
    )
    return out


def analyze(kf_stamps, loops, gt_stamps, gt_pos, accum_gate=50.0,
            interval=10.0, revisit_radius=5.0, false_radius=7.0):
    kf_stamps = np.asarray(kf_stamps)
    pos = gt_at(kf_stamps, gt_stamps, gt_pos)
    n = len(kf_stamps)
    # ground-truth traveled distance per keyframe
    accum = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(pos, axis=0), axis=1))])
    d = np.linalg.norm(pos[None, :, :] - pos[:, None, :], axis=-1)
    elig = (d < revisit_radius) & (np.abs(accum[None, :] - accum[:, None]) > accum_gate)
    has_partner = elig.any(axis=0)  # j has some valid old partner i

    # split eligible j's into revisit regions every `interval` meters
    regions = []
    cur = None
    for j in range(n):
        if not has_partner[j]:
            if cur is not None:
                regions.append(cur)
                cur = None
            continue
        if cur is None:
            cur = [j, j, accum[j]]
        elif accum[j] - cur[2] >= interval:
            regions.append(cur)
            cur = [j, j, accum[j]]
        else:
            cur[1] = j
    if cur is not None:
        regions.append(cur)

    true_accepts, false_accepts = 0, 0
    for key_new, key_old, _fit in loops:
        if d[key_new, key_old] <= false_radius:
            true_accepts += 1
        else:
            false_accepts += 1
    covered, covered_new_only = set(), set()
    for k, (j0, j1, _) in enumerate(regions):
        for key_new, key_old, _fit in loops:
            if d[key_new, key_old] > false_radius:
                continue
            if j0 <= key_new <= j1:
                covered.add(k)
                covered_new_only.add(k)
            if j0 <= key_old <= j1:
                covered.add(k)
    # structural ceiling of the key_new-only metric: regions with no index
    # that has an OLDER partner can never host a key_new
    can_be_new = np.array(
        [bool((elig[j, :j] & (accum[j] - accum[:j] > accum_gate)).any())
         for j in range(n)]
    )
    n_reachable = sum(1 for j0, j1, _ in regions if can_be_new[j0 : j1 + 1].any())
    hits = len(covered)
    return {
        "n_keyframes": n,
        "n_revisit_pairs": int(elig.sum() // 2),
        "n_regions": len(regions),
        "n_loops_accepted": len(loops),
        "n_true_accepts": true_accepts,
        "n_false_accepts": false_accepts,
        "n_regions_covered": hits,
        "recall_regions": round(hits / max(len(regions), 1), 4),
        "recall_key_new_only": round(
            len(covered_new_only) / max(len(regions), 1), 4
        ),
        "n_regions_reachable_new": int(n_reachable),
        "key_new_only_ceiling": round(n_reachable / max(len(regions), 1), 4),
        "precision": round(true_accepts / max(len(loops), 1), 4) if loops else 1.0,
        "revisit_radius_m": revisit_radius,
        "false_radius_m": false_radius,
        "interval_m": interval,
        "accum_gate_m": accum_gate,
    }


def run_sequence(name, workdir=None):
    from gorio_tpu.cli import main
    from gorio_tpu.io.tum import ate_rmse, load_tum, rte

    spec = SEQUENCES[name]
    base = Path(workdir or tempfile.mkdtemp(prefix=f"gorio_recall_{name}_"))
    ds = base / name
    main(["simulate", "--output", str(ds)] + spec["simulate"])
    est = ds / "est.tum"
    timing = ds / "timing.json"
    main(["slam", "--dataset", str(ds), "--output", str(est),
          "--timing-out", str(timing)] + SLAM_ARGS)
    with open(timing) as fh:
        tinfo = json.load(fh)
    gs, gp = load_tum(ds / "groundtruth.tum")
    gt_pos = np.asarray([T[:3, 3] for T in gp])
    out = analyze(tinfo["keyframe_stamps"], tinfo["loops"], np.asarray(gs), gt_pos)
    out["loop_gate_counts"] = tinfo["loop_gate_counts"]
    out["loops"] = tinfo["loops"]
    # trajectory quality alongside (context for whether recall was *needed*)
    es, ep = load_tum(est)
    out["ate_rmse_m"] = round(float(ate_rmse(es, ep, np.asarray(gs), gp)), 4)
    # the SAME run also carries everything the accuracy artifact stores
    # (identical simulate + slam args for the shared sequences) — one run,
    # both artifacts, no second 15-30 min SLAM pass
    out["_accuracy_entry"] = {
        "ate_rmse_m": out["ate_rmse_m"],
        "rte_m": round(float(rte(es, ep, np.asarray(gs), gp)), 4),
        "n_keyframes": tinfo["n_keyframes"],
        "n_loops": tinfo["n_loops"],
        "stage_median_ms": {
            k: round(v, 2) for k, v in tinfo["stage_median_ms"].items()
        },
    }
    return out


# recall sequence -> ACCURACY.json entry name (identical simulate+slam args)
ACCURACY_MAP = {"circuit2": "circuit", "figure8": "figure8"}


def main_cli():
    ap = argparse.ArgumentParser()
    ap.add_argument("--update", action="store_true")
    ap.add_argument("--accuracy-update", action="store_true",
                    help="also refresh the matching ACCURACY.json entries "
                    "from the same runs (circuit2 -> circuit, figure8)")
    ap.add_argument("--seq", choices=list(SEQUENCES), default=None)
    args = ap.parse_args()
    names = [args.seq] if args.seq else list(SEQUENCES)
    results = {}
    for name in names:
        print(f"== {name} ==", file=sys.stderr)
        results[name] = run_sequence(name)
        print(json.dumps({name: results[name]}), flush=True)
    acc_entries = {
        ACCURACY_MAP[n]: r.pop("_accuracy_entry")
        for n, r in results.items()
        if n in ACCURACY_MAP
    }
    for r in results.values():
        r.pop("_accuracy_entry", None)
    if args.update:
        stored = {}
        if RECALL_JSON.exists():
            stored = json.loads(RECALL_JSON.read_text())
        stored.update(results)
        RECALL_JSON.write_text(json.dumps(stored, indent=2) + "\n")
        print(f"wrote {RECALL_JSON}", file=sys.stderr)
    if args.accuracy_update and acc_entries:
        acc_path = REPO / "ACCURACY.json"
        stored = json.loads(acc_path.read_text()) if acc_path.exists() else {}
        stored.update(acc_entries)
        acc_path.write_text(json.dumps(stored, indent=2) + "\n")
        print(f"wrote {acc_path} ({', '.join(acc_entries)})", file=sys.stderr)


if __name__ == "__main__":
    main_cli()
