"""Record/replay harness for loop-detector experiments.

A full recall-circuit SLAM run costs ~20 min on the 2-core CI box, which
makes gate-threshold experiments (VERDICT r3 item 5: recall is thin)
impractically slow to iterate. This tool records the detector's inputs
during ONE real run — per-cycle pose/odom/accum snapshots at every
`detect_batch` call, the Scan-Context descriptor bank, and the keyframe
clouds — then replays loop detection OFFLINE against those snapshots with
arbitrary `LoopConfig` overrides in ~seconds.

Caveat (documented, inherent): replay uses the recorded pose trajectory, so
a replayed config that accepts a *different* loop set sees poses that the
real pipeline would have optimized differently afterwards. Replay is a
diagnosis/screening tool; any chosen config is validated with a real run
(`scripts/recall_benchmark.py`) before artifacts are regenerated.

Usage:
    JAX_PLATFORMS=cpu python scripts/loop_replay.py record \
        --seq circuit2 --out /tmp/rec_c2.pkl
    python scripts/loop_replay.py replay --rec /tmp/rec_c2.pkl \
        [--set pairwise_check_trans_thresh=6.0 ...]
"""

import argparse
import json
import os
import pickle
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

import numpy as np  # noqa: E402


def record(seq: str, out: str):
    import gorio_tpu.loopclosure.loop_detector as ld
    from scripts.recall_benchmark import SEQUENCES, SLAM_ARGS
    from gorio_tpu.cli import main as cli_main

    cycles = []
    clouds_ref = {}
    orig = ld.LoopDetector.detect_batch

    def wrapped(self, new_indices, keyframe_clouds, keyframe_poses,
                keyframe_odoms, keyframe_accum, keyframe_altitudes=None):
        cycles.append({
            "new_idx": list(map(int, new_indices)),
            "poses": np.asarray(keyframe_poses).copy(),
            "odoms": np.asarray(keyframe_odoms).copy(),
            "accum": np.asarray(keyframe_accum).copy(),
            "alts": None if keyframe_altitudes is None else [
                None if a is None else float(a) for a in keyframe_altitudes
            ],
        })
        for k, c in enumerate(keyframe_clouds):
            if k not in clouds_ref:
                clouds_ref[k] = c
            elif clouds_ref[k] is not c:
                # replay verifies against the FIRST-seen cloud; a rebuilt/
                # redownsampled keyframe cloud would silently skew gate
                # experiments, so make it loud
                print(f"WARNING: keyframe {k} cloud object changed between "
                      "detect_batch calls; replay uses the first-seen cloud",
                      file=sys.stderr)
        return orig(self, new_indices, keyframe_clouds, keyframe_poses,
                    keyframe_odoms, keyframe_accum, keyframe_altitudes)

    captured = {}
    orig_init = ld.LoopDetector.__post_init__

    def wrapped_init(self):
        orig_init(self)
        captured["det"] = self

    ld.LoopDetector.detect_batch = wrapped
    ld.LoopDetector.__post_init__ = wrapped_init
    try:
        spec = SEQUENCES[seq]
        base = Path(tempfile.mkdtemp(prefix=f"gorio_replay_{seq}_"))
        ds = base / seq
        cli_main(["simulate", "--output", str(ds)] + spec["simulate"])
        est = ds / "est.tum"
        timing = ds / "timing.json"
        cli_main(["slam", "--dataset", str(ds), "--output", str(est),
                  "--timing-out", str(timing)] + SLAM_ARGS)
    finally:
        ld.LoopDetector.detect_batch = orig
        ld.LoopDetector.__post_init__ = orig_init

    det = captured["det"]
    with open(timing) as fh:
        tinfo = json.load(fh)
    gt_stamps, gt_pos = [], []
    for line in (ds / "groundtruth.tum").read_text().splitlines():
        v = line.split()
        if len(v) >= 4:
            gt_stamps.append(float(v[0]))
            gt_pos.append([float(v[1]), float(v[2]), float(v[3])])
    rec = {
        "seq": seq,
        "cycles": cycles,
        "clouds": {
            k: {f: np.asarray(getattr(c, f)) for f in type(c)._fields}
            for k, c in clouds_ref.items()
        },
        "descs": np.asarray(det.db.descs),
        "ring_keys": np.asarray(det.db.ring_keys),
        "count": int(det.db.count),
        "kf_stamps": tinfo["keyframe_stamps"],
        "gt_stamps": np.asarray(gt_stamps),
        "gt_pos": np.asarray(gt_pos),
        "loops_real": tinfo["loops"],
        "gate_counts_real": tinfo.get("loop_gate_counts", {}),
        "candidate_log_real": list(det.candidate_log),
    }
    with open(out, "wb") as fh:
        pickle.dump(rec, fh)
    print(f"recorded {len(cycles)} cycles, {len(clouds_ref)} clouds -> {out}",
          file=sys.stderr)


def make_detector(rec, overrides):
    import jax.numpy as jnp

    from gorio_tpu.loopclosure.loop_detector import LoopConfig, LoopDetector
    from gorio_tpu.loopclosure.scancontext import ScanContextDB

    cfg = LoopConfig()._replace(**overrides)
    det = LoopDetector(cfg=cfg)
    db = det.db
    n = rec["count"]
    while db.descs.shape[0] < rec["descs"].shape[0]:
        db = db.grow()
    # explicit shape contract: the grown DB must hold the whole recording
    # (no clamping-slice tricks — .at[].set with the exact recorded arrays)
    assert db.descs.shape[0] >= rec["descs"].shape[0], (
        db.descs.shape, rec["descs"].shape)
    descs = db.descs.at[: rec["descs"].shape[0]].set(jnp.asarray(rec["descs"]))
    rkeys = db.ring_keys.at[: rec["ring_keys"].shape[0]].set(
        jnp.asarray(rec["ring_keys"])
    )
    db = db._replace(descs=descs, ring_keys=rkeys, count=jnp.asarray(n, jnp.int32))
    det.db = db
    return det


def replay(rec, overrides):
    import jax.numpy as jnp

    from gorio_tpu.core.pointcloud import PointCloud

    det = make_detector(rec, overrides)
    clouds = {
        k: PointCloud(**{f: jnp.asarray(v) for f, v in c.items()})
        for k, c in rec["clouds"].items()
    }
    cloud_list_max = max(clouds) + 1
    cloud_list = [clouds.get(k) for k in range(cloud_list_max)]
    loops = []
    for cyc in rec["cycles"]:
        loops.extend(
            det.detect_batch(
                cyc["new_idx"], cloud_list, cyc["poses"], cyc["odoms"],
                cyc["accum"], keyframe_altitudes=cyc["alts"],
            )
        )
    return det, loops


def classify(rec, loops, radius=7.0):
    """True/false per accepted loop via GT interpolation."""
    kf = np.asarray(rec["kf_stamps"])
    gt_pos = np.stack(
        [np.interp(kf, rec["gt_stamps"], rec["gt_pos"][:, k]) for k in range(3)],
        axis=1,
    )
    out = []
    for lp in loops:
        i, m = (lp.key_new, lp.key_old) if hasattr(lp, "key_new") else (lp[0], lp[1])
        d = float(np.linalg.norm(gt_pos[i] - gt_pos[m]))
        out.append((int(i), int(m), round(d, 2), d <= radius))
    return out


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("record")
    rp.add_argument("--seq", default="circuit2")
    rp.add_argument("--out", required=True)
    pp = sub.add_parser("replay")
    pp.add_argument("--rec", required=True)
    pp.add_argument("--set", action="append", default=[],
                    help="LoopConfig override field=value")
    pp.add_argument("--log", action="store_true",
                    help="dump the per-candidate decision log")
    args = ap.parse_args()

    if args.cmd == "record":
        record(args.seq, args.out)
        return
    with open(args.rec, "rb") as fh:
        rec = pickle.load(fh)
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    det, loops = replay(rec, overrides)
    cls = classify(rec, loops)
    # region-level recall on the recorded ground truth — the SAME metric
    # RECALL.json stores (scripts/recall_benchmark.analyze), so replay
    # screening optimizes the number that actually gates the artifact
    from scripts.recall_benchmark import analyze

    regions = analyze(
        rec["kf_stamps"],
        [(int(l.key_new), int(l.key_old), float(l.fitness)) for l in loops],
        rec["gt_stamps"], rec["gt_pos"],
    )
    print(json.dumps({
        "overrides": overrides,
        "n_loops": len(loops),
        "loops": cls,
        "n_false": sum(1 for c in cls if not c[3]),
        "recall_regions": regions["recall_regions"],
        "n_regions": regions["n_regions"],
        "n_regions_covered": regions["n_regions_covered"],
        "precision": regions["precision"],
        "gate_counts": det.gate_counts,
    }))
    if args.log:
        for r in det.candidate_log:
            print(json.dumps(r))


if __name__ == "__main__":
    main()
