"""Loop detection: candidate gating + Scan Context + registration verification.

Counterpart of `LoopDetector`
(`src/radar_graph_slam/loop_detector.cpp`, SURVEY.md §2 #12). The candidate
prefilter (`find_candidates`, `:139-189`), odometry check (`:249-267`) and
pairwise consistency check (`:270-297`) operate on per-keyframe metadata and
are expressed as masked array ops; Scan Context matching and APDGICP
verification reuse the batched modules. The host-side `LoopDetector` class
orchestrates (the counterpart of the optimization-timer thread driving it).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.pointcloud import PointCloud
from ..registration.gicp import GICPConfig, gicp_align
from .information import InformationConfig, calc_information_matrix
from .scancontext import ScanContextConfig, ScanContextDB, detect_loop, make_scancontext


class LoopConfig(NamedTuple):
    """Defaults mirror `loop_detector.hpp` params + ntu launch values.

    `distance_thresh` has no gating effect in the reference either — its only
    live use is the rviz candidate-sphere radius
    (`radar_graph_slam_nodelet.cpp:1114`; the `detect` comparison at
    `loop_detector.cpp:112` is a stray-semicolon no-op) — exported by
    `RadarGraphSLAM.export_markers` as `loop_search_radius`.
    """

    distance_thresh: float = 10.0  # `ntu_loop2.launch:133`
    accum_distance_thresh: float = 50.0  # `ntu_loop2.launch:134`
    # reference launch value is 10.0 (`ntu_loop2.launch:135`); halved after
    # the r5 recall work: on the recall circuits the 10 m spacing was the
    # #2 rejection gate (74 counts on circuit3) and each extra accepted loop
    # is independently verified + gated, so the tighter spacing buys region
    # coverage without costing precision (measured, RECALL.json r5)
    min_loop_interval_dist: float = 5.0
    max_yaw_difference_deg: float = 95.0
    max_baro_difference: float = 2.0
    odom_drift_xy: float = 0.05
    odom_drift_z: float = 0.02
    drift_scale_xy: float = 2.0
    drift_scale_z: float = 2.0
    fitness_thresh: float = 2.5
    # coarse-to-fine loop verification: first align with this correspondence
    # gate (the seed pose carries up to the drift-ellipse radius of error —
    # with only the 2.5 m odometry gate the true basin is out of reach and
    # verification "converges" onto the drifted seed), then refine with the
    # odometry-grade gate. The reference has no coarse stage (and aligns
    # from identity, `loop_detector.cpp:225-228`) — a known weakness this
    # deliberately improves on.
    coarse_corr_dist: float = 10.0
    # gated-fallback SC matches (see detect_batch stage 1) assert
    # co-location; reject a fallback whose VERIFIED relative translation
    # exceeds this — displaced-basin "successes" otherwise enter the chain
    fallback_max_trans: float = 5.0
    # apply the same verified-translation ceiling to DIRECT matches too.
    # The candidate ellipse asserts co-location for every match; a verified
    # transform that moves the keyframe far beyond the ellipse radius
    # contradicts the gate that admitted it (displaced basin). Without this,
    # widening ellipse_base lets descriptor-strong/geometry-weak direct
    # matches verify onto ~5 m-offset poses and poison the pairwise chain
    # (measured, r5 replay sweep).
    trans_gate_all: bool = True
    enable_odom_check: bool = True
    odom_check_trans_thresh: float = 0.3
    odom_check_rot_thresh: float = 0.05
    pairwise_check_trans_thresh: float = 3.0
    pairwise_check_rot_thresh: float = 0.3
    # which pose source closes the pairwise-consistency cycle between the
    # previous accepted loop and the candidate. "odom" is reference parity
    # (raw scan odometry, `loop_detector.cpp:281-283`). "estimate" closes the
    # cycle with the graph-optimized poses (the reference's own #if 0
    # alternative at `loop_detector.cpp:273-280` uses node->estimate()) —
    # measured WORSE on the recall circuit (r4): drift-free spans make the
    # cycle so permissive that a displaced-basin verification passed it
    # (circuit2: 1 false accept, precision 1.0 -> 0.5), while true loops far
    # from the previous accept still failed on their own transform error.
    # Kept as an option; the default stays at parity.
    pairwise_mode: str = "odom"  # "odom" (reference parity) | "estimate"
    # drift-scaled pairwise translation allowance (r4 recall fix): the
    # pairwise cycle error T_lc_ij * odom_li * T_lc_kl^-1 * odom_jk contains
    # the RAW odometRY drift accumulated over the two odometry spans
    # (prev.key_old -> m and prev.key_new -> i), so the reference's fixed
    # 3 m bound rejects every true loop whose spans are long — measured on
    # the recall circuit: 55 true revisits with verification fitness
    # 0.05-0.10 rejected at cycle errors 3.4-4.2 m, all from span drift.
    # When enabled, the translation threshold grows with span length using
    # the SAME drift model the candidate ellipse gates already use
    # (odom_drift_xy * drift_scale_xy per meter traveled); the rotation
    # bound stays fixed. False loops are still rejected: their cycle error
    # contains the match displacement itself, far above the allowance.
    pairwise_drift_scaled: bool = True
    # base radius of the since-last-loop drift ellipse (reference hardcodes
    # 3.0, `loop_detector.cpp:171`). Kept at parity for the FIRST loop:
    # widening it unconditionally was MEASURED WORSE on the recall circuit
    # (replay sweep r5: 1 accepted loop vs 4 — before any loop exists the
    # estimate is raw odometry and there is no pairwise backstop, so wide
    # eligibility admits geometry-weak matches whose accepted transform
    # poisons every later pairwise check).
    ellipse_base: float = 3.0
    # ...and widened ONCE >=1 loop has been accepted: the graph estimate is
    # then loop-corrected, so the candidate-to-current displacement
    # approaches the TRUE lateral revisit offset (up to the ~5 m co-location
    # radius the verification + trans gate confirm), which the 3 m floor
    # shadows — measured r5: on the recall circuit ALL tail-lap candidates
    # (60+ keyframes) died on this gate with the estimate already accurate.
    # With a loop accepted, the pairwise-consistency chain + universal
    # translation gate carry the precision burden.
    ellipse_base_after_first: float = 6.0
    # pairwise consistency compares against the accepted loop with the
    # SMALLEST odometry-span distance to the candidate cycle (the reference
    # always uses the most recent, `loop_detector.cpp:281-283` — after a
    # long loop-free stretch the cycle accumulates so much span drift the
    # check either rejects true loops (fixed thr) or allows everything
    # (drift-scaled thr)). Nearest-span keeps the cycle short => tight
    # bound, which is the point of the check.
    pairwise_nearest: bool = True
    # hard ceiling on the drift-scaled pairwise translation allowance: the
    # linear growth (0.1 m per meter of span) must not disable the backstop
    # for loops far from the previous accept (a 100 m span would otherwise
    # allow +10 m of cycle error). A genuine loop's cycle error is span
    # drift; a displaced-basin false match adds its own displacement, which
    # this cap keeps rejectable at any span length.
    pairwise_trans_cap: float = 8.0
    # number of Scan-Context candidates VERIFIED per new keyframe (the
    # reference verifies only the single descriptor-best match,
    # `Scancontext.cpp:352-360`). Extra candidates ride the same
    # vmapped registration batch — near-zero marginal latency — and recover
    # revisits whose best match fails verification or an acceptance gate.
    # Per keyframe the candidate list is: the global match (if it passes the
    # find_candidates gates) followed by gated-search matches, deduplicated,
    # capped at this count; candidates are tried in verified-fitness order
    # and at most one loop is accepted per keyframe. 1 = reference-shaped
    # single-candidate behavior.
    sc_candidates: int = 2


class Loop(NamedTuple):
    """A verified loop closure (parity: `Loop` struct, `loop_detector.hpp:27`)."""

    key_new: int
    key_old: int
    T_rel: np.ndarray  # (4,4): old_T_new (relative pose for the between factor)
    information: np.ndarray  # (6,6)
    fitness: float


from functools import partial


@partial(jax.jit, static_argnames=("cfg",))
def _sc_match_batch(db: "ScanContextDB", idxs, cfg: ScanContextConfig, masks=None):
    """vmapped `detect_loop`: keyframe i may only match descriptors < i.
    `masks` (B, capacity) restricts each query to its pre-gated candidates
    (see `detect_loop`'s cand_mask)."""

    def one(i, mk):
        return detect_loop(
            db._replace(count=i.astype(jnp.int32)), db.descs[i], cfg, cand_mask=mk
        )

    if masks is None:
        return jax.vmap(lambda i: one(i, None))(idxs)
    return jax.vmap(one)(idxs, masks)


@partial(jax.jit, static_argnames=("cfg", "k"))
def _sc_match_batch_topk(db: "ScanContextDB", idxs, cfg: ScanContextConfig,
                         masks, k: int):
    """vmapped `detect_loop_topk` (gated search, several candidates each)."""
    from .scancontext import detect_loop_topk

    def one(i, mk):
        return detect_loop_topk(
            db._replace(count=i.astype(jnp.int32)), db.descs[i], cfg,
            cand_mask=mk, k=k,
        )

    return jax.vmap(one)(idxs, masks)


@partial(jax.jit, static_argnames=("gicp_cfg", "coarse_cfg", "info_cfg"))
def _verify_batch(
    src, tgt, init_T, gicp_cfg: GICPConfig, coarse_cfg: GICPConfig,
    info_cfg: InformationConfig,
):
    """vmapped loop verification: coarse-to-fine registration +
    information-from-fitness.

    `init_T` seeds each align with the current estimated relative pose — a
    deliberate improvement over the reference, which aligns loop clouds from
    identity (`loop_detector.cpp:225-227`, with a literal `// TODO icp align
    with initial` at `:228`): under the drift a loop is meant to correct,
    identity is outside the correspondence-gate basin and true revisits fail
    verification. The coarse stage (wide correspondence gate) recovers the
    remaining seed error before the odometry-grade refinement."""

    def verify(s, t, T0):
        def one(Ti):
            res_c = gicp_align(s, t, init_T=Ti, cfg=coarse_cfg)
            res = gicp_align(s, t, init_T=res_c.T, cfg=gicp_cfg)
            info, fitness = calc_information_matrix(s, t, res.T, info_cfg)
            return res.T, res.converged, info, fitness

        # two hypotheses: the current estimate (exact after loops have been
        # absorbed) and CO-LOCATION (what an SC match asserts; exact before
        # any loop has corrected the drift). Keep the better-fitting result —
        # a drift-contaminated estimate seed otherwise "verifies" onto a
        # displaced basin with plausible fitness, and that one bad loop then
        # poisons every later pairwise-consistency comparison.
        Ta, ca, ia, fa = one(T0)
        Tb, cb, ib, fb = one(jnp.eye(4, dtype=T0.dtype))
        # NaN-safe selection: a diverged seed yields NaN fitness, and
        # `fa <= fb` is False whenever fb is NaN — which would pick the NaN
        # result over a finite one. Treat NaN as +inf on both sides.
        fa_s = jnp.where(jnp.isnan(fa), jnp.inf, fa)
        fb_s = jnp.where(jnp.isnan(fb), jnp.inf, fb)
        a = fa_s <= fb_s
        return (
            jnp.where(a, Ta, Tb),
            jnp.where(a, ca, cb),
            jnp.where(a, ia, ib),
            jnp.where(a, fa, fb),
        )

    return jax.vmap(verify)(src, tgt, init_T)


def _rot_angle_np(R) -> float:
    return float(np.arccos(np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)))


def candidate_gate_reason(new_pos, new_yaw, new_accum, old_pos, old_yaw, old_accum,
                          dist_since_last_loop, cfg: LoopConfig,
                          new_alt=None, old_alt=None) -> str:
    """`find_candidates` gates (`loop_detector.cpp:139-189`):
    accumulated-distance, barometer-altitude difference (`:155-157`),
    yaw-difference, and both drift-scaled ellipses (since-last-loop +
    accumulated-distance). Returns '' on pass or the failing gate's name (the
    per-gate rejection diagnostic the reference lacks). Scalar numpy on
    purpose: these run per candidate in the host-side accept chain, where a
    device dispatch per check would dominate (see `detect_batch`)."""
    accum_d = new_accum - old_accum
    if accum_d <= cfg.accum_distance_thresh:
        return "accum_distance"
    # barometer gate: only when the OLD keyframe carries an altitude (the
    # reference checks `k->altitude.is_initialized()` alone, `:156`)
    if old_alt is not None and new_alt is not None:
        if abs(float(old_alt) - float(new_alt)) > cfg.max_baro_difference:
            return "barometer"
    yaw_diff = abs((new_yaw - old_yaw + np.pi) % (2 * np.pi) - np.pi)
    if np.rad2deg(yaw_diff) >= cfg.max_yaw_difference_deg:
        return "yaw"
    diff = np.asarray(new_pos) - np.asarray(old_pos)
    rad_lle = cfg.ellipse_base + dist_since_last_loop * cfg.odom_drift_xy * cfg.drift_scale_xy
    if (diff[0] / rad_lle) ** 2 + (diff[1] / rad_lle) ** 2 > 1.0:
        return "ellipse_since_last_loop"
    rad_xy = 10.0 + cfg.odom_drift_xy * accum_d * cfg.drift_scale_xy
    if (diff[0] / rad_xy) ** 2 + (diff[1] / rad_xy) ** 2 > 1.0:
        return "ellipse_accum"
    return ""


def candidate_gates_np(*args, **kwargs) -> bool:
    """Boolean view of `candidate_gate_reason` (True = candidate passes)."""
    return not candidate_gate_reason(*args, **kwargs)


def odometry_check(T_loop_ij, odom_new, odom_old, idx_new, idx_old, cfg: LoopConfig):
    """Per-edge drift bound (`loop_detector.cpp:249-267`)."""
    T_odom_ji = np.linalg.inv(odom_new) @ odom_old
    T_err = np.asarray(T_loop_ij) @ T_odom_ji
    n = max(idx_new - idx_old, 1)
    trans_err = np.linalg.norm(T_err[:3, 3]) / n
    rot_err = _rot_angle_np(T_err[:3, :3]) / n
    return trans_err <= cfg.odom_check_trans_thresh and rot_err <= cfg.odom_check_rot_thresh


def pairwise_consistency_check(
    T_loop_ij, odom_li, T_loop_kl_inv, odom_jk, cfg: LoopConfig,
    span_dist: float = 0.0,
):
    """Consistency vs the previous loop (`loop_detector.cpp:270-297`).

    `span_dist` is the total traveled distance along the two odometry spans
    of the cycle; with `cfg.pairwise_drift_scaled` the translation bound
    grows by the drift model (see LoopConfig), since that drift sits in the
    cycle error even for a perfect loop transform."""
    T_err = np.asarray(T_loop_ij) @ odom_li @ T_loop_kl_inv @ odom_jk
    trans_err = np.linalg.norm(T_err[:3, 3])
    rot_err = _rot_angle_np(T_err[:3, :3])
    thr_t = cfg.pairwise_check_trans_thresh
    if cfg.pairwise_drift_scaled:
        thr_t = min(
            thr_t + cfg.odom_drift_xy * cfg.drift_scale_xy * float(span_dist),
            cfg.pairwise_trans_cap,
        )
    return trans_err <= thr_t and rot_err <= cfg.pairwise_check_rot_thresh


@dataclass
class LoopDetector:
    """Host-side orchestrator over the jitted kernels."""

    cfg: LoopConfig = LoopConfig()
    sc_cfg: ScanContextConfig = ScanContextConfig()
    gicp_cfg: GICPConfig = GICPConfig()
    info_cfg: InformationConfig = InformationConfig()
    capacity: int = 1024
    db: Optional[ScanContextDB] = None
    last_loop_accum: float = 0.0
    loops: list = field(default_factory=list)
    # per-gate rejection counters (diagnosis: which gate starves recall —
    # VERDICT r2 found 1 loop on a closed circuit with zero visibility into
    # why; the reference prints nothing either, `loop_detector.cpp:139-297`)
    gate_counts: dict = field(default_factory=dict)
    # per-VERIFIED-candidate decision log (pair, seed used, fitness, |t| of
    # the verified transform, cycle errors, final gate) — the recall
    # characterization needs to know WHICH true loops die WHERE, not just
    # counts. Cheap (host floats, only for pairs that reach verification).
    candidate_log: list = field(default_factory=list)

    def _count(self, gate: str, n: int = 1):
        self.gate_counts[gate] = self.gate_counts.get(gate, 0) + n

    def __post_init__(self):
        if self.db is None:
            self.db = ScanContextDB.create(self.capacity, self.sc_cfg)

    def add_keyframe(self, cloud: PointCloud):
        """Parity: `makeAndSaveScancontextAndKeys` feeding from the backend."""
        desc = make_scancontext(cloud, self.sc_cfg).astype(self.db.descs.dtype)
        if int(self.db.count) >= self.db.descs.shape[0]:
            self.db = self.db.grow()  # see ScanContextDB.grow
        self.db = self.db.add(desc)

    def detect(
        self,
        new_index: int,
        new_cloud: PointCloud,
        keyframe_clouds,
        keyframe_poses,
        keyframe_odoms,
        keyframe_accum,
        keyframe_altitudes=None,
    ) -> Optional[Loop]:
        """Run the full gate chain for one new keyframe (whose descriptor must
        already be in the DB at `new_index`)."""
        cfg = self.cfg
        if self.loops:  # loop-corrected estimate: widen the ellipse floor
            cfg = cfg._replace(ellipse_base=cfg.ellipse_base_after_first)
        poses = np.asarray(keyframe_poses)
        accum = np.asarray(keyframe_accum)
        new_accum = accum[new_index]
        dist_since = new_accum - self.last_loop_accum
        if dist_since < cfg.min_loop_interval_dist:
            self._count("interval")
            return None

        desc = self.db.descs[new_index]
        # eligibility gates applied INSIDE the ring-key search (see
        # `detect_loop`): vectorized `find_candidates` over every old
        # keyframe, so SC returns the best GATED candidate instead of a
        # global match that may be ineligible (r4 recall fix)
        alts = keyframe_altitudes
        yaw_new = np.arctan2(poses[new_index][1, 0], poses[new_index][0, 0])
        yaws = np.arctan2(poses[: new_index, 1, 0], poses[: new_index, 0, 0])
        diff = poses[: new_index, :3, 3] - poses[new_index][:3, 3][None, :]
        accum_d = new_accum - accum[:new_index]
        mask = accum_d > cfg.accum_distance_thresh
        if alts is not None and alts[new_index] is not None:
            old_alts = np.array(
                [np.nan if a is None else float(a) for a in alts[:new_index]]
            )
            mask &= ~(np.abs(old_alts - float(alts[new_index])) > cfg.max_baro_difference)
        yaw_diff = np.abs((yaw_new - yaws + np.pi) % (2 * np.pi) - np.pi)
        mask &= np.rad2deg(yaw_diff) < cfg.max_yaw_difference_deg
        rad_lle = cfg.ellipse_base + dist_since * cfg.odom_drift_xy * cfg.drift_scale_xy
        mask &= (diff[:, 0] / rad_lle) ** 2 + (diff[:, 1] / rad_lle) ** 2 <= 1.0
        rad_xy = 10.0 + cfg.odom_drift_xy * accum_d * cfg.drift_scale_xy
        mask &= (diff[:, 0] / rad_xy) ** 2 + (diff[:, 1] / rad_xy) ** 2 <= 1.0
        if not mask.any():
            self._count("no_eligible_candidate")
            return None
        cap = self.db.descs.shape[0]
        full_mask = np.zeros(cap, bool)
        full_mask[: new_index] = mask

        match, yaw, sc_dist = detect_loop(
            self.db._replace(count=jnp.asarray(new_index, jnp.int32)), desc,
            self.sc_cfg, cand_mask=jnp.asarray(full_mask),
        )
        match = int(match)
        if match < 0:
            self._count(
                "sc_distance" if np.isfinite(float(sc_dist)) else "sc_no_candidate"
            )
            return None
        yaw_old = float(yaws[match])
        reason = candidate_gate_reason(
            poses[new_index][:3, 3], yaw_new, new_accum,
            poses[match][:3, 3], yaw_old, accum[match], dist_since, cfg,
            new_alt=None if alts is None else alts[new_index],
            old_alt=None if alts is None else alts[match],
        )
        if reason:  # defense in depth: the mask already enforced these
            self._count(reason)
            return None

        # registration verification (`:222-244`): coarse-to-fine align of new
        # (source) to old from both the estimate and co-location seeds (see
        # _verify_batch)
        init = jnp.asarray(np.linalg.inv(poses[match]) @ poses[new_index])
        coarse_cfg = self.gicp_cfg._replace(
            max_correspondence_distance=self.cfg.coarse_corr_dist
        )

        def _one(Ti):
            rc = gicp_align(new_cloud, keyframe_clouds[match], init_T=Ti, cfg=coarse_cfg)
            rr = gicp_align(new_cloud, keyframe_clouds[match], init_T=rc.T, cfg=self.gicp_cfg)
            info, fit = calc_information_matrix(
                new_cloud, keyframe_clouds[match], rr.T, self.info_cfg
            )
            return rr, info, fit

        res, info, fitness = _one(init)
        res_b, info_b, fit_b = _one(jnp.eye(4, dtype=init.dtype))
        # NaN-safe seed selection (mirror of _verify_batch): a NaN estimate-
        # seed fitness must not win over a finite co-location result
        f_a = float(fitness) if np.isfinite(float(fitness)) else np.inf
        f_b = float(fit_b) if np.isfinite(float(fit_b)) else np.inf
        if f_b < f_a:
            res, info, fitness = res_b, info_b, fit_b
        # fitness is the real verification gate (PCL's hasConverged() is
        # effectively always true — see detect_batch)
        if not np.isfinite(float(fitness)) or float(fitness) > cfg.fitness_thresh:
            self._count("fitness")
            return None
        T_rel = np.asarray(res.T)  # maps new-frame points into old frame
        if cfg.trans_gate_all and np.linalg.norm(T_rel[:3, 3]) > cfg.fallback_max_trans:
            self._count("fallback_trans")  # see detect_batch: co-location gate
            return None

        if cfg.enable_odom_check:
            T_loop_ij = np.linalg.inv(T_rel)
            if not odometry_check(
                T_loop_ij,
                np.asarray(keyframe_odoms[new_index]),
                np.asarray(keyframe_odoms[match]),
                new_index,
                match,
                cfg,
            ):
                return None
        if self.loops:
            # cycle i -> j (this loop) -> l (odom) -> k (prev loop) -> i
            # (odom): l/k are the previous loop's OLD/NEW keyframes
            # (`loop_detector.cpp:281-283`; queue = (new, old), `:324`).
            # Compared loop per cfg.pairwise_nearest (see LoopConfig).
            def _span_of(p):
                return abs(accum[match] - accum[p.key_old]) + abs(
                    accum[new_index] - accum[p.key_new]
                )

            prev = (
                min(self.loops, key=_span_of)
                if cfg.pairwise_nearest
                else self.loops[-1]
            )
            # span source per cfg.pairwise_mode (see LoopConfig)
            span = poses if cfg.pairwise_mode == "estimate" else np.asarray(keyframe_odoms)
            odom_li = np.linalg.inv(span[match]) @ span[prev.key_old]
            odom_jk = np.linalg.inv(span[prev.key_new]) @ span[new_index]
            span_dist = _span_of(prev)
            if not pairwise_consistency_check(
                np.linalg.inv(T_rel), odom_li, np.asarray(prev.T_rel), odom_jk, cfg,
                span_dist=span_dist,
            ):
                return None

        loop = Loop(
            key_new=new_index,
            key_old=match,
            T_rel=T_rel,
            information=np.asarray(info),
            fitness=float(fitness),
        )
        self.loops.append(loop)
        self.last_loop_accum = float(new_accum)
        return loop

    def detect_batch(
        self,
        new_indices,
        keyframe_clouds,
        keyframe_poses,
        keyframe_odoms,
        keyframe_accum,
        keyframe_altitudes=None,
    ) -> list:
        """Batched `detect` over many new keyframes: ONE vmapped Scan-Context
        matching dispatch for the whole batch, ONE vmapped registration +
        information dispatch for the gate survivors, then the inherently
        sequential accept chain (loop-interval spacing, odometry check,
        pairwise consistency — each depends on previously accepted loops) on
        the host. Orders of magnitude fewer device round trips than calling
        `detect` per keyframe (the reference verifies loops serially,
        `loop_detector.cpp:192-244`)."""
        if len(new_indices) == 0:
            return []
        cfg = self.cfg
        if self.loops:  # see detect(): post-first-loop ellipse floor
            cfg = cfg._replace(ellipse_base=cfg.ellipse_base_after_first)
        poses = np.asarray(keyframe_poses)
        odoms = np.asarray(keyframe_odoms)
        accum = np.asarray(keyframe_accum)
        idxs = np.asarray(new_indices, np.int32)

        # ---- stage 1: SC matching for all new keyframes. Two batched
        # dispatches: the reference-parity GLOBAL search, plus a GATED search
        # with the `find_candidates` gates applied inside the ring-key
        # masking. The global match is preferred (it is the descriptor-
        # strongest and behaves exactly like the reference); the gated match
        # is a FALLBACK used only when the global match is ineligible —
        # recovering the revisits the reference loses to gate shadowing
        # without ever displacing a strong eligible match (an earlier r4
        # variant that always took the best gated candidate let weak
        # first loops in, poisoning the pairwise-consistency chain).
        # Pad the batch to a power of two so batch-size changes don't recompile
        n_new = len(idxs)
        pad_n = max(4, 1 << (n_new - 1).bit_length())
        idxs_p = np.concatenate([idxs, np.full(pad_n - n_new, idxs[-1], np.int32)])
        yaw_all = np.arctan2(poses[:, 1, 0], poses[:, 0, 0])
        cap = self.db.descs.shape[0]
        masks = np.zeros((pad_n, cap), bool)
        alts = keyframe_altitudes
        for k, i in enumerate(idxs_p):
            i = int(i)
            accum_d = accum[i] - accum[:i]
            mk = accum_d > cfg.accum_distance_thresh
            if alts is not None and alts[i] is not None:
                old_alts = np.array(
                    [np.nan if a is None else float(a) for a in alts[:i]]
                )
                mk &= ~(np.abs(old_alts - float(alts[i])) > cfg.max_baro_difference)
            yaw_diff = np.abs((yaw_all[i] - yaw_all[:i] + np.pi) % (2 * np.pi) - np.pi)
            mk &= np.rad2deg(yaw_diff) < cfg.max_yaw_difference_deg
            diff = poses[:i, :3, 3] - poses[i][:3, 3][None, :]
            # batch-start dist_since upper-bounds the true value -> radius is
            # a superset of the exact gate, which the accept chain re-runs
            dist_since0 = accum[i] - self.last_loop_accum
            rad_lle = cfg.ellipse_base + dist_since0 * cfg.odom_drift_xy * cfg.drift_scale_xy
            mk &= (diff[:, 0] / rad_lle) ** 2 + (diff[:, 1] / rad_lle) ** 2 <= 1.0
            rad_xy = 10.0 + cfg.odom_drift_xy * accum_d * cfg.drift_scale_xy
            mk &= (diff[:, 0] / rad_xy) ** 2 + (diff[:, 1] / rad_xy) ** 2 <= 1.0
            masks[k, :i] = mk
        matches_g, yaws_g, dists_g = _sc_match_batch(
            self.db, jnp.asarray(idxs_p), self.sc_cfg
        )
        K_SC = max(1, int(cfg.sc_candidates))
        if K_SC == 1:
            matches_m, yaws_m, dists_m = _sc_match_batch(
                self.db, jnp.asarray(idxs_p), self.sc_cfg, masks=jnp.asarray(masks)
            )
            matches_m = np.asarray(matches_m)[:n_new, None]
        else:
            matches_m, yaws_m, dists_m = _sc_match_batch_topk(
                self.db, jnp.asarray(idxs_p), self.sc_cfg, jnp.asarray(masks),
                K_SC,
            )
            matches_m = np.asarray(matches_m)[:n_new]
        matches_g = np.asarray(matches_g)[:n_new]
        yaws_g = np.asarray(yaws_g)[:n_new]
        dists_g = np.asarray(dists_g)[:n_new]
        no_eligible = ~masks[:n_new].any(axis=1)

        # per-keyframe candidate lists (see LoopConfig.sc_candidates): the
        # gate-passing global match first, then gated-search matches,
        # deduplicated, at most K_SC entries
        cand_lists: list = [[] for _ in range(n_new)]
        for k, i in enumerate(idxs):
            i = int(i)
            cl = cand_lists[k]
            mg = int(matches_g[k])
            if mg >= 0 and masks[k, mg]:
                cl.append((mg, False))
            for r in range(matches_m.shape[1]):
                mm = int(matches_m[k, r])
                if mm >= 0 and len(cl) < K_SC and all(mm != c0 for c0, _ in cl):
                    cl.append((mm, True))
                    self._count("gated_fallback_match")

        # ---- stage 2: host prefilter before the expensive verification.
        # Both gates are safe w.r.t. in-batch accepts: last_loop_accum only
        # grows, so (a) dist_since computed at batch start upper-bounds the
        # true value -> the interval gate is exact-reject, and (b) the
        # drift-ellipse radius grows with dist_since -> gating with the
        # batch-start value is a superset of the exact gate (which the accept
        # chain re-runs). Mirrors `find_candidates` (`loop_detector.cpp:139`).
        pairs = []
        for k, i in enumerate(idxs):
            i = int(i)
            if not cand_lists[k]:
                mg = int(matches_g[k])
                if mg >= 0 and not masks[k, mg]:
                    # the global match failed a gate and no gated candidate
                    # cleared the SC threshold — attribute the gate
                    dist_since0 = accum[i] - self.last_loop_accum
                    reason = candidate_gate_reason(
                        poses[i][:3, 3], yaw_all[i], accum[i],
                        poses[mg][:3, 3], yaw_all[mg], accum[mg], dist_since0, cfg,
                        new_alt=None if alts is None else alts[i],
                        old_alt=None if alts is None else alts[mg],
                    )
                    self._count(reason or "gated_sc_distance")
                elif no_eligible[k]:
                    self._count("no_eligible_candidate")
                else:
                    self._count(
                        "sc_distance" if np.isfinite(dists_g[k]) else "sc_no_candidate"
                    )
                continue
            dist_since0 = accum[i] - self.last_loop_accum
            if dist_since0 < cfg.min_loop_interval_dist:
                self._count("interval")
                continue
            for m, fb in cand_lists[k]:
                reason = candidate_gate_reason(
                    poses[i][:3, 3], yaw_all[i], accum[i],
                    poses[m][:3, 3], yaw_all[m], accum[m], dist_since0, cfg,
                    new_alt=None if keyframe_altitudes is None else keyframe_altitudes[i],
                    old_alt=None if keyframe_altitudes is None else keyframe_altitudes[m],
                )
                if reason:
                    self._count(reason)
                    continue
                pairs.append((i, m, fb))
        if not pairs:
            return []

        # ---- stage 3: batched verification, pow2-padded; pairs are grouped
        # by (source, target) cloud capacity so heterogeneous-capacity
        # keyframes batch among themselves instead of crashing jnp.stack
        def stack_clouds(ids):
            return jax.tree.map(
                lambda *xs: jnp.stack(xs), *[keyframe_clouds[k] for k in ids]
            )

        n_pairs = len(pairs)
        Ts = np.zeros((n_pairs, 4, 4))
        conv = np.zeros(n_pairs, bool)
        infos = np.zeros((n_pairs, 6, 6))
        fits = np.full(n_pairs, np.inf)
        groups = {}
        for n, (i, m, _fb) in enumerate(pairs):
            kcap = (keyframe_clouds[i].capacity, keyframe_clouds[m].capacity)
            groups.setdefault(kcap, []).append(n)
        for members in groups.values():
            gp = [pairs[n] for n in members]
            pad_p = max(2, 1 << (len(gp) - 1).bit_length())
            gp_p = gp + [gp[0]] * (pad_p - len(gp))
            src = stack_clouds([i for i, _, _fb in gp_p])
            tgt = stack_clouds([m for _, m, _fb in gp_p])
            # seed each verification at the current estimated relative pose
            # old_T_new (see _verify_batch: the reference's identity init is
            # its own acknowledged defect)
            init = jnp.asarray(
                np.stack([np.linalg.inv(poses[m]) @ poses[i] for i, m, _fb in gp_p])
            )
            coarse_cfg = self.gicp_cfg._replace(
                max_correspondence_distance=self.cfg.coarse_corr_dist
            )
            T_g, c_g, i_g, f_g = _verify_batch(
                src, tgt, init, self.gicp_cfg, coarse_cfg, self.info_cfg
            )
            Ts[members] = np.asarray(T_g)[: len(gp)]
            conv[members] = np.asarray(c_g)[: len(gp)]
            infos[members] = np.asarray(i_g)[: len(gp)]
            fits[members] = np.asarray(f_g)[: len(gp)]

        # ---- stage 4: sequential accept chain (host) -----------------------
        # keyframes ascending; a keyframe's candidates in verified-fitness
        # order; at most ONE accepted loop per keyframe
        by_i: dict = {}
        for n, (i, m, fb) in enumerate(pairs):
            by_i.setdefault(i, []).append(n)
        order = []
        for i in sorted(by_i):
            order.extend(sorted(by_i[i], key=lambda n: fits[n]))
        accepted = []
        accepted_i = set()
        for n in order:
            i, m, fb = pairs[n]
            if i in accepted_i:
                continue
            T_rel = Ts[n]
            est_rel = np.linalg.inv(poses[m]) @ poses[i]
            rec = {
                "new": int(i), "old": int(m), "fallback": bool(fb),
                "fitness": float(fits[n]),
                "t_norm": float(np.linalg.norm(T_rel[:3, 3])),
                # disagreement between the verified transform and the current
                # graph estimate of the same relative pose
                "est_err": float(
                    np.linalg.norm((np.linalg.inv(est_rel) @ T_rel)[:3, 3])
                ),
                "gate": "accepted",
            }
            self.candidate_log.append(rec)
            # NOTE the reference's hasConverged() gate (`loop_detector.cpp:
            # 230`) is PCL's, which is true for any completed run — the real
            # verification is the fitness gate + odometry/pairwise checks.
            # Our LM's stricter relative-tolerance flag would over-reject
            # viewpoint-distant loop pairs, so it is counted but not gating;
            # non-finite fitness (a genuinely failed align) still rejects.
            if not bool(conv[n]):
                self._count("not_converged")
            if not np.isfinite(fits[n]) or float(fits[n]) > cfg.fitness_thresh:
                rec["gate"] = "fitness"
                self._count("fitness")
                continue
            new_accum = accum[i]
            dist_since = new_accum - self.last_loop_accum
            if dist_since < cfg.min_loop_interval_dist:
                rec["gate"] = "interval"
                self._count("interval")
                continue
            reason = candidate_gate_reason(
                poses[i][:3, 3], yaw_all[i], new_accum,
                poses[m][:3, 3], yaw_all[m], accum[m], dist_since, cfg,
                new_alt=None if keyframe_altitudes is None else keyframe_altitudes[i],
                old_alt=None if keyframe_altitudes is None else keyframe_altitudes[m],
            )
            if reason:
                rec["gate"] = reason
                self._count(reason)
                continue
            if (fb or cfg.trans_gate_all) and (
                np.linalg.norm(T_rel[:3, 3]) > cfg.fallback_max_trans
            ):
                # the match asserts CO-LOCATION (fallbacks by construction;
                # direct matches via the candidate ellipse); a verified
                # transform that moves the keyframe far is a displaced-basin
                # "success" (SC descriptors are weakly discriminative on
                # repetitive scenes) — reject before it can poison the
                # pairwise chain
                rec["gate"] = "fallback_trans"
                self._count("fallback_trans")
                continue
            if cfg.enable_odom_check and not odometry_check(
                np.linalg.inv(T_rel), odoms[i], odoms[m], i, m, cfg
            ):
                rec["gate"] = "odom_check"
                self._count("odom_check")
                continue
            if self.loops:
                # see detect(): l/k are the previous loop's OLD/NEW keyframes;
                # compared loop per cfg.pairwise_nearest (see LoopConfig)
                def _span_of(p):
                    return abs(accum[m] - accum[p.key_old]) + abs(
                        accum[i] - accum[p.key_new]
                    )

                prev = (
                    min(self.loops, key=_span_of)
                    if cfg.pairwise_nearest
                    else self.loops[-1]
                )
                # span source per cfg.pairwise_mode (see LoopConfig)
                span = poses if cfg.pairwise_mode == "estimate" else odoms
                odom_li = np.linalg.inv(span[m]) @ span[prev.key_old]
                odom_jk = np.linalg.inv(span[prev.key_new]) @ span[i]
                T_err = (
                    np.linalg.inv(T_rel) @ odom_li @ np.asarray(prev.T_rel) @ odom_jk
                )
                span_dist = _span_of(prev)
                rec["pairwise_trans"] = float(np.linalg.norm(T_err[:3, 3]))
                rec["pairwise_rot"] = _rot_angle_np(T_err[:3, :3])
                rec["span_dist"] = float(span_dist)
                rec["prev"] = [int(prev.key_new), int(prev.key_old)]
                if not pairwise_consistency_check(
                    np.linalg.inv(T_rel), odom_li, np.asarray(prev.T_rel), odom_jk, cfg,
                    span_dist=span_dist,
                ):
                    rec["gate"] = "pairwise"
                    self._count("pairwise")
                    continue
            loop = Loop(
                key_new=i, key_old=m, T_rel=T_rel,
                information=infos[n], fitness=float(fits[n]),
            )
            self.loops.append(loop)
            self.last_loop_accum = float(new_accum)
            self._count("accepted")
            accepted.append(loop)
            accepted_i.add(i)
        return accepted
