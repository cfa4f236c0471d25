"""Host-side pose-graph builder + g2o-format persistence.

Counterpart of the reference's `GraphSLAM` wrapper object
(`graph_slam.cpp:56-412`) and its `save`/`load` with the robust-kernel sidecar
(`robust_kernel_io.cpp`): the builder accumulates factors in Python lists (the
host is the "graph manager", like the 2-3 s optimization timer thread), then
`freeze()` packs them into fixed-capacity `GraphData` arrays for the jitted
solver. Save/load uses the standard g2o text format (VERTEX_SE3:QUAT /
EDGE_SE3:QUAT) so graphs can be cross-checked against g2o itself.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..core import lie
from .factors import (
    GraphData,
    empty_graph,
    empty_plane_graph,
)


def _pad_to(n, cap):
    if cap is None:
        # round up to the next power of two >= 4 to bound recompilation
        return max(4, 1 << (max(n, 1) - 1).bit_length())
    return cap


@dataclass
class PoseGraph:
    """Mutable builder; freeze() -> (poses, GraphData) for `optimize_graph`."""

    dtype: type = np.float64
    poses: list = field(default_factory=list)  # list of (4,4) np arrays
    planes: list = field(default_factory=list)  # list of (4,) np arrays [n, d]
    _between: list = field(default_factory=list)
    _priors: list = field(default_factory=list)
    _point_priors: list = field(default_factory=list)
    _quat_priors: list = field(default_factory=list)
    _vec_priors: list = field(default_factory=list)
    _plane_factors: list = field(default_factory=list)
    _plane_priors: list = field(default_factory=list)
    _plane_plane: list = field(default_factory=list)
    _se3_plane: list = field(default_factory=list)
    _z_between: list = field(default_factory=list)
    _utm_align: list = field(default_factory=list)

    # ---- vertices -------------------------------------------------------
    def add_pose(self, T) -> int:
        """Parity: `GraphSLAM::add_se3_node` (`graph_slam.cpp:88`)."""
        self.poses.append(np.asarray(T, dtype=self.dtype))
        return len(self.poses) - 1

    def add_plane(self, coeffs) -> int:
        """Plane vertex [n, d] with |n|=1; parity: `add_plane_node`
        (`graph_slam.cpp:96`, g2o::VertexPlane)."""
        p = np.asarray(coeffs, dtype=self.dtype)
        nrm = np.linalg.norm(p[:3])
        self.planes.append(p / max(nrm, 1e-12))
        return len(self.planes) - 1

    # ---- factors --------------------------------------------------------
    def add_between(self, i, j, T_meas, info, robust_delta=math.inf):
        """Parity: `add_se3_edge` (`graph_slam.cpp:125`); info is the 6x6
        information matrix (rot block first, matching our residual order)."""
        self._between.append((i, j, np.asarray(T_meas, self.dtype), _sqrt_info(info, 6, self.dtype), robust_delta))

    def add_prior(self, i, T_meas, info, robust_delta=math.inf):
        self._priors.append((i, np.asarray(T_meas, self.dtype), _sqrt_info(info, 6, self.dtype), robust_delta))

    def add_point_prior(self, i, p_meas, info, axes=(1, 1, 1), robust_delta=math.inf):
        """Covers add_se3_prior_xyz_edge / add_se3_prior_xy_edge / z
        (`graph_slam.cpp:141-168`) via the axis mask."""
        self._point_priors.append(
            (i, np.asarray(p_meas, self.dtype), np.asarray(axes, self.dtype), _sqrt_info(info, 3, self.dtype), robust_delta)
        )

    def add_quat_prior(self, i, R_meas, info, robust_delta=math.inf):
        self._quat_priors.append((i, np.asarray(R_meas, self.dtype), _sqrt_info(info, 3, self.dtype), robust_delta))

    def add_vec_prior(self, i, dir_world, dir_meas, info, robust_delta=math.inf):
        """Parity: add_se3_prior_vec_edge (e.g. gravity alignment)."""
        self._vec_priors.append(
            (i, np.asarray(dir_world, self.dtype), np.asarray(dir_meas, self.dtype),
             _sqrt_info(info, 3, self.dtype), robust_delta)
        )

    def add_plane_factor(self, i, plane_world, plane_meas, info, robust_delta=math.inf):
        """Parity: add_se3_plane_edge with a fixed global plane (floor/ground)."""
        self._plane_factors.append(
            (i, np.asarray(plane_world, self.dtype), np.asarray(plane_meas, self.dtype),
             _sqrt_info(info, 4, self.dtype), robust_delta)
        )

    # ---- plane-vertex factors (g2o edge parity, `graph_slam.cpp:170-340`) -
    def add_plane_prior_normal(self, j, n_meas, info, robust_delta=math.inf):
        """Parity: EdgePlanePriorNormal via `add_plane_normal_prior_edge`."""
        sq3 = _sqrt_info(info, 3, self.dtype)
        sq = np.zeros((4, 4), self.dtype)
        sq[:3, :3] = sq3
        self._plane_priors.append(
            (j, np.asarray(n_meas, self.dtype), 0.0, sq, robust_delta)
        )

    def add_plane_prior_distance(self, j, d_meas, info, robust_delta=math.inf):
        """Parity: EdgePlanePriorDistance via `add_plane_distance_prior_edge`."""
        sq = np.zeros((4, 4), self.dtype)
        sq[3, 3] = math.sqrt(float(np.asarray(info).reshape(-1)[0]))
        self._plane_priors.append(
            (j, np.array([0.0, 0.0, 1.0], self.dtype), float(d_meas), sq, robust_delta)
        )

    def add_plane_identity(self, i, j, meas, info, robust_delta=math.inf):
        """Parity: EdgePlaneIdentity (`add_plane_identity_edge`)."""
        self._plane_plane.append(
            (i, j, 0, np.asarray(meas, self.dtype), _sqrt_info(info, 4, self.dtype), robust_delta)
        )

    def add_plane_parallel(self, i, j, meas, info, robust_delta=math.inf):
        """Parity: EdgePlaneParallel — meas is the expected 3-dof normal
        difference (usually zero)."""
        sq = np.zeros((4, 4), self.dtype)
        sq[:3, :3] = _sqrt_info(info, 3, self.dtype)
        m = np.zeros(4, self.dtype)
        m[:3] = np.asarray(meas, self.dtype)
        self._plane_plane.append((i, j, 1, m, sq, robust_delta))

    def add_plane_perpendicular(self, i, j, info, robust_delta=math.inf):
        """Parity: EdgePlanePerpendicular — penalizes n_i . n_j."""
        sq = np.zeros((4, 4), self.dtype)
        sq[0, 0] = math.sqrt(float(np.asarray(info).reshape(-1)[0]))
        self._plane_plane.append((i, j, 2, np.zeros(4, self.dtype), sq, robust_delta))

    def add_se3_plane(self, i, j, plane_meas, info, robust_delta=math.inf):
        """Binary pose-plane observation; parity: EdgeSE3Plane via
        `add_se3_plane_edge` (`graph_slam.cpp:110`). `plane_meas` is the
        body-frame [n, d] measurement (3-dof chart residual)."""
        pm = np.asarray(plane_meas, self.dtype)
        pm = pm / max(np.linalg.norm(pm[:3]), 1e-12)
        self._se3_plane.append((i, j, pm, _sqrt_info(info, 3, self.dtype), robust_delta))

    def add_se3_z(self, i, j, z_meas, info, robust_delta=math.inf):
        """Parity: EdgeSE3Z (`edge_se3_z.hpp`): relative altitude z_j - z_i."""
        sq = np.array([[math.sqrt(float(np.asarray(info).reshape(-1)[0]))]], self.dtype)
        self._z_between.append((i, j, float(z_meas), sq, robust_delta))

    def add_utm_align(self, i, p_utm, p_world, info, robust_delta=math.inf):
        """Parity: EdgeSE3GtUTM — pose i maps the UTM point onto the world
        point (the `gps_traj_align` factor)."""
        self._utm_align.append(
            (i, np.asarray(p_utm, self.dtype), np.asarray(p_world, self.dtype),
             _sqrt_info(info, 3, self.dtype), robust_delta)
        )

    def freeze_planes(self, capacity=None, as_numpy=False):
        """Pack the plane-extension factors into `PlaneGraphData` plus the
        (M, 4) plane-vertex array, for `optimize_graph_with_planes`."""
        pg = empty_plane_graph(
            _pad_to(len(self._plane_priors), capacity),
            _pad_to(len(self._plane_plane), capacity),
            _pad_to(len(self._se3_plane), capacity),
            _pad_to(len(self._z_between), capacity),
            _pad_to(len(self._utm_align), capacity),
            dtype=self.dtype,
            xp=np,
        )
        f = pg.plane_priors
        for n, (j, nm, dm, sq, rd) in enumerate(self._plane_priors):
            f.i[n] = j
            f.n_meas[n] = nm
            f.d_meas[n] = dm
            f.sqrt_info[n] = sq
            f.mask[n] = True
            f.robust_delta[n] = rd
        f = pg.plane_plane
        for n, (i, j, kind, m, sq, rd) in enumerate(self._plane_plane):
            f.i[n] = i
            f.j[n] = j
            f.kind[n] = kind
            f.meas[n] = m
            f.sqrt_info[n] = sq
            f.mask[n] = True
            f.robust_delta[n] = rd
        f = pg.se3_plane
        for n, (i, j, pm, sq, rd) in enumerate(self._se3_plane):
            f.i[n] = i
            f.j[n] = j
            f.plane_meas[n] = pm
            f.sqrt_info[n] = sq
            f.mask[n] = True
            f.robust_delta[n] = rd
        f = pg.z_between
        for n, (i, j, z, sq, rd) in enumerate(self._z_between):
            f.i[n] = i
            f.j[n] = j
            f.z_meas[n] = z
            f.sqrt_info[n] = sq
            f.mask[n] = True
            f.robust_delta[n] = rd
        f = pg.utm_align
        for n, (i, pu, pw, sq, rd) in enumerate(self._utm_align):
            f.i[n] = i
            f.p_utm[n] = pu
            f.p_world[n] = pw
            f.sqrt_info[n] = sq
            f.mask[n] = True
            f.robust_delta[n] = rd
        planes = (
            np.stack(self.planes).astype(self.dtype)
            if self.planes
            else np.tile(np.array([0.0, 0.0, 1.0, 0.0], self.dtype), (1, 1))
        )
        if as_numpy:
            return planes, pg
        jdtype = jnp.asarray(np.zeros(1, self.dtype)).dtype
        return jnp.asarray(planes, dtype=jdtype), jax.tree.map(jnp.asarray, pg)

    # ---- freeze ---------------------------------------------------------
    def freeze(self, capacity_between=None, capacity_unary=None, as_numpy=False):
        """Build the padded GraphData. Buffers are assembled host-side in
        numpy (one device transfer per leaf at the end, NOT O(factors) eager
        `.at[].set` dispatches).

        `as_numpy=True` skips the device transfer entirely: the returned
        pytrees hold numpy arrays, which JAX converts at the jit boundary and
        which are safe to capture as closure constants."""
        K = len(self.poses)
        jdtype = jnp.asarray(np.zeros(1, self.dtype)).dtype
        g = empty_graph(
            _pad_to(len(self._between), capacity_between),
            _pad_to(len(self._priors), capacity_unary),
            _pad_to(len(self._point_priors), capacity_unary),
            _pad_to(len(self._quat_priors), capacity_unary),
            _pad_to(len(self._vec_priors), capacity_unary),
            _pad_to(len(self._plane_factors), capacity_unary),
            dtype=self.dtype,
            xp=np,
        )
        b = g.between
        for n, (i, j, T, sq, rd) in enumerate(self._between):
            b.i[n] = i
            b.j[n] = j
            b.T_meas[n] = T
            b.sqrt_info[n] = sq
            b.mask[n] = True
            b.robust_delta[n] = rd
        p = g.priors
        for n, (i, T, sq, rd) in enumerate(self._priors):
            p.i[n] = i
            p.T_meas[n] = T
            p.sqrt_info[n] = sq
            p.mask[n] = True
            p.robust_delta[n] = rd
        pp = g.point_priors
        for n, (i, pm, ax, sq, rd) in enumerate(self._point_priors):
            pp.i[n] = i
            pp.p_meas[n] = pm
            pp.axis_mask[n] = ax
            pp.sqrt_info[n] = sq
            pp.mask[n] = True
            pp.robust_delta[n] = rd
        q = g.quat_priors
        for n, (i, Rm, sq, rd) in enumerate(self._quat_priors):
            q.i[n] = i
            q.R_meas[n] = Rm
            q.sqrt_info[n] = sq
            q.mask[n] = True
            q.robust_delta[n] = rd
        v = g.vec_priors
        for n, (i, dw, dm, sq, rd) in enumerate(self._vec_priors):
            v.i[n] = i
            v.dir_world[n] = dw
            v.dir_meas[n] = dm
            v.sqrt_info[n] = sq
            v.mask[n] = True
            v.robust_delta[n] = rd
        pf = g.plane_factors
        for n, (i, pw, pm, sq, rd) in enumerate(self._plane_factors):
            pf.i[n] = i
            pf.plane_world[n] = pw
            pf.plane_meas[n] = pm
            pf.sqrt_info[n] = sq
            pf.mask[n] = True
            pf.robust_delta[n] = rd
        poses = np.stack(self.poses).astype(self.dtype)
        if as_numpy:
            return poses, g
        graph = jax.tree.map(jnp.asarray, g)
        return jnp.asarray(poses, dtype=jdtype), graph

    # ---- persistence (g2o text format) ---------------------------------
    def save(self, path, poses=None):
        """Write VERTEX_SE3:QUAT / EDGE_SE3:QUAT lines; parity with
        `GraphSLAM::save` (`graph_slam.cpp:384-391`). Note g2o orders the
        6-dof error as [trans, rot]; we store our [rot, trans] info in that
        order when serializing for compatibility.

        SE3 priors get framework-specific `GORIO_PRIOR_SE3` lines (g2o's own
        EDGE_SE3_PRIOR needs a parameter-offset vertex we don't model), and
        robust kernels go to a `<path>.kernels` sidecar, mirroring
        `save_robust_kernels` (`robust_kernel_io.cpp:45-80`): one
        `EDGE_SE3:QUAT <ordinal> Huber <delta>` line per robustified edge."""
        with open(path, "w") as fh:
            ps = poses if poses is not None else self.poses
            for k, T in enumerate(np.asarray(ps)):
                q = np.asarray(lie.mat_to_quat(jnp.asarray(T[:3, :3])))
                t = T[:3, 3]
                fh.write(
                    f"VERTEX_SE3:QUAT {k} {t[0]} {t[1]} {t[2]} {q[1]} {q[2]} {q[3]} {q[0]}\n"
                )
            kernels = []
            for ordinal, (i, j, T, sq, rd) in enumerate(self._between):
                q = np.asarray(lie.mat_to_quat(jnp.asarray(T[:3, :3])))
                t = T[:3, 3]
                info = sq.T @ sq
                # reorder [rot, trans] -> [trans, rot] for g2o
                P = np.zeros((6, 6))
                P[:3, 3:] = np.eye(3)
                P[3:, :3] = np.eye(3)
                info_g = P @ info @ P.T
                upper = [info_g[r, c] for r in range(6) for c in range(r, 6)]
                fh.write(
                    f"EDGE_SE3:QUAT {i} {j} {t[0]} {t[1]} {t[2]} "
                    f"{q[1]} {q[2]} {q[3]} {q[0]} " + " ".join(map(str, upper)) + "\n"
                )
                if math.isfinite(rd):
                    kernels.append(("EDGE_SE3:QUAT", ordinal, rd))
            for ordinal, (i, T, sq, rd) in enumerate(self._priors):
                q = np.asarray(lie.mat_to_quat(jnp.asarray(T[:3, :3])))
                t = T[:3, 3]
                info = sq.T @ sq
                P = np.zeros((6, 6))
                P[:3, 3:] = np.eye(3)
                P[3:, :3] = np.eye(3)
                info_g = P @ info @ P.T
                upper = [info_g[r, c] for r in range(6) for c in range(r, 6)]
                fh.write(
                    f"GORIO_PRIOR_SE3 {i} {t[0]} {t[1]} {t[2]} "
                    f"{q[1]} {q[2]} {q[3]} {q[0]} " + " ".join(map(str, upper)) + "\n"
                )
                if math.isfinite(rd):
                    kernels.append(("GORIO_PRIOR_SE3", ordinal, rd))
            # plane vertices (g2o VERTEX_PLANE) and extension edges; plane ids
            # continue after the pose ids, matching g2o's shared id space
            K = len(ps)
            for m, p in enumerate(np.asarray(self.planes).reshape(-1, 4)):
                fh.write(f"VERTEX_PLANE {K + m} {p[0]} {p[1]} {p[2]} {p[3]}\n")
            def _upper(sq, d):
                info = sq.T @ sq
                return " ".join(str(info[r, c]) for r in range(d) for c in range(r, d))
            for ordinal, (j, nm, dm, sq, rd) in enumerate(self._plane_priors):
                fh.write(
                    f"GORIO_PLANE_PRIOR {K + j} {nm[0]} {nm[1]} {nm[2]} {dm} "
                    + _upper(sq, 4) + "\n"
                )
                if math.isfinite(rd):
                    kernels.append(("GORIO_PLANE_PRIOR", ordinal, rd))
            for ordinal, (i, j, kind, m, sq, rd) in enumerate(self._plane_plane):
                fh.write(
                    f"GORIO_PLANE_PLANE {K + i} {K + j} {kind} "
                    f"{m[0]} {m[1]} {m[2]} {m[3]} " + _upper(sq, 4) + "\n"
                )
                if math.isfinite(rd):
                    kernels.append(("GORIO_PLANE_PLANE", ordinal, rd))
            for ordinal, (i, j, pm, sq, rd) in enumerate(self._se3_plane):
                fh.write(
                    f"GORIO_SE3_PLANE {i} {K + j} {pm[0]} {pm[1]} {pm[2]} {pm[3]} "
                    + _upper(sq, 3) + "\n"
                )
                if math.isfinite(rd):
                    kernels.append(("GORIO_SE3_PLANE", ordinal, rd))
            for ordinal, (i, j, z, sq, rd) in enumerate(self._z_between):
                fh.write(f"GORIO_SE3_Z {i} {j} {z} {float(sq[0, 0]) ** 2}\n")
                if math.isfinite(rd):
                    kernels.append(("GORIO_SE3_Z", ordinal, rd))
            for ordinal, (i, pu, pw, sq, rd) in enumerate(self._utm_align):
                fh.write(
                    f"GORIO_SE3_GT_UTM {i} {pu[0]} {pu[1]} {pu[2]} "
                    f"{pw[0]} {pw[1]} {pw[2]} " + _upper(sq, 3) + "\n"
                )
                if math.isfinite(rd):
                    kernels.append(("GORIO_SE3_GT_UTM", ordinal, rd))
        if kernels:
            with open(str(path) + ".kernels", "w") as kf:
                for tag, ordinal, delta in kernels:
                    kf.write(f"{tag} {ordinal} Huber {delta}\n")

    @classmethod
    def load(cls, path, dtype=np.float64):
        """Restore poses + between edges + SE3 priors, re-applying robust
        kernels from the `<path>.kernels` sidecar (parity:
        `load_robust_kernels`, `robust_kernel_io.cpp:84-128`)."""
        import os

        g = cls(dtype=dtype)
        verts = {}
        plane_verts = {}  # raw g2o id -> coeffs; ids remapped after reading
        raw_plane_priors = []
        raw_plane_plane = []
        raw_se3_plane = []
        kernels = {}

        def _info_from_upper(vals, d):
            info = np.zeros((d, d))
            n = 0
            for r in range(d):
                for c in range(r, d):
                    info[r, c] = info[c, r] = vals[n]
                    n += 1
            return info
        if os.path.exists(str(path) + ".kernels"):
            with open(str(path) + ".kernels") as kf:
                for line in kf:
                    tok = line.split()
                    if len(tok) == 4:
                        kernels[(tok[0], int(tok[1]))] = float(tok[3])
        n_between = 0
        n_prior = 0
        with open(path) as fh:
            for line in fh:
                tok = line.split()
                if not tok:
                    continue
                if tok[0] == "VERTEX_SE3:QUAT":
                    idx = int(tok[1])
                    t = np.array(list(map(float, tok[2:5])))
                    qx, qy, qz, qw = map(float, tok[5:9])
                    R = np.asarray(lie.quat_to_mat(jnp.asarray([qw, qx, qy, qz])))
                    T = np.eye(4)
                    T[:3, :3] = R
                    T[:3, 3] = t
                    verts[idx] = T
                elif tok[0] == "EDGE_SE3:QUAT":
                    i, j = int(tok[1]), int(tok[2])
                    t = np.array(list(map(float, tok[3:6])))
                    qx, qy, qz, qw = map(float, tok[6:10])
                    R = np.asarray(lie.quat_to_mat(jnp.asarray([qw, qx, qy, qz])))
                    T = np.eye(4)
                    T[:3, :3] = R
                    T[:3, 3] = t
                    upper = list(map(float, tok[10:31]))
                    info_g = np.zeros((6, 6))
                    n = 0
                    for r in range(6):
                        for c in range(r, 6):
                            info_g[r, c] = info_g[c, r] = upper[n]
                            n += 1
                    P = np.zeros((6, 6))
                    P[:3, 3:] = np.eye(3)
                    P[3:, :3] = np.eye(3)
                    info = P.T @ info_g @ P
                    rd = kernels.get(("EDGE_SE3:QUAT", n_between), math.inf)
                    g._between.append((i, j, T, _sqrt_info(info, 6, dtype), rd))
                    n_between += 1
                elif tok[0] == "GORIO_PRIOR_SE3":
                    i = int(tok[1])
                    t = np.array(list(map(float, tok[2:5])))
                    qx, qy, qz, qw = map(float, tok[5:9])
                    R = np.asarray(lie.quat_to_mat(jnp.asarray([qw, qx, qy, qz])))
                    T = np.eye(4)
                    T[:3, :3] = R
                    T[:3, 3] = t
                    upper = list(map(float, tok[9:30]))
                    info_g = np.zeros((6, 6))
                    n = 0
                    for r in range(6):
                        for c in range(r, 6):
                            info_g[r, c] = info_g[c, r] = upper[n]
                            n += 1
                    P = np.zeros((6, 6))
                    P[:3, 3:] = np.eye(3)
                    P[3:, :3] = np.eye(3)
                    info = P.T @ info_g @ P
                    rd = kernels.get(("GORIO_PRIOR_SE3", n_prior), math.inf)
                    g._priors.append((i, T, _sqrt_info(info, 6, dtype), rd))
                    n_prior += 1
                elif tok[0] == "VERTEX_PLANE":
                    plane_verts[int(tok[1])] = np.array(list(map(float, tok[2:6])))
                elif tok[0] == "GORIO_PLANE_PRIOR":
                    j = int(tok[1])
                    nm = np.array(list(map(float, tok[2:5])))
                    dm = float(tok[5])
                    sq = _sqrt_info(_info_from_upper(list(map(float, tok[6:16])), 4), 4, dtype)
                    rd = kernels.get(("GORIO_PLANE_PRIOR", len(raw_plane_priors)), math.inf)
                    raw_plane_priors.append((j, nm, dm, sq, rd))
                elif tok[0] == "GORIO_PLANE_PLANE":
                    i, j, kind = int(tok[1]), int(tok[2]), int(tok[3])
                    m = np.array(list(map(float, tok[4:8])))
                    sq = _sqrt_info(_info_from_upper(list(map(float, tok[8:18])), 4), 4, dtype)
                    rd = kernels.get(("GORIO_PLANE_PLANE", len(raw_plane_plane)), math.inf)
                    raw_plane_plane.append((i, j, kind, m, sq, rd))
                elif tok[0] == "GORIO_SE3_PLANE":
                    i, j = int(tok[1]), int(tok[2])
                    pm = np.array(list(map(float, tok[3:7])))
                    sq = _sqrt_info(_info_from_upper(list(map(float, tok[7:13])), 3), 3, dtype)
                    rd = kernels.get(("GORIO_SE3_PLANE", len(raw_se3_plane)), math.inf)
                    raw_se3_plane.append((i, j, pm, sq, rd))
                elif tok[0] == "GORIO_SE3_Z":
                    i, j = int(tok[1]), int(tok[2])
                    z, info1 = float(tok[3]), float(tok[4])
                    rd = kernels.get(("GORIO_SE3_Z", len(g._z_between)), math.inf)
                    g._z_between.append(
                        (i, j, z, np.array([[math.sqrt(info1)]], dtype), rd)
                    )
                elif tok[0] == "GORIO_SE3_GT_UTM":
                    i = int(tok[1])
                    pu = np.array(list(map(float, tok[2:5])))
                    pw = np.array(list(map(float, tok[5:8])))
                    sq = _sqrt_info(_info_from_upper(list(map(float, tok[8:14])), 3), 3, dtype)
                    rd = kernels.get(("GORIO_SE3_GT_UTM", len(g._utm_align)), math.inf)
                    g._utm_align.append((i, pu, pw, sq, rd))
        for k in sorted(verts):
            g.poses.append(verts[k])
        # plane ids were written offset by the pose count; remap to 0-based
        K = len(g.poses)
        for k in sorted(plane_verts):
            g.planes.append(plane_verts[k].astype(dtype))
        g._plane_priors = [(j - K, nm, dm, sq, rd) for j, nm, dm, sq, rd in raw_plane_priors]
        g._plane_plane = [
            (i - K, j - K, kind, m, sq, rd) for i, j, kind, m, sq, rd in raw_plane_plane
        ]
        g._se3_plane = [(i, j - K, pm, sq, rd) for i, j, pm, sq, rd in raw_se3_plane]
        return g


def _sqrt_info(info, dim, dtype):
    """Upper-triangular square root of an information matrix (scalar,
    diagonal, or full)."""
    info = np.asarray(info, dtype=dtype)
    if info.ndim == 0:
        info = np.eye(dim, dtype=dtype) * info
    elif info.ndim == 1:
        info = np.diag(info)
    # symmetrize and Cholesky; fall back to sqrt of diagonal
    info = 0.5 * (info + info.T)
    try:
        L = np.linalg.cholesky(info + 1e-15 * np.eye(dim))
        return L.T.astype(dtype)
    except np.linalg.LinAlgError:
        return np.diag(np.sqrt(np.maximum(np.diag(info), 0.0))).astype(dtype)
