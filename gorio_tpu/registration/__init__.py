"""Registration backends + method factory.

`select_registration` is the counterpart of `select_registration_method`
(`src/radar_graph_slam/registrations.cpp:23-139`): maps a method name to a
configured align callable `(source, target, init_T) -> LMResult`. The CUDA
variants of the reference map to the same device programs (the "CUDA
backend" IS the XLA path here), so FAST_VGICP_CUDA and NDT_CUDA alias their
non-CUDA spellings.
"""

from __future__ import annotations

from .gicp import GICPConfig, gicp_align  # noqa: F401
from .knn import knn, nn1  # noqa: F401
from .lsq import LMConfig, LMResult, gn_optimize, lm_optimize  # noqa: F401
from .ndt import NDTConfig, ndt_align, ndt_align_cf, ndt_d2d_align  # noqa: F401
from .vgicp import VGICPConfig, vgicp_align  # noqa: F401

_METHODS = {
    "FAST_GICP": ("gicp", "gicp"),
    "FAST_APDGICP": ("gicp", "apdgicp"),
    "FAST_VGICP": ("vgicp", None),
    # FastVGICPCuda's default neighbor method is CPU kd-tree kNN
    # (`fast_vgicp_cuda.hpp:41` CPU_PARALLEL_KDTREE); pass
    # covariance_method="rbf" for the GPU_RBF_KERNEL estimator.
    "FAST_VGICP_CUDA": ("vgicp", None),
    "GICP": ("gicp", "gicp"),
    "GICP_OMP": ("gicp", "gicp"),
    "ICP": ("gicp", "icp"),  # point-to-point ICP: identity covariances
    "NDT": ("ndt", None),
    "NDT_OMP": ("ndt", None),
    "NDT_CUDA": ("ndt", None),  # P2D mode (`NDTDistanceMode::P2D`)
    "NDT_CUDA_D2D": ("ndt_d2d", None),  # D2D mode (`ndt_compute_derivatives.cu`)
    # coarse-to-fine schedule (no reference counterpart; see
    # `ndt.ndt_align_multires`): ~2.5x faster than NDT_OMP's single
    # resolution with equal-or-better recovered pose
    "NDT_MULTIRES": ("ndt_cf", None),
}


def select_registration(method: str = "FAST_APDGICP", **overrides):
    """Return `align(source, target, init_T=None) -> LMResult` for the named
    method (names as in the reference's launch files).

    Note (NDT_MULTIRES): per-stage iteration budgets are controlled by
    `coarse_iterations` / `fine_iterations`; `max_iterations` only LOWERS the
    fine budget (the fine stage runs min(max_iterations, fine_iterations) —
    see `ndt.ndt_align_multires`)."""
    kind, mode = _METHODS[method.upper()]
    if kind == "gicp":
        cfg = GICPConfig(mode=mode, **overrides)
        return lambda s, t, init_T=None: gicp_align(s, t, init_T=init_T, cfg=cfg)
    if kind == "vgicp":
        cfg = VGICPConfig(**overrides)
        return lambda s, t, init_T=None: vgicp_align(s, t, init_T=init_T, cfg=cfg)
    cfg = NDTConfig(**overrides)
    if kind == "ndt_d2d":
        return lambda s, t, init_T=None: ndt_d2d_align(s, t, init_T=init_T, cfg=cfg)
    if kind == "ndt_cf":
        return lambda s, t, init_T=None: ndt_align_cf(s, t, init_T=init_T, cfg=cfg)
    return lambda s, t, init_T=None: ndt_align(s, t, init_T=init_T, cfg=cfg)
