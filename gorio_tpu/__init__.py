"""gorio_tpu — a JAX/XLA radar-inertial SLAM & probabilistic
inference framework with the capabilities of Go-RIO (1879615351/Go-RIO).

This is a from-scratch re-design, not a port: every stage of the reference
C++/ROS pipeline (preprocessing, Doppler ego-velocity, Gaussian-process
velocity preintegration, GICP/NDT registration, pose-graph optimization,
loop closure, posterior inference) is re-expressed as pure, batched, jittable
functions over fixed-shape padded arrays, sharded over device meshes with
`jax.sharding` where it scales.

Layering (see SURVEY.md §7):
  core/            SO(3)/SE(3) Lie math, SE-kernel integrals, linalg, point clouds
  estimators/      per-scan ops: ego-velocity RANSAC, ground seg, clustering, deskew
  registration/    batched GICP/APDGICP/VGICP/NDT + GN/LM driver
  preintegration/  GP velocity preintegration: LPM (scan) and UGPM (batched GP solve)
  graph/           typed factor graph, robust kernels, batched sparse GN/LM, Laplace
  loopclosure/     Intensity Scan Context (scatter-max + circulant matmul), gates
  inference/       Laplace / HMC / NUTS / SMC over trajectory posteriors
  parallel/        mesh & sharding helpers, multi-host collectives
  pipeline/        the three "nodelets" as an offline/streaming driver
  io/              dataset readers/writers, synthetic generators, TUM export
  utils/           profiling, timing stats
"""

__version__ = "0.1.0"
