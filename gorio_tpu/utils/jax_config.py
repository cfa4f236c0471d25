"""Process-wide JAX settings, in one place.

Every entry point (the CLI, `chip_smoke.py`, `bench.py`, `__graft_entry__`,
the scripts and the test suite) calls `configure_jax()` before its first
trace. It sets two things:

- Matmul precision: every float32 contraction runs at `Precision.HIGHEST`.
  On the GPU an f32 matmul with no precision asked for may round its operands
  to TF32 (about 3 decimal digits). Here that is wrong almost everywhere: the
  NN distance expansion at ~50 m (q.r ~ 2500 m^2 against 0.01 m^2 voxel
  leaves), RANSAC residuals against an inlier threshold, Mahalanobis inverses
  of covariances regularized to a 1e-3 eigenvalue, the 4x4/6x6 SE(3) chains
  of the pose graph and the LM accept ratio. The contractions are small
  (K <= 6 for most), so full precision costs little.
  tests/test_precision.py checks that the lowered programs carry it.
- The persistent compilation cache. Where `JAX_COMPILATION_CACHE_DIR` is set,
  JAX already reads it and this sets no directory. Otherwise the cache lives
  at the fixed path `<repo>/.jax_cache` (git-ignored): the path is part of
  what a cache hit needs, so it must not move between runs.
"""

from __future__ import annotations

import os
from pathlib import Path

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def configure_jax() -> str:
    """Pin f32 matmul precision and turn the persistent compile cache on for
    this process; returns the cache directory."""
    import jax

    jax.config.update("jax_default_matmul_precision", "highest")
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not env_dir:
        jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return env_dir or str(REPO_CACHE_DIR)
