"""DBSCAN clustering with distance-ranked cluster ids, fully batched.

Counterpart of `DBSCANKdtreeCluster` + the ranking loop in the
preprocessing nodelet (`preprocessing_nodelet_ntu.cpp:520-568`,
`include/dbscan/DBSCAN_kdtree.h`): the kd-tree range queries become one
batched kNN (distance-masked), the BFS cluster expansion becomes iterative
min-label propagation over the core-point graph (converges in graph-diameter
steps, bounded), and the final "rank clusters by centroid distance, write
rank+1 into normal_x" is a segment-reduce + sort.

Range-adaptive epsilon (`DBSCAN_simple.h:36-40`: eps_i = |r-1|/50 + eps) is
supported via `adaptive_eps`.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.pointcloud import PointCloud
from ..registration.knn import knn


class DBSCANConfig(NamedTuple):
    """Defaults mirror `preprocessing_nodelet_ntu.cpp:527-530`."""

    eps: float = 0.9
    core_min_pts: int = 10
    min_cluster_size: int = 20
    max_cluster_size: int = 25000
    k_neighbors: int = 32  # neighbor candidates per point (>= core_min_pts)
    max_label_iters: int = 50
    adaptive_eps: bool = False  # eps_i = |r - 1|/50 + eps


@partial(jax.jit, static_argnames=("cfg",))
def dbscan_cluster(cloud: PointCloud, cfg: DBSCANConfig = DBSCANConfig()) -> PointCloud:
    """Label clusters and write distance-rank ids into `cluster` (rank+1;
    0 = unclustered), mirroring the reference's normal_x convention."""
    n = cloud.capacity
    dtype = cloud.xyz.dtype
    idx, sqd = knn(cloud.xyz, cloud.xyz, cfg.k_neighbors, ref_mask=cloud.mask)
    if cfg.adaptive_eps:
        r = jnp.linalg.norm(cloud.xyz, axis=-1)
        eps = jnp.abs(r - 1.0) / 50.0 + cfg.eps
    else:
        eps = jnp.full((n,), cfg.eps, dtype)
    within = sqd <= (eps[:, None] ** 2)
    within = within & cloud.mask[:, None] & cloud.mask[idx]
    n_within = jnp.sum(within, axis=1)
    core = cloud.mask & (n_within >= cfg.core_min_pts)

    # min-label propagation over core-core edges; border points attach at end
    labels0 = jnp.where(core, jnp.arange(n, dtype=jnp.int32), jnp.int32(n))

    def body(state):
        labels, changed, it = state
        # for each core point, min label among core neighbors within eps
        neigh_labels = jnp.where(
            within & core[idx], labels[idx], jnp.int32(n)
        )
        new = jnp.minimum(labels, jnp.min(neigh_labels, axis=1))
        new = jnp.where(core, new, labels)
        return new, jnp.any(new != labels), it + 1

    def cond(state):
        _, changed, it = state
        return changed & (it < cfg.max_label_iters)

    labels, _, _ = jax.lax.while_loop(cond, body, (labels0, jnp.array(True), 0))

    # border points: take the label of any core neighbor within eps
    border_neigh = jnp.where(within & core[idx], labels[idx], jnp.int32(n))
    border_label = jnp.min(border_neigh, axis=1)
    labels = jnp.where(core, labels, jnp.where(cloud.mask, border_label, n))

    # cluster sizes + gating
    one = jnp.where(labels < n, 1, 0)
    sizes = jax.ops.segment_sum(one, labels, num_segments=n + 1)[:-1]
    ok_size = (sizes >= cfg.min_cluster_size) & (sizes <= cfg.max_cluster_size)
    labels = jnp.where((labels < n) & ok_size[jnp.clip(labels, 0, n - 1)], labels, n)

    # centroid distance per cluster -> rank (`:538-566`)
    w = (labels < n).astype(dtype)
    cent = jax.ops.segment_sum(cloud.xyz * w[:, None], labels, num_segments=n + 1)[:-1]
    cnt = jax.ops.segment_sum(w, labels, num_segments=n + 1)[:-1]
    cent = cent / jnp.maximum(cnt, 1.0)[:, None]
    dist = jnp.linalg.norm(cent, axis=-1)
    live = cnt > 0
    dist_sorted = jnp.where(live, dist, jnp.inf)
    order = jnp.argsort(dist_sorted)  # cluster root ids by distance
    rank_of = jnp.zeros(n + 1, jnp.int32).at[order].set(jnp.arange(n, dtype=jnp.int32) + 1)
    cluster_id = jnp.where(labels < n, rank_of[jnp.clip(labels, 0, n - 1)], 0)
    return cloud._replace(cluster=cluster_id.astype(dtype))
