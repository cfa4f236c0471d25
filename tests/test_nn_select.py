"""The NN + payload select feeding the GICP linearize (`knn.nn1_select`)
against an exact float64 brute force: shapes that are not multiples of the
query block, masked refs, exact payload rows, vmap over pairs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gorio_tpu.registration.knn import nn1, nn1_select

# distances of the winner come from coordinate differences: float32 rounding
# of ~2500 m^2 values at most, well inside this
D2_TOL = 1e-3


def _scene(n, m, seed, mask_frac=0.2):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(-50, 50, size=(m, 3)).astype(np.float32)
    query = (ref[rng.integers(0, m, n)] + rng.normal(scale=0.5, size=(n, 3))).astype(np.float32)
    mask = rng.random(m) > mask_frac
    payload = rng.normal(size=(m, 11)).astype(np.float32)
    return query, ref, mask, payload


def _exact(query, ref, mask):
    d2 = ((query[:, None, :].astype(np.float64) - ref[None].astype(np.float64)) ** 2).sum(-1)
    d2 = np.where(mask[None], d2, np.inf)
    order = np.argsort(d2, axis=1)
    rows = np.arange(len(query))
    return order[:, 0], d2[rows, order[:, 0]], d2[rows, order[:, 1]]


@pytest.mark.parametrize(
    "n,m,block",
    [(77, 300, 64), (130, 129, 128), (33, 1000, 16), (64, 64, 64)],
)
def test_nn1_select_matches_bruteforce(n, m, block):
    """N not a multiple of the block; ~20% of refs masked; payload rows are
    exactly payload[idx]; the winner's d2 is exact to float32 rounding."""
    q, r, mask, pay = _scene(n, m, seed=n + m)
    idx, d2, sel = nn1_select(jnp.asarray(q), jnp.asarray(r), jnp.asarray(pay),
                              jnp.asarray(mask), block=block)
    idx = np.asarray(idx)
    t_idx, t_d2, t_d2b = _exact(q, r, mask)
    clear = (t_d2b - t_d2) > D2_TOL
    np.testing.assert_array_equal(idx[clear], t_idx[clear])
    assert mask[idx].all()
    np.testing.assert_allclose(np.asarray(d2), t_d2, atol=D2_TOL, rtol=0)
    np.testing.assert_array_equal(np.asarray(sel), pay[idx])
    assert sel.shape == (n, 11) and sel.dtype == jnp.float32


def test_nn1_all_refs_masked_returns_far_bias():
    """With every ref masked the winner carries the 1e12 invalid bias, so
    every downstream distance gate rejects it."""
    q = jnp.zeros((5, 3), jnp.float32)
    r = jnp.full((70, 3), 40.0, jnp.float32)
    idx, d2 = nn1(q, r, ref_mask=jnp.zeros(70, bool))
    assert np.all((np.asarray(idx) >= 0) & (np.asarray(idx) < 70))
    assert np.all(np.asarray(d2) >= 1e12)


def test_nn1_select_vmaps_over_pairs():
    """Loop-closure verification vmaps the align over candidate pairs."""
    q, r, mask, pay = _scene(40, 100, seed=3)
    qs = jnp.stack([jnp.asarray(q), jnp.asarray(q) + 0.25])
    f = jax.vmap(lambda x: nn1_select(x, jnp.asarray(r), jnp.asarray(pay), jnp.asarray(mask)))
    idx, d2, sel = f(qs)
    for b in range(2):
        i1, d1, s1 = nn1_select(qs[b], jnp.asarray(r), jnp.asarray(pay), jnp.asarray(mask))
        np.testing.assert_array_equal(np.asarray(idx[b]), np.asarray(i1))
        np.testing.assert_allclose(np.asarray(d2[b]), np.asarray(d1), atol=D2_TOL)
        np.testing.assert_array_equal(np.asarray(sel[b]), np.asarray(s1))


def test_nn1_select_keeps_query_dtype():
    """float64 queries (the CPU validation path) select float64 payload rows
    and distances; the index matches nn1."""
    q, r, mask, pay = _scene(50, 80, seed=5)
    q64, r64, p64 = (jnp.asarray(a, jnp.float64) for a in (q, r, pay))
    idx, d2, sel = nn1_select(q64, r64, p64, jnp.asarray(mask))
    i1, d1 = nn1(q64, r64, ref_mask=jnp.asarray(mask))
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(i1))
    np.testing.assert_array_equal(np.asarray(d2), np.asarray(d1))
    assert sel.dtype == jnp.float64


def test_nn1_winner_distance_is_not_the_expansion():
    """Far from the origin the |q|^2 + |r|^2 - 2 q.r expansion cancels to
    ~1e-3 m^2 in float32; the returned distance must not."""
    rng = np.random.default_rng(9)
    centre = np.array([45.0, 20.0, 5.0])
    r = (centre + rng.uniform(-3, 3, (200, 3))).astype(np.float32)
    q = (r[:50] + rng.normal(scale=0.02, size=(50, 3))).astype(np.float32)
    _, d2 = nn1(jnp.asarray(q), jnp.asarray(r))
    _, t_d2, _ = _exact(q, r, np.ones(200, bool))
    np.testing.assert_allclose(np.asarray(d2), t_d2, atol=1e-6, rtol=1e-4)


@pytest.mark.gpu
def test_nn1_select_on_gpu(gpu_device):
    """Full-f32 matmuls (`configure_jax`, as conftest.py sets them) on the card
    at the pipeline's capacity: at TF32, wrong neighbours appear here."""
    q, r, mask, pay = _scene(2048, 2048, seed=11)
    with jax.default_device(gpu_device):
        idx, d2, sel = nn1_select(jnp.asarray(q), jnp.asarray(r), jnp.asarray(pay),
                                  jnp.asarray(mask))
    t_idx, t_d2, t_d2b = _exact(q, r, mask)
    clear = (t_d2b - t_d2) > D2_TOL
    np.testing.assert_array_equal(np.asarray(idx)[clear], t_idx[clear])
    np.testing.assert_allclose(np.asarray(d2), t_d2, atol=D2_TOL, rtol=0)
    np.testing.assert_array_equal(np.asarray(sel), pay[np.asarray(idx)])
