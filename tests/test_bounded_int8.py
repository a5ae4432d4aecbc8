"""int8 bounded-exact top-k (VERDICT r4 item 2): the scan runs on
exact int32 dots of per-window int8 codes; the margins cover the
block-quantization residual; exactness w.r.t. the refine-domain corpus
is UNCONDITIONAL (certificates route anything unprovable to the exact
fallback)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from qrag_tpu.ops.bounded_topk import (
    bounded_exact_topk_int8,
    packed_window_scan_top2_int,
    window_maxnorms,
    window_minsqnorms_device,
    window_quant_residuals_device,
)
from qrag_tpu.ops.topk import _goodness
from qrag_tpu.ops.window_scan import (
    WINDOW,
    make_lane_rank,
    quantize_block_rows,
)


def _run(q, x, metric, k, valid=None, **kw):
    x = np.asarray(x, np.float32)
    sq = (x ** 2).sum(1)
    q8x, wscale = quantize_block_rows(x)
    return bounded_exact_topk_int8(
        jnp.asarray(q),
        jnp.asarray(q8x),
        jnp.asarray(wscale),
        jnp.asarray(x),
        jnp.asarray(sq),
        jnp.asarray(window_maxnorms(sq)),
        window_minsqnorms_device(jnp.asarray(sq)),
        window_quant_residuals_device(
            jnp.asarray(x), jnp.asarray(q8x), jnp.asarray(wscale)
        ),
        jnp.asarray(make_lane_rank(x.shape[0])),
        k,
        metric=metric,
        valid_rows=None if valid is None else jnp.asarray(valid),
        **kw,
    )


def _oracle(q, x, metric, valid, k):
    sq = (np.asarray(x, np.float32) ** 2).sum(1)
    g = _goodness(
        jnp.asarray(q, jnp.float32),
        jnp.asarray(x, jnp.float32),
        metric,
        jnp.asarray(sq),
        None if valid is None else jnp.asarray(valid),
    )
    return jax.lax.top_k(g, k)


def _assert_exact(q, x, metric, k, res, valid=None, atol=1e-4):
    ov, oi = _oracle(q, x, metric, valid, k)
    vals, idx, fb, npatch = res[:4]
    idx, oi = np.asarray(idx), np.asarray(oi)
    vals, ov = np.asarray(vals), np.asarray(ov)
    if not np.array_equal(idx, oi):
        sq = (np.asarray(x, np.float32) ** 2).sum(1)
        g = np.asarray(
            _goodness(
                jnp.asarray(q, jnp.float32), jnp.asarray(x, jnp.float32),
                metric, jnp.asarray(sq),
                None if valid is None else jnp.asarray(valid),
            )
        )
        rows, pos = np.where(idx != oi)
        tol = 3e-4 * (1.0 + np.abs(ov[rows, pos]))
        gap = np.abs(g[rows, idx[rows, pos]] - ov[rows, pos])
        assert (gap <= tol).all(), (
            f"non-tie index mismatch: rows {rows}, pos {pos}, gap {gap}"
        )
    np.testing.assert_allclose(vals, ov, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_int8_random_exact(rng, metric):
    n, d, b, k = 131072, 64, 8, 10
    x = rng.randn(n, d).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.randn(b, d).astype(np.float32)
    res = _run(q, x, metric, k)
    assert not bool(res[2])  # fast path (no fallback)
    _assert_exact(q, x, metric, k, res)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_int8_near_boundary_margin_stress(rng, metric):
    """Rows planted inside the int8 quantization band around the k-th
    boundary must become extra candidates or patches, never wrong
    answers (the VERDICT item-2 'planted-near-boundary' contract)."""
    n, d, b, k = 32768, 128, 6, 10
    x = rng.randn(n, d).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.randn(b, d).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = q[0]
    # int8 band is ~1-2% of |q||x| on normalized data: plant a ladder
    # straddling the decision boundary at sub-band spacing
    for j in range(24):
        x[128 * (9 * j + 3) + (j % WINDOW)] = t * (1.0 - 2e-3 * j)
    res = _run(q, x, metric, k)
    _assert_exact(q, x, metric, k, res, atol=5e-3)


def test_int8_unnormalized_norm_spread_still_exact(rng):
    """Wildly varying row norms make the l2 min-norm bound loose —
    more candidates/fallbacks, never wrong results."""
    n, d, b, k = 16384, 32, 4, 8
    x = rng.randn(n, d).astype(np.float32)
    x *= np.exp(rng.randn(n, 1)).astype(np.float32)  # lognormal norms
    q = rng.randn(b, d).astype(np.float32)
    res = _run(q, x, "l2", k)
    _assert_exact(q, x, "l2", k, res, atol=1e-2)


def test_int8_window_collision_patch(rng):
    n, d, b, k = 16384, 32, 4, 8
    x = 0.05 * rng.randn(n, d).astype(np.float32)
    q = rng.randn(b, d).astype(np.float32)
    t = q[0] / np.linalg.norm(q[0])
    w = 23
    for j, off in enumerate((3, 40, 100)):
        x[w * WINDOW + off] = t * (4.0 + 0.01 * j)
    res = _run(q, x, "ip", k)
    vals, idx, fb, npatch = res[:4]
    _assert_exact(q, x, "ip", k, res)
    got = set(map(int, np.asarray(idx)[0]))
    assert {w * WINDOW + 3, w * WINDOW + 40, w * WINDOW + 100} <= got


def test_int8_cert_failure_escalates_without_full_sort(rng):
    """20 near-tied tops in 20 windows > C=8 but <= 4*C=32: the
    escalated re-certification succeeds — exact, no full sort."""
    n, d, b, k = 8192, 16, 4, 6
    x = rng.randn(n, d).astype(np.float32)
    q = rng.randn(b, d).astype(np.float32)
    t = q[0] / np.linalg.norm(q[0])
    for j in range(20):
        x[j * WINDOW * 2 + 5] = t * (5.0 + 1e-6 * j)
    res = _run(q, x, "ip", k, candidates=8)
    assert bool(res[4])  # escalated
    assert not bool(res[2])  # ... and certified there: no full sort
    _assert_exact(q, x, "ip", k, res)


def test_int8_cert_failure_beyond_escalation_falls_back_exact(rng):
    """40 near-tied tops in 40 windows > 4*C=32: the exact full sort
    must run and the answer stays exact."""
    n, d, b, k = 8192, 16, 4, 6
    x = rng.randn(n, d).astype(np.float32)
    q = rng.randn(b, d).astype(np.float32)
    t = q[0] / np.linalg.norm(q[0])
    for j in range(40):
        x[j * WINDOW + 5] = t * (5.0 + 1e-6 * j)
    res = _run(q, x, "ip", k, candidates=8)
    assert bool(res[4])  # escalated first
    assert bool(res[2])  # then fell back
    _assert_exact(q, x, "ip", k, res)


def test_int8_clip_detection_falls_back(rng):
    """Keys at the 2^23 clamp void the bound: must fall back, stay
    exact.  d=8192 with full-scale +/-127-code rows overflows the
    24-bit key budget."""
    n, d, b, k = 4096, 8192, 2, 5
    x = np.sign(rng.randn(n, d)).astype(np.float32)  # all +-1: max dots
    q = np.sign(rng.randn(b, d)).astype(np.float32)
    q[0] = x[5]  # aligned pair -> dot_int = d * 127^2 >> 2^23
    res = _run(q, x, "ip", k)
    assert bool(res[2])  # clip fallback fired
    _assert_exact(q, x, "ip", k, res, atol=1e-1)


def test_int8_valid_rows_and_padding_windows(rng):
    n, d, b, k = 4096, 32, 4, 5
    x = rng.randn(n, d).astype(np.float32)
    # make everything NEGATIVE against q so zero-padding (dot 0) would
    # win if not masked
    q = -np.abs(rng.randn(b, d)).astype(np.float32)
    x = np.abs(x)
    valid = np.ones(n, bool)
    valid[n - 300 :] = False  # trailing padding + one partial window
    x[n - 300 :] = 0.0
    res = _run(q, x, "ip", k, valid=valid)
    _assert_exact(q, x, "ip", k, res, valid=valid)
    assert (np.asarray(res[1]) < n - 300).all()


@pytest.mark.parametrize("seed", range(8))
def test_int8_seed_sweep_exact(seed):
    rng = np.random.RandomState(100 + seed)
    n, d, b, k = 16384, 64, 4, 10
    x = rng.randn(n, d).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.randn(b, d).astype(np.float32)
    res = _run(q, x, "l2", k)
    _assert_exact(q, x, "l2", k, res)
