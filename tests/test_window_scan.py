"""Windowed packed scan (ops/window_scan.py): key transforms, packing
tie-break, end-to-end recall vs the exact oracle, int8 block scales."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qrag_tpu.ops.topk import _goodness
from qrag_tpu.ops.window_scan import (
    WINDOW,
    _float_from_key,
    _float_sort_key,
    make_lane_rank,
    packed_window_scan,
    quantize_block_rows,
    quantize_block_rows_device,
    unpack_stats,
    windowed_scan_topk,
)


def test_float_sort_key_monotone():
    xs = np.asarray(
        [-1e30, -5.5, -1.0, -0.0, 0.0, 1e-20, 1.0, 3.25, 1e30], np.float32
    )
    keys = np.asarray(_float_sort_key(jnp.asarray(xs)))
    assert (np.diff(keys) >= 0).all()
    # roundtrip after clearing low bits stays within 2^-16 relative
    cleared = jnp.asarray(keys) & ~jnp.int32(127)
    back = np.asarray(_float_from_key(cleared))
    nz = np.abs(xs) > 0
    assert np.all(np.abs(back[nz] - xs[nz]) <= np.abs(xs[nz]) * 2e-5 + 1e-30)


def test_packed_scan_matches_numpy_window_argmax(rng):
    n, d, b = 1024, 128, 8
    x = rng.randn(n, d).astype(np.float32)
    q = rng.randn(b, d).astype(np.float32)
    lane_rank = jnp.asarray(make_lane_rank(n))
    wstat = packed_window_scan(jnp.asarray(q), jnp.asarray(x), lane_rank)
    vals, lanes = unpack_stats(wstat, int_domain=False)
    g = q @ x.T
    gw = g.reshape(b, n // WINDOW, WINDOW)
    np.testing.assert_array_equal(np.asarray(lanes), gw.argmax(-1))
    np.testing.assert_allclose(
        np.asarray(vals), gw.max(-1), rtol=3e-5, atol=1e-6
    )


def test_packed_tie_break_lower_lane(rng):
    # identical rows within a window -> argmax must be the FIRST lane
    n, d = 256, 64
    row = rng.randn(1, d).astype(np.float32)
    x = np.repeat(row, n, axis=0)
    q = rng.randn(2, d).astype(np.float32)
    lane_rank = jnp.asarray(make_lane_rank(n))
    wstat = packed_window_scan(jnp.asarray(q), jnp.asarray(x), lane_rank)
    _, lanes = unpack_stats(wstat, int_domain=False)
    assert (np.asarray(lanes) == 0).all()


def test_int8_packed_scan_window_argmax(rng):
    n, d, b = 512, 64, 4
    x = rng.randn(n, d).astype(np.float32)
    x8, bscale = quantize_block_rows(x)
    q = rng.randn(b, d).astype(np.float32)
    q8 = np.clip(np.round(q * 30), -127, 127).astype(np.int8)
    lane_rank = jnp.asarray(make_lane_rank(n))
    wstat = packed_window_scan(jnp.asarray(q8), jnp.asarray(x8), lane_rank)
    raw, lanes = unpack_stats(wstat, int_domain=True)
    dots = q8.astype(np.int32) @ x8.astype(np.int32).T
    dw = dots.reshape(b, n // WINDOW, WINDOW)
    np.testing.assert_array_equal(np.asarray(lanes), dw.argmax(-1))
    np.testing.assert_array_equal(np.asarray(raw), dw.max(-1))


def test_block_quantize_host_equals_device(rng):
    x = rng.randn(384, 32).astype(np.float32)
    qh, sh = quantize_block_rows(x)
    qd, sd = jax.jit(quantize_block_rows_device)(jnp.asarray(x))
    np.testing.assert_array_equal(qh, np.asarray(qd))
    np.testing.assert_allclose(sh, np.asarray(sd), rtol=1e-6)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_windowed_topk_recall_and_exact_scores(rng, metric):
    n, d, b, k = 131072, 128, 16, 10
    x = rng.randn(n, d).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.randn(b, d).astype(np.float32)
    sq = (x * x).sum(1)
    x8, bscale = quantize_block_rows(x)
    vals, idx = windowed_scan_topk(
        jnp.asarray(q),
        jnp.asarray(x8),
        jnp.asarray(x),
        jnp.asarray(make_lane_rank(n)),
        k,
        metric=metric,
        corpus_sqnorms=jnp.asarray(sq),
        window_scale=jnp.asarray(bscale),
        refine_factor=8,
        selector="top_k",
    )
    g = np.asarray(
        _goodness(jnp.asarray(q), jnp.asarray(x), metric, jnp.asarray(sq), None)
    )
    ref_idx = np.argsort(-g, axis=1, kind="stable")[:, :k]
    recall = np.mean(
        [len(set(map(int, idx[i])) & set(ref_idx[i])) / k for i in range(b)]
    )
    assert recall >= 0.95, recall
    # returned scores are EXACT for the rows returned (refinement)
    got_g = np.take_along_axis(g, np.asarray(idx), axis=1)
    np.testing.assert_allclose(np.asarray(vals), got_g, rtol=1e-4, atol=1e-4)


def test_windowed_topk_bf16_float_domain(rng):
    n, d, b, k = 65536, 128, 8, 10
    x = rng.randn(n, d).astype(np.float32)
    q = rng.randn(b, d).astype(np.float32)
    sq = (x * x).sum(1)
    vals, idx = windowed_scan_topk(
        jnp.asarray(q),
        jnp.asarray(x),  # f32 float-domain scan
        jnp.asarray(x),
        jnp.asarray(make_lane_rank(n)),
        k,
        metric="ip",
        corpus_sqnorms=jnp.asarray(sq),
        refine_factor=8,
        selector="top_k",
    )
    g = q @ x.T
    ref_idx = np.argsort(-g, axis=1, kind="stable")[:, :k]
    recall = np.mean(
        [len(set(map(int, idx[i])) & set(ref_idx[i])) / k for i in range(b)]
    )
    assert recall >= 0.95, recall


def test_windowed_topk_padding_rows_never_surface(rng):
    n, ntotal, d, k = 512, 400, 32, 3
    x = np.zeros((n, d), np.float32)
    x[:ntotal] = rng.randn(ntotal, d) * 0.1 - 2.0  # all-negative scores
    x8, bscale = quantize_block_rows(x)
    q = np.abs(rng.randn(3, d)).astype(np.float32)  # positive queries
    vals, idx = windowed_scan_topk(
        jnp.asarray(q),
        jnp.asarray(x8),
        jnp.asarray(x),
        jnp.asarray(make_lane_rank(n)),
        k,
        metric="ip",
        window_scale=jnp.asarray(bscale),
        ntotal=jnp.asarray(ntotal),
        refine_factor=8,
        selector="top_k",
    )
    assert (np.asarray(idx) < ntotal).all()
    assert np.isfinite(np.asarray(vals)).all()


def test_windowed_topk_gather_free_mode(rng):
    """exact_scores=False ranks by plane values (no candidate-row
    gather): bf16/f32 domain indices match the refined path; scores are
    within the float-key precision of true dots."""
    n, d, b, k = 65536, 128, 8, 10
    x = rng.randn(n, d).astype(np.float32)
    q = rng.randn(b, d).astype(np.float32)
    v_ref, i_ref = windowed_scan_topk(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(x),
        jnp.asarray(make_lane_rank(n)), k, metric="ip",
        refine_factor=8, selector="top_k", exact_scores=True,
    )
    v_nf, i_nf = windowed_scan_topk(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(x),
        jnp.asarray(make_lane_rank(n)), k, metric="ip",
        refine_factor=8, selector="top_k", exact_scores=False,
    )
    # same candidate machinery -> same rows (float-key rounding can
    # only flip near-ties); values within 2^-16 relative
    overlap = np.mean([
        len(set(map(int, i_ref[i])) & set(map(int, i_nf[i]))) / k
        for i in range(b)
    ])
    assert overlap >= 0.9
    g = q @ x.T
    got = np.take_along_axis(g, np.asarray(i_nf), axis=1)
    np.testing.assert_allclose(np.asarray(v_nf), got, rtol=3e-5, atol=1e-5)


def test_gather_free_int8_l2_distances(rng):
    """int8-domain gather-free mode converts plane dots to l2 goodness
    via the (B, k) scalar-sqnorm identity, so _finalize yields
    meaningful approximate distances — close to the true d^2 of the
    returned rows within the block-int8 error budget."""
    n, d, b, k = 65536, 64, 8, 10
    x = rng.randn(n, d).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.randn(b, d).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    sq = np.sum(x * x, axis=1)
    x8, bscale = quantize_block_rows(x)
    v, i = windowed_scan_topk(
        jnp.asarray(q), jnp.asarray(x8), jnp.asarray(x),
        jnp.asarray(make_lane_rank(n)), k, metric="l2",
        corpus_sqnorms=jnp.asarray(sq), window_scale=jnp.asarray(bscale),
        refine_factor=8, selector="top_k", exact_scores=False,
    )
    v, i = np.asarray(v), np.asarray(i)
    # v is l2 GOODNESS (-d^2): compare against the true d^2 of the rows
    # actually returned (approximate scores, exact identity)
    true_d2 = ((q[:, None, :] - x[i]) ** 2).sum(-1)
    np.testing.assert_allclose(-v, true_d2, atol=0.08)
    # and the downstream finalize gives ascending non-negative distances
    from qrag_tpu.ops.topk import _finalize

    dist, _ = _finalize(jnp.asarray(v), jnp.asarray(i), "l2")
    dist = np.asarray(dist)
    assert (dist >= 0).all()
    assert (np.diff(dist, axis=1) >= -1e-4).all()


def test_gather_free_int8_l2_prequantized_queries(rng):
    """Callers that pre-quantize (pass q_scale, `queries` holding int8
    CODES) must get the same approximate distances as the float-query
    call: |q|^2 comes from the dequantized codes, not from summing the
    raw codes (review finding r3 — that was off by q_scale^-2)."""
    from qrag_tpu.ops.quantize import quantize_rows

    n, d, b, k = 65536, 64, 8, 10
    x = rng.randn(n, d).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.randn(b, d).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    sq = np.sum(x * x, axis=1)
    x8, bscale = quantize_block_rows(x)
    common = dict(
        k=k, metric="l2", corpus_sqnorms=jnp.asarray(sq),
        window_scale=jnp.asarray(bscale), refine_factor=8,
        selector="top_k", exact_scores=False,
    )
    v_f, i_f = windowed_scan_topk(
        jnp.asarray(q), jnp.asarray(x8), jnp.asarray(x),
        jnp.asarray(make_lane_rank(n)), **common,
    )
    q8, qs = quantize_rows(jnp.asarray(q))
    v_q, i_q = windowed_scan_topk(
        q8, jnp.asarray(x8), jnp.asarray(x),
        jnp.asarray(make_lane_rank(n)), q_scale=qs, **common,
    )
    np.testing.assert_array_equal(np.asarray(i_f), np.asarray(i_q))
    # same dot plane, same dequantized |q|^2 -> (near-)identical scores
    np.testing.assert_allclose(np.asarray(v_f), np.asarray(v_q), atol=2e-3)
    # and still close to the true d^2 of the returned rows
    i_q = np.asarray(i_q)
    true_d2 = ((q[:, None, :] - x[i_q]) ** 2).sum(-1)
    np.testing.assert_allclose(-np.asarray(v_q), true_d2, atol=0.08)


def test_flat_scan_use_pallas_windowed_route(rng):
    """use_pallas + non-exact mode routes through the windowed packed
    pipeline: results match the XLA approx pipeline's quality class
    with exact scores, valid-row masking included."""
    import jax.numpy as jnp

    from qrag_tpu.ops.topk import flat_scan_topk

    n, d, b, k = 8192, 128, 8, 5
    x = np.zeros((n, d), np.float32)
    n_real = 8000
    x[:n_real] = rng.randn(n_real, d)
    valid = np.zeros(n, bool)
    valid[:n_real] = True
    sq = (x * x).sum(1)
    q = x[rng.choice(n_real, b)] + 0.01 * rng.randn(b, d).astype(np.float32)
    s_w, i_w = flat_scan_topk(
        jnp.asarray(q), jnp.asarray(x), k, metric="l2",
        corpus_sqnorms=jnp.asarray(sq), valid_rows=jnp.asarray(valid),
        use_pallas=True, mode="approx",
    )
    s_e, i_e = flat_scan_topk(
        jnp.asarray(q), jnp.asarray(x), k, metric="l2",
        corpus_sqnorms=jnp.asarray(sq), valid_rows=jnp.asarray(valid),
        mode="exact",
    )
    assert (np.asarray(i_w) < n_real).all()  # masked rows never surface
    overlap = np.mean([
        len(set(map(int, np.asarray(i_w)[i])) & set(map(int, np.asarray(i_e)[i]))) / k
        for i in range(b)
    ])
    assert overlap >= 0.9, overlap
    # scores of returned rows are exact (refinement)
    g = np.asarray(s_e)
    for i in range(b):
        d2 = ((x[np.asarray(i_w)[i]] - q[i]) ** 2).sum(-1)
        np.testing.assert_allclose(np.asarray(s_w)[i], d2, rtol=1e-3, atol=1e-3)


def test_windowed_l2_affine_selection_on_wild_norms(rng):
    """Float-domain l2 selection is exact-goodness-ordered even on
    NON-constant-norm corpora (the affine terms ride the epilogue)."""
    n, d, b, k = 65536, 128, 8, 10
    x = rng.randn(n, d).astype(np.float32)
    x *= rng.uniform(0.1, 10.0, size=(n, 1)).astype(np.float32)
    sq = (x * x).sum(1)
    q = rng.randn(b, d).astype(np.float32)
    vals, idx = windowed_scan_topk(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(x),
        jnp.asarray(make_lane_rank(n)), k, metric="l2",
        corpus_sqnorms=jnp.asarray(sq), refine_factor=8, selector="top_k",
    )
    d2 = ((x[None] - q[:, None]) ** 2).sum(-1) if False else None
    # oracle via goodness
    g = 2 * (q @ x.T) - (q * q).sum(1)[:, None] - sq[None, :]
    ref_idx = np.argsort(-g, axis=1, kind="stable")[:, :k]
    recall = np.mean([
        len(set(map(int, idx[i])) & set(ref_idx[i])) / k for i in range(b)
    ])
    assert recall >= 0.95, recall


