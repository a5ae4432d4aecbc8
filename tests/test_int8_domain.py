"""Own-domain int8 exact top-k (`ops/int8_domain.py`).

The contract: exact top-k (values AND indices, ties -> lower global
index) of score(q, r) = fl32((t*s_w) * f32(<q8, x8_r>_int32)) — the
dequantized-code domain.  The oracle below evaluates that expression
step-by-step in numpy f32 from the SAME rounded query the op uses, so
any drift (plane, refine, patch, fallback) is a hard failure.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qrag_tpu.ops.int8_domain import (
    exact_topk_int8_domain,
    full_topk_int8_domain,
    quantize_query_int8,
    row_int_sqnorms,
)
from qrag_tpu.ops.window_scan import (
    WINDOW,
    make_lane_rank,
    quantize_block_rows_device,
)


def _quantize(x32):
    q8, scales = jax.jit(quantize_block_rows_device)(jnp.asarray(x32))
    isq = jax.jit(row_int_sqnorms)(q8)
    return q8, scales, isq


def _oracle(q32, q8_dev, t_dev, x8, scales, isq, k, metric, valid=None):
    """Numpy own-domain top-k from the op's OWN rounded query (the
    contract is 'exact given the rounding'; query rounding itself is
    covered by test_query_quantization_matches_numpy)."""
    q8 = np.asarray(q8_dev, np.int32)
    t = np.asarray(t_dev, np.float32)
    x8 = np.asarray(x8, np.int32)
    scales = np.asarray(scales, np.float32)
    isq = np.asarray(isq, np.int64)
    n = x8.shape[0]
    scale_rows = np.repeat(scales, WINDOW).astype(np.float32)
    dots = (q8 @ x8.T).astype(np.int64)
    assert np.abs(dots).max() < 2 ** 31  # int32-exact regime
    scale = (t[:, None] * scale_rows[None, :]).astype(np.float32)
    s = scale * dots.astype(np.float32)
    if metric == "l2":
        qsq = (t * t).astype(np.float32) * np.sum(
            q8 * q8, axis=1
        ).astype(np.float32)
        xsq = (scale_rows * scale_rows) * isq.astype(np.float32)
        g = (np.float32(2.0) * s - qsq[:, None]) - xsq[None, :]
    else:
        g = s
    g = g.astype(np.float32)
    if valid is not None:
        g = np.where(np.asarray(valid)[None, :], g, -np.inf)
    order = np.argsort(-g, axis=1, kind="stable")[:, :k]
    return (
        np.take_along_axis(g, order, axis=1),
        order.astype(np.int32),
        g,
    )


# One f32 ulp of slack: XLA may contract the scoring expression's
# multiply-add into an fma (observed on the chunked full-sort path,
# ~1e-7 relative vs numpy's op-by-op rounding) — the same sub-noise
# cross-path drift class documented on ops/cluster_topk, 3 orders of
# magnitude tighter here because the int dot itself is exact
_ULP_RTOL = 4e-7


def _assert_tie_tolerant(g, idx, oi, ov):
    if np.array_equal(idx, oi):
        return
    rows, pos = np.where(idx != oi)
    tol = _ULP_RTOL * (1.0 + np.abs(ov[rows, pos]))
    gap = np.abs(g[rows, idx[rows, pos]] - ov[rows, pos])
    assert (gap <= tol).all(), (
        f"non-tie index mismatch: rows {rows}, pos {pos}, gap {gap}"
    )


def _check(q32, x8, scales, isq, k, metric, valid=None, **op_kw):
    q8_dev, t_dev = jax.jit(quantize_query_int8)(
        jnp.asarray(q32, jnp.float32)
    )
    ov, oi, g = _oracle(
        q32, q8_dev, t_dev, x8, scales, isq, k, metric, valid
    )
    lane_rank = jnp.asarray(make_lane_rank(x8.shape[0]))
    vals, idx, fb, npatch, esc = exact_topk_int8_domain(
        jnp.asarray(q32, jnp.float32),
        x8,
        scales,
        isq,
        lane_rank,
        k,
        metric=metric,
        valid_rows=None if valid is None else jnp.asarray(valid),
        **op_kw,
    )
    _assert_tie_tolerant(g, np.asarray(idx), oi, ov)
    np.testing.assert_allclose(
        np.asarray(vals), ov, rtol=_ULP_RTOL, atol=0
    )
    return fb, npatch, esc


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_random_exact(metric):
    rng = np.random.default_rng(0)
    # nw >> k (the design's regime — at nw ~ k the certificates
    # correctly flood and the full sort serves, still exact)
    n, d, b, k = 65536, 128, 8, 10
    x = rng.standard_normal((n, d), np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((b, d), np.float32)
    x8, scales, isq = _quantize(x)
    fb, _, esc = _check(q, x8, scales, isq, k, metric)
    assert not bool(fb)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_duplicate_ties_escalate_exact(metric):
    # 16 distinct rows tiled 128x: every top value ties across >C
    # windows — escalation and/or the full-sort fallback must fire,
    # and the index tie order must survive it
    rng = np.random.default_rng(1)
    base = rng.standard_normal((16, 64), np.float32)
    x = np.tile(base, (128, 1))
    q = rng.standard_normal((4, 64), np.float32)
    x8, scales, isq = _quantize(x)
    fb, _, esc = _check(q, x8, scales, isq, 10, metric, candidates=16)
    assert bool(fb) or bool(esc)  # ties exceeded the lean budget


def test_window_collision_patch():
    # plant the global top-2 rows in ONE window: row 2 only reachable
    # through the cert_b whole-window patch layer
    rng = np.random.default_rng(2)
    n, d = 8192, 128
    x = rng.standard_normal((n, d), np.float32)
    x /= 10.0 * np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((2, d), np.float32)
    qn = q[0] / np.linalg.norm(q[0])
    x[130] = qn * 1.0  # window 1, best
    x[131] = qn * 0.999  # window 1, second best
    x8, scales, isq = _quantize(x)
    fb, npatch, _ = _check(q, x8, scales, isq, 5, "ip")
    assert not bool(fb)
    assert int(npatch) >= 1


def test_valid_rows_negative_corpus():
    # all-negative ip scores: zero PADDING codes carry dot 0, which
    # would beat every real row if validity masking leaked
    rng = np.random.default_rng(3)
    n, d, ntotal = 16384, 128, 15000
    q = np.abs(rng.standard_normal((4, d)).astype(np.float32))
    x = -np.abs(rng.standard_normal((n, d)).astype(np.float32))
    x[ntotal:] = 0.0
    valid = np.arange(n) < ntotal
    x8, scales, isq = _quantize(x)
    _check(q, x8, scales, isq, 10, "ip", valid=valid)
    _check(q, x8, scales, isq, 10, "l2", valid=valid)


def test_single_query():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((16384, 128), np.float32)
    q = rng.standard_normal((1, 128), np.float32)
    x8, scales, isq = _quantize(x)
    _check(q, x8, scales, isq, 10, "l2")


def test_clip_fail_falls_back_exact():
    # adversarial alignment: all-127 codes at d=768 push |dot| past
    # the 2^23 plane clamp — bounds void, the full sort must serve
    n, d = 1024, 768
    x = np.ones((n, d), np.float32)
    x[:, 0] += np.arange(n, dtype=np.float32) / n  # break exact ties
    q = np.ones((2, d), np.float32)
    x8, scales, isq = _quantize(x)
    fb, _, _ = _check(q, x8, scales, isq, 5, "ip")
    assert bool(fb)


def test_full_sort_small_corpus():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((256, 64), np.float32)
    q = rng.standard_normal((3, 64), np.float32)
    x8, scales, isq = _quantize(x)
    q8_dev, t_dev = jax.jit(quantize_query_int8)(jnp.asarray(q))
    ov, oi, g = _oracle(q, q8_dev, t_dev, x8, scales, isq, 10, "l2")
    vals, idx = full_topk_int8_domain(
        jnp.asarray(q), x8, scales, isq, 10, metric="l2"
    )
    _assert_tie_tolerant(g, np.asarray(idx), oi, ov)
    np.testing.assert_allclose(
        np.asarray(vals), ov, rtol=_ULP_RTOL, atol=0
    )


def test_query_quantization_matches_numpy():
    rng = np.random.default_rng(7)
    q = rng.standard_normal((16, 96)).astype(np.float32)
    q[3] = 0.0  # zero query: scale 1.0, codes 0
    q8, t = jax.jit(quantize_query_int8)(jnp.asarray(q))
    am = np.max(np.abs(q), axis=1)
    tn = np.where(am > 0, (am / np.float32(127.0)), np.float32(1.0))
    qn = np.clip(np.round(q / tn[:, None]), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(np.asarray(t), tn.astype(np.float32))
    np.testing.assert_array_equal(np.asarray(q8), qn)


class TestQuantizedIndexDomainExact:
    def _index(self, x, **kw):
        from qrag_tpu.index.quantized_index import QuantizedFlatIndex

        idx = QuantizedFlatIndex(
            d=x.shape[1], metric=kw.pop("metric", "l2"),
            scan="window", domain_exact=True, **kw,
        )
        idx.add(x)
        return idx

    def test_search_matches_op(self):
        rng = np.random.default_rng(8)
        x = rng.standard_normal((4096, 128), np.float32)
        q = rng.standard_normal((5, 128), np.float32)
        idx = self._index(x)
        res = idx.search(q, k=10)
        snap = idx.device_buffers()
        x8, scales, _ = snap.extras["int8w"]
        isq = snap.extras["int8w_isq"]
        q8_dev, t_dev = jax.jit(quantize_query_int8)(jnp.asarray(q))
        ov, oi, g = _oracle(
            q, q8_dev, t_dev, x8, scales, isq, 10, "l2",
            valid=np.asarray(snap.valid),
        )
        _assert_tie_tolerant(g, res.indices, oi, ov)
        # l2 API scores are distances: goodness negated at _finalize
        np.testing.assert_allclose(
            res.scores, -ov, rtol=_ULP_RTOL, atol=0
        )

    def test_append_then_search(self):
        rng = np.random.default_rng(9)
        x = rng.standard_normal((2048, 128), np.float32)
        idx = self._index(x[:1024])
        idx.add(x[1024:])
        q = rng.standard_normal((3, 128), np.float32)
        res = idx.search(q, k=10)
        snap = idx.device_buffers()
        x8, scales, _ = snap.extras["int8w"]
        isq = snap.extras["int8w_isq"]
        q8_dev, t_dev = jax.jit(quantize_query_int8)(jnp.asarray(q))
        ov, oi, g = _oracle(
            q, q8_dev, t_dev, x8, scales, isq, 10, "l2",
            valid=np.asarray(snap.valid),
        )
        _assert_tie_tolerant(g, res.indices, oi, ov)

    def test_small_corpus_routes_full_sort(self):
        rng = np.random.default_rng(10)
        x = rng.standard_normal((200, 64), np.float32)
        idx = self._index(x)
        q = rng.standard_normal((2, 64), np.float32)
        res = idx.search(q, k=5)
        assert res.indices.shape == (2, 5)
        assert (res.indices >= 0).all() and (res.indices < 200).all()

    def test_layout_reports_mode(self):
        rng = np.random.default_rng(11)
        idx = self._index(
            rng.standard_normal((1024, 64), np.float32)
        )
        lay = idx.layout()
        assert lay["domain_exact"] is True

    def test_requires_window_scan(self):
        from qrag_tpu.index.quantized_index import QuantizedFlatIndex

        with pytest.raises(ValueError, match="domain_exact"):
            QuantizedFlatIndex(d=64, scan="row", domain_exact=True)
