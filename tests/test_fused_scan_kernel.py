"""The fused packed window-scan kernel (ops/pallas/fused_scan.py, the
Pallas Triton route) against its XLA twins, run in interpret mode on
the CPU.  The card compiles the same kernel; chip_smoke.py checks it
there at the real width."""

import numpy as np
import pytest
import jax.numpy as jnp

from qrag_tpu.ops.bounded_topk import (
    bounded_exact_topk,
    packed_window_scan_top2,
    packed_window_scan_top3,
    plane_value_bounds,
    window_maxnorms,
)
from qrag_tpu.ops.pallas.fused_scan import packed_window_scan_kernel, tiles
from qrag_tpu.ops.topk import _goodness
from qrag_tpu.ops.window_scan import (
    WINDOW,
    make_lane_rank,
    packed_window_scan,
    quantize_block_rows,
    windowed_scan_topk,
)


def _twin(planes, q, x, ra, ca, alpha):
    lr = jnp.asarray(make_lane_rank(x.shape[0]))
    if planes == 1:
        return (packed_window_scan(q, x, lr, ra, ca, alpha),)
    if planes == 2:
        return packed_window_scan_top2(q, x, lr, ra, ca, alpha)
    return packed_window_scan_top3(q, x, lr, ra, ca, alpha)


def _affine(x, q, metric, valid):
    alpha, ra, ca = 1.0, None, None
    if metric == "l2":
        alpha = 2.0
        ra = -jnp.sum(x.astype(jnp.float32) ** 2, axis=1)[None, :]
        ca = -jnp.sum(q.astype(jnp.float32) ** 2, axis=1, keepdims=True)
    if valid is not None:
        bias = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)[None, :]
        ra = bias if ra is None else ra + bias
    return alpha, ra, ca


@pytest.mark.parametrize("n", [512, 384])  # an even and an odd window count
@pytest.mark.parametrize("metric,masked", [("ip", False), ("l2", True)])
@pytest.mark.parametrize("b", [1, 3, 130])  # padded query blocks
@pytest.mark.parametrize("planes", [1, 2, 3])
def test_kernel_matches_xla_twin(planes, b, metric, masked, n):
    """Small-integer inputs make every product and partial sum exact
    in f32, so the kernel's chunked accumulation and the twin's single
    product agree bit for bit: the planes must be identical."""
    rng = np.random.default_rng(planes * 1000 + b + n)
    d = 128
    q = jnp.asarray(rng.integers(-2, 3, (b, d)), jnp.bfloat16)
    x = jnp.asarray(rng.integers(-2, 3, (n, d)), jnp.bfloat16)
    valid = rng.random(n) > 0.25 if masked else None
    alpha, ra, ca = _affine(x, q, metric, valid)
    got = packed_window_scan_kernel(
        q, x, ra, ca, alpha=alpha, planes=planes, interpret=True
    )
    want = _twin(planes, q, x, ra, ca, alpha)
    assert len(got) == planes
    for g, w in zip(got, want):
        assert g.shape == (b, n // WINDOW)
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("planes", [2, 3])
def test_kernel_random_data_within_accumulation_margin(planes):
    """On general data the kernel sums d in 64-wide chunks, another
    order than the twin's: plane values may move by accumulation
    noise, never by more than the certificate's accumulation term."""
    rng = np.random.default_rng(planes)
    n, d, b = 2048, 256, 16
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qb, xb = jnp.asarray(q, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16)
    alpha, ra, ca = _affine(xb, qb, "l2", None)
    got = packed_window_scan_kernel(
        qb, xb, ra, ca, alpha=alpha, planes=planes, interpret=True
    )
    want = _twin(planes, qb, xb, ra, ca, alpha)
    for g, w in zip(got, want):
        lo_g, _ = plane_value_bounds(g)
        lo_w, hi_w = plane_value_bounds(w)
        gap = np.abs(np.asarray(lo_g) - np.asarray(lo_w))
        assert (gap <= np.asarray(hi_w - lo_w) + 2 * 2.4e-4).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("k", [10, 100])  # small-k and large-k designs
def test_bounded_kernel_backend_exact(metric, k):
    """The bounded search on the kernel route returns exactly what it
    returns on the XLA route, and that is the oracle's top-k."""
    rng = np.random.default_rng(k)
    n, d, b = 32768, 128, 8
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    sq = (x * x).sum(1)
    args = (
        jnp.asarray(q), jnp.asarray(x, jnp.bfloat16), jnp.asarray(x),
        jnp.asarray(sq), jnp.asarray(window_maxnorms(sq)),
        jnp.asarray(make_lane_rank(n)), k,
    )
    kern = bounded_exact_topk(
        *args, metric=metric, backend="triton", interpret=True
    )
    twin = bounded_exact_topk(*args, metric=metric, backend="xla")
    np.testing.assert_array_equal(np.asarray(kern[1]), np.asarray(twin[1]))
    np.testing.assert_array_equal(np.asarray(kern[0]), np.asarray(twin[0]))
    assert not bool(kern[2])
    g = _goodness(jnp.asarray(q), jnp.asarray(x), metric, jnp.asarray(sq), None)
    oracle = np.argsort(-np.asarray(g), axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(np.asarray(kern[1]), oracle)


def test_windowed_kernel_backend_end_to_end():
    """The one-plane windowed scan on the kernel route matches its XLA
    route (float domain, valid-row mask included)."""
    rng = np.random.default_rng(7)
    n, d, b, k = 16384, 128, 8, 10
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    sq = (x * x).sum(1)
    valid = np.ones(n, bool)
    valid[-300:] = False
    kw = dict(
        metric="l2", corpus_sqnorms=jnp.asarray(sq),
        valid_rows=jnp.asarray(valid), refine_factor=8, selector="top_k",
    )
    args = (
        jnp.asarray(q), jnp.asarray(x, jnp.bfloat16), jnp.asarray(x),
        jnp.asarray(make_lane_rank(n)), k,
    )
    vx, ix = windowed_scan_topk(*args, backend="xla", **kw)
    vk, ik = windowed_scan_topk(*args, backend="triton", interpret=True, **kw)
    np.testing.assert_array_equal(np.asarray(ix), np.asarray(ik))
    np.testing.assert_array_equal(np.asarray(vx), np.asarray(vk))
    assert (np.asarray(ik) < n - 300).all()


def test_windowed_int8_domain_stays_on_xla():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1024, 128)).astype(np.float32)
    x8, scale = quantize_block_rows(x)
    with pytest.raises(ValueError, match="XLA twin only"):
        windowed_scan_topk(
            jnp.asarray(x[:2]), jnp.asarray(x8), jnp.asarray(x),
            jnp.asarray(make_lane_rank(1024)), 5, metric="ip",
            window_scale=jnp.asarray(scale), backend="triton",
        )


@pytest.mark.parametrize(
    "n,d,ok",
    [(1024, 128, True), (384, 64, True), (1000, 128, False),
     (1024, 100, False), (64, 128, False)],
)
def test_kernel_tiling_guard(n, d, ok):
    assert tiles(n, d) is ok
    if not ok:
        with pytest.raises(ValueError, match="shapes must tile"):
            packed_window_scan_kernel(
                jnp.zeros((2, d), jnp.bfloat16),
                jnp.zeros((n, d), jnp.bfloat16), interpret=True,
            )
