"""Every f32 product whose result is certified, compared or returned as
an exact score carries Precision.HIGHEST (a DEFAULT f32 product may run
in TF32 on a GPU, far outside the certificates' margins).  Checked on
the traced jaxprs, so it holds for whatever backend compiles them."""

import jax
import jax.extend.core
import jax.numpy as jnp
import numpy as np
import pytest

from qrag_tpu.ops import bounded_topk as bt
from qrag_tpu.ops.cluster_topk import build_clustered_groups, cluster_pruned_topk
from qrag_tpu.ops.quantize import refine_candidates
from qrag_tpu.ops.topk import l2_topk
from qrag_tpu.ops.window_scan import (
    make_lane_rank,
    quantize_block_rows_device,
    windowed_scan_topk,
)

HIGHEST = jax.lax.Precision.HIGHEST


def _sub_jaxprs(params):
    for v in params.values():
        for item in v if isinstance(v, (tuple, list)) else (v,):
            if isinstance(item, jax.extend.core.ClosedJaxpr):
                yield item.jaxpr
            elif isinstance(item, jax.extend.core.Jaxpr):
                yield item


def _f32_dots(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and any(
            v.aval.dtype == jnp.float32 for v in eqn.invars
        ):
            yield eqn
        for sub in _sub_jaxprs(eqn.params):
            yield from _f32_dots(sub)


N, D, B = 16384, 128, 8


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    sq = (x * x).sum(1)
    return jnp.asarray(q), jnp.asarray(x), jnp.asarray(sq)


def _bounded(scan_dtype, k):
    def f(q, x, sq):
        return bt.bounded_exact_topk(
            q, x.astype(scan_dtype), x, sq, bt.window_maxnorms_device(sq),
            jnp.asarray(make_lane_rank(N)), k, metric="l2",
        )
    return f


def _bounded_int8(q, x, sq):
    x8, ws = quantize_block_rows_device(x)
    mx = bt.window_maxnorms_device(sq)
    return bt.bounded_exact_topk_int8(
        q, x8, ws, x, sq, mx, bt.window_minsqnorms_device(sq),
        bt.window_quant_residuals_device(x, x8, ws),
        jnp.asarray(make_lane_rank(N)), 10, metric="l2",
    )


def _refine(q, x, sq):
    idx = jnp.tile(jnp.arange(40, dtype=jnp.int32)[None], (B, 1))
    return refine_candidates(
        q, x, idx, jnp.zeros((B, 40)), 10, metric="l2", corpus_sqnorms=sq
    )


def _windowed(q, x, sq):
    return windowed_scan_topk(
        q, x, x, jnp.asarray(make_lane_rank(N)), 10, metric="l2",
        corpus_sqnorms=sq,
    )


CASES = {
    "bounded bf16 scan k=10": _bounded(jnp.bfloat16, 10),
    "bounded bf16 scan k=100": _bounded(jnp.bfloat16, 100),
    "bounded f32 scan": _bounded(jnp.float32, 10),
    "bounded int8 scan": _bounded_int8,
    "refine_candidates": _refine,
    "exact sort": lambda q, x, sq: l2_topk(q, x, 10, corpus_sqnorms=sq),
    "exact sort in row slices": lambda q, x, sq: bt._exact_full_sort(
        q, x, sq, 10, "l2", None
    ),
    "windowed f32 scan": _windowed,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_f32_products_are_highest(data, name):
    jaxpr = jax.make_jaxpr(CASES[name])(*data).jaxpr
    dots = list(_f32_dots(jaxpr))
    assert dots, "no f32 product traced"
    for eqn in dots:
        prec = eqn.params["precision"]
        assert prec is not None and all(p == HIGHEST for p in prec), (
            f"{name}: f32 dot_general at precision {prec}"
        )


def test_clustered_accelerator_products_are_highest():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8192, 64)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    groups = build_clustered_groups(jnp.asarray(x), group_rows=512)
    q = jnp.asarray(x[:4])
    jaxpr = jax.make_jaxpr(
        lambda qq: cluster_pruned_topk(qq, groups, 10, metric="l2")
    )(q).jaxpr
    dots = list(_f32_dots(jaxpr))
    assert dots
    for eqn in dots:
        prec = eqn.params["precision"]
        assert prec is not None and all(p == HIGHEST for p in prec)


def _bounds_q32(q, x, sq):
    return bt.window_bounds_bf16(
        q.astype(jnp.bfloat16), x.astype(jnp.bfloat16), x, sq,
        bt.window_maxnorms_device(sq), jnp.asarray(make_lane_rank(N)),
    )[0]


def _goodness_bf16(q, x, sq):
    from qrag_tpu.ops.topk import _goodness

    return _goodness(q.astype(jnp.bfloat16), x.astype(jnp.bfloat16), "l2", sq, None)


@pytest.mark.parametrize("fn", [_bounds_q32, _goodness_bf16], ids=["bounds", "goodness"])
def test_store_dtype_query_is_rounded_again_before_the_refine(data, fn):
    """A query rounded to bf16 inside the caller's graph is rounded again
    where it is widened to f32: the GPU compiler may drop an
    f32 -> bf16 -> f32 round trip as excess precision, and the product
    would then read another query than the refine, the norms and the
    margins."""
    q, x, sq = data
    eqns = [e for e in jax.make_jaxpr(lambda q: fn(q, x, sq))(q).jaxpr.eqns
            if e.primitive.name == "reduce_precision"]
    assert [(e.params["exponent_bits"], e.params["mantissa_bits"])
            for e in eqns] == [(8, 7)]
    if fn is _bounds_q32:
        np.testing.assert_array_equal(
            np.asarray(fn(q, x, sq)),
            np.asarray(q.astype(jnp.bfloat16).astype(jnp.float32)),
        )
