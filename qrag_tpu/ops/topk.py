"""Exact flat-index scan + top-k.

This is the retrieval core the reference outsourced to faiss-cpu's C++
``IndexFlatL2`` (``mcp/server/tools/store_in_faiss.py:105``) — except
the reference never actually called ``index.search`` (SURVEY.md §0 gap
1); here search is a first-class jit-compiled op over an HBM-resident
matrix.

Scan: a single matmul (optionally bf16 inputs / f32 accumulation).
L2 uses the identity ||q-x||^2 = ||q||^2 + ||x||^2 - 2 q.x so the whole
metric is matmul + rank-1 corrections, and both metrics reduce to a
descending "goodness" selection.

Selection: ``lax.top_k`` over the score matrix is sort-based, while
``lax.approx_max_k`` is a partial reduction.  Three modes:

  * "exact"    — ``lax.top_k``.  FAISS-identical incl. tie order.
  * "approx"   — ``approx_max_k`` with oversampling + exact re-rank of
                 the candidate set.  ~0.999 recall@10 at rt=0.99, o=2;
                 scores of returned hits are exact.
  * "verified" — approx pass + a one-pass exactness certificate
                 (count of elements strictly better than the k-th
                 returned value must be <= k-1 per row); rows failing
                 the check are re-run with exact top-k.  Exact *values*
                 at approx speed (~26x exact); host-side patch-up, so
                 it lives in the host wrapper, not inside fused jits.

On unit-norm vectors L2 and IP orderings coincide (d^2 = 2 - 2 q.x),
asserted against NumPy oracles in tests.

``flat_scan_topk(use_pallas=True)`` routes non-exact modes through
the memory-lean windowed scan (``ops/window_scan.py``), which on a GPU
runs the fused kernel of ``ops/pallas/fused_scan.py`` and never writes
the (B, N) score matrix to device memory.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from qrag_tpu.ops.window_scan import f32_precision, widen_f32
from qrag_tpu.platform import scan_route

DEFAULT_OVERSAMPLE = 2
DEFAULT_RECALL_TARGET = 0.99
# below this corpus size the sort-based exact top-k is already cheap
APPROX_MIN_ROWS = 4096


def cosine_scores(queries: jnp.ndarray, corpus: jnp.ndarray) -> jnp.ndarray:
    """Cosine similarity (B, d) x (N, d) -> (B, N)."""
    qn = queries / jnp.clip(
        jnp.linalg.norm(queries, axis=-1, keepdims=True), 1e-12
    )
    cn = corpus / jnp.clip(jnp.linalg.norm(corpus, axis=-1, keepdims=True), 1e-12)
    return jnp.dot(qn, cn.T, preferred_element_type=jnp.float32)


def _goodness(
    queries: jnp.ndarray,
    corpus: jnp.ndarray,
    metric: str,
    corpus_sqnorms: Optional[jnp.ndarray],
    valid_rows: Optional[jnp.ndarray],
) -> jnp.ndarray:
    """Descending-is-better score matrix (B, N); L2 goodness = -d^2.

    A product with a float32 operand runs at HIGHEST precision: its
    scores are returned as exact and must match the refine-domain
    einsum (``bounded_topk._exact_scores``), while a DEFAULT f32
    product may run in TF32 on a GPU.  bf16 x bf16 needs no pin (one
    exact pass given the inputs)."""
    dots = jnp.dot(
        queries, corpus.T, preferred_element_type=jnp.float32,
        precision=f32_precision(jnp.result_type(queries, corpus)),
    )
    if metric == "l2":
        if corpus_sqnorms is None:
            corpus_sqnorms = jnp.sum(
                corpus.astype(jnp.float32) * corpus.astype(jnp.float32), axis=-1
            )
        q32 = widen_f32(queries)  # the values the product reads
        q_sq = jnp.sum(q32 * q32, axis=-1, keepdims=True)
        g = 2.0 * dots - q_sq - corpus_sqnorms[None, :].astype(jnp.float32)
    elif metric == "ip":
        g = dots
    else:
        raise ValueError(f"unknown metric {metric!r}")
    if valid_rows is not None:
        g = jnp.where(valid_rows[None, :], g, -jnp.inf)
    return g


def goodness_topk(
    g: jnp.ndarray,
    k: int,
    mode: str = "exact",
    oversample: int = DEFAULT_OVERSAMPLE,
    recall_target: float = DEFAULT_RECALL_TARGET,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-k (descending) of a goodness matrix. Returns (vals, idx)."""
    n = g.shape[-1]
    if mode == "exact" or n < APPROX_MIN_ROWS or k * oversample * 8 >= n:
        return jax.lax.top_k(g, k)
    if mode in ("approx", "verified"):
        kk = min(k * oversample, n)
        sv, si = jax.lax.approx_max_k(g, kk, recall_target=recall_target)
        rv, ri = jax.lax.top_k(sv, k)  # exact re-rank of the candidates
        return rv, jnp.take_along_axis(si, ri, axis=1)
    raise ValueError(f"unknown topk mode {mode!r}")


@functools.partial(jax.jit, static_argnames=("k",))
def _exactness_deficit(g: jnp.ndarray, kth_vals: jnp.ndarray, k: int) -> jnp.ndarray:
    """Per-row certificate: #\\{g > v_k\\} must be <= k-1 for the approx
    result's *values* to be exact.  Returns a (B,) bool "row ok"."""
    cnt = jnp.sum(g > kth_vals[:, None], axis=1)
    return cnt <= k - 1


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "mode", "oversample", "recall_target"),
)
def _scan_topk_device(
    queries,
    corpus,
    corpus_sqnorms,
    valid_rows,
    k: int,
    metric: str,
    mode: str,
    oversample: int,
    recall_target: float,
):
    if mode == "refined":
        # bf16 goodness into the selector (halves the dominant (B, N)
        # HBM traffic of the selection stage), then exact re-scoring of
        # the gathered candidates — exact final scores, recall like
        # "approx" at the oversampled candidate count
        from qrag_tpu.ops.quantize import refine_candidates

        g = _goodness(queries, corpus, metric, corpus_sqnorms, valid_rows)
        kk = min(max(k * max(oversample, 2), k), g.shape[-1])
        sv, si = goodness_topk(
            g.astype(jnp.bfloat16), kk, "approx", 1, recall_target
        )
        vals, idx = refine_candidates(
            queries,
            corpus,
            si,
            sv.astype(jnp.float32),
            k,
            metric=metric,
            corpus_sqnorms=corpus_sqnorms,
        )
        return vals, idx, jnp.ones((g.shape[0],), dtype=bool)
    g = _goodness(queries, corpus, metric, corpus_sqnorms, valid_rows)
    vals, idx = goodness_topk(g, k, mode, oversample, recall_target)
    if mode == "verified":
        ok = _exactness_deficit(g, vals[:, -1], k)
    else:
        ok = jnp.ones((g.shape[0],), dtype=bool)
    return vals, idx, ok


def _finalize(vals: jnp.ndarray, idx: jnp.ndarray, metric: str):
    if metric == "l2":
        invalid = jnp.isneginf(vals)
        dist = jnp.where(invalid, jnp.inf, jnp.maximum(-vals, 0.0))
        return dist, idx
    return vals, idx


@functools.partial(jax.jit, static_argnames=("k",))
def ip_topk(
    queries: jnp.ndarray,
    corpus: jnp.ndarray,
    k: int,
    valid_rows: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact inner-product top-k: (scores desc, indices), (B, k) each."""
    g = _goodness(queries, corpus, "ip", None, valid_rows)
    return jax.lax.top_k(g, k)


@functools.partial(jax.jit, static_argnames=("k",))
def l2_topk(
    queries: jnp.ndarray,
    corpus: jnp.ndarray,
    k: int,
    corpus_sqnorms: Optional[jnp.ndarray] = None,
    valid_rows: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact squared-L2 top-k (ascending distances), FAISS semantics."""
    g = _goodness(queries, corpus, "l2", corpus_sqnorms, valid_rows)
    vals, idx = jax.lax.top_k(g, k)
    return _finalize(vals, idx, "l2")


def flat_scan_topk(
    queries: jnp.ndarray,
    corpus: jnp.ndarray,
    k: int,
    metric: str = "l2",
    corpus_sqnorms: Optional[jnp.ndarray] = None,
    valid_rows: Optional[jnp.ndarray] = None,
    use_pallas: bool = False,
    mode: str = "exact",
    oversample: int = DEFAULT_OVERSAMPLE,
    recall_target: float = DEFAULT_RECALL_TARGET,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Dispatch to the XLA (exact/approx) or windowed scan.

    Returns (scores, indices): distances ascending for "l2", inner
    products descending for "ip".  Jit-traceable (no host sync); the
    "verified" mode's host patch-up lives in
    `DeviceFlatIndex.search` — under jit, "verified" behaves as
    "approx".  "bounded" (norm-bounded window pruning,
    ops/bounded_topk.py) has its own path behind
    `DeviceFlatIndex.search_device`; if it reaches this generic
    dispatch (ineligible shapes) it degrades to "exact" — both are
    exact, this one is just the sort.
    """
    if mode == "bounded":
        mode = "exact"
    if use_pallas:
        n, d = corpus.shape
        if mode != "exact" and n >= 4096 and n % 128 == 0:
            # memory-lean path: packed window scan + exact refinement
            # (ops/window_scan.py; approx-class recall like `mode`)
            from qrag_tpu.ops.window_scan import (
                make_lane_rank,
                windowed_scan_topk,
            )

            vals, idx = windowed_scan_topk(
                queries.astype(jnp.float32),
                corpus,
                corpus,
                jnp.asarray(make_lane_rank(n)),
                k,
                metric=metric,
                corpus_sqnorms=corpus_sqnorms,
                valid_rows=valid_rows,
                refine_factor=max(oversample * 4, 4),
                backend=scan_route(n, d, corpus.dtype),
            )
            return _finalize(vals, idx, metric)
    vals, idx, _ = _scan_topk_device(
        queries,
        corpus,
        corpus_sqnorms,
        valid_rows,
        k,
        metric,
        "approx" if mode == "verified" else mode,
        oversample,
        recall_target,
    )
    return _finalize(vals, idx, metric)


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "oversample", "recall_target")
)
def scan_topk_verified_jit(
    queries: jnp.ndarray,
    corpus: jnp.ndarray,
    k: int,
    metric: str = "l2",
    corpus_sqnorms: Optional[jnp.ndarray] = None,
    valid_rows: Optional[jnp.ndarray] = None,
    oversample: int = 16,
    recall_target: float = DEFAULT_RECALL_TARGET,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Fully-on-device verified-exact top-k — usable INSIDE jit/scan
    (the host-patch-up `scan_topk_verified` cannot be).

    Deep-oversampled approx pass (kk = oversample*k; at o=16 the
    certificate failure rate measured 0/16k rows on 1M x 768 random
    data) + the per-row exactness certificate + a `lax.cond` whole-
    batch exact `top_k` fallback that runs only when any row fails.
    Returns (finalized scores, indices, n_fallback_rows).

    The certificate is a second full pass over the (B, N) goodness.
    It MUST compare against the SAME evaluation of the score
    matrix: recomputing the matmul for the certificate pass (e.g.
    behind an optimization barrier to fuse it) changes bf16->f32
    accumulation order and near-tie comparisons flip, producing
    spurious fallbacks (measured: 480 vs 0 per 16k rows).
    """
    g = _goodness(queries, corpus, metric, corpus_sqnorms, valid_rows)
    kk = min(max(oversample * k, k), g.shape[-1])
    sv, si = jax.lax.approx_max_k(g, kk, recall_target=recall_target)
    vals, ri = jax.lax.top_k(sv, k)
    idx = jnp.take_along_axis(si, ri, axis=1)
    ok = _exactness_deficit(g, vals[:, -1], k)
    n_bad = jnp.sum(~ok)
    vals, idx = jax.lax.cond(
        n_bad > 0,
        lambda: tuple(jax.lax.top_k(g, k)),
        lambda: (vals, idx),
    )
    fin_vals, fin_idx = _finalize(vals, idx, metric)
    return fin_vals, fin_idx, n_bad


def scan_topk_verified(
    queries: jnp.ndarray,
    corpus: jnp.ndarray,
    k: int,
    metric: str = "l2",
    corpus_sqnorms: Optional[jnp.ndarray] = None,
    valid_rows: Optional[jnp.ndarray] = None,
    oversample: int = DEFAULT_OVERSAMPLE,
    recall_target: float = DEFAULT_RECALL_TARGET,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Host-level verified-exact scan: approx pass + certificate +
    exact re-run of only the failing rows.  Returns numpy
    (scores, indices, n_fallback_rows); score *values* match the exact
    scan (tie index order may differ on exactly-tied scores).
    """
    vals, idx, ok = _scan_topk_device(
        queries,
        corpus,
        corpus_sqnorms,
        valid_rows,
        k,
        metric,
        "verified",
        oversample,
        recall_target,
    )
    ok_np = np.asarray(ok)
    # np.array (not asarray): jax arrays convert to READ-ONLY views and
    # the fallback patch-up below writes in place
    vals_np = np.array(vals)
    idx_np = np.array(idx)
    n_bad = int((~ok_np).sum())
    if n_bad:
        bad_rows = np.nonzero(~ok_np)[0]
        fix_vals, fix_idx, _ = _scan_topk_device(
            queries[bad_rows],
            corpus,
            corpus_sqnorms,
            valid_rows,
            k,
            metric,
            "exact",
            oversample,
            recall_target,
        )
        vals_np[bad_rows] = np.asarray(fix_vals)
        idx_np[bad_rows] = np.asarray(fix_idx)
    s, i = _finalize(jnp.asarray(vals_np), jnp.asarray(idx_np), metric)
    return np.asarray(s), np.asarray(i), n_bad
