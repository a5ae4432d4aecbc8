"""Int8 symmetric quantization for the retrieval scan.

Narrower arithmetic than the bf16 scan: int8 halves the bytes read per
row, and a GPU's tensor cores run int8 at twice the bf16 rate.
Scheme:

  * corpus: per-row symmetric scale  s_i = max|x_i| / 127,
    q_i = round(x_i / s_i)  (int8)
  * queries: per-query scale likewise
  * scores:  dot(x_i, q_b) ≈ s_i * t_b * (Q8 @ X8^T)[b, i]  with the
    int32-accumulating matmul
  * selection: approx top-C on the rescaled scores, then (optionally)
    exact refinement: gather the true-precision candidate rows and
    re-score — recall governed by C, final scores exact.

This is the standard quantized-MIPS recipe (cf. the FAISS/ScaNN
lineage — PAPERS.md); the reference itself only ever used exact f32
flat scans.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def quantize_rows(x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-row symmetric int8: returns (q8 (N, d), scales (N,) f32)."""
    x = jnp.asarray(x, jnp.float32)
    absmax = jnp.max(jnp.abs(x), axis=-1)
    scale = jnp.where(absmax > 0, absmax / 127.0, 1.0)
    q = jnp.clip(jnp.round(x / scale[..., None]), -127, 127).astype(jnp.int8)
    return q, scale


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def int8_scan_topk(
    q8: jnp.ndarray,  # (B, d) int8
    q_scale: jnp.ndarray,  # (B,) f32
    x8: jnp.ndarray,  # (N, d) int8
    x_scale: jnp.ndarray,  # (N,) f32
    k: int,
    metric: str = "ip",
    corpus_sqnorms: Optional[jnp.ndarray] = None,  # f32 true sqnorms (l2)
    query_sqnorms: Optional[jnp.ndarray] = None,
    valid_rows: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Quantized scan + approx top-k.  Returns ("goodness" desc, idx).

    Scores are approximate (int8 dot, true scales); for "l2" the
    goodness is -(qsq + xsq - 2*dot) with exact norms, so the only
    error is in the cross term.
    """
    dots = jax.lax.dot_general(
        q8,
        x8,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).astype(jnp.float32)
    dots = dots * q_scale[:, None] * x_scale[None, :]
    if metric == "l2":
        if corpus_sqnorms is None or query_sqnorms is None:
            raise ValueError("l2 needs true sqnorms for both sides")
        g = 2.0 * dots - query_sqnorms[:, None] - corpus_sqnorms[None, :]
    else:
        g = dots
    if valid_rows is not None:
        g = jnp.where(valid_rows[None, :], g, -jnp.inf)
    from qrag_tpu.ops.topk import goodness_topk

    # bf16 goodness into the selector: halves the (B, N) HBM traffic
    # that dominates the selection stage; exact
    # refinement downstream restores exact final scores
    vals, idx = goodness_topk(g.astype(jnp.bfloat16), k, mode="approx", oversample=1)
    return vals.astype(jnp.float32), idx


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def refine_candidates(
    queries_f: jnp.ndarray,  # (B, d) f32/bf16 true queries
    corpus_f: jnp.ndarray,  # (N, d) true-precision corpus
    idx: jnp.ndarray,  # (B, C) candidate indices
    cand_goodness: jnp.ndarray,  # (B, C) quantized goodness (-inf invalid)
    k: int,
    metric: str = "ip",
    corpus_sqnorms: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact re-scoring of gathered candidates → final top-k.
    Returns goodness (desc) and indices."""
    cand = jnp.take(corpus_f, idx, axis=0).astype(jnp.float32)  # (B, C, d)
    q32 = queries_f.astype(jnp.float32)
    dots = jnp.einsum(
        "bd,bcd->bc", q32, cand, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    if metric == "l2":
        if corpus_sqnorms is None:
            xsq = jnp.sum(cand * cand, axis=-1)
        else:
            xsq = jnp.take(corpus_sqnorms, idx, axis=0)
        qsq = jnp.sum(q32 * q32, axis=-1, keepdims=True)
        g = 2.0 * dots - qsq - xsq
    else:
        g = dots
    g = jnp.where(jnp.isneginf(cand_goodness), -jnp.inf, g)
    vals, sel = jax.lax.top_k(g, k)
    return vals, jnp.take_along_axis(idx, sel, axis=1)
