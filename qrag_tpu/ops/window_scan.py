"""Windowed scan + selection: the memory-lean retrieval pipeline.

Each 128-row window of the score matrix is reduced to ONE int32 that
carries (score, lane) packed together:

    dots   = Q @ X^T                      (int8 x int8 -> int32
                                           or bf16 -> f32)
    key    = order-preserving int32 of the score  (int: dots << 7;
             f32: sign-fold bitcast with the low 7 mantissa bits
             sacrificed — refinement restores exact scores)
    packed = (key & ~127) | (127 - lane)  (ties -> LOWER lane wins)
    wstat  = max over each 128-lane window -> (B, N/128) int32

Selection then works on planes 128x smaller: top-C windows per query
(`approx_max_k` or `top_k`), unpack (window, lane) -> global row ids,
and exactly re-score the C gathered candidates
(``ops.quantize.refine_candidates``) — returned scores are EXACT;
recall is the approx class (window collisions), controlled by C.

Int8 corpora use PER-WINDOW (128-row block) scales so raw int32 dots
order correctly within a window; the scale rejoins at the plane level.
The same windows serve both quantization groups and selection units.

Backends: ``packed_window_scan`` here is the XLA twin (the product
and the epilogue are separate XLA operations, so the (B, N) scores
pass through device memory) and the reference; on a GPU the float
domain runs the fused kernel of ``ops/pallas/fused_scan.py`` instead,
which keeps the scores in registers.  Device times: not measured on
a GPU yet.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

WINDOW = 128
_I32_MIN = np.int32(-(2 ** 31))  # a NumPy scalar: a literal, not a captured array


def _float_sort_key(x_f32: jnp.ndarray) -> jnp.ndarray:
    """Order-preserving f32 -> int32 (IEEE sign-fold)."""
    u = jax.lax.bitcast_convert_type(x_f32, jnp.int32)
    return jnp.where(u < 0, _I32_MIN - u, u)


def _float_from_key(key: jnp.ndarray) -> jnp.ndarray:
    """Inverse of `_float_sort_key` (low bits already cleared)."""
    u = jnp.where(key < 0, _I32_MIN - key, key)
    return jax.lax.bitcast_convert_type(u, jnp.float32)


_INT_CLAMP = (1 << 23) - 1  # |key| <= 2^23 so << 7 never overflows


def f32_precision(dtype):
    """Precision for a scan product with ``dtype`` inputs: HIGHEST for
    float32, whose DEFAULT product may run in TF32 on a GPU (about 10
    mantissa bits — far outside the certificates' f32 margins); None
    for bf16 and int8, whose single pass is exact given the inputs."""
    return jax.lax.Precision.HIGHEST if dtype == jnp.float32 else None


def widen_f32(x: jnp.ndarray) -> jnp.ndarray:
    """``x`` as float32, holding exactly values of ``x``'s own dtype.
    Inside one graph the GPU compiler drops an f32 -> bf16 -> f32 round
    trip as excess precision, so a query rounded to the store dtype
    upstream in the same graph would come back unrounded; rounding
    again keeps every reader of the query on the same values."""
    x32 = x.astype(jnp.float32)
    if jnp.issubdtype(x.dtype, jnp.floating) and jnp.finfo(x.dtype).bits < 32:
        fi = jnp.finfo(x.dtype)
        x32 = jax.lax.reduce_precision(
            x32, exponent_bits=fi.nexp, mantissa_bits=fi.nmant
        )
    return x32


def packed_window_scan(
    queries: jnp.ndarray,  # (B, d) int8 or bf16/f32
    corpus: jnp.ndarray,  # (N, d) same family; N % 128 == 0
    lane_rank: jnp.ndarray,  # (1, N) int32: 127 - (col % 128), precomputed
    row_add: Optional[jnp.ndarray] = None,  # (1, N) f32 (float domain only)
    col_add: Optional[jnp.ndarray] = None,  # (B, 1) f32 (float domain only)
    alpha: float = 1.0,  # float-domain dots multiplier (2.0 for l2)
) -> jnp.ndarray:
    """(B, N/128) packed int32 window stats; the (B, N) score matrix
    lives only inside the fused matmul epilogue.

    Float domain scores ``alpha*dots + row_add + col_add`` (covers the
    exact -d^2 l2 goodness); the int domain packs raw int32 dots
    (clamped to 24 bits — beyond that, d*127^2 overflows the shifted
    key; clamped scores tie at the extreme and refinement still
    re-scores exactly)."""
    b = queries.shape[0]
    n = corpus.shape[0]
    nw = n // WINDOW
    if corpus.dtype == jnp.int8:
        dots = jax.lax.dot_general(
            queries,
            corpus,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        key = jnp.clip(dots, -_INT_CLAMP, _INT_CLAMP) << 7
    else:
        dots = jax.lax.dot_general(
            queries,
            corpus,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=f32_precision(queries.dtype),
        )
        if alpha != 1.0:
            dots = dots * alpha
        if row_add is not None:
            dots = dots + row_add
        if col_add is not None:
            dots = dots + col_add
        key = _float_sort_key(dots) & ~jnp.int32(127)
    packed = key | lane_rank
    return jnp.max(packed.reshape(b, nw, WINDOW), axis=2)


def make_lane_rank(n: int) -> np.ndarray:
    """(1, N) int32 lane-rank plane: 127 - (col % 128), so packed ties
    resolve to the LOWER global index (lax.top_k parity)."""
    return (127 - (np.arange(n, dtype=np.int32) % WINDOW))[None, :]


def unpack_stats(
    wstat: jnp.ndarray, int_domain: bool, int_shift: int = 7
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(B, NW) packed -> (approx score f32/int32-scaled, lane idx)."""
    lane = WINDOW - 1 - (wstat & (WINDOW - 1))
    key = wstat & ~jnp.int32(WINDOW - 1)
    if int_domain:
        return (wstat >> int_shift).astype(jnp.float32), lane
    return _float_from_key(key), lane


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "metric", "refine_factor", "selector", "backend", "exact_scores",
        "interpret",
    ),
)
def windowed_scan_topk(
    queries: jnp.ndarray,  # (B, d) f32 true queries
    corpus_scan: jnp.ndarray,  # (N, d) int8 / bf16 / f32 scan form
    corpus_f: jnp.ndarray,  # (N, d) true-precision rows for refinement
    lane_rank: jnp.ndarray,  # (1, N) from make_lane_rank
    k: int,
    metric: str = "l2",
    corpus_sqnorms: Optional[jnp.ndarray] = None,
    window_scale: Optional[jnp.ndarray] = None,  # (NW,) int8 block scales
    q_scale: Optional[jnp.ndarray] = None,  # (B,) int8 query scales
    ntotal: Optional[jnp.ndarray] = None,  # scalar; rows >= are padding
    valid_rows: Optional[jnp.ndarray] = None,  # (N,) bool; float domain only
    refine_factor: int = 8,
    selector: str = "auto",
    # "xla" (packed_window_scan) | "triton" (ops/pallas/fused_scan.py,
    # float domain; callers take it from qrag_tpu.platform.scan_route);
    # interpret runs the kernel on the CPU (tests only)
    backend: str = "xla",
    exact_scores: bool = True,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fused scan -> top-C windows -> exact re-score -> top-k.

    Returns (goodness desc, indices) like ``_scan_topk_device`` —
    finalize to distances at the API edge.  Selection ranks by dot
    product (for l2 this equals the true order on constant-norm rows,
    e.g. normalized corpora; refinement applies the exact metric either
    way, so returned SCORES are always exact).

    ``exact_scores=False`` skips the candidate-row re-score entirely —
    the GATHER-FREE mode: returned scores are the scan-domain dot
    products straight from the packed planes (bf16/f32 domain: within
    2^-16 relative of the scan's own precision; int8 domain:
    block-quantized, ~1% — document to callers).  Saves the (B, C)
    random-row gather and never touches corpus_f; metric must tolerate
    dot-product scores ("ip", or l2 on constant-norm corpora)."""
    n = corpus_scan.shape[0]
    nw = n // WINDOW
    int_domain = corpus_scan.dtype == jnp.int8
    if int_domain and backend != "xla":
        raise ValueError("the int8 windowed scan runs on the XLA twin only")

    # float domain + l2: fold the exact goodness corrections into the
    # scan epilogue so SELECTION is exact-l2-ordered even on
    # non-constant-norm corpora (the int domain can't — per-window
    # scales; its l2 selection ranks by dot, refinement applies the
    # true metric)
    alpha, row_add, col_add = 1.0, None, None
    if not int_domain and metric == "l2" and corpus_sqnorms is not None:
        alpha = 2.0
        row_add = -corpus_sqnorms[None, :].astype(jnp.float32)
        q32_tmp = queries.astype(jnp.float32)
        col_add = -jnp.sum(q32_tmp * q32_tmp, axis=-1, keepdims=True)
    if valid_rows is not None:
        if int_domain:
            raise ValueError(
                "valid_rows masks the float domain only; the int8 path "
                "uses `ntotal` (trailing-padding contract)"
            )
        # -inf bias: masked rows' keys restore to -inf -> the existing
        # non-finite candidate filtering drops them
        bias = jnp.where(valid_rows.astype(bool), 0.0, -jnp.inf)[None, :]
        row_add = bias if row_add is None else row_add + bias

    def scan(q_in):
        if backend == "triton":
            from qrag_tpu.ops.pallas.fused_scan import (
                packed_window_scan_kernel,
            )

            return packed_window_scan_kernel(
                q_in, corpus_scan, row_add=row_add, col_add=col_add,
                alpha=alpha, planes=1, interpret=interpret,
            )[0]
        return packed_window_scan(
            q_in, corpus_scan, lane_rank,
            row_add=row_add, col_add=col_add, alpha=alpha,
        )

    if int_domain:
        from qrag_tpu.ops.quantize import quantize_rows

        if q_scale is None:
            q8, q_scale = quantize_rows(queries.astype(jnp.float32))
        else:
            q8 = queries
        wstat = scan(q8)
        raw, lanes = unpack_stats(wstat, int_domain=True)
        # rejoin scales at the PLANE level (per-window corpus scale x
        # per-query scale) — ordering within a window was already
        # correct because rows in a window share one scale
        wvals = raw * (window_scale[None, :] * q_scale[:, None])
    else:
        wstat = scan(queries.astype(corpus_scan.dtype))
        wvals, lanes = unpack_stats(wstat, int_domain=False)

    window_base = (jnp.arange(nw, dtype=jnp.int32) * WINDOW)[None, :]
    wind_idx = window_base + lanes  # (B, NW) global row of each window max

    if ntotal is not None:
        # windows fully past ntotal can never contribute
        valid_w = (window_base[0] < ntotal)[None, :]
        wvals = jnp.where(valid_w, wvals, -jnp.inf)

    c = min(refine_factor * k, nw)
    use_approx = selector == "approx" or (
        selector == "auto" and nw >= 4096 and c * 8 < nw
    )
    if use_approx:
        sv, si = jax.lax.approx_max_k(wvals, c, recall_target=0.99)
    else:
        sv, si = jax.lax.top_k(wvals, c)
    cand_idx = jnp.take_along_axis(wind_idx, si, axis=1)
    cand_ok = jnp.isfinite(sv)
    if ntotal is not None:
        # the boundary window's argmax may be a padding row
        cand_ok = cand_ok & (cand_idx < ntotal)

    if not exact_scores:
        # gather-free: rank by the scan-domain plane values directly
        masked = jnp.where(cand_ok, sv, -jnp.inf)
        vals, sel = jax.lax.top_k(masked, k)
        idx_out = jnp.take_along_axis(cand_idx, sel, axis=1)
        if int_domain and metric == "l2" and corpus_sqnorms is not None:
            # the int8 plane carries (quantized) DOT products; convert
            # the k winners to l2 goodness via -d^2 = 2*dot - |q|^2 -
            # |x|^2 so _finalize yields meaningful (approximate)
            # distances at the API edge.  Only (B, k) scalar sqnorms
            # are gathered — bytes, not the (C, d) row gather this
            # mode exists to avoid.  |q|^2 comes from the DEQUANTIZED
            # codes (q8 * q_scale): when the caller pre-quantized
            # (q_scale passed, `queries` holds int8 codes), summing
            # `queries**2` would be off by q_scale^-2 — and the
            # dequantized norm matches the quantized dot's domain.
            q_deq = q8.astype(jnp.float32) * q_scale[:, None]
            qsq = jnp.sum(q_deq * q_deq, axis=-1, keepdims=True)
            xsq = jnp.take(
                corpus_sqnorms.astype(jnp.float32), idx_out, axis=0
            )
            vals = jnp.where(
                jnp.isfinite(vals), 2.0 * vals - qsq - xsq, vals
            )
            # the dot->l2 conversion is NOT monotone in dot when doc
            # norms vary, so the k winners must be re-sorted in the
            # returned domain (ADVICE r3) — otherwise hits[0] may not
            # be the best of the returned set.  (B, k) sort: free next
            # to the scan.  -inf (invalid) rows sort last either way.
            order = jnp.lexsort((idx_out, -vals), axis=-1)
            vals = jnp.take_along_axis(vals, order, axis=1)
            idx_out = jnp.take_along_axis(idx_out, order, axis=1)
        return vals, idx_out

    cand_goodness = jnp.where(cand_ok, 0.0, -jnp.inf)

    from qrag_tpu.ops.quantize import refine_candidates

    return refine_candidates(
        queries.astype(jnp.float32),
        corpus_f,
        cand_idx,
        cand_goodness,
        k,
        metric=metric,
        corpus_sqnorms=corpus_sqnorms,
    )


def quantize_block_rows(
    x: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-128-row-block symmetric int8 quantization (host-side; the
    blocks coincide with selection windows so raw int32 dots order
    correctly within each window)."""
    n, d = x.shape
    if n % WINDOW:
        raise ValueError(f"N={n} must be a multiple of {WINDOW}")
    xb = x.reshape(n // WINDOW, WINDOW, d)
    absmax = np.abs(xb).max(axis=(1, 2))
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(
        np.round(xb / scale[:, None, None]), -127, 127
    ).astype(np.int8)
    return q.reshape(n, d), scale


def quantize_block_rows_device(x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Device-side per-block quantization (jit-friendly)."""
    n, d = x.shape
    xb = x.reshape(n // WINDOW, WINDOW, d)
    absmax = jnp.max(jnp.abs(xb), axis=(1, 2))
    scale = jnp.where(absmax > 0, absmax / 127.0, 1.0).astype(jnp.float32)
    q = jnp.clip(
        jnp.round(xb / scale[:, None, None]), -127, 127
    ).astype(jnp.int8)
    return q.reshape(n, d), scale
