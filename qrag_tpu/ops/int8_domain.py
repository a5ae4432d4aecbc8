"""Own-domain int8 exact top-k: the int8 scan with a ZERO band.

The f32-contract int8 bounded mode (``bounded_topk.bounded_exact_
topk_int8``) is refuted as a headline path: quantization residuals put
a ~0.5-sigma band around every plane value and the certificates
flood.  This op takes the documented remaining axis — a CONTRACT
change, not a tighter bound.  The corpus IS the int8 codes (plus one
f32 scale per 128-row window), the query is symmetrically int8-rounded
once at the edge, and the scoring function is *defined* as

    score(q, r) = fl32( (t * s_w) * f32(<q8, x8_r>_int32) )      (ip)
    goodness(q, r) = (2*score - qsq_deq) - xsq_deq_r             (l2)

i.e. the EXACT int32 accumulation of the rounded operands, scaled
once in f32 (the dot is bit-exact; the f32 cast and single multiply
are correctly rounded and monotone in the dot).  This is the contract
of fp16/int8 GPU-FAISS indexes one quantization step coarser — the
reference's own store would hold these codes (it outsources scanning
to faiss-cpu, ``mcp/server/tools/store_in_faiss.py:105``); here the
scan runs in int8 arithmetic (device time: not measured on a GPU yet).

Why the band is (nearly) zero: the packed plane keys carry the RAW
int32 dots — no rounding — and the refinement computes the SAME
product of the SAME integers, so a plane bound and a refined score of
one row agree bit-for-bit up to how XLA fuses the identical f32
expression trees (fma vs separate rounding).  A relative epsilon of
1e-6 — orders of magnitude below the bf16 mode's quantization margins
but above any fusion dust — keeps the certificates sound without
admitting a meaningful candidate band.

Everything downstream is the proven bounded-exact design
(``ops/bounded_topk.py``): top-C windows by upper bound, exact
candidate re-scoring (an int8 row gather is 4x lighter than bf16),
cert_a coverage, cert_b whole-window patches, 4x escalation on the
same planes, and an unconditional own-domain full-sort fallback.
Result contract: exact top-k values AND indices of the own-domain
scoring function, ties broken by lower global index.

Scope notes:
  * |dot| can exceed 2^23 only on adversarially aligned codes at
    d > ~512; the plane keys clip there, which VOIDS the bounds and
    routes the batch to the full sort (clip_fail) — exactness is
    unconditional, matching the f32-contract int8 mode.
  * Tuned for k <= ~16 (the serving top-10 shape).  Large k rides the
    same escalation/fallback ladder correctly but without the
    runner-up-row layer of the bf16 large-k design.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from qrag_tpu.ops.bounded_topk import (
    _I32_MIN,
    packed_window_scan_top2_int,
    topk_tiebreak,
)
from qrag_tpu.ops.window_scan import _INT_CLAMP, WINDOW


def quantize_query_int8(
    q32: jnp.ndarray,  # (B, d) f32
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-query symmetric int8 rounding — THE edge where the own-
    domain contract is entered (same scheme as the per-window corpus
    codes, ``window_scan.quantize_block_rows_device``)."""
    q_absmax = jnp.max(jnp.abs(q32), axis=1)
    t = jnp.where(q_absmax > 0, q_absmax / 127.0, 1.0).astype(jnp.float32)
    q8 = jnp.clip(jnp.round(q32 / t[:, None]), -127, 127).astype(jnp.int8)
    return q8, t


def row_int_sqnorms(corpus_q8: jnp.ndarray) -> jnp.ndarray:
    """(N,) int32 sum(x8^2) per row — EXACT (<= d * 127^2 < 2^31 for
    d <= ~133k).  Computed once per snapshot; the l2 contract's
    dequantized row sqnorm is (s_w^2) * f32(this)."""
    x = corpus_q8.astype(jnp.int32)
    return jnp.sum(x * x, axis=1)


def _own_score(dot_i32, scale, qsq_deq, xsq_deq, metric: str):
    """THE own-domain scoring expression — shared verbatim by the
    plane bounds, the candidate/patch refinement, and the full-sort
    fallback so every evaluation of one row is the identical f32
    expression tree (the epsilon margin only has to cover XLA fusion
    dust, not algorithmic drift)."""
    s = scale * dot_i32.astype(jnp.float32)
    if metric == "l2":
        return (2.0 * s - qsq_deq) - xsq_deq
    return s


def _int_dots(q8: jnp.ndarray, rows8: jnp.ndarray) -> jnp.ndarray:
    """Exact int32 dots of (B, d) int8 queries vs (B, ..., d) int8
    gathered rows (batched over B)."""
    b = q8.shape[0]
    lead = rows8.shape[1:-1]
    flat = rows8.reshape(b, -1, rows8.shape[-1])
    dots = jax.lax.dot_general(
        q8,
        flat,
        dimension_numbers=(((1,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.int32,
    )  # (B, prod(lead))
    return dots.reshape(b, *lead)


def _own_full_sort(
    q8: jnp.ndarray,  # (B, d) int8
    t: jnp.ndarray,  # (B,)
    qsq_deq: jnp.ndarray,  # (B, 1) f32
    corpus_q8: jnp.ndarray,  # (N, d) int8
    scale_rows: jnp.ndarray,  # (N,) f32 per-row window scale
    xsq_full: jnp.ndarray,  # (N,) f32 dequantized row sqnorms (l2)
    k: int,
    metric: str,
    valid_rows: Optional[jnp.ndarray],
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Unconditional own-domain backstop: full top-k, chunked over
    queries (a rarely-taken cond branch must not reserve (B, N) f32)."""
    b, d = q8.shape
    chunk = min(b, 64)
    pad = (-b) % chunk
    if pad:
        q8 = jnp.pad(q8, ((0, pad), (0, 0)))
        t = jnp.pad(t, (0, pad), constant_values=1.0)
        qsq_deq = jnp.pad(qsq_deq, ((0, pad), (0, 0)))

    def one(args):
        qc, tc, qsqc = args
        dots = jax.lax.dot_general(
            qc,
            corpus_q8,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )  # (chunk, N)
        scale = tc[:, None] * scale_rows[None, :]
        g = _own_score(dots, scale, qsqc, xsq_full[None, :], metric)
        if valid_rows is not None:
            g = jnp.where(valid_rows[None, :], g, -jnp.inf)
        return tuple(jax.lax.top_k(g, k))

    vs, is_ = jax.lax.map(
        one,
        (
            q8.reshape(-1, chunk, d),
            t.reshape(-1, chunk),
            qsq_deq.reshape(-1, chunk, 1),
        ),
    )
    return vs.reshape(-1, k)[:b], is_.reshape(-1, k)[:b]


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def full_topk_int8_domain(
    queries: jnp.ndarray,  # (B, d) f32
    corpus_q8: jnp.ndarray,  # (N, d) int8
    window_scales: jnp.ndarray,  # (NW,) f32
    row_isq: jnp.ndarray,  # (N,) int32
    k: int,
    metric: str = "l2",
    valid_rows: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Unpruned own-domain top-k — the small-corpus route (and the
    oracle the tests hold ``exact_topk_int8_domain`` to)."""
    q32 = queries.astype(jnp.float32)
    q8, t = quantize_query_int8(q32)
    qi = q8.astype(jnp.int32)
    qsq_deq = ((t * t) * jnp.sum(qi * qi, axis=1).astype(jnp.float32))[
        :, None
    ]
    scale_rows = jnp.repeat(window_scales, WINDOW)
    xsq_full = (scale_rows * scale_rows) * row_isq.astype(jnp.float32)
    return _own_full_sort(
        q8, t, qsq_deq, corpus_q8, scale_rows, xsq_full,
        k, metric, valid_rows,
    )


def _refine_int8_domain(
    q8, t, qsq_deq, corpus_q8, window_scales, xsq_full,
    k: int, metric: str, valid_rows,
    C: int, F: int,
    *, ub, ub2, cand_live, lane1,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """The bounded tail specialized to the int8 own domain: candidate
    selection + exact int re-scoring + cert_a/cert_b + whole-window
    patches.  Mirrors ``bounded_topk._certify_and_refine`` (which
    refines against f32 rows) — kept separate because the refinement
    gathers CODES and scores with ``_own_score``, and the small-k
    serving shape needs no runner-up layer."""
    b = q8.shape[0]
    nw = ub.shape[1]

    ub = jnp.where(cand_live, ub, -jnp.inf)
    if nw > 4096:
        sel_vals, wsel = jax.lax.approx_max_k(ub, C, recall_target=0.999)
    else:
        sel_vals, wsel = jax.lax.top_k(ub, C)  # (B, C)
    cand_idx = wsel * WINDOW + jnp.take_along_axis(lane1, wsel, axis=1)
    cand_ok = sel_vals > -jnp.inf
    if valid_rows is not None:
        # int planes can surface an invalid argmax row (padding codes
        # carry dot 0); drop it here — any valid runner-up in that
        # window is covered by the ub2 patch layer
        cand_ok = cand_ok & jnp.take(valid_rows, cand_idx)
    cand_idx = jnp.where(cand_ok, cand_idx, 0)
    rows8 = jnp.take(corpus_q8, cand_idx, axis=0)  # (B, C, d) int8
    dots = _int_dots(q8, rows8)  # (B, C) exact
    scale_c = t[:, None] * jnp.take(window_scales, wsel, axis=0)
    xsq_c = jnp.take(xsq_full, cand_idx, axis=0)
    cand_g = _own_score(dots, scale_c, qsq_deq, xsq_c, metric)
    cand_g = jnp.where(cand_ok, cand_g, -jnp.inf)

    ck_vals, _ = topk_tiebreak(cand_g, cand_idx, k)
    thr = ck_vals[:, k - 1]  # (B,)

    # cert_a: every window that could clear thr is IN the selection
    # (sel_vals ARE ub[wsel] — no plane gather; bounded_topk r5 note)
    count_a = jnp.sum(ub >= thr[:, None], axis=1)
    sel_qual = jnp.sum(sel_vals >= thr[:, None], axis=1)
    cert_a_fail = jnp.any((count_a > C) | (count_a != sel_qual))

    # cert_b: windows whose SECOND row might clear thr -> whole-window
    # patch (2-argmax selection; see _certify_and_refine for why)
    flags = ub2 >= thr[:, None]  # (B, NW)
    fcount = jnp.sum(flags, axis=1)
    prio = jnp.where(flags, ub2, -jnp.inf)
    w0 = jnp.argmax(prio, axis=1)
    prio_masked = prio.at[jnp.arange(b), w0].set(-jnp.inf)
    w1 = jnp.argmax(prio_masked, axis=1)
    pw = jnp.stack([w0, w1], axis=1)  # (B, 2)
    pv = jnp.stack(
        [
            jnp.take_along_axis(prio, w0[:, None], axis=1)[:, 0],
            jnp.take_along_axis(prio_masked, w1[:, None], axis=1)[:, 0],
        ],
        axis=1,
    )
    P = 2
    n_flagged_q = jnp.sum(fcount > 0)
    cert_b_fail = jnp.any(fcount > P) | (n_flagged_q > F)

    # flagged-query compaction (top-F queries by flag count)
    _, qsel = jax.lax.top_k(fcount.astype(jnp.float32), F)  # (F,)
    q_active = fcount[qsel] > 0
    pq8 = q8[qsel]  # (F, d)
    pt = t[qsel]
    pqsq = qsq_deq[qsel]  # (F, 1)
    p_w = pw[qsel]  # (F, P)
    p_live = jnp.isfinite(pv[qsel]) & q_active[:, None]
    p_lane1 = jnp.take_along_axis(lane1[qsel], p_w, axis=1)
    p_w_safe = jnp.where(p_live, p_w, 0)

    def slice_window(w):
        rows = jax.lax.dynamic_slice(
            corpus_q8, (w * WINDOW, 0), (WINDOW, corpus_q8.shape[1])
        )
        xsq = jax.lax.dynamic_slice(xsq_full, (w * WINDOW,), (WINDOW,))
        return rows, xsq

    p_rows, p_xsq = jax.vmap(lambda ws: jax.vmap(slice_window)(ws))(
        p_w_safe
    )  # (F, P, WINDOW, d) int8, (F, P, WINDOW) f32
    p_dots = _int_dots(pq8, p_rows)  # (F, P, WINDOW)
    p_scale = (
        pt[:, None] * jnp.take(window_scales, p_w_safe, axis=0)
    )[:, :, None]
    p_g = _own_score(p_dots, p_scale, pqsq[:, :, None], p_xsq, metric)
    lanes = jnp.arange(WINDOW, dtype=jnp.int32)[None, None, :]
    p_idx = p_w_safe[:, :, None] * WINDOW + lanes
    dead = (lanes == p_lane1[:, :, None]) | ~p_live[:, :, None]
    if valid_rows is not None:
        dead = dead | ~jnp.take(valid_rows, p_idx)
    p_g = jnp.where(dead, -jnp.inf, p_g)

    extras_g = jnp.full((b, P * WINDOW), -jnp.inf, jnp.float32)
    extras_g = extras_g.at[qsel].set(p_g.reshape(F, P * WINDOW))
    extras_idx = jnp.zeros((b, P * WINDOW), jnp.int32)
    extras_idx = extras_idx.at[qsel].set(p_idx.reshape(F, P * WINDOW))

    n_patched = jnp.sum(p_live)
    fell_back = cert_a_fail | cert_b_fail
    g_all = jnp.concatenate([cand_g, extras_g], axis=1)
    idx_all = jnp.concatenate([cand_idx, extras_idx], axis=1)
    fast_vals, fast_idx = topk_tiebreak(g_all, idx_all, k)
    return fast_vals, fast_idx, fell_back, n_patched


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "metric", "candidates", "patch_queries",
    ),
)
def exact_topk_int8_domain(
    queries: jnp.ndarray,  # (B, d) f32 (rounded to int8 in-op)
    corpus_q8: jnp.ndarray,  # (N, d) int8 per-window codes; N % 128 == 0
    window_scales: jnp.ndarray,  # (NW,) f32
    row_isq: jnp.ndarray,  # (N,) int32 from row_int_sqnorms
    lane_rank: jnp.ndarray,  # (1, N)
    k: int,
    metric: str = "l2",
    valid_rows: Optional[jnp.ndarray] = None,  # (N,) bool
    candidates: int = 16,
    patch_queries: int = 32,
) -> Tuple[
    jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray
]:
    """Exact top-k of the OWN-DOMAIN int8 scoring function (module
    doc), 5-tuple return matching ``bounded_exact_topk``:
    (values, indices, fell_back, n_patched, escalated)."""
    b, d = queries.shape
    n = corpus_q8.shape[0]
    nw = n // WINDOW
    if nw < k:
        raise ValueError(
            f"bounded top-k needs >= k windows (k={k}, windows={nw}) — "
            "route small corpora to int8_domain_full_sort"
        )
    C = min(max(candidates, k), nw)
    F = min(patch_queries, b)

    q32 = queries.astype(jnp.float32)
    q8, t = quantize_query_int8(q32)
    qi = q8.astype(jnp.int32)
    qsq_deq = ((t * t) * jnp.sum(qi * qi, axis=1).astype(jnp.float32))[
        :, None
    ]  # (B, 1)

    pk1, pk2 = packed_window_scan_top2_int(q8, corpus_q8, lane_rank)

    dot1 = pk1 >> 7  # EXACT int dot of each window's argmax row
    lane1 = WINDOW - 1 - (pk1 & jnp.int32(WINDOW - 1))
    pk2_masked = pk2 == _I32_MIN
    dot2 = pk2 >> 7
    # a clipped key voids the upper bound: force the full sort
    clip_fail = jnp.any(jnp.abs(dot1) >= _INT_CLAMP) | jnp.any(
        jnp.where(pk2_masked, 0, jnp.abs(dot2)) >= _INT_CLAMP
    )

    scale_rows = jnp.repeat(window_scales, WINDOW)  # (N,)
    xsq_full = (scale_rows * scale_rows) * row_isq.astype(jnp.float32)

    scale_bw = t[:, None] * window_scales[None, :]  # (B, NW)
    s1 = scale_bw * dot1.astype(jnp.float32)
    s2 = scale_bw * dot2.astype(jnp.float32)
    if metric == "l2":
        minsq_src = xsq_full
        if valid_rows is not None:
            minsq_src = jnp.where(valid_rows, xsq_full, jnp.inf)
        minsq = jnp.min(minsq_src.reshape(nw, WINDOW), axis=1)
        minsq = jnp.where(jnp.isfinite(minsq), minsq, 0.0)[None, :]
        # epsilon covers XLA fusing the (identical) plane vs refine
        # expression trees differently (fma dust) — NOT a quantization
        # band; relative 1e-6 >> any single-rounding asymmetry
        eps = 1e-6 * (2.0 * jnp.abs(s1) + qsq_deq + minsq) + 1e-30
        ub = (2.0 * s1 - qsq_deq) - minsq + eps
        ub2 = jnp.where(
            pk2_masked, -jnp.inf, (2.0 * s2 - qsq_deq) - minsq + eps
        )
    elif metric == "ip":
        eps = 1e-6 * jnp.abs(s1) + 1e-30
        ub = s1 + eps
        ub2 = jnp.where(pk2_masked, -jnp.inf, s2 + eps)
    else:
        raise ValueError(f"unknown metric {metric!r}")

    cand_live = jnp.ones((b, nw), bool)
    if valid_rows is not None:
        # windows with no valid row must not qualify (zero-padding
        # codes carry dot 0, beating real negative scores)
        wvalid = jnp.any(valid_rows.reshape(nw, WINDOW), axis=1)[None, :]
        ub = jnp.where(wvalid, ub, -jnp.inf)
        ub2 = jnp.where(wvalid, ub2, -jnp.inf)
        cand_live = jnp.broadcast_to(wvalid, (b, nw))

    refine_args = (
        q8, t, qsq_deq, corpus_q8, window_scales, xsq_full,
        k, metric, valid_rows,
    )
    common = dict(ub=ub, ub2=ub2, cand_live=cand_live, lane1=lane1)

    v1, i1, fb1, np1 = _refine_int8_domain(*refine_args, C, F, **common)
    # clipped keys void the BOUNDS — escalation can't fix that; route
    # straight to the full sort (bounded_topk._certify_escalate parity)
    esc = fb1 & ~clip_fail
    C2 = min(4 * C, nw)
    F2 = min(4 * F, b)

    def full_sort():
        return _own_full_sort(
            q8, t, qsq_deq, corpus_q8, scale_rows, xsq_full,
            k, metric, valid_rows,
        )

    def escalated():
        v2, i2, fb2, np2 = _refine_int8_domain(
            *refine_args, C2, F2, **common
        )
        vals, idx = jax.lax.cond(
            fb2 | clip_fail, full_sort, lambda: (v2, i2)
        )
        return vals, idx, fb2 | clip_fail, np2

    def fast_or_void():
        vals, idx = jax.lax.cond(
            clip_fail, full_sort, lambda: (v1, i1)
        )
        return vals, idx, clip_fail, np1

    if C2 <= C:
        vals, idx = jax.lax.cond(
            fb1 | clip_fail, full_sort, lambda: (v1, i1)
        )
        return vals, idx, fb1 | clip_fail, np1, jnp.asarray(False)
    vals, idx, fb, npatch = jax.lax.cond(esc, escalated, fast_or_void)
    return vals, idx, fb, npatch, esc
