"""Provably-exact top-k via norm-bounded window pruning.

An on-device, jit-compatible exact top-k whose cost is ONE windowed
scan pass plus small targeted gathers — no second full pass over the
(B, N) goodness (``scan_topk_verified_jit``'s certificate is a second
pass over 4 GB at 1M x 768 / B=1024) and no full sort over N columns.

How it stays exact — bound-and-prune (the accelerator-shaped analogue of a
branch-and-bound pruned scan; the reference outsourced its whole scan
to faiss-cpu, ``mcp/server/tools/store_in_faiss.py:105``):

  1. ONE scan computes, per 128-row window, the top-2 score values and
     the argmax row (``packed_window_scan_top2`` / the Pallas twin) —
     a (B, N/128) plane, 128x smaller than the score matrix.
  2. A rigorous per-window error MARGIN converts plane values into
     upper bounds on any row's REFINE-domain score:
         |e_r - s_r| <= alpha * eps_rel * |q|_2 * maxnorm_w
     where s is the scan evaluation (scan-dtype inputs, f32
     accumulation), e the refine evaluation (f32 gather + einsum),
     eps_rel covers input rounding (2^-9 per operand cast to bf16,
     via |Sum dq_i x_i| <= |dq||x| Cauchy-Schwarz) plus worst-case
     f32 summation-order drift (d * eps_f32), and maxnorm_w =
     max_{r in w} |x_r|_2.
  3. Candidate windows = top-C by upper bound v1+margin; their argmax
     rows are gathered and EXACTLY re-scored -> threshold thr = k-th
     candidate score.  cert_a: if #{windows: v1+margin >= thr} <= C,
     every window outside the selection provably contains no top-k row.
  4. Windows whose SECOND-best plane value clears thr-margin might
     hide a non-argmax top-k row: those (rare — two global-top rows
     sharing one 128-row window) are PATCHED — the flagged queries'
     flagged windows are sliced contiguously (128 rows, no random
     gather), exactly re-scored, and merged.  cert_b: <= 2 flagged
     windows per query, <= F flagged queries per batch (static
     budgets).
  5. A certificate failure first ESCALATES: the same (already
     computed) planes are re-certified at a 4x candidate budget — a
     bigger gather and selection, not a new scan.  Only if
     the escalated certificates fail too does the op fall back
     (``lax.cond``) to the chunked exact full sort — exactness is
     unconditional, the fast path just stops applying.  Escalation is
     what makes a lean default budget safe on tie-heavy corpora (at
     1M x 768 the narrow-regime band is mean 10.4 / max 15
     windows/query, so C=16 is one escalation-free notch above it): a
     duplicate-row corpus that needs C > 16 pays one bigger gather,
     not the full sort.

Result contract: the EXACT top-k (values, indices, ties broken by
lower global index — lax.top_k parity) of the refine-domain scoring
function, the same scoring ``refine_candidates``/``_goodness`` define.
Margins make rows near the decision boundary extra CANDIDATES (cheap)
rather than failures, so the fast path survives near-ties; only
multi-row-per-window collisions cost anything.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from qrag_tpu.ops.window_scan import (
    _INT_CLAMP,
    WINDOW,
    _float_from_key,
    _float_sort_key,
    f32_precision,
    make_lane_rank,
    widen_f32,
)

# worst-case relative f32 accumulation-order drift between two
# evaluations of the same d-term dot product (d * eps_f32 each, two
# evaluations, product-rounding dust), d <= ~8192
_EPS_ACC = 2.4e-4
# bf16 has SEVEN fraction bits: ulp at 1.0 is 2^-7, so round-to-
# nearest input error is <= 2^-8 * |x| per operand (NOT 2^-9 — that
# off-by-one under-covered the margin band and let planted
# near-boundary rows escape the certificates).
_BF16_HALF_ULP = 2.0 ** -8
_SAFETY = 1.25
_I32_MIN = np.int32(-(2 ** 31))  # a NumPy scalar: a literal, not a captured array


def window_maxnorms(corpus_sqnorms: np.ndarray) -> np.ndarray:
    """(NW,) f32: max row L2-norm per 128-row window (pad with 0)."""
    sq = np.asarray(corpus_sqnorms, np.float32)
    n = sq.shape[0]
    nw = -(-n // WINDOW)
    padded = np.zeros((nw * WINDOW,), np.float32)
    padded[:n] = sq
    return np.sqrt(padded.reshape(nw, WINDOW).max(axis=1))


def window_maxnorms_device(corpus_sqnorms: jnp.ndarray) -> jnp.ndarray:
    """jnp twin of ``window_maxnorms`` for buffers already on device
    (requires len % WINDOW == 0) — the ONE derivation of the per-window
    norm bound, shared by the flat snapshot cache and the sharded
    per-shard path."""
    return jnp.sqrt(
        jnp.max(corpus_sqnorms.reshape(-1, WINDOW), axis=1)
    )


def window_minsqnorms_device(corpus_sqnorms: jnp.ndarray) -> jnp.ndarray:
    """(NW,) f32 MIN row sqnorm per window — the l2 bound of the int8
    mode needs it (the int plane ranks windows by DOT, so the window's
    goodness upper bound must assume the smallest-norm row; equals
    maxnorm^2 on constant-norm corpora, where the bound is tight)."""
    return jnp.min(corpus_sqnorms.reshape(-1, WINDOW), axis=1)


def window_quant_residuals_device(
    corpus_f: jnp.ndarray,  # (N, d) refine-domain rows
    corpus_q8: jnp.ndarray,  # (N, d) int8 codes quantized FROM corpus_f
    window_scales: jnp.ndarray,  # (NW,) f32
) -> jnp.ndarray:
    """(NW,) f32: max over each window of the EXACT quantization
    residual L2 norm |x_r - s_w * x8_r|_2.

    The worst-case bound sqrt(d)/2 * s_w is ~1.7x above the actual
    rounding residual (RMS sqrt(d/12) * s_w); using the computed norm
    keeps the margin rigorous (Cauchy-Schwarz still holds with the
    true norm) while nearly halving the candidate band — the
    difference between cert_a holding and failing at 1M x 768."""
    scales_per_row = jnp.repeat(window_scales, WINDOW)[:, None]
    resid = (
        corpus_f.astype(jnp.float32)
        - corpus_q8.astype(jnp.float32) * scales_per_row
    )
    rn = jnp.sqrt(jnp.sum(resid * resid, axis=1))
    # (1 + 1e-5) + floor absorbs the f32 rounding of computing the
    # norm itself (relative error ~d * eps_f32 << 1e-5)
    return jnp.max(rn.reshape(-1, WINDOW), axis=1) * (1.0 + 1e-5) + 1e-20


def margin_coeff(
    query_dtype, scan_dtype, exact_dtype, d: int
) -> float:
    """Rigorous relative error coefficient between the scan evaluation
    and the refine evaluation of one dot product (see module doc)."""
    q_round = 0.0 if query_dtype == scan_dtype else _BF16_HALF_ULP
    x_round = 0.0 if exact_dtype == scan_dtype else _BF16_HALF_ULP
    cross = 2.0 ** -16 if (q_round or x_round) else 0.0
    acc = max(d, 768) / 768.0 * _EPS_ACC
    return (q_round + x_round + cross + acc) * _SAFETY


def packed_window_scan_top2(
    queries: jnp.ndarray,  # (B, d) scan dtype (bf16/f32)
    corpus: jnp.ndarray,  # (N, d) scan dtype; N % 128 == 0
    lane_rank: jnp.ndarray,  # (1, N) from make_lane_rank
    row_add: Optional[jnp.ndarray] = None,  # (1, N) f32
    col_add: Optional[jnp.ndarray] = None,  # (B, 1) f32
    alpha: float = 1.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """XLA reference top-2 window scan.

    Returns (pk1, pk2) (B, NW) int32 packed (truncated-score | lane)
    planes: the window argmax key (``window_scan.packed_window_scan``
    contract) and the runner-up key (argmax lane masked; packed keys
    are unique within a window so exactly one lane is excluded).
    Value BOUNDS are recovered with ``plane_value_bounds`` — the
    packed domain keeps the fused epilogue to two integer reductions.
    On a sub-trunc-quantum near-tie pk2 can carry the true max's
    twin — sound: bounds, not identities, feed the certificates."""
    b = queries.shape[0]
    n = corpus.shape[0]
    nw = n // WINDOW
    g = jax.lax.dot_general(
        queries,
        corpus,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=f32_precision(queries.dtype),
    )
    if alpha != 1.0:
        g = g * alpha
    if row_add is not None:
        g = g + row_add
    if col_add is not None:
        g = g + col_add
    key = _float_sort_key(g) & ~jnp.int32(127)
    packed = (key | lane_rank).reshape(b, nw, WINDOW)
    pk1 = jnp.max(packed, axis=2)
    pk2 = jnp.max(
        jnp.where(packed == pk1[:, :, None], _I32_MIN, packed), axis=2
    )
    return pk1, pk2


def packed_window_scan_top3(
    queries: jnp.ndarray,
    corpus: jnp.ndarray,
    lane_rank: jnp.ndarray,
    row_add: Optional[jnp.ndarray] = None,
    col_add: Optional[jnp.ndarray] = None,
    alpha: float = 1.0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """XLA reference top-3 window scan: ``packed_window_scan_top2``
    plus the third-best plane (one more masked max — packed keys are
    unique within a window, so each == mask removes exactly one row).
    The large-k bounded design needs pk3 to bound rows 3..WINDOW of a
    window whose runner-up was exactly scored."""
    b = queries.shape[0]
    n = corpus.shape[0]
    nw = n // WINDOW
    g = jax.lax.dot_general(
        queries,
        corpus,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=f32_precision(queries.dtype),
    )
    if alpha != 1.0:
        g = g * alpha
    if row_add is not None:
        g = g + row_add
    if col_add is not None:
        g = g + col_add
    key = _float_sort_key(g) & ~jnp.int32(127)
    packed = (key | lane_rank).reshape(b, nw, WINDOW)
    pk1 = jnp.max(packed, axis=2)
    masked = jnp.where(packed == pk1[:, :, None], _I32_MIN, packed)
    pk2 = jnp.max(masked, axis=2)
    pk3 = jnp.max(
        jnp.where(masked == pk2[:, :, None], _I32_MIN, masked), axis=2
    )
    return pk1, pk2, pk3


def plane_value_bounds(pk: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(lower, upper) f32 bounds of the true scan score behind a
    packed plane entry: the trunc key is a lower bound, the NEXT
    truncation step (+128 in the sign-folded int) a strict upper
    bound.  Fully-masked entries (_I32_MIN, e.g. pk2 of a one-lane
    window) map to (-inf, -inf)."""
    key = pk & ~jnp.int32(127)
    lo = _float_from_key(key)
    hi = _float_from_key(key + 128)
    masked = pk == _I32_MIN
    return (
        jnp.where(masked, -jnp.inf, lo),
        jnp.where(masked, -jnp.inf, hi),
    )


def topk_tiebreak(
    g: jnp.ndarray, idx: jnp.ndarray, k: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-k of (goodness, global index) candidate lists with the
    framework-wide tie-break: higher goodness first, ties -> lower
    global index (lax.top_k-over-the-full-matrix parity)."""
    sneg, sidx = jax.lax.sort(
        (-g, idx.astype(jnp.int32)), dimension=1, num_keys=2
    )
    return -sneg[:, :k], sidx[:, :k]


def _exact_scores(
    q32: jnp.ndarray,  # (B, d) f32
    rows: jnp.ndarray,  # (..., d) gathered corpus rows
    xsq: jnp.ndarray,  # (...,) f32 sqnorms of those rows
    qsq: jnp.ndarray,  # (B, 1) f32 broadcastable
    metric: str,
) -> jnp.ndarray:
    """The refine-domain scoring function (matches
    ``quantize.refine_candidates``): f32 einsum + l2 identity, at
    HIGHEST precision — ``margin_coeff`` assumes true f32 arithmetic,
    and a DEFAULT f32 product may run in TF32 on a GPU."""
    dots = jnp.einsum(
        "bd,b...d->b...", q32, rows.astype(jnp.float32),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    if metric == "l2":
        return 2.0 * dots - qsq.reshape(qsq.shape[0], *([1] * (dots.ndim - 1))) - xsq
    return dots


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "metric", "candidates", "patch_queries", "backend",
        "interpret", "large_k", "runner_rows",
    ),
)
def bounded_exact_topk(
    queries: jnp.ndarray,  # (B, d) f32 or scan dtype
    corpus_scan: jnp.ndarray,  # (N, d) bf16/f32 scan form; N % 128 == 0
    corpus_f: jnp.ndarray,  # (N, d) refine-domain rows (may alias scan)
    corpus_sqnorms: jnp.ndarray,  # (N,) f32 (refine-domain row sqnorms)
    maxnorms: jnp.ndarray,  # (NW,) f32 from window_maxnorms
    lane_rank: jnp.ndarray,  # (1, N)
    k: int,
    metric: str = "l2",
    valid_rows: Optional[jnp.ndarray] = None,  # (N,) bool
    # C: top windows exactly re-scored; F: per-batch flagged-query
    # patch budget.  None = margin-regime defaults (``_auto_budgets``:
    # narrow (16, 32) / mid (48, 32) / wide (96, 96))
    candidates: Optional[int] = None,
    patch_queries: Optional[int] = None,
    # "xla" (the twins above) | "triton" (ops/pallas/fused_scan.py);
    # callers take it from qrag_tpu.platform.scan_route.  interpret
    # runs the kernel on the CPU (tests only).
    backend: str = "xla",
    interpret: bool = False,
    # large-k design (three bound planes + per-query runner-up row
    # patches): None = auto (k > _LARGE_K_AUTO).  At rerank-width k the
    # top-k rows birthday-collide into shared windows (expected flagged
    # queries ~ B*k^2/2NW), swamping the whole-window patch budget F
    # and forcing the full sort every batch; the runner-up layer scores
    # the colliding rows individually instead.
    large_k: Optional[bool] = None,
    runner_rows: Optional[int] = None,  # R; None = _auto_runner_budget
) -> Tuple[
    jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray
]:
    """Provably-exact top-k (see module doc).

    Returns (goodness desc (B, k), indices (B, k), fell_back (bool
    scalar: the exact full sort ran), n_patched (int32 scalar),
    escalated (bool scalar: the 4x-budget re-certification ran)).
    Finalize to distances at the API edge (``ops.topk._finalize``)."""
    b, d = queries.shape
    n = corpus_scan.shape[0]
    nw = n // WINDOW
    if nw < k:
        raise ValueError(
            f"bounded top-k needs >= k windows (k={k}, windows={nw}) — "
            "route small corpora to the exact sort"
        )
    C, F = _auto_budgets(
        candidates, patch_queries,
        queries.dtype, corpus_scan.dtype, corpus_f.dtype, d,
    )
    if large_k is None:
        large_k = k > _LARGE_K_AUTO
    if candidates is None and k > C:
        # auto budgets were censused at k=10; at larger k the threshold
        # sits k-deep, so the margin band rides ON TOP of the k
        # qualifying windows — C=k alone would escalate every batch
        C = k + C
    C = min(max(C, k), nw)
    F = min(F, b)
    R = (
        _auto_runner_budget(k, nw) if runner_rows is None else runner_rows
    ) if large_k else 8
    R = min(R, nw)
    # per-query whole-window patch cap: 2 (the tuned small-k argmax
    # pair) unless the corpus is DENSE relative to k — at k ~ NW/5
    # the margin band piles several triple-collision-class windows
    # onto one query (measured max 9 at k=100, NW=512); 4x the
    # triple-collision Poisson mean k^3/6NW^2, escalation covers 4P
    P = 2
    if large_k:
        P = min(max(2, -(-4 * k**3 // (6 * nw * nw))), nw)

    bounds = window_bounds_bf16(
        queries, corpus_scan, corpus_f, corpus_sqnorms, maxnorms,
        lane_rank, metric=metric, valid_rows=valid_rows,
        backend=backend, interpret=interpret, top3=large_k,
    )
    q32, qsq, ub, ub2, cand_live, lane1 = bounds[:6]
    ub3, lane2, live2 = bounds[6:] if large_k else (None, None, None)
    return _certify_escalate(
        q32, qsq, corpus_f, corpus_sqnorms, k, metric, valid_rows, C, F,
        ub=ub, ub2=ub2, cand_live=cand_live, lane1=lane1,
        extra_fail=None,
        ub3=ub3, lane2=lane2, live2=live2, runner_budget=R,
        patch_windows=P,
    )


# k above which the large-k (top3 + runner-up) design engages by
# default: below it, expected window collisions (~k^2/2NW) stay well
# under the whole-window patch budget F and the third plane + runner
# gather would be pure overhead on the k=10 headline path
_LARGE_K_AUTO = 16


def _auto_runner_budget(k: int, nw: int) -> int:
    """Default per-query runner-up row budget R: 4x the expected
    per-query double-collision count k^2/2NW (Poisson mean; the 4x
    headroom plus the margin band's extra flags), floored at 8.  A
    corpus hotter than 4x the random-placement expectation escalates
    to 4R before any full sort."""
    return max(8, -(-4 * k * k // (2 * nw)))


def _auto_budgets(
    candidates: Optional[int], patch_queries: Optional[int],
    query_dtype, scan_dtype, refine_dtype, d: int,
) -> Tuple[int, int]:
    """Default (C, F) budgets, chosen by the MARGIN REGIME (a static
    dtype property, so the choice is jit-free).  The two budgets must
    clear the certificate band TOGETHER: cert_b's flagged-query budget
    F binds at the batch level, so raising C alone leaves every batch
    escalating while making tier-2's 4C gather pricier.

    Three regimes (band census of random unit corpora at 1M x 768,
    k=10, B=1024 — corpus statistics of the margin formulas, not
    device timings; margin_coeff values at d=768):

      narrow  query == scan == refine dtype (coeff 3e-4: f32
              accumulation drift only).  Band mean 10.4 / max 15
              windows/query, ~8 flagged queries/batch: (16, 32).
      mid     f32 queries against a bf16 store that is also the
              refine domain (coeff 5.2e-3: one bf16 rounding term).
              Band mean 19 / max 38, ~25 flagged queries/batch:
              (48, 32), 10 windows of cert_a headroom over the max.
      wide    f32 queries, bf16 scan, f32 refine store (coeff 1.0e-2:
              both rounding terms).  Band mean 34 / max 88, ~77
              flagged queries/batch — (48, 32) escalates EVERY batch
              and raising C alone does not help (cert_b still fails
              on F): (96, 96).

    Values outside the census's corpus-statistics regime self-correct
    through the escalation tier (4C, 4F) before any full sort."""
    coeff = margin_coeff(query_dtype, scan_dtype, refine_dtype, d)
    if coeff < 1e-3:
        c_def, f_def = 16, 32
    elif coeff < 7.5e-3:
        c_def, f_def = 48, 32
    else:
        c_def, f_def = 96, 96
    return (
        c_def if candidates is None else candidates,
        f_def if patch_queries is None else patch_queries,
    )


def window_bounds_bf16(
    queries: jnp.ndarray,  # (B, d) f32 or scan dtype
    corpus_scan: jnp.ndarray,  # (N, d) bf16/f32 scan form
    corpus_f: jnp.ndarray,  # (N, d) refine-domain rows
    corpus_sqnorms: jnp.ndarray,  # (N,) f32
    maxnorms: jnp.ndarray,  # (NW,) f32
    lane_rank: jnp.ndarray,  # (1, N)
    metric: str = "l2",
    valid_rows: Optional[jnp.ndarray] = None,
    backend: str = "xla",
    interpret: bool = False,
    top3: bool = False,
):
    """Float-scan front-end: top-2 packed window scan + rigorous
    rounding margins.  Returns (q32, qsq, ub, ub2, cand_live, lane1)
    — the certificate inputs of ``_certify_escalate``.  Exposed so
    measurement tooling (the band census) uses the PRODUCTION bound
    formulas instead of a hand-copied replica that could silently
    desync.

    ``top3=True`` (the large-k design) appends (ub3, lane2, live2):
    the third-row bound plane, the runner-up lane per window, and
    whether a live runner-up exists — what lets flagged windows be
    patched with ONE exactly-scored row instead of all WINDOW rows."""
    b, d = queries.shape
    n = corpus_scan.shape[0]

    # the scan reads the rounded query; the refine and the margins
    # must see the same values (``widen_f32``)
    q32 = widen_f32(queries)
    qsq = jnp.sum(q32 * q32, axis=-1, keepdims=True)
    qnorm = jnp.sqrt(qsq)

    alpha, row_add, col_add = 1.0, None, None
    if metric == "l2":
        alpha = 2.0
        row_add = -corpus_sqnorms[None, :].astype(jnp.float32)
        col_add = -qsq
    if valid_rows is not None:
        bias = jnp.where(valid_rows, 0.0, -jnp.inf)[None, :]
        row_add = bias if row_add is None else row_add + bias

    q_scan = queries.astype(corpus_scan.dtype)
    pk3 = None
    if backend == "triton":
        from qrag_tpu.ops.pallas.fused_scan import packed_window_scan_kernel

        pks = packed_window_scan_kernel(
            q_scan, corpus_scan, row_add=row_add, col_add=col_add,
            alpha=alpha, planes=3 if top3 else 2, interpret=interpret,
        )
        pk1, pk2 = pks[0], pks[1]
        if top3:
            pk3 = pks[2]
    elif top3:
        pk1, pk2, pk3 = packed_window_scan_top3(
            q_scan, corpus_scan, lane_rank,
            row_add=row_add, col_add=col_add, alpha=alpha,
        )
    else:
        pk1, pk2 = packed_window_scan_top2(
            q_scan, corpus_scan, lane_rank,
            row_add=row_add, col_add=col_add, alpha=alpha,
        )
    v1_lb, v1_ub = plane_value_bounds(pk1)
    _, v2_ub = plane_value_bounds(pk2)

    coeff = alpha * margin_coeff(
        queries.dtype, corpus_scan.dtype, corpus_f.dtype, d
    )
    margin = coeff * qnorm * maxnorms[None, :] + 1e-30  # (B, NW)
    if metric == "l2":
        # the affine epilogue (+(-|q|^2) +(-|x|^2)) rounds in f32 with
        # association orders that differ between scan and refine; that
        # drift scales with the NORM TERMS, not |q||x| — an absolute
        # eps_f32-scale term keeps the bound rigorous for
        # norm-mismatched data (|q| >> |x| or vice versa)
        margin = margin + 5e-7 * (qsq + maxnorms[None, :] ** 2)

    lane1 = WINDOW - 1 - (pk1 & jnp.int32(WINDOW - 1))  # (B, NW)
    # a window whose best score is exactly -inf is all-masked: never a
    # real candidate (its +128-step upper bound is finite, so test the
    # LOWER bound)
    base = (
        q32, qsq, v1_ub + margin, v2_ub + margin, v1_lb > -jnp.inf, lane1,
    )
    if not top3:
        return base
    v2_lb, _ = plane_value_bounds(pk2)
    _, v3_ub = plane_value_bounds(pk3)
    lane2 = WINDOW - 1 - (pk2 & jnp.int32(WINDOW - 1))  # (B, NW)
    return base + (v3_ub + margin, lane2, v2_lb > -jnp.inf)


def _certify_and_refine(
    q32: jnp.ndarray,  # (B, d) f32 true queries
    qsq: jnp.ndarray,  # (B, 1)
    corpus_f: jnp.ndarray,  # (N, d) refine-domain rows
    corpus_sqnorms: jnp.ndarray,  # (N,)
    k: int,
    metric: str,
    valid_rows: Optional[jnp.ndarray],
    C: int,
    F: int,
    ub: jnp.ndarray,  # (B, NW) goodness upper bound for ANY row in window
    ub2: jnp.ndarray,  # (B, NW) goodness upper bound for any NON-ARGMAX row
    cand_live: jnp.ndarray,  # (B, NW) bool: window can hold candidates
    lane1: jnp.ndarray,  # (B, NW) argmax lane per window
    extra_fail: Optional[jnp.ndarray],  # bool: front-end soundness failure
    do_fallback: bool = True,
    # ---- large-k (top3) design: runner-up-row patches ----
    ub3: Optional[jnp.ndarray] = None,  # (B, NW) bound for rows 3..W
    lane2: Optional[jnp.ndarray] = None,  # (B, NW) runner-up lane
    live2: Optional[jnp.ndarray] = None,  # (B, NW) runner-up exists
    runner_budget: int = 8,  # R: flagged runner-up rows per query
    patch_windows: int = 2,  # P: whole-window patches per query
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """The scan-domain-agnostic tail of the bounded-exact design:
    top-C window selection by upper bound -> exact re-score ->
    certificates -> targeted window patches -> cond'd exact fallback.
    Both front-ends (bf16 packed-float planes; int8 exact-integer
    planes with quantization margins) feed it their goodness-domain
    bounds; exactness is theirs to guarantee, the tail only needs
    ``ub``/``ub2`` to be sound.  With ``do_fallback=False`` the exact
    full sort is SKIPPED — the caller (``_certify_escalate``) owns the
    failure path and the returned values are only valid where
    ``fell_back`` is False.

    With ``ub3``/``lane2``/``live2`` (the LARGE-K design): a window
    whose runner-up bound clears the threshold gets its runner-up ROW
    exactly scored (R per query, a (B, R)-row gather) instead of a
    whole-WINDOW patch, and the window patch layer keys off ``ub3``
    (third-row bound) instead of ``ub2``.  Rationale: at rerank-width
    k the top-k rows birthday-collide into shared windows (expected
    flagged queries ~ B*k^2/2NW — ~480/batch1024 at k=100), which
    swamps any whole-window patch budget F and forced the full sort
    every batch.  Triple collisions (~B*k^3/6NW^2, a handful per
    batch) still ride the window-patch layer."""
    b, d = q32.shape
    nw = ub.shape[1]

    # ---- candidates: top-C windows by upper bound, argmax rows exact.
    # approx_max_k (hardware partial-reduce) instead of a full sort
    # over the (B, NW) plane: cert_a below verifies COVERAGE — every
    # qualifying window must actually be in the selection — so a
    # recall miss here can cost a fallback, never exactness.
    #
    # Dead windows fold into the ub plane as -inf BEFORE selection
    # (one fused plane-wide where), so liveness and cert_a
    # qualification both read off the SELECTION VALUES — this removes
    # two (B, NW)-plane take_along_axis gathers (cand_live + the
    # qualifies plane).
    ub = jnp.where(cand_live, ub, -jnp.inf)
    if nw > 4096:
        sel_vals, wsel = jax.lax.approx_max_k(ub, C, recall_target=0.999)
    else:
        sel_vals, wsel = jax.lax.top_k(ub, C)  # (B, C)
    cand_idx = wsel * WINDOW + jnp.take_along_axis(lane1, wsel, axis=1)
    cand_ok = sel_vals > -jnp.inf
    if valid_rows is not None:
        # int-domain planes can surface an invalid argmax row (padding
        # is masked at the plane level only when the whole window is
        # invalid); the float domain folds -inf into the scan, where
        # this check is redundant but free
        cand_ok = cand_ok & jnp.take(valid_rows, cand_idx)
    cand_idx = jnp.where(cand_ok, cand_idx, 0)
    cand_rows = jnp.take(corpus_f, cand_idx, axis=0)  # (B, C, d)
    cand_xsq = jnp.take(corpus_sqnorms, cand_idx, axis=0)
    cand_g = _exact_scores(q32, cand_rows, cand_xsq, qsq, metric)
    cand_g = jnp.where(cand_ok, cand_g, -jnp.inf)

    ck_vals, _ = topk_tiebreak(cand_g, cand_idx, k)
    thr = ck_vals[:, k - 1]  # (B,)

    # ---- runner-up layer (large-k design): a window whose SECOND row
    # might clear thr gets that one row exactly scored — R per query
    cert_r_fail = jnp.asarray(False)
    runner_g = None
    runner_idx = None
    if ub3 is not None:
        # flags2 keys off the PRE-RUNNER threshold (it has to — the
        # runner scores don't exist yet), a lower bound on the final
        # k-th value, so the flag set is a sound superset
        flags2 = (ub2 >= thr[:, None]) & live2  # (B, NW)
        prio2 = jnp.where(flags2, ub2, -jnp.inf)
        R = min(runner_budget, nw)
        if nw > 4096:
            _, rsel = jax.lax.approx_max_k(prio2, R, recall_target=0.999)
        else:
            _, rsel = jax.lax.top_k(prio2, R)  # (B, R)
        r_live = jnp.take_along_axis(flags2, rsel, axis=1)
        r_idx = rsel * WINDOW + jnp.take_along_axis(lane2, rsel, axis=1)
        r_idx = jnp.where(r_live, r_idx, 0)
        if valid_rows is not None:
            r_live = r_live & jnp.take(valid_rows, r_idx)
        r_rows = jnp.take(corpus_f, r_idx, axis=0)  # (B, R, d)
        r_xsq = jnp.take(corpus_sqnorms, r_idx, axis=0)
        runner_g = jnp.where(
            r_live,
            _exact_scores(q32, r_rows, r_xsq, qsq, metric),
            -jnp.inf,
        )
        runner_idx = r_idx
        # cert_r: the budget held AND the (approx) selection covered
        # every flagged window — same coverage shape as cert_a
        count2 = jnp.sum(flags2, axis=1)
        cert_r_fail = jnp.any(
            (count2 > R) | (count2 != jnp.sum(r_live, axis=1))
        )
        # RAISE the threshold with the runner scores before the other
        # certificates: at rerank-width k the argmax-only candidate
        # k-th sits a full collision-count below the true k-th, and
        # every extra margin-width of threshold slack inflates the
        # cert_a/cert_b flag sets (measured: the 12-double planted
        # corpus cert_b-failed on background third rows with the
        # pre-runner thr).  Still a lower bound on the final k-th
        # (the merge is a superset of cand ∪ runner) — sound.
        mk_vals, _ = topk_tiebreak(
            jnp.concatenate([cand_g, runner_g], axis=1),
            jnp.concatenate([cand_idx, runner_idx], axis=1),
            k,
        )
        thr = mk_vals[:, k - 1]

    # ---- cert_a: every window that could clear thr is IN the
    # selection (counts both the budget and approx-selection recall).
    # sel_vals ARE ub[wsel] (top_k/approx_max_k return the actual
    # elements), so the selected-side count needs no plane gather.
    count_a = jnp.sum(ub >= thr[:, None], axis=1)
    sel_qual = jnp.sum(sel_vals >= thr[:, None], axis=1)
    cert_a_fail = jnp.any((count_a > C) | (count_a != sel_qual))

    # ---- cert_b: windows whose SECOND (large-k: THIRD) row might
    # clear thr -> whole-window patch
    flags = (ub2 if ub3 is None else ub3) >= thr[:, None]  # (B, NW)
    fcount = jnp.sum(flags, axis=1)  # (B,)
    prio = jnp.where(flags, ub2 if ub3 is None else ub3, -jnp.inf)
    P = min(patch_windows, nw)
    if P == 2:
        # top-2 flagged windows per query via two argmax passes (a
        # full top_k sort over the plane costs ms at NW ~ 8k; argmax
        # is a cheap reduction)
        w0 = jnp.argmax(prio, axis=1)
        prio_masked = prio.at[jnp.arange(b), w0].set(-jnp.inf)
        w1 = jnp.argmax(prio_masked, axis=1)
        pw = jnp.stack([w0, w1], axis=1)  # (B, 2)
        # slot-1 liveness from the MASKED plane: if only window 0 is
        # flagged, both argmaxes return 0 — reading prio for slot 1
        # would patch the same window twice (duplicate rows in the
        # merge)
        pv = jnp.stack(
            [
                jnp.take_along_axis(prio, w0[:, None], axis=1)[:, 0],
                jnp.take_along_axis(prio_masked, w1[:, None], axis=1)[:, 0],
            ],
            axis=1,
        )
    else:
        # dense large-k regimes (k approaching NW: margin-band windows
        # pile onto the same queries) need P > 2; lax.top_k returns
        # distinct positions so liveness is just finiteness
        pv, pw = jax.lax.top_k(prio, P)  # (B, P)
    n_flagged_q = jnp.sum(fcount > 0)
    cert_b_fail = jnp.any(fcount > P) | (n_flagged_q > F)

    # flagged-query compaction (top-F queries by flag count)
    _, qsel = jax.lax.top_k(fcount.astype(jnp.float32), F)  # (F,)
    q_active = fcount[qsel] > 0  # (F,)
    pq32 = q32[qsel]  # (F, d)
    pqsq = qsq[qsel]  # (F, 1)
    p_w = pw[qsel]  # (F, P)
    p_live = jnp.isfinite(pv[qsel]) & q_active[:, None]  # (F, P)
    p_lane1 = jnp.take_along_axis(lane1[qsel], p_w, axis=1)  # (F, P)

    def slice_window(w):
        rows = jax.lax.dynamic_slice(
            corpus_f, (w * WINDOW, 0), (WINDOW, corpus_f.shape[1])
        )
        xsq = jax.lax.dynamic_slice(corpus_sqnorms, (w * WINDOW,), (WINDOW,))
        return rows, xsq

    p_rows, p_xsq = jax.vmap(
        lambda ws: jax.vmap(slice_window)(ws)
    )(jnp.where(p_live, p_w, 0))  # (F, P, WINDOW, d), (F, P, WINDOW)
    p_g = _exact_scores(pq32, p_rows, p_xsq, pqsq, metric)  # (F, P, WINDOW)
    lanes = jnp.arange(WINDOW, dtype=jnp.int32)[None, None, :]
    p_idx = jnp.where(p_live, p_w, 0)[:, :, None] * WINDOW + lanes
    dead = (
        (lanes == p_lane1[:, :, None])  # argmax row: already a candidate
        | ~p_live[:, :, None]
    )
    if ub3 is not None:
        # large-k: a patched window's runner-up was exactly scored by
        # the runner-up layer (its ub2 >= ub3 >= thr, so it was
        # flagged2 and cert_r verified coverage) — mask it here or the
        # merge would hold the same row twice
        p_lane2 = jnp.take_along_axis(lane2[qsel], p_w, axis=1)  # (F, P)
        dead = dead | (lanes == p_lane2[:, :, None])
    if valid_rows is not None:
        dead = dead | ~jnp.take(valid_rows, p_idx)
    p_g = jnp.where(dead, -jnp.inf, p_g)

    extras_g = jnp.full((b, P * WINDOW), -jnp.inf, jnp.float32)
    extras_g = extras_g.at[qsel].set(p_g.reshape(F, P * WINDOW))
    extras_idx = jnp.zeros((b, P * WINDOW), jnp.int32)
    extras_idx = extras_idx.at[qsel].set(p_idx.reshape(F, P * WINDOW))

    n_patched = jnp.sum(p_live)
    fell_back = cert_a_fail | cert_r_fail | cert_b_fail
    if extra_fail is not None:
        fell_back = fell_back | extra_fail

    parts_g = [cand_g, extras_g]
    parts_i = [cand_idx, extras_idx]
    if runner_g is not None:
        parts_g.insert(1, runner_g)
        parts_i.insert(1, runner_idx)
    g_all = jnp.concatenate(parts_g, axis=1)
    idx_all = jnp.concatenate(parts_i, axis=1)
    fast_vals, fast_idx = topk_tiebreak(g_all, idx_all, k)
    if not do_fallback:
        return fast_vals, fast_idx, fell_back, n_patched

    vals, idx = jax.lax.cond(
        fell_back,
        lambda: _exact_full_sort(
            q32, corpus_f, corpus_sqnorms, k, metric, valid_rows
        ),
        lambda: (fast_vals, fast_idx),
    )
    return vals, idx, fell_back, n_patched


def _exact_full_sort(
    q: jnp.ndarray,
    corpus_f: jnp.ndarray,
    corpus_sqnorms: jnp.ndarray,
    k: int,
    metric: str,
    valid_rows: Optional[jnp.ndarray],
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The exact top-k over every row (``lax.top_k`` parity, ties to the
    lower index), chunked over queries, and over corpus rows when the
    scores of all rows do not fit ``_FULL_SORT_BYTES``: it never holds a
    (B, N) score matrix, nor an f32 copy of a bf16 store (61 GB for a
    25M-row bf16 shard).

    The bounded ops' unconditional-exactness backstop and the sharded
    exact mode's per-shard sort.  Rows are scored in the promoted dtype
    of ``q`` and the store: an f32 query scores in the refine domain of
    the fast path's f32 einsum (HIGHEST, inside ``_goodness``)."""
    b, d = q.shape
    n = corpus_f.shape[0]
    from qrag_tpu.ops.topk import _goodness

    chunk = min(b, 128)
    pad = (-b) % chunk
    qq = jnp.pad(q, ((0, pad), (0, 0))) if pad else q
    score_dtype = jnp.result_type(q.dtype, corpus_f.dtype)
    rows = _full_sort_rows(chunk, n, d, corpus_f.dtype, score_dtype)
    valid = jnp.ones((n,), bool) if valid_rows is None else valid_rows
    starts = jnp.arange(0, n, rows, dtype=jnp.int32)

    def one(qc):
        def step(best, start):
            # the last step's slice is clamped to end at n: rows before
            # ``start`` were scored by the previous step and are masked
            at = jnp.minimum(start, n - rows)
            idx = at + jnp.arange(rows, dtype=jnp.int32)
            x = jax.lax.dynamic_slice(corpus_f, (at, 0), (rows, d))
            g = _goodness(
                qc, x.astype(score_dtype), metric,
                jax.lax.dynamic_slice(corpus_sqnorms, (at,), (rows,)),
                jax.lax.dynamic_slice(valid, (at,), (rows,)) & (idx >= start),
            )
            v, i = jax.lax.top_k(g, min(k, rows))
            merged = topk_tiebreak(
                jnp.concatenate([best[0], v], axis=1),
                jnp.concatenate([best[1], idx[i]], axis=1),
                k,
            )
            return merged, None

        # sentinel ids >= n lose every tie to a real row, as the
        # lowest-index rule of lax.top_k over all rows requires; at
        # 2^30 they stay out of range when a shard offsets its ids
        init = (
            jnp.full((chunk, k), -jnp.inf, jnp.float32),
            jnp.broadcast_to(
                (1 << 30) + jnp.arange(k, dtype=jnp.int32), (chunk, k)
            ),
        )
        out, _ = jax.lax.scan(step, init, starts)
        return out

    vs, is_ = jax.lax.map(one, qq.reshape(-1, chunk, d))
    return vs.reshape(-1, k)[:b], is_.reshape(-1, k)[:b]


# bytes that one step of the exact sort may hold: its (chunk, rows)
# scores and, when the rows are sliced, the slice in the scoring dtype
_FULL_SORT_BYTES = 1 << 30


def _full_sort_rows(chunk: int, n: int, d: int, store_dtype, score_dtype) -> int:
    """Corpus rows per step of ``_exact_full_sort``: every row at once
    when the scores (and an f32 copy of a narrower store) fit the
    budget — one product over all rows is the fastest form on one card
    — else the largest slice that fits."""
    width = jnp.dtype(score_dtype).itemsize * d
    whole = 4 * chunk + (width if store_dtype != score_dtype else 0)
    if n * whole <= _FULL_SORT_BYTES:
        return n
    return max(1, min(n, _FULL_SORT_BYTES // (4 * chunk + width)))


def _certify_escalate(
    q32, qsq, corpus_f, corpus_sqnorms, k, metric, valid_rows, C, F,
    *, ub, ub2, cand_live, lane1, extra_fail,
    ub3=None, lane2=None, live2=None, runner_budget=8, patch_windows=2,
) -> Tuple[
    jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray
]:
    """Escalating-budget certification: try C, then 4C (reusing the
    SAME planes — no new scan), then the exact full sort.  The lean
    default budget rides the fast path on well-separated corpora; a
    tie-heavy corpus (duplicate rows spread over > C windows all
    clearing the top-k threshold) pays one bigger gather instead of
    the ~5x-headline-cost sort.  Returns the 5-tuple of the public
    ops (``bounded_exact_topk`` doc)."""
    b = q32.shape[0]
    nw = ub.shape[1]
    common = dict(
        ub=ub, ub2=ub2, cand_live=cand_live, lane1=lane1,
        extra_fail=extra_fail,
        ub3=ub3, lane2=lane2, live2=live2,
    )
    C2 = min(4 * C, nw)
    F2 = min(4 * F, b)
    R2 = min(4 * runner_budget, nw)
    # the per-query patch-window cap only widens in large-k mode (the
    # small-k headline path keeps the tuned 2-argmax selection at both
    # tiers); 4x covers the dense-regime band pileup measured at
    # k ~ NW/5 (max 9 flagged windows per query at k=100, NW=512)
    P2 = patch_windows if ub3 is None else min(4 * patch_windows, nw)
    if C2 <= C and (
        ub3 is None or (R2 <= runner_budget and P2 <= patch_windows)
    ):
        vals, idx, fb, npatch = _certify_and_refine(
            q32, qsq, corpus_f, corpus_sqnorms, k, metric, valid_rows,
            C, F, runner_budget=runner_budget,
            patch_windows=patch_windows, **common,
        )
        return vals, idx, fb, npatch, jnp.asarray(False)

    v1, i1, fb1, np1 = _certify_and_refine(
        q32, qsq, corpus_f, corpus_sqnorms, k, metric, valid_rows,
        C, F, do_fallback=False, runner_budget=runner_budget,
        patch_windows=patch_windows, **common,
    )
    # a front-end soundness failure (e.g. int8 key clipping) voids the
    # BOUNDS — no candidate budget can fix that, so escalation must
    # not run (it would pay the 4C gather only to fall back anyway):
    # route straight to the exact full sort instead
    esc = fb1 if extra_fail is None else fb1 & ~extra_fail

    def escalated():
        return _certify_and_refine(
            q32, qsq, corpus_f, corpus_sqnorms, k, metric, valid_rows,
            C2, F2, runner_budget=R2, patch_windows=P2, **common,
        )

    def fast_or_void():
        if extra_fail is None:
            return v1, i1, jnp.asarray(False), np1
        vals, idx = jax.lax.cond(
            extra_fail,
            lambda: _exact_full_sort(
                q32, corpus_f, corpus_sqnorms, k, metric, valid_rows
            ),
            lambda: (v1, i1),
        )
        return vals, idx, extra_fail, np1

    vals, idx, fb, npatch = jax.lax.cond(esc, escalated, fast_or_void)
    return vals, idx, fb, npatch, esc


def packed_window_scan_top2_int(
    q8: jnp.ndarray,  # (B, d) int8
    corpus_q8: jnp.ndarray,  # (N, d) int8; N % 128 == 0
    lane_rank: jnp.ndarray,  # (1, N)
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """XLA reference int top-2 window scan: packed keys carry the RAW
    int32 dots (exact — the int8 x int8 -> int32 accumulation
    has no rounding), shifted by 7 for the lane bits.  Twin of the
    int-domain arm of ``fused_scan._packed_top2_t_kernel``."""
    b = q8.shape[0]
    n = corpus_q8.shape[0]
    nw = n // WINDOW
    dots = jax.lax.dot_general(
        q8,
        corpus_q8,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    key = jnp.clip(dots, -_INT_CLAMP, _INT_CLAMP) << 7
    packed = (key | lane_rank).reshape(b, nw, WINDOW)
    pk1 = jnp.max(packed, axis=2)
    pk2 = jnp.max(
        jnp.where(packed == pk1[:, :, None], _I32_MIN, packed), axis=2
    )
    return pk1, pk2


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "metric", "candidates", "patch_queries",
    ),
)
def bounded_exact_topk_int8(
    queries: jnp.ndarray,  # (B, d) f32 true queries
    corpus_q8: jnp.ndarray,  # (N, d) int8 per-window codes; N % 128 == 0
    window_scales: jnp.ndarray,  # (NW,) f32 s_w (from quantize_block_rows*)
    corpus_f: jnp.ndarray,  # (N, d) refine-domain rows THE CODES CAME FROM
    corpus_sqnorms: jnp.ndarray,  # (N,) f32 refine-domain row sqnorms
    maxnorms: jnp.ndarray,  # (NW,) f32 max row L2 per window
    minsqnorms: jnp.ndarray,  # (NW,) f32 min row sqnorm per window
    window_resid: jnp.ndarray,  # (NW,) f32 max |x - s*x8|_2 per window
    lane_rank: jnp.ndarray,  # (1, N)
    k: int,
    metric: str = "l2",
    valid_rows: Optional[jnp.ndarray] = None,  # (N,) bool
    candidates: int = 48,
    patch_queries: int = 32,
) -> Tuple[
    jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray
]:
    """Provably-exact top-k with the SCAN in int8 arithmetic
    (the margin derivation extended to int8 block-quantization
    error).

    The scan packs EXACT int32 dots of per-window-quantized codes, so
    unlike the bf16 mode there is no scan rounding at all — the margin
    covers the QUANTIZATION residual instead.  With q = t*q_hat + eq,
    x = s_w*x_hat + ex, using the EXACT residual norms (rq := |eq|_2
    computed on device; rx_w := ``window_resid`` computed at
    quantization time — both rigorous in Cauchy-Schwarz and ~1.7x
    tighter than the worst-case sqrt(d)/2*scale), every row r in
    window w satisfies:

        |q.x_r - t*s_w*dot_int| <= (|q|+rq)*rx_w + (maxnorm_w+rx_w)*rq
                                    =: E[b, w]

    For l2 the plane ranks windows by DOT, not goodness, so the window
    goodness bound assumes the smallest-norm row (minsqnorms) — tight
    on normalized corpora (the north-star contract normalizes at
    ingestion), loose-but-sound otherwise.  Clipped keys (|dot_int| at
    the 2^23 clamp) void the bound and force the exact fallback —
    exactness stays unconditional.  Certification/patching/escalation/
    fallback is the shared ``_certify_escalate`` tail (same 5-tuple
    return as ``bounded_exact_topk``); the refine domain is
    ``corpus_f`` in f32, identical to the bf16 mode's contract."""
    b, d = queries.shape
    n = corpus_q8.shape[0]
    nw = n // WINDOW
    if nw < k:
        raise ValueError(
            f"bounded top-k needs >= k windows (k={k}, windows={nw}) — "
            "route small corpora to the exact sort"
        )
    C = min(max(candidates, k), nw)
    F = min(patch_queries, b)

    q32, qsq, ub, ub2, cand_live, lane1, clip_fail = window_bounds_int8(
        queries, corpus_q8, window_scales, corpus_f, corpus_sqnorms,
        maxnorms, minsqnorms, window_resid, lane_rank, metric=metric,
        valid_rows=valid_rows,
    )
    return _certify_escalate(
        q32, qsq, corpus_f, corpus_sqnorms, k, metric, valid_rows, C, F,
        ub=ub,
        ub2=ub2,
        cand_live=cand_live,
        lane1=lane1,
        extra_fail=clip_fail,
    )


def window_bounds_int8(
    queries: jnp.ndarray,  # (B, d) f32
    corpus_q8: jnp.ndarray,  # (N, d) int8
    window_scales: jnp.ndarray,  # (NW,) f32
    corpus_f: jnp.ndarray,  # (N, d) refine-domain rows
    corpus_sqnorms: jnp.ndarray,  # (N,)
    maxnorms: jnp.ndarray,  # (NW,)
    minsqnorms: jnp.ndarray,  # (NW,)
    window_resid: jnp.ndarray,  # (NW,)
    lane_rank: jnp.ndarray,  # (1, N)
    metric: str = "l2",
    valid_rows=None,
):
    """int8-scan front-end: exact int32 window dots + quantization-
    residual margins.  Returns (q32, qsq, ub, ub2, cand_live, lane1,
    clip_fail) — the certificate inputs of ``_certify_escalate``
    (clip_fail = bounds void, route straight to the exact sort).
    Exposed for the same reason as ``window_bounds_bf16``: the band
    census must measure the PRODUCTION bound formulas."""
    b, d = queries.shape
    n = corpus_q8.shape[0]
    nw = n // WINDOW
    q32 = queries.astype(jnp.float32)
    qsq = jnp.sum(q32 * q32, axis=-1, keepdims=True)
    qnorm = jnp.sqrt(qsq)[:, 0]  # (B,)

    # per-query symmetric int8 (same scheme as the corpus windows)
    q_absmax = jnp.max(jnp.abs(q32), axis=1)
    t = jnp.where(q_absmax > 0, q_absmax / 127.0, 1.0)  # (B,)
    q8 = jnp.clip(
        jnp.round(q32 / t[:, None]), -127, 127
    ).astype(jnp.int8)

    pk1, pk2 = packed_window_scan_top2_int(q8, corpus_q8, lane_rank)

    dot1 = pk1 >> 7  # EXACT int dot of each window's argmax row
    lane1 = WINDOW - 1 - (pk1 & jnp.int32(WINDOW - 1))
    pk2_masked = pk2 == _I32_MIN
    dot2 = pk2 >> 7
    # a clipped key voids the upper bound: force the exact fallback
    clip_fail = jnp.any(jnp.abs(dot1) >= _INT_CLAMP) | jnp.any(
        jnp.where(pk2_masked, 0, jnp.abs(dot2)) >= _INT_CLAMP
    )

    scale_bw = t[:, None] * window_scales[None, :]  # (B, NW)
    s1 = scale_bw * dot1.astype(jnp.float32)
    s2 = scale_bw * dot2.astype(jnp.float32)
    # EXACT residual norms (rigorous and ~1.7x tighter than the
    # sqrt(d)/2*scale worst case — see window_quant_residuals_device)
    q_deq = q8.astype(jnp.float32) * t[:, None]
    rq = (
        jnp.sqrt(jnp.sum((q32 - q_deq) ** 2, axis=1)) * (1.0 + 1e-5)
        + 1e-20
    )  # (B,)
    rx = window_resid  # (NW,)
    E = (
        (qnorm + rq)[:, None] * rx[None, :]
        + (maxnorms + rx)[None, :] * rq[:, None]
    )
    # _SAFETY absorbs the f32 rounding of computing E/s1 themselves;
    # the margin_coeff term covers the refine evaluation's own
    # f32 accumulation-order drift; 2e-7|s1| covers the two scaling
    # multiplies in s1/s2
    E = (
        _SAFETY * E
        + margin_coeff(jnp.float32, jnp.float32, jnp.float32, d)
        * qnorm[:, None]
        * maxnorms[None, :]
        + 2e-7 * jnp.abs(s1)
        + 1e-30
    )

    if metric == "l2":
        extra = 5e-7 * (qsq + maxnorms[None, :] ** 2)
        ub = 2.0 * (s1 + E) - qsq - minsqnorms[None, :] + extra
        ub2 = jnp.where(
            pk2_masked,
            -jnp.inf,
            2.0 * (s2 + E) - qsq - minsqnorms[None, :] + extra,
        )
    elif metric == "ip":
        ub = s1 + E
        ub2 = jnp.where(pk2_masked, -jnp.inf, s2 + E)
    else:
        raise ValueError(f"unknown metric {metric!r}")

    cand_live = jnp.ones((b, nw), bool)
    if valid_rows is not None:
        # windows with no valid row must not qualify (their quantized
        # zero-padding rows carry dot 0, which can beat real negative
        # scores); partially-valid windows stay live — an invalid
        # argmax row is dropped at the candidate level and any valid
        # runner-up is covered by ub2/patching
        wvalid = jnp.any(valid_rows.reshape(nw, WINDOW), axis=1)[None, :]
        ub = jnp.where(wvalid, ub, -jnp.inf)
        ub2 = jnp.where(wvalid, ub2, -jnp.inf)
        cand_live = jnp.broadcast_to(wvalid, (b, nw))


    return q32, qsq, ub, ub2, cand_live, lane1, clip_fail

