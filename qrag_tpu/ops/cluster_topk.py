"""Cluster-pruned provably-exact top-k: the LATENCY-mode complement to
``ops.bounded_topk``.

The bounded mode is throughput-shaped: one full scan pass computes
every dot product (the batch amortizes the corpus read), and pruning
only trims the SELECTION work.  At small batch the scan is
HBM-bandwidth-bound instead — reading a 1M x 768 bf16 corpus is
~1.5 GB per batch no matter how small B is — so the latency lever is
pruning the READS, not the selection.  (The round-4 int8 pre-filter
census killed read-pruning for B=1024: the batch-union of surviving
regions is the whole corpus.  At B <= ~32 the union is small — that
regime flip is what this op serves.)

Design — the FAISS-IVF shape rebuilt for an accelerator, but EXACT (the
reference family's ``faiss.IndexFlatL2``, ``store_in_faiss.py:105``,
is exact; classical IVF trades exactness for speed — this op refuses
that trade):

  build (``build_clustered_groups``): device k-means over the stored
  rows, then a stable sort of rows by (cluster, original index) into
  FIXED-SIZE groups of ``group_rows`` consecutive permuted rows.
  Fixed groups keep every shape static for XLA; mis-grouped rows only
  inflate that group's radius (a quality, never a correctness, cost).
  Per group: centroid, covering radius max |x - c|, max row norm.

  search (``cluster_pruned_topk``): score the B queries against the
  G centroids (a tiny matmul), convert to rigorous per-group
  goodness upper bounds (triangle inequality + f32 evaluation-drift
  margins), exactly score every row of the top-S groups (S CONTIGUOUS
  ``dynamic_slice`` reads per query — no random row gather), and
  certify: if <= S groups have ub >= the k-th exact candidate score,
  every unread row provably scores below the top-k.  Certificate
  failure escalates to 4S (one bigger read, no rebuild), then falls
  back to a chunked full scan with original-index tie-break merging.
  Exactness is unconditional; clustering quality only decides how
  often the fast path applies.

Result contract matches ``bounded_exact_topk``: exact top-k goodness
(descending) of the refine-domain scoring function over the ORIGINAL
row indices, ties broken by lower original index; finalize to
distances at the API edge (``ops.topk._finalize``).

Tie caveat (the same class every exact mode documents): a row scored
by the fast path's gathered einsum and a bitwise-identical row scored
by the fallback's matmul can drift ~1e-7 apart (two f32 contraction
orders of the same dot), so sub-noise ties across DIFFERENT
evaluation paths — e.g. duplicate rows on different shards when one
shard falls back — order by that drift rather than by index.  Within
one evaluation path the index tie-break is exact.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from qrag_tpu.ops.bounded_topk import (
    _SAFETY,
    _exact_scores,
    margin_coeff,
    topk_tiebreak,
)

# groups per fallback chunk: the build pads G to a multiple of this so
# the chunked exact fallback can reshape (N_pad, d) statically
_FALLBACK_GROUP_CHUNK = 16


def _acc_rel(d: int) -> float:
    """Relative error bound of one f32 reduction over d terms
    (d * eps_f32 ~ 4.6e-5 at d=768, with ~1.6x headroom).  Unlike the
    bounded mode — whose affine terms are the SAME fl values on both
    sides of the certificate and cancel — the cluster bound compares
    fl-computed stats (qsq, csq, radii, sqnorms) against TRUE
    geometric quantities, so each one's own computation error must be
    covered explicitly."""
    return max(d, 768) / 768.0 * 7.5e-5


class ClusteredGroups(NamedTuple):
    """Device-resident acceleration structure over a permuted corpus.

    ``corpus_p``/``sqnorms_p``/``orig_idx``/``valid_p`` are the
    permuted (cluster-contiguous, padded) row arrays; ``centroids``,
    ``csq``, ``radii``, ``maxnorms``, ``group_valid`` are per-group
    stats.  Geometry stats (centroids/radii/maxnorms) come from the
    STORED rows (cast to f32); ``sqnorms_p`` — the array the refine
    actually SCORES with — may instead be the caller's master-copy f32
    norms (``build_clustered_groups(sqnorms=...)``), in which case
    ``norm_gap`` carries the per-group positive part of
    (stored-row norm^2 - scoring norm^2) and the upper bounds widen by
    it, keeping certification sound while the scoring function matches
    the index's other l2 paths bit-for-bit (ADVICE r4: a bf16 store
    scored with stored-row norms ranked differently from the plain
    scan's master-f32 norms)."""

    corpus_p: jnp.ndarray  # (N_pad, d) store dtype
    sqnorms_p: jnp.ndarray  # (N_pad,) f32 (the SCORING norms)
    orig_idx: jnp.ndarray  # (N_pad,) int32 (pad rows: 2^30)
    valid_p: jnp.ndarray  # (N_pad,) bool
    centroids: jnp.ndarray  # (G, d) f32
    csq: jnp.ndarray  # (G,) f32
    radii: jnp.ndarray  # (G,) f32 (inflated for f32 rounding)
    maxnorms: jnp.ndarray  # (G,) f32
    norm_gap: jnp.ndarray  # (G,) f32 max(stored sq - scoring sq, 0)
    group_valid: jnp.ndarray  # (G,) bool
    group_rows: int  # L (static)


_PAD_IDX = np.int32(1 << 30)


@functools.partial(jax.jit, static_argnames=("n_clusters", "iters", "chunk"))
def _kmeans_assign(
    x32: jnp.ndarray,  # (N, d) f32
    init: jnp.ndarray,  # (n_clusters, d) f32
    n_clusters: int,
    iters: int,
    chunk: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Lloyd's k-means on device, chunked over rows (the assignment
    matmul and the one-hot accumulation are both matmuls).  Returns
    (centroids (G0, d), assignment (N,) int32).  Build-time only —
    clustering QUALITY affects pruning rate, never exactness."""
    n, d = x32.shape
    pad = (-n) % chunk
    xp = jnp.pad(x32, ((0, pad), (0, 0)))
    w = jnp.pad(jnp.ones((n,), jnp.float32), (0, pad))
    xc = xp.reshape(-1, chunk, d)
    wc = w.reshape(-1, chunk)

    def step(c, _):
        csq = jnp.sum(c * c, axis=1)

        def acc(carry, inp):
            sums, counts = carry
            xb, wb = inp
            a = jnp.argmax(
                xb @ c.T - 0.5 * csq[None, :], axis=1
            )  # (chunk,) l2 assignment
            one = (
                jax.nn.one_hot(a, n_clusters, dtype=jnp.float32)
                * wb[:, None]
            )
            return (sums + one.T @ xb, counts + one.sum(axis=0)), None

        (sums, counts), _ = jax.lax.scan(
            acc,
            (jnp.zeros_like(c), jnp.zeros((n_clusters,), jnp.float32)),
            (xc, wc),
        )
        # empty clusters keep their previous centroid
        c_new = jnp.where(
            counts[:, None] > 0, sums / jnp.maximum(counts[:, None], 1.0), c
        )
        return c_new, None

    cent, _ = jax.lax.scan(step, init, None, length=iters)
    return cent, _kmeans_assign_only(x32, cent, chunk)


@functools.partial(jax.jit, static_argnames=("chunk",))
def _kmeans_assign_only(
    x32: jnp.ndarray, cent: jnp.ndarray, chunk: int
) -> jnp.ndarray:
    """One chunked assignment pass of every row to its nearest
    centroid (l2 via the dot identity)."""
    n, d = x32.shape
    pad = (-n) % chunk
    xc = jnp.pad(x32, ((0, pad), (0, 0))).reshape(-1, chunk, d)
    csq = jnp.sum(cent * cent, axis=1)

    def assign(xb):
        return jnp.argmax(xb @ cent.T - 0.5 * csq[None, :], axis=1)

    return jax.lax.map(assign, xc).reshape(-1)[:n].astype(jnp.int32)


def cluster_assignments(
    corpus: jnp.ndarray,  # (N, d)
    group_rows: int = 512,
    rows_per_cluster: int = 0,  # 0 = 4 * group_rows
    kmeans_iters: int = 6,
    seed: int = 0,
    chunk: int = 16384,
) -> np.ndarray:
    """The expensive half of the build: k-means cluster assignment of
    every row.  The returned (N,) int32 vector is the thing worth
    PERSISTING (``DeviceFlatIndex.save_native``): the rest of the
    structure rebuilds from it in one cheap pass.  ANY assignment
    vector yields a correct (exact) structure — its quality only
    decides the pruning rate."""
    corpus = jnp.asarray(corpus)
    n, d = corpus.shape
    x32 = corpus.astype(jnp.float32)
    # clusters several groups wide: the layout pads each cluster to a
    # group boundary, so cluster width / group_rows sets the padding
    # overhead (~L/2 pad rows per cluster -> ~12% at 4L)
    rpc = rows_per_cluster or 4 * group_rows
    n_clusters = max(1, n // rpc)

    rng = np.random.default_rng(seed)
    init_rows = np.sort(rng.choice(n, size=n_clusters, replace=False))
    init = x32[jnp.asarray(init_rows)]
    # Lloyd iterations train on a SUBSAMPLE (clustering quality only
    # affects the pruning rate, never exactness); the full corpus gets
    # exactly one assignment pass.  At 1M x 768 this cuts the build
    # from ~9 TFLOP of f32 matmuls to ~2 TFLOP.
    train_cap = max(131072, 64 * n_clusters)
    if n > train_cap:
        stride = -(-n // train_cap)
        x_train = x32[::stride]
    else:
        x_train = x32
    cent, _ = _kmeans_assign(
        x_train, init, n_clusters, kmeans_iters,
        min(chunk, x_train.shape[0]),
    )
    assign = _kmeans_assign_only(x32, cent, min(chunk, n))
    return np.asarray(assign, np.int32)


def build_clustered_groups(
    corpus: jnp.ndarray,  # (N, d) store dtype (device or host)
    group_rows: int = 512,
    rows_per_cluster: int = 0,
    kmeans_iters: int = 6,
    seed: int = 0,
    chunk: int = 16384,
    assign: Optional[np.ndarray] = None,
    sqnorms: Optional[jnp.ndarray] = None,  # (N,) f32 SCORING norms
) -> ClusteredGroups:
    """Build the acceleration structure (offline; one device pass per
    k-means iteration plus one permutation gather).  Pass a persisted
    ``assign`` (from ``cluster_assignments``) to skip the k-means.

    Pass ``sqnorms`` = the index's master-copy f32 row norms to make
    the accelerator SCORE with exactly the same refine function as the
    index's other l2 paths (``flat_index.py:338``: sqnorms come from
    the f32 master even on a bf16 store).  The group bounds then widen
    by the per-group ``norm_gap`` = max(stored-row sq - scoring sq, 0),
    so certification stays rigorous; without it a bf16 store ranked by
    stored-row norms diverged from the plain scan (ADVICE r4 medium).

    Layout invariant: every cluster is padded to a GROUP boundary, so
    no group ever spans two clusters.  (The first cut chunked the
    cluster-sorted rows into fixed groups directly; with cluster size
    ~ group size nearly every group then straddled two arbitrary
    clusters and its radius covered the inter-cluster distance — the
    bounds pruned nothing.  ~L/2 pad rows per cluster is the price of
    radii that reflect actual cluster geometry.)"""
    corpus = jnp.asarray(corpus)
    n, d = corpus.shape
    L = group_rows
    if sqnorms is not None and jnp.shape(sqnorms) != (n,):
        raise ValueError(
            f"sqnorms shape {jnp.shape(sqnorms)} does not match n={n}"
        )
    if n == 0:
        return empty_groups(d, L, corpus.dtype)
    if n < L and assign is None:
        # too few rows to cluster usefully — one sequential group
        # (bounds are sound over any grouping; a single group means
        # tier-1 scores everything, which is exactly right this small)
        assign = np.zeros((n,), np.int32)
    if assign is None:
        assign = cluster_assignments(
            corpus, group_rows=L, rows_per_cluster=rows_per_cluster,
            kmeans_iters=kmeans_iters, seed=seed, chunk=chunk,
        )
    else:
        assign = np.asarray(assign, np.int32)
        if assign.shape != (n,) or (
            n and (assign.min() < 0 or assign.max() >= n)
        ):
            # the max bound also keeps a corrupted artifact from
            # driving np.bincount into a (max+1)-sized allocation
            raise ValueError(
                "persisted cluster assignment does not match the "
                f"corpus (shape {assign.shape} vs n={n}) — rebuild it"
            )

    # stable sort by (cluster, original index): equal-cluster rows
    # keep ascending original order, aligning group-internal tie-break
    # positions with the original-index contract
    order = np.lexsort((np.arange(n), assign)).astype(np.int64)
    sizes = np.bincount(assign)
    sizes = sizes[sizes > 0]  # empty clusters contribute no groups
    padded = (-(-sizes // L) * L).astype(np.int64)
    g_total = int(padded.sum()) // L
    g_pad = -(-g_total // _FALLBACK_GROUP_CHUNK) * _FALLBACK_GROUP_CHUNK
    n_pad = g_pad * L
    perm_p = np.zeros((n_pad,), np.int32)
    valid = np.zeros((n_pad,), bool)
    starts = np.concatenate([[0], np.cumsum(padded)])[:-1]
    src = 0
    for c, (off, size) in enumerate(zip(starts, sizes)):
        perm_p[off : off + size] = order[src : src + size]
        valid[off : off + size] = True
        src += size
    orig_idx = np.where(valid, perm_p, _PAD_IDX).astype(np.int32)

    perm_j = jnp.asarray(perm_p)
    valid_j = jnp.asarray(valid)
    corpus_p = jnp.take(corpus, perm_j, axis=0)
    corpus_p = jnp.where(valid_j[:, None], corpus_p, 0).astype(corpus.dtype)

    @jax.jit
    def group_stats(cp):
        x = cp.astype(jnp.float32)
        sq = jnp.sum(x * x, axis=1)
        xg = x.reshape(g_pad, L, d)
        vg = valid_j.reshape(g_pad, L)
        cnt = jnp.sum(vg, axis=1).astype(jnp.float32)
        cent = jnp.sum(
            jnp.where(vg[:, :, None], xg, 0.0), axis=1
        ) / jnp.maximum(cnt[:, None], 1.0)
        diff = xg - cent[:, None, :]
        dist = jnp.sqrt(jnp.sum(diff * diff, axis=2))
        radii = jnp.max(jnp.where(vg, dist, 0.0), axis=1)
        mxn = jnp.sqrt(jnp.max(jnp.where(vg, sq.reshape(g_pad, L), 0.0), axis=1))
        # inflate for the f32 rounding of computing the stats
        # themselves: a d-term reduction carries ~d*eps_f32 relative
        # error (_acc_rel), not the 1e-5 the first cut assumed
        infl = 1.0 + _acc_rel(d)
        radii = radii * infl + 1e-20
        mxn = mxn * infl + 1e-20
        csq = jnp.sum(cent * cent, axis=1)
        return sq, cent, csq, radii, mxn, cnt > 0

    sq, cent, csq, radii, mxn, gvalid = group_stats(corpus_p)
    sq = jnp.where(valid_j, sq, 0.0)
    if sqnorms is None:
        # scoring norms == stored-row norms: no gap (their own f32
        # computation error is covered by _group_upper_bounds'
        # acc*(qsq + mxn^2) term)
        norm_gap = jnp.zeros((g_pad,), jnp.float32)
    else:
        @jax.jit
        def score_norms(sq_stored, sq_master, perm, vld):
            sq_m = jnp.where(
                vld, jnp.take(sq_master.astype(jnp.float32), perm), 0.0
            )
            # positive part of (stored sq - scoring sq), per group: the
            # refine subtracts the SCORING norm while the geometric
            # decomposition produces the STORED one — the ub must
            # absorb the difference.  Both operands are concrete f32
            # values; 1e-6 covers the subtraction's own rounding.
            gap = jnp.maximum(sq_stored - sq_m, 0.0)
            gap = jnp.max(
                jnp.where(vld, gap, 0.0).reshape(g_pad, L), axis=1
            )
            return sq_m, gap * (1.0 + 1e-6) + 1e-30

        sq, norm_gap = score_norms(
            sq, jnp.asarray(sqnorms), perm_j, valid_j
        )
    return ClusteredGroups(
        corpus_p=corpus_p,
        sqnorms_p=sq,
        orig_idx=jnp.asarray(orig_idx),
        valid_p=valid_j,
        centroids=cent,
        csq=csq,
        radii=radii,
        maxnorms=mxn,
        norm_gap=norm_gap,
        group_valid=gvalid,
        group_rows=L,
    )


def empty_groups(d: int, group_rows: int, dtype) -> ClusteredGroups:
    """All-invalid structure for a rowless corpus/shard: every group
    bound is -inf, every row invalid — it contributes nothing and
    certifies trivially (the sharded accelerator needs a well-shaped
    placeholder for shards the capacity padding left empty)."""
    L = group_rows
    n_pad = _FALLBACK_GROUP_CHUNK * L
    g = _FALLBACK_GROUP_CHUNK
    return ClusteredGroups(
        corpus_p=jnp.zeros((n_pad, d), dtype),
        sqnorms_p=jnp.zeros((n_pad,), jnp.float32),
        orig_idx=jnp.full((n_pad,), int(_PAD_IDX), jnp.int32),
        valid_p=jnp.zeros((n_pad,), bool),
        centroids=jnp.zeros((g, d), jnp.float32),
        csq=jnp.zeros((g,), jnp.float32),
        radii=jnp.zeros((g,), jnp.float32),
        maxnorms=jnp.zeros((g,), jnp.float32),
        norm_gap=jnp.zeros((g,), jnp.float32),
        group_valid=jnp.zeros((g,), bool),
        group_rows=L,
    )


def _group_upper_bounds(
    q32: jnp.ndarray,  # (B, d)
    qsq: jnp.ndarray,  # (B, 1)
    cg: ClusteredGroups,
    metric: str,
    d: int,
) -> jnp.ndarray:
    """(B, G) rigorous goodness upper bound for ANY valid row of each
    group: triangle inequality over the centroid/radius, plus margins
    for (a) the f32 evaluation drift of the centroid dot computed
    here, and (b) the refine evaluation's own drift vs exact math
    (``_exact_scores`` is a fresh f32 einsum)."""
    qn = jnp.sqrt(qsq)  # (B, 1)
    cn = jnp.sqrt(cg.csq)[None, :]  # (1, G)
    qc = jnp.dot(
        q32, cg.centroids.T, precision=jax.lax.Precision.HIGHEST
    )  # (B, G) f32; the e_qc margin assumes true f32 arithmetic
    coeff = margin_coeff(jnp.float32, jnp.float32, jnp.float32, d)
    acc = _acc_rel(d)
    e_qc = coeff * qn * cn  # |fl(q.c) - q.c| bound (safety included)
    mxn = cg.maxnorms[None, :]
    if metric == "l2":
        # refine evaluation: g_r = 2*fl(q.x_r) - qsq_a - xsq_a.  Via
        # 2 q.x = qsq_true + xsq_true - |q-x|^2:
        #   g_r <= (qsq_true - qsq_a) + (xsq_true - xsq_a)
        #          - dist_lb^2 + 2*coeff*|q|*maxnorm
        # The first two terms are the fl-computation errors of the
        # STORED norm arrays (they do NOT cancel here the way the
        # bounded mode's shared affine terms do) — cover each with
        # _acc_rel of its magnitude.
        refine_m = (
            2.0 * coeff * qn * mxn + acc * (qsq + mxn * mxn)
            # scoring-norm gap: the refine subtracts cg.sqnorms_p
            # (possibly master-copy norms) while the decomposition
            # 2 q.x = qsq + |x_stored|^2 - |q - x_stored|^2 produces
            # the stored-row norm — absorb the per-group difference
            + cg.norm_gap[None, :] + 1e-30
        )
        d2 = qsq + cg.csq[None, :] - 2.0 * qc
        # |fl(d2) - d2_true| <= 2 e_qc + acc*(qsq + csq) (the norm
        # arrays' own errors) + association dust (inside _SAFETY)
        e2 = _SAFETY * (
            2.0 * e_qc + acc * (qsq + cg.csq[None, :])
        )
        d_lb = jnp.sqrt(jnp.maximum(d2 - e2, 0.0))
        dist_lb = jnp.maximum(d_lb - cg.radii[None, :], 0.0)
        ub = -(dist_lb * dist_lb) + refine_m
    elif metric == "ip":
        # fl(q.x_r) <= q.c_true + |q| r_true + coeff*|q|*maxnorm
        #           <= fl(qc) + e_qc + |q| r + refine drift
        # (radii/maxnorms already inflated by _acc_rel at build)
        refine_m = coeff * qn * mxn
        ub = qc + _SAFETY * e_qc + qn * cg.radii[None, :] + refine_m
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return jnp.where(cg.group_valid[None, :], ub, -jnp.inf)


def _score_selected_groups(
    q32: jnp.ndarray,  # (B, d)
    qsq: jnp.ndarray,
    cg: ClusteredGroups,
    gsel: jnp.ndarray,  # (B, S) int32 group ids
    metric: str,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exactly score every row of the selected groups.  Returns
    ((B, S*L) goodness, (B, S*L) original indices) — each group read
    is ONE contiguous (L, d) dynamic_slice (no random row gather)."""
    L = cg.group_rows
    d = cg.corpus_p.shape[1]
    b, S = gsel.shape

    def one_group(g):
        rows = jax.lax.dynamic_slice(cg.corpus_p, (g * L, 0), (L, d))
        xsq = jax.lax.dynamic_slice(cg.sqnorms_p, (g * L,), (L,))
        oid = jax.lax.dynamic_slice(cg.orig_idx, (g * L,), (L,))
        vld = jax.lax.dynamic_slice(cg.valid_p, (g * L,), (L,))
        return rows, xsq, oid, vld

    parts_g, parts_i = [], []
    for s in range(S):
        rows, xsq, oid, vld = jax.vmap(one_group)(gsel[:, s])
        gsc = _exact_scores(q32, rows, xsq, qsq, metric)  # (B, L)
        gsc = jnp.where(vld, gsc, -jnp.inf)
        oid = jnp.where(vld, oid, _PAD_IDX)
        parts_g.append(gsc)
        parts_i.append(oid)
    return (
        jnp.concatenate(parts_g, axis=1),
        jnp.concatenate(parts_i, axis=1),
    )


def _certify_tier(
    q32, qsq, cg: ClusteredGroups, ub, k: int, S: int, metric: str
):
    """One certification tier at budget S: select, exactly score,
    threshold, certify.  Returns (vals, idx, fail)."""
    g_count = ub.shape[1]
    S = min(S, g_count)
    _, gsel = jax.lax.top_k(ub, S)  # (B, S) exact selection
    cand_g, cand_i = _score_selected_groups(q32, qsq, cg, gsel, metric)
    vals, idx = topk_tiebreak(cand_g, cand_i, k)
    thr = vals[:, k - 1]
    # every group whose bound clears thr must be inside the selection:
    # with EXACT top-S selection, count <= S implies coverage (if a
    # qualifying group were excluded, S higher-ub groups would also
    # qualify, making count > S)
    count = jnp.sum(ub >= thr[:, None], axis=1)
    # a -inf threshold (fewer than k real rows read) voids the
    # certificate logic: force the fallback, which handles tiny/padded
    # corpora unconditionally
    fail = jnp.any(count > S) | jnp.any(~jnp.isfinite(thr))
    return vals, idx, fail


def _fallback_full(
    q32: jnp.ndarray, qsq: jnp.ndarray, cg: ClusteredGroups, k: int,
    metric: str,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Unconditional-exactness backstop: chunked scan of the PERMUTED
    corpus with original-index tie-break merging (lax.top_k position
    ties would follow the permuted order, so the merge carries
    (goodness, original index) pairs through ``topk_tiebreak`` — the
    same order-insensitive merge the sharded ring uses)."""
    n_pad, d = cg.corpus_p.shape
    L = cg.group_rows
    ch = _FALLBACK_GROUP_CHUNK * L
    n_chunks = n_pad // ch
    b = q32.shape[0]

    xc = cg.corpus_p.reshape(n_chunks, ch, d)
    sqc = cg.sqnorms_p.reshape(n_chunks, ch)
    oc = cg.orig_idx.reshape(n_chunks, ch)
    vc = cg.valid_p.reshape(n_chunks, ch)

    def body(carry, inp):
        cv, ci = carry
        xb, sb, ob, vb = inp
        # refine-domain scoring of rows SHARED across queries (the
        # same f32 math as _exact_scores, without its per-query row
        # batching).  HIGHEST precision: a DEFAULT f32 product may
        # run in TF32 on a GPU (~1e-3 relative) while the documented
        # cross-path tie caveat is sized for f32-order noise ~1e-7
        dots = jnp.dot(
            q32, xb.astype(jnp.float32).T,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        g = 2.0 * dots - qsq - sb[None, :] if metric == "l2" else dots
        g = jnp.where(vb[None, :], g, -jnp.inf)
        oid = jnp.where(vb[None, :], ob[None, :], _PAD_IDX)
        oid = jnp.broadcast_to(oid, g.shape)
        mv, mi = topk_tiebreak(
            jnp.concatenate([cv, g], axis=1),
            jnp.concatenate([ci, oid], axis=1),
            k,
        )
        return (mv, mi), None

    init = (
        jnp.full((b, k), -jnp.inf, jnp.float32),
        jnp.full((b, k), int(_PAD_IDX), jnp.int32),
    )
    (vals, idx), _ = jax.lax.scan(body, init, (xc, sqc, oc, vc))
    return vals, idx


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "budget", "group_rows")
)
def _cluster_probe_topk_impl(
    queries: jnp.ndarray,
    corpus_p, sqnorms_p, orig_idx, valid_p,
    centroids, csq, radii, maxnorms, norm_gap, group_valid,
    k: int, metric: str, budget: int, group_rows: int,
):
    """IVF-style PROBE search: score the top-S groups, skip the
    certificates — classic FAISS-IVF nprobe semantics (S == nprobe in
    group units).  Approximate by design: recall rises with S; scores
    of returned hits are still exact refine-domain evaluations.  The
    certified op is the default — this exists for callers who
    explicitly accept IVF's recall/latency trade."""
    cg = ClusteredGroups(
        corpus_p, sqnorms_p, orig_idx, valid_p,
        centroids, csq, radii, maxnorms, norm_gap, group_valid,
        group_rows,
    )
    b, d = queries.shape
    q32 = queries.astype(jnp.float32)
    qsq = jnp.sum(q32 * q32, axis=1, keepdims=True)
    ub = _group_upper_bounds(q32, qsq, cg, metric, d)
    S = min(max(budget, k), ub.shape[1])
    _, gsel = jax.lax.top_k(ub, S)
    cand_g, cand_i = _score_selected_groups(q32, qsq, cg, gsel, metric)
    return topk_tiebreak(cand_g, cand_i, k)


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "budget", "group_rows")
)
def _cluster_pruned_topk_impl(
    queries: jnp.ndarray,
    corpus_p, sqnorms_p, orig_idx, valid_p,
    centroids, csq, radii, maxnorms, norm_gap, group_valid,
    k: int, metric: str, budget: int, group_rows: int,
):
    cg = ClusteredGroups(
        corpus_p, sqnorms_p, orig_idx, valid_p,
        centroids, csq, radii, maxnorms, norm_gap, group_valid,
        group_rows,
    )
    b, d = queries.shape
    q32 = queries.astype(jnp.float32)
    qsq = jnp.sum(q32 * q32, axis=1, keepdims=True)

    ub = _group_upper_bounds(q32, qsq, cg, metric, d)
    g_count = ub.shape[1]
    S1 = min(max(budget, k), g_count)
    v1, i1, f1 = _certify_tier(q32, qsq, cg, ub, k, S1, metric)
    # a structure with NO valid rows (an empty shard's placeholder)
    # trivially certifies: its all--inf fast result IS exact, and
    # letting the -inf threshold void the cert would count phantom
    # fallbacks on every sharded query
    f1 = f1 & jnp.any(cg.valid_p)
    S2 = min(4 * S1, g_count)
    if S2 <= S1:
        # budget already covers every group: tier 1 scored the whole
        # corpus, the certificate cannot fail on coverage — only on a
        # degenerate threshold, which the fallback handles.  The
        # escalated flag mirrors f1 so the counters keep the ladder
        # invariant (a fallback is always preceded by a tier-1
        # failure) even though there is no distinct 4x tier here.
        vals, idx = jax.lax.cond(
            f1,
            lambda: _fallback_full(q32, qsq, cg, k, metric),
            lambda: (v1, i1),
        )
        return vals, idx, f1, f1

    def escalated():
        v2, i2, f2 = _certify_tier(q32, qsq, cg, ub, k, S2, metric)
        vals, idx = jax.lax.cond(
            f2,
            lambda: _fallback_full(q32, qsq, cg, k, metric),
            lambda: (v2, i2),
        )
        return vals, idx, f2

    def fast():
        return v1, i1, jnp.asarray(False)

    vals, idx, fb = jax.lax.cond(f1, escalated, fast)
    return vals, idx, fb, f1


def cluster_pruned_topk(
    queries: jnp.ndarray,  # (B, d) float (cast to f32 — exact)
    groups: ClusteredGroups,
    k: int,
    metric: str = "l2",
    budget: Optional[int] = None,
    certify: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Provably-exact top-k over the clustered structure (module doc).

    Returns (goodness desc (B, k), ORIGINAL indices (B, k), fell_back
    (bool scalar: tier-2 certificate also failed -> the chunked exact
    scan ran), escalated (bool scalar: tier-1 failed)).  Finalize to
    distances at the API edge (``ops.topk._finalize``).

    ``certify=False`` is the IVF nprobe mode: same selection and exact
    candidate scoring, NO certificates/escalation/fallback — recall is
    the caller's trade (budget == nprobe in group units); the two
    status flags come back False."""
    if budget is None:
        budget = _auto_budget(k, groups.group_rows)
    args = (
        queries,
        groups.corpus_p, groups.sqnorms_p, groups.orig_idx,
        groups.valid_p, groups.centroids, groups.csq, groups.radii,
        groups.maxnorms, groups.norm_gap, groups.group_valid,
    )
    if not certify:
        vals, idx = _cluster_probe_topk_impl(
            *args, k=k, metric=metric, budget=budget,
            group_rows=groups.group_rows,
        )
        return vals, idx, jnp.asarray(False), jnp.asarray(False)
    return _cluster_pruned_topk_impl(
        *args, k=k, metric=metric, budget=budget,
        group_rows=groups.group_rows,
    )


def _auto_budget(k: int, group_rows: int) -> int:
    """Default group budget S: cover the worst case of every top-k row
    landing in a distinct group, with a 2x headroom notch for the
    margin band; floored at 8.  Corpora whose geometry defeats the
    bound (e.g. uniform random on the sphere: radii ~ row norms, so
    nothing prunes) self-correct through escalation -> fallback,
    paying one extra read, never exactness."""
    del group_rows
    return max(8, 2 * k)
