"""Sharded flat index: corpus rows over a device mesh, allgather top-k merge.

The scale-out design of SURVEY.md §2 (TP row) and BASELINE configs[4]:
the (N, d) embedding matrix is sharded by rows across the mesh "model"
axis; each chip scans its shard with the same goodness+top-k kernel as
the single-chip path, then the per-shard (B, k) candidates are
``all_gather``'d over the mesh and merged locally — k·S candidates per
query, one collective, no full-score exchange.  Queries shard across
"data" (DP).  Sharded results match the single-device exact scan
bit-for-bit at equal k (tie order included: the merge keeps shard-major
candidate order, so lower global indices win ties, same as
``lax.top_k``); tested on the 8-device CPU mesh (SURVEY.md §4.3).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from qrag_tpu.ops.bounded_topk import _exact_full_sort
from qrag_tpu.ops.topk import _goodness, goodness_topk
from qrag_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
from qrag_tpu.platform import scan_route


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _merge_candidates(
    acc_v: jnp.ndarray,
    acc_i: jnp.ndarray,
    new_v: jnp.ndarray,
    new_i: jnp.ndarray,
    k: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact (B, k) merge of two candidate sets with lower-global-index
    tie-break (lexsort on (-value, index)) — order-insensitive, so the
    ring merge matches the allgather merge bit-for-bit."""
    comb_v = jnp.concatenate([acc_v, new_v], axis=1)
    comb_i = jnp.concatenate([acc_i, new_i], axis=1)
    order = jnp.lexsort((comb_i, -comb_v), axis=-1)[:, :k]
    return (
        jnp.take_along_axis(comb_v, order, axis=1),
        jnp.take_along_axis(comb_i, order, axis=1),
    )


def _merge_over_model_axis(vals, idx, k: int, s: int, merge: str):
    """Exact global (B, k) merge of per-shard candidates inside a
    shard_map ``local`` body (idx already globalized).  Tie-break:
    candidates are shard-major and within-shard index-ascending among
    equal values, so top_k's positional preference == lower global
    index — lax.top_k-over-the-full-matrix parity."""
    if merge == "ring":
        # memory-bounded ring merge (the retrieval analogue of ring
        # attention — SURVEY.md §2): the ORIGINAL per-shard
        # candidates travel around the ring via ppermute; each shard
        # folds the traveling set into its accumulator.  Peak memory
        # per step is (B, 2k) instead of allgather's (S, B, k).
        perm = [(j, (j + 1) % s) for j in range(s)]
        acc_v, acc_i = vals, idx
        trav_v, trav_i = vals, idx
        for _ in range(s - 1):
            trav_v = jax.lax.ppermute(trav_v, MODEL_AXIS, perm)
            trav_i = jax.lax.ppermute(trav_i, MODEL_AXIS, perm)
            acc_v, acc_i = _merge_candidates(acc_v, acc_i, trav_v, trav_i, k)
        return acc_v, acc_i
    # one collective: k candidates per shard, all-to-all-gather
    all_vals = jax.lax.all_gather(vals, MODEL_AXIS)  # (S, Bl, k)
    all_idx = jax.lax.all_gather(idx, MODEL_AXIS)
    bl = all_vals.shape[1]
    comb_v = jnp.transpose(all_vals, (1, 0, 2)).reshape(bl, s * k)
    comb_i = jnp.transpose(all_idx, (1, 0, 2)).reshape(bl, s * k)
    v, sel = jax.lax.top_k(comb_v, k)  # local k-way merge
    i = jnp.take_along_axis(comb_i, sel, axis=1)
    return v, i


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "budget", "group_rows", "rows_per",
                     "mesh", "merge", "certify"),
)
def _sharded_accel_search(
    queries: jnp.ndarray,  # (B, d) f32, sharded P(data, None)
    corpus_p: jnp.ndarray,  # (S, n_pad, d) sharded P(model, None, None)
    sqnorms_p: jnp.ndarray,  # (S, n_pad) P(model, None)
    orig_idx: jnp.ndarray,  # (S, n_pad) int32 shard-LOCAL device row ids
    valid_p: jnp.ndarray,  # (S, n_pad) bool
    centroids: jnp.ndarray,  # (S, G, d) f32
    csq: jnp.ndarray,  # (S, G)
    radii: jnp.ndarray,  # (S, G)
    maxnorms: jnp.ndarray,  # (S, G)
    norm_gap: jnp.ndarray,  # (S, G)
    group_valid: jnp.ndarray,  # (S, G) bool
    k: int,
    metric: str,
    budget: int,
    group_rows: int,
    rows_per: int,  # device capacity rows per shard (globalization)
    mesh: Mesh,
    merge: str = "allgather",
    certify: bool = True,
):
    """Sharded small-batch clustered accelerator: each shard runs the
    cluster-pruned PROVABLY-EXACT search over its own structure
    (ops/cluster_topk.py), then the per-shard exact candidates merge
    with the standard exact tie-break — exact GLOBAL top-k, reading
    only each shard's certified groups."""
    from qrag_tpu.ops.cluster_topk import (
        _cluster_probe_topk_impl,
        _cluster_pruned_topk_impl,
    )

    def local(q, cp, sp, oi, vp, ce, cs, ra, mx, ng, gv):
        if certify:
            vals, idx, fb, esc = _cluster_pruned_topk_impl(
                q, cp[0], sp[0], oi[0], vp[0], ce[0], cs[0], ra[0],
                mx[0], ng[0], gv[0], k, metric, budget, group_rows,
            )
        else:
            # IVF nprobe mode per shard: exact per-group scoring, no
            # certificates; the merge is still exact over whatever
            # candidates the shards surfaced
            vals, idx = _cluster_probe_topk_impl(
                q, cp[0], sp[0], oi[0], vp[0], ce[0], cs[0], ra[0],
                mx[0], ng[0], gv[0], k, metric, budget, group_rows,
            )
            fb = esc = jnp.asarray(False)
        shard = jax.lax.axis_index(MODEL_AXIS)
        # globalize into device-capacity row space (pad sentinels stay
        # >= 2^30 -> invalid at the host edge)
        idx = idx + shard * rows_per
        s = jax.lax.axis_size(MODEL_AXIS)
        stats = jax.lax.psum(
            jax.lax.psum(
                jnp.stack([fb.astype(jnp.int32), esc.astype(jnp.int32)]),
                MODEL_AXIS,
            ),
            DATA_AXIS,
        )
        return _merge_over_model_axis(vals, idx, k, s, merge) + (stats,)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS, None),
            P(MODEL_AXIS, None, None),
            P(MODEL_AXIS, None),
            P(MODEL_AXIS, None),
            P(MODEL_AXIS, None),
            P(MODEL_AXIS, None, None),
            P(MODEL_AXIS, None),
            P(MODEL_AXIS, None),
            P(MODEL_AXIS, None),
            P(MODEL_AXIS, None),
            P(MODEL_AXIS, None),
        ),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None), P(None)),
        check_vma=False,
    )(
        queries, corpus_p, sqnorms_p, orig_idx, valid_p,
        centroids, csq, radii, maxnorms, norm_gap, group_valid,
    )


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "mode", "mesh", "merge")
)
def _sharded_search(
    queries: jnp.ndarray,  # (B, d) sharded P(data, None)
    corpus: jnp.ndarray,  # (Np, d) sharded P(model, None)
    sqnorms: jnp.ndarray,  # (Np,) sharded P(model)
    valid: jnp.ndarray,  # (Np,) sharded P(model)
    k: int,
    metric: str,
    mode: str,
    mesh: Mesh,
    merge: str = "allgather",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    def local(q, x, sq, vl):
        stats = jnp.zeros((2,), jnp.int32)  # (fell_back, escalated)
        if mode == "bounded":
            # provably-exact sharded retrieval: per-shard bounded-exact
            # top-k (ops/bounded_topk.py) + the exact tie-break merge
            # below = exact GLOBAL top-k.  Queries stay f32 (the
            # DeviceFlatIndex semantics: exact w.r.t. the f32 query
            # against the stored rows — the margin regime widens with
            # the store's dtype gap, ``bounded_topk._auto_budgets``).
            # Shards too small for the windowed machinery use the
            # exact sort (cheap there) — either way every shard's
            # candidates are exact, so the merged result is.  With
            # store_dtype="float32" the bf16 scan copy is cast per
            # call — prefer "bfloat16" storage for production
            # bounded+sharded serving.
            from qrag_tpu.ops.bounded_topk import (
                WINDOW,
                bounded_exact_topk,
                window_maxnorms_device,
            )

            nl = x.shape[0]
            if (
                nl >= 4096
                and nl % WINDOW == 0
                and nl // WINDOW >= max(k, 16)
            ):
                scan = x if x.dtype == jnp.bfloat16 else x.astype(jnp.bfloat16)
                mx = window_maxnorms_device(sq)
                # built in-trace, not as a NumPy constant: a large
                # captured constant becomes a hidden executable argument,
                # and two merges' executables then mix up their argument
                # counts on a repeated call
                lr = (WINDOW - 1) - jax.lax.broadcasted_iota(
                    jnp.int32, (1, nl), 1
                ) % WINDOW
                vals, idx, fb, _, esc = bounded_exact_topk(
                    q, scan, x, sq, mx, lr, k,
                    metric=metric, valid_rows=vl,
                    backend=scan_route(*scan.shape, scan.dtype),
                )
                stats = jnp.stack(
                    [fb.astype(jnp.int32), esc.astype(jnp.int32)]
                )
            else:
                vals, idx = _exact_full_sort(q, x, sq, k, metric, vl)
        elif mode == "exact":
            # row slices with a running merge: a product over the whole
            # shard would need a (B, N/S) score matrix, and autotuning
            # it a second shard-sized operand buffer
            vals, idx = _exact_full_sort(q, x, sq, k, metric, vl)
        elif mode == "verified":
            # verified-exact sharded retrieval (VERDICT r3 weak #5: no
            # more silent approx downgrade): per-shard deep-oversample
            # approx + the exactness certificate + a cond'd exact sort
            # fallback — every shard's k candidates carry exact VALUES,
            # so the exact tie-break merge below yields a verified-
            # exact GLOBAL top-k.  Collective-free per shard (the cert
            # compares against the shard's own goodness evaluation).
            g = _goodness(q, x, metric, sq, vl)
            kk = min(max(16 * k, k), g.shape[-1])
            if kk * 8 >= g.shape[-1]:
                vals, idx = jax.lax.top_k(g, k)  # small shard: sort
            else:
                sv, si = jax.lax.approx_max_k(g, kk, recall_target=0.99)
                vals, ri = jax.lax.top_k(sv, k)
                idx = jnp.take_along_axis(si, ri, axis=1)
                thr = vals[:, -1:]
                bad = jnp.sum(g > thr, axis=1) > k - 1
                # tie certificate (ADVICE r4): values being exact is
                # not enough — a bitwise-duplicate row with a LOWER
                # index that approx_max_k missed would silently break
                # the repo-wide "lower index wins" tie contract.  The
                # in-set rows AT the threshold value must be exactly
                # the smallest-index equal-value rows overall.
                col = jax.lax.broadcasted_iota(jnp.int32, g.shape, 1)
                eq_small = -jax.lax.top_k(
                    jnp.where(g == thr, -col, -jnp.int32(2 ** 31 - 1)),
                    k,
                )[0]  # (B, k) ascending indices of equal-value rows
                m = jnp.sum(vals == thr, axis=1)  # in-set equals >= 1
                mth = jnp.take_along_axis(
                    eq_small, (m - 1)[:, None], axis=1
                )[:, 0]
                max_in = jnp.max(
                    jnp.where(vals == thr, idx, -1), axis=1
                )
                bad = bad | (
                    jnp.isfinite(thr[:, 0]) & (max_in > mth)
                )
                vals, idx = jax.lax.cond(
                    jnp.any(bad),
                    lambda: tuple(jax.lax.top_k(g, k)),
                    lambda: (vals, idx),
                )
        else:
            # per-shard scan: identical kernel to the single-chip path
            g = _goodness(q, x, metric, sq, vl)
            vals, idx = goodness_topk(g, k, mode=mode)
        shard = jax.lax.axis_index(MODEL_AXIS)
        idx = idx + shard * x.shape[0]  # globalize row ids
        s = jax.lax.axis_size(MODEL_AXIS)
        # shard-count of bounded cert events this call (fell_back,
        # escalated), summed over BOTH mesh axes -> replicated scalar
        # pair the host-level search() can surface in /stats
        stats = jax.lax.psum(
            jax.lax.psum(stats, MODEL_AXIS), DATA_AXIS
        )
        return _merge_over_model_axis(vals, idx, k, s, merge) + (stats,)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS, None),
            P(MODEL_AXIS, None),
            P(MODEL_AXIS),
            P(MODEL_AXIS),
        ),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None), P(None)),
        # after the all_gather+merge the outputs ARE replicated over
        # "model"; the varying-axes checker can't infer that
        check_vma=False,
    )(queries, corpus, sqnorms, valid)


@functools.partial(jax.jit, static_argnames=("mesh",))
def _sharded_gather_rows(
    idx: jnp.ndarray,  # (B, k) int32 global row ids (replicated)
    corpus: jnp.ndarray,  # (Np, d) sharded P(model, None)
    mesh: Mesh,
) -> jnp.ndarray:
    def local(idx_l, x):
        rows_per = x.shape[0]
        shard = jax.lax.axis_index(MODEL_AXIS)
        local_idx = idx_l - shard * rows_per
        owned = (local_idx >= 0) & (local_idx < rows_per)
        safe = jnp.clip(local_idx, 0, rows_per - 1)
        take = jnp.take(x, safe.reshape(-1), axis=0).reshape(
            idx_l.shape + (x.shape[1],)
        )
        contrib = jnp.where(owned[..., None], take.astype(jnp.float32), 0.0)
        return jax.lax.psum(contrib, MODEL_AXIS)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(MODEL_AXIS, None)),
        out_specs=P(DATA_AXIS, None, None),
        check_vma=False,
    )(idx, corpus)


class ShardedFlatIndex:
    """Row-sharded HBM-resident exact flat index over a device mesh.

    Engine-compatible: exposes the same ``add`` / ``search`` /
    ``sample_rows`` / persistence surface as ``DeviceFlatIndex`` so
    `QragEngine` (and the serve CLI's ``--sharded`` flag) can put a
    sharded corpus behind the exact same HTTP API.  Appends keep a
    host master copy and re-shard lazily on the next query (the
    single-writer contract of the unsharded index applies).

    Score contract: ``search_device`` returns FINALIZED scores exactly
    like ``DeviceFlatIndex.search_device`` (l2: distances ascending;
    ip: dots descending — the CLAUDE.md API-edge invariant).  The raw
    descending-goodness form used by fused rerank internals is
    ``search_device_raw``."""

    # No single-device buffer snapshot exists for a sharded corpus; the
    # engine dispatches on this flag (not duck-typing) to pick the
    # sharded query arm.
    has_device_snapshot = False

    def __init__(
        self,
        vectors: Optional[np.ndarray] = None,
        mesh: Optional[Mesh] = None,
        metric: str = "l2",
        metadata: Optional[Sequence[str]] = None,
        topk_mode: str = "approx",
        store_dtype: str = "float32",
        merge: str = "allgather",
        d: Optional[int] = None,
        normalize: bool = False,
        keep_host_master: bool = True,
        bounded_query_dtype: str = "float32",
        small_batch_accel: str = "none",
        accel_max_batch: int = 16,
        cluster_group_rows: int = 512,
        cluster_budget: Optional[int] = None,
        accel_read_cap: float = 0.5,
    ):
        if metric not in ("l2", "ip"):
            raise ValueError(f"unknown metric {metric!r}")
        if merge not in ("allgather", "ring"):
            raise ValueError(f"unknown merge strategy {merge!r}")
        if small_batch_accel not in ("none", "clustered", "clustered_probe"):
            raise ValueError(
                f"unknown small_batch_accel {small_batch_accel!r}"
            )
        # Small-batch latency accelerator, sharded: each shard builds
        # its own cluster-pruned structure (ops/cluster_topk.py) and
        # small batches read only certified groups per shard, merged
        # exactly — the per-chip read pruning is what makes single-
        # query serving viable at pod scale.  Exact for every
        # topk_mode; rebuilt lazily per device generation.
        self.small_batch_accel = small_batch_accel
        self.accel_max_batch = int(accel_max_batch)
        self.cluster_group_rows = int(cluster_group_rows)
        self.cluster_budget = cluster_budget
        self.accel_read_cap = float(accel_read_cap)
        self._accel_struct = None  # (arrays tuple, rows_per, ntotal)
        self.cluster_fallbacks = 0
        self.cluster_escalations = 0
        self._pending_cluster_stats = None
        if bounded_query_dtype not in ("float32", "store"):
            raise ValueError(
                f"unknown bounded_query_dtype {bounded_query_dtype!r}"
            )
        # same opt-in contract as DeviceFlatIndex: "store" rounds
        # queries to the store dtype before the bounded scan (exact
        # w.r.t. the rounded query, narrow margins on a bf16 store)
        self.bounded_query_dtype = bounded_query_dtype
        if mesh is None:
            from qrag_tpu.parallel.mesh import make_mesh

            mesh = make_mesh()
        if vectors is None:
            if d is None:
                raise ValueError("need vectors or d")
            vectors = np.zeros((0, d), np.float32)
        self.merge = merge
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        self.mesh = mesh
        self.metric = metric
        self.topk_mode = topk_mode
        self.normalize = normalize
        self.use_pallas = False
        self.fallback_rows = 0  # stats-surface parity with DeviceFlatIndex
        self.bounded_escalations = 0  # bounded-mode 4x-budget re-certs
        self._pending_bounded_stats = None  # lazy (fell_back, escalated)
        self.d = int(d if d is not None else vectors.shape[1])
        self.store_dtype = (
            jnp.bfloat16 if store_dtype == "bfloat16" else jnp.float32
        )
        self._store_dtype_name = store_dtype
        self._dp = mesh.shape[DATA_AXIS]
        self.keep_host_master = keep_host_master
        self._host_vectors = np.zeros((0, self.d), np.float32)
        self._ntotal = 0
        self.metadata: List[str] = []
        self._dirty = True
        self._dev_matrix = None
        self._dev_sqnorms = None
        self._dev_valid = None
        self._dev_ntotal = 0
        self._capacity = 0
        # rows added since the last device build: within capacity the
        # next _ensure_device transfers ONLY these (VERDICT r4 item 4)
        self._pending: List[np.ndarray] = []
        self._needs_full = True
        import threading

        self._write_lock = threading.Lock()
        if vectors.shape[0]:
            self.add(vectors, metadata)

    @property
    def ntotal(self) -> int:
        return self._ntotal

    def add(
        self, vectors: np.ndarray, metadata: Optional[Sequence[str]] = None
    ) -> int:
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.d:
            raise ValueError(
                f"expected (*, {self.d}) vectors, got {vectors.shape}"
            )
        if self.normalize:
            norms = np.linalg.norm(vectors, axis=1, keepdims=True)
            vectors = np.where(norms > 0, vectors / np.where(norms > 0, norms, 1), vectors)
        if metadata is not None and len(metadata) != vectors.shape[0]:
            raise ValueError(
                f"metadata length {len(metadata)} != vectors {vectors.shape[0]}"
            )
        with self._write_lock:
            if self.keep_host_master:
                self._host_vectors = np.concatenate(
                    [self._host_vectors, vectors], axis=0
                )
            self._pending.append(vectors)
            self._ntotal += vectors.shape[0]
            if metadata is not None:
                self.metadata.extend(str(m) for m in metadata)
            else:
                self.metadata.extend([""] * vectors.shape[0])
            self._dirty = True
        return self.ntotal

    def sample_rows(self, rows: Sequence[int]) -> np.ndarray:
        if self.keep_host_master:
            return np.asarray(
                self._host_vectors[np.asarray(rows, dtype=np.int64)]
            )
        # streaming mode: the corpus lives only on the mesh — gather
        # the requested rows across shards (store-dtype precision).
        # The distributed gather shards its batch axis over "data":
        # replicate the single request row to fill the axis.
        idx = np.tile(
            np.asarray(rows, dtype=np.int32)[None, :], (self._dp, 1)
        )
        out = self.gather_rows_device(jnp.asarray(idx))
        return np.asarray(out)[0]

    def layout(self) -> dict:
        """Shard layout for observability (/stats) — computed from the
        padding formula / build state, NOT by touching device buffers
        (an observability call must never trigger a corpus upload)."""
        mp = self.mesh.shape[MODEL_AXIS]
        npad = self._capacity or (
            _round_up(max(self.ntotal, mp), mp * 128) if self.ntotal else 0
        )
        return {
            "sharded": True,
            "mesh": {DATA_AXIS: self._dp, MODEL_AXIS: mp},
            "merge": self.merge,
            "rows_per_shard": npad // mp if mp else 0,
            "devices": self.mesh.devices.size,
            "host_master": self.keep_host_master,
        }

    def _row_sharding(self):
        return NamedSharding(self.mesh, P(MODEL_AXIS, None))

    def _vec_sharding(self):
        return NamedSharding(self.mesh, P(MODEL_AXIS))

    def _ensure_device(self) -> None:
        if not self._dirty and self._dev_matrix is not None:
            return
        with self._write_lock:
            if not self._dirty and self._dev_matrix is not None:
                return
            mp = self.mesh.shape[MODEL_AXIS]
            n = self.ntotal
            needed = _round_up(max(n, mp), mp * 128)
            if (
                self._dev_matrix is not None
                and not self._needs_full
                and self._pending
            ):
                new_rows = np.concatenate(self._pending, axis=0)
                if needed > self._capacity:
                    if not self.keep_host_master:
                        # streaming mode: grow capacity DEVICE-SIDE
                        # (copy into a bigger sharded buffer — no host
                        # materialization of the corpus, ever)
                        self._grow_device_locked(needed, mp)
                    else:
                        self._full_upload_locked(n, needed, mp)
                        return
                self._append_pending_locked(new_rows)
                return
            if not self.keep_host_master and self._dev_matrix is None:
                # streaming first build: allocate empty capacity then
                # append the pending chunks — the host never holds
                # more than one chunk
                if needed > self._capacity:
                    self._capacity = _round_up(
                        max(needed, 2 * self._capacity), mp * 128
                    )
                self._alloc_device_locked(mp)
                if self._pending:
                    self._append_pending_locked(
                        np.concatenate(self._pending, axis=0)
                    )
                else:
                    self._dirty = False
                self._needs_full = False
                return
            self._full_upload_locked(n, needed, mp)

    def _full_upload_locked(self, n: int, needed: int, mp: int) -> None:
        if not self.keep_host_master:
            raise RuntimeError(
                "full re-shard requires the host master copy "
                "(keep_host_master=False streaming index cannot rebuild)"
            )
        if needed > self._capacity:
            if self._capacity:
                cap = max(needed, self._capacity * 2)
            else:
                # first build: headroom so early appends stay
                # incremental (mirrors DeviceFlatIndex)
                cap = needed + max(needed // 4, mp * 128)
            self._capacity = _round_up(cap, mp * 128)
        npad = self._capacity
        padded = np.zeros((npad, self.d), np.float32)
        padded[:n] = self._host_vectors
        valid = np.zeros((npad,), bool)
        valid[:n] = True
        self._dev_matrix = jax.device_put(
            padded.astype(self.store_dtype), self._row_sharding()
        )
        self._dev_sqnorms = jax.device_put(
            np.sum(padded * padded, axis=1, dtype=np.float32),
            self._vec_sharding(),
        )
        self._dev_valid = jax.device_put(valid, self._vec_sharding())
        self._dev_ntotal = n
        self._dirty = False
        self._pending = []
        self._needs_full = False

    def _alloc_device_locked(self, mp: int) -> None:
        """Zero-filled sharded capacity buffers (streaming build)."""
        cap = self._capacity
        row, vec = self._row_sharding(), self._vec_sharding()
        self._dev_matrix = jax.jit(
            lambda: jnp.zeros((cap, self.d), self.store_dtype),
            out_shardings=row,
        )()
        self._dev_sqnorms = jax.jit(
            lambda: jnp.zeros((cap,), jnp.float32), out_shardings=vec
        )()
        self._dev_valid = jax.jit(
            lambda: jnp.zeros((cap,), bool), out_shardings=vec
        )()
        self._dev_ntotal = 0

    def _grow_device_locked(self, needed: int, mp: int) -> None:
        """Device-side capacity growth for the streaming (no-host-
        master) mode: copy the old sharded buffers into bigger ones —
        all on the mesh, nothing re-crosses the host boundary."""
        new_cap = _round_up(
            max(needed, self._capacity * 2 if self._capacity else needed),
            mp * 128,
        )
        row, vec = self._row_sharding(), self._vec_sharding()
        old_m, old_s, old_v = (
            self._dev_matrix, self._dev_sqnorms, self._dev_valid
        )

        def grow(m, s, v):
            gm = jnp.zeros((new_cap, self.d), m.dtype)
            gs = jnp.zeros((new_cap,), jnp.float32)
            gv = jnp.zeros((new_cap,), bool)
            return (
                jax.lax.dynamic_update_slice(gm, m, (0, 0)),
                jax.lax.dynamic_update_slice(gs, s, (0,)),
                jax.lax.dynamic_update_slice(gv, v, (0,)),
            )

        self._dev_matrix, self._dev_sqnorms, self._dev_valid = jax.jit(
            grow, out_shardings=(row, vec, vec)
        )(old_m, old_s, old_v)
        self._capacity = new_cap

    def _append_pending_locked(self, new_rows: np.ndarray) -> None:
        """Incremental sharded append: transfer only the new rows and
        dynamic_update_slice them into the sharded capacity buffers
        (GSPMD places the update on the owning shard(s))."""
        from qrag_tpu.index.flat_index import (
            _append_into_capacity,
            _pow2_bucket,
        )

        start = self._dev_ntotal
        n_new = new_rows.shape[0]
        bucket = _pow2_bucket(n_new)
        if start + bucket > self._capacity >= start + n_new:
            bucket = self._capacity - start  # boundary clamp
        if start + bucket > self._capacity:
            mp = self.mesh.shape[MODEL_AXIS]
            if self.keep_host_master:
                self._full_upload_locked(
                    self.ntotal,
                    _round_up(max(self.ntotal, mp), mp * 128),
                    mp,
                )
                return
            self._grow_device_locked(start + bucket, mp)
        padded = np.zeros((bucket, self.d), np.float32)
        padded[:n_new] = new_rows
        rep = NamedSharding(self.mesh, P())
        self._dev_matrix, self._dev_sqnorms, self._dev_valid = (
            _append_into_capacity(
                self._dev_matrix,
                self._dev_sqnorms,
                self._dev_valid,
                jax.device_put(padded, rep),
                jnp.int32(n_new),
                jnp.int32(start),
            )
        )
        self._dev_ntotal = self.ntotal
        self._dirty = False
        self._pending = []
        self._needs_full = False

    def _accel_eligible(self, batch: int, k: int) -> bool:
        """Route this batch through the sharded clustered accelerator?
        Every shard needs enough VALID rows for a useful structure
        (the last shard holds the capacity padding)."""
        if (
            self.small_batch_accel not in ("clustered", "clustered_probe")
            or batch > self.accel_max_batch
            or self.ntotal == 0
        ):
            return False
        # AGGREGATE thresholds (mirrors DeviceFlatIndex._accel_eligible
        # scaled to the whole corpus): capacity headroom concentrates
        # padding on the last shards, so per-shard minimums would
        # disqualify real corpora — tiny/empty shards get degenerate
        # structures instead (unpruned but exact)
        L = self.cluster_group_rows
        if not (
            self.ntotal >= max(4096, 4 * L)
            and self.ntotal // L >= max(2 * k, 8)
        ):
            return False
        # read-volume cap (per shard): ~batch*S*L rows per shard vs
        # the shard's share of the corpus — past accel_read_cap of it
        # the scan wins.  0 disables (correctness tests).
        if not self.accel_read_cap:
            return True
        from qrag_tpu.ops.cluster_topk import _auto_budget

        s = self.mesh.shape[MODEL_AXIS]
        s_budget = self.cluster_budget or _auto_budget(k, L)
        # queries shard over the data axis: each device sees
        # batch/dp queries, and each reads S groups per query from
        # its OWN shard
        eff_batch = -(-batch // max(self._dp, 1))
        return eff_batch * s_budget * L <= max(self.ntotal // s, 1) * (
            self.accel_read_cap
        )

    def build_clustered(self):
        """Build (or fetch the cached) per-shard clustered structures,
        stacked and device_put sharded over the model axis.  Lazily
        invoked by search routing; call eagerly at serve startup
        (engine.warmup).  Uses ``sample_rows`` for shard rows, so it
        works in keep_host_master=False mode too (one shard-size host
        array at a time)."""
        from qrag_tpu.ops.cluster_topk import (
            _PAD_IDX,
            build_clustered_groups,
        )

        self._ensure_device()
        s = self.mesh.shape[MODEL_AXIS]
        rows_per = self._dev_matrix.shape[0] // s
        if (
            self._accel_struct is not None
            and self._accel_struct[2] == self.ntotal
        ):
            return self._accel_struct
        from qrag_tpu.ops.cluster_topk import empty_groups

        per = []
        for sh in range(s):
            lo = sh * rows_per
            hi = min(self.ntotal, lo + rows_per)
            if hi <= lo:
                # capacity padding left this shard rowless: a
                # well-shaped all-invalid placeholder (exact no-op)
                per.append(
                    empty_groups(
                        self.d, self.cluster_group_rows, self.store_dtype
                    )
                )
                continue
            rows = self.sample_rows(range(lo, hi))
            # scoring norms: the same master-f32 sqnorms the plain
            # sharded scan uses (this shard's slice of _dev_sqnorms) —
            # keeps the accel's refine function identical to the other
            # l2 paths on a bf16 store (ADVICE r4)
            shard_sq = np.asarray(self._dev_sqnorms[lo:hi])
            g = build_clustered_groups(
                jnp.asarray(rows).astype(self.store_dtype),
                group_rows=self.cluster_group_rows,
                sqnorms=jnp.asarray(shard_sq, jnp.float32),
            )
            per.append(g)
        L = self.cluster_group_rows
        n_pad = max(g.corpus_p.shape[0] for g in per)
        g_max = n_pad // L

        def pad_shard(g):
            pn = n_pad - g.corpus_p.shape[0]
            pg = g_max - g.centroids.shape[0]
            return (
                jnp.pad(g.corpus_p, ((0, pn), (0, 0))),
                jnp.pad(g.sqnorms_p, (0, pn)),
                jnp.pad(g.orig_idx, (0, pn), constant_values=int(_PAD_IDX)),
                jnp.pad(g.valid_p, (0, pn)),
                jnp.pad(g.centroids, ((0, pg), (0, 0))),
                jnp.pad(g.csq, (0, pg)),
                jnp.pad(g.radii, (0, pg)),
                jnp.pad(g.maxnorms, (0, pg)),
                jnp.pad(g.norm_gap, (0, pg)),
                jnp.pad(g.group_valid, (0, pg)),
            )

        stacked_host = [
            np.stack([np.asarray(t) for t in parts])
            for parts in zip(*(pad_shard(g) for g in per))
        ]
        specs = [
            P(MODEL_AXIS, None, None),  # corpus_p
            P(MODEL_AXIS, None),  # sqnorms_p
            P(MODEL_AXIS, None),  # orig_idx
            P(MODEL_AXIS, None),  # valid_p
            P(MODEL_AXIS, None, None),  # centroids
            P(MODEL_AXIS, None),  # csq
            P(MODEL_AXIS, None),  # radii
            P(MODEL_AXIS, None),  # maxnorms
            P(MODEL_AXIS, None),  # norm_gap
            P(MODEL_AXIS, None),  # group_valid
        ]
        arrays = tuple(
            jax.device_put(a, NamedSharding(self.mesh, sp))
            for a, sp in zip(stacked_host, specs)
        )
        self._accel_struct = (arrays, rows_per, self.ntotal)
        return self._accel_struct

    def _accel_search_device(self, queries: jnp.ndarray, k: int):
        """Raw sharded accel search (goodness, global idx) + pending
        stats; callers finalize."""
        from qrag_tpu.ops.cluster_topk import _auto_budget

        arrays, rows_per, _ = self.build_clustered()
        budget = self.cluster_budget or _auto_budget(
            k, self.cluster_group_rows
        )
        vals, idx, stats = _sharded_accel_search(
            queries.astype(jnp.float32),
            *arrays,
            k=k,
            metric=self.metric,
            budget=budget,
            group_rows=self.cluster_group_rows,
            rows_per=rows_per,
            mesh=self.mesh,
            merge=self.merge,
            certify=self.small_batch_accel != "clustered_probe",
        )
        self._pending_cluster_stats = stats
        return vals, idx

    def search_device_raw(
        self, queries: jnp.ndarray, k: int
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Raw per-query goodness (descending; l2 goodness = -d^2),
        pre-_finalize — the internal form the fused rerank stages
        consume.  API-edge callers want ``search_device``.

        Bounded mode keeps queries f32 (same exactness semantics as
        ``DeviceFlatIndex``: exact w.r.t. the f32 query against the
        stored rows) unless ``bounded_query_dtype="store"`` opts into
        rounded-query exactness; scan modes cast to the store dtype so
        the scan matmul runs at the bf16 rate."""
        self._ensure_device()
        if self._accel_eligible(queries.shape[0], k):
            return self._accel_search_device(queries, k)
        keep_f32 = (
            self.topk_mode == "bounded"
            and self.bounded_query_dtype == "float32"
        )
        q = queries.astype(
            jnp.float32 if keep_f32 else self.store_dtype
        )
        vals, idx, stats = _sharded_search(
            q,
            self._dev_matrix,
            self._dev_sqnorms,
            self._dev_valid,
            k,
            self.metric,
            self.topk_mode,
            self.mesh,
            self.merge,
        )
        # lazy DeviceArray — host-level search() consumes it AFTER the
        # result sync so the device pipeline never blocks on stats
        self._pending_bounded_stats = stats
        return vals, idx

    def search_device(
        self, queries: jnp.ndarray, k: int
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Device-level search with the SAME score semantics as
        ``DeviceFlatIndex.search_device`` (contract-tested in
        tests/test_index_contract.py): l2 distances ascending, ip dots
        descending."""
        from qrag_tpu.ops.topk import _finalize

        vals, idx = self.search_device_raw(queries, k)
        return _finalize(vals, idx, self.metric)

    @classmethod
    def load_faiss(cls, path: str, mesh: Mesh, **kwargs) -> "ShardedFlatIndex":
        """Load a FAISS flat artifact directly into a sharded index."""
        from qrag_tpu.index import faiss_io

        data, meta = faiss_io.read_flat_with_metadata(path)
        return cls(
            data.vectors, mesh, metric=data.metric, metadata=meta, **kwargs
        )

    def gather_rows_device(self, idx: jnp.ndarray) -> jnp.ndarray:
        """Gather corpus rows by global index across shards: each shard
        contributes the rows it owns (masked local take), one psum over
        the model axis combines them.  (B, k) int32 → (B, k, d) f32."""
        self._ensure_device()
        return _sharded_gather_rows(idx, self._dev_matrix, self.mesh)

    def search_rerank_device(
        self, queries: jnp.ndarray, k: int, candidates: int, n_qubits: int
    ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """Sharded retrieval → quantum fidelity rerank: per-shard scan +
        allgather/ring merge, distributed candidate-row gather, batched
        fidelity, final top-k (BASELINE configs[4] query path).

        Returned retrieval scores are FINALIZED (API-edge semantics),
        matching ``engine.fused_search_rerank``'s third output."""
        from qrag_tpu.ops.topk import _finalize

        retr, idx = self.search_device_raw(queries, candidates)
        cand = self.gather_rows_device(idx)  # (B, C, d)
        from qrag_tpu.ops.statevector import fidelity_analytic

        q32 = queries.astype(jnp.float32)
        fid = jax.vmap(lambda q, c: fidelity_analytic(q, c, n_qubits))(
            q32, cand
        )
        # retr is raw goodness here (pre-_finalize): invalid slots -inf
        invalid = jnp.isneginf(retr)
        fid = jnp.where(invalid, -jnp.inf, fid)
        top, sel = jax.lax.top_k(fid, k)
        sel_retr = jnp.take_along_axis(retr, sel, axis=1)
        sel_idx = jnp.take_along_axis(idx, sel, axis=1)
        return (top, sel_idx, _finalize(sel_retr, sel_idx, self.metric)[0])

    def search_rerank_routed_device(
        self,
        queries: jnp.ndarray,
        route_quantum: jnp.ndarray,  # (B,) bool
        k: int,
        candidates: int,
        n_qubits: int,
    ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """Sharded retrieval → per-query expert-routed rerank: the
        sharded counterpart of ``engine.fused_search_rerank_routed``
        (quantum fidelity vs classical cosine, branchless select).
        Retrieval scores are finalized like ``search_rerank_device``."""
        from qrag_tpu.ops.topk import _finalize

        retr, idx = self.search_device_raw(queries, candidates)
        cand = self.gather_rows_device(idx)  # (B, C, d) f32 replicated
        from qrag_tpu.ops.statevector import fidelity_analytic

        q32 = queries.astype(jnp.float32)
        fid = jax.vmap(lambda q, c: fidelity_analytic(q, c, n_qubits))(
            q32, cand
        )
        qn = q32 / jnp.clip(jnp.linalg.norm(q32, axis=-1, keepdims=True), 1e-12)
        cn = cand / jnp.clip(
            jnp.linalg.norm(cand, axis=-1, keepdims=True), 1e-12
        )
        cos = jnp.einsum("bd,bcd->bc", qn, cn)
        scores = jnp.where(route_quantum[:, None], fid, cos)
        scores = jnp.where(jnp.isneginf(retr), -jnp.inf, scores)
        top, sel = jax.lax.top_k(scores, k)
        sel_retr = jnp.take_along_axis(retr, sel, axis=1)
        sel_idx = jnp.take_along_axis(idx, sel, axis=1)
        return (top, sel_idx, _finalize(sel_retr, sel_idx, self.metric)[0])

    # ------------------------------------------------------- persistence

    def _download_vectors_memmap(self, path: str) -> np.ndarray:
        """Stream the device corpus to a disk-backed array in chunks —
        the streaming (no-host-master) index can checkpoint without
        ever materializing the full corpus in host RAM.  Values carry
        store-dtype precision (bf16 storage saves bf16-rounded f32)."""
        self._ensure_device()
        out = np.lib.format.open_memmap(
            path, mode="w+", dtype=np.float32, shape=(self.ntotal, self.d)
        )
        step = 65536
        for i0 in range(0, self.ntotal, step):
            i1 = min(self.ntotal, i0 + step)
            out[i0:i1] = np.asarray(
                self._dev_matrix[i0:i1].astype(jnp.float32)
            )
        out.flush()
        return out

    def save_native(self, directory: str) -> None:
        """Same manifest format as DeviceFlatIndex (shard layout is a
        runtime property, not part of the checkpoint — a bundle saved
        sharded restores on any mesh, or unsharded)."""
        from qrag_tpu.index import flat_index as fi

        if self.keep_host_master:
            fi.DeviceFlatIndex.save_native(self, directory)  # type: ignore[arg-type]
            return
        import json
        import os

        os.makedirs(directory, exist_ok=True)
        self._download_vectors_memmap(
            os.path.join(directory, fi.VECTORS_NAME)
        )
        with open(os.path.join(directory, fi.METADATA_NAME), "w") as f:
            json.dump(self.metadata, f)
        manifest = {
            "format": "qrag_tpu.flat_index",
            "version": 1,
            "d": self.d,
            "ntotal": self.ntotal,
            "metric": self.metric,
            "dtype": "float32",
            "normalized": self.normalize,
            "row_pad_multiple": self.row_pad_multiple,
        }
        with open(os.path.join(directory, fi.MANIFEST_NAME), "w") as f:
            json.dump(manifest, f, indent=2)

    row_pad_multiple = 128  # manifest field parity

    @classmethod
    def load_native(
        cls, directory: str, mesh: Optional[Mesh] = None, **kwargs
    ) -> "ShardedFlatIndex":
        from qrag_tpu.index.flat_index import DeviceFlatIndex

        host = DeviceFlatIndex.load_native(directory)
        kwargs.pop("row_pad_multiple", None)
        idx = cls(
            host._host_vectors,
            mesh,
            metric=host.metric,
            metadata=host.metadata,
            normalize=host.normalize,
            **kwargs,
        )
        return idx

    def save_faiss(self, path: str) -> None:
        from qrag_tpu.index.flat_index import DeviceFlatIndex

        if self.keep_host_master:
            DeviceFlatIndex.save_faiss(self, path)  # type: ignore[arg-type]
            return
        import os
        import pickle

        from qrag_tpu.index import faiss_io

        tmp = path + ".vectors.tmp.npy"
        try:
            vecs = self._download_vectors_memmap(tmp)
            faiss_io.write_flat_index(path, vecs, metric=self.metric)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        meta_path = faiss_io.metadata_path_for(path)
        with open(meta_path + ".tmp", "wb") as f:
            pickle.dump(list(self.metadata), f)
        os.replace(meta_path + ".tmp", meta_path)

    def search(self, queries: np.ndarray, k: int = 10):
        """Host-level sharded search (pads the batch to the data axis)."""
        from qrag_tpu.index.flat_index import SearchResult

        queries = np.ascontiguousarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if queries.shape[1] != self.d:
            raise ValueError(
                f"expected (*, {self.d}) queries, got {queries.shape}"
            )
        b = queries.shape[0]
        bp = _round_up(b, self._dp)
        if bp != b:
            # edge-repeat (see serving/batcher.py): zero padding rows
            # are certificate-hostile for the clustered accelerator
            queries = np.pad(queries, ((0, bp - b), (0, 0)), mode="edge")
        k_eff = min(k, max(self.ntotal, 1))
        batch_sh = NamedSharding(self.mesh, P(DATA_AXIS, None))
        qdev = jax.device_put(queries, batch_sh)
        vals, idx = self.search_device(qdev, k_eff)  # finalized
        scores = np.asarray(vals)[:b]
        indices = np.asarray(idx, dtype=np.int32)[:b]
        if self._pending_bounded_stats is not None:
            # result sync above already ran the computation: reading
            # the replicated stats pair here is free
            st = np.asarray(self._pending_bounded_stats)
            self._pending_bounded_stats = None
            self.fallback_rows += int(st[0])
            self.bounded_escalations += int(st[1])
        if self._pending_cluster_stats is not None:
            st = np.asarray(self._pending_cluster_stats)
            self._pending_cluster_stats = None
            self.cluster_fallbacks += int(st[0])
            self.cluster_escalations += int(st[1])
        invalid = (indices < 0) | (indices >= self.ntotal)
        indices = np.where(invalid, -1, indices)
        meta = [
            [None if i < 0 else (self.metadata[i] or None) for i in row]
            for row in indices
        ]
        return SearchResult(scores=scores, indices=indices, metadata=meta)
