"""HBM-resident exact flat index.

The device-resident replacement for the reference's on-disk FAISS
``IndexFlatL2`` (``store_in_faiss.py:102-109``): the corpus lives as a
padded float32 matrix in device memory, searched by a single
jit-compiled scan + top-k (XLA, or the fused Pallas kernel on a GPU).  The host keeps the
master copy for append/save; the device buffer is grown geometrically so
appends within capacity never recompile the search graph.

Also speaks the reference's artifact formats both ways:
  * ``load_faiss`` / ``save_faiss`` — FAISS flat files + metadata pickle
    (loads the bundled Piers Morgan corpus).
  * ``save_native`` / ``load_native`` — manifest.json + .npy shard, the
    checkpoint format of this framework (SURVEY.md §5 checkpoint/resume).
"""

from __future__ import annotations

import functools
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from qrag_tpu.index import faiss_io
from qrag_tpu.ops.topk import flat_scan_topk, scan_topk_verified
from qrag_tpu.platform import scan_route

MANIFEST_NAME = "manifest.json"
VECTORS_NAME = "vectors.npy"
METADATA_NAME = "metadata.json"


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pow2_bucket(x: int, floor: int = 8) -> int:
    """Pad append sizes to a pow2 bucket so the incremental-append jit
    compiles a bounded ladder of shapes, not one per add size."""
    b = floor
    while b < x:
        b *= 2
    return b


@jax.jit
def _append_into_capacity(
    matrix: jax.Array,  # (capacity, d) store dtype
    sqnorms: jax.Array,  # (capacity,) f32
    valid: jax.Array,  # (capacity,) bool
    new_rows: jax.Array,  # (bucket, d) f32, zero-padded past n_new
    n_new: jax.Array,  # int32 scalar: real rows in new_rows
    start: jax.Array,  # int32 scalar: write offset (== old ntotal)
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Device-side append (VERDICT r4 item 4): only the new rows ever
    cross host->device; the capacity buffers update on device via
    dynamic_update_slice.  NOT donated: concurrent lock-free readers
    may still hold the previous snapshot generation, so the update
    must produce fresh buffers (a device-side copy at HBM bandwidth —
    the same transient 2x the old full re-upload path peaked at, with
    ~corpus-size less host->device traffic)."""
    cap = matrix.shape[0]
    matrix = jax.lax.dynamic_update_slice(
        matrix, new_rows.astype(matrix.dtype), (start, 0)
    )
    new_sq = jnp.sum(new_rows * new_rows, axis=1, dtype=jnp.float32)
    sqnorms = jax.lax.dynamic_update_slice(sqnorms, new_sq, (start,))
    pos = jnp.arange(cap, dtype=jnp.int32)
    valid = valid | ((pos >= start) & (pos < start + n_new))
    return matrix, sqnorms, valid


@dataclass
class DeviceBuffers:
    """One immutable-by-convention generation of device buffers,
    published atomically (single attribute store) so lock-free readers
    never observe a mix of old and new corpus state."""

    matrix: jax.Array  # (capacity, d) store_dtype
    sqnorms: jax.Array  # (capacity,) f32
    valid: jax.Array  # (capacity,) bool
    ntotal: int
    extras: dict  # derived buffers: fidelity features, int8 forms, ...


def _rotation_features_impl(matrix, n_qubits, sqnorms):
    from qrag_tpu.ops.statevector import rotation_features

    return rotation_features(matrix, n_qubits, sqnorms=sqnorms)


# module-level jit: one trace cache across all indexes/uploads
_jit_rotation_features = jax.jit(
    _rotation_features_impl, static_argnames="n_qubits"
)


@dataclass
class SearchResult:
    """Results of a top-k search over the index."""

    scores: np.ndarray  # (B, k) — L2: ascending distances; IP: descending
    indices: np.ndarray  # (B, k) int32, -1 for padded/invalid slots
    metadata: List[List[Optional[str]]]  # per query, per hit

    def top(self, query: int = 0) -> List[Tuple[int, float, Optional[str]]]:
        return [
            (int(i), float(s), m)
            for i, s, m in zip(
                self.indices[query], self.scores[query], self.metadata[query]
            )
            if i >= 0
        ]


class DeviceFlatIndex:
    """Exact flat index with the corpus resident in device HBM."""

    # This index family exposes `device_buffers()` — one atomic
    # single-device snapshot the engine's fused graphs consume.  The
    # sharded family sets this False and the engine dispatches on the
    # flag (an explicit capability, not hasattr duck-typing).
    has_device_snapshot = True

    def __init__(
        self,
        d: int,
        metric: str = "l2",
        normalize: bool = False,
        row_pad_multiple: int = 128,
        use_pallas: bool = False,
        topk_mode: str = "bounded",  # r5 default flip: IndexConfig doc
        store_dtype: str = "float32",
        bounded_scan: str = "bf16",
        bounded_query_dtype: str = "float32",
        small_batch_accel: str = "none",
        accel_max_batch: int = 16,
        cluster_group_rows: int = 512,
        cluster_budget: Optional[int] = None,
        accel_read_cap: float = 0.5,
        device=None,
    ):
        if metric not in ("l2", "ip"):
            raise ValueError(f"unknown metric {metric!r}")
        if topk_mode not in ("exact", "approx", "verified", "refined", "bounded"):
            raise ValueError(f"unknown topk_mode {topk_mode!r}")
        if bounded_scan not in ("bf16", "int8"):
            raise ValueError(f"unknown bounded_scan {bounded_scan!r}")
        if bounded_query_dtype not in ("float32", "store"):
            raise ValueError(
                f"unknown bounded_query_dtype {bounded_query_dtype!r}"
            )
        if small_batch_accel not in ("none", "clustered", "clustered_probe"):
            raise ValueError(
                f"unknown small_batch_accel {small_batch_accel!r}"
            )
        # Small-batch latency accelerator (ops/cluster_topk.py): at
        # B <= accel_max_batch the scan is HBM-read-bound, so queries
        # route through the cluster-pruned PROVABLY-EXACT path (reads
        # only the certified groups) instead of the full scan.  Exact
        # for every topk_mode; rebuilt lazily per snapshot generation.
        self.small_batch_accel = small_batch_accel
        self.accel_max_batch = int(accel_max_batch)
        self.cluster_group_rows = int(cluster_group_rows)
        self.cluster_budget = cluster_budget
        # routing guard: skip the accelerator when its expected read
        # volume (batch * S * group_rows rows) would exceed this
        # fraction of the corpus — the full scan is then strictly
        # better.  0 disables the guard (correctness tests).
        self.accel_read_cap = float(accel_read_cap)
        self._cluster_assign: Optional[np.ndarray] = None
        self.bounded_scan = bounded_scan
        # "store": round queries to the store dtype before the bounded
        # scan — the result is then provably exact w.r.t. the ROUNDED
        # query (the fp16-store contract of e.g. GPU FAISS), which on a
        # bf16 store collapses the margin regime to narrow and buys the
        # lean certificate budgets.  Default "float32" keeps exactness
        # w.r.t. the query as given.
        self.bounded_query_dtype = bounded_query_dtype
        self.d = int(d)
        self.metric = metric
        self.normalize = normalize
        self.row_pad_multiple = max(8, int(row_pad_multiple))
        self.use_pallas = use_pallas
        self.topk_mode = topk_mode
        self.store_dtype = jnp.bfloat16 if store_dtype == "bfloat16" else jnp.float32
        self.device = device
        self.fallback_rows = 0  # verified-mode exact re-runs (observability)
        self.bounded_escalations = 0  # bounded-mode 4x-budget re-certs
        self.cluster_fallbacks = 0  # accel: full-scan backstop ran
        self.cluster_escalations = 0  # accel: 4x-budget tier ran
        self._host_vectors = np.zeros((0, d), dtype=np.float32)
        self.metadata: List[str] = []
        self._snapshot: Optional[DeviceBuffers] = None
        self._capacity = 0
        self._dirty = True
        # incremental-append state: rows added since the last upload
        # (device append within capacity transfers only these) and
        # whether the next upload must be a full one
        self._pending: List[np.ndarray] = []
        self._needs_full = True
        # Single-writer contract (SURVEY.md §5 race detection): the
        # reference's index read-modify-write and score cache were
        # unguarded; here mutation and device-upload are serialized.
        # The query path reads immutable device arrays, so concurrent
        # searches need no lock once uploaded.
        import threading

        self._write_lock = threading.Lock()

    # ------------------------------------------------------------------
    # construction / ingestion
    # ------------------------------------------------------------------

    @property
    def ntotal(self) -> int:
        return self._host_vectors.shape[0]

    def sample_rows(self, rows: Sequence[int]) -> np.ndarray:
        """Public row access for observability (recall sampling) and
        tooling — the supported alternative to reaching into
        ``_host_vectors``, so index types without a host master copy
        (e.g. an mmap-store bridge) can override it."""
        return np.asarray(self._host_vectors[np.asarray(rows, dtype=np.int64)])

    def add(
        self, vectors: np.ndarray, metadata: Optional[Sequence[str]] = None
    ) -> int:
        """Append vectors (validating d, unlike the reference —
        SURVEY.md Appendix A.6).  Returns new ntotal."""
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
            self._host_vectors = np.concatenate(
                [self._host_vectors, vectors], axis=0
            )
            if metadata is not None:
                self.metadata.extend(str(m) for m in metadata)
            else:
                self.metadata.extend([""] * vectors.shape[0])
            if self._snapshot is not None and not self._needs_full:
                # stash the canonical (validated/normalized) rows for
                # the incremental device append — within capacity the
                # next upload transfers ONLY these
                self._pending.append(vectors)
            self._dirty = True
        return self.ntotal

    @classmethod
    def from_numpy(
        cls,
        vectors: np.ndarray,
        metric: str = "l2",
        metadata: Optional[Sequence[str]] = None,
        normalize: bool = False,
        **kwargs,
    ) -> "DeviceFlatIndex":
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        idx = cls(d=vectors.shape[1], metric=metric, normalize=normalize, **kwargs)
        idx.add(vectors, metadata)
        return idx

    @classmethod
    def load_faiss(cls, path: str, **kwargs) -> "DeviceFlatIndex":
        """Load a FAISS flat index file + metadata sidecar."""
        data, meta = faiss_io.read_flat_with_metadata(path)
        return cls.from_numpy(
            data.vectors, metric=data.metric, metadata=meta, **kwargs
        )

    # ------------------------------------------------------------------
    # device residency
    # ------------------------------------------------------------------

    def _ensure_device(self) -> None:
        if not self._dirty and self._snapshot is not None:
            return
        with self._write_lock:
            self._upload_locked()

    def _upload_locked(self) -> None:
        if not self._dirty and self._snapshot is not None:
            return
        n = self.ntotal
        needed = max(self.row_pad_multiple, _round_up(n, self.row_pad_multiple))
        if (
            self._snapshot is not None
            and not self._needs_full
            and self._pending
            and needed <= self._capacity
        ):
            new_rows = np.concatenate(self._pending, axis=0)
            start = self._snapshot.ntotal
            bucket = _pow2_bucket(new_rows.shape[0])
            if start + bucket > self._capacity >= start + new_rows.shape[0]:
                # clamp the bucket at the capacity boundary (one
                # odd-shaped compile, once per capacity generation)
                bucket = self._capacity - start
            if start + bucket <= self._capacity:
                # incremental device append: transfer ONLY the new rows
                # (VERDICT r4 item 4 — the old path re-uploaded the
                # whole padded matrix on every add within capacity)
                self._append_pending_locked(new_rows, start, bucket)
                return
            # past capacity: fall through to the full growth upload
        if needed > self._capacity:
            if self._capacity:
                cap = max(needed, self._capacity * 2)  # geometric growth
            else:
                # first build: 25% headroom so early appends take the
                # incremental path instead of an immediate full regrow
                cap = needed + max(needed // 4, self.row_pad_multiple)
            self._capacity = _round_up(cap, self.row_pad_multiple)
        padded = np.zeros((self._capacity, self.d), dtype=np.float32)
        padded[:n] = self._host_vectors
        valid = np.zeros((self._capacity,), dtype=bool)
        valid[:n] = True
        put = (
            (lambda x: jax.device_put(x, self.device))
            if self.device is not None
            else jax.device_put
        )
        # sqnorms computed in f32 from the master copy even when the
        # device matrix is stored bf16 (keeps L2 corrections accurate)
        snap = DeviceBuffers(
            matrix=put(padded.astype(self.store_dtype)),
            sqnorms=put(np.sum(padded * padded, axis=1, dtype=np.float32)),
            valid=put(valid),
            ntotal=n,
            extras={},
        )
        self._finalize_snapshot(snap)
        # single attribute store publishes the whole generation
        # atomically — lock-free readers never see mixed buffers
        self._snapshot = snap
        self._dirty = False
        self._pending = []
        self._needs_full = False

    def _append_pending_locked(
        self, new_rows: np.ndarray, start: int, bucket: int
    ) -> None:
        """Incremental path of ``_upload_locked``: device-side
        dynamic_update_slice of the pending rows into the existing
        capacity buffers.  Derived extras (fidelity features, bounded
        buffers, quantized forms) are INVALIDATED and rebuild lazily —
        device-side computation, no host transfer."""
        old = self._snapshot
        n_new = new_rows.shape[0]
        padded = np.zeros((bucket, self.d), dtype=np.float32)
        padded[:n_new] = new_rows
        put = (
            (lambda x: jax.device_put(x, self.device))
            if self.device is not None
            else jax.device_put
        )
        matrix, sqnorms, valid = _append_into_capacity(
            old.matrix,
            old.sqnorms,
            old.valid,
            put(padded),
            jnp.int32(n_new),
            jnp.int32(start),
        )
        snap = DeviceBuffers(
            matrix=matrix,
            sqnorms=sqnorms,
            valid=valid,
            ntotal=self.ntotal,
            extras={},
        )
        self._finalize_snapshot(snap)
        self._snapshot = snap
        self._dirty = False
        self._pending = []

    def _finalize_snapshot(self, snap: "DeviceBuffers") -> None:
        """Hook for subclasses to attach derived buffers (quantized
        forms etc.) BEFORE the snapshot is published."""

    def device_buffers(self) -> "DeviceBuffers":
        """Atomic snapshot of all device-resident buffers for one
        corpus generation.  Callers doing multi-buffer reads MUST take
        one snapshot rather than reading attributes sequentially."""
        self._ensure_device()
        return self._snapshot

    # back-compat attribute views (single-buffer reads only)
    @property
    def _dev_matrix(self):
        return self._snapshot.matrix if self._snapshot else None

    @property
    def _dev_sqnorms(self):
        return self._snapshot.sqnorms if self._snapshot else None

    @property
    def _dev_valid(self):
        return self._snapshot.valid if self._snapshot else None

    @property
    def device_matrix(self) -> jax.Array:
        self._ensure_device()
        return self._snapshot.matrix

    def fidelity_features(
        self, n_qubits: int, snap: Optional["DeviceBuffers"] = None
    ) -> jax.Array:
        """Cached (capacity, n_qubits) rotation-encoding features —
        what the fused quantum rerank gathers instead of full rows
        (768/n_qubits× less HBM gather traffic).  Cached per snapshot
        generation."""
        if snap is None:
            snap = self.device_buffers()
        feats = snap.extras.get(("fid_feats", n_qubits))
        if feats is None:
            feats = _jit_rotation_features(
                snap.matrix.astype(jnp.float32), n_qubits, snap.sqnorms
            )
            snap.extras[("fid_feats", n_qubits)] = feats
        return feats

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------

    def _bounded_buffers(self, snap=None):
        """Derived buffers for topk_mode="bounded" (norm-bounded
        window pruning, ops/bounded_topk.py), cached per snapshot
        generation: a bf16 scan copy (aliases the matrix when it
        already stores bf16), per-window max row norms, lane ranks."""
        from qrag_tpu.ops.bounded_topk import window_maxnorms_device
        from qrag_tpu.ops.window_scan import make_lane_rank

        snap = self.device_buffers() if snap is None else snap
        bufs = snap.extras.get("bounded")
        if bufs is None:
            scan = (
                snap.matrix
                if snap.matrix.dtype == jnp.bfloat16
                else snap.matrix.astype(jnp.bfloat16)
            )
            mx = window_maxnorms_device(snap.sqnorms)
            lr = jnp.asarray(make_lane_rank(snap.matrix.shape[0]))
            bufs = (scan, mx, lr)
            snap.extras["bounded"] = bufs
        return snap, bufs

    def _bounded_eligible(self, k: int) -> bool:
        if self.topk_mode != "bounded" or self.ntotal == 0:
            return False
        cap = self.device_buffers().matrix.shape[0]
        # small corpora route to the exact sort (already cheap there)
        return cap >= 4096 and cap % 128 == 0 and cap // 128 >= max(k, 16)

    def _bounded_buffers_int8(self, snap=None):
        """Derived buffers for topk_mode="bounded" + bounded_scan=
        "int8": per-window int8 codes of the REFINE-domain rows (the
        margin derivation requires codes quantized from the exact rows
        the refine re-scores), window scales, min sqnorms and exact
        quantization-residual norms.  Cached per snapshot generation."""
        from qrag_tpu.ops.bounded_topk import (
            window_maxnorms_device,
            window_minsqnorms_device,
            window_quant_residuals_device,
        )
        from qrag_tpu.ops.window_scan import (
            make_lane_rank,
            quantize_block_rows_device,
        )

        snap = self.device_buffers() if snap is None else snap
        bufs = snap.extras.get("bounded_int8")
        if bufs is None:
            q8x, wscale = jax.jit(quantize_block_rows_device)(
                snap.matrix.astype(jnp.float32)
            )
            bufs = (
                q8x,
                wscale,
                window_maxnorms_device(snap.sqnorms),
                window_minsqnorms_device(snap.sqnorms),
                window_quant_residuals_device(snap.matrix, q8x, wscale),
                jnp.asarray(make_lane_rank(snap.matrix.shape[0])),
            )
            snap.extras["bounded_int8"] = bufs
        return snap, bufs

    def _bounded_search(self, queries: jnp.ndarray, k: int):
        """Provably-exact search via norm-bounded window pruning.
        Returns the raw op output (goodness, idx, fell_back,
        n_patched) — callers finalize."""
        from qrag_tpu.ops.bounded_topk import (
            bounded_exact_topk,
            bounded_exact_topk_int8,
        )

        if self.bounded_query_dtype == "store":
            # opt-in query rounding (constructor doc): exact w.r.t.
            # the store-dtype query; narrow margins on a bf16 store
            queries = queries.astype(self.store_dtype)

        if self.bounded_scan == "int8":
            snap, (q8x, wscale, mx, minsq, resid, lr) = (
                self._bounded_buffers_int8()
            )
            return bounded_exact_topk_int8(
                queries,
                q8x,
                wscale,
                snap.matrix,
                snap.sqnorms,
                mx,
                minsq,
                resid,
                lr,
                k,
                metric=self.metric,
                valid_rows=snap.valid,
            )
        snap, (scan, mx, lr) = self._bounded_buffers()
        return bounded_exact_topk(
            queries,
            scan,
            snap.matrix,
            snap.sqnorms,
            mx,
            lr,
            k,
            metric=self.metric,
            valid_rows=snap.valid,
            backend=scan_route(*scan.shape, scan.dtype),
        )

    def _accel_eligible(self, batch: int, k: int) -> bool:
        """Route this query batch through the small-batch clustered
        accelerator?  Geometry guards mirror _bounded_eligible: small
        corpora are already cheap exactly, and the structure needs
        several groups per top-k row to prune anything."""
        if (
            self.small_batch_accel not in ("clustered", "clustered_probe")
            or batch > self.accel_max_batch
        ):
            return False
        n = self.ntotal
        L = self.cluster_group_rows
        if not (n >= max(4096, 4 * L) and n // L >= max(2 * k, 8)):
            return False
        # the accelerator reads ~batch*S*L rows (per-query groups);
        # past accel_read_cap of the corpus the full scan is strictly
        # better (it reads each row once and prunes selection instead)
        if not self.accel_read_cap:
            return True
        from qrag_tpu.ops.cluster_topk import _auto_budget

        s_budget = self.cluster_budget or _auto_budget(k, L)
        return batch * s_budget * L <= n * self.accel_read_cap

    def build_clustered(self, snap=None):
        """Build (or fetch the cached) cluster-pruned acceleration
        structure for the current snapshot (ops/cluster_topk.py).
        Lazily invoked by search routing; call eagerly at serve
        startup (engine.warmup) — the k-means build is seconds-scale
        at 1M rows and must not land on the first live query.  A
        persisted permutation (save_native/load_native) skips the
        k-means; it invalidates on append (ntotal changes)."""
        from qrag_tpu.ops.cluster_topk import build_clustered_groups

        snap = self.device_buffers() if snap is None else snap
        groups = snap.extras.get("clustered")
        if groups is None:
            # size off the SNAPSHOT's row count, not self.ntotal: with
            # an explicit (possibly older) snap a concurrent append
            # must not leak capacity-padding rows into the structure
            n = snap.ntotal
            assign = self._cluster_assign
            if assign is not None and assign.shape[0] != n:
                assign = None  # appended since the assignment was made
            # build over the VALID rows only (capacity padding would
            # dilute the group stats); the clustered structure carries
            # its own permutation/padding
            groups = build_clustered_groups(
                snap.matrix[:n],
                group_rows=self.cluster_group_rows,
                assign=assign,
                # scoring norms: the snapshot's master-f32 sqnorms —
                # the accel ranks by the SAME refine function as the
                # full scan/bounded paths even on a bf16 store
                # (ADVICE r4 medium: stored-row norms diverged)
                sqnorms=snap.sqnorms[:n],
            )
            snap.extras["clustered"] = groups
            if assign is None:
                # recover a persistable assignment from the structure:
                # labeling each row by its GROUP reproduces the exact
                # layout on rebuild (each group re-pads to itself, and
                # within-group original order is already ascending)
                oid = np.asarray(groups.orig_idx)
                vld = np.asarray(groups.valid_p)
                L = groups.group_rows
                gid = np.repeat(
                    np.arange(oid.shape[0] // L, dtype=np.int32), L
                )
                assign = np.empty((n,), np.int32)
                assign[oid[vld]] = gid[vld]
            self._cluster_assign = assign
        return groups

    def _accel_search(self, queries: jnp.ndarray, k: int):
        """Raw cluster-pruned exact search (goodness, ORIGINAL idx,
        fell_back, escalated) — callers finalize."""
        from qrag_tpu.ops.cluster_topk import cluster_pruned_topk

        groups = self.build_clustered()
        return cluster_pruned_topk(
            queries.astype(jnp.float32),
            groups,
            k,
            metric=self.metric,
            budget=self.cluster_budget,
            # "clustered_probe" = IVF nprobe semantics: no
            # certificates, recall set by cluster_budget — the ONLY
            # approximate arm of this accelerator, and an explicit
            # opt-in ("clustered" stays provably exact)
            certify=self.small_batch_accel != "clustered_probe",
        )

    def search_device(
        self, queries: jnp.ndarray, k: int
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Device-level search: (B, d) queries → (scores, indices) on
        device, padded rows masked out.  Stays inside jit if called
        under one (the "verified" mode's host patch-up degrades to
        "approx" here; "bounded" runs its real exact path; use
        `search` for verified-exact results with observability).

        The small-batch clustered accelerator routes here only when
        its structure is ALREADY built (the k-means build needs host
        control flow, so it cannot happen under an enclosing trace —
        `search`/`build_clustered` build it)."""
        if (
            self._accel_eligible(queries.shape[0], k)
            and self.device_buffers().extras.get("clustered") is not None
        ):
            from qrag_tpu.ops.topk import _finalize

            vals, idx, _, _ = self._accel_search(
                queries.astype(jnp.float32), k
            )
            return _finalize(vals, idx, self.metric)
        if self._bounded_eligible(k):
            from qrag_tpu.ops.topk import _finalize

            vals, idx, _, _, _ = self._bounded_search(
                queries.astype(jnp.float32), k
            )
            return _finalize(vals, idx, self.metric)
        snap = self.device_buffers()
        return flat_scan_topk(
            queries.astype(self.store_dtype),
            snap.matrix,
            k,
            metric=self.metric,
            corpus_sqnorms=snap.sqnorms,
            valid_rows=snap.valid,
            use_pallas=self.use_pallas,
            mode=self.topk_mode,
        )

    def search(self, queries: np.ndarray, k: int = 10) -> SearchResult:
        """Host-level search with metadata resolution."""
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if queries.shape[1] != self.d:
            raise ValueError(
                f"expected (*, {self.d}) queries, got {queries.shape}"
            )
        k_eff = min(k, max(self.ntotal, 1))
        snap = self.device_buffers()
        if self._accel_eligible(queries.shape[0], k_eff):
            from qrag_tpu.ops.topk import _finalize

            vals, idx, fell_back, escalated = self._accel_search(
                jnp.asarray(queries, jnp.float32), k_eff
            )
            self.cluster_fallbacks += int(np.asarray(fell_back))
            self.cluster_escalations += int(np.asarray(escalated))
            scores, indices = _finalize(vals, idx, self.metric)
        elif self.topk_mode == "verified" and not self.use_pallas:
            scores, indices, n_bad = scan_topk_verified(
                jnp.asarray(queries).astype(self.store_dtype),
                snap.matrix,
                k_eff,
                metric=self.metric,
                corpus_sqnorms=snap.sqnorms,
                valid_rows=snap.valid,
            )
            self.fallback_rows += n_bad
        elif self._bounded_eligible(k_eff):
            from qrag_tpu.ops.topk import _finalize

            vals, idx, fell_back, _, escalated = self._bounded_search(
                jnp.asarray(queries, jnp.float32), k_eff
            )
            # observability: count whole-batch cert fallbacks in the
            # same counter /stats surfaces (row-granular for verified,
            # batch-granular here; both are "exactness needed a slow
            # path" events)
            self.fallback_rows += int(np.asarray(fell_back))
            self.bounded_escalations += int(np.asarray(escalated))
            scores, indices = _finalize(vals, idx, self.metric)
        else:
            scores, indices = self.search_device(jnp.asarray(queries), k_eff)
        scores = np.asarray(scores)
        indices = np.asarray(indices, dtype=np.int32)
        # mark hits beyond ntotal (possible when ntotal == 0) invalid
        invalid = (indices < 0) | (indices >= self.ntotal)
        indices = np.where(invalid, -1, indices)
        meta = [
            [None if i < 0 else (self.metadata[i] or None) for i in row]
            for row in indices
        ]
        return SearchResult(scores=scores, indices=indices, metadata=meta)

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    def save_faiss(self, path: str) -> None:
        faiss_io.write_flat_index(path, self._host_vectors, metric=self.metric)
        # overwrite (not append) the sidecar unconditionally: the index
        # file was fully rewritten, and a stale sidecar from a previous
        # save must not survive next to it
        import pickle

        meta_path = faiss_io.metadata_path_for(path)
        with open(meta_path + ".tmp", "wb") as f:
            pickle.dump(list(self.metadata), f)
        os.replace(meta_path + ".tmp", meta_path)

    def save_native(self, directory: str) -> None:
        """Manifest + raw vectors: the framework's own checkpoint format."""
        os.makedirs(directory, exist_ok=True)
        np.save(os.path.join(directory, VECTORS_NAME), self._host_vectors)
        with open(os.path.join(directory, METADATA_NAME), "w") as f:
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
        # persist the clustered-accel assignment when one exists for
        # the current rows: load_native then skips the k-means rebuild
        # (the rest of the structure is one cheap device pass)
        assign = getattr(self, "_cluster_assign", None)
        if assign is not None and assign.shape[0] == self.ntotal:
            np.save(
                os.path.join(directory, "cluster_assign.npy"),
                np.asarray(assign, np.int32),
            )
            manifest["cluster_group_rows"] = self.cluster_group_rows
        with open(os.path.join(directory, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f, indent=2)

    @classmethod
    def load_native(cls, directory: str, **kwargs) -> "DeviceFlatIndex":
        with open(os.path.join(directory, MANIFEST_NAME)) as f:
            manifest = json.load(f)
        if manifest.get("format") != "qrag_tpu.flat_index":
            raise ValueError(f"{directory}: not a qrag_tpu flat index")
        vectors = np.load(os.path.join(directory, VECTORS_NAME))
        meta_path = os.path.join(directory, METADATA_NAME)
        metadata: Optional[List[str]] = None
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                metadata = json.load(f)
        kwargs.setdefault("row_pad_multiple", manifest.get("row_pad_multiple", 128))
        idx = cls.from_numpy(
            vectors,
            metric=manifest["metric"],
            metadata=metadata,
            **kwargs,
        )
        idx.normalize = bool(manifest.get("normalized", False))
        assign_path = os.path.join(directory, "cluster_assign.npy")
        if (
            os.path.exists(assign_path)
            and manifest.get("cluster_group_rows") == idx.cluster_group_rows
        ):
            assign = np.load(assign_path)
            if assign.shape[0] == idx.ntotal:
                idx._cluster_assign = assign.astype(np.int32)
        return idx
