"""ctypes bindings for the native index store (``native/indexstore.cpp``).

`NativeVectorStore` is the host-runtime side of the index: an
mmap-backed append-only float32 row store with a binary manifest and a
C++ exact scan+top-k (heap selection, lower-index tie-break — matching
``lax.top_k`` and the Pallas kernel).  It plays the role faiss-cpu's
C++ played for the reference: durable index storage and a CPU scan
oracle; the device path loads from it via `to_device_index`.

The shared library auto-builds on first use (``make -C
qrag_tpu/native``; g++ is part of the image).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libqidx.so")
_BUILD_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

METRIC_IP = 0
METRIC_L2 = 1


def _build_library() -> None:
    subprocess.run(
        ["make", "-C", _NATIVE_DIR, "-s"],
        check=True,
        capture_output=True,
        text=True,
    )


def load_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    with _BUILD_LOCK:
        if _LIB is not None:
            return _LIB
        if not os.path.exists(_LIB_PATH):
            _build_library()
        lib = ctypes.CDLL(_LIB_PATH)
        if not hasattr(lib, "qidx_cluster_topk"):
            # a prebuilt .so from an older commit lacks the newer
            # symbols; rebuild (make is a fast no-op when fresh) and
            # reload rather than failing on registration below
            _build_library()
            lib = ctypes.CDLL(_LIB_PATH)
        c = ctypes
        lib.qidx_open.restype = c.c_void_p
        lib.qidx_open.argtypes = [c.c_char_p, c.c_uint32, c.c_uint32, c.c_uint32, c.c_int]
        lib.qidx_dim.restype = c.c_uint32
        lib.qidx_dim.argtypes = [c.c_void_p]
        lib.qidx_metric.restype = c.c_uint32
        lib.qidx_metric.argtypes = [c.c_void_p]
        lib.qidx_normalized.restype = c.c_uint32
        lib.qidx_normalized.argtypes = [c.c_void_p]
        lib.qidx_ntotal.restype = c.c_uint64
        lib.qidx_ntotal.argtypes = [c.c_void_p]
        lib.qidx_append.restype = c.c_int64
        lib.qidx_append.argtypes = [c.c_void_p, c.POINTER(c.c_float), c.c_uint64]
        lib.qidx_read.restype = c.c_int
        lib.qidx_read.argtypes = [c.c_void_p, c.c_uint64, c.c_uint64, c.POINTER(c.c_float)]
        lib.qidx_flush.restype = c.c_int
        lib.qidx_flush.argtypes = [c.c_void_p]
        lib.qidx_close.restype = None
        lib.qidx_close.argtypes = [c.c_void_p]
        lib.qidx_scan_topk.restype = None
        lib.qidx_scan_topk.argtypes = [
            c.c_void_p, c.POINTER(c.c_float), c.c_uint64, c.c_uint32,
            c.POINTER(c.c_float), c.POINTER(c.c_int64),
        ]
        lib.qidx_raw_scan_topk.restype = None
        lib.qidx_raw_scan_topk.argtypes = [
            c.POINTER(c.c_float), c.c_uint64, c.c_uint32,
            c.POINTER(c.c_float), c.c_uint64, c.c_uint32, c.c_uint32,
            c.POINTER(c.c_float), c.POINTER(c.c_int64),
        ]
        lib.qidx_raw_scan_topk_mt.restype = None
        lib.qidx_raw_scan_topk_mt.argtypes = [
            c.POINTER(c.c_float), c.c_uint64, c.c_uint32,
            c.POINTER(c.c_float), c.c_uint64, c.c_uint32, c.c_uint32,
            c.c_uint32, c.POINTER(c.c_float), c.POINTER(c.c_int64),
        ]
        lib.qidx_scan_topk_mt.restype = None
        lib.qidx_scan_topk_mt.argtypes = [
            c.c_void_p, c.POINTER(c.c_float), c.c_uint64, c.c_uint32,
            c.c_uint32, c.POINTER(c.c_float), c.POINTER(c.c_int64),
        ]
        lib.qidx_cluster_topk.restype = None
        lib.qidx_cluster_topk.argtypes = [
            c.c_void_p,  # store handle
            c.POINTER(c.c_float),  # xsq
            c.POINTER(c.c_int32), c.POINTER(c.c_int64),  # order, goff
            c.POINTER(c.c_float), c.POINTER(c.c_float),  # cent, csq
            c.POINTER(c.c_float), c.POINTER(c.c_float),  # radii, mxn
            c.c_uint32,  # G
            c.POINTER(c.c_float), c.c_uint64, c.c_uint32,  # q, b, k
            c.c_uint32,  # budget
            c.POINTER(c.c_float), c.POINTER(c.c_int64),  # out
            c.POINTER(c.c_uint32),  # stats
        ]
        lib.qidx_raw_cluster_topk_mt.restype = None
        lib.qidx_raw_cluster_topk_mt.argtypes = [
            c.POINTER(c.c_float), c.c_uint64, c.c_uint32,  # x, n, d
            c.POINTER(c.c_float),  # xsq
            c.POINTER(c.c_int32), c.POINTER(c.c_int64),  # order, goff
            c.POINTER(c.c_float), c.POINTER(c.c_float),  # cent, csq
            c.POINTER(c.c_float), c.POINTER(c.c_float),  # radii, mxn
            c.c_uint32,  # G
            c.POINTER(c.c_float), c.c_uint64, c.c_uint32,  # q, b, k
            c.c_uint32, c.c_uint32, c.c_uint32,  # metric, budget, threads
            c.POINTER(c.c_float), c.POINTER(c.c_int64),  # out
            c.POINTER(c.c_uint32),  # stats
        ]
        lib.qidx_raw_cluster_topk.restype = None
        lib.qidx_raw_cluster_topk.argtypes = [
            c.POINTER(c.c_float), c.c_uint64, c.c_uint32,  # x, n, d
            c.POINTER(c.c_float),  # xsq
            c.POINTER(c.c_int32), c.POINTER(c.c_int64),  # order, goff
            c.POINTER(c.c_float), c.POINTER(c.c_float),  # cent, csq
            c.POINTER(c.c_float), c.POINTER(c.c_float),  # radii, mxn
            c.c_uint32,  # G
            c.POINTER(c.c_float), c.c_uint64, c.c_uint32,  # q, b, k
            c.c_uint32, c.c_uint32,  # metric, budget
            c.POINTER(c.c_float), c.POINTER(c.c_int64),  # out
            c.POINTER(c.c_uint32),  # stats (2,)
        ]
        _LIB = lib
    return _LIB


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeVectorStore:
    """mmap-backed append-only vector store (single writer, torn-read
    safe for concurrent readers)."""

    def __init__(
        self,
        path: str,
        d: int = 0,
        metric: str = "l2",
        normalized: bool = False,
        writable: bool = True,
    ):
        self._lib = load_library()
        metric_code = METRIC_L2 if metric == "l2" else METRIC_IP
        self._handle = self._lib.qidx_open(
            path.encode(), d, metric_code, int(normalized), int(writable)
        )
        if not self._handle:
            raise OSError(
                f"cannot open native store {path!r} "
                f"(missing file, bad magic, or d mismatch)"
            )
        self.path = path

    # ---------------------------------------------------------- properties

    @property
    def d(self) -> int:
        return int(self._lib.qidx_dim(self._handle))

    @property
    def ntotal(self) -> int:
        return int(self._lib.qidx_ntotal(self._handle))

    @property
    def metric(self) -> str:
        return "l2" if self._lib.qidx_metric(self._handle) == METRIC_L2 else "ip"

    @property
    def normalized(self) -> bool:
        return bool(self._lib.qidx_normalized(self._handle))

    # ------------------------------------------------------------------ ops

    def append(self, rows: np.ndarray) -> int:
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        if rows.ndim != 2 or rows.shape[1] != self.d:
            raise ValueError(f"expected (*, {self.d}) rows, got {rows.shape}")
        total = self._lib.qidx_append(self._handle, _fptr(rows), rows.shape[0])
        if total < 0:
            raise OSError("append failed (read-only store or IO error)")
        return int(total)

    def read(self, start: int = 0, n: Optional[int] = None) -> np.ndarray:
        n = self.ntotal - start if n is None else n
        out = np.empty((n, self.d), np.float32)
        if n and self._lib.qidx_read(self._handle, start, n, _fptr(out)) != 0:
            raise IndexError(f"read [{start}, {start + n}) out of range")
        return out

    def flush(self) -> None:
        self._lib.qidx_flush(self._handle)

    def build_clusters(
        self, rows_per_cluster: int = 2048, iters: int = 6, seed: int = 0
    ) -> "HostClusters":
        """Build (and cache) the cluster-pruned structure over the
        store's current rows (one read pass; invalidated by append
        via the ntotal key)."""
        key = (self.ntotal, rows_per_cluster, iters, seed)
        cached = getattr(self, "_clusters", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        clusters = build_host_clusters(
            self.read(), rows_per_cluster=rows_per_cluster, iters=iters,
            seed=seed,
        )
        self._clusters = (key, clusters)
        return clusters

    def cluster_topk(
        self,
        queries: np.ndarray,
        k: int,
        clusters: Optional["HostClusters"] = None,
        budget: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Cluster-pruned PROVABLY-EXACT top-k over the mmap'd store
        rows in place (the host twin of the device accelerator; see
        ``raw_cluster_topk``).  Returns (scores, indices, stats)."""
        if clusters is None:
            clusters = self.build_clusters()
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        b = queries.shape[0]
        if budget <= 0:
            budget = max(8, 2 * k)
        scores = np.empty((b, k), np.float32)
        idx = np.empty((b, k), np.int64)
        stats = np.zeros((2,), np.uint32)
        order = np.ascontiguousarray(clusters.order, np.int32)
        goff = np.ascontiguousarray(clusters.goff, np.int64)
        self._lib.qidx_cluster_topk(
            self._handle,
            _fptr(np.ascontiguousarray(clusters.xsq, np.float32)),
            order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            goff.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            _fptr(np.ascontiguousarray(clusters.cent, np.float32)),
            _fptr(np.ascontiguousarray(clusters.csq, np.float32)),
            _fptr(np.ascontiguousarray(clusters.radii, np.float32)),
            _fptr(np.ascontiguousarray(clusters.mxn, np.float32)),
            clusters.cent.shape[0],
            _fptr(queries), b, k, budget,
            _fptr(scores),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            stats.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        )
        return scores, idx, stats

    def scan_topk(
        self, queries: np.ndarray, k: int, threads: int = 1
    ) -> Tuple[np.ndarray, np.ndarray]:
        """C++ exact scan: (scores, indices); L2 distances ascending /
        IP descending, -1 indices when ntotal < k.  ``threads``: 1 =
        the deterministic single-thread oracle; 0 = all cores; >1 =
        exactly that many (query-parallel for batches, corpus-split +
        merge for small batches — results identical either way)."""
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        b = queries.shape[0]
        scores = np.empty((b, k), np.float32)
        idx = np.empty((b, k), np.int64)
        out_i = idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        if threads == 1:
            self._lib.qidx_scan_topk(
                self._handle, _fptr(queries), b, k, _fptr(scores), out_i
            )
        else:
            self._lib.qidx_scan_topk_mt(
                self._handle, _fptr(queries), b, k, threads,
                _fptr(scores), out_i,
            )
        return scores, idx

    def close(self) -> None:
        if self._handle:
            self._lib.qidx_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------- bridges

    def to_device_index(self, **kwargs):
        """Load into the device-resident DeviceFlatIndex."""
        from qrag_tpu.index.flat_index import DeviceFlatIndex

        return DeviceFlatIndex.from_numpy(
            self.read(), metric=self.metric, **kwargs
        )


def cpu_scan_topk(
    x: np.ndarray,
    queries: np.ndarray,
    k: int,
    metric: str = "l2",
    threads: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """C++ exact scan over a raw matrix (no store) — the CPU oracle
    (threads=1) and its parallel serving variant (threads=0 → all
    cores; identical results, tie order included)."""
    lib = load_library()
    x = np.ascontiguousarray(x, dtype=np.float32)
    queries = np.ascontiguousarray(queries, dtype=np.float32)
    if queries.ndim == 1:
        queries = queries[None, :]
    b = queries.shape[0]
    scores = np.empty((b, k), np.float32)
    idx = np.empty((b, k), np.int64)
    out_i = idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    metric_code = METRIC_L2 if metric == "l2" else METRIC_IP
    if threads == 1:
        lib.qidx_raw_scan_topk(
            _fptr(x), x.shape[0], x.shape[1], _fptr(queries), b, k,
            metric_code, _fptr(scores), out_i,
        )
    else:
        lib.qidx_raw_scan_topk_mt(
            _fptr(x), x.shape[0], x.shape[1], _fptr(queries), b, k,
            metric_code, threads, _fptr(scores), out_i,
        )
    return scores, idx


class HostClusters:
    """Variable-size cluster structure for the native cluster-pruned
    exact search (``qidx_raw_cluster_topk`` — the host-tier twin of
    ``ops/cluster_topk.py``; faiss-cpu's IVF role, but provably
    exact).  Built once per corpus; any assignment yields a correct
    structure (quality only sets the pruning rate)."""

    def __init__(self, order, goff, cent, csq, radii, mxn, xsq):
        self.order = order  # (n,) int32 row ids grouped by cluster
        self.goff = goff  # (G+1,) int64 offsets into order
        self.cent = cent  # (G, d) f32
        self.csq = csq  # (G,) f32
        self.radii = radii  # (G,) f32 (inflated)
        self.mxn = mxn  # (G,) f32 (inflated)
        self.xsq = xsq  # (n,) f32 row squared norms (build-time)


def build_host_clusters(
    x: np.ndarray,
    rows_per_cluster: int = 2048,
    iters: int = 6,
    seed: int = 0,
) -> HostClusters:
    """NumPy Lloyd k-means + per-cluster stats, with the same float-
    rounding inflation discipline as the device build (radii/maxnorms
    scaled by 1 + ~d*eps headroom so the C++ float margins stay
    rigorous)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    n, d = x.shape
    if n == 0:
        # empty corpus: zero clusters — every query rides the (empty)
        # fallback and gets the padded -1/inf output scan_topk returns
        return HostClusters(
            np.zeros((0,), np.int32), np.zeros((1,), np.int64),
            np.zeros((0, d), np.float32), np.zeros((0,), np.float32),
            np.zeros((0,), np.float32), np.zeros((0,), np.float32),
            np.zeros((0,), np.float32),
        )
    g = max(1, n // max(rows_per_cluster, 1))
    rng = np.random.default_rng(seed)
    cent = x[np.sort(rng.choice(n, size=g, replace=False))].astype(
        np.float64
    )
    x64 = x.astype(np.float64)
    assign = np.zeros((n,), np.int64)
    for _ in range(max(iters, 1)):
        # chunked assignment (memory-bounded)
        for s in range(0, n, 65536):
            xb = x64[s : s + 65536]
            dots = xb @ cent.T
            assign[s : s + 65536] = np.argmax(
                dots - 0.5 * np.sum(cent * cent, axis=1)[None, :], axis=1
            )
        sums = np.zeros_like(cent)
        np.add.at(sums, assign, x64)
        counts = np.bincount(assign, minlength=g).astype(np.float64)
        nonzero = counts > 0
        cent[nonzero] = sums[nonzero] / counts[nonzero, None]

    order = np.argsort(assign, kind="stable").astype(np.int32)
    sizes = np.bincount(assign, minlength=g)
    goff = np.zeros((g + 1,), np.int64)
    goff[1:] = np.cumsum(sizes)
    centf = cent.astype(np.float32)
    infl = np.float32(1.0 + 4.0e-7 * max(d, 768))
    radii = np.zeros((g,), np.float32)
    mxn = np.zeros((g,), np.float32)
    for c in range(g):
        rows = x[order[goff[c] : goff[c + 1]]]
        if rows.shape[0] == 0:
            continue
        diff = rows.astype(np.float64) - cent[c][None, :]
        radii[c] = np.sqrt((diff * diff).sum(axis=1).max()) * infl + 1e-20
        mxn[c] = np.sqrt(
            (rows.astype(np.float64) ** 2).sum(axis=1).max()
        ) * infl + 1e-20
    # csq is NOT inflated: for l2 a larger csq would RAISE the
    # distance lower bound and under-state ub (unsound direction);
    # its computation error is covered by the C side's e2 margin
    csq = np.sum(centf.astype(np.float64) * centf, axis=1).astype(
        np.float32
    )
    xsq = np.einsum("nd,nd->n", x, x, dtype=np.float64).astype(np.float32)
    return HostClusters(order, goff, centf, csq, radii, mxn, xsq)


def raw_cluster_topk(
    x: np.ndarray,
    clusters: HostClusters,
    queries: np.ndarray,
    k: int,
    metric: str = "l2",
    budget: int = 0,
    threads: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cluster-pruned PROVABLY-EXACT top-k over a raw host matrix.

    Returns (scores finalized like ``raw_scan_topk``, indices, stats
    (2,) uint32 = (fallback queries, escalated queries)).  Exactness
    is unconditional — certificate failures escalate 4x then run the
    exact full scan per query."""
    lib = load_library()
    x = np.ascontiguousarray(x, dtype=np.float32)
    queries = np.ascontiguousarray(queries, dtype=np.float32)
    if queries.ndim == 1:
        queries = queries[None, :]
    b = queries.shape[0]
    n, d = x.shape
    xsq = np.ascontiguousarray(clusters.xsq, np.float32)
    if budget <= 0:
        budget = max(8, 2 * k)
    scores = np.empty((b, k), np.float32)
    idx = np.empty((b, k), np.int64)
    stats = np.zeros((2,), np.uint32)
    order = np.ascontiguousarray(clusters.order, np.int32)
    goff = np.ascontiguousarray(clusters.goff, np.int64)
    metric_code = METRIC_L2 if metric == "l2" else METRIC_IP
    common = (
        _fptr(x), n, d, _fptr(xsq),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        goff.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _fptr(np.ascontiguousarray(clusters.cent, np.float32)),
        _fptr(np.ascontiguousarray(clusters.csq, np.float32)),
        _fptr(np.ascontiguousarray(clusters.radii, np.float32)),
        _fptr(np.ascontiguousarray(clusters.mxn, np.float32)),
        clusters.cent.shape[0],
        _fptr(queries), b, k, metric_code, budget,
    )
    outs = (
        _fptr(scores),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        stats.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    if threads == 1:
        lib.qidx_raw_cluster_topk(*common, *outs)
    else:
        lib.qidx_raw_cluster_topk_mt(*common, threads, *outs)
    return scores, idx, stats
