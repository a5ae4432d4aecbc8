#!/usr/bin/env python
"""Start the exact-retrieval service on one GPU and check it.

Drives the main path once, through the entry points a user calls:

  * a 1,000,000 x 768 unit-norm corpus (BASELINE configs[2]) made on
    the device from ``--seed`` with bench.py's generator, loaded into
    the engine that ``qrag-serve`` builds (default ``IndexConfig``: a
    float32 store with ``topk_mode="bounded"`` and its bf16 scan copy);
  * ``serve_in_thread`` with batching, in this process, answering
    ``POST /search`` (k=10, k=100, single queries and a concurrent
    burst), ``POST /search_rerank`` (quantum and classical routes),
    ``POST /rerank`` (the shipped cross-encoder) and ``GET /stats``;
  * one direct index search at the headline batch B=1024, k=10;
  * every kernel of that path, compiled for the card, against its XLA
    twin at the real width.

Results are compared with plain references: a float64 NumPy top-k on
the host, the complex128 circuit oracle of ``tests/oracle_qiskit.py``,
and the cross-encoder's float32 HIGHEST-precision forward pass.  Any
failed check makes the run exit non-zero.  The last line of stdout is
``{"ok": true, "device": {...}}``.

``--four-cards`` runs only the row-sharded path (``ShardedFlatIndex``,
``qrag-serve --sharded``) over four cards: a 1M-row index as
``qrag-serve --sharded`` configures it, filled through ``add``, and a
100,000,000 x 768 bf16 corpus (BASELINE configs[4]) made on the cards;
bounded search with float32 and store-dtype queries, each with the
allgather and the ring merge, and the sharded exact sort, all checked
against a float64 top-k over every row.

The script needs a GPU and refuses to run without one.  One process
holds each card: JAX reserves most of a card's memory on first use.

Usage: python chip_smoke.py [--seed N] [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

# ---------------------------------------------------------------- references

U32 = 2.0 ** -24  # f32 unit roundoff


def reference_topk(x, q, k, chunk=65536):
    """Float64 top-k by squared L2 over host rows ``x``, in row chunks
    scored on 8 threads; ties go to the lower index.  Returns
    (d2 (B, k), ids)."""
    q64 = np.asarray(q, np.float64)
    qsq = np.sum(q64 * q64, axis=1, keepdims=True)

    def part(s):
        xc = np.asarray(x[s:s + chunk], np.float64)
        d2 = qsq - 2.0 * (q64 @ xc.T) + np.sum(xc * xc, axis=1)[None, :]
        kk = min(k, d2.shape[1])
        kth = np.partition(d2, kk - 1, axis=1)[:, kk - 1:kk]
        # every row up to the k-th value, ties included, so that the
        # merge below sees the lowest-index ones
        keep = [np.nonzero(row <= t)[0] for row, t in zip(d2, kth)]
        return [(d2[b, j], s + j) for b, j in enumerate(keep)]

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(8) as pool:
        parts = list(pool.map(part, range(0, x.shape[0], chunk)))
    best_d = np.empty((q64.shape[0], k))
    best_i = np.empty((q64.shape[0], k), np.int64)
    for b in range(q64.shape[0]):
        cd = np.concatenate([p[b][0] for p in parts])
        ci = np.concatenate([p[b][1] for p in parts])
        order = np.lexsort((ci, cd))[:k]
        best_d[b], best_i[b] = cd[order], ci[order]
    return best_d, best_i


def round_bf16(a):
    """Round f32 values to the nearest bf16 (ties to even), as f32."""
    u = np.asarray(a, np.float32).view(np.uint32)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


class MeshRows:
    """Host float32 copies of rows of a row-sharded device matrix,
    gathered card by card with a plain ``take`` (an independent read
    path: the store's own gather is under test): ``rows[ids]``."""

    def __init__(self, matrix, n):
        import jax
        import jax.numpy as jnp

        blocks = {}
        for s in matrix.addressable_shards:
            blocks.setdefault(s.index[0].start or 0, s.data)
        self.blocks = sorted(blocks.items())
        self.per = matrix.shape[0] // len(self.blocks)
        self.shape = (n, matrix.shape[1])
        self._gather = jax.jit(lambda a, i: jnp.take(a, i, axis=0))

    def __getitem__(self, ids):
        ids = np.asarray(ids)
        flat = ids.reshape(-1)
        out = np.empty((flat.shape[0], self.shape[1]), np.float32)
        for lo, data in self.blocks:
            mine = (flat >= lo) & (flat < lo + self.per)
            if mine.any():
                local = np.where(mine, flat - lo, 0).astype(np.int32)
                out[mine] = np.asarray(self._gather(data, local), np.float32)[mine]
        return out.reshape(ids.shape + (self.shape[1],))


def mesh_reference_topk(x, q, k):
    """Float64 top-k by squared L2 over the rows of ``MeshRows`` ``x``,
    computed where the rows live: each card scores its shard in float64
    with plain jnp, slice by slice (``lax.top_k`` keeps the lower index
    among ties), and the host merges.  Returns (d2 (B, k), ids).
    (Streaming the rows to the host instead took 103.5 s for 25M rows
    on a 16-core host.)"""
    import functools

    import jax
    import jax.numpy as jnp

    rows = min(x.per & -x.per, 1 << 17)  # a power of two dividing the shard

    with jax.enable_x64(True):
        @functools.partial(jax.jit, static_argnames=("k", "rows"))
        def shard_topk(data, q64, lo, n, k, rows):
            qsq = jnp.sum(q64 * q64, axis=1, keepdims=True)

            def one(at):
                x64 = jax.lax.dynamic_slice_in_dim(data, at, rows).astype(jnp.float64)
                d2 = qsq - 2.0 * (q64 @ x64.T) + jnp.sum(x64 * x64, axis=1)[None, :]
                ids = lo + at + jnp.arange(rows, dtype=jnp.int64)
                v, j = jax.lax.top_k(-jnp.where(ids < n, d2, jnp.inf), k)
                return -v, ids[j]

            return jax.lax.map(one, jnp.arange(0, data.shape[0], rows, dtype=jnp.int64))

        parts = []
        for lo, data in x.blocks:
            q64 = jax.device_put(np.asarray(q, np.float64), data.device)
            parts.append(shard_topk(data, q64, lo, x.shape[0], k=k, rows=rows))
        parts = [(np.asarray(v), np.asarray(i)) for v, i in parts]
    cd = np.concatenate([np.moveaxis(v, 0, 1).reshape(len(q), -1) for v, _ in parts], axis=1)
    ci = np.concatenate([np.moveaxis(i, 0, 1).reshape(len(q), -1) for _, i in parts], axis=1)
    order = np.lexsort((ci, cd), axis=1)[:, :k]
    return np.take_along_axis(cd, order, axis=1), np.take_along_axis(ci, order, axis=1)


def d2_tolerance(d, qnorm=1.0, xnorm=1.0):
    """Bound on |f32 evaluation - exact| of 2 q.x - |q|^2 - |x|^2: the
    d-term f32 dot drifts at most d * 2^-24 * |q||x| (twice, for 2 q.x)
    plus the rounding of the three-term sum and the stored norms."""
    return 2.0 * d * U32 * qnorm * xnorm + 8.0 * U32 * (qnorm ** 2 + xnorm ** 2)


def check_topk(x, q, ids, d2, k, label, ref=None):
    """Served (ids, squared distances) against the float64 reference
    (``ref``, or computed here).  Ids and tie order must match exactly,
    except at positions where the float64 gap between the served row
    and the reference row is inside the f32 evaluation tolerance (a tie
    the f32 arithmetic cannot order).  Scores must match within that
    tolerance too."""
    ref_d, ref_i = reference_topk(x, q, k) if ref is None else ref
    tol = d2_tolerance(x.shape[1], 1.0, float(np.sqrt(np.max(
        np.sum(np.asarray(x[np.asarray(ids).ravel()], np.float64) ** 2, axis=1)))))
    problems = []
    ids = np.asarray(ids, np.int64)
    d2 = np.asarray(d2, np.float64)
    q64 = np.asarray(q, np.float64)
    for b in range(q64.shape[0]):
        served_true = np.sum((np.asarray(x[ids[b]], np.float64) - q64[b]) ** 2, axis=1)
        bad_score = np.abs(d2[b] - served_true) > tol
        if bad_score.any():
            problems.append(f"{label} q{b}: score off by {np.abs(d2[b] - served_true).max():.3e} > {tol:.3e}")
        for j in np.nonzero(ids[b] != ref_i[b])[0]:
            gap = abs(served_true[j] - ref_d[b, j])
            if gap > tol:
                problems.append(
                    f"{label} q{b} rank {j}: id {ids[b, j]} vs reference "
                    f"{ref_i[b, j]} (float64 gap {gap:.3e} > {tol:.3e})")
    n_tie = int(np.sum(ids != ref_i))
    print(f"# check {label}: {q64.shape[0]} queries x k={k}, "
          f"id mismatches inside the tie tolerance {n_tie}, tolerance "
          f"{tol:.3e} on d^2, problems {len(problems)}", flush=True)
    return problems


def sample_queries(x, n_near, n_rand, d, rng):
    """Perturbed corpus rows (their top-1 is the row itself) plus
    random unit vectors, drawn from the NumPy generator ``rng``."""
    rows = rng.choice(x.shape[0], n_near, replace=False)
    near = np.asarray(x[rows], np.float32) + (
        0.02 / np.sqrt(d)) * rng.standard_normal((n_near, d), np.float32)
    rand = rng.standard_normal((n_rand, d)).astype(np.float32)
    q = np.concatenate([near, rand])
    return q / np.linalg.norm(q, axis=1, keepdims=True), rows


# ------------------------------------------------------------------- phases


def gpu_banner():
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def build_engine(rows, d, seed):
    """The engine ``qrag-serve`` builds with no ``--index`` (config
    from ``QragConfig().with_env_overrides()``), filled through
    ``index.add`` with a corpus made on the device by bench.py's
    generator.  Returns (engine, host copy of the rows)."""
    import jax.numpy as jnp

    from bench import make_corpus
    from qrag_tpu.config import QragConfig
    from qrag_tpu.engine import QragEngine

    config = QragConfig().with_env_overrides()
    engine = QragEngine(config=config)
    t0 = time.perf_counter()
    engine.index.add(np.asarray(make_corpus(rows, d, jnp.float32, seed=seed)))
    engine.index.device_buffers()
    print(f"# corpus {rows}x{d} made on device, loaded and uploaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # the rows as the index holds them (add() renormalizes in f32)
    return engine, engine.index.sample_rows(np.arange(rows))


class Client:
    def __init__(self, port):
        self.base = f"http://127.0.0.1:{port}"

    def post(self, path, body):
        req = urllib.request.Request(
            self.base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=600) as r:
            out = json.loads(r.read())
        if isinstance(out, dict) and "error" in out:
            raise RuntimeError(f"{path}: {out['error']}")
        return out

    def get(self, path):
        with urllib.request.urlopen(self.base + path, timeout=600) as r:
            return json.loads(r.read())


def hits_of(resp):
    ids = np.array([[h["index"] for h in r] for r in resp["results"]])
    scores = np.array([[h["score"] for h in r] for r in resp["results"]])
    return ids, scores


def phase_search(client, x, q, seed):
    """/search at k=10 and k=100, single requests and a concurrent
    burst the batcher coalesces; returns the problems found."""
    problems = []
    for k in (10, 100):
        t0 = time.perf_counter()
        ids, d2 = hits_of(client.post("/search", {"vectors": q[:1].tolist(), "k": k}))
        t1 = time.perf_counter()
        ids2, _ = hits_of(client.post("/search", {"vectors": q[:1].tolist(), "k": k}))
        t2 = time.perf_counter()
        print(f"# /search k={k} single query: first call {t1 - t0:.3f} s, "
              f"second {t2 - t1:.3f} s", flush=True)
        problems += check_topk(x, q[:1], ids, d2, k, f"/search k={k} single")
        results = [None] * q.shape[0]

        def one(i, k=k):
            results[i] = hits_of(client.post("/search", {"vectors": q[i:i + 1].tolist(), "k": k}))

        threads = [threading.Thread(target=one, args=(i,)) for i in range(q.shape[0])]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        print(f"# /search k={k} burst of {q.shape[0]} concurrent requests: "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        if any(r is None for r in results):
            problems.append(f"/search k={k} burst: a request did not finish")
            continue
        ids = np.concatenate([r[0] for r in results])
        d2 = np.concatenate([r[1] for r in results])
        problems += check_topk(x, q, ids, d2, k, f"/search k={k} burst")
    return problems


def phase_search_rerank(client, x, q, n_qubits):
    """/search_rerank, k=10 of 100 candidates: the quantum route's
    fidelities against the complex128 oracle, the classical route's
    retrieval ids against the float64 reference."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from oracle_qiskit import oracle_fidelity

    problems = []
    body = {"vectors": q[:2].tolist(), "k": 10, "candidates": 100}
    quantum = client.post("/search_rerank", {**body, "reranker_type": "quantum"})
    err = 0.0
    for b, hits in enumerate(quantum["results"]):
        for h in hits:
            want = oracle_fidelity(q[b], x[h["index"]], n_qubits)
            err = max(err, abs(h["score"] - want))
    # f32 features: each of the n_qubits per-qubit overlap factors
    # carries a few roundings (cos, sin, products) of 2^-24 each
    tol = 1e-5
    print(f"# /search_rerank quantum ({n_qubits} qubits): max |fidelity - "
          f"complex128 oracle| {err:.3e} (tolerance {tol:.0e})", flush=True)
    if not err <= tol:
        problems.append(f"/search_rerank quantum: fidelity error {err:.3e} > {tol:.0e}")
    # every returned hit must come from the exact top-100 candidates
    # (a row tied with the 100th within the f32 tolerance counts)
    ref_d, _ = reference_topk(x, q[:2], 100)
    tol_d2 = d2_tolerance(x.shape[1])
    classical = client.post("/search_rerank", {**body, "reranker_type": "classical"})
    print(f"# /search_rerank classical: reranker_used="
          f"{classical['reranker_used']}, {len(classical['results'][0])} hits", flush=True)
    for route, resp in (("quantum", quantum), ("classical", classical)):
        for b, hits in enumerate(resp["results"]):
            ids = [h["index"] for h in hits]
            true = np.sum((np.asarray(x[ids], np.float64) - q[b]) ** 2, axis=1)
            if len(hits) != 10 or np.any(true > ref_d[b, 99] + tol_d2):
                problems.append(f"/search_rerank {route} q{b}: hits outside the exact top-100")
    return problems


RERANK_QUERY = "advertisement segments in the broadcast"
RERANK_DOCS = [
    "The show cut to an advertisement segment before the interview.",
    "A long discussion of monetary policy and interest rates.",
    "Sponsors bought two advertisement slots in the evening broadcast.",
    "The weather forecast predicts rain over the weekend.",
    "Commercial breaks were shortened during the live broadcast.",
    "A recipe for bread with flour, water, salt and yeast.",
]


def phase_rerank(client, config):
    """/rerank with a reference-shaped body on the classical route
    (the shipped cross-encoder), against the same forward pass in
    float32 at HIGHEST precision."""
    import dataclasses

    import jax

    from qrag_tpu.models.cross_encoder import CrossEncoderScorer, _load_scorer_config

    body = {
        "query": RERANK_QUERY,
        "documents": [{"content": c, "source": f"doc{i}"} for i, c in enumerate(RERANK_DOCS)],
        "reranker_type": "classical",
        "top_k": len(RERANK_DOCS),
    }
    resp = client.post("/rerank", body)
    served = {d["document"]["content"]: d["score"] for d in resp["documents"]}
    cache = os.path.join(config.classical.model_cache_dir,
                         config.classical.model_name.replace("/", "_"))
    cfg = _load_scorer_config(cache)
    ref = CrossEncoderScorer(dataclasses.replace(cfg, dtype=jax.numpy.float32))
    ref.load(cache)
    with jax.default_matmul_precision("highest"):
        want = ref.score(RERANK_QUERY, RERANK_DOCS)
    err = max(abs(served[c] - float(w)) for c, w in zip(RERANK_DOCS, want))
    # bf16 activations keep 8 significant bits (relative 2^-8); through
    # two layers and the x20 interaction temperature a logit moves by
    # up to ~0.2, and the sigmoid's slope is at most 1/4
    tol = 0.05
    print(f"# /rerank cross-encoder (reranker_used={resp['reranker_used']}): "
          f"max |score - f32 HIGHEST forward| {err:.3e} (tolerance {tol})", flush=True)
    return [] if err <= tol else [f"/rerank cross-encoder: score error {err:.3e} > {tol}"]


def phase_headline(engine, x, seed, batch=1024):
    """One direct index search at B=1024, k=10, checked on a sample of
    32 queries; prints the certificate counters and the scan route."""
    import jax.numpy as jnp

    from qrag_tpu.platform import scan_route

    d = x.shape[1]
    q, _ = sample_queries(x, batch // 2, batch // 2, d, np.random.default_rng(seed + 8))
    snap, (scan, _, _) = engine.index._bounded_buffers()
    route = scan_route(*scan.shape, scan.dtype)
    t0 = time.perf_counter()
    res = engine.index.search(q, k=10)
    t1 = time.perf_counter()
    res = engine.index.search(q, k=10)
    t2 = time.perf_counter()
    vals, idx, fell_back, n_patched, escalated = engine.index._bounded_search(
        jnp.asarray(q), 10)
    print(f"# headline index.search B={batch} k=10: scan route {route} "
          f"({scan.shape[0]}x{scan.shape[1]} {scan.dtype}), first call "
          f"{t1 - t0:.3f} s, second {t2 - t1:.4f} s", flush=True)
    print(f"# certificate counters B={batch} k=10: fell_back={bool(fell_back)} "
          f"escalated={bool(escalated)} patched_rows={int(n_patched)}", flush=True)
    sel = np.r_[0:16, batch // 2:batch // 2 + 16]
    problems = check_topk(x, q[sel], res.indices[sel], res.scores[sel], 10, f"headline B={batch}")
    if bool(fell_back):
        problems.append(f"headline B={batch}: the certificate fell back to the full sort")
    return problems


def phase_kernels(engine, interpret=False):
    """Every kernel of the bounded path as compiled for the card, next
    to its XLA twin at the engine's width: the planes must agree to
    within the accumulation term of the certificate margin, and the
    bounded search must return the same ids and scores either way."""
    import jax
    import jax.numpy as jnp

    from qrag_tpu.ops import bounded_topk as bt
    from qrag_tpu.ops.pallas.fused_scan import packed_window_scan_kernel
    from qrag_tpu.ops.window_scan import packed_window_scan

    snap, (scan, mx, lr) = engine.index._bounded_buffers()
    n, d = scan.shape
    b = 1024 if n >= 1 << 20 else 64
    q = jax.random.normal(jax.random.PRNGKey(3), (b, d), jnp.float32)
    q = q / jnp.linalg.norm(q, axis=1, keepdims=True)
    qsq = jnp.sum(q * q, axis=1, keepdims=True)
    row_add = (-snap.sqnorms + jnp.where(snap.valid, 0.0, -jnp.inf))[None, :]
    qs = q.astype(scan.dtype)
    twins = {
        1: lambda: (packed_window_scan(qs, scan, lr, row_add, -qsq, 2.0),),
        2: lambda: bt.packed_window_scan_top2(qs, scan, lr, row_add, -qsq, 2.0),
        3: lambda: bt.packed_window_scan_top3(qs, scan, lr, row_add, -qsq, 2.0),
    }
    # alpha * accumulation term * |q| * maxnorm, plus the l2 epilogue's
    # absolute rounding term (window_bounds_bf16's margin without the
    # input-rounding terms, which both sides share)
    acc = (2.0 * (max(d, 768) / 768.0 * bt._EPS_ACC) * mx[None, :]
           + 5e-7 * (1.0 + mx[None, :] ** 2))
    problems = []
    for planes, twin in twins.items():
        t0 = time.perf_counter()
        got = jax.block_until_ready(packed_window_scan_kernel(
            qs, scan, row_add, -qsq, alpha=2.0, planes=planes, interpret=interpret))
        ct = time.perf_counter() - t0
        want = twin()
        worst = -np.inf
        for g, w in zip(got, want):
            lo_g, hi_g = bt.plane_value_bounds(g)
            lo_w, hi_w = bt.plane_value_bounds(w)
            live = jnp.isfinite(lo_w) & jnp.isfinite(lo_g)
            gap = jnp.where(live, jnp.abs(lo_g - lo_w) - (hi_w - lo_w) - acc, -1.0)
            worst = max(worst, float(jnp.max(gap)))
            if bool(jnp.any(jnp.isfinite(lo_g) != jnp.isfinite(lo_w))):
                problems.append(f"kernel planes={planes}: masked entries differ")
        print(f"# kernel packed_window_scan planes={planes} B={b} N={n} d={d}: "
              f"compile+run {ct:.1f} s; worst excess over the accumulation "
              f"margin {worst:.3e} (must be <= 0)", flush=True)
        if worst > 0:
            problems.append(f"kernel planes={planes}: plane values outside the margin")
    for k in (10, 100):
        outs = [bt.bounded_exact_topk(q, scan, snap.matrix, snap.sqnorms, mx, lr, k,
                                      metric="l2", valid_rows=snap.valid, backend=be,
                                      interpret=interpret and be == "triton")
                for be in ("xla", "triton")]
        same = bool(jnp.all(outs[0][1] == outs[1][1])) and bool(jnp.all(outs[0][0] == outs[1][0]))
        print(f"# bounded k={k} B={b}: kernel and XLA twin agree on ids and "
              f"scores: {same}", flush=True)
        if not same:
            problems.append(f"bounded k={k}: kernel and XLA twin disagree")
    return problems


def phase_first_call():
    """Cold and warm wall time of the first device call of a fresh
    graph (compile or persistent-cache load, then a cached call)."""
    import jax
    import jax.numpy as jnp

    from qrag_tpu.utils.compilation_cache import cache_dir, enable_compilation_cache

    on = enable_compilation_cache()
    n_files = len(os.listdir(cache_dir())) if os.path.isdir(cache_dir()) else 0
    f = jax.jit(lambda a: jnp.sort(a @ a.T, axis=1)[:, -10:].sum())
    x = jnp.ones((512, 768), jnp.float32)
    t0 = time.perf_counter()
    jax.block_until_ready(f(x))
    t1 = time.perf_counter()
    jax.block_until_ready(f(x))
    t2 = time.perf_counter()
    print(f"# first device call: cold {t1 - t0:.3f} s, warm {t2 - t1:.4f} s; "
          f"persistent cache {'on' if on else 'off'} at {cache_dir()} "
          f"({n_files} entries when this process started)", flush=True)


# --------------------------------------------------------------- four cards


def install_sharded(index, matrix, sqnorms, valid, ntotal):
    """Hand ``ShardedFlatIndex`` a corpus that already lives on its mesh.
    A 100M-row corpus is made on the cards: ``add`` would take it from
    the host, and a streaming append copies a shard (the update is not
    donated), which does not fit beside a 38 GB shard.  The public
    ingestion path runs in ``phase_sharded_ingest``."""
    index._dev_matrix, index._dev_sqnorms, index._dev_valid = matrix, sqnorms, valid
    index._dev_ntotal = index._ntotal = ntotal
    index._capacity = matrix.shape[0]
    index.metadata = [""] * ntotal
    index._dirty = index._needs_full = False
    index._pending = []


def make_sharded_corpus(mesh, rows, d, seed):
    """Unit-norm bf16 rows made shard by shard on the mesh's devices,
    with the squared norms of the stored bf16 rows."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from qrag_tpu.parallel.mesh import MODEL_AXIS

    mp = mesh.shape[MODEL_AXIS]
    chunk = 1 << min(16, max(7, (-(-rows // mp) - 1).bit_length()))
    cap = -(-rows // (mp * chunk)) * mp * chunk
    per = cap // mp

    @functools.partial(jax.jit, out_shardings=NamedSharding(mesh, P(MODEL_AXIS, None)))
    def gen():
        def shard(_):
            key = jax.random.fold_in(jax.random.PRNGKey(seed), jax.lax.axis_index(MODEL_AXIS))

            def one(k):
                x = jax.random.normal(k, (chunk, d), jnp.float32)
                return (x / jnp.linalg.norm(x, axis=1, keepdims=True)).astype(jnp.bfloat16)

            return jax.lax.map(one, jax.random.split(key, per // chunk)).reshape(per, d)

        return jax.shard_map(
            shard, mesh=mesh, in_specs=P(MODEL_AXIS), out_specs=P(MODEL_AXIS, None),
        )(jnp.zeros((mp,), jnp.int32))

    matrix = gen()
    # a separate graph that reads the stored rows, block by block:
    # inside the generating one, the GPU compiler may drop an
    # f32 -> bf16 -> f32 round trip as excess precision and give the
    # norms of the unrounded rows
    sqnorms = jax.jit(jax.shard_map(
        lambda m: jax.lax.map(
            lambda blk: jnp.sum(jnp.square(blk.astype(jnp.float32)), axis=1),
            m.reshape(-1, chunk, d)).reshape(-1),
        mesh=mesh, in_specs=P(MODEL_AXIS, None), out_specs=P(MODEL_AXIS)))(matrix)
    valid = jax.jit(lambda: jnp.arange(cap) < rows,
                    out_shardings=NamedSharding(mesh, P(MODEL_AXIS)))()
    return matrix, sqnorms, valid


def phase_sharded_ingest(rows, d, seed, batch=64):
    """``qrag-serve --sharded`` as it is configured by default (float32
    store, bounded mode, float32 queries), filled through the public
    ``add`` in two steps — the first builds the sharded store with
    headroom, the second appends into it on the cards — and searched
    with each merge against the float64 reference."""
    import dataclasses

    from qrag_tpu.config import QragConfig
    from qrag_tpu.engine import QragEngine

    rng = np.random.default_rng(seed + 11)
    vecs = rng.standard_normal((rows, d), np.float32)
    first = rows * 4 // 5
    base = QragConfig().with_env_overrides()
    problems, out = [], {}
    for merge in ("allgather", "ring"):
        config = dataclasses.replace(
            base, embedding=dataclasses.replace(base.embedding, dim=d),
            index=dataclasses.replace(base.index, sharded=True, shard_merge=merge))
        index = QragEngine(config=config).index
        t0 = time.perf_counter()
        index.add(vecs[:first])
        index.search(vecs[:1], k=1)  # builds the sharded store
        cap = index.layout()["rows_per_shard"]
        index.add(vecs[first:])
        x = index.sample_rows(np.arange(rows))  # the rows as the index holds them
        if merge == "allgather":
            q, near = sample_queries(x, batch // 2, batch - batch // 2, d, rng)
        t1 = time.perf_counter()
        res = index.search(q, k=10)  # appends the second part on the cards
        t2 = time.perf_counter()
        print(f"# ingest/{merge}: {first} + {rows - first} rows via add(), "
              f"{cap} -> {index.layout()['rows_per_shard']} rows per shard "
              f"({type(index).__name__}, {index.store_dtype.__name__} store, "
              f"topk_mode={index.topk_mode}, queries {index.bounded_query_dtype}); "
              f"build {t1 - t0:.1f} s, first search {t2 - t1:.2f} s; "
              f"fallback_rows={index.fallback_rows} escalations={index.bounded_escalations}",
              flush=True)
        out[merge] = res
        problems += check_topk(x, q, res.indices, res.scores, 10, f"ingest/{merge}")
        hit1 = float(np.mean(res.indices[:batch // 2, 0] == near))
        if hit1 != 1.0:
            problems.append(f"ingest/{merge}: perturbed rows found at rank 0: {hit1:.3f}")
        del index
    a, r = out["allgather"], out["ring"]
    if not (np.array_equal(a.indices, r.indices) and np.array_equal(a.scores, r.scores)):
        problems.append("ingest: allgather and ring merges disagree")
    return problems


def phase_four_cards(rows, d, seed, batch=64, n_check=16):
    """Row-sharded search over every card of the host, on a bf16 corpus
    made on the mesh: bounded mode with float32 queries (the default)
    and with store-dtype queries, each with the allgather and the ring
    merge, and the sharded exact sort.  ``n_check`` sampled queries of
    each kind are checked against a float64 top-k over every row."""
    import jax

    from qrag_tpu.parallel.mesh import make_mesh
    from qrag_tpu.parallel.sharded_index import ShardedFlatIndex

    mesh = make_mesh()
    t0 = time.perf_counter()
    matrix, sqnorms, valid = make_sharded_corpus(mesh, rows, d, seed)
    jax.block_until_ready(matrix)
    print(f"# four-card corpus {rows}x{d} bf16 made on the mesh "
          f"{dict(mesh.shape)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for s in matrix.addressable_shards:
        lo = s.index[0].start or 0
        print(f"# shard rows {lo}:{lo + s.data.shape[0]} on {s.device}", flush=True)
    x = MeshRows(matrix, rows)
    q, near = sample_queries(x, batch // 2, batch - batch // 2, d,
                             np.random.default_rng(seed))
    out = {}
    for name, kw in (
            ("bounded/allgather/f32", dict(topk_mode="bounded", merge="allgather")),
            ("bounded/ring/f32", dict(topk_mode="bounded", merge="ring")),
            ("bounded/allgather/store", dict(topk_mode="bounded", merge="allgather",
                                             bounded_query_dtype="store")),
            ("bounded/ring/store", dict(topk_mode="bounded", merge="ring",
                                        bounded_query_dtype="store")),
            ("exact/allgather", dict(topk_mode="exact", merge="allgather"))):
        index = ShardedFlatIndex(d=d, mesh=mesh, store_dtype="bfloat16",
                                 keep_host_master=False, **kw)
        install_sharded(index, matrix, sqnorms, valid, rows)
        t0 = time.perf_counter()
        res = index.search(q, k=10)
        t1 = time.perf_counter()
        index.search(q, k=10)
        print(f"# {name}: first call {t1 - t0:.2f} s, second "
              f"{time.perf_counter() - t1:.3f} s (B={batch}, k=10); "
              f"fallback_rows={index.fallback_rows} "
              f"escalations={index.bounded_escalations}", flush=True)
        out[name] = res
    problems = []
    for a, b in (("bounded/allgather/f32", "bounded/ring/f32"),
                 ("bounded/allgather/store", "bounded/ring/store")):
        same = (np.array_equal(out[a].indices, out[b].indices)
                and np.array_equal(out[a].scores, out[b].scores))
        print(f"# {a} == {b}: {same}", flush=True)
        if not same:
            problems.append(f"four cards: {a} and {b} disagree")
    # the exact sort scores store-dtype (bf16) queries, as the bounded
    # runs with bounded_query_dtype="store" do
    ex, bs = out["exact/allgather"], out["bounded/allgather/store"]
    tol = d2_tolerance(d)
    mism = ex.indices != bs.indices
    print(f"# bounded/store vs exact: id mismatches {int(mism.sum())}, "
          f"max score difference {np.abs(ex.scores - bs.scores).max():.3e}", flush=True)
    if np.any(np.abs(ex.scores - bs.scores) > tol):
        problems.append("four cards: bounded/store and exact disagree beyond the f32 tolerance")
    h = min(n_check, batch) // 2
    sel = np.r_[0:h, batch // 2:batch // 2 + h]
    q_store = round_bf16(q)
    t0 = time.perf_counter()
    ref = mesh_reference_topk(x, np.concatenate([q[sel], q_store[sel]]), 10)
    print(f"# float64 reference over {rows} rows, on the cards, "
          f"{2 * len(sel)} queries: {time.perf_counter() - t0:.1f} s", flush=True)
    m = len(sel)
    refs = {"f32": (ref[0][:m], ref[1][:m]), "store": (ref[0][m:], ref[1][m:])}
    for name, res in out.items():
        kind = "f32" if name.endswith("f32") else "store"
        qs = q[sel] if kind == "f32" else q_store[sel]
        problems += check_topk(x, qs, res.indices[sel], res.scores[sel], 10,
                               f"four cards {name}", ref=refs[kind])
        hit1 = float(np.mean(res.indices[:batch // 2, 0] == near))
        if hit1 != 1.0:
            problems.append(f"four cards {name}: perturbed rows found at rank 0: {hit1:.3f}")
    return problems


# --------------------------------------------------------------------- main


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--four-cards", action="store_true",
                   help="run only the row-sharded path over four cards")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "qrag_tpu")):
        print("chip_smoke.py runs from the root of a qrag-tpu checkout "
              "(qrag_tpu/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    os.environ.setdefault("QRAG_EMBEDDING_DIM", "768")
    os.environ.setdefault("QRAG_QUANTUM_N_QUBITS", "10")
    os.environ.setdefault("QRAG_CLASSICAL_METHOD", "cross-encoder")
    os.environ.setdefault("QRAG_CLASSICAL_MODEL_CACHE_DIR", os.path.join(here, "artifacts"))
    os.environ.setdefault("QRAG_CLASSICAL_MODEL_NAME", "cross_encoder")

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {dev.platform!r} "
              f"({dev.device_kind})", file=sys.stderr)
        return 2
    print(f"# {gpu_banner()}", flush=True)
    print(f"# jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}", flush=True)
    d = 768
    problems = []
    if args.four_cards:
        if len(jax.devices()) < 4:
            print(f"--four-cards needs 4 cards, found {len(jax.devices())}", file=sys.stderr)
            return 2
        problems += phase_sharded_ingest(1_000_000, d, args.seed)
        problems += phase_four_cards(100_000_000, d, args.seed)
    else:
        from qrag_tpu.serving.http_app import serve_in_thread

        phase_first_call()
        engine, x = build_engine(1_000_000, d, args.seed)
        server = serve_in_thread(
            engine, port=0, batching=True,
            max_pairs=max(engine.config.serving.doc_buckets),
        )
        try:
            client = Client(server.server_address[1])
            q, _ = sample_queries(x, 16, 16, d, np.random.default_rng(args.seed + 1))
            problems += phase_search(client, x, q, args.seed)
            problems += phase_search_rerank(client, x, q, engine.config.quantum.n_qubits)
            problems += phase_rerank(client, engine.config)
            stats = client.get("/stats")
            print(f"# /stats index: {json.dumps(stats['index'])}", flush=True)
            problems += phase_headline(engine, x, args.seed)
            problems += phase_kernels(engine)
        finally:
            server.shutdown()
            server.server_close()
    for p in problems:
        print(f"# FAILED: {p}", flush=True)
    if problems:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
