"""Dynamic request batching for serving.

Concurrent HTTP requests each carry a handful of queries, but the
device scan amortizes with batch size (every query of a batch shares
one read of the corpus).  The
batcher aggregates queries from concurrent requests into one device
call: callers enqueue (vectors, k) and block on a future; a worker
drains the queue, pads the combined batch to a power-of-two bucket
(stable compiled shapes), runs ONE engine search, and scatters results
back.

max_wait_s bounds added latency (default 2 ms); max_batch bounds the
device batch — its default (64) matches the top of the warmed query
ladder (``ServingConfig.warmup_batch_buckets``), so coalesced batches
only ever hit shapes ``engine.warmup()`` already compiled.  Requests
with different k are served with max(k) and trimmed per caller.

Requests carry an integer ``priority`` (default 0): when the queue is
backlogged, higher-priority requests jump ahead; equal priorities stay
FIFO, and an idle queue serves everything immediately, so priorities
only matter under load.  Effective priority AGES with queue wait time
(+1 priority unit per ``priority_aging_s`` waited, applied at drain
time), so sustained high-priority traffic cannot starve
default-priority requests indefinitely (ADVICE r3): a priority-0
request outranks fresh priority-p arrivals after ~p*priority_aging_s
in the queue.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np

from qrag_tpu.utils.buckets import pow2_bucket


@dataclass
class _Pending:
    vectors: Optional[np.ndarray]  # (n, d); None for doc-list reranks
    k: int
    future: Future = field(default_factory=Future)
    params: tuple = ()  # extra grouping key (rerank candidates/type)
    payload: Any = None  # (query, documents, top_k) for doc-list reranks
    priority: int = 0  # higher serves first when the queue is backlogged


@functools.lru_cache(maxsize=None)
def _pair_fidelity_fn(n_qubits: int, analytic: bool, encoding: str):
    """One jitted PAIR-flattened fidelity graph per config — the
    device op that coalesces concurrent /rerank requests.

    Signature: ``(P, dim) query rows x (P, dim) doc rows -> (P,)``.
    Coalesced requests flatten their (query, doc) pairs into ONE
    padded pair axis, so the compiled-shape set is a single pow2
    ladder over P — independent of how many requests coalesced (R)
    and of each request's doc count.  (The earlier (R, D)-shaped form
    compiled a fresh graph per R x doc-bucket combination, which
    warmup could not enumerate.)"""
    import jax

    if encoding == "amplitude":
        from qrag_tpu.ops.statevector import amplitude_fidelity

        def one(q, d):
            return amplitude_fidelity(q, d[None], n_qubits)[0]
    else:
        from qrag_tpu.ops.statevector import batched_fidelity

        def one(q, d):
            return batched_fidelity(
                q, d[None], n_qubits=n_qubits, analytic=analytic
            )[0]

    return jax.jit(jax.vmap(one))


class SearchBatcher:
    """Aggregates concurrent search calls into single device batches.

    Plain searches batch freely (k differences are served with max(k)
    and trimmed); fused search+rerank requests batch among requests
    with identical (k, candidates, reranker_type)."""

    def __init__(
        self,
        engine,
        max_wait_s: float = 0.002,
        max_batch: int = 64,
        bucket_floor: int = 8,
        max_pairs: int = 512,
        priority_aging_s: float = 0.25,
    ):
        self.engine = engine
        self.max_wait_s = max_wait_s
        self.max_batch = max_batch
        self.bucket_floor = bucket_floor
        # cap on the COALESCED doc-rerank pair axis: must equal
        # max(ServingConfig.doc_buckets) so coalescing never produces a
        # pair bucket engine.warmup() didn't compile (ADVICE r3) —
        # oversized groups split into multiple device calls instead
        self.max_pairs = max_pairs
        # +1 effective priority per this many seconds of queue wait
        self.priority_aging_s = max(priority_aging_s, 1e-6)
        # pending list drained by effective (aged) priority at drain
        # time; equal effective priorities stay FIFO via seq
        self._items: List[Tuple[int, int, float, _Pending]] = []
        self._cv = threading.Condition()
        self._seq = itertools.count()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self.batches = 0
        self.batched_queries = 0
        self.prioritized_served = 0  # requests served with priority > 0

    # ------------------------------------------------------------- client

    def _submit(self, item: _Pending):
        with self._cv:
            # the closed check must live INSIDE the critical section: a
            # submitter that passed an outside check while close() was
            # draining _items could append afterward and block forever
            # on a future nobody will resolve (ADVICE r4)
            if self._stop.is_set():
                raise RuntimeError("batcher is closed")
            self._items.append(
                (int(item.priority), next(self._seq), time.time(), item)
            )
            self._cv.notify()
        return item.future.result()

    def search(self, vectors: np.ndarray, k: int = 10, priority: int = 0):
        """Blocking search through the batcher; returns SearchResult."""
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        return self._submit(
            _Pending(vectors=vectors, k=k, priority=priority)
        )

    def search_rerank(
        self,
        vectors: np.ndarray,
        k: int = 10,
        candidates: int = 100,
        reranker_type: str = "quantum",
        priority: int = 0,
    ) -> dict:
        """Blocking fused search+rerank through the batcher; returns
        the engine's result dict for THESE vectors only."""
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        return self._submit(
            _Pending(
                vectors=vectors,
                k=k,
                params=("rerank", k, candidates, reranker_type),
                priority=priority,
            )
        )

    def rerank_documents(
        self,
        query: str,
        documents: list,
        top_k: Optional[int] = None,
        reranker_type: str = "auto",
        priority: int = 0,
    ) -> dict:
        """Blocking document-list rerank (the reference's POST /rerank
        hot path, ``classical.py:281-284``) through the batcher.

        Routing resolves on the host first (the controller truth
        table), then requests group by expert: quantum groups flatten
        all their (query, doc) pairs into ONE pair-bucketed device
        fidelity call; classical requests keep the single-request path (its
        score cache + neutral-degradation semantics are per-request
        state, and its scorer already mini-batches pairs).
        Returns the controller-shaped result dict."""
        expert = (
            self.engine.controller.select_reranker(query)
            if reranker_type == "auto"
            else reranker_type
        )
        return self._submit(
            _Pending(
                vectors=None,
                k=top_k if top_k is not None else -1,
                params=("docrr", expert),
                payload=(query, documents, top_k),
                priority=priority,
            )
        )

    def close(self) -> None:
        """Stop the worker and FAIL any still-pending requests so no
        caller blocks forever on a dead queue."""
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        self._worker.join(timeout=5)
        with self._cv:
            pending, self._items = self._items, []
        for _, _, _, item in pending:
            if not item.future.done():
                item.future.set_exception(RuntimeError("batcher closed"))

    def stats(self) -> dict:
        return {
            "batches": self.batches,
            "batched_queries": self.batched_queries,
            "mean_batch": (
                round(self.batched_queries / self.batches, 2)
                if self.batches
                else 0.0
            ),
            "prioritized_served": self.prioritized_served,
        }

    # ------------------------------------------------------------- worker

    def _pop_best_locked(self) -> _Pending:
        """Pop the pending item with the highest EFFECTIVE priority
        (nominal + age/priority_aging_s), FIFO within ties.  Aging is
        applied at drain time, so a long-waiting priority-0 request
        eventually outranks a stream of fresh high-priority arrivals
        (no starvation).  Caller holds the cv lock."""
        now = time.time()
        best = min(
            range(len(self._items)),
            key=lambda i: (
                -(
                    self._items[i][0]
                    + (now - self._items[i][2]) / self.priority_aging_s
                ),
                self._items[i][1],
            ),
        )
        return self._items.pop(best)[3]

    def _drain(self) -> List[_Pending]:
        def size(it: _Pending) -> int:
            if it.vectors is not None:
                return it.vectors.shape[0]
            return max(1, len(it.payload[1]))  # doc-list rerank

        with self._cv:
            if not self._items:
                self._cv.wait(timeout=0.05)
            if not self._items:
                return []
            items = [self._pop_best_locked()]
        total = size(items[0])
        deadline = time.time() + self.max_wait_s
        while total < self.max_batch:
            remaining = deadline - time.time()
            if remaining <= 0:
                break
            with self._cv:
                if not self._items and not self._cv.wait(timeout=remaining):
                    break
                if not self._items:
                    continue
                nxt = self._pop_best_locked()
            items.append(nxt)
            total += size(nxt)
        self.prioritized_served += sum(1 for it in items if it.priority > 0)
        return items

    def _run(self) -> None:
        while not self._stop.is_set():
            items = self._drain()
            if not items:
                continue
            # group by extra params: only identical-parameter requests
            # share a device batch
            groups: dict = {}
            for it in items:
                groups.setdefault(it.params, []).append(it)
            for group in groups.values():
                try:
                    self._serve(group)
                except Exception as e:  # noqa: BLE001 - per-request
                    for it in group:
                        if not it.future.done():
                            it.future.set_exception(e)

    def _serve(self, items: List[_Pending]) -> None:
        if items[0].params and items[0].params[0] == "docrr":
            self._serve_doc_rerank(items)
            return
        if items[0].params and items[0].params[0] == "rerank":
            self._serve_rerank(items)
            return
        vecs = np.concatenate([it.vectors for it in items], axis=0)
        k = max(it.k for it in items)
        b = vecs.shape[0]
        # pad to a power-of-two bucket → few compiled shapes
        bucket = pow2_bucket(b, self.bucket_floor)
        if bucket != b:
            # edge-repeat, not zeros: results beyond b are discarded
            # either way, but an all-zero padding query is equidistant
            # from the whole corpus and would fail the clustered
            # accelerator's certificate, dragging the real requests
            # into its fallback.  An EMPTY batch has no edge to
            # repeat (np.pad mode="edge" rejects it) — zeros are fine
            # there, nothing real shares the batch.
            mode = "edge" if b else "constant"
            vecs = np.pad(vecs, ((0, bucket - b), (0, 0)), mode=mode)
        res = self.engine.search(vecs, k=k)
        self.batches += 1
        self.batched_queries += b
        off = 0
        for it in items:
            n = it.vectors.shape[0]
            sl = slice(off, off + n)
            from qrag_tpu.index.flat_index import SearchResult

            it.future.set_result(
                SearchResult(
                    scores=res.scores[sl][:, : it.k],
                    indices=res.indices[sl][:, : it.k],
                    metadata=[row[: it.k] for row in res.metadata[sl]],
                )
            )
            off += n

    def _serve_doc_rerank(self, items: List[_Pending]) -> None:
        _, expert = items[0].params
        if expert != "quantum":
            # classical: per-request path (cache/neutral semantics);
            # the scorer itself mini-batches pairs (classical.py:281)
            for it in items:
                query, documents, top_k = it.payload
                out = self.engine.controller.rerank(
                    query, documents, top_k, reranker_type=expert
                )
                it.future.set_result(out)
            return
        qr = self.engine.controller.quantum_reranker
        from qrag_tpu.documents import validate_documents

        # requests that fail validation (or empty) keep the fallback
        # contract via the single-request path
        coalesced: List[_Pending] = []
        for it in items:
            query, documents, top_k = it.payload
            if (
                not documents
                or not validate_documents(query, documents)
                or qr.config.method != "state_fidelity"
            ):
                out = self.engine.controller.rerank(
                    query, documents, top_k, reranker_type="quantum"
                )
                it.future.set_result(out)
            else:
                coalesced.append(it)
        if not coalesced:
            return
        # cap each device call's pair axis at max_pairs (the top of
        # the warmed pair-bucket ladder): unbounded coalescing could
        # push pow2_bucket past every warmed shape and pay a surprise
        # multi-second compile under load (ADVICE r3).  A single
        # request with more than max_pairs docs still runs alone —
        # that's client-driven, like an oversized query batch.
        chunks: List[List[_Pending]] = [[]]
        pairs = 0
        for it in coalesced:
            nd = len(it.payload[1])
            if chunks[-1] and pairs + nd > self.max_pairs:
                chunks.append([])
                pairs = 0
            chunks[-1].append(it)
            pairs += nd
        for chunk in chunks:
            self._serve_doc_rerank_chunk(chunk)

    def _serve_doc_rerank_chunk(self, coalesced: List[_Pending]) -> None:
        qr = self.engine.controller.quantum_reranker
        try:
            # ONE embedder call + ONE device fidelity call for the
            # whole group: every (query, doc) pair flattens onto a
            # single padded pair axis, so the compiled shape depends
            # only on pow2_bucket(total pairs) — not on R or on the
            # per-request doc counts
            texts: List[str] = []
            for it in coalesced:
                query, documents, _ = it.payload
                texts.append(query)
                texts.extend(d.content for d in documents)
            embeds = np.asarray(qr.embedder(texts), dtype=np.float32)
            dim = embeds.shape[1]
            npairs = sum(len(it.payload[1]) for it in coalesced)
            pbucket = pow2_bucket(npairs, self.bucket_floor)
            pair_q = np.zeros((pbucket, dim), np.float32)
            pair_d = np.zeros((pbucket, dim), np.float32)
            off = 0  # into embeds
            poff = 0  # into the pair axis
            spans = []
            for it in coalesced:
                _, documents, _ = it.payload
                nd = len(documents)
                pair_q[poff : poff + nd] = embeds[off]
                pair_d[poff : poff + nd] = embeds[off + 1 : off + 1 + nd]
                spans.append(slice(poff, poff + nd))
                off += 1 + nd
                poff += nd
            fid_fn = _pair_fidelity_fn(
                qr.n_qubits,
                bool(qr.config.use_analytic_fidelity),
                qr.config.encoding,
            )
            scores = np.asarray(fid_fn(pair_q, pair_d), dtype=np.float32)
            self.batches += 1
            self.batched_queries += len(coalesced)
            for ri, it in enumerate(coalesced):
                query, documents, top_k = it.payload
                scored = [
                    (doc, float(s))
                    for doc, s in zip(documents, scores[spans[ri]])
                ]
                reranked = sorted(scored, key=lambda x: x[1], reverse=True)
                if top_k is not None:
                    reranked = reranked[:top_k]
                it.future.set_result(
                    {
                        "documents": reranked,
                        "reranker_used": "quantum",
                        "query": query,
                    }
                )
        except Exception as e:  # noqa: BLE001 - per-request fallback
            for it in coalesced:
                if it.future.done():
                    continue
                query, documents, top_k = it.payload
                try:
                    it.future.set_result(
                        self.engine.controller.rerank(
                            query, documents, top_k, reranker_type="quantum"
                        )
                    )
                except Exception:  # noqa: BLE001
                    it.future.set_exception(e)

    def _serve_rerank(self, items: List[_Pending]) -> None:
        _, k, candidates, reranker_type = items[0].params
        vecs = np.concatenate([it.vectors for it in items], axis=0)
        b = vecs.shape[0]
        bucket = pow2_bucket(b, self.bucket_floor)
        if bucket != b:
            mode = "edge" if b else "constant"
            vecs = np.pad(vecs, ((0, bucket - b), (0, 0)), mode=mode)
        out = self.engine.search_rerank(
            vecs, k=k, candidates=candidates, reranker_type=reranker_type
        )
        self.batches += 1
        self.batched_queries += b
        results = out["results"]
        off = 0
        for it in items:
            n = it.vectors.shape[0]
            it.future.set_result(
                {
                    "queries": n,
                    "results": results[off : off + n],
                    "reranker_used": out["reranker_used"],
                }
            )
            off += n
