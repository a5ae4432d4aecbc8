"""HTTP serving layer — stdlib only.

The reference serves ``POST /rerank`` + ``GET /`` via FastAPI/uvicorn
with permissive CORS (``app.py:37-96``).  FastAPI isn't a dependency
here; this is a threaded stdlib HTTP server exposing the same surface
(same request/response shapes) plus the retrieval endpoints the
reference lacked:

  POST /rerank         — reference-shaped: {query, documents:[{id,
                         content, source?}], reranker_type?, top_k?}
                         (``app.py:23-33``); response
                         {documents: [{document, score}], reranker_used,
                         query} (explicit schema; SURVEY.md A.3)
  POST /search         — {query: str | queries: [str] | vectors: [[f]],
                         k?, stream?, priority?} → top-k over the HBM
                         index; ``stream: true`` returns chunked
                         NDJSON (hits in <=512-row spans per line +
                         a final {"done": true} line) for large k
  POST /search_rerank  — fused retrieval→quantum-rerank
  POST /add            — {texts: [str], metadata?: [str]} ingestion
  GET  /               — service info (mirrors ``app.py:81-92``)
  GET  /stats          — counters + latency histograms (SURVEY.md §5)

Errors return ``{"error": str}`` with HTTP 200 for handler-level
failures, matching the reference's behavior (``app.py:75-77`` returns
the error dict rather than a 4xx/5xx), and 400/404 for protocol-level
problems.
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from qrag_tpu.config import QragConfig
from qrag_tpu.documents import Document
from qrag_tpu.engine import QragEngine
from qrag_tpu.reranker.controller import rerank_response_dict
from qrag_tpu.utils.logging_util import configure_logging

logger = logging.getLogger(__name__)

SERVICE_INFO = {
    "message": "qrag_tpu retrieval + rerank API",
    "version": "0.1.0",
    "use_case": "Podcast advertisement detection",
    "endpoints": {
        "rerank": "POST /rerank - rerank documents (quantum/classical/auto)",
        "search": "POST /search - exact top-k over the HBM-resident index",
        "search_rerank": "POST /search_rerank - fused retrieval + quantum rerank",
        "add": "POST /add - embed + ingest texts",
        "stats": "GET /stats - metrics snapshot",
    },
}


def _make_handler(engine: QragEngine, batcher=None):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        # -- helpers ----------------------------------------------------

        def _send_json(self, payload: Dict[str, Any], status: int = 200) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            # permissive CORS, as the reference configures (app.py:44-50)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods", "*")
            self.send_header("Access-Control-Allow-Headers", "*")
            self.end_headers()
            self.wfile.write(body)

        def _read_json(self) -> Optional[Dict[str, Any]]:
            try:
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length) if length else b"{}"
                data = json.loads(raw)
                if not isinstance(data, dict):
                    raise ValueError("body must be a JSON object")
                return data
            except Exception as e:  # noqa: BLE001
                self._send_json({"error": f"invalid JSON body: {e}"}, 400)
                return None

        def log_message(self, fmt, *args):  # route to logging, not stderr
            logger.debug("%s %s", self.address_string(), fmt % args)

        # -- routes -----------------------------------------------------

        def do_OPTIONS(self):  # CORS preflight
            self.send_response(204)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods", "*")
            self.send_header("Access-Control-Allow-Headers", "*")
            self.send_header("Content-Length", "0")
            self.end_headers()

        def do_GET(self):
            if self.path == "/":
                self._send_json(SERVICE_INFO)
            elif self.path == "/docs":
                # JSON API description (the reference advertises
                # docs_url "/docs" via FastAPI's swagger; app.py:84)
                self._send_json(
                    {
                        "service": SERVICE_INFO["message"],
                        "endpoints": {
                            "POST /rerank": {
                                "body": {
                                    "query": "str",
                                    "documents": [
                                        {"id": "str", "content": "str",
                                         "source": "str?"}
                                    ],
                                    "reranker_type": "auto|quantum|classical",
                                    "top_k": "int?",
                                },
                            },
                            "POST /search": {
                                "body": {
                                    "query | queries | vectors": "...",
                                    "k": "int?",
                                    "stream": "bool? (chunked NDJSON)",
                                    "priority": "int? (-10..10)",
                                },
                            },
                            "POST /search_rerank": {
                                "body": {
                                    "query | queries | vectors": "...",
                                    "k": "int?",
                                    "candidates": "int?",
                                    "reranker_type": "quantum|classical|auto",
                                    "priority": "int? (-10..10)",
                                },
                            },
                            "POST /add": {
                                "body": {"texts": ["str"], "metadata": ["str?"]},
                            },
                            "GET /stats": {"query": "?recall=1"},
                        },
                    }
                )
            elif self.path.startswith("/stats"):
                stats = engine.stats()
                if batcher is not None:
                    stats["batcher"] = batcher.stats()
                if "recall" in self.path.partition("?")[2]:
                    # on-demand recall@10 self-check (perturbed
                    # self-queries; SURVEY.md §5 observability)
                    stats["sampled_recall_at_10"] = engine.sample_recall(k=10)
                self._send_json(stats)
            else:
                self._send_json({"error": f"not found: {self.path}"}, 404)

        def do_POST(self):
            body = self._read_json()
            if body is None:
                return
            try:
                if self.path == "/rerank":
                    self._send_json(self._handle_rerank(body))
                elif self.path == "/search" and body.get("stream"):
                    self._stream_search(body)
                elif self.path == "/search":
                    self._send_json(self._handle_search(body))
                elif self.path == "/search_rerank":
                    self._send_json(self._handle_search_rerank(body))
                elif self.path == "/add":
                    self._send_json(self._handle_add(body))
                else:
                    self._send_json({"error": f"not found: {self.path}"}, 404)
            except Exception as e:  # noqa: BLE001 - reference app.py:75-77
                logger.error("error during request: %s", e)
                self._send_json({"error": str(e)})

        # -- handlers ---------------------------------------------------

        def _handle_rerank(self, body: Dict[str, Any]) -> Dict[str, Any]:
            query = body.get("query")
            if not isinstance(query, str):
                return {"error": "query must be a string"}
            raw_docs = body.get("documents")
            if not isinstance(raw_docs, list):
                return {"error": "documents must be a list"}
            documents = [
                Document(
                    id=str(d.get("id", i)),
                    content=str(d.get("content", "")),
                    source=d.get("source"),
                )
                for i, d in enumerate(raw_docs)
            ]
            top_k = body.get("top_k", engine.config.serving.default_top_k)
            rtype = body.get("reranker_type", "auto")
            if batcher is not None:
                # coalesce concurrent document-list reranks into one
                # pair-flattened device fidelity call (grouped by
                # routed expert)
                result = batcher.rerank_documents(
                    query, documents, top_k=top_k, reranker_type=rtype,
                    priority=self._priority(body),
                )
                engine.metrics.incr("rerank_requests")
                engine.metrics.incr(f"rerank_{result['reranker_used']}")
            else:
                result = engine.rerank(
                    query=query,
                    documents=documents,
                    top_k=top_k,
                    reranker_type=rtype,
                )
            return rerank_response_dict(result)

        def _priority(self, body: Dict[str, Any]) -> int:
            """Request priority, clamped to the documented -10..10."""
            return max(-10, min(10, int(body.get("priority", 0))))

        def _search_result(self, body: Dict[str, Any]):
            """Shared /search resolution: parse queries, run through
            the batcher (with request priority) or the engine.
            Returns (SearchResult, None) or (None, error dict)."""
            import numpy as np

            k = int(body.get("k", 10))
            prio = self._priority(body)
            if "vectors" in body:
                queries = np.asarray(body["vectors"], dtype=np.float32)
            elif "queries" in body:
                queries = list(body["queries"])
            elif "query" in body:
                queries = [body["query"]]
            else:
                return None, {"error": "provide query, queries, or vectors"}
            if batcher is not None:
                # dynamic batching: coalesce concurrent requests into
                # one device call (embed text host-side first)
                vecs = (
                    engine.embedder([str(q) for q in queries])
                    if not isinstance(queries, np.ndarray)
                    else queries
                )
                res = batcher.search(vecs, k=k, priority=prio)
            else:
                res = engine.search(queries, k=k)
            return res, None

        def _stream_search(self, body: Dict[str, Any]) -> None:
            """``"stream": true`` — chunked NDJSON for LARGE k
            (ROADMAP serving item): each line is
            ``{"query": qi, "offset": j, "hits": [... <=512 ...]}``
            followed by a final ``{"done": true, "metric": ...}``
            line, so clients render results incrementally instead of
            buffering one giant JSON body."""
            res, err = self._search_result(body)
            if err is not None:
                self._send_json(err)
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(obj: Dict[str, Any]) -> None:
                line = (json.dumps(obj) + "\n").encode()
                self.wfile.write(f"{len(line):X}\r\n".encode())
                self.wfile.write(line + b"\r\n")
                self.wfile.flush()

            # once headers are out, failures must be handled IN-STREAM:
            # falling through to _send_json would write a second status
            # line into the middle of the chunked body (keep-alive
            # framing corruption); a broken pipe just drops the
            # connection
            try:
                span = 512
                for qi in range(res.indices.shape[0]):
                    hits = [
                        {"index": int(i), "score": float(s), "metadata": m}
                        for i, s, m in res.top(qi)
                    ]
                    for off in range(0, max(len(hits), 1), span):
                        chunk(
                            {
                                "query": qi,
                                "offset": off,
                                "hits": hits[off : off + span],
                            }
                        )
                chunk({"done": True, "metric": engine.index.metric})
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                logger.debug("stream client disconnected mid-response")
                self.close_connection = True
            except Exception as e:  # noqa: BLE001 - in-stream error line
                logger.error("error mid-stream: %s", e)
                try:
                    chunk({"error": str(e)})
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except Exception:  # noqa: BLE001
                    pass
                self.close_connection = True

        def _handle_search(self, body: Dict[str, Any]) -> Dict[str, Any]:
            res, err = self._search_result(body)
            if err is not None:
                return err
            return {
                "results": [
                    [
                        {"index": int(i), "score": float(s), "metadata": m}
                        for i, s, m in res.top(q)
                    ]
                    for q in range(res.indices.shape[0])
                ],
                "metric": engine.index.metric,
            }

        def _handle_search_rerank(self, body: Dict[str, Any]) -> Dict[str, Any]:
            import numpy as np

            if "vectors" in body:
                queries = np.asarray(body["vectors"], dtype=np.float32)
            elif "query" in body:
                queries = [body["query"]]
            elif "queries" in body:
                queries = list(body["queries"])
            else:
                return {"error": "provide query, queries, or vectors"}
            k = int(body.get("k", 10))
            candidates = int(body.get("candidates", 100))
            rtype = body.get("reranker_type", "quantum")
            if batcher is not None and rtype != "auto":
                vecs = (
                    engine.embedder([str(q) for q in queries])
                    if not isinstance(queries, np.ndarray)
                    else queries
                )
                return batcher.search_rerank(
                    vecs, k=k, candidates=candidates, reranker_type=rtype,
                    priority=self._priority(body),
                )
            return engine.search_rerank(
                queries, k=k, candidates=candidates, reranker_type=rtype
            )

        def _handle_add(self, body: Dict[str, Any]) -> Dict[str, Any]:
            texts = body.get("texts")
            if not isinstance(texts, list) or not texts:
                return {"error": "texts must be a non-empty list"}
            ntotal = engine.add_texts(
                [str(t) for t in texts], body.get("metadata")
            )
            return {"stored_count": len(texts), "total_vectors": ntotal}

    return Handler


def create_server(
    engine: QragEngine,
    host: str = "0.0.0.0",
    port: int = 8000,
    batching: bool = False,
    **batcher_kwargs,
) -> ThreadingHTTPServer:
    batcher = None
    if batching:
        from qrag_tpu.serving.batcher import SearchBatcher

        batcher = SearchBatcher(engine, **batcher_kwargs)
    return ThreadingHTTPServer((host, port), _make_handler(engine, batcher))


def serve_in_thread(
    engine: QragEngine,
    host: str = "127.0.0.1",
    port: int = 0,
    batching: bool = False,
    **batcher_kwargs,
) -> ThreadingHTTPServer:
    """Start serving on a background thread (tests / embedding)."""
    server = create_server(engine, host, port, batching=batching, **batcher_kwargs)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="qrag_tpu HTTP server")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--index", default=None, help=".faiss file or native dir")
    parser.add_argument(
        "--embedding-provider",
        default=None,
        choices=["mock", "hash", "openai", "trained"],
    )
    parser.add_argument("--no-warmup", action="store_true")
    parser.add_argument(
        "--reload",
        action="store_true",
        help="dev auto-reload: re-exec on source change (server.py:56-62 parity)",
    )
    parser.add_argument(
        "--batching",
        action="store_true",
        help="coalesce concurrent /search requests into device batches",
    )
    parser.add_argument(
        "--sharded",
        action="store_true",
        help="shard corpus rows over all devices (mesh from QRAG_MESH_* "
        "env / config; parallel/sharded_index.py)",
    )
    parser.add_argument(
        "--shard-merge",
        default=None,
        choices=["allgather", "ring"],
        help="per-shard top-k merge strategy (with --sharded)",
    )
    parser.add_argument(
        "--elastic",
        action="store_true",
        help="with --sharded: survive device loss by re-sharding over "
        "the remaining devices (parallel/elastic.py)",
    )
    parser.add_argument(
        "--lean-scan",
        action="store_true",
        help="memory-lean serving: int8 windowed packed scan with "
        "gather-free scoring (quantization=int8, quant_scan=window, "
        "exact_scores=False) — the (B, N) score matrix never exists "
        "and candidate rows are never gathered; returned scores are "
        "approximate (block-int8, ~1%%)",
    )
    parser.add_argument(
        "--topk-mode",
        default=None,
        choices=["exact", "approx", "verified", "refined", "bounded"],
        help="top-k selection mode (IndexConfig.topk_mode): 'bounded' "
        "= provably-exact norm-bounded window pruning "
        "(ops/bounded_topk.py; works single-device AND --sharded)",
    )
    parser.add_argument(
        "--bounded-scan",
        default=None,
        choices=["bf16", "int8"],
        help="with --topk-mode bounded: scan arithmetic — 'int8' runs "
        "the exact-integer int8 scan with margins "
        "covering the quantization residual (still provably exact)",
    )
    parser.add_argument(
        "--bounded-query-dtype",
        default=None,
        choices=["float32", "store"],
        help="with --topk-mode bounded: 'store' rounds queries to the "
        "store dtype first — exact w.r.t. the ROUNDED query (the "
        "fp16-store contract), narrow margins + lean budgets on a "
        "bf16 store.  Default float32 = exact w.r.t. the query as given",
    )
    parser.add_argument(
        "--small-batch-accel",
        default=None,
        choices=["none", "clustered", "clustered_probe"],
        help="small-batch latency accelerator: 'clustered' routes "
        "query batches <= IndexConfig.accel_max_batch through the "
        "cluster-pruned PROVABLY-EXACT path (ops/cluster_topk.py) — "
        "certified group reads instead of the full HBM scan; exact "
        "for every topk-mode; with --sharded each shard prunes its "
        "own structure and the candidates merge exactly.  "
        "'clustered_probe' = FAISS-IVF nprobe semantics (no "
        "certificates, recall via QRAG_INDEX_CLUSTER_BUDGET) — the "
        "explicit approximate opt-in",
    )
    args = parser.parse_args(argv)

    configure_logging()
    config = QragConfig().with_env_overrides()
    if args.small_batch_accel:
        from dataclasses import replace as _r

        config = _r(
            config,
            index=_r(
                config.index, small_batch_accel=args.small_batch_accel
            ),
        )
        import os as _os

        _os.environ["QRAG_INDEX_SMALL_BATCH_ACCEL"] = args.small_batch_accel
    if (args.shard_merge or args.elastic) and not args.sharded:
        parser.error("--shard-merge/--elastic require --sharded")
    if args.lean_scan and args.sharded:
        parser.error("--lean-scan is a single-device index mode")
    if args.topk_mode and args.lean_scan:
        parser.error("--lean-scan fixes its own scan mode")
    if args.bounded_scan and (args.topk_mode or config.index.topk_mode) != "bounded":
        parser.error("--bounded-scan requires --topk-mode bounded")
    if args.bounded_scan == "int8" and args.sharded:
        # ShardedFlatIndex has no int8 bounded arm: accepting the flag
        # would silently serve the bf16 scan while the operator
        # believes int8 is active (ADVICE r4)
        parser.error(
            "--bounded-scan int8 is not implemented for --sharded "
            "(the sharded bounded path scans bf16); drop one flag"
        )
    if args.bounded_query_dtype and (
        (args.topk_mode or config.index.topk_mode) != "bounded"
    ):
        parser.error("--bounded-query-dtype requires --topk-mode bounded")
    if args.topk_mode:
        from dataclasses import replace as _r

        config = _r(config, index=_r(config.index, topk_mode=args.topk_mode))
        import os as _os

        _os.environ["QRAG_INDEX_TOPK_MODE"] = args.topk_mode
    if args.bounded_scan:
        from dataclasses import replace as _r

        config = _r(
            config, index=_r(config.index, bounded_scan=args.bounded_scan)
        )
        import os as _os

        _os.environ["QRAG_INDEX_BOUNDED_SCAN"] = args.bounded_scan
    if args.bounded_query_dtype:
        from dataclasses import replace as _r

        config = _r(
            config,
            index=_r(
                config.index, bounded_query_dtype=args.bounded_query_dtype
            ),
        )
        import os as _os

        _os.environ["QRAG_INDEX_BOUNDED_QUERY_DTYPE"] = (
            args.bounded_query_dtype
        )
    if args.lean_scan:
        from dataclasses import replace as _r

        config = _r(
            config,
            index=_r(
                config.index,
                quantization="int8",
                quant_scan="window",
                exact_scores=False,
            ),
        )
        # propagate through the env channel so engine bundles
        # (QragEngine.load re-reads env overrides) pick it up too
        import os as _os

        _os.environ["QRAG_INDEX_QUANTIZATION"] = "int8"
        _os.environ["QRAG_INDEX_QUANT_SCAN"] = "window"
        _os.environ["QRAG_INDEX_EXACT_SCORES"] = "0"
    if args.sharded:
        from dataclasses import replace as _r

        config = _r(
            config,
            index=_r(
                config.index,
                sharded=True,
                elastic=args.elastic or config.index.elastic,
                shard_merge=args.shard_merge or config.index.shard_merge,
            ),
        )
        # bundles re-read config with env overrides (QragEngine.load),
        # so propagate the CLI choice through the env channel too
        import os as _os

        _os.environ["QRAG_INDEX_SHARDED"] = "1"
        _os.environ["QRAG_INDEX_SHARD_MERGE"] = config.index.shard_merge
        if config.index.elastic:
            _os.environ["QRAG_INDEX_ELASTIC"] = "1"
    if args.embedding_provider:
        from dataclasses import replace

        config = replace(
            config, embedding=replace(config.embedding, provider=args.embedding_provider)
        )
    host = args.host or config.serving.host
    port = args.port if args.port is not None else config.serving.port

    if args.index:
        import os

        if os.path.isdir(args.index):
            if os.path.exists(os.path.join(args.index, "engine.json")):
                engine = QragEngine.load(args.index)
                if args.embedding_provider:
                    # CLI override still applies on top of the bundle
                    from dataclasses import replace as _replace

                    from qrag_tpu.pipeline.embeddings import get_embedder

                    engine.embedder = get_embedder(
                        _replace(
                            engine.config.embedding,
                            provider=args.embedding_provider,
                        )
                    )
            else:
                if config.index.sharded:
                    from qrag_tpu.parallel.mesh import make_mesh
                    from qrag_tpu.parallel.sharded_index import (
                        ShardedFlatIndex,
                    )

                    # plumb the configured selection mode through —
                    # load_native otherwise keeps the constructor
                    # default and --topk-mode would be silently
                    # ignored on the --index path (ADVICE r3)
                    index = ShardedFlatIndex.load_native(
                        args.index,
                        mesh=make_mesh(config.mesh),
                        merge=config.index.shard_merge,
                        topk_mode=config.index.topk_mode,
                        bounded_query_dtype=(
                            config.index.bounded_query_dtype
                        ),
                        small_batch_accel=config.index.small_batch_accel,
                        accel_max_batch=config.index.accel_max_batch,
                        cluster_group_rows=config.index.cluster_group_rows,
                        cluster_budget=config.index.cluster_budget or None,
                        accel_read_cap=config.index.accel_read_cap,
                    )
                elif config.index.quantization == "int8":
                    from qrag_tpu.index.quantized_index import (
                        QuantizedFlatIndex,
                    )

                    if args.topk_mode:
                        parser.error(
                            "--topk-mode does not apply to the int8 "
                            "quantized index (its scan/refine modes "
                            "come from quant_scan/exact_scores)"
                        )
                    index = QuantizedFlatIndex.load_native(
                        args.index,
                        refine_factor=config.index.refine_factor,
                        scan=config.index.quant_scan,
                        exact_scores=config.index.exact_scores,
                    )
                else:
                    from qrag_tpu.index.flat_index import DeviceFlatIndex

                    index = DeviceFlatIndex.load_native(
                        args.index,
                        topk_mode=config.index.topk_mode,
                        bounded_scan=config.index.bounded_scan,
                        bounded_query_dtype=(
                            config.index.bounded_query_dtype
                        ),
                        small_batch_accel=config.index.small_batch_accel,
                        accel_max_batch=config.index.accel_max_batch,
                        cluster_group_rows=config.index.cluster_group_rows,
                        cluster_budget=config.index.cluster_budget or None,
                        accel_read_cap=config.index.accel_read_cap,
                    )
                engine = QragEngine(config=config, index=index)
        else:
            engine = QragEngine.from_faiss(args.index, config=config)
    else:
        engine = QragEngine(config=config)

    # Bind before warmup so clients can connect immediately; warmup
    # compiles the hot graphs concurrently (first queries that race it
    # simply compile on demand).
    server = create_server(
        engine,
        host,
        port,
        batching=args.batching,
        **(
            # keep the batcher's coalesced pair axis inside the warmed
            # doc-bucket ladder (ADVICE r3)
            {"max_pairs": max(config.serving.doc_buckets)}
            if args.batching
            else {}
        ),
    )
    if args.reload:
        from qrag_tpu.serving.devreload import start_reloader

        start_reloader()
    if not args.no_warmup:
        threading.Thread(target=engine.warmup, daemon=True).start()
    logger.info("serving on %s:%d (index ntotal=%d)", host, port, engine.index.ntotal)
    server.serve_forever()


if __name__ == "__main__":
    main()
