"""The four ingestion tools (reference: ``mcp/server/tools/*.py``).

Same tool names, input/output shapes and error contracts as the
reference's MCP tools, with JAX internals: embeddings come from
the pluggable provider (mock/hash/openai), the index store writes the
FAISS-compatible flat format via ``qrag_tpu.index.faiss_io`` (no
faiss-cpu), and transcripts come from a storage backend (local dir or
S3).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

from pydantic import BaseModel

from qrag_tpu.config import EmbeddingConfig
from qrag_tpu.index import faiss_io
from qrag_tpu.pipeline.chunker import chunk_text
from qrag_tpu.pipeline.embeddings import Embedder, get_embedder
from qrag_tpu.pipeline.storage import TranscriptStore, get_store
from qrag_tpu.tools.interface import BaseToolInput, Tool, ToolResponse
from qrag_tpu.tools.progress import nested_progress, report_progress

logger = logging.getLogger(__name__)


# ------------------------------------------------------------ FetchEmbeddings


class FetchEmbeddingsInput(BaseToolInput):
    texts: List[str]
    model: Optional[str] = None


class FetchEmbeddingsOutput(BaseModel):
    embeddings: List[List[float]]
    count: int
    model: str
    dimension: int
    # input positions whose embedding failed entirely (skip-on-error);
    # callers must drop the corresponding labels to stay aligned
    skipped_indices: List[int] = []


class FetchEmbeddingsTool(Tool):
    """Embeds texts, chunking long ones (~8k tokens, sentence-boundary
    preference — ``fetch_embeddings.py:67-104``) and averaging chunk
    vectors; per-chunk failures are skipped (``:153-155``)."""

    name = "FetchEmbeddings"
    description = (
        "Fetches embeddings for a list of input texts using the "
        "configured provider. Automatically chunks long texts."
    )
    input_model = FetchEmbeddingsInput
    output_model = FetchEmbeddingsOutput

    def __init__(self, embedder: Optional[Embedder] = None,
                 config: Optional[EmbeddingConfig] = None):
        self.config = config or EmbeddingConfig(provider="hash")
        self.embedder = embedder or get_embedder(self.config)

    async def execute(self, input_data: FetchEmbeddingsInput) -> ToolResponse:
        if not input_data.texts:
            return ToolResponse.from_error("texts must be non-empty")
        import numpy as np

        out: List[List[float]] = []
        skipped: List[int] = []
        n_texts = len(input_data.texts)
        for pos, text in enumerate(input_data.texts):
            report_progress(pos, n_texts, f"embedding text {pos + 1}/{n_texts}")
            chunks = chunk_text(text, self.config.max_tokens_per_chunk)
            vecs = []
            for chunk in chunks:
                try:
                    vecs.append(self.embedder([chunk])[0])
                except Exception as e:  # noqa: BLE001 - skip-on-error
                    logger.warning("chunk embedding failed: %s", e)
                    continue
            if not vecs:
                skipped.append(pos)
                continue
            mean = np.mean(vecs, axis=0)
            n = np.linalg.norm(mean)
            out.append((mean / (n if n > 0 else 1.0)).tolist())
        if not out:
            return ToolResponse.from_error("all embeddings failed")
        return ToolResponse.from_model(
            FetchEmbeddingsOutput(
                embeddings=out,
                count=len(out),
                model=input_data.model or self.config.model,
                dimension=len(out[0]),
                skipped_indices=skipped,
            )
        )


# ---------------------------------------------------------------- ReadFromS3


class ReadFromS3Input(BaseToolInput):
    show_name: Optional[str] = None


class ReadFromS3Output(BaseModel):
    transcripts: List[Dict[str, Any]]
    count: int
    available_shows: List[str]


class ReadFromS3Tool(Tool):
    """Lists shows / reads one show's transcripts.

    Reference semantics (``read_from_s3.py:71-163``): without a
    show_name, returns the available shows; with an unknown show,
    errors and includes ``available_shows`` (the agent uses that for
    its retry loop).  The backend is pluggable: local directory by
    default, S3+SSM when configured.
    """

    name = "ReadFromS3"
    description = (
        "Reads podcast transcripts from storage. Call without show_name "
        "to list available shows."
    )
    input_model = ReadFromS3Input
    output_model = ReadFromS3Output

    def __init__(self, store: Optional[TranscriptStore] = None):
        self.store = store or get_store("local")

    async def execute(self, input_data: ReadFromS3Input) -> ToolResponse:
        shows = self.store.list_shows()
        if input_data.show_name is None:
            return ToolResponse.from_model(
                ReadFromS3Output(
                    transcripts=[], count=0, available_shows=shows
                )
            )
        if input_data.show_name not in shows:
            return ToolResponse.from_error(
                f"show {input_data.show_name!r} not found",
                available_shows=shows,
            )
        transcripts = self.store.read_show(input_data.show_name)
        return ToolResponse.from_model(
            ReadFromS3Output(
                transcripts=transcripts,
                count=len(transcripts),
                available_shows=shows,
            )
        )


# -------------------------------------------------------------- StoreInFaiss


class StoreInFaissInput(BaseToolInput):
    embeddings: List[List[float]]
    index_path: str
    metadata: Optional[List[str]] = None


class StoreInFaissOutput(BaseModel):
    stored_count: int
    total_vectors: int
    index_path: str
    dimension: int


class StoreInFaissTool(Tool):
    """Appends vectors to a FAISS-format flat-L2 file (open-or-create,
    ``store_in_faiss.py:102-109``) + metadata sidecar append
    (``:111-122``) — validating dimension compatibility, which the
    reference skipped (SURVEY.md Appendix A.6)."""

    name = "StoreInFaiss"
    description = (
        "Stores embeddings in a FAISS-compatible flat index file on "
        "disk, appending to an existing index when present."
    )
    input_model = StoreInFaissInput
    output_model = StoreInFaissOutput

    async def execute(self, input_data: StoreInFaissInput) -> ToolResponse:
        import numpy as np

        if not input_data.embeddings:
            return ToolResponse.from_error("embeddings must be non-empty")
        vectors = np.asarray(input_data.embeddings, dtype=np.float32)
        if vectors.ndim != 2:
            return ToolResponse.from_error(
                f"embeddings must be a 2D list, got shape {vectors.shape}"
            )
        if input_data.metadata is not None and len(input_data.metadata) != len(
            vectors
        ):
            return ToolResponse.from_error(
                f"metadata length {len(input_data.metadata)} != "
                f"embeddings {len(vectors)}"
            )
        try:
            total = faiss_io.append_flat_index(
                input_data.index_path, vectors, metric="l2"
            )
        except ValueError as e:
            return ToolResponse.from_error(str(e))
        if input_data.metadata:
            faiss_io.append_metadata(input_data.index_path, input_data.metadata)
        return ToolResponse.from_model(
            StoreInFaissOutput(
                stored_count=len(vectors),
                total_vectors=total,
                index_path=input_data.index_path,
                dimension=vectors.shape[1],
            )
        )


# --------------------------------------------------------------- SearchIndex


class SearchIndexInput(BaseToolInput):
    index_path: str
    query: Optional[str] = None
    embedding: Optional[List[float]] = None
    k: int = 10
    rerank: bool = False  # quantum-fidelity rerank of the hits


class SearchIndexOutput(BaseModel):
    hits: List[Dict[str, Any]]
    count: int
    total_vectors: int
    reranked: bool


class SearchIndexTool(Tool):
    """Exact top-k retrieval over a stored index — the step the
    reference's "RAG" pipeline never had (no ``index.search`` call
    exists anywhere in it; SURVEY.md §0 gap 1).  Accepts a text query
    (embedded with the configured provider) or a raw embedding;
    optionally reranks the hits by quantum state fidelity."""

    name = "SearchIndex"
    description = (
        "Searches a stored flat index for the top-k nearest documents "
        "to a query (text or embedding), optionally reranking by "
        "quantum state fidelity."
    )
    input_model = SearchIndexInput
    output_model = SearchIndexOutput

    def __init__(self, embedder: Optional[Embedder] = None,
                 config: Optional[EmbeddingConfig] = None):
        self.config = config or EmbeddingConfig(provider="hash")
        self.embedder = embedder or get_embedder(self.config)
        self._engines: Dict[str, Any] = {}  # index_path -> engine cache

    def _engine_for(self, index_path: str):
        import os

        key = f"{index_path}:{os.path.getmtime(index_path)}"
        engine = self._engines.get(key)
        if engine is None:
            from qrag_tpu.engine import QragEngine

            engine = QragEngine.from_faiss(index_path)
            engine.embedder = self.embedder
            self._engines.clear()  # one cached engine (latest artifact)
            self._engines[key] = engine
        return engine

    async def execute(self, input_data: SearchIndexInput) -> ToolResponse:
        import os

        import numpy as np

        if not os.path.exists(input_data.index_path):
            return ToolResponse.from_error(
                f"index not found: {input_data.index_path}"
            )
        if input_data.query is None and input_data.embedding is None:
            return ToolResponse.from_error("provide query or embedding")
        try:
            engine = self._engine_for(input_data.index_path)
        except ValueError as e:
            return ToolResponse.from_error(str(e))
        if input_data.embedding is not None:
            qv = np.asarray(input_data.embedding, np.float32)[None, :]
            if qv.shape[1] != engine.index.d:
                return ToolResponse.from_error(
                    f"embedding dim {qv.shape[1]} != index d {engine.index.d}"
                )
            queries = qv
        else:
            queries = input_data.query
        k = max(1, min(input_data.k, engine.index.ntotal))
        if input_data.rerank:
            out = engine.search_rerank(
                queries, k=k, candidates=min(10 * k, engine.index.ntotal)
            )
            hits = out["results"][0]
        else:
            res = engine.search(queries, k=k)
            hits = [
                {"index": i, "score": s, "metadata": m}
                for i, s, m in res.top(0)
            ]
        return ToolResponse.from_model(
            SearchIndexOutput(
                hits=hits,
                count=len(hits),
                total_vectors=engine.index.ntotal,
                reranked=bool(input_data.rerank),
            )
        )


# --------------------------------------- ProcessTranscriptsToEmbeddings


class ProcessTranscriptsInput(BaseToolInput):
    show_name: str
    index_path: str
    max_transcripts: Optional[int] = None


class ProcessTranscriptsOutput(BaseModel):
    show_name: str
    transcripts_processed: int
    embeddings_created: int
    total_vectors: int
    index_path: str


def extract_texts(
    transcripts: List[Dict[str, Any]]
) -> Tuple[List[str], List[int]]:
    """Payload-shape tolerance of
    ``process_embeddings_index.py:137-165``: str, dict with
    text/transcript/content, or list of strings.

    Returns (texts, source_indices): source_indices[i] is the position
    in ``transcripts`` that texts[i] came from, so downstream metadata
    stays aligned when un-extractable entries are skipped.
    """
    texts: List[str] = []
    sources: List[int] = []
    for pos, t in enumerate(transcripts):
        data = t.get("data")
        text: Optional[str] = None
        if isinstance(data, str):
            text = data
        elif isinstance(data, dict):
            for key in ("text", "transcript", "content"):
                if isinstance(data.get(key), str):
                    text = data[key]
                    break
        elif isinstance(data, list) and all(isinstance(x, str) for x in data):
            text = "\n".join(data)
        if text is not None:
            texts.append(text)
            sources.append(pos)
    return texts, sources


class ProcessTranscriptsToEmbeddingsTool(Tool):
    """End-to-end pipeline: read → extract → embed → store
    (``process_embeddings_index.py:225-279``), including the
    case-insensitive show-name retry (``:214-223``).

    Metadata is written per-EMBEDDING as ``"{show}/{episode}"`` —
    aligned with how the bundled artifact actually is, fixing the
    reference's per-transcript/per-chunk mismatch (SURVEY.md A.4).
    """

    name = "ProcessTranscriptsToEmbeddings"
    description = (
        "Complete pipeline: reads a show's transcripts, creates "
        "embeddings, and stores them in a flat index with metadata."
    )
    input_model = ProcessTranscriptsInput
    output_model = ProcessTranscriptsOutput

    def __init__(
        self,
        store: Optional[TranscriptStore] = None,
        embedder: Optional[Embedder] = None,
        config: Optional[EmbeddingConfig] = None,
    ):
        self.reader = ReadFromS3Tool(store)
        self.embedder_tool = FetchEmbeddingsTool(embedder, config)

    async def execute(self, input_data: ProcessTranscriptsInput) -> ToolResponse:
        show = input_data.show_name
        report_progress(0, 3, f"reading transcripts for {show!r}")
        read = await self.reader.execute(ReadFromS3Input(show_name=show))
        if not read.success:
            # case-insensitive retry (process_embeddings_index.py:214-223)
            shows = (read.first_json() or {}).get("available_shows", [])
            match = next(
                (s for s in shows if s.lower() == show.lower()), None
            )
            if match is None:
                return ToolResponse.from_error(
                    f"show {show!r} not found", available_shows=shows
                )
            show = match
            read = await self.reader.execute(ReadFromS3Input(show_name=show))
            if not read.success:
                return read
        transcripts = (read.first_json() or {}).get("transcripts", [])
        if input_data.max_transcripts:
            transcripts = transcripts[: input_data.max_transcripts]
        if not transcripts:
            return ToolResponse.from_error(f"no transcripts found for {show!r}")

        texts, sources = extract_texts(transcripts)
        if not texts:
            return ToolResponse.from_error(
                f"no extractable text in {len(transcripts)} transcripts"
            )
        report_progress(1, 3, f"embedding {len(texts)} texts")
        with nested_progress(base=1.0, span=1.0, total=3):
            emb = await self.embedder_tool.execute(
                FetchEmbeddingsInput(texts=texts)
            )
        if not emb.success:
            return emb
        emb_out = emb.first_json() or {}
        embeddings = emb_out["embeddings"]
        skipped = set(emb_out.get("skipped_indices", []))
        # per-embedding metadata "{show}/{episode}" (SURVEY.md A.4),
        # aligned through BOTH skip stages (un-extractable transcripts
        # and embedding failures) so labels always match their vectors
        kept_sources = [s for i, s in enumerate(sources) if i not in skipped]
        metadata = [
            f"{transcripts[s]['show_name']}/{transcripts[s]['episode_id']}"
            for s in kept_sources
        ]
        report_progress(2, 3, "storing vectors in index")
        store_resp = await StoreInFaissTool().execute(
            StoreInFaissInput(
                embeddings=embeddings,
                index_path=input_data.index_path,
                metadata=metadata,
            )
        )
        if not store_resp.success:
            return store_resp
        stored = store_resp.first_json() or {}
        return ToolResponse.from_model(
            ProcessTranscriptsOutput(
                show_name=show,
                transcripts_processed=len(transcripts),
                embeddings_created=len(embeddings),
                total_vectors=stored.get("total_vectors", 0),
                index_path=input_data.index_path,
            )
        )


def default_tools(
    store: Optional[TranscriptStore] = None,
    embedder: Optional[Embedder] = None,
    config: Optional[EmbeddingConfig] = None,
) -> List[Tool]:
    """The reference's four tools (``server.py:16-31``) plus
    SearchIndex — the retrieval step its pipeline was missing."""
    return [
        FetchEmbeddingsTool(embedder, config),
        ReadFromS3Tool(store),
        StoreInFaissTool(),
        ProcessTranscriptsToEmbeddingsTool(store, embedder, config),
        SearchIndexTool(embedder, config),
    ]
