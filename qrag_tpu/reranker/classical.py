"""Classical reranker.

JAX counterpart of the reference's CrossEncoder reranker
(``src/reranker/classical.py:45-320``).  The reference scored
(query, doc) pairs with a torch CrossEncoder on CPU/CUDA; here the
scorer is pluggable and runs under jit:

* "cosine" (default): embed query+docs (pluggable embedder) and score
  by cosine similarity — one matmul over the candidate batch.
* "cross-encoder": the JAX cross-encoder model
  (``qrag_tpu/models/cross_encoder.py``), batched forward pass.

Behavioral contract preserved from the reference:
  * input validation failure → original order, neutral 0.5 scores
    (``classical.py:248-252``)
  * scorer failure after retries → original order, neutral scores
    (``classical.py:218-229``); retries with 0.5·(attempt+1) backoff
    (``classical.py:193-216``)
  * text sanitation: whitespace collapse + truncation at
    ``max_sequence_length * 4`` chars (``classical.py:155-167``)
  * per-(query, doc) score cache — keyed by a stable blake2 content
    hash rather than the salted builtin ``hash`` (SURVEY.md A.5)
  * stable descending sort + top_k (``classical.py:301-308``)
"""

from __future__ import annotations

import hashlib
import logging
import re
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from qrag_tpu.config import ClassicalConfig
from qrag_tpu.documents import Document, validate_documents
from qrag_tpu.ops.topk import cosine_scores
from qrag_tpu.pipeline.embeddings import Embedder, HashEmbedder

logger = logging.getLogger(__name__)


def sanitize_text(text: str, max_sequence_length: int = 512) -> str:
    """Whitespace collapse + ~4-chars-per-token truncation
    (``classical.py:155-167``)."""
    if not isinstance(text, str):
        text = str(text)
    text = re.sub(r"\s+", " ", text).strip()
    limit = max_sequence_length * 4
    if len(text) > limit:
        text = text[:limit]
    return text


def _stable_key(query: str, doc_content: str) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(query.encode("utf-8"))
    h.update(b"\x00")
    h.update(doc_content.encode("utf-8"))
    return h.hexdigest()


class ClassicalReranker:
    """Pluggable-scorer classical reranker with the reference's
    resilience contract."""

    def __init__(
        self,
        config: Optional[ClassicalConfig] = None,
        embedder: Optional[Embedder] = None,
        scorer: Optional[Callable[[str, List[str]], np.ndarray]] = None,
    ):
        self.config = config or ClassicalConfig()
        self.embedder = embedder or HashEmbedder(dim=256)
        self._scorer_override = scorer
        self.score_cache: Dict[str, float] = {}
        self._cross_encoder = None  # lazily built JAX model
        # scorer fallback chain (the reference fell back across three
        # cross-encoder models on load failure, classical.py:134-153,
        # before neutral scores; here the chain is cross-encoder →
        # cosine → neutral).  Sticky: once a scorer fails out, later
        # requests use the fallback directly.
        self._active_method = self.config.method

    # ------------------------------------------------------------------

    def _score_cosine(self, query: str, contents: List[str]) -> np.ndarray:
        embeds = self.embedder([query] + contents)
        q, docs = embeds[:1], embeds[1:]
        scores = cosine_scores(jnp.asarray(q), jnp.asarray(docs))
        return np.asarray(scores)[0]

    def _score_cross_encoder(self, query: str, contents: List[str]) -> np.ndarray:
        if self._cross_encoder is None:
            from qrag_tpu.models.cross_encoder import CrossEncoderScorer

            self._cross_encoder = CrossEncoderScorer.from_config(self.config)
        if self.config.long_doc_strategy != "chunk_pool":
            return self._cross_encoder.score(query, contents)
        # chunk-and-pool: score fixed-size windows of each document and
        # max-pool — no content is dropped (the reference truncates at
        # max_sequence_length*4 chars; SURVEY.md §5 long-context).
        # Windows are cut at what the tokenizer actually INGESTS per
        # piece (byte-level: max_len minus CLS/SEP framing minus the
        # query's share), so every window is fully scored.
        max_len = getattr(
            getattr(self._cross_encoder, "cfg", None),
            "max_len",
            self.config.max_sequence_length,
        )
        q_bytes = min(len(query.encode("utf-8")), (max_len - 3) // 2)
        window = max(32, max_len - 3 - q_bytes)
        pieces: List[str] = []
        owner: List[int] = []
        for di, content in enumerate(contents):
            chunks = [
                content[i : i + window] for i in range(0, len(content), window)
            ] or [""]
            pieces.extend(chunks)
            owner.extend([di] * len(chunks))
        piece_scores = self._cross_encoder.score(query, pieces)
        out = np.full(len(contents), -np.inf, np.float32)
        for s, di in zip(piece_scores, owner):
            out[di] = max(out[di], float(s))
        return out

    def _score_batch(self, query: str, contents: List[str]) -> np.ndarray:
        if self._scorer_override is not None:
            return np.asarray(self._scorer_override(query, contents))
        if self._active_method == "cross-encoder":
            return self._score_cross_encoder(query, contents)
        return self._score_cosine(query, contents)

    def _retry_once_through(self, query: str, contents: List[str]) -> np.ndarray:
        """One scorer, max_retries attempts with linear backoff
        (``classical.py:193-216``)."""
        last_err: Optional[Exception] = None
        for attempt in range(self.config.max_retries):
            try:
                t0 = time.time()
                scores = self._score_batch(query, contents)
                logger.debug(
                    "scorer completed in %.3fs for %d pairs",
                    time.time() - t0,
                    len(contents),
                )
                return scores
            except Exception as e:  # noqa: BLE001 - resilience contract
                last_err = e
                logger.warning("prediction attempt %d failed: %s", attempt + 1, e)
                if attempt < self.config.max_retries - 1:
                    time.sleep(0.5 * (attempt + 1))
        raise RuntimeError("all retry attempts failed") from last_err

    def _predict_with_retries(self, query: str, contents: List[str]) -> np.ndarray:
        """Retries, then the scorer FALLBACK CHAIN: cross-encoder →
        cosine → (caller's) neutral scores — the rebuild's counterpart
        of the reference's three-model fallback
        (``classical.py:134-153``)."""
        try:
            return self._retry_once_through(query, contents)
        except RuntimeError:
            if (
                self._scorer_override is not None
                or self._active_method != "cross-encoder"
            ):
                raise  # no further scorer to fall back to
            logger.warning(
                "cross-encoder scorer failed out; falling back to the "
                "cosine scorer (sticky)"
            )
            self._active_method = "cosine"
            return self._retry_once_through(query, contents)

    def _neutral(self, documents: List[Document]) -> List[Tuple[Document, float]]:
        """Original order, neutral scores (``classical.py:218-229``)."""
        return [(doc, self.config.neutral_score) for doc in documents]

    # ------------------------------------------------------------------

    def rerank(
        self,
        query: str,
        documents: List[Document],
        top_k: Optional[int] = None,
    ) -> List[Tuple[Document, float]]:
        start = time.time()
        if not validate_documents(query, documents):
            logger.error("input validation failed - returning neutral scores")
            return self._neutral(documents)

        query_s = sanitize_text(query, self.config.max_sequence_length)
        try:
            # chunk_pool keeps full content (windows are cut at scoring
            # time); truncate mode applies the reference's limit here
            sanitize_limit = (
                self.config.max_sequence_length
                if self.config.long_doc_strategy != "chunk_pool"
                else 1 << 24
            )
            # Up to 2 passes: if the scorer FALLS BACK mid-request
            # (cross-encoder -> cosine), the two scorers' score scales
            # are incomparable, so the cache (old-scale scores) is
            # cleared and the WHOLE request rescored on the fallback —
            # one request always ranks on one scale.
            for _pass in range(2):
                method_before = self._active_method
                # score into position slots so the stable descending
                # sort below sees documents in THEIR ORIGINAL ORDER
                # regardless of cache-hit/miss interleaving (ties keep
                # input order — the reference's contract,
                # classical.py:301-308)
                scores_by_pos: List[Optional[float]] = [None] * len(documents)
                uncached_pos: List[int] = []
                uncached_contents: List[str] = []
                for pos, doc in enumerate(documents):
                    content_s = sanitize_text(doc.content, sanitize_limit)
                    key = _stable_key(query_s, content_s)
                    if self.config.enable_cache and key in self.score_cache:
                        scores_by_pos[pos] = self.score_cache[key]
                    else:
                        uncached_pos.append(pos)
                        uncached_contents.append(content_s)

                if uncached_contents:
                    all_scores: List[float] = []
                    bs = self.config.batch_size
                    for i in range(0, len(uncached_contents), bs):
                        batch = uncached_contents[i : i + bs]
                        all_scores.extend(
                            float(s)
                            for s in self._predict_with_retries(query_s, batch)
                        )
                    for pos, content_s, score in zip(
                        uncached_pos, uncached_contents, all_scores
                    ):
                        if self.config.enable_cache:
                            self.score_cache[
                                _stable_key(query_s, content_s)
                            ] = score
                        scores_by_pos[pos] = score
                if self._active_method == method_before:
                    break
                logger.warning(
                    "scorer fell back mid-request (%s -> %s): clearing "
                    "the score cache and rescoring the request on one "
                    "scale",
                    method_before,
                    self._active_method,
                )
                self.score_cache.clear()
            scored = [
                (doc, float(s)) for doc, s in zip(documents, scores_by_pos)
            ]
        except Exception as e:  # noqa: BLE001 - resilience contract
            logger.error("scoring failed: %s", e)
            return self._neutral(documents)

        # stable descending sort (ties keep original order), then top_k
        reranked = sorted(scored, key=lambda x: x[1], reverse=True)
        if top_k is not None and top_k > 0:
            reranked = reranked[:top_k]

        logger.info(
            "reranking completed in %.3fs for %d documents",
            time.time() - start,
            len(documents),
        )
        return reranked
