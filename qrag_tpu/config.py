"""Typed configuration tree.

The reference used untyped ``Dict[str, Any]`` configs with scattered
``.get(key, default)`` calls (``controller.py:16-22,40``,
``classical.py:55-77``, ``quantum.py:32-34``) plus env vars, argparse and
AWS SSM as config channels (SURVEY.md §5 "Config / flag system").  This
module centralizes the same keys and defaults into one dataclass tree
with env-var and dict overrides.

Defaults preserved from the reference:
  - controller: complexity_threshold=8, the 10 ad keywords
    (``controller.py:25-40``)
  - classical: method="cross-encoder", batch_size=32,
    max_sequence_length=512, max_retries=3, timeout=30, enable_cache=True
    (``classical.py:55-77``)
  - quantum: method="state_fidelity", n_qubits=4 (``quantum.py:32-34``)
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# The 10 ad-detection keywords of the reference controller
# (``src/reranker/controller.py:25-36``).  Substring matching against
# query words is part of the observable routing semantics (SURVEY.md
# Appendix A.7) and must be preserved.
DEFAULT_QUANTUM_KEYWORDS: Tuple[str, ...] = (
    "advertisement",
    "ad",
    "sponsor",
    "commercial",
    "promotion",
    "product",
    "brand",
    "discount",
    "offer",
    "deal",
)


@dataclass
class ControllerConfig:
    """Quantum-vs-classical routing (``controller.py:42-67``)."""

    complexity_threshold: int = 8
    quantum_keywords: Tuple[str, ...] = DEFAULT_QUANTUM_KEYWORDS


@dataclass
class ClassicalConfig:
    """Classical reranker (``classical.py:55-77``).

    ``method`` selects the scorer:
      - "cosine": cosine similarity between embeddings (default here —
        runs on the device; the reference's torch CrossEncoder is not
        available here)
      - "cross-encoder": the JAX cross-encoder model
        (``qrag_tpu/models/cross_encoder.py``)
    """

    method: str = "cosine"
    model_name: str = "qrag-cross-encoder-tiny"
    batch_size: int = 32
    max_sequence_length: int = 512
    max_retries: int = 3
    timeout: float = 30.0
    model_cache_dir: str = "cross_encoder"
    enable_cache: bool = True
    # Neutral score returned on scorer failure (``classical.py:218-229``).
    neutral_score: float = 0.5
    # Long documents: "truncate" (the reference's behavior,
    # classical.py:164-165) or "chunk_pool" (score fixed-size windows,
    # max-pool — no content is dropped).
    long_doc_strategy: str = "truncate"


@dataclass
class QuantumConfig:
    """Quantum fidelity reranker (``quantum.py:32-34``)."""

    method: str = "state_fidelity"
    n_qubits: int = 4
    # Use the O(n_qubits) analytic product-form fidelity (exact — both
    # circuits share the same CX-ladder entangler, which cancels in
    # <psi_q|psi_d>).  Set False to force the full 2^n statevector path.
    use_analytic_fidelity: bool = True
    # "rotation": the reference's ry/rz + CX-ladder encoding
    # (quantum.py:138-167).  "amplitude": amplitude encoding + swap-test
    # fidelity (the BASELINE north-star variant).
    encoding: str = "rotation"


@dataclass
class IndexConfig:
    """HBM-resident flat index."""

    metric: str = "l2"  # "l2" or "ip"; reference builds IndexFlatL2
    dtype: str = "float32"  # device-matrix dtype: "float32" | "bfloat16"
    normalize: bool = True  # normalize vectors at ingestion (north star)
    # Pad corpus rows to a multiple of this (whole 128-row windows).
    row_pad_multiple: int = 128
    # Non-exact modes use the memory-lean windowed scan
    # (ops/window_scan.py; the fused kernel on a GPU).
    use_pallas: bool = False
    # Top-k selection: "exact" (lax.top_k), "approx" (hardware
    # partial-reduce + oversample), "verified" (approx + exactness
    # certificate + exact re-run of failing rows; exact values at
    # ~approx speed), "refined" (bf16 selection traffic + exact
    # re-scoring of gathered candidates), "bounded" (provably-exact
    # top-k via norm-bounded window pruning — ops/bounded_topk.py;
    # identity AND tie order exact, one scan pass, no (B, N) matrix).
    #
    # Default "bounded": it is strictly stronger than "verified"
    # (exact identity AND tie order, w.r.t. the f32 query) and needs
    # no second pass over the scores.  Cost: on a float32 store it caches a bf16 scan copy (+50%
    # corpus HBM single-device; per-call cast when sharded) — prefer
    # dtype="bfloat16" for large production corpora.  Small/odd-shaped
    # corpora degrade to the exact sort (cheap there).
    topk_mode: str = "bounded"
    # With topk_mode="bounded": the scan arithmetic. "bf16" (packed
    # float planes) or "int8" (EXACT integer dots of per-window int8
    # codes — with margins extended to the quantization residual;
    # ops/bounded_topk.bounded_exact_topk_int8).  Both are
    # provably exact w.r.t. the stored corpus.
    bounded_scan: str = "bf16"
    # With topk_mode="bounded": "float32" (default) keeps exactness
    # w.r.t. the query as given; "store" rounds queries to the store
    # dtype first — provably exact w.r.t. the ROUNDED query (the
    # fp16-store contract of e.g. GPU FAISS), collapsing the margin
    # regime to narrow on a bf16 store (lean certificate budgets).
    bounded_query_dtype: str = "float32"
    # Small-batch latency accelerator: "none" | "clustered" |
    # "clustered_probe".
    # "clustered" routes query batches of <= accel_max_batch through
    # cluster-pruned PROVABLY-EXACT search (ops/cluster_topk.py):
    # k-means groups + centroid/radius upper bounds certify which
    # contiguous row groups can hold top-k rows, so a small batch
    # reads a few MB instead of the whole corpus (the full scan is
    # HBM-read-bound at small B).  Exact for every topk_mode; uniform
    # random corpora defeat the bounds and self-correct through
    # escalation -> full scan (exact, just not faster).
    # "clustered_probe" is the classic FAISS-IVF nprobe trade —
    # certificates OFF, recall set by cluster_budget — the only
    # APPROXIMATE arm, and an explicit opt-in.
    small_batch_accel: str = "none"
    accel_max_batch: int = 16
    # rows per clustered group (contiguous dynamic_slice unit)
    cluster_group_rows: int = 512
    # top-S group budget per query; 0 = auto (max(8, 2k))
    cluster_budget: int = 0
    # routing guard: skip the accelerator when its expected read
    # volume (batch * S * group_rows rows, per chip) would exceed
    # this fraction of the (per-chip) corpus — the full scan is then
    # strictly better.  0 disables the guard.
    accel_read_cap: float = 0.5
    # "none" | "int8": int8 scan with exact refinement
    # (index/quantized_index.py) — half the scan bytes of bf16.
    quantization: str = "none"
    # candidates = refine_factor * k for the quantized scan
    refine_factor: int = 4
    # quantized scan backend: "row" (per-row scales + approx_max_k)
    # or "window" (packed window-argmax scan, ops/window_scan.py:
    # selection over (B, N/128) planes)
    quant_scan: str = "row"
    # With quant_scan="window": exact_scores=False skips the
    # candidate-row re-score GATHER entirely (the gather-free mode).
    # Returned scores are then
    # APPROXIMATE (block-int8 dot products converted to l2 via exact
    # sqnorms: ~1% error); indices are approx-class like the rest of
    # the windowed pipeline.  serve CLI: --lean-scan.
    exact_scores: bool = True
    # Shard corpus rows over the mesh "model" axis
    # (parallel/sharded_index.py; BASELINE configs[4]).  Mesh geometry
    # comes from the `mesh` config section; also via serve --sharded.
    sharded: bool = False
    # With sharded: wrap in ElasticShardedIndex (parallel/elastic.py) —
    # device-loss detection + re-shard over survivors on failure.
    elastic: bool = False
    # "allgather" | "ring" per-shard top-k merge strategy
    shard_merge: str = "allgather"


@dataclass
class MeshConfig:
    """Device mesh for sharded retrieval / training."""

    # Axis names: data (query batch), model (corpus rows / model shards).
    data_axis: str = "data"
    model_axis: str = "model"
    # -1 = use all devices on that axis.
    data_parallel: int = 1
    model_parallel: int = -1


@dataclass
class ServingConfig:
    """HTTP API + MCP server (reference: ``app.py:95-96``, ``server.py:54-71``)."""

    host: str = "0.0.0.0"
    port: int = 8000
    mcp_port: int = 6969
    default_top_k: int = 5
    # Request padding buckets (XLA static shapes; SURVEY.md §7 hard
    # part 5).  The FULL pow2 ladder pow2_bucket() can produce for
    # <=512 docs — warmup compiles every rung, and the batcher caps
    # its COALESCED pair axis at max(doc_buckets) (SearchBatcher
    # max_pairs, splitting oversized groups), so batcher-driven device
    # calls never hit an unwarmed shape.  A single client request
    # with more docs than max(doc_buckets) still pays a one-time
    # compile for its own pow2 bucket — client-driven.
    doc_buckets: Tuple[int, ...] = (8, 16, 32, 64, 128, 256, 512)
    # Query-batch buckets engine.warmup() pre-compiles: the batcher
    # pads coalesced batches to pow2 buckets >= 8 (utils/buckets.py)
    # and caps coalescing at max_batch=64, so this ladder covers every
    # shape batched serving can produce.  (A single client request
    # carrying >64 queries of its own still pays a one-time compile
    # for its pow2 bucket — client-driven, not batcher-driven.)
    warmup_batch_buckets: Tuple[int, ...] = (1, 8, 16, 32, 64)


@dataclass
class EmbeddingConfig:
    """Embedding provider (reference: ``fetch_embeddings.py:33-37,67-104``)."""

    provider: str = "mock"  # "mock" | "openai" | "hash"
    model: str = "text-embedding-3-small"
    dim: int = 1536
    max_tokens_per_chunk: int = 8000  # ~4 chars/token => 32k chars
    ssm_api_key_param: str = "/openai/api_key"


@dataclass
class QragConfig:
    """Root config."""

    controller: ControllerConfig = field(default_factory=ControllerConfig)
    classical: ClassicalConfig = field(default_factory=ClassicalConfig)
    quantum: QuantumConfig = field(default_factory=QuantumConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    embedding: EmbeddingConfig = field(default_factory=EmbeddingConfig)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "QragConfig":
        """Build from a (possibly nested, possibly partial) dict."""
        cfg = cls()
        if not d:
            return cfg
        return _merge_dataclass(cfg, d)

    def with_env_overrides(self, environ: Optional[Dict[str, str]] = None) -> "QragConfig":
        """Apply ``QRAG_<SECTION>_<FIELD>`` env overrides.

        e.g. ``QRAG_SERVING_PORT=9000``, ``QRAG_QUANTUM_N_QUBITS=10``.
        """
        env = os.environ if environ is None else environ
        cfg = self
        for section_field in dataclasses.fields(cfg):
            section = getattr(cfg, section_field.name)
            if not dataclasses.is_dataclass(section):
                continue
            updates: Dict[str, Any] = {}
            for f in dataclasses.fields(section):
                key = f"QRAG_{section_field.name.upper()}_{f.name.upper()}"
                if key in env:
                    updates[f.name] = _coerce(env[key], getattr(section, f.name))
            if updates:
                cfg = dataclasses.replace(
                    cfg, **{section_field.name: dataclasses.replace(section, **updates)}
                )
        return cfg

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _coerce(raw: str, current: Any) -> Any:
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, (tuple, list)):
        parts = [p.strip() for p in raw.split(",") if p.strip()]
        if current and isinstance(current[0], int):
            return tuple(int(p) for p in parts)
        return tuple(parts)
    return raw


def _merge_dataclass(obj: Any, overrides: Dict[str, Any]) -> Any:
    updates: Dict[str, Any] = {}
    for f in dataclasses.fields(obj):
        if f.name not in overrides:
            continue
        val = overrides[f.name]
        cur = getattr(obj, f.name)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            updates[f.name] = _merge_dataclass(cur, val)
        elif isinstance(cur, tuple) and isinstance(val, (list, tuple)):
            updates[f.name] = tuple(val)
        else:
            updates[f.name] = val
    return dataclasses.replace(obj, **updates)
