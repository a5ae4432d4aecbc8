"""qrag_tpu — an exact retrieval-and-rerank engine in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference "quantum-rag" project (jon-fox/quantum-rag): exact dense
retrieval over an HBM-resident (optionally sharded) embedding matrix,
a quantum state-fidelity reranker implemented as batched JAX statevector
math, a classical reranker + routing controller compiled as jit branches,
an ingestion pipeline behind a typed tool registry, an MCP-style server
and agent client, and an HTTP serving layer.

Layer map (bottom-up; see SURVEY.md §1):
  ops/       Pallas kernels + XLA ops (tiled scan + fused top-k, statevector)
  index/     FAISS-format IO, HBM-resident flat index, manifests
  parallel/  mesh/sharding helpers, sharded search with top-k merge
  reranker/  quantum + classical rerankers, routing controller
  models/    JAX cross-encoder (flagship trainable model)
  pipeline/  chunking, embedding providers, ingestion
  tools/     typed tool registry (reference: mcp/server/interfaces/tool.py)
  serving/   HTTP API + MCP server + agent client (stdlib; no FastAPI dep)
  utils/     logging, profiling, metrics
"""

__version__ = "0.1.0"

from qrag_tpu.documents import Document
from qrag_tpu.config import (
    QragConfig,
    ControllerConfig,
    ClassicalConfig,
    QuantumConfig,
    IndexConfig,
    ServingConfig,
)

__all__ = [
    "Document",
    "QragConfig",
    "ControllerConfig",
    "ClassicalConfig",
    "QuantumConfig",
    "IndexConfig",
    "ServingConfig",
    "__version__",
]
