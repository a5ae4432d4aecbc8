"""End-to-end demo of the full reference workflow, offline.

  1. ingest: transcripts dir -> embeddings -> FAISS-format index
     (the MCP pipeline tool, run in-process)
  2. serve: load the artifact into the engine
  3. query: exact retrieval, fused quantum rerank, routed /rerank

Run: python examples/full_workflow.py
"""

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from qrag_tpu.config import EmbeddingConfig, QragConfig
from qrag_tpu.documents import Document
from qrag_tpu.engine import QragEngine
from qrag_tpu.pipeline.storage import LocalTranscriptStore
from qrag_tpu.reranker.controller import rerank_response_dict
from qrag_tpu.tools import ToolService, default_tools

EPISODES = {
    "ep1": "Today's show is sponsored by Acme. Use discount code ACME for a great deal on premium products.",
    "ep2": "A long discussion about the election, polling numbers, and what the candidates said this week.",
    "ep3": "We interview a jazz pianist about improvisation, practice habits, and their favorite recordings.",
    "ep4": "This segment is a paid promotion: the new Brand X subscription offer, limited time only.",
}


def main() -> None:
    work = tempfile.mkdtemp(prefix="qrag_demo_")
    show_dir = os.path.join(work, "shows", "Demo_Podcast", "2026")
    os.makedirs(show_dir)
    for ep, text in EPISODES.items():
        with open(os.path.join(show_dir, f"{ep}_transcript.json"), "w") as f:
            json.dump({"transcript": text}, f)

    # 1. ingest through the typed tool pipeline
    embed_cfg = EmbeddingConfig(provider="hash", dim=256)
    service = ToolService()
    service.register_tools(
        default_tools(
            store=LocalTranscriptStore(os.path.join(work, "shows")),
            config=embed_cfg,
        )
    )
    index_path = os.path.join(work, "demo.faiss")
    resp = service.execute_tool_sync(
        "ProcessTranscriptsToEmbeddings",
        {"show_name": "Demo_Podcast", "index_path": index_path},
    )
    print("ingest:", resp.first_json())

    # 2. serve: load the artifact into the engine
    cfg = QragConfig.from_dict({"embedding": {"provider": "hash", "dim": 256}})
    engine = QragEngine.from_faiss(index_path, config=cfg)

    # 3a. exact retrieval
    res = engine.search(EPISODES["ep3"], k=2)
    print("search top hit:", res.metadata[0][0])

    # 3b. fused retrieval -> quantum fidelity rerank (one jit graph)
    out = engine.search_rerank(
        "find the sponsored advertisement segments", k=3, candidates=4
    )
    print("fused rerank:", [h["metadata"] for h in out["results"][0]])

    # 3c. the reference's /rerank semantics with auto routing
    docs = [Document(ep, text) for ep, text in EPISODES.items()]
    result = engine.rerank(
        "find the advertisement", docs, top_k=2, reranker_type="auto"
    )
    print("route:", result["reranker_used"])  # "ad" keyword -> quantum
    print(json.dumps(rerank_response_dict(result), indent=2)[:400])


if __name__ == "__main__":
    main()
