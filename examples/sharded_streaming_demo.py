#!/usr/bin/env python
"""Round-2 feature demo: sharded + elastic serving, streaming MCP.

Runs self-contained on the CPU (8 virtual devices):

  1. build a corpus and serve it ROW-SHARDED over all devices with
     elastic recovery (the `qrag-serve --sharded --elastic` path);
  2. inject a device failure mid-serving and watch it re-shard;
  3. run an MCP ingestion over the STREAMING transport with live
     progress notifications.

Usage: python examples/sharded_streaming_demo.py
"""

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# This is a MULTI-DEVICE demo: always run on the 8-virtual-device CPU
# mesh (one card can't show re-sharding).  APPEND to existing
# XLA_FLAGS (conftest.py does the same) and select the platform via
# jax.config BEFORE any backend query — jax.default_backend() would
# initialize the default platform and pin it.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from qrag_tpu.config import QragConfig  # noqa: E402
from qrag_tpu.engine import QragEngine  # noqa: E402


def sharded_elastic_demo() -> None:
    print(f"== sharded + elastic serving over {len(jax.devices())} devices")
    cfg = QragConfig.from_dict(
        {
            "embedding": {"provider": "hash", "dim": 64},
            "index": {"sharded": True, "elastic": True, "metric": "l2"},
        }
    )
    eng = QragEngine(config=cfg)
    rng = np.random.RandomState(0)
    texts = [f"episode {i} discusses topic {i % 7}" for i in range(200)]
    eng.add_texts(texts, metadata=[f"Show/ep{i}" for i in range(200)])
    print("   layout:", json.dumps(eng.index.layout()))

    out = eng.search_rerank("find topic 3 discussions", k=3, candidates=20)
    print("   top hit:", out["results"][0][0]["metadata"])

    def boom():
        raise RuntimeError("injected device loss")

    eng.index.inject_search_failure(boom)
    out2 = eng.search_rerank("find topic 3 discussions", k=3, candidates=20)
    print(
        f"   survived a device loss: rebuilds={eng.index.rebuilds}, "
        f"now {eng.index.layout()['mesh']['model']} shards, "
        f"same top hit: {out2['results'][0][0]['metadata']}"
    )


def streaming_mcp_demo() -> None:
    print("== streaming MCP ingestion (SSE progress)")
    from qrag_tpu.config import EmbeddingConfig
    from qrag_tpu.pipeline.storage import LocalTranscriptStore
    from qrag_tpu.serving.mcp_client import McpClient
    from qrag_tpu.serving.mcp_server import create_tool_service, serve_in_thread

    root = tempfile.mkdtemp()
    d = os.path.join(root, "Demo_Show", "2026")
    os.makedirs(d)
    for ep in ("alpha", "beta", "gamma"):
        with open(os.path.join(d, f"{ep}_transcript.json"), "w") as f:
            json.dump({"transcript": f"the {ep} episode content " * 12}, f)
    service = create_tool_service(
        store=LocalTranscriptStore(root),
        config=EmbeddingConfig(provider="hash", dim=32),
    )
    server = serve_in_thread(service)
    url = f"http://127.0.0.1:{server.server_address[1]}/mcp"

    events = []
    client = McpClient(
        url,
        stream=True,
        on_progress=lambda p, t, m: events.append(f"{p:.1f}/{t} {m}"),
    )
    client.initialize()
    ok, payload = client.call_tool(
        "ProcessTranscriptsToEmbeddings",
        {"show_name": "Demo_Show", "index_path": os.path.join(root, "i.faiss")},
    )
    server.shutdown()
    print(f"   ingested: {payload.get('embeddings_created')} embeddings, "
          f"{len(events)} progress events streamed:")
    for e in events:
        print("    ", e)


if __name__ == "__main__":
    sharded_elastic_demo()
    streaming_mcp_demo()
    print("demo complete")
