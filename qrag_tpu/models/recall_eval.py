"""Learned-embedding training + recall@k evaluation harness.

Closes the north-star "recall@10 parity with learned embeddings"
evidence gap: trains the bi-encoder (``models/bi_encoder.py``) on
(query, chunk) pairs from the deterministic transcript corpus
(``pipeline/corpus_gen.py``), then measures recall@k of retrieval with
the trained provider vs the string-hash baseline on queries against
EPISODE-HELD-OUT chunks (the trainer never saw them).

The hash provider embeds whole strings (no lexical generalization), so
its recall reflects chance; the trained encoder must learn byte-level
token overlap AND the topic synonym mapping to score — both transfer
to held-out episodes.  ``python -m qrag_tpu.models.recall_eval`` runs
the full-size version and prints JSON; tests run a tiny config.
"""

from __future__ import annotations

import functools
import json
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from qrag_tpu.pipeline.corpus_gen import (
    Chunk,
    generate_corpus,
    make_query,
    split_by_episode,
    training_pairs,
)


@dataclass
class RecallEvalConfig:
    n_episodes: int = 48
    chunks_per_episode: int = 8
    holdout_frac: float = 0.25
    steps: int = 400
    batch: int = 64
    lr: float = 1e-3
    dim: int = 128  # tower width
    layers: int = 2
    heads: int = 4
    out_dim: int = 128
    max_len: int = 128
    k: int = 10
    queries_per_chunk: int = 2
    seed: int = 0


def train_bi_encoder(cfg: RecallEvalConfig, pairs: List[Tuple[str, str]]):
    """InfoNCE training loop; returns a TrainedEmbedder."""
    import jax
    from qrag_tpu.platform import compute_dtype
    import jax.numpy as jnp
    import optax

    from qrag_tpu.models.bi_encoder import (
        BiEncoderConfig,
        TrainedEmbedder,
        init_params,
        make_train_step,
        tokenize_texts,
    )
    from qrag_tpu.models.cross_encoder import CrossEncoderConfig

    bi_cfg = BiEncoderConfig(
        tower=CrossEncoderConfig(
            dim=cfg.dim,
            n_heads=cfg.heads,
            n_layers=cfg.layers,
            max_len=cfg.max_len,
            dtype=compute_dtype(),
        ),
        out_dim=cfg.out_dim,
    )
    params = init_params(jax.random.PRNGKey(cfg.seed), bi_cfg)
    optimizer = optax.adam(cfg.lr)
    opt_state = optimizer.init(params)
    step = jax.jit(make_train_step(bi_cfg, optimizer))
    rng = np.random.RandomState(cfg.seed + 7)
    # group pairs by their positive text: a batch must not contain the
    # same chunk twice, or the in-batch-negative labels are ill-posed
    # (two identical docs, two different "correct" rows)
    by_doc: Dict[str, List[Tuple[str, str]]] = {}
    for q, d in pairs:
        by_doc.setdefault(d, []).append((q, d))
    docs = list(by_doc)
    eff_batch = min(cfg.batch, len(docs))
    losses = []
    for i in range(cfg.steps):
        picks = rng.choice(len(docs), size=eff_batch, replace=False)
        qs, ds = [], []
        for p in picks:
            variants = by_doc[docs[p]]
            q, d = variants[rng.randint(len(variants))]
            qs.append(q)
            ds.append(d)
        qt, qm = tokenize_texts(qs, cfg.max_len)
        dt, dm = tokenize_texts(ds, cfg.max_len)
        params, opt_state, loss = step(params, opt_state, qt, qm, dt, dm)
        if i % 50 == 0 or i == cfg.steps - 1:
            losses.append((i, float(loss)))
    return TrainedEmbedder(bi_cfg, params=params), losses


def recall_at_k(
    embedder,
    chunks: List[Chunk],
    eval_idx: Sequence[int],
    k: int,
    queries_per_chunk: int,
    seed: int = 11,
) -> float:
    """Index ALL chunks with `embedder`, query for held-out chunks,
    score the fraction whose source chunk lands in the top-k."""
    from qrag_tpu.index.flat_index import DeviceFlatIndex

    vecs = embedder([c.text for c in chunks])
    index = DeviceFlatIndex.from_numpy(
        np.asarray(vecs, np.float32), metric="l2", normalize=True,
        topk_mode="exact",
    )
    rng = np.random.RandomState(seed)
    queries, truth = [], []
    for ci in eval_idx:
        for _ in range(queries_per_chunk):
            queries.append(make_query(chunks[ci], rng))
            truth.append(ci)
    qv = np.asarray(embedder(queries), np.float32)
    res = index.search(qv, k=k)
    hits = sum(
        1 for qi, t in enumerate(truth) if t in set(int(i) for i in res.indices[qi])
    )
    return hits / len(truth)


def run_eval(
    cfg: Optional[RecallEvalConfig] = None,
    weights_dir: Optional[str] = None,
) -> Dict[str, object]:
    """Full pipeline: corpus → split → train → recall@k for trained vs
    hash (vs untrained-random sanity floor)."""
    from qrag_tpu.pipeline.embeddings import HashEmbedder

    cfg = cfg or RecallEvalConfig()
    chunks = generate_corpus(
        cfg.n_episodes, cfg.chunks_per_episode, seed=cfg.seed
    )
    train_idx, hold_idx = split_by_episode(
        chunks, cfg.holdout_frac, seed=cfg.seed + 1
    )
    pairs = training_pairs(
        chunks, train_idx, n_pairs=cfg.steps * cfg.batch, seed=cfg.seed + 2
    )
    t0 = time.time()
    trained, losses = train_bi_encoder(cfg, pairs)
    train_s = time.time() - t0
    out: Dict[str, object] = {
        "corpus_chunks": len(chunks),
        "held_out_chunks": len(hold_idx),
        "train_pairs": len(pairs),
        "steps": cfg.steps,
        "train_seconds": round(train_s, 1),
        "loss_trace": losses,
    }
    out["recall_at_k"] = cfg.k
    out["trained"] = recall_at_k(
        trained, chunks, hold_idx, cfg.k, cfg.queries_per_chunk
    )
    out["hash"] = recall_at_k(
        HashEmbedder(dim=cfg.out_dim), chunks, hold_idx, cfg.k,
        cfg.queries_per_chunk,
    )
    if weights_dir:
        trained.save(weights_dir)
        out["weights_dir"] = weights_dir
    return out


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="train + recall@k eval")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--episodes", type=int, default=48)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--weights-dir", default=None)
    args = p.parse_args(argv)
    cfg = RecallEvalConfig(
        steps=args.steps, n_episodes=args.episodes, batch=args.batch
    )
    print(json.dumps(run_eval(cfg, weights_dir=args.weights_dir), indent=2))


if __name__ == "__main__":
    main()
