"""Distill the quantum fidelity scorer into the cross-encoder.

The controller routes "quantum" queries to the statevector-fidelity
scorer and "classical" ones to the cross-encoder; distillation closes
the loop between the two model families (ROADMAP models item): the
cross-encoder STUDENT learns to reproduce the fidelity TEACHER's
(query, doc) scores from raw text, so classical-routed traffic ranks
consistently with the quantum expert without paying the embedding +
fidelity path at inference.

Teacher: |<psi_q|psi_d>|^2 via the analytic product form
(``ops/statevector.batched_fidelity`` — the semantics of the
reference's ``quantum.py:108-133``), over deterministic embeddings.
Student: the JAX cross-encoder (``models/cross_encoder.py``), trained
with MSE between sigmoid(logit) and the teacher fidelity (both live
in [0, 1]).

``python -m qrag_tpu.models.distill`` trains on transcript-corpus
pairs and reports held-out rank agreement (Spearman + top-1) before
vs after; the regression test locks a tiny config.
"""

from __future__ import annotations

import functools
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class DistillConfig:
    n_episodes: int = 16
    chunks_per_episode: int = 4
    docs_per_query: int = 8
    n_queries: int = 160
    holdout_frac: float = 0.25
    steps: int = 300
    batch: int = 32
    lr: float = 1e-3
    dim: int = 64
    layers: int = 2
    heads: int = 2
    max_len: int = 128
    n_qubits: int = 10
    teacher_weights: Optional[str] = None  # bi-encoder dir (else fixed init)
    # Warm-start the STUDENT tower from the trained bi-encoder (the
    # round-3 recipe: a tiny byte cross-encoder does not converge from
    # scratch at this scale — it memorizes the train pairs; held-out
    # Spearman stays ~0.  Measured again at full distill scale r4:
    # from-scratch 2000 steps -> spearman 0.015 / agreement at chance).
    # Requires the interaction head + geometry matching the artifact.
    init_from: Optional[str] = None
    n_experts: int = 4
    seed: int = 0


def default_teacher_embedder(n_qubits: int, weights_dir: Optional[str] = None):
    """The teacher's text embedder: the bi-encoder (trained weights if
    available, else its fixed random init).  A *structured* text
    function is required — string-hash embeddings make teacher scores
    textually random, so the student would have nothing to learn."""
    import os

    from qrag_tpu.models.bi_encoder import BiEncoderConfig, TrainedEmbedder
    from qrag_tpu.models.cross_encoder import CrossEncoderConfig

    import jax
    from qrag_tpu.platform import compute_dtype
    import jax.numpy as jnp

    cfg = BiEncoderConfig(
        tower=CrossEncoderConfig(
            dim=64,
            n_heads=2,
            n_layers=1,
            max_len=128,
            dtype=compute_dtype(),
        ),
        out_dim=max(32, 2 * n_qubits),
    )
    if weights_dir and os.path.isdir(weights_dir):
        return TrainedEmbedder(weights_dir=weights_dir)
    return TrainedEmbedder(cfg, seed=42)


def teacher_fidelity(
    queries: Sequence[str],
    doc_lists: Sequence[Sequence[str]],
    n_qubits: int,
    embedder=None,
) -> np.ndarray:
    """Fidelity teacher over (query_i, doc_lists_i) — ONE vmapped
    device call for the whole set (doc lists share a length)."""
    import jax
    import jax.numpy as jnp

    from qrag_tpu.ops.statevector import batched_fidelity

    embedder = embedder or default_teacher_embedder(n_qubits)
    d_per = len(doc_lists[0])
    flat_docs = [d for docs in doc_lists for d in docs]
    q_vecs = np.asarray(embedder(list(queries)), np.float32)
    d_vecs = np.asarray(embedder(flat_docs), np.float32).reshape(
        len(queries), d_per, -1
    )
    fid = jax.vmap(
        lambda q, d: batched_fidelity(q, d, n_qubits=n_qubits, analytic=True)
    )(jnp.asarray(q_vecs), jnp.asarray(d_vecs))
    return np.asarray(fid, np.float32).reshape(-1)


def _make_pairs(cfg: DistillConfig):
    """(query, doc, teacher_score) triplets over the transcript corpus,
    split by episode."""
    from qrag_tpu.pipeline.corpus_gen import (
        generate_corpus,
        make_query,
        split_by_episode,
    )

    chunks = generate_corpus(cfg.n_episodes, cfg.chunks_per_episode, cfg.seed)
    train_idx, hold_idx = split_by_episode(
        chunks, cfg.holdout_frac, seed=cfg.seed + 1
    )
    rng = np.random.RandomState(cfg.seed + 2)

    def build(idx_pool, n_queries):
        pool = np.asarray(list(idx_pool))
        items = []  # (query, [docs]) — docs_per_query per query
        for _ in range(n_queries):
            ci = int(pool[rng.randint(len(pool))])
            query = make_query(chunks[ci], rng)
            others = pool[rng.randint(0, len(pool), size=cfg.docs_per_query - 1)]
            docs = [chunks[ci].text] + [chunks[int(o)].text for o in others]
            items.append((query, docs))
        return items

    n_hold_q = max(8, cfg.n_queries // 4)
    return build(train_idx, cfg.n_queries), build(hold_idx, n_hold_q)


def _flatten_with_teacher(items, n_qubits, embedder):
    teacher = teacher_fidelity(
        [q for q, _ in items], [docs for _, docs in items], n_qubits,
        embedder=embedder,
    )
    qs, ds = [], []
    for query, docs in items:
        for doc in docs:
            qs.append(query)
            ds.append(doc)
    return qs, ds, teacher


def _spearman(a: np.ndarray, b: np.ndarray) -> float:
    ra = np.argsort(np.argsort(a))
    rb = np.argsort(np.argsort(b))
    ra = ra - ra.mean()
    rb = rb - rb.mean()
    denom = np.sqrt((ra * ra).sum() * (rb * rb).sum())
    return float((ra * rb).sum() / denom) if denom else 0.0


def _agreement(items, student_scores, teacher_scores, docs_per_query):
    """Per-query: does the student's best doc match the teacher's?"""
    hits, off = 0, 0
    for _query, docs in items:
        s = student_scores[off : off + len(docs)]
        t = teacher_scores[off : off + len(docs)]
        hits += int(np.argmax(s) == np.argmax(t))
        off += len(docs)
    return hits / len(items)


def distill(cfg: Optional[DistillConfig] = None) -> Dict[str, object]:
    import jax
    from qrag_tpu.platform import compute_dtype
    import jax.numpy as jnp
    import optax

    from qrag_tpu.models.cross_encoder import (
        CrossEncoderConfig,
        forward,
        init_params,
        tokenize_pair,
    )

    cfg = cfg or DistillConfig()
    train_items, hold_items = _make_pairs(cfg)
    emb = default_teacher_embedder(cfg.n_qubits, cfg.teacher_weights)
    tq, td, t_teacher = _flatten_with_teacher(train_items, cfg.n_qubits, emb)
    hq, hd, h_teacher = _flatten_with_teacher(hold_items, cfg.n_qubits, emb)

    if cfg.init_from:
        from qrag_tpu.models.rerank_eval import (
            resolve_init_from,
            warm_start_params,
        )

        ce_cfg = CrossEncoderConfig(
            dim=cfg.dim,
            n_heads=cfg.heads,
            n_layers=cfg.layers,
            max_len=cfg.max_len,
            n_experts=cfg.n_experts,
            dtype=compute_dtype(),
            head_type="interaction",
        )
        init_dir = resolve_init_from(cfg.init_from)
        if init_dir is None:
            raise FileNotFoundError(
                f"init_from={cfg.init_from!r}: no such artifact"
            )
        params = warm_start_params(ce_cfg, init_dir)
    else:
        ce_cfg = CrossEncoderConfig(
            dim=cfg.dim,
            n_heads=cfg.heads,
            n_layers=cfg.layers,
            max_len=cfg.max_len,
            dtype=compute_dtype(),
        )
        params = init_params(jax.random.PRNGKey(cfg.seed), ce_cfg)
    optimizer = optax.adam(cfg.lr)
    opt_state = optimizer.init(params)

    def mse_loss(p, tokens, mask, targets):
        logits = forward(p, tokens, mask, ce_cfg)
        return jnp.mean((jax.nn.sigmoid(logits) - targets) ** 2)

    @jax.jit
    def step(p, o, tokens, mask, targets):
        loss, grads = jax.value_and_grad(mse_loss)(p, tokens, mask, targets)
        updates, o = optimizer.update(grads, o, p)
        return jax.tree_util.tree_map(lambda a, u: a + u, p, updates), o, loss

    def tok(qs, ds):
        toks, masks = zip(
            *(tokenize_pair(q, d, cfg.max_len) for q, d in zip(qs, ds))
        )
        return jnp.asarray(np.stack(toks)), jnp.asarray(np.stack(masks))

    @jax.jit
    def score(p, tokens, mask):
        return jax.nn.sigmoid(forward(p, tokens, mask, ce_cfg))

    h_tokens, h_mask = tok(hq, hd)
    before = np.asarray(score(params, h_tokens, h_mask))

    rng = np.random.RandomState(cfg.seed + 5)
    losses = []
    n = len(tq)
    for i in range(cfg.steps):
        picks = rng.randint(0, n, size=cfg.batch)
        tokens, mask = tok([tq[p] for p in picks], [td[p] for p in picks])
        targets = jnp.asarray(t_teacher[picks])
        params, opt_state, loss = step(params, opt_state, tokens, mask, targets)
        if i % 50 == 0 or i == cfg.steps - 1:
            losses.append((i, float(loss)))

    after = np.asarray(score(params, h_tokens, h_mask))
    out: Dict[str, object] = {
        "loss_trace": losses,
        "spearman_before": round(_spearman(before, h_teacher), 4),
        "spearman_after": round(_spearman(after, h_teacher), 4),
        "top1_agreement_before": round(
            _agreement(hold_items, before, h_teacher, cfg.docs_per_query), 4
        ),
        "top1_agreement_after": round(
            _agreement(hold_items, after, h_teacher, cfg.docs_per_query), 4
        ),
        "held_out_pairs": len(hq),
    }
    return out, params, ce_cfg


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="fidelity -> cross-encoder distillation")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--out", default=None, help="save student weights dir")
    # full-scale knobs (VERDICT r3 item 6): production corpus size,
    # shipped cross-encoder geometry, trained bi-encoder teacher
    p.add_argument("--episodes", type=int, default=16)
    p.add_argument("--chunks-per-episode", type=int, default=4)
    p.add_argument("--queries", type=int, default=160)
    p.add_argument("--docs-per-query", type=int, default=8)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=2)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument(
        "--teacher-weights", default=None,
        help="trained bi-encoder dir (e.g. artifacts/bi_encoder)",
    )
    p.add_argument(
        "--init-from", default=None,
        help="warm-start the STUDENT tower from this bi-encoder dir "
        "(interaction head; required for convergence at scale)",
    )
    args = p.parse_args(argv)
    out, params, ce_cfg = distill(
        DistillConfig(
            steps=args.steps,
            n_episodes=args.episodes,
            chunks_per_episode=args.chunks_per_episode,
            n_queries=args.queries,
            docs_per_query=args.docs_per_query,
            batch=args.batch,
            lr=args.lr,
            dim=args.dim,
            layers=args.layers,
            heads=args.heads,
            max_len=args.max_len,
            teacher_weights=args.teacher_weights,
            init_from=args.init_from,
        )
    )
    if args.out:
        from qrag_tpu.models.cross_encoder import CrossEncoderScorer

        scorer = CrossEncoderScorer(ce_cfg, params=params)
        scorer.save(args.out)
        out["weights_dir"] = args.out
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
