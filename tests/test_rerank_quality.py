"""Cross-encoder rerank-quality evidence (VERDICT r2 #7).

Three layers of proof, all CPU-sized:
  1. the gated-cross-attention interaction variant is EXACTLY the
     two-tower bi-encoder at init (logits == temperature * cosine of
     the tower embeddings, 1e-4) — so warm-starting from the shipped
     bi-encoder inherits its full ranking quality;
  2. the tiny rerank eval: warm-started cross-encoder >> the
     production cosine fallback (HashEmbedder cosine,
     reranker/classical.py:76) on held-out episodes;
  3. fine-tuning machinery runs (loss finite, params update).
Full-size numbers: `python -m qrag_tpu.models.rerank_eval`.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from qrag_tpu.models.bi_encoder import (
    BiEncoderConfig,
    TrainedEmbedder,
    init_params as bi_init,
)
from qrag_tpu.models.cross_encoder import (
    CrossEncoderConfig,
    forward,
    tokenize_pair,
)
from qrag_tpu.models.rerank_eval import (
    RerankEvalConfig,
    eval_ranker,
    _cosine_scorer,
    _eval_cases,
    _make_cfg,
    warm_start_params,
)
from qrag_tpu.pipeline.corpus_gen import generate_corpus, split_by_episode


@pytest.fixture(scope="module")
def bi_artifact(tmp_path_factory):
    """A RANDOM bi-encoder saved as an artifact (geometry of the
    shipped one, tiny dims) — random weights still define a unique
    ranking the warm start must reproduce exactly."""
    cfg = BiEncoderConfig(
        tower=CrossEncoderConfig(
            dim=32, n_heads=2, n_layers=2, max_len=128, n_experts=2,
            dtype=jnp.float32,
        ),
        out_dim=32,
    )
    emb = TrainedEmbedder(cfg, params=bi_init(jax.random.PRNGKey(3), cfg))
    d = tmp_path_factory.mktemp("bi_art")
    emb.save(str(d))
    return str(d), emb


def test_interaction_equals_two_tower_at_init(bi_artifact):
    weights_dir, bi = bi_artifact
    ce_cfg = CrossEncoderConfig(
        dim=32, n_heads=2, n_layers=2, max_len=224, n_experts=2,
        dtype=jnp.float32, head_type="interaction",
    )
    params = warm_start_params(ce_cfg, weights_dir)
    queries = ["what did they say about vote xkcdqa", "find prices"]
    docs = ["xkcdqa election senate campaign on the show",
            "inflation market interest rates discussion"]
    for q in queries:
        toks, masks = zip(*(tokenize_pair(q, d, ce_cfg.max_len) for d in docs))
        logits = np.asarray(
            forward(params, jnp.asarray(np.stack(toks)),
                    jnp.asarray(np.stack(masks)), ce_cfg)
        )
        embs = bi([q] + docs)
        want = bi.cfg.temperature * (embs[1:] @ embs[0])
        np.testing.assert_allclose(logits, want, rtol=1e-4, atol=1e-4)


def test_config_json_roundtrip(bi_artifact, tmp_path):
    """TrainedEmbedder.save writes config.json; loading with a WRONG
    caller cfg still reconstructs the saved geometry (the r2 shipped
    artifact crashed here)."""
    weights_dir, bi = bi_artifact
    loaded = TrainedEmbedder(weights_dir=weights_dir)  # no cfg given
    assert loaded.cfg.tower.dim == 32
    v1 = bi(["hello world"])
    v2 = loaded(["hello world"])
    np.testing.assert_allclose(v1, v2, rtol=1e-5, atol=1e-6)


def test_warm_started_reranker_beats_cosine_hash():
    """The production claim: a (warm-started) trained cross-encoder
    ranks far better than the classical cosine fallback on held-out
    episodes.  Uses the SHIPPED artifact; skips if absent."""
    import os

    from qrag_tpu.models.cross_encoder import CrossEncoderScorer
    from qrag_tpu.pipeline.embeddings import HashEmbedder

    if not os.path.isdir("artifacts/bi_encoder"):
        pytest.skip("shipped bi-encoder artifact not present")
    cfg = RerankEvalConfig(
        n_episodes=16, chunks_per_episode=4, candidates=16,
        queries_per_chunk=2,
    )
    chunks = generate_corpus(16, 4, seed=0)
    _, hold_idx = split_by_episode(chunks, 0.25, seed=1)
    cases = _eval_cases(cfg, chunks, hold_idx)
    ce_cfg = _make_cfg(cfg)
    scorer = CrossEncoderScorer(
        ce_cfg, params=warm_start_params(ce_cfg, "artifacts/bi_encoder")
    )
    ours = eval_ranker(scorer.score, chunks, cases)
    cosine = eval_ranker(
        _cosine_scorer(HashEmbedder(dim=256)), chunks, cases
    )
    assert ours["ndcg@10"] > cosine["ndcg@10"] + 0.2, (ours, cosine)
    assert ours["top1"] > cosine["top1"] + 0.2, (ours, cosine)


def test_shipped_cross_encoder_loads_via_classical_config():
    """The shipped fine-tuned weights load through the
    ClassicalReranker's cache layout (config.json sidecar rebuilds the
    interaction geometry) and rank a rare-token match above an
    off-topic doc."""
    import os

    from qrag_tpu.config import ClassicalConfig
    from qrag_tpu.models.cross_encoder import CrossEncoderScorer

    if not os.path.isfile("artifacts/cross_encoder/params.npz"):
        pytest.skip("shipped cross-encoder artifact not present")
    cc = ClassicalConfig(
        method="cross-encoder",
        model_cache_dir="artifacts",
        model_name="cross_encoder",
    )
    scorer = CrossEncoderScorer.from_config(cc)
    assert scorer.cfg.head_type == "interaction"
    assert scorer.cfg.dim == 128
    s = scorer.score(
        "what did they say about vote xkcdqa",
        ["xkcdqa election senate campaign", "inflation market rates"],
    )
    assert s[0] > s[1]


def test_distill_aux_finetune_and_curve(bi_artifact):
    """The round-4 combined objective (listwise CE + fidelity-distill
    MSE over the same in-batch pair matrix): steps run, loss is
    finite, the aux term actually changes the trajectory vs
    distill_weight=0, and the quality-curve hook fires at the
    configured cadence."""
    from qrag_tpu.models.rerank_eval import train_cross_encoder

    weights_dir, _ = bi_artifact
    chunks = generate_corpus(8, 4, seed=0)
    train_idx, _ = split_by_episode(chunks, 0.25, seed=1)
    base = dict(
        n_episodes=8, chunks_per_episode=4, steps=2, batch=4,
        init_from=weights_dir, dim=32, heads=2, n_experts=2,
        max_len=128,
    )
    cfg0 = RerankEvalConfig(**base)
    cfg1 = RerankEvalConfig(**base, distill_weight=1.0, curve_every=2)
    s0, l0 = train_cross_encoder(cfg0, chunks, train_idx)
    seen = []
    s1, l1 = train_cross_encoder(
        cfg1, chunks, train_idx,
        hook=lambda at, sc: seen.append((at, sc)),
    )
    assert all(np.isfinite(l) for _, l in l0 + l1)
    # the aux MSE is part of the reported loss, so trajectories differ
    assert l0[0][1] != l1[0][1]
    assert [at for at, _ in seen] == [2]
    # hook receives a usable scorer
    s = seen[0][1].score("find prices", ["a doc", "another doc"])
    assert np.all(np.isfinite(np.asarray(s)))


def test_distill_aux_requires_warm_start():
    from qrag_tpu.models.rerank_eval import train_cross_encoder

    chunks = generate_corpus(8, 4, seed=0)
    train_idx, _ = split_by_episode(chunks, 0.25, seed=1)
    cfg = RerankEvalConfig(
        n_episodes=8, chunks_per_episode=4, steps=1, batch=4,
        init_from=None, dim=32, heads=2, n_experts=2, max_len=128,
        distill_weight=0.5,
    )
    with pytest.raises(ValueError, match="distill_weight"):
        train_cross_encoder(cfg, chunks, train_idx)


def test_finetune_step_runs():
    """One in-batch listwise step on the warm start: finite loss,
    parameters move, gates stay finite."""
    from qrag_tpu.models.rerank_eval import train_cross_encoder

    chunks = generate_corpus(8, 4, seed=0)
    train_idx, _ = split_by_episode(chunks, 0.25, seed=1)
    cfg = RerankEvalConfig(
        n_episodes=8, chunks_per_episode=4, steps=2, batch=4,
        init_from=None, dim=32, heads=2, n_experts=2, max_len=128,
    )
    scorer, losses = train_cross_encoder(cfg, chunks, train_idx)
    assert all(np.isfinite(l) for _, l in losses)
    g = float(np.asarray(scorer.params["layers"][0]["xgate"]))
    assert np.isfinite(g)
