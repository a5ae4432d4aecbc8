"""Rerank-quality eval of a DISTILLED cross-encoder vs the shipped one:
report rerank_eval top-1/MRR/nDCG@10 against the fine-tuned
cross-encoder, then ship or reject.

Uses the SAME protocol as models/rerank_eval.run_eval: the full
transcript corpus, episode-held-out eval cases with same-topic hard
distractors — so numbers are directly comparable with its table.

    python scripts/eval_distilled.py --weights /tmp/distilled_student
"""

import argparse
import json
import sys

sys.path.insert(0, ".")

from qrag_tpu.models.cross_encoder import CrossEncoderScorer  # noqa: E402
from qrag_tpu.models.rerank_eval import (  # noqa: E402
    RerankEvalConfig,
    _cosine_scorer,
    _eval_cases,
    eval_ranker,
)
from qrag_tpu.pipeline.corpus_gen import (  # noqa: E402
    generate_corpus,
    split_by_episode,
)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", required=True, help="distilled student dir")
    p.add_argument("--baseline", default="artifacts/cross_encoder")
    p.add_argument("--bi", default="artifacts/bi_encoder")
    p.add_argument(
        "--val", action="store_true",
        help="evaluate on the TRAIN-episode validation slice (fresh "
        "seed) instead of the held-out episodes — the slice SHIP "
        "decisions must use (no held-out peeking; rerank_eval r3 "
        "protocol)",
    )
    args = p.parse_args(argv)

    cfg = RerankEvalConfig()
    chunks = generate_corpus(
        cfg.n_episodes, cfg.chunks_per_episode, seed=cfg.seed
    )
    train_idx, hold_idx = split_by_episode(
        chunks, cfg.holdout_frac, seed=cfg.seed + 1
    )
    if args.val:
        cases = _eval_cases(chunks=chunks, cfg=cfg,
                            hold_idx=train_idx[: len(hold_idx)], seed=29)
    else:
        cases = _eval_cases(cfg, chunks, hold_idx)

    out = {"cases": len(cases)}
    for name, d in (
        ("distilled_student", args.weights),
        ("shipped_cross_encoder", args.baseline),
    ):
        sc = CrossEncoderScorer()
        sc.load(d)
        out[name] = eval_ranker(sc.score, chunks, cases)
    try:
        from qrag_tpu.models.bi_encoder import TrainedEmbedder

        bi = TrainedEmbedder(weights_dir=args.bi)
        out["cosine_trained_bi_encoder"] = eval_ranker(
            _cosine_scorer(bi), chunks, cases
        )
    except Exception as e:  # noqa: BLE001 - baseline optional
        out["cosine_trained_bi_encoder"] = f"unavailable: {e}"
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
