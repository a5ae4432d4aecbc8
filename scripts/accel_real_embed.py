"""Clustered-accel evidence on REAL learned-embedding geometry.

Embeds a generated transcript corpus with the TRAINED bi-encoder
artifact and measures the cluster-pruned exact accelerator's
exactness + certificate-tier usage.

    JAX_PLATFORMS=cpu python scripts/accel_real_embed.py [--episodes 768]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")

import numpy as np

from qrag_tpu.utils.compilation_cache import enable_compilation_cache

enable_compilation_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--episodes", type=int, default=768)
    p.add_argument("--group-rows", type=int, default=128)
    p.add_argument("--queries", type=int, default=64)
    p.add_argument("--weights", default="artifacts/bi_encoder")
    args = p.parse_args()

    from qrag_tpu.models.bi_encoder import TrainedEmbedder
    from qrag_tpu.ops.cluster_topk import (
        build_clustered_groups,
        cluster_pruned_topk,
    )
    from qrag_tpu.ops.topk import _goodness
    from qrag_tpu.pipeline.corpus_gen import generate_corpus, make_query

    chunks = generate_corpus(
        n_episodes=args.episodes, chunks_per_episode=8, seed=3
    )
    emb = TrainedEmbedder(weights_dir=args.weights)
    t0 = time.time()
    X = emb([c.text for c in chunks])
    print(f"embedded {X.shape} in {time.time()-t0:.0f}s", flush=True)

    groups = build_clustered_groups(
        jnp.asarray(X), group_rows=args.group_rows, kmeans_iters=6
    )
    radii = np.asarray(groups.radii)
    print(
        f"groups G={groups.centroids.shape[0]} radii mean/p90 "
        f"{radii.mean():.3f}/{np.quantile(radii, 0.9):.3f}",
        flush=True,
    )

    rng = np.random.RandomState(0)
    qs = [
        make_query(chunks[i], rng)
        for i in rng.randint(0, len(chunks), args.queries)
    ]
    Q = emb(qs)
    fb_n = esc_n = ok_n = total = 0
    for i in range(0, args.queries, 8):
        q = jnp.asarray(Q[i : i + 8])
        vals, idx, fb, esc = cluster_pruned_topk(q, groups, 10)
        g = _goodness(q, jnp.asarray(X), "l2", None, None)
        _, oi = jax.lax.top_k(g, 10)
        ok_n += int(np.sum(np.asarray(idx) == np.asarray(oi)))
        total += idx.size
        fb_n += int(np.asarray(fb))
        esc_n += int(np.asarray(esc))
    batches = args.queries // 8
    print(
        f"real-embedding accel: {ok_n}/{total} oracle-identical hits, "
        f"fallback batches {fb_n}/{batches}, escalated {esc_n}/{batches}",
        flush=True,
    )


if __name__ == "__main__":
    main()
