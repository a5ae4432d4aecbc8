"""Train the cross-encoder reranker: ``python -m qrag_tpu.models.train_cli``.

The reference downloads a pretrained torch CrossEncoder at service
startup (``classical.py:79-153``); this environment trains the JAX
cross-encoder instead and saves weights where the classical reranker's
"cross-encoder" method loads them (``model_cache_dir/<model_name>/
params.npz`` — the same local-cache-preferred contract,
``classical.py:82-99``).

Data: JSONL of ``{"query": ..., "doc": ..., "label": 0|1}`` via
--data, or the synthetic relevance task.  Training is sharded over all
visible devices (DP x TP/EP via the mesh trainer); checkpoints resume
with --resume.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Iterator, List, Tuple

import numpy as np


def _jsonl_batches(
    path: str, batch: int, max_len: int, rng: np.random.RandomState
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    from qrag_tpu.models.cross_encoder import tokenize_pair

    rows: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    if not rows:
        raise ValueError(f"{path}: no training rows")
    while True:
        picks = rng.choice(len(rows), size=batch)
        toks, masks, labels = [], [], []
        for i in picks:
            r = rows[i]
            t, m = tokenize_pair(str(r["query"]), str(r["doc"]), max_len)
            toks.append(t)
            masks.append(m)
            labels.append(float(r["label"]))
        yield np.stack(toks), np.stack(masks), np.asarray(labels, np.float32)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="train the qrag cross-encoder")
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--dim", type=int, default=128)
    parser.add_argument("--heads", type=int, default=4)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--experts", type=int, default=4)
    parser.add_argument("--max-len", type=int, default=128)
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--data", default=None, help="JSONL {query,doc,label}")
    parser.add_argument(
        "--out", default="cross_encoder/qrag-cross-encoder-tiny"
    )
    parser.add_argument("--resume", default=None, help="checkpoint dir")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    from qrag_tpu.utils.compilation_cache import enable_compilation_cache

    enable_compilation_cache()

    import jax
    from qrag_tpu.platform import compute_dtype
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from qrag_tpu.models.checkpoint import load_train_state, save_train_state
    from qrag_tpu.models.cross_encoder import (
        CrossEncoderConfig,
        CrossEncoderScorer,
    )
    from qrag_tpu.parallel.mesh import make_mesh
    from qrag_tpu.parallel.train import make_sharded_trainer, synthetic_batch

    cfg = CrossEncoderConfig(
        dim=args.dim,
        n_heads=args.heads,
        n_layers=args.layers,
        n_experts=args.experts,
        max_len=args.max_len,
        remat=args.remat,
        dtype=compute_dtype(),
    )
    # model-axis size must divide the sharded param dims (experts,
    # attention heads / FFN hidden); put the rest on "data"
    import math

    n_dev = len(jax.devices())
    shardable = args.experts if args.experts > 0 else args.heads
    mp = math.gcd(n_dev, shardable)
    from qrag_tpu.config import MeshConfig

    mesh = make_mesh(MeshConfig(data_parallel=n_dev // mp, model_parallel=mp))
    print(f"mesh: data={n_dev // mp} x model={mp} over {n_dev} devices")
    params, opt_state, step_fn, batch_sh = make_sharded_trainer(
        cfg, mesh, learning_rate=args.lr, seed=args.seed
    )
    start_step = 0
    if args.resume:
        params, opt_state, start_step, _ = load_train_state(
            args.resume, params, opt_state
        )
        print(f"resumed from {args.resume} at step {start_step}")

    rng = np.random.RandomState(args.seed)
    data_iter = (
        _jsonl_batches(args.data, args.batch, cfg.max_len, rng)
        if args.data
        else None
    )
    t0 = time.time()
    loss = float("nan")
    for step in range(start_step, start_step + args.steps):
        if data_iter is not None:
            toks, masks, labels = next(data_iter)
        else:
            toks, masks, labels = synthetic_batch(rng, args.batch, cfg.max_len)
        toks = jax.device_put(jnp.asarray(toks), batch_sh)
        masks = jax.device_put(jnp.asarray(masks), batch_sh)
        labels_d = jax.device_put(
            jnp.asarray(labels), NamedSharding(mesh, P("data"))
        )
        params, opt_state, loss = step_fn(params, opt_state, toks, masks, labels_d)
        if (step + 1) % 20 == 0 or step == start_step:
            print(
                f"step {step + 1}: loss {float(loss):.4f} "
                f"({(time.time() - t0):.1f}s)"
            )

    final_step = start_step + args.steps
    # inference weights where ClassicalReranker's cross-encoder method
    # looks for them
    host_params = jax.tree_util.tree_map(lambda x: np.asarray(x), params)
    scorer = CrossEncoderScorer(cfg, params=host_params)
    scorer.save(args.out)
    # resumable training state
    save_train_state(args.out + ".ckpt", params, opt_state, final_step, cfg)
    print(
        f"trained to step {final_step} (loss {float(loss):.4f}); "
        f"weights -> {args.out}, checkpoint -> {args.out}.ckpt"
    )


if __name__ == "__main__":
    main()
