"""Sharded training for the cross-encoder (DP x TP/EP over the mesh).

GSPMD style: parameters are placed with explicit NamedShardings from
``models.cross_encoder.partition_spec`` (attention/FFN/experts on
"model", batch on "data"); the optimizer state inherits the parameter
shardings by propagation; one ``jax.jit`` compiles the whole step and
XLA inserts the collectives (psum of grads over "data", activation
collectives over "model").
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from qrag_tpu.models.cross_encoder import (
    CrossEncoderConfig,
    init_params,
    make_train_step,
    partition_spec,
    tokenize_pair,
)
from qrag_tpu.parallel.mesh import DATA_AXIS


def shard_params(params: Dict[str, Any], cfg: CrossEncoderConfig, mesh: Mesh):
    """Place the parameter pytree according to partition_spec."""
    specs = partition_spec(cfg)
    return jax.tree_util.tree_map(
        lambda p, s: jax.device_put(p, NamedSharding(mesh, s)),
        params,
        specs,
        is_leaf=lambda x: isinstance(x, P),
    )


def make_sharded_trainer(
    cfg: CrossEncoderConfig,
    mesh: Mesh,
    learning_rate: float = 3e-4,
    seed: int = 0,
):
    """Returns (params, opt_state, step_fn, batch_sharding).

    step_fn(params, opt_state, tokens, mask, labels) -> (params,
    opt_state, loss) — fully jit-compiled over the mesh.
    """
    optimizer = optax.adamw(learning_rate)
    params = shard_params(init_params(jax.random.PRNGKey(seed), cfg), cfg, mesh)
    opt_state = jax.jit(optimizer.init)(params)
    step = jax.jit(make_train_step(cfg, optimizer), donate_argnums=(0, 1))
    batch_sharding = NamedSharding(mesh, P(DATA_AXIS, None))
    return params, opt_state, step, batch_sharding


# --------------------------------------------------------- synthetic data

_WORDS = [
    "podcast", "advert", "sponsor", "deal", "politics", "sport", "brand",
    "morgan", "episode", "interview", "discount", "news", "product",
    "climate", "music", "health", "money", "offer", "guest", "debate",
]


def synthetic_batch(
    rng: np.random.RandomState, batch: int, max_len: int = 128
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic relevance task: positive docs contain the query's
    words, negatives are disjoint word samples.  Labels 0/1."""
    toks, masks, labels = [], [], []
    for _ in range(batch):
        qw = list(rng.choice(_WORDS, size=3, replace=False))
        pos = rng.rand() < 0.5
        if pos:
            dw = qw + list(rng.choice(_WORDS, size=5))
            rng.shuffle(dw)
        else:
            rest = [w for w in _WORDS if w not in qw]
            dw = list(rng.choice(rest, size=8))
        t, m = tokenize_pair(" ".join(qw), " ".join(dw), max_len)
        toks.append(t)
        masks.append(m)
        labels.append(1.0 if pos else 0.0)
    return (
        np.stack(toks),
        np.stack(masks),
        np.asarray(labels, np.float32),
    )


def train_demo(
    cfg: Optional[CrossEncoderConfig] = None,
    mesh: Optional[Mesh] = None,
    steps: int = 20,
    batch: int = 32,
    seed: int = 0,
) -> float:
    """Short sharded training run; returns the final loss (used by
    tests to assert learning and by the multichip dry run)."""
    from qrag_tpu.parallel.mesh import make_mesh

    cfg = cfg or CrossEncoderConfig(dim=64, n_heads=4, n_layers=2, max_len=128)
    mesh = mesh or make_mesh()
    params, opt_state, step, batch_sh = make_sharded_trainer(cfg, mesh)
    rng = np.random.RandomState(seed)
    loss = float("nan")
    for _ in range(steps):
        toks, masks, labels = synthetic_batch(rng, batch, cfg.max_len)
        toks = jax.device_put(jnp.asarray(toks), batch_sh)
        masks = jax.device_put(jnp.asarray(masks), batch_sh)
        labels_d = jax.device_put(
            jnp.asarray(labels), NamedSharding(mesh, P(DATA_AXIS))
        )
        params, opt_state, loss = step(params, opt_state, toks, masks, labels_d)
    return float(loss)
