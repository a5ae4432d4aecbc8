"""Bi-encoder (two-tower) embedding model — the second model family.

The reference gets its index vectors from the OpenAI embeddings API
(``mcp/server/tools/fetch_embeddings.py:33-37``) and its rerank scores
from a pretrained cross-encoder; with no network access, this module
closes the loop in-framework: a trainable JAX text encoder producing
the unit-norm vectors the flat index stores and scans.

Architecture: the cross-encoder's transformer blocks (shared code —
byte tokenizer, pre-LN attention, MoE/dense FFN) with masked mean
pooling and a linear projection to ``out_dim``, L2-normalized.
Training: in-batch-negatives contrastive loss (InfoNCE) over
(query, positive-doc) pairs — logits = τ·QDᵀ, labels = diagonal —
the standard dense-retrieval recipe.  Shards like the cross-encoder
(batch on "data", heads/FFN/experts on "model").

`TrainedEmbedder` adapts trained weights to the pipeline's embedder
interface (``pipeline/embeddings.py``), so `QragEngine`,
`FetchEmbeddingsTool` and the MCP pipeline can ingest and query with
learned embeddings (config ``embedding.provider="trained"``).
"""

from __future__ import annotations

import functools
import math
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from qrag_tpu.models.cross_encoder import (
    CrossEncoderConfig,
    PAD_ID,
    _block,
    _init_linear,
    _layer_norm,
    init_params as _init_tower_params,
    partition_spec as _tower_partition_spec,
)
from qrag_tpu.platform import compute_dtype


@dataclass
class BiEncoderConfig:
    tower: CrossEncoderConfig = field(
        default_factory=lambda: CrossEncoderConfig(max_len=128)
    )
    out_dim: int = 256
    temperature: float = 20.0  # InfoNCE logit scale


def tokenize_texts(
    texts: Sequence[str], max_len: int = 128
) -> Tuple[np.ndarray, np.ndarray]:
    """Byte tokens + mask for single texts (no CLS/SEP framing —
    the towers see raw byte sequences)."""
    toks, masks = [], []
    for t in texts:
        ids = list(t.encode("utf-8"))[:max_len]
        mask = [1.0] * len(ids)
        pad = max_len - len(ids)
        toks.append(np.asarray(ids + [PAD_ID] * pad, np.int32))
        masks.append(np.asarray(mask + [0.0] * pad, np.float32))
    return np.stack(toks), np.stack(masks)


def init_params(key: jax.Array, cfg: BiEncoderConfig) -> Dict[str, Any]:
    k_tower, k_proj = jax.random.split(key)
    params = _init_tower_params(k_tower, cfg.tower)
    del params["head"]  # towers pool, they don't classify
    params["proj"] = _init_linear(k_proj, cfg.tower.dim, cfg.out_dim)
    return params


def partition_spec(cfg: BiEncoderConfig) -> Dict[str, Any]:
    spec = _tower_partition_spec(cfg.tower)
    del spec["head"]
    spec["proj"] = {"w": P(), "b": P()}
    return spec


def encode(
    params: Dict[str, Any],
    tokens: jnp.ndarray,  # (B, T)
    mask: jnp.ndarray,  # (B, T)
    cfg: BiEncoderConfig,
) -> jnp.ndarray:
    """Unit-norm embeddings (B, out_dim)."""
    t_cfg = cfg.tower
    x = params["tok_emb"][tokens] + params["pos_emb"][None, : tokens.shape[1]]
    x = x.astype(t_cfg.dtype)
    block = functools.partial(
        _block, n_heads=t_cfg.n_heads, dtype=t_cfg.dtype
    )
    if t_cfg.remat:
        block = jax.checkpoint(block)
    for layer in params["layers"]:
        x = block(layer, x, mask)
    x = _layer_norm(
        x.astype(jnp.float32), params["final_ln"]["g"], params["final_ln"]["b"]
    )
    # masked mean pooling
    m = mask[..., None]
    pooled = jnp.sum(x * m, axis=1) / jnp.clip(jnp.sum(m, axis=1), 1e-6)
    emb = (
        jnp.dot(pooled, params["proj"]["w"], preferred_element_type=jnp.float32)
        + params["proj"]["b"]
    )
    return emb / jnp.clip(jnp.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)


def info_nce_loss(
    params,
    q_tokens,
    q_mask,
    d_tokens,
    d_mask,
    cfg: BiEncoderConfig,
) -> jnp.ndarray:
    """In-batch negatives: row i's positive is column i."""
    q = encode(params, q_tokens, q_mask, cfg)  # (B, D)
    d = encode(params, d_tokens, d_mask, cfg)
    logits = cfg.temperature * jnp.dot(
        q, d.T, preferred_element_type=jnp.float32
    )
    labels = jnp.arange(logits.shape[0])
    # symmetric InfoNCE (query->doc and doc->query)
    ce_qd = -jnp.mean(
        jax.nn.log_softmax(logits, axis=1)[labels, labels]
    )
    ce_dq = -jnp.mean(
        jax.nn.log_softmax(logits, axis=0)[labels, labels]
    )
    return 0.5 * (ce_qd + ce_dq)


def make_train_step(cfg: BiEncoderConfig, optimizer):
    def train_step(params, opt_state, q_tokens, q_mask, d_tokens, d_mask):
        loss, grads = jax.value_and_grad(info_nce_loss)(
            params, q_tokens, q_mask, d_tokens, d_mask, cfg
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        return params, opt_state, loss

    return train_step


# ---------------------------------------------------------------- embedder


class TrainedEmbedder:
    """Pipeline embedder backed by trained bi-encoder weights
    (interface of ``pipeline/embeddings.py``: texts → (N, dim) f32)."""

    def __init__(
        self,
        cfg: Optional[BiEncoderConfig] = None,
        params: Optional[Dict[str, Any]] = None,
        weights_dir: Optional[str] = None,
        seed: int = 0,
        batch_size: int = 64,
    ):
        # a weights dir's config.json is authoritative for the tower
        # geometry — without it a caller-supplied cfg with different
        # dims crashes the npz unflatten (r2's shipped artifact bug)
        if weights_dir:
            saved = _load_config(weights_dir)
            if saved is not None:
                cfg = saved
        if cfg is None:
            cfg = BiEncoderConfig(
                tower=CrossEncoderConfig(
                    max_len=128,
                    dtype=compute_dtype(),
                )
            )
        self.cfg = cfg
        self.dim = cfg.out_dim
        self.batch_size = batch_size
        self.params = (
            params
            if params is not None
            else init_params(jax.random.PRNGKey(seed), cfg)
        )
        if weights_dir:
            self.load(weights_dir)
        self._encode = jax.jit(functools.partial(encode, cfg=cfg))

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        out = []
        bs = self.batch_size
        for i in range(0, len(texts), bs):
            chunk = list(texts[i : i + bs])
            n = len(chunk)
            # pad to a power-of-two bucket (few compiled shapes without
            # paying a full batch_size forward for single queries)
            bucket = 1 << max(2, (n - 1).bit_length())
            chunk = chunk + [""] * (bucket - n)
            toks, mask = tokenize_texts(chunk, self.cfg.tower.max_len)
            mask[:, 0] = 1.0  # empty strings: avoid all-zero masks
            emb = self._encode(self.params, jnp.asarray(toks), jnp.asarray(mask))
            out.append(np.asarray(emb, np.float32)[:n])
        return np.concatenate(out, axis=0)

    # -- persistence (same npz scheme as the cross-encoder scorer) -----

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        flat, _ = jax.tree_util.tree_flatten(self.params)
        np.savez(
            os.path.join(directory, "bi_encoder.npz"),
            **{f"p{i}": np.asarray(x) for i, x in enumerate(flat)},
        )
        import json

        t = self.cfg.tower
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(
                {
                    "tower": {
                        "vocab_size": t.vocab_size,
                        "max_len": t.max_len,
                        "dim": t.dim,
                        "n_heads": t.n_heads,
                        "n_layers": t.n_layers,
                        "mlp_ratio": t.mlp_ratio,
                        "n_experts": t.n_experts,
                    },
                    "out_dim": self.cfg.out_dim,
                    "temperature": self.cfg.temperature,
                },
                f,
                indent=2,
            )

    def load(self, directory: str) -> None:
        data = np.load(os.path.join(directory, "bi_encoder.npz"))
        flat, treedef = jax.tree_util.tree_flatten(self.params)
        self.params = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(data[f"p{i}"]) for i in range(len(flat))]
        )


def _load_config(directory: str) -> Optional[BiEncoderConfig]:
    """Read a saved config.json (runtime picks the dtype)."""
    import json

    path = os.path.join(directory, "config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    t = d.get("tower", {})
    return BiEncoderConfig(
        tower=CrossEncoderConfig(
            vocab_size=t.get("vocab_size", 259),
            max_len=t.get("max_len", 128),
            dim=t.get("dim", 256),
            n_heads=t.get("n_heads", 8),
            n_layers=t.get("n_layers", 4),
            mlp_ratio=t.get("mlp_ratio", 4),
            n_experts=t.get("n_experts", 4),
            dtype=compute_dtype(),
        ),
        out_dim=d.get("out_dim", 256),
        temperature=d.get("temperature", 20.0),
    )


def synthetic_pairs(
    rng: np.random.RandomState, batch: int, max_len: int = 128
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(query, positive doc) pairs from the shared synthetic task."""
    from qrag_tpu.parallel.train import _WORDS

    qs, ds = [], []
    for _ in range(batch):
        qw = list(rng.choice(_WORDS, size=3, replace=False))
        dw = qw + list(rng.choice(_WORDS, size=5))
        rng.shuffle(dw)
        qs.append(" ".join(qw))
        ds.append(" ".join(dw))
    qt, qm = tokenize_texts(qs, max_len)
    dt, dm = tokenize_texts(ds, max_len)
    return qt, qm, dt, dm
