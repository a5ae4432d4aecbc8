"""JAX cross-encoder — the trainable reranking model.

The reference scores (query, document) pairs with a pretrained torch
CrossEncoder (``src/reranker/classical.py:45-77``, model
``cross-encoder/ms-marco-MiniLM-L-6-v2``, 512-token inputs, batch 32).
This environment has no weight downloads, so the JAX counterpart
is a from-scratch transformer cross-encoder trained on-device:

  * byte-level tokenizer (no external vocab), CLS/SEP framing:
    ``[CLS] query [SEP] document [SEP]`` — the classic cross-encoder
    input layout;
  * pre-LN transformer with a mixture-of-experts FFN block — the MoE
    router is the learned generalization of the reference's
    quantum-vs-classical expert dispatch (``controller.py:42-67`` is a
    hand-written 2-expert router; SURVEY.md §2 maps it to EP);
  * bf16 activations / f32 parameters + optimizer, pointwise BCE
    relevance loss, adamw;
  * explicit sharding rules over a ("data", "model") mesh: batch on
    "data" (DP), attention heads + FFN hidden + experts on "model"
    (TP/EP).  See `partition_spec` and `qrag_tpu/parallel/mesh.py`.

Everything is a plain pytree + pure functions — jit/grad/shard_map
compose without framework wrappers.
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

from qrag_tpu.platform import compute_dtype

# ---------------------------------------------------------------- tokenizer

PAD_ID = 256
CLS_ID = 257
SEP_ID = 258
VOCAB_SIZE = 259


def tokenize_pair(
    query: str, doc: str, max_len: int = 256
) -> Tuple[np.ndarray, np.ndarray]:
    """``[CLS] query [SEP] doc [SEP]`` byte tokens + attention mask."""
    q = list(query.encode("utf-8"))
    d = list(doc.encode("utf-8"))
    budget = max_len - 3
    q = q[: budget // 2]
    d = d[: budget - len(q)]
    ids = [CLS_ID] + q + [SEP_ID] + d + [SEP_ID]
    ids = ids[:max_len]
    mask = [1] * len(ids)
    pad = max_len - len(ids)
    ids = ids + [PAD_ID] * pad
    mask = mask + [0] * pad
    return np.asarray(ids, np.int32), np.asarray(mask, np.float32)


def tokenize_batch(
    query: str, docs: Sequence[str], max_len: int = 256
) -> Tuple[np.ndarray, np.ndarray]:
    toks, masks = zip(*(tokenize_pair(query, d, max_len) for d in docs))
    return np.stack(toks), np.stack(masks)


# ------------------------------------------------------------------- config


@dataclass
class CrossEncoderConfig:
    vocab_size: int = VOCAB_SIZE
    max_len: int = 256
    dim: int = 256
    n_heads: int = 8
    n_layers: int = 4
    mlp_ratio: int = 4
    n_experts: int = 4  # MoE FFN experts (EP axis); 0 = dense FFN
    dropout: float = 0.0  # (not used at score time)
    dtype: Any = jnp.bfloat16
    # rematerialize each block's activations in backward (trade FLOPs
    # for HBM — jax.checkpoint per layer)
    remat: bool = False
    # Scoring head / architecture variant.
    #
    # "cls": linear on the CLS vector (the classic cross-encoder
    # readout).
    #
    # "interaction": the GATED cross-attention variant
    # (models/rerank_eval.py).  Query and document segments get
    # per-segment positions and segment-restricted attention, so a
    # WARM-STARTED model (``warm_start_params``, which copies the
    # bi-encoder tower and ZEROES the CLS head) is exactly the
    # two-tower bi-encoder run in one sequence (equivalence tested to
    # 1e-5).  ``init_params`` alone does NOT have this property — it
    # gives the CLS head random weights, so the readout carries a
    # random logit on top of the cosine.  Each layer adds a tanh-gated
    # cross-segment attention term initialized CLOSED (alpha=0, unit
    # gradient), so fine-tuning opens early interaction only where it
    # helps.  Readout: tau * cosine(segment pools through iproj)
    # + a zero-init CLS logit.  The fixed logit scale mirrors
    # BiEncoderConfig.temperature.
    head_type: str = "cls"
    interaction_temp: float = 20.0


# ------------------------------------------------------------------- params


def _init_linear(key, d_in, d_out, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return {
        "w": jax.random.normal(key, (d_in, d_out), jnp.float32) * scale,
        "b": jnp.zeros((d_out,), jnp.float32),
    }


def init_params(key: jax.Array, cfg: CrossEncoderConfig) -> Dict[str, Any]:
    keys = iter(jax.random.split(key, 16 + cfg.n_layers * 16))
    params: Dict[str, Any] = {
        "tok_emb": jax.random.normal(
            next(keys), (cfg.vocab_size, cfg.dim), jnp.float32
        )
        * 0.02,
        "pos_emb": jax.random.normal(
            next(keys), (cfg.max_len, cfg.dim), jnp.float32
        )
        * 0.02,
        "final_ln": {"g": jnp.ones((cfg.dim,)), "b": jnp.zeros((cfg.dim,))},
        "head": _init_linear(next(keys), cfg.dim, 1),
        "layers": [],
    }
    if cfg.head_type == "interaction":
        # segment-pool projection (see forward): without it the pooled
        # LN features share a dominant common mode and every pair's
        # cosine starts ~1 — the projection is what lets the
        # similarity head separate (the bi-encoder's proj plays the
        # same role, bi_encoder.py:75)
        params["iproj"] = _init_linear(next(keys), cfg.dim, cfg.dim)
    hidden = cfg.dim * cfg.mlp_ratio
    for _ in range(cfg.n_layers):
        lk = iter(jax.random.split(next(keys), 10))
        layer = {
            "ln1": {"g": jnp.ones((cfg.dim,)), "b": jnp.zeros((cfg.dim,))},
            "ln2": {"g": jnp.ones((cfg.dim,)), "b": jnp.zeros((cfg.dim,))},
            "attn": {
                "qkv": _init_linear(next(lk), cfg.dim, 3 * cfg.dim),
                "out": _init_linear(next(lk), cfg.dim, cfg.dim),
            },
        }
        if cfg.head_type == "interaction":
            # per-layer cross-segment attention gate, CLOSED at init
            layer["xgate"] = jnp.zeros((), jnp.float32)
        if cfg.n_experts > 0:
            ek = jax.random.split(next(lk), 2)
            layer["moe"] = {
                "router": _init_linear(next(lk), cfg.dim, cfg.n_experts),
                # experts stacked on a leading axis (sharded on "model")
                "w1": jax.random.normal(
                    ek[0], (cfg.n_experts, cfg.dim, hidden), jnp.float32
                )
                / math.sqrt(cfg.dim),
                "b1": jnp.zeros((cfg.n_experts, hidden), jnp.float32),
                "w2": jax.random.normal(
                    ek[1], (cfg.n_experts, hidden, cfg.dim), jnp.float32
                )
                / math.sqrt(hidden),
                "b2": jnp.zeros((cfg.n_experts, cfg.dim), jnp.float32),
            }
        else:
            layer["mlp"] = {
                "w1": _init_linear(next(lk), cfg.dim, hidden),
                "w2": _init_linear(next(lk), hidden, cfg.dim),
            }
        params["layers"].append(layer)
    return params


def partition_spec(cfg: CrossEncoderConfig) -> Dict[str, Any]:
    """PartitionSpecs mirroring init_params' tree.

    TP: attention qkv/out and FFN hidden sharded on "model".
    EP: the experts' leading axis sharded on "model" (experts live on
    different chips; routing happens via the sharded einsum).
    """
    layer_spec = {
        "ln1": {"g": P(), "b": P()},
        "ln2": {"g": P(), "b": P()},
        "attn": {
            "qkv": {"w": P(None, "model"), "b": P("model")},
            "out": {"w": P("model", None), "b": P()},
        },
    }
    if cfg.head_type == "interaction":
        layer_spec["xgate"] = P()
    if cfg.n_experts > 0:
        layer_spec["moe"] = {
            "router": {"w": P(), "b": P()},
            "w1": P("model", None, None),
            "b1": P("model", None),
            "w2": P("model", None, None),
            "b2": P("model", None),
        }
    else:
        layer_spec["mlp"] = {
            "w1": {"w": P(None, "model"), "b": P("model")},
            "w2": {"w": P("model", None), "b": P()},
        }
    spec = {
        "tok_emb": P(),
        "pos_emb": P(),
        "final_ln": {"g": P(), "b": P()},
        "head": {"w": P(), "b": P()},
        "layers": [layer_spec] * cfg.n_layers,
    }
    if cfg.head_type == "interaction":
        spec["iproj"] = {"w": P(), "b": P()}
    return spec


# ------------------------------------------------------------------ forward


def _layer_norm(x, g, b, eps=1e-5):
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    return (x - mu) * jax.lax.rsqrt(var + eps) * g + b


def _linear(p, x):
    return (
        jnp.dot(x, p["w"].astype(x.dtype), preferred_element_type=jnp.float32)
        + p["b"]
    ).astype(x.dtype)


def _attention(p, x, mask, n_heads):
    b, t, d = x.shape
    qkv = _linear(p["qkv"], x)  # (b, t, 3d)
    q, k, v = jnp.split(qkv, 3, axis=-1)
    hd = d // n_heads

    def heads(z):
        return z.reshape(b, t, n_heads, hd).transpose(0, 2, 1, 3)

    q, k, v = heads(q), heads(k), heads(v)
    scores = jnp.einsum(
        "bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32
    ) / math.sqrt(hd)
    neg = jnp.asarray(-1e9, scores.dtype)
    scores = jnp.where(mask[:, None, None, :] > 0, scores, neg)
    att = jax.nn.softmax(scores, axis=-1).astype(x.dtype)
    out = jnp.einsum("bhqk,bhkd->bhqd", att, v, preferred_element_type=jnp.float32)
    out = out.astype(x.dtype).transpose(0, 2, 1, 3).reshape(b, t, d)
    return _linear(p["out"], out)


def _attention_pair(p, x, allowed, n_heads):
    """Attention with an explicit (B, Tq, Tk) boolean allowed matrix
    (the interaction variant's segment-restricted / full passes share
    one qkv projection, so gating mixes OUTPUTS, not weights)."""
    b, t, d = x.shape
    qkv = _linear(p["qkv"], x)
    q, k, v = jnp.split(qkv, 3, axis=-1)
    hd = d // n_heads

    def heads(z):
        return z.reshape(b, t, n_heads, hd).transpose(0, 2, 1, 3)

    q, k, v = heads(q), heads(k), heads(v)
    scores = jnp.einsum(
        "bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32
    ) / math.sqrt(hd)
    neg = jnp.asarray(-1e9, scores.dtype)
    scores = jnp.where(allowed[:, None, :, :], scores, neg)
    att = jax.nn.softmax(scores, axis=-1).astype(x.dtype)
    out = jnp.einsum(
        "bhqk,bhkd->bhqd", att, v, preferred_element_type=jnp.float32
    )
    out = out.astype(x.dtype).transpose(0, 2, 1, 3).reshape(b, t, d)
    return _linear(p["out"], out)


def _moe_ffn(p, x):
    """Soft-routed MoE FFN (dense dispatch over a sharded expert axis).

    Tokens compute all experts via a sharded einsum over the expert
    axis (E on "model"); router weights mix the results.  This is the
    batched-einsum EP formulation — no host-side routing, XLA inserts
    the psum over the expert-sharded contraction.
    """
    b, t, d = x.shape
    gates = jax.nn.softmax(
        _linear(p["router"], x).astype(jnp.float32), axis=-1
    )  # (b, t, E)
    h = jnp.einsum(
        "btd,edh->beth", x, p["w1"].astype(x.dtype),
        preferred_element_type=jnp.float32,
    )
    h = jax.nn.gelu(h + p["b1"][None, :, None, :])
    y = jnp.einsum(
        "beth,ehd->betd", h.astype(x.dtype), p["w2"].astype(x.dtype),
        preferred_element_type=jnp.float32,
    )
    y = y + p["b2"][None, :, None, :]
    out = jnp.einsum("bte,betd->btd", gates, y.astype(jnp.float32))
    return out.astype(x.dtype)


def _dense_ffn(p, x):
    h = jax.nn.gelu(_linear(p["w1"], x).astype(jnp.float32)).astype(x.dtype)
    return _linear(p["w2"], h)


def _block(layer, x, mask, n_heads, dtype):
    h = _layer_norm(x.astype(jnp.float32), layer["ln1"]["g"], layer["ln1"]["b"])
    x = x + _attention(layer["attn"], h.astype(dtype), mask, n_heads)
    h = _layer_norm(x.astype(jnp.float32), layer["ln2"]["g"], layer["ln2"]["b"])
    h = h.astype(dtype)
    if "moe" in layer:
        return x + _moe_ffn(layer["moe"], h)
    return x + _dense_ffn(layer["mlp"], h)


def forward(
    params: Dict[str, Any],
    tokens: jnp.ndarray,  # (B, T) int32
    mask: jnp.ndarray,  # (B, T) float
    cfg: CrossEncoderConfig,
) -> jnp.ndarray:
    """Relevance logits (B,)."""
    if cfg.head_type == "interaction":
        return _interaction_forward(params, tokens, mask, cfg)
    x = params["tok_emb"][tokens] + params["pos_emb"][None, : tokens.shape[1]]
    x = x.astype(cfg.dtype)
    block = functools.partial(_block, n_heads=cfg.n_heads, dtype=cfg.dtype)
    if cfg.remat:
        block = jax.checkpoint(block)
    for layer in params["layers"]:
        x = block(layer, x, mask)
    x = _layer_norm(
        x.astype(jnp.float32), params["final_ln"]["g"], params["final_ln"]["b"]
    )
    cls = x[:, 0, :]  # CLS pooling
    logit = jnp.dot(cls, params["head"]["w"][:, 0]) + params["head"]["b"][0]
    return logit.astype(jnp.float32)


def _interaction_forward(
    params: Dict[str, Any],
    tokens: jnp.ndarray,  # (B, T) [CLS] q [SEP] d [SEP] framing
    mask: jnp.ndarray,
    cfg: CrossEncoderConfig,
) -> jnp.ndarray:
    """Gated cross-attention variant.

    Exact two-tower equivalence at init (tested): per-SEGMENT
    positions (query bytes at 0.., doc bytes restart at 0..),
    attention restricted to same-segment non-special keys, readout
    tau*cosine of the segment pools through ``iproj``.  Each layer
    adds tanh(xgate)*(full-attention - segment-attention) with
    xgate=0 at init — closed gate, unit gradient — so fine-tuning
    learns WHERE cross-segment (early) interaction helps.  The CLS
    logit (zero-init head) rides on top."""
    b, t = tokens.shape
    # segments: 0 = [CLS]+query, 1 = document, >=2 = trailing
    seg = jnp.cumsum((tokens == SEP_ID).astype(jnp.int32), axis=1)
    live = mask > 0
    special = (tokens == CLS_ID) | (tokens == SEP_ID) | (tokens == PAD_ID)
    key_ok = live & ~special
    same = (seg[:, :, None] == seg[:, None, :]) & key_ok[:, None, :]
    full = jnp.broadcast_to(key_ok[:, None, :], same.shape)
    # per-segment positions: query bytes 0.. (CLS sits before 0),
    # doc bytes 0.. from just after the first SEP
    first_sep = jnp.argmax((tokens == SEP_ID).astype(jnp.int32), axis=1)
    pos = jnp.arange(t)[None, :]
    pos_in = jnp.where(seg == 0, pos - 1, pos - (first_sep + 1)[:, None])
    pos_in = jnp.clip(pos_in, 0, params["pos_emb"].shape[0] - 1)
    x = params["tok_emb"][tokens] + params["pos_emb"][pos_in]
    x = x.astype(cfg.dtype)
    for layer in params["layers"]:
        h = _layer_norm(
            x.astype(jnp.float32), layer["ln1"]["g"], layer["ln1"]["b"]
        ).astype(cfg.dtype)
        a_same = _attention_pair(layer["attn"], h, same, cfg.n_heads)
        a_full = _attention_pair(layer["attn"], h, full, cfg.n_heads)
        gate = jnp.tanh(layer["xgate"]).astype(jnp.float32)
        mixed = a_same.astype(jnp.float32) + gate * (
            a_full.astype(jnp.float32) - a_same.astype(jnp.float32)
        )
        x = x + mixed.astype(cfg.dtype)
        h = _layer_norm(
            x.astype(jnp.float32), layer["ln2"]["g"], layer["ln2"]["b"]
        ).astype(cfg.dtype)
        if "moe" in layer:
            x = x + _moe_ffn(layer["moe"], h)
        else:
            x = x + _dense_ffn(layer["mlp"], h)
    x = _layer_norm(
        x.astype(jnp.float32), params["final_ln"]["g"], params["final_ln"]["b"]
    )
    cls = x[:, 0, :]
    logit = jnp.dot(cls, params["head"]["w"][:, 0]) + params["head"]["b"][0]
    is_q = (seg == 0) & key_ok
    is_d = (seg == 1) & key_ok

    def _pool(sel):
        m = sel.astype(jnp.float32)[..., None]
        p = jnp.sum(x * m, axis=1) / jnp.clip(jnp.sum(m, axis=1), 1e-6)
        p = jnp.dot(p, params["iproj"]["w"]) + params["iproj"]["b"]
        return p / jnp.clip(jnp.linalg.norm(p, axis=-1, keepdims=True), 1e-12)

    sim = jnp.sum(_pool(is_q) * _pool(is_d), axis=-1)
    return (cfg.interaction_temp * sim + logit).astype(jnp.float32)


# ----------------------------------------------------------------- training


def bce_loss(
    params, tokens, mask, labels, cfg: CrossEncoderConfig
) -> jnp.ndarray:
    logits = forward(params, tokens, mask, cfg)
    return jnp.mean(
        jnp.maximum(logits, 0) - logits * labels + jnp.log1p(jnp.exp(-jnp.abs(logits)))
    )


def make_train_step(cfg: CrossEncoderConfig, optimizer):
    """Returns train_step(params, opt_state, batch) -> (params,
    opt_state, loss).  Pure; jit/pjit-ready."""

    def train_step(params, opt_state, tokens, mask, labels):
        loss, grads = jax.value_and_grad(bce_loss)(
            params, tokens, mask, labels, cfg
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(
            lambda p, u: p + u, params, updates
        )
        return params, opt_state, loss

    return train_step


# ------------------------------------------------------------------- scorer


def _geometry(cfg: CrossEncoderConfig) -> tuple:
    return (
        cfg.vocab_size, cfg.max_len, cfg.dim, cfg.n_heads, cfg.n_layers,
        cfg.mlp_ratio, cfg.n_experts, cfg.head_type,
    )


def _load_scorer_config(directory: str) -> Optional[CrossEncoderConfig]:
    import json

    path = os.path.join(directory, "config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    return CrossEncoderConfig(
        vocab_size=d.get("vocab_size", VOCAB_SIZE),
        max_len=d.get("max_len", 256),
        dim=d.get("dim", 256),
        n_heads=d.get("n_heads", 8),
        n_layers=d.get("n_layers", 4),
        mlp_ratio=d.get("mlp_ratio", 4),
        n_experts=d.get("n_experts", 4),
        head_type=d.get("head_type", "cls"),
        interaction_temp=d.get("interaction_temp", 20.0),
        dtype=compute_dtype(),
    )


class CrossEncoderScorer:
    """Inference wrapper used by ClassicalReranker's "cross-encoder"
    method: tokenization + jit forward, with weight load/save (the
    reference cached its model to ``cross_encoder/<name>``;
    ``classical.py:82-99``)."""

    def __init__(
        self,
        cfg: Optional[CrossEncoderConfig] = None,
        params: Optional[Dict[str, Any]] = None,
        seed: int = 0,
    ):
        if cfg is None:
            cfg = CrossEncoderConfig(
                dtype=compute_dtype()
            )
        self.cfg = cfg
        self.params = (
            params
            if params is not None
            else init_params(jax.random.PRNGKey(seed), self.cfg)
        )
        self._fwd = jax.jit(
            functools.partial(forward, cfg=self.cfg)
        )

    @classmethod
    def from_config(cls, classical_config) -> "CrossEncoderScorer":
        """Build from a ClassicalConfig, loading cached weights if the
        model_cache_dir has them.  A config.json saved next to the
        weights is authoritative for the model geometry (shipped
        artifacts may use the interaction variant / non-default dims)."""
        cache_dir = os.path.join(
            classical_config.model_cache_dir,
            classical_config.model_name.replace("/", "_"),
        )
        path = os.path.join(cache_dir, "params.npz")
        cfg = _load_scorer_config(cache_dir)
        if cfg is None:
            cfg = CrossEncoderConfig(
                max_len=min(classical_config.max_sequence_length, 512),
                dtype=compute_dtype(),
            )
        scorer = cls(cfg)
        if os.path.exists(path):
            scorer.load(cache_dir)
        return scorer

    def score(self, query: str, docs: List[str]) -> np.ndarray:
        tokens, mask = tokenize_batch(query, docs, self.cfg.max_len)
        # pad batch to a power-of-two bucket (static jit shapes)
        b = tokens.shape[0]
        bp = 1 << max(3, (b - 1).bit_length())
        if bp != b:
            tokens = np.pad(tokens, ((0, bp - b), (0, 0)), constant_values=PAD_ID)
            mask = np.pad(mask, ((0, bp - b), (0, 0)))
            mask[b:, 0] = 1.0  # avoid fully-masked rows
        logits = self._fwd(self.params, jnp.asarray(tokens), jnp.asarray(mask))
        return np.asarray(jax.nn.sigmoid(logits))[:b]

    # -- persistence (flat npz; no orbax dependency at runtime) --------

    def save(self, directory: str) -> None:
        import json

        os.makedirs(directory, exist_ok=True)
        flat, treedef = jax.tree_util.tree_flatten(self.params)
        np.savez(
            os.path.join(directory, "params.npz"),
            **{f"p{i}": np.asarray(x) for i, x in enumerate(flat)},
        )
        c = self.cfg
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(
                {
                    "vocab_size": c.vocab_size,
                    "max_len": c.max_len,
                    "dim": c.dim,
                    "n_heads": c.n_heads,
                    "n_layers": c.n_layers,
                    "mlp_ratio": c.mlp_ratio,
                    "n_experts": c.n_experts,
                    "head_type": c.head_type,
                    "interaction_temp": c.interaction_temp,
                },
                f,
                indent=2,
            )

    def load(self, directory: str) -> None:
        saved = _load_scorer_config(directory)
        if saved is not None and _geometry(saved) != _geometry(self.cfg):
            # the sidecar is authoritative for geometry (runtime keeps
            # its dtype choice via _load_scorer_config)
            self.cfg = saved
            self.params = init_params(jax.random.PRNGKey(0), saved)
            self._fwd = jax.jit(functools.partial(forward, cfg=saved))
        data = np.load(os.path.join(directory, "params.npz"))
        flat, treedef = jax.tree_util.tree_flatten(self.params)
        new_flat = [jnp.asarray(data[f"p{i}"]) for i in range(len(flat))]
        self.params = jax.tree_util.tree_unflatten(treedef, new_flat)
