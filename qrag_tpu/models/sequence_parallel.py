"""Sequence-parallel cross-encoder forward (SP).

The reference handles long inputs by truncation (2048 chars,
``classical.py:164-165``) and chunked ingestion; SURVEY.md §2 maps SP
to "shard long transcript token sequences across chips for the
cross-encoder-equivalent scorer".  This module shards the TOKEN axis
of the cross-encoder over the mesh "model" axis via shard_map:

  * embeddings, layernorms, FFN/MoE: pointwise over tokens — stay
    sharded, zero communication;
  * attention: Q stays local to the shard's tokens; K/V are computed
    locally then ``all_gather``'d over the mesh (one collective per layer),
    so every shard attends over the full sequence;
  * CLS pooling: the logit is computed from the gathered final hidden
    states (CLS lives on shard 0).

Per-chip activation memory for a length-T sequence drops from O(T) to
O(T/S) (+ the transient gathered K/V), which is what makes
longer-than-HBM sequences scoreable.  Numerically identical to the
dense forward (tested on the 8-device CPU mesh).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from qrag_tpu.models.cross_encoder import (
    CrossEncoderConfig,
    _dense_ffn,
    _layer_norm,
    _linear,
    _moe_ffn,
)
from qrag_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS


def _sp_attention(p, x_local, mask_local, n_heads):
    """Attention with local Q and gathered K/V."""
    b, tl, d = x_local.shape
    qkv = _linear(p["qkv"], x_local)  # (b, tl, 3d)
    q, k_local, v_local = jnp.split(qkv, 3, axis=-1)
    # one collective per layer: token-axis gather of K, V, mask
    k = jax.lax.all_gather(k_local, MODEL_AXIS, axis=1, tiled=True)  # (b, T, d)
    v = jax.lax.all_gather(v_local, MODEL_AXIS, axis=1, tiled=True)
    mask = jax.lax.all_gather(mask_local, MODEL_AXIS, axis=1, tiled=True)
    hd = d // n_heads

    def heads(z, t):
        return z.reshape(b, t, n_heads, hd).transpose(0, 2, 1, 3)

    t_full = k.shape[1]
    qh, kh, vh = heads(q, tl), heads(k, t_full), heads(v, t_full)
    scores = jnp.einsum(
        "bhqd,bhkd->bhqk", qh, kh, preferred_element_type=jnp.float32
    ) / math.sqrt(hd)
    neg = jnp.asarray(-1e9, scores.dtype)
    scores = jnp.where(mask[:, None, None, :] > 0, scores, neg)
    att = jax.nn.softmax(scores, axis=-1).astype(x_local.dtype)
    out = jnp.einsum(
        "bhqk,bhkd->bhqd", att, vh, preferred_element_type=jnp.float32
    )
    out = out.astype(x_local.dtype).transpose(0, 2, 1, 3).reshape(b, tl, d)
    return _linear(p["out"], out)


def forward_sequence_parallel(
    params: Dict[str, Any],
    tokens: jnp.ndarray,  # (B, T) int32; T divisible by mesh model size
    mask: jnp.ndarray,  # (B, T)
    cfg: CrossEncoderConfig,
    mesh: Mesh,
) -> jnp.ndarray:
    """Relevance logits (B,) with the token axis sharded over "model"."""

    def local(prm, toks_l, mask_l):
        shard = jax.lax.axis_index(MODEL_AXIS)
        tl = toks_l.shape[1]
        pos = jax.lax.dynamic_slice_in_dim(
            prm["pos_emb"], shard * tl, tl, axis=0
        )
        x = (prm["tok_emb"][toks_l] + pos[None]).astype(cfg.dtype)
        for layer in prm["layers"]:
            h = _layer_norm(
                x.astype(jnp.float32), layer["ln1"]["g"], layer["ln1"]["b"]
            )
            x = x + _sp_attention(
                layer["attn"], h.astype(cfg.dtype), mask_l, cfg.n_heads
            )
            h = _layer_norm(
                x.astype(jnp.float32), layer["ln2"]["g"], layer["ln2"]["b"]
            )
            h = h.astype(cfg.dtype)
            if "moe" in layer:
                x = x + _moe_ffn(layer["moe"], h)
            else:
                x = x + _dense_ffn(layer["mlp"], h)
        # CLS readout: gather final hidden states along tokens, take 0
        xg = jax.lax.all_gather(x, MODEL_AXIS, axis=1, tiled=True)
        cls = _layer_norm(
            xg[:, 0, :].astype(jnp.float32),
            prm["final_ln"]["g"],
            prm["final_ln"]["b"],
        )
        logit = jnp.dot(cls, prm["head"]["w"][:, 0]) + prm["head"]["b"][0]
        return logit.astype(jnp.float32)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS, MODEL_AXIS), P(DATA_AXIS, MODEL_AXIS)),
        out_specs=P(DATA_AXIS),
        check_vma=False,  # outputs are replicated over "model" post-gather
    )
    return fn(params, tokens, mask)


def score_long_documents(
    scorer_params: Dict[str, Any],
    cfg: CrossEncoderConfig,
    mesh: Mesh,
    tokens,
    mask,
):
    """Convenience jit wrapper placing batch on "data" and tokens on
    "model"."""
    batch_sh = NamedSharding(mesh, P(DATA_AXIS, MODEL_AXIS))
    tokens = jax.device_put(tokens, batch_sh)
    mask = jax.device_put(mask, batch_sh)
    fn = jax.jit(
        functools.partial(forward_sequence_parallel, cfg=cfg, mesh=mesh)
    )
    return fn(scorer_params, tokens, mask)
