"""Every choice the program makes from the machine it runs on.

Two decisions depend on the platform, and both are made here only:

* the scan route of the bounded and windowed exact searches: the
  fused Pallas kernel through Triton (``ops/pallas/fused_scan.py``) on
  a GPU when the scan is bf16 and the shapes tile, the XLA twins
  otherwise — always on the CPU, where a GPU kernel could only run in
  interpret mode, which only tests choose;
* the compute dtype of the models (cross-encoder, bi-encoder, hash
  embedder, distillation): bf16 on a GPU, float32 on the CPU, whose
  dot thunk has no bf16 x bf16 -> f32 product.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def on_gpu() -> bool:
    return jax.default_backend() == "gpu"


def compute_dtype():
    """Activation dtype for model forward passes."""
    return jnp.bfloat16 if on_gpu() else jnp.float32


def scan_route(n: int, d: int, scan_dtype) -> str:
    """``"triton"`` or ``"xla"`` for a packed window scan over an
    (n, d) corpus held in ``scan_dtype``."""
    from qrag_tpu.ops.pallas.fused_scan import tiles

    if on_gpu() and scan_dtype == jnp.bfloat16 and tiles(n, d):
        return "triton"
    return "xla"
