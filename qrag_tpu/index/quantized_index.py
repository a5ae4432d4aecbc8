"""Int8-quantized flat index: quantized scan + exact refinement.

`QuantizedFlatIndex` keeps TWO device-resident forms of the corpus:
an int8 matrix (+ scales) that the hot scan reads, and the
true-precision matrix (bf16 by default) used to exactly re-score the
top candidates.  Returned scores are therefore exact; only candidate
recall depends on quantization, controlled by ``refine_factor``
(candidates = refine_factor × k).

Two scan modes (device times: not measured on a GPU yet):

* ``scan="row"`` (default): per-row scales, rescaled f32 scores
  through ``approx_max_k`` (``ops.quantize.int8_scan_topk``).
* ``scan="window"``: the windowed packed-argmax scan
  (``ops/window_scan.py``) — per-128-row-BLOCK scales aligned with
  selection windows, so selection runs on (B, N/128) planes and the
  exact re-score gathers one row per selected window.

Memory for 1M×768: 0.77 GB int8 + 1.5 GB bf16 ≈ 2.3 GB; the scan
reads only the int8 half.  The quantized buffers live inside the
index's atomic `DeviceBuffers` snapshot, so appends publish all forms
of a corpus generation together.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from qrag_tpu.index.flat_index import DeviceBuffers, DeviceFlatIndex
from qrag_tpu.ops.quantize import int8_scan_topk, quantize_rows, refine_candidates
from qrag_tpu.ops.topk import _finalize
from qrag_tpu.ops.window_scan import (
    make_lane_rank,
    quantize_block_rows_device,
    windowed_scan_topk,
)

# module-level jit: one trace cache across all indexes/uploads
_jit_quantize_rows = jax.jit(quantize_rows)
_jit_quantize_blocks = jax.jit(quantize_block_rows_device)


def _jit_row_isq(q8):
    from qrag_tpu.ops.int8_domain import row_int_sqnorms

    return jax.jit(row_int_sqnorms)(q8)


class QuantizedFlatIndex(DeviceFlatIndex):
    """DeviceFlatIndex whose scan runs on int8 with exact refinement."""

    def __init__(
        self,
        *args,
        refine_factor: int = 4,
        scan: str = "row",
        exact_scores: bool = True,
        domain_exact: bool = False,
        **kwargs,
    ):
        kwargs.setdefault("store_dtype", "bfloat16")
        # the quantized scan is pre-refinement approximate; "verified"
        # certificates don't apply (host search must route through our
        # search_device)
        kwargs["topk_mode"] = "approx"
        if scan not in ("window", "row"):
            raise ValueError(f"unknown quantized scan mode {scan!r}")
        if not exact_scores and scan != "window":
            raise ValueError(
                "exact_scores=False (the gather-free mode) requires "
                "scan='window' — the row scan always refines"
            )
        if domain_exact and scan != "window":
            raise ValueError(
                "domain_exact=True needs scan='window' (the own-domain "
                "contract is defined over per-window codes — "
                "ops/int8_domain.py)"
            )
        super().__init__(*args, **kwargs)
        if scan == "window" and self.row_pad_multiple % 128:
            raise ValueError(
                "window scan needs row_pad_multiple % 128 == 0 "
                f"(got {self.row_pad_multiple})"
            )
        self.refine_factor = max(1, int(refine_factor))
        self.scan = scan
        self.exact_scores = bool(exact_scores)
        self.domain_exact = bool(domain_exact)

    def layout(self) -> dict:
        """Scan-mode observability for /stats (engine.stats attaches
        this when present)."""
        return {
            "quantization": "int8",
            "scan": self.scan,
            "exact_scores": self.exact_scores,
            "refine_factor": self.refine_factor,
            "domain_exact": self.domain_exact,
        }

    def _finalize_snapshot(self, snap: DeviceBuffers) -> None:
        x32 = snap.matrix.astype(jnp.float32)
        if self.scan == "window":
            q8, bscales = _jit_quantize_blocks(x32)
            snap.extras["int8w"] = (
                q8,
                bscales,
                jnp.asarray(make_lane_rank(q8.shape[0])),
            )
            if self.domain_exact:
                snap.extras["int8w_isq"] = _jit_row_isq(q8)
        else:
            q8, scales = _jit_quantize_rows(x32)
            snap.extras["int8"] = (q8, scales)

    def _search_domain_exact(
        self, snap: DeviceBuffers, q32: jnp.ndarray, k: int, nw: int
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Own-domain int8 EXACT top-k (``ops/int8_domain.py``): the
        scoring contract is the dequantized codes + rounded query, the
        result is provably the exact top-k of that contract (identity
        AND tie order).  Cert events land in the same counters the
        bounded mode uses (/stats parity)."""
        from qrag_tpu.ops.int8_domain import (
            exact_topk_int8_domain,
            full_topk_int8_domain,
        )
        x8, bscales, lane_rank = snap.extras["int8w"]
        row_isq = snap.extras["int8w_isq"]
        if nw < max(2 * k, 16):
            # small corpus: the pruned design can't cover top-k out of
            # so few windows; the full own-domain sort is cheap here
            vals, idx = full_topk_int8_domain(
                q32, x8, bscales, row_isq, k,
                metric=self.metric, valid_rows=snap.valid,
            )
            return _finalize(vals, idx, self.metric)
        vals, idx, fell_back, _, escalated = exact_topk_int8_domain(
            q32, x8, bscales, row_isq, lane_rank, k,
            metric=self.metric,
            valid_rows=snap.valid,
            candidates=max(16, k),
        )
        self.fallback_rows += int(np.asarray(fell_back))
        self.bounded_escalations += int(np.asarray(escalated))
        return _finalize(vals, idx, self.metric)

    def search_device(
        self, queries: jnp.ndarray, k: int
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        snap = self.device_buffers()
        q32 = queries.astype(jnp.float32)
        nw = snap.matrix.shape[0] // 128
        if self.domain_exact:
            return self._search_domain_exact(snap, q32, k, nw)
        if self.scan == "window" and nw < max(16 * k, 64):
            # small corpus: one candidate per window can't cover top-k
            # without collisions (k balls in nw bins), and the exact
            # scan is already cheap at this size — use it
            from qrag_tpu.ops.topk import flat_scan_topk

            return flat_scan_topk(
                q32.astype(self.store_dtype),
                snap.matrix,
                k,
                metric=self.metric,
                corpus_sqnorms=snap.sqnorms,
                valid_rows=snap.valid,
                mode="exact",
            )
        if self.scan == "window":
            x8, bscales, lane_rank = snap.extras["int8w"]
            vals, final_idx = windowed_scan_topk(
                q32,
                x8,
                snap.matrix,
                lane_rank,
                k,
                metric=self.metric,
                corpus_sqnorms=snap.sqnorms,
                window_scale=bscales,
                ntotal=jnp.asarray(snap.ntotal),
                refine_factor=self.refine_factor,
                exact_scores=self.exact_scores,
            )
            return _finalize(vals, final_idx, self.metric)
        x8, scales = snap.extras["int8"]
        q8, q_scale = quantize_rows(q32)
        qsq = jnp.sum(q32 * q32, axis=-1)
        c = min(self.refine_factor * k, x8.shape[0])
        cand_g, idx = int8_scan_topk(
            q8,
            q_scale,
            x8,
            scales,
            c,
            metric=self.metric,
            corpus_sqnorms=snap.sqnorms,
            query_sqnorms=qsq,
            valid_rows=snap.valid,
        )
        vals, final_idx = refine_candidates(
            q32,
            snap.matrix,
            idx,
            cand_g,
            k,
            metric=self.metric,
            corpus_sqnorms=snap.sqnorms,
        )
        return _finalize(vals, final_idx, self.metric)
