"""Packed window scan as one Pallas kernel through Triton (Hopper).

The scan pass of ``ops.bounded_topk`` and ``ops.window_scan`` computes
``Q @ X^T``, turns every score into an order-preserving int32 key with
the lane in its low 7 bits, and keeps only the top 1, 2 or 3 keys of
each 128-row window.  The XLA twins (``bounded_topk.
packed_window_scan_top2`` / ``_top3``, ``window_scan.
packed_window_scan``) hand the product to a library GEMM and run the
epilogue as a separate fusion, so the (B, N) f32 score matrix is
written to device memory and read back.  Here the epilogue runs on the
accumulator in registers and only the (B, N/128) planes are written:

  per (bm queries, windows x 128 rows) block:
    acc_w  = sum over d chunks of  Q[:, c] @ X_w[:, c]^T   (bf16 in, f32 acc)
    g      = (alpha * acc_w + row_add) + col_add           (twin's order)
    key    = sign-folded bitcast(g) & ~127
    packed = key | (127 - lane)              ties -> LOWER row index wins
    plane p = p-th largest packed key of the window  (p = 1..planes)

Blocks are independent; the query axis is the fastest grid axis, so
the blocks that share one corpus tile run together and the tile is
read from device memory once and from L2 after that.

``interpret=True`` runs the same kernel on the CPU (tests only).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

WINDOW = 128
# Tiling, from a sweep at B=1024 x 1M x 768 on an H100 (400 W limit):
# 128 queries x 2 windows per block with 8 warps and a 3-stage
# pipeline over 64-wide d chunks ran the two-plane scan in 4.40 ms
# against 5.18 ms for 64 x 2 / 4 warps; a 128-wide d chunk no longer
# fits 3 stages in shared memory.  An odd window count takes one
# window per block (and 4 warps).
_BM = 128
_BK = 64
_WINDOWS = 2
_STAGES = 3
# plain Python ints: a jnp scalar here would be a captured constant,
# which pallas_call kernels reject
_I32_MIN_P = -(2 ** 31)
_TRUNC_MASK = -WINDOW  # ~127: clears the lane bits


def _scan_kernel(
    q_ref, ca_ref, x_ref, ra_ref, *plane_refs, alpha: float, bk: int,
    windows: int,
):
    bm, d = q_ref.shape

    def body(t, accs):
        cols = pl.ds(pl.multiple_of(t * bk, bk), bk)
        q = q_ref[:, cols]
        return tuple(
            acc + pl.dot(q, x_ref[pl.ds(w * WINDOW, WINDOW), cols],
                         trans_b=True)
            for w, acc in enumerate(accs)
        )

    accs = jax.lax.fori_loop(
        0, d // bk, body,
        tuple(jnp.zeros((bm, WINDOW), jnp.float32) for _ in range(windows)),
    )
    ca = ca_ref[...][:, None]  # (bm, 1)
    lane_rank = (WINDOW - 1) - jax.lax.broadcasted_iota(
        jnp.int32, (bm, WINDOW), 1
    )
    for w, acc in enumerate(accs):
        ra = ra_ref[pl.ds(w * WINDOW, WINDOW)][None, :]  # (1, 128)
        g = acc * alpha if alpha != 1.0 else acc
        g = (g + ra) + ca
        u = jax.lax.bitcast_convert_type(g, jnp.int32)
        key = jnp.where(u < 0, _I32_MIN_P - u, u) & _TRUNC_MASK
        packed = key | lane_rank
        for p, ref in enumerate(plane_refs):
            top = jnp.max(packed, axis=1)  # (bm,)
            ref[w, :] = top
            if p + 1 < len(plane_refs):
                # packed keys are unique within a window (lane bits),
                # so each mask removes exactly one row
                packed = jnp.where(packed == top[:, None], _I32_MIN_P, packed)


def _pick_bm(b: int, bm_max: int) -> int:
    """Query block: the smallest power of two >= B up to ``bm_max``,
    and at least 16 (the tensor-core product's minimum M)."""
    return min(bm_max, max(16, 1 << max(0, (b - 1).bit_length())))


def tiles(n: int, d: int) -> bool:
    """Do these corpus shapes fit the kernel's tiling?"""
    return n >= WINDOW and n % WINDOW == 0 and d >= _BK and d % _BK == 0


@functools.partial(
    jax.jit, static_argnames=("alpha", "planes", "interpret")
)
def packed_window_scan_kernel(
    queries: jnp.ndarray,  # (B, d) bf16
    corpus: jnp.ndarray,  # (N, d) bf16; N % 128 == 0, d % 64 == 0
    row_add=None,  # (1, N) f32 per-row add (-|x|^2 for l2, -inf masks)
    col_add=None,  # (B, 1) f32 per-query add (-|q|^2)
    alpha: float = 1.0,
    planes: int = 2,
    interpret: bool = False,
):
    """Tuple of ``planes`` (B, N/128) int32 packed planes: the window
    argmax key, the runner-up key and (planes=3) the third key — the
    contract of ``bounded_topk.packed_window_scan_top2``/``_top3`` and
    (planes=1) ``window_scan.packed_window_scan``."""
    b0, d = queries.shape
    n = corpus.shape[0]
    if not tiles(n, d):
        raise ValueError(f"shapes must tile: N={n}%{WINDOW}, d={d}%{_BK}")
    nw = n // WINDOW
    windows = _WINDOWS if nw % _WINDOWS == 0 else 1
    bk = _BK
    bm = _pick_bm(b0, _BM)
    b = -(-b0 // bm) * bm
    queries = jnp.pad(queries, ((0, b - b0), (0, 0)))
    col = (
        jnp.zeros((b,), jnp.float32) if col_add is None
        else jnp.pad(col_add.reshape(b0), (0, b - b0))
    )
    row = (
        jnp.zeros((n,), jnp.float32) if row_add is None
        else row_add.reshape(n)
    )
    plane = jax.ShapeDtypeStruct((nw, b), jnp.int32)
    out_spec = pl.BlockSpec((windows, bm), lambda i, j: (j, i))
    pks = pl.pallas_call(
        functools.partial(
            _scan_kernel, alpha=alpha, bk=bk, windows=windows
        ),
        grid=(b // bm, nw // windows),
        in_specs=[
            pl.BlockSpec((bm, d), lambda i, j: (i, 0)),
            pl.BlockSpec((bm,), lambda i, j: (i,)),
            pl.BlockSpec((windows * WINDOW, d), lambda i, j: (j, 0)),
            pl.BlockSpec((windows * WINDOW,), lambda i, j: (j,)),
        ],
        out_specs=(out_spec,) * planes,
        out_shape=(plane,) * planes,
        compiler_params=plgpu.CompilerParams(
            num_warps=4 * windows, num_stages=_STAGES
        ),
        backend="triton",
        interpret=interpret,
        name="packed_window_scan",
    )(queries.astype(jnp.bfloat16), col, corpus, row)
    return tuple(pk.T[:b0] for pk in pks)
