"""Batched quantum statevector ops in JAX.

Implements — for real, on the accelerator — the circuit semantics the reference
*intended* but could not run (its ``from qiskit import ... Aer, execute``
fails under the pinned qiskit>=2.1, so the quantum path silently falls
back to classical; SURVEY.md §0 gap 2).  The encoding circuit, from
``src/reranker/quantum.py:138-167``:

    1. normalize the input vector v
    2. for qubit i in [0, min(len(v), n_qubits)):
         ry(v[i] * pi, i) ; rz(v[i] * pi / 2, i)
    3. CX ladder: cx(i, i+1) for i in [0, n_qubits-1)
    4. score = state_fidelity(psi_q, psi_d) = |<psi_q|psi_d>|^2
       (``quantum.py:108-133``)

Conventions match Qiskit: little-endian qubit ordering (statevector
index bit k == qubit k), RY(t) = [[cos t/2, -sin t/2], [sin t/2,
cos t/2]], RZ(t) = diag(e^{-it/2}, e^{it/2}), initial state |0...0>.

Two evaluation paths, both exact:

* **Full statevector** (`encode_statevector` + `fidelity_statevector`):
  builds the 2^n complex amplitude vector by contracting per-qubit
  states and applying the CX ladder.  O(2^n) per vector; general (used
  for arbitrary circuit extensions and as an in-repo oracle).

* **Analytic product form** (`fidelity_analytic`): because *both*
  circuits end in the *same* CX ladder U, the fidelity
  |<psi_q|psi_d>|^2 = |<phi_q|U^T U|phi_d>|^2 = |<phi_q|phi_d>|^2
  reduces to a product of per-qubit 2-vector inner products — O(n)
  real arithmetic per pair, no complex tensors, fully VPU-vectorized.
  This is the hot path: reranking 1k candidates at 10 qubits
  costs 1k×10 fused multiply-adds instead of 1k×2^10 complex ops.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def _normalize(v: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """L2-normalize; zero vectors pass through unchanged
    (``quantum.py:149-151`` only divides when norm > 0)."""
    norm = jnp.linalg.norm(v, axis=axis, keepdims=True)
    return jnp.where(norm > 0, v / jnp.where(norm > 0, norm, 1.0), v)


def encode_product_amplitudes(
    vectors: jnp.ndarray, n_qubits: int
) -> jnp.ndarray:
    """Per-qubit amplitudes of the pre-entanglement product state.

    Args:
      vectors: (..., m) real vectors (normalized internally).
      n_qubits: number of qubits n.

    Returns:
      (..., n, 2) complex64 per-qubit states.  Qubit i's state after
      ``rz(v[i]*pi/2) @ ry(v[i]*pi) |0>`` is
      ``[cos(v[i]*pi/2) * e^{-i v[i] pi/4}, sin(v[i]*pi/2) * e^{+i v[i] pi/4}]``.
      Qubits with no corresponding vector component stay |0>.
    """
    vectors = jnp.asarray(vectors, dtype=jnp.float32)
    v = _normalize(vectors)
    m = v.shape[-1]
    k = min(m, n_qubits)
    vk = v[..., :k]
    theta = vk * jnp.pi  # ry angle
    phi = vk * (jnp.pi / 2)  # rz angle
    a0 = jnp.cos(theta / 2) * jnp.exp(-1j * phi / 2)
    a1 = jnp.sin(theta / 2) * jnp.exp(1j * phi / 2)
    amps = jnp.stack([a0, a1], axis=-1).astype(jnp.complex64)  # (..., k, 2)
    if k < n_qubits:
        pad_shape = amps.shape[:-2] + (n_qubits - k, 2)
        zero_state = jnp.zeros(pad_shape, dtype=jnp.complex64)
        zero_state = zero_state.at[..., 0].set(1.0)
        amps = jnp.concatenate([amps, zero_state], axis=-2)
    return amps


def apply_1q_gate(
    state: jnp.ndarray, gate: jnp.ndarray, qubit: int, n_qubits: int
) -> jnp.ndarray:
    """Apply a 2x2 gate to `qubit` of a (..., 2**n) statevector
    (little-endian: statevector index bit k == qubit k)."""
    batch = state.shape[:-1]
    st = state.reshape(batch + (2,) * n_qubits)
    # C-order reshape puts qubit (n-1) on the first state axis.
    axis = len(batch) + (n_qubits - 1 - qubit)
    st = jnp.moveaxis(st, axis, -1)
    st = jnp.einsum("ab,...b->...a", gate.astype(state.dtype), st)
    st = jnp.moveaxis(st, -1, axis)
    return st.reshape(batch + (2 ** n_qubits,))


def apply_cx(
    state: jnp.ndarray, control: int, target: int, n_qubits: int
) -> jnp.ndarray:
    """Apply CX(control, target) to a (..., 2**n) statevector."""
    batch = state.shape[:-1]
    st = state.reshape(batch + (2,) * n_qubits)
    ax_c = len(batch) + (n_qubits - 1 - control)
    ax_t = len(batch) + (n_qubits - 1 - target)
    st = jnp.moveaxis(st, (ax_c, ax_t), (-2, -1))
    # control=1 block gets its target axis flipped
    c0 = st[..., 0, :]
    c1 = st[..., 1, ::-1]
    st = jnp.stack([c0, c1], axis=-2)
    st = jnp.moveaxis(st, (-2, -1), (ax_c, ax_t))
    return st.reshape(batch + (2 ** n_qubits,))


def encode_statevector(vectors: jnp.ndarray, n_qubits: int) -> jnp.ndarray:
    """Full 2^n statevector of the reference encoding circuit.

    Args:
      vectors: (..., m) real vectors.
    Returns:
      (..., 2**n_qubits) complex64 statevectors (ry/rz rotations then
      the CX ladder, Qiskit little-endian ordering).
    """
    amps = encode_product_amplitudes(vectors, n_qubits)  # (..., n, 2)
    batch = amps.shape[:-2]
    # Product state: contract per-qubit states into the full register.
    # Little-endian: qubit n-1 is the most-significant index bit, so
    # kron from qubit n-1 down to qubit 0.
    state = amps[..., n_qubits - 1, :]
    for q in range(n_qubits - 2, -1, -1):
        state = state[..., :, None] * amps[..., q, :][..., None, :]
        state = state.reshape(batch + (-1,))
    # CX ladder cx(i, i+1), in circuit order (quantum.py:164-165).
    for i in range(n_qubits - 1):
        state = apply_cx(state, i, i + 1, n_qubits)
    return state


def state_fidelity(psi: jnp.ndarray, chi: jnp.ndarray) -> jnp.ndarray:
    """|<psi|chi>|^2 between statevectors, batched over leading dims."""
    inner = jnp.sum(jnp.conj(psi) * chi, axis=-1)
    return jnp.abs(inner) ** 2


def fidelity_statevector(
    query_vec: jnp.ndarray, doc_vecs: jnp.ndarray, n_qubits: int
) -> jnp.ndarray:
    """Fidelity scores via the full statevector path.

    Args:
      query_vec: (m,) query embedding.
      doc_vecs: (N, m) document embeddings.
    Returns:
      (N,) float32 fidelities.
    """
    psi_q = encode_statevector(query_vec, n_qubits)  # (2^n,)
    psi_d = encode_statevector(doc_vecs, n_qubits)  # (N, 2^n)
    return state_fidelity(psi_q[None, :], psi_d).astype(jnp.float32)


def fidelity_analytic(
    query_vec: jnp.ndarray, doc_vecs: jnp.ndarray, n_qubits: int
) -> jnp.ndarray:
    """Exact fidelity via the product form — the hot path.

    Both encoding circuits share the same CX-ladder entangler U, which
    cancels inside the overlap: |<psi_q|psi_d>| = |<phi_q|phi_d>| where
    phi are pre-entanglement product states.  The overlap then factors
    per qubit:

      <phi_q|phi_d> = prod_k [ cos(tq/2)cos(td/2) e^{+i dphi/2}
                             + sin(tq/2)sin(td/2) e^{-i dphi/2} ]

    with dphi = phi_q - phi_d, giving the real squared magnitude

      |c_k|^2 = A^2 + B^2 + 2AB cos(dphi),
      A = cos(tq/2)cos(td/2), B = sin(tq/2)sin(td/2).

    All-real VPU arithmetic, O(n_qubits) per pair.

    Args / returns as `fidelity_statevector`; results match it (and the
    Qiskit semantics) to float32 precision.
    """
    q = _normalize(jnp.asarray(query_vec, dtype=jnp.float32))
    d = _normalize(jnp.asarray(doc_vecs, dtype=jnp.float32))
    kq = min(q.shape[-1], n_qubits)
    kd = min(d.shape[-1], n_qubits)
    k = max(kq, kd)
    # Pad rotation angles with zeros for un-rotated qubits (|0> state
    # == ry(0) rz(0) |0>, so zero-angle padding is exact).
    qa = jnp.zeros(q.shape[:-1] + (k,), jnp.float32).at[..., :kq].set(q[..., :kq])
    da = jnp.zeros(d.shape[:-1] + (k,), jnp.float32).at[..., :kd].set(d[..., :kd])
    half_tq = qa * (jnp.pi / 2)  # theta_q / 2
    half_td = da * (jnp.pi / 2)
    dphi = (qa - da) * (jnp.pi / 2)  # phi_q - phi_d
    A = jnp.cos(half_tq) * jnp.cos(half_td)
    B = jnp.sin(half_tq) * jnp.sin(half_td)
    per_qubit = A * A + B * B + 2.0 * A * B * jnp.cos(dphi)
    return jnp.prod(per_qubit, axis=-1)


@functools.partial(jax.jit, static_argnames=("n_qubits", "analytic"))
def batched_fidelity(
    query_vec: jnp.ndarray,
    doc_vecs: jnp.ndarray,
    n_qubits: int,
    analytic: bool = True,
) -> jnp.ndarray:
    """Jit entry: (m,) query × (N, m) docs → (N,) fidelity scores."""
    if analytic:
        return fidelity_analytic(query_vec, doc_vecs, n_qubits)
    return fidelity_statevector(query_vec, doc_vecs, n_qubits)


def rotation_features(
    vectors: jnp.ndarray, n_qubits: int, sqnorms: Optional[jnp.ndarray] = None
) -> jnp.ndarray:
    """Precompute the per-vector features the analytic fidelity needs:
    the first ``n_qubits`` components of the L2-NORMALIZED vector.

    The rotation encoding only reads v_normalized[:n_qubits]
    (``quantum.py:158-161`` uses min(len(v), n_qubits) components after
    normalizing the FULL vector), so a (N, n_qubits) feature matrix is
    all the rerank stage must gather from HBM — 768/n_qubits× less
    bandwidth than gathering raw rows.
    """
    vectors = jnp.asarray(vectors, dtype=jnp.float32)
    if sqnorms is None:
        sqnorms = jnp.sum(vectors * vectors, axis=-1)
    inv = jnp.where(sqnorms > 0, jax.lax.rsqrt(jnp.maximum(sqnorms, 1e-30)), 1.0)
    k = min(vectors.shape[-1], n_qubits)
    feats = vectors[..., :k] * inv[..., None]
    if k < n_qubits:
        pad = [(0, 0)] * (vectors.ndim - 1) + [(0, n_qubits - k)]
        feats = jnp.pad(feats, pad)
    return feats


def fidelity_from_features(
    q_feat: jnp.ndarray,  # (..., n_qubits) — rotation_features of queries
    d_feats: jnp.ndarray,  # (..., C, n_qubits) — of candidates
) -> jnp.ndarray:
    """Analytic fidelity from precomputed features (same math as
    `fidelity_analytic`, minus the normalization — exact for features
    built by `rotation_features`)."""
    qa = q_feat[..., None, :]
    half_tq = qa * (jnp.pi / 2)
    half_td = d_feats * (jnp.pi / 2)
    dphi = (qa - d_feats) * (jnp.pi / 2)
    A = jnp.cos(half_tq) * jnp.cos(half_td)
    B = jnp.sin(half_tq) * jnp.sin(half_td)
    per_qubit = A * A + B * B + 2.0 * A * B * jnp.cos(dphi)
    return jnp.prod(per_qubit, axis=-1)


# ----------------------------------------------------------- amplitude mode


def amplitude_encode(vectors: jnp.ndarray, n_qubits: int) -> jnp.ndarray:
    """Amplitude encoding: the (normalized) vector IS the statevector.

    The BASELINE north star specifies "amplitude-encode query/doc
    pairs, swap-test fidelity" (the encoding the reference's docstring
    *aspired* to — ``quantum.py:156`` "in a real implementation, this
    would use amplitude encoding").  Vectors are truncated/zero-padded
    to 2^n amplitudes and re-normalized.
    """
    vectors = jnp.asarray(vectors, dtype=jnp.float32)
    dim = 2 ** n_qubits
    m = vectors.shape[-1]
    if m >= dim:
        v = vectors[..., :dim]
    else:
        pad = [(0, 0)] * (vectors.ndim - 1) + [(0, dim - m)]
        v = jnp.pad(vectors, pad)
    return _normalize(v).astype(jnp.complex64)


def amplitude_fidelity(
    query_vec: jnp.ndarray, doc_vecs: jnp.ndarray, n_qubits: int
) -> jnp.ndarray:
    """|<psi_q|psi_d>|^2 under amplitude encoding — for real vectors
    this is the squared cosine similarity of the truncated/renormalized
    vectors, computed as one batched dot (one matmul)."""
    q = jnp.real(amplitude_encode(query_vec, n_qubits)).astype(jnp.float32)
    d = jnp.real(amplitude_encode(doc_vecs, n_qubits)).astype(jnp.float32)
    inner = jnp.einsum("...d,nd->...n", jnp.atleast_2d(q), d)
    out = inner * inner
    return out[0] if query_vec.ndim == 1 else out


def swap_test_probability(
    query_vec: jnp.ndarray, doc_vecs: jnp.ndarray, n_qubits: int
) -> jnp.ndarray:
    """P(ancilla = 0) of the swap test = (1 + |<psi_q|psi_d>|^2) / 2.

    The physical-circuit readout the north star references: an ancilla
    in |+>, controlled-SWAP between the two registers, H, measure.
    Derived exactly from the amplitude fidelity (no 2^(2n+1) circuit
    simulation needed — the identity is exact).
    """
    return 0.5 * (1.0 + amplitude_fidelity(query_vec, doc_vecs, n_qubits))
