"""Bounded-exact top-k (norm-bounded window pruning): exactness is
UNCONDITIONAL — every test asserts bit-equal indices (tie order
included) against the full refine-domain oracle, across the fast path,
the patch path, and the cert-failure fallback."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from qrag_tpu.ops.bounded_topk import (
    bounded_exact_topk,
    margin_coeff,
    packed_window_scan_top2,
    topk_tiebreak,
    window_maxnorms,
)
from qrag_tpu.ops.topk import _goodness
from qrag_tpu.ops.window_scan import WINDOW, make_lane_rank


def _oracle(q, x, metric, sq, valid, k):
    g = _goodness(
        jnp.asarray(q, jnp.float32),
        jnp.asarray(x, jnp.float32),
        metric,
        jnp.asarray(sq),
        None if valid is None else jnp.asarray(valid),
    )
    return jax.lax.top_k(g, k)


def _run(q, x, metric, k, x_scan=None, valid=None, **kw):
    sq = (np.asarray(x, np.float32) ** 2).sum(1)
    xs = x if x_scan is None else x_scan
    return bounded_exact_topk(
        jnp.asarray(q),
        jnp.asarray(xs),
        jnp.asarray(x),
        jnp.asarray(sq),
        jnp.asarray(window_maxnorms(sq)),
        jnp.asarray(make_lane_rank(x.shape[0])),
        k,
        metric=metric,
        valid_rows=None if valid is None else jnp.asarray(valid),
        **kw,
    )


def _assert_exact(q, x, metric, k, res, atol=1e-4):
    """Exactness up to the contract: identity equals the full-matrix
    oracle, EXCEPT where the oracle's own values show a sub-noise tie
    (two f32 evaluation orders of the same dot can drift ~1e-5
    relative; refine-domain and matmul-domain orderings of such ties
    legitimately differ — the same caveat the verified mode
    documents).  Any disagreement wider than the rigorous
    accumulation-noise bound is a REAL bug."""
    sq = (np.asarray(x, np.float32) ** 2).sum(1)
    ov, oi = _oracle(q, x, metric, sq, None, k)
    vals, idx, fb, npatch = res[:4]
    idx, oi = np.asarray(idx), np.asarray(oi)
    vals, ov = np.asarray(vals), np.asarray(ov)
    if not np.array_equal(idx, oi):
        g = np.asarray(
            _goodness(
                jnp.asarray(q, jnp.float32), jnp.asarray(x, jnp.float32),
                metric, jnp.asarray(sq), None,
            )
        )
        rows, pos = np.where(idx != oi)
        tol = 3e-4 * (1.0 + np.abs(ov[rows, pos]))  # rigorous accum bound
        # the row I returned must tie the oracle's row at this rank
        # within evaluation noise — else it's a genuine wrong answer
        gap = np.abs(g[rows, idx[rows, pos]] - ov[rows, pos])
        assert (gap <= tol).all(), (
            f"non-tie index mismatch: rows {rows}, pos {pos}, gap {gap}"
        )
    np.testing.assert_allclose(vals, ov, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_random_exact(rng, metric):
    n, d, b, k = 131072, 64, 8, 10
    x = rng.randn(n, d).astype(np.float32)
    q = rng.randn(b, d).astype(np.float32)
    res = _run(q, x, metric, k)
    assert not bool(res[2])  # fast path
    _assert_exact(q, x, metric, k, res)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_window_collision_patch_path(rng, metric):
    """3 of the global top-k rows packed into ONE window: the argmax
    covers one, the patch path must find the other two."""
    n, d, b, k = 16384, 32, 4, 8
    x = 0.05 * rng.randn(n, d).astype(np.float32)
    q = rng.randn(b, d).astype(np.float32)
    target = q[0] / np.linalg.norm(q[0])
    w = 17
    for j, off in enumerate((3, 40, 100)):
        x[w * WINDOW + off] = target * (4.0 + 0.001 * j)
    res = _run(q, x, metric, k)
    vals, idx, fb, npatch = res[:4]
    assert not bool(fb)
    assert int(npatch) >= 1  # the collision window got patched
    _assert_exact(q, x, metric, k, res)
    got = set(map(int, np.asarray(idx)[0]))
    assert {w * WINDOW + 3, w * WINDOW + 40, w * WINDOW + 100} <= got


def test_exact_tie_break_lower_index(rng):
    """Duplicate rows spread across windows: ties resolve to the lower
    global index, exactly as lax.top_k over the full matrix."""
    n, d, b, k = 4096, 16, 3, 12
    base = rng.randn(32, d).astype(np.float32)
    x = np.tile(base, (n // 32, 1))
    q = rng.randn(b, d).astype(np.float32)
    res = _run(q, x, "ip", k)
    _assert_exact(q, x, "ip", k, res)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_bf16_scan_f32_refine_margins(rng, metric):
    """Scan in bf16, exactness w.r.t. the f32 corpus: the margins must
    absorb the input rounding, including rows planted within a hair of
    the decision boundary."""
    n, d, b, k = 32768, 128, 8, 10
    x = rng.randn(n, d).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.randn(b, d).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    # plant near-boundary rows: slightly-decayed copies of the top
    # dir.  l2 needs wider decay steps: its goodness for a scaled
    # copy is -(1-s)^2, so 1e-4 steps give ~1e-8 quadratic spacing —
    # BELOW f32 accumulation noise, i.e. effectively exact ties whose
    # order is evaluation-dependent in ANY implementation.
    t = q[0]
    step = 5e-3 if metric == "l2" else 1e-4
    for j in range(24):
        x[128 * (7 * j + 1) + (j % WINDOW)] = t * (1.0 - step * j)
    res = _run(q, x, metric, k, x_scan=x.astype(jnp.bfloat16))
    _assert_exact(q, x, metric, k, res, atol=5e-3)


def test_cert_failure_escalates_without_full_sort(rng):
    """More qualifying windows than the candidate budget but fewer
    than 4x of it: cert_a fails at C, the ESCALATED re-certification
    (same planes, 4C budget) succeeds — exact answer, no full sort."""
    n, d, b, k = 8192, 16, 4, 6
    x = rng.randn(n, d).astype(np.float32)
    q = rng.randn(b, d).astype(np.float32)
    t = q[0] / np.linalg.norm(q[0])
    # 20 near-tied top rows in 20 DIFFERENT windows > C=8 budget
    for j in range(20):
        x[j * WINDOW * 2 + 5] = t * (5.0 + 1e-6 * j)
    res = _run(q, x, "ip", k, candidates=8)
    assert bool(res[4])  # escalated
    assert not bool(res[2])  # ... and certified there: no full sort
    _assert_exact(q, x, "ip", k, res)


def test_cert_failure_beyond_escalation_falls_back_exact(rng):
    """More qualifying windows than even the 4x escalated budget:
    the exact full sort must run and the answer stays exact."""
    n, d, b, k = 8192, 16, 4, 6
    x = rng.randn(n, d).astype(np.float32)
    q = rng.randn(b, d).astype(np.float32)
    t = q[0] / np.linalg.norm(q[0])
    # 40 near-tied top rows in 40 DIFFERENT windows > 4*C=32 budget
    for j in range(40):
        x[j * WINDOW + 5] = t * (5.0 + 1e-6 * j)
    res = _run(q, x, "ip", k, candidates=8)
    assert bool(res[4])  # escalated first
    assert bool(res[2])  # then fell back
    _assert_exact(q, x, "ip", k, res)


def test_multiflag_query_falls_back_exact(rng):
    """Three windows each hiding TWO top rows for one query (> the
    2-window patch budget) -> cert_b fallback, still exact."""
    n, d, b, k = 8192, 16, 4, 10
    x = 0.05 * rng.randn(n, d).astype(np.float32)
    q = rng.randn(b, d).astype(np.float32)
    t = q[0] / np.linalg.norm(q[0])
    for wi, w in enumerate((3, 19, 40)):
        x[w * WINDOW + 7] = t * (4.0 + 0.01 * wi)
        x[w * WINDOW + 90] = t * (4.0 + 0.005 * wi)
    res = _run(q, x, "ip", k)
    # > 2 flagged windows on one query can't be patched at ANY
    # candidate budget unless the threshold rises past them; with the
    # planted scores it doesn't, so escalation runs AND the full sort
    # still fires
    assert bool(res[2])
    _assert_exact(q, x, "ip", k, res)


def test_valid_rows_mask(rng):
    n, d, b, k = 4096, 32, 4, 5
    x = rng.randn(n, d).astype(np.float32)
    q = x[:b] + 0.01 * rng.randn(b, d).astype(np.float32)
    valid = np.ones(n, bool)
    valid[: b // 2] = False  # mask some of the likely winners
    sq = (x ** 2).sum(1)
    res = _run(q, x, "l2", k, valid=valid)
    ov, oi = _oracle(q, x, "l2", sq, valid, k)
    np.testing.assert_array_equal(np.asarray(res[1]), np.asarray(oi))
    np.testing.assert_allclose(
        np.asarray(res[0]), np.asarray(ov), rtol=1e-5, atol=1e-4
    )


def test_top2_scan_oracle(rng):
    from qrag_tpu.ops.bounded_topk import plane_value_bounds

    n, d, b = 2048, 32, 6
    x = rng.randn(n, d).astype(np.float32)
    q = rng.randn(b, d).astype(np.float32)
    pk1, pk2 = packed_window_scan_top2(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(make_lane_rank(n))
    )
    g = np.asarray(q @ x.T, np.float32)
    gr = g.reshape(b, n // WINDOW, WINDOW)
    lo1, hi1 = (np.asarray(a) for a in plane_value_bounds(pk1))
    _, hi2 = (np.asarray(a) for a in plane_value_bounds(pk2))
    # bounds bracket the true top-2 values (strict upper bound)
    assert (lo1 <= gr.max(2) + 1e-6).all()
    assert (gr.max(2) < hi1).all()
    s = np.sort(gr, axis=2)
    assert (s[:, :, -2] < hi2 + 1e-6).all()
    # bounds are TIGHT: within one trunc quantum (~2^-16 relative)
    np.testing.assert_allclose(hi1, gr.max(2), rtol=1e-4)
    lane = WINDOW - 1 - (np.asarray(pk1) & (WINDOW - 1))
    np.testing.assert_array_equal(lane, gr.argmax(2))


def test_topk_tiebreak_matches_lax(rng):
    g = np.array([[1.0, 3.0, 3.0, -np.inf, 2.0]], np.float32)
    idx = np.array([[40, 30, 10, 0, 20]], np.int32)
    v, i = topk_tiebreak(jnp.asarray(g), jnp.asarray(idx), 3)
    np.testing.assert_array_equal(np.asarray(i)[0], [10, 30, 20])
    np.testing.assert_allclose(np.asarray(v)[0], [3.0, 3.0, 2.0])


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_device_flat_index_bounded_mode(rng, metric):
    """topk_mode="bounded" through DeviceFlatIndex.search /
    search_device matches the exact index bit-for-bit (indices + tie
    order), finalized distances included."""
    from qrag_tpu.index.flat_index import DeviceFlatIndex

    n, d, b, k = 8192, 64, 8, 10
    x = rng.randn(n, d).astype(np.float32)
    q = x[rng.choice(n, b)] + 0.01 * rng.randn(b, d).astype(np.float32)
    bounded = DeviceFlatIndex.from_numpy(
        x, metric=metric, topk_mode="bounded", normalize=False
    )
    exact = DeviceFlatIndex.from_numpy(
        x, metric=metric, topk_mode="exact", normalize=False
    )
    rb = bounded.search(q, k=k)
    re_ = exact.search(q, k=k)
    np.testing.assert_array_equal(rb.indices, re_.indices)
    np.testing.assert_allclose(rb.scores, re_.scores, rtol=1e-5, atol=1e-4)
    # device-level too (jit-compatible path)
    sv, si = bounded.search_device(jnp.asarray(q), k)
    np.testing.assert_array_equal(np.asarray(si), re_.indices)


def test_bounded_k_exceeds_candidate_default(rng):
    """k > the default candidate budget must WIDEN the budget, not
    crash (review finding r3: the engine's rerank pass asks for
    candidates=100 through a default-config bounded index)."""
    from qrag_tpu.index.flat_index import DeviceFlatIndex

    n, d, b = 8192, 64, 4
    x = rng.randn(n, d).astype(np.float32)
    q = rng.randn(b, d).astype(np.float32)
    idx = DeviceFlatIndex.from_numpy(x, topk_mode="bounded", normalize=False)
    ex = DeviceFlatIndex.from_numpy(x, topk_mode="exact", normalize=False)
    r1, r2 = idx.search(q, k=40), ex.search(q, k=40)
    np.testing.assert_array_equal(r1.indices, r2.indices)


def test_bounded_mode_small_corpus_degrades_exact(rng):
    from qrag_tpu.index.flat_index import DeviceFlatIndex

    x = rng.randn(500, 32).astype(np.float32)
    q = rng.randn(3, 32).astype(np.float32)
    idx = DeviceFlatIndex.from_numpy(x, topk_mode="bounded", normalize=False)
    exact = DeviceFlatIndex.from_numpy(x, topk_mode="exact", normalize=False)
    np.testing.assert_array_equal(
        idx.search(q, k=5).indices, exact.search(q, k=5).indices
    )


def test_bounded_mode_incremental_add(rng):
    """Snapshot-cached bounded buffers regenerate after add()."""
    from qrag_tpu.index.flat_index import DeviceFlatIndex

    x = rng.randn(4096, 32).astype(np.float32)
    idx = DeviceFlatIndex.from_numpy(x, topk_mode="bounded", normalize=False)
    q = rng.randn(2, 32).astype(np.float32)
    idx.search(q, k=3)  # build + cache bounded buffers
    extra = rng.randn(512, 32).astype(np.float32)
    idx.add(extra)
    exact = DeviceFlatIndex.from_numpy(
        np.concatenate([x, extra]), topk_mode="exact", normalize=False
    )
    np.testing.assert_array_equal(
        idx.search(q, k=5).indices, exact.search(q, k=5).indices
    )


@pytest.mark.parametrize("merge", ["allgather", "ring"])
def test_sharded_bounded_exact(rng, merge):
    """topk_mode="bounded" on the sharded index: per-shard bounded +
    exact tie-break merge = exact GLOBAL top-k, bit-equal to the
    single-device exact index (duplicates included)."""
    from qrag_tpu.config import MeshConfig
    from qrag_tpu.index.flat_index import DeviceFlatIndex
    from qrag_tpu.parallel import ShardedFlatIndex, make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    mesh = make_mesh(MeshConfig(data_parallel=1, model_parallel=8))
    n, d, b, k = 8 * 4608, 32, 6, 10  # 4608 rows/shard (>=4096, %128)
    base = rng.randn(64, d).astype(np.float32)
    x = rng.randn(n, d).astype(np.float32)
    x[:: n // 64] = base[: len(x[:: n // 64])]  # planted duplicates
    q = rng.randn(b, d).astype(np.float32)
    for metric in ("ip", "l2"):
        sharded = ShardedFlatIndex(
            x, mesh, metric=metric, topk_mode="bounded", merge=merge
        )
        exact = DeviceFlatIndex.from_numpy(
            x, metric=metric, topk_mode="exact", normalize=False
        )
        rs = sharded.search(q, k=k)
        re_ = exact.search(q, k=k)
        np.testing.assert_array_equal(rs.indices, re_.indices)
        np.testing.assert_allclose(
            rs.scores, re_.scores, rtol=1e-5, atol=1e-4
        )


def test_sharded_bounded_large_k_exact(rng):
    """k=64 over an 8-shard mesh: every shard runs the LARGE-K design
    (third plane + runner-up patches) on its slice and the tie-break
    merge must still produce the exact global top-k — bit-equal to
    the single-device exact index."""
    from qrag_tpu.config import MeshConfig
    from qrag_tpu.index.flat_index import DeviceFlatIndex
    from qrag_tpu.parallel import ShardedFlatIndex, make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    mesh = make_mesh(MeshConfig(data_parallel=1, model_parallel=8))
    n, d, b, k = 8 * 16384, 32, 6, 64  # 128 windows/shard, k = NW/2
    x = rng.randn(n, d).astype(np.float32)
    q = rng.randn(b, d).astype(np.float32)
    for metric in ("ip", "l2"):
        sharded = ShardedFlatIndex(
            x, mesh, metric=metric, topk_mode="bounded"
        )
        exact = DeviceFlatIndex.from_numpy(
            x, metric=metric, topk_mode="exact", normalize=False
        )
        rs = sharded.search(q, k=k)
        re_ = exact.search(q, k=k)
        np.testing.assert_array_equal(rs.indices, re_.indices)
        np.testing.assert_allclose(
            rs.scores, re_.scores, rtol=1e-5, atol=1e-4
        )


def test_sharded_bounded_small_shards_degrade(rng):
    from qrag_tpu.config import MeshConfig
    from qrag_tpu.index.flat_index import DeviceFlatIndex
    from qrag_tpu.parallel import ShardedFlatIndex, make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    mesh = make_mesh(MeshConfig(data_parallel=1, model_parallel=8))
    x = rng.randn(2000, 16).astype(np.float32)  # 256 rows/shard: exact
    q = rng.randn(3, 16).astype(np.float32)
    sharded = ShardedFlatIndex(x, mesh, topk_mode="bounded")
    exact = DeviceFlatIndex.from_numpy(x, topk_mode="exact", normalize=False)
    np.testing.assert_array_equal(
        sharded.search(q, k=5).indices, exact.search(q, k=5).indices
    )


def test_fuzz_exactness_many_shapes(rng):
    """Randomized sweep over shapes, metrics, dtypes, k, and data
    styles (normalized / wild-norm / clustered): exactness must hold
    on every draw — any non-tie index disagreement with the oracle is
    a real bug."""
    for trial in range(12):
        # per-trial seed (NOT the shared session rng): a failing draw
        # must be replayable by running this test alone
        trng = np.random.RandomState(1000 + trial)
        n = int(trng.choice([4096, 8192, 16384]))
        d = int(trng.choice([16, 48, 96]))
        b = int(trng.choice([1, 3, 9]))
        k = int(trng.choice([1, 5, 17]))
        # metric and scan dtype vary on DIFFERENT bits so all four
        # (metric x dtype) combinations appear across the sweep
        metric = ["ip", "l2"][trial % 2]
        use_bf16_scan = (trial // 2) % 2 == 1
        style = trial % 3
        x = trng.randn(n, d).astype(np.float32)
        if style == 1:  # wild norms (margin scaling must track)
            x *= trng.lognormal(0.0, 2.0, size=(n, 1)).astype(np.float32)
        elif style == 2:  # clustered: many near-duplicates
            centers = trng.randn(8, d).astype(np.float32)
            x = centers[trng.randint(0, 8, n)] + 0.01 * x
        q = trng.randn(b, d).astype(np.float32)
        scan = x.astype(jnp.bfloat16) if use_bf16_scan else None
        res = _run(q, x, metric, k, x_scan=scan)
        _assert_exact(q, x, metric, k, res, atol=5e-3)


# ---------------------------------------------------------------- large-k


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_large_k_random_exact(rng, metric):
    """k=64 (rerank width): the large-k design (auto at k > 16) must
    certify on random data — window collisions ride the runner-up
    layer, no full sort."""
    n, d, b, k = 131072, 64, 8, 64
    x = rng.randn(n, d).astype(np.float32)
    q = rng.randn(b, d).astype(np.float32)
    res = _run(q, x, metric, k)
    assert not bool(res[2])  # fast path
    _assert_exact(q, x, metric, k, res)


def _plant_large_k(trng, n, d, b, k, doubles, triples=0, singles=None):
    """Background + a planted top-k for query 0 that FILLS all k ranks
    (doubles/triples in shared windows + singles in their own), so the
    certification threshold lands among planted values, far above the
    background — the test exercises the collision machinery, not the
    background order statistics (a thr in the background band can
    legitimately cert_b-flag planted windows' background rows, which
    is sound behavior but a different test).  Deterministic local rng:
    a failing draw must be replayable by running the test alone."""
    x = 0.05 * trng.randn(n, d).astype(np.float32)
    q = trng.randn(b, d).astype(np.float32)
    t = q[0] / np.linalg.norm(q[0])
    if singles is None:
        singles = k - 2 * doubles - 3 * triples
    assert singles >= 0 and doubles + triples + singles <= n // WINDOW // 4
    planted = []

    def put(w, lane, s):
        x[w * WINDOW + lane] = t * s
        planted.append(w * WINDOW + lane)

    w = 3
    for j in range(doubles):
        put(w, 9, 4.0 + 0.01 * j)
        put(w, 70, 3.7 + 0.01 * j)
        w += 5
    for j in range(triples):
        put(w, 7, 3.9 + 0.01 * j)
        put(w, 60, 3.8 + 0.01 * j)
        put(w, 101, 3.75 + 0.01 * j)
        w += 5
    for j in range(singles):
        put(w, 33, 3.5 + 0.01 * j)
        w += 5
    return x, q, planted


def test_large_k_double_collisions_runner_layer():
    """12 windows each holding TWO top-k rows for one query — far over
    the 2-window whole-window patch budget that forced the full sort
    pre-large-k.  The runner-up layer must score the second rows
    individually: fast path, exact, all planted rows returned."""
    n, d, b, k = 16384, 32, 4, 30
    x, q, planted = _plant_large_k(
        np.random.RandomState(42), n, d, b, k, doubles=12
    )
    res = _run(q, x, "ip", k)
    assert not bool(res[2])  # runner layer, not the full sort
    _assert_exact(q, x, "ip", k, res)
    assert set(planted) <= set(map(int, np.asarray(res[1])[0]))


def test_large_k_triple_collision_window_patch():
    """Doubles ride the runner layer; a TRIPLE collision (3 top rows in
    one window) still needs the whole-window patch — cert_b keys off
    the third-row bound (ub3) in large-k mode."""
    n, d, b, k = 16384, 32, 4, 20
    x, q, planted = _plant_large_k(
        np.random.RandomState(43), n, d, b, k, doubles=4, triples=1
    )
    res = _run(q, x, "ip", k)
    assert not bool(res[2])
    assert int(res[3]) >= 1  # the triple window got patched
    _assert_exact(q, x, "ip", k, res)
    assert set(planted) <= set(map(int, np.asarray(res[1])[0]))


def test_large_k_runner_budget_escalates():
    """More flagged runner-up windows than R but fewer than 4R:
    cert_r fails at tier 1, the escalated re-certification (same
    planes, 4R) succeeds — exact, no full sort."""
    n, d, b, k = 16384, 32, 4, 24
    x, q, planted = _plant_large_k(
        np.random.RandomState(44), n, d, b, k, doubles=8  # 8 > R=4
    )
    res = _run(q, x, "ip", k, runner_rows=4)
    assert bool(res[4])  # escalated
    assert not bool(res[2])  # ... and certified there
    _assert_exact(q, x, "ip", k, res)


def test_large_k_beyond_runner_escalation_falls_back():
    """More flagged runner-up windows than even 4R: the exact full
    sort runs and the answer stays exact."""
    n, d, b, k = 16384, 32, 4, 30
    x, q, planted = _plant_large_k(
        np.random.RandomState(45), n, d, b, k, doubles=12  # 12 > 4R=8
    )
    res = _run(q, x, "ip", k, runner_rows=2)
    assert bool(res[2])
    _assert_exact(q, x, "ip", k, res)


def test_large_k_bf16_scan_margins(rng):
    """Large-k + bf16 scan store: the ub2/ub3 margin math must absorb
    input rounding with planted near-boundary doubles."""
    n, d, b, k = 32768, 128, 6, 48
    x = rng.randn(n, d).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.randn(b, d).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = q[0]
    for j in range(10):  # doubles within a hair of each other
        w = 11 * j + 3
        x[w * WINDOW + 2] = t * (1.0 - 5e-3 * j)
        x[w * WINDOW + 77] = t * (1.0 - 5e-3 * j - 1e-3)
    res = _run(q, x, "l2", k, x_scan=x.astype(jnp.bfloat16))
    _assert_exact(q, x, "l2", k, res, atol=5e-3)


def test_auto_runner_budget():
    from qrag_tpu.ops.bounded_topk import _auto_runner_budget

    assert _auto_runner_budget(100, 8192) == 8  # big corpus: floor
    assert _auto_runner_budget(64, 128) == 64  # small corpus: scales
    assert _auto_runner_budget(30, 128) >= 14  # 4x the Poisson mean


def test_large_k_dense_regime_escalates_not_full_sorts(rng):
    """k ~ NW/5 (the smoke-test shape that exposed the hard P=2 cap):
    the margin band piles several triple-collision-class windows onto
    one query — measured max 9 flagged at k=100, NW=512, far over 2.
    The widened per-query patch cap (P ~ 4x the triple Poisson mean,
    4P at escalation) must certify WITHOUT the full sort."""
    n, d, b, k = 65536, 256, 32, 100
    x = rng.randn(n, d).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.randn(b, d).astype(np.float32)
    res = _run(q, x, "l2", k, x_scan=x.astype(jnp.bfloat16))
    assert not bool(res[2]), "dense regime fell back to the full sort"
    _assert_exact(q, x, "l2", k, res, atol=5e-3)


def test_margin_coeff_domains():
    f32, bf16 = jnp.float32, jnp.bfloat16
    same = margin_coeff(bf16, bf16, bf16, 768)
    mixed = margin_coeff(f32, bf16, f32, 768)
    assert same < 1e-3 < mixed < 2e-2
    # the mixed coefficient must cover 2^-8 per bf16-rounded operand
    assert mixed >= 2 * 2.0 ** -8


def test_auto_budgets_regimes():
    """The (C, F) defaults follow the margin REGIME (census + timed
    sweeps): narrow dtype-equal
    paths get the lean budgets, f32-queries-vs-bf16-store the mid
    tier, and a refine domain that differs from the scan store the
    wide tier.  Guards the regression where the narrow threshold sat
    below the f32-accumulation coefficient (3e-4) and silently pushed
    the bench regime onto the wide budgets."""
    from qrag_tpu.ops.bounded_topk import _auto_budgets

    f32, bf16 = jnp.float32, jnp.bfloat16
    assert _auto_budgets(None, None, bf16, bf16, bf16, 768) == (16, 32)
    assert _auto_budgets(None, None, f32, f32, f32, 768) == (16, 32)
    assert _auto_budgets(None, None, f32, bf16, bf16, 768) == (48, 32)
    assert _auto_budgets(None, None, f32, bf16, f32, 768) == (96, 96)
    # explicit values pass through untouched, independently
    assert _auto_budgets(7, None, f32, bf16, f32, 768) == (7, 96)
    assert _auto_budgets(None, 5, bf16, bf16, bf16, 768) == (16, 5)


def test_sharded_bounded_stats_surface(rng):
    """The sharded bounded path surfaces cert-event counts the same
    way DeviceFlatIndex does: fallback_rows / bounded_escalations
    accumulate on the host-level search() (psum'd over the mesh), and
    the lazy stats handle is consumed exactly once."""
    from qrag_tpu.config import MeshConfig
    from qrag_tpu.parallel import ShardedFlatIndex, make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    mesh = make_mesh(MeshConfig(data_parallel=1, model_parallel=8))
    n, d = 8 * 4608, 32
    x = rng.randn(n, d).astype(np.float32)
    q = rng.randn(4, d).astype(np.float32)
    idx = ShardedFlatIndex(x, mesh, topk_mode="bounded")
    assert idx.bounded_escalations == 0 and idx.fallback_rows == 0
    r = idx.search(q, k=10)
    assert r.indices.shape == (4, 10)
    assert idx._pending_bounded_stats is None  # consumed
    # at d=32 the wide-regime margin band is large vs the score
    # spread, so per-shard cert failures are legitimate — exactness
    # is covered by test_sharded_bounded_exact; here assert the
    # counters are bounded by the event space and accumulate
    shards = 8
    first_fb = idx.fallback_rows
    assert 0 <= first_fb <= shards
    assert 0 <= idx.bounded_escalations <= shards
    idx.search(q, k=10)
    assert idx.fallback_rows == 2 * first_fb  # same queries, same certs


def test_bounded_query_rounding_contract(rng):
    """bounded_query_dtype="store" on a bf16 store: results are exact
    w.r.t. the STORE-DTYPE-ROUNDED query (the fp16-store contract) —
    bit-equal to the exact oracle evaluated on the rounded queries —
    and the op sees store-dtype queries (narrow margin regime)."""
    from qrag_tpu.index.flat_index import DeviceFlatIndex

    n, d, b, k = 8192, 64, 5, 10
    x = rng.randn(n, d).astype(np.float32)
    q = rng.randn(b, d).astype(np.float32)
    idx = DeviceFlatIndex.from_numpy(
        x, metric="l2", topk_mode="bounded", store_dtype="bfloat16",
        bounded_query_dtype="store", normalize=False,
    )
    r = idx.search(q, k=k)
    # oracle: exact top-k of the ROUNDED query under the index's own
    # scoring function — bf16-stored rows with f32 norm corrections
    # (flat_index uploads sqnorms from the f32 master "to keep L2
    # corrections accurate" even for a bf16 store)
    q_r = jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32)
    x_r = jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
    sq_f32 = jnp.sum(jnp.asarray(x) * jnp.asarray(x), axis=1)
    ov, oi = _oracle(
        np.asarray(q_r), np.asarray(x_r), "l2", sq_f32, None, k
    )
    idx, oi = np.asarray(r.indices), np.asarray(oi)
    if not np.array_equal(idx, oi):
        # identical-after-rounding rows tie-break by index in BOTH
        # evaluations; only sub-noise near-ties (two f32 evaluation
        # orders of the same dot) may legitimately reorder — the same
        # caveat _assert_exact documents
        g = np.asarray(
            _goodness(q_r, x_r, "l2", sq_f32, None)
        )
        ovn = np.asarray(ov)
        rows, pos = np.where(idx != oi)
        gap = np.abs(g[rows, idx[rows, pos]] - ovn[rows, pos])
        tol = 3e-4 * (1.0 + np.abs(ovn[rows, pos]))
        assert (gap <= tol).all(), (
            f"non-tie index mismatch: rows {rows}, pos {pos}, gap {gap}"
        )

    # constructor validation
    with pytest.raises(ValueError):
        DeviceFlatIndex.from_numpy(
            x, topk_mode="bounded", bounded_query_dtype="fp8"
        )


def test_bounded_query_rounding_config_plumbing():
    """IndexConfig.bounded_query_dtype flows through the engine's
    index construction (both families)."""
    from qrag_tpu.config import QragConfig
    from qrag_tpu.engine import QragEngine

    cfg = QragConfig.from_dict(
        {
            "embedding": {"provider": "hash", "dim": 32},
            "index": {
                "topk_mode": "bounded",
                "dtype": "bfloat16",
                "bounded_query_dtype": "store",
                "normalize": False,
            },
        }
    )
    eng = QragEngine(config=cfg)
    assert eng.index.bounded_query_dtype == "store"


@pytest.mark.parametrize("rows", [384, 1000, 1 << 16])
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_exact_full_sort_row_chunks_match_full_top_k(monkeypatch, rng, rows, store):
    """The fallback scores the corpus in row chunks (the last one
    clamped to end at N) and merges with the lower-index tie rule: it
    must equal lax.top_k over the whole refine-domain score matrix,
    duplicates across chunk boundaries and masked rows included."""
    from qrag_tpu.ops import bounded_topk as bt

    monkeypatch.setattr(bt, "_full_sort_rows", lambda chunk, n, *_: min(n, rows))
    n, d, b, k = 4096, 64, 5, 12
    x = rng.randn(n, d).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[[383, 384, 999, 1000, 4095]] = x[7]  # ties across chunk edges
    valid = np.ones(n, bool)
    valid[[1000, 2000]] = False
    q = np.concatenate([x[7:8] + 0.01, rng.randn(b - 1, d)]).astype(np.float32)
    xf = jnp.asarray(x, getattr(jnp, store))
    sq = jnp.sum(xf.astype(jnp.float32) ** 2, axis=1)
    vals, idx = bt._exact_full_sort(
        jnp.asarray(q), xf, sq, k, "l2", jnp.asarray(valid)
    )
    g = _goodness(jnp.asarray(q), xf.astype(jnp.float32), "l2", sq, jnp.asarray(valid))
    want_v, want_i = jax.lax.top_k(g, k)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(want_i))
    # another product shape may sum d in another order: f32 noise only
    np.testing.assert_allclose(
        np.asarray(vals), np.asarray(want_v), rtol=0, atol=1e-5
    )


@pytest.mark.parametrize(
    "chunk, n, store, score, want",
    [
        # 1M x 768 f32 store, 128 queries: 512 MB of scores, every row
        (128, 1_000_448, "float32", "float32", 1_000_448),
        # a bf16 store scored in f32: the f32 copy does not fit, slices do
        (128, 1_000_448, "bfloat16", "float32", (1 << 30) // (512 + 3072)),
        # a 25M-row bf16 shard with bf16 queries: (64, 25M) scores would
        # be 6.4 GB; a slice and its scores stay inside the budget
        (64, 25_034_752, "bfloat16", "bfloat16", (1 << 30) // (256 + 1536)),
        (5, 40, "float32", "float32", 40),
    ],
)
def test_full_sort_rows_fit_the_budget(chunk, n, store, score, want):
    from qrag_tpu.ops import bounded_topk as bt

    got = bt._full_sort_rows(chunk, n, 768, jnp.dtype(store), jnp.dtype(score))
    assert got == want
    if got < n:
        width = jnp.dtype(score).itemsize * 768
        assert got * (4 * chunk + width) <= bt._FULL_SORT_BYTES
