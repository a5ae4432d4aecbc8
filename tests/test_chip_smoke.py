"""chip_smoke.py and bench.py on the CPU: both refuse to measure without
a GPU, and chip_smoke's phases and references work at a small size
(the card runs them at 1M x 768)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

CPU_ENV = {**os.environ, "JAX_PLATFORMS": "cpu"}


def test_chip_smoke_refuses_cpu():
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=CPU_ENV,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert out.stdout == ""
    assert "needs a GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=CPU_ENV,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert out.stdout == ""
    assert "qrag_tpu/ not found" in out.stderr


def test_bench_refuses_cpu_without_small():
    out = subprocess.run(
        [sys.executable, "bench.py"], cwd=REPO, env=CPU_ENV,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 2
    assert out.stdout == ""
    assert "--small" in out.stderr


def test_bench_failed_section_is_recorded():
    import bench

    failures = []
    with bench._section("boom", failures):
        raise RuntimeError("kaput")
    with bench._section("fine", failures):
        pass
    assert failures == ["boom: RuntimeError: kaput"]


def test_reference_topk_ties_go_to_lower_index():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    x[250] = x[7]  # exact duplicate: same distance, the lower id first
    q = x[7:8] + 0.01
    d2, ids = cs.reference_topk(x, q, 5, chunk=64)
    brute = ((x.astype(np.float64) - q[0]) ** 2).sum(1)
    order = np.lexsort((np.arange(300), brute))[:5]
    np.testing.assert_array_equal(ids[0], order)
    np.testing.assert_allclose(d2[0], brute[order], rtol=1e-12)
    assert list(ids[0][:2]) == [7, 250]


def test_check_topk_flags_a_wrong_id_and_accepts_a_tie():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((500, 32)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[400] = x[3]
    q = x[3:4].copy()
    d2, ids = cs.reference_topk(x, q, 4)
    assert not cs.check_topk(x, q, ids, d2, 4, "exact")
    swapped = ids.copy()
    swapped[0, :2] = swapped[0, 1::-1]  # the duplicate pair, reversed
    assert not cs.check_topk(x, q, swapped, d2, 4, "tie")
    wrong = ids.copy()
    wrong[0, 2] = ids[0, 3] + 1 if ids[0, 3] + 1 not in ids[0] else 0
    assert cs.check_topk(x, q, wrong, d2, 4, "wrong")


@pytest.fixture(scope="module")
def served():
    env = {
        "QRAG_EMBEDDING_DIM": "768",
        "QRAG_QUANTUM_N_QUBITS": "10",
        "QRAG_CLASSICAL_METHOD": "cross-encoder",
        "QRAG_CLASSICAL_MODEL_CACHE_DIR": os.path.join(REPO, "artifacts"),
        "QRAG_CLASSICAL_MODEL_NAME": "cross_encoder",
    }
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    from qrag_tpu.serving.http_app import serve_in_thread

    try:
        engine, x = cs.build_engine(20000, 768, 0)
        server = serve_in_thread(
            engine, port=0, batching=True,
            max_pairs=max(engine.config.serving.doc_buckets),
        )
        yield engine, x, cs.Client(server.server_address[1])
        server.shutdown()
        server.server_close()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_phase_search(served):
    engine, x, client = served
    q, _ = cs.sample_queries(x, 3, 3, 768, np.random.default_rng(1))
    assert cs.phase_search(client, x, q, 0) == []


def test_phase_search_rerank(served):
    engine, x, client = served
    q, _ = cs.sample_queries(x, 2, 2, 768, np.random.default_rng(2))
    assert cs.phase_search_rerank(client, x, q, engine.config.quantum.n_qubits) == []


def test_phase_rerank_cross_encoder(served):
    engine, x, client = served
    assert cs.phase_rerank(client, engine.config) == []


def test_phase_kernels_interpret(served):
    engine, x, client = served
    assert cs.phase_kernels(engine, interpret=True) == []


def test_phase_headline_ids(served):
    engine, x, client = served
    problems = cs.phase_headline(engine, x, 0, batch=64)
    assert not [p for p in problems if "fell back" not in p]


def test_phase_four_cards_on_cpu_mesh():
    """The sharded phase on the test session's virtual CPU devices."""
    assert cs.phase_four_cards(40000, 768, 0, batch=8) == []


def test_phase_sharded_ingest_on_cpu_mesh():
    """The public sharded ingestion path (add, then an on-device append
    into the headroom) on the virtual CPU devices."""
    assert cs.phase_sharded_ingest(40000, 64, 0, batch=8) == []


def test_round_bf16_matches_device_rounding():
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    x = rng.standard_normal(4096).astype(np.float32)
    # exact ties between two bf16 neighbours round to the even one
    ties = (np.arange(1, 65, dtype=np.uint32) << 16 | 0x8000).view(np.float32)
    x = np.concatenate([x, ties, -ties])
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(cs.round_bf16(x), want)


@pytest.mark.parametrize("rows", [3000, 40000])
def test_mesh_reference_matches_host_reference(rows):
    """The per-card float64 top-k (shard slices, padding rows masked,
    host merge) equals the host float64 top-k over the same rows, ties
    to the lower index across shard edges included; MeshRows' gathers
    equal the rows."""
    import jax
    import ml_dtypes
    from jax.sharding import NamedSharding, PartitionSpec as P

    from qrag_tpu.parallel.mesh import MODEL_AXIS, make_mesh

    mesh = make_mesh()
    mp = mesh.shape[MODEL_AXIS]
    cap = -(-rows // (mp * 128)) * mp * 128
    rng = np.random.default_rng(0)
    host = np.zeros((cap, 16), np.float32)
    host[:rows] = rng.standard_normal((rows, 16))
    host[[rows // 2, rows - 1]] = host[3]  # duplicates in other shards
    host = host.astype(ml_dtypes.bfloat16).astype(np.float32)
    matrix = jax.device_put(host.astype(ml_dtypes.bfloat16),
                            NamedSharding(mesh, P(MODEL_AXIS, None)))
    x = cs.MeshRows(matrix, rows)
    ids = rng.integers(0, rows, (3, 5))
    np.testing.assert_array_equal(x[ids], host[ids])
    q = np.concatenate([host[[3, rows - 2]] + 0.01, rng.standard_normal((2, 16))])
    want_d, want_i = cs.reference_topk(host[:rows], q, 7, chunk=512)
    got_d, got_i = cs.mesh_reference_topk(x, q, 7)
    assert list(want_i[0][:3]) == [3, rows // 2, rows - 1]
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=0, atol=1e-12)
