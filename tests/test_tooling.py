"""Tests for code_util, alist, protograph, noise_models,
monte_carlo_simulation and the legacy v1 shims (reference test models:
python_test/test_codes.py, test_mod2.py patterns)."""

import os

import numpy as np
import pytest

import ldpc_tpu
from ldpc_tpu import code_util, protograph
from ldpc_tpu.alist import alist2numpy, save_alist
from ldpc_tpu.codes import hamming_code, rep_code
from ldpc_tpu.monte_carlo_simulation import (
    BpParams,
    MonteCarloBscSimulation,
    build_multiround_pcm,
    decode_multiround,
    move_syndrome,
)
from ldpc_tpu.noise_models import generate_bsc_error


# ----------------------------------------------------------------------
# code_util
# ----------------------------------------------------------------------
def test_generator_matrix_hamming():
    H = np.asarray(hamming_code(3).todense(), np.uint8)
    G = code_util.construct_generator_matrix(H)
    assert (H @ np.asarray(G.todense()).T % 2 == 0).all()
    assert G.shape[0] == 4


def test_code_parameters_hamming():
    H = hamming_code(3)
    n, k, d = code_util.compute_code_parameters(H, timeout_seconds=0.05)
    assert (n, k) == (7, 4)
    assert d == 3


def test_exact_distance():
    assert code_util.compute_exact_code_distance(hamming_code(3)) == 3
    assert code_util.compute_exact_code_distance(rep_code(5)) == 5


def test_search_cycles():
    H = np.asarray(hamming_code(3).todense(), np.uint8)
    # hamming(3) has 4-cycles
    assert code_util.search_cycles(H, 4) is True
    count = code_util.search_cycles(H, 4, terminate=False)
    assert count > 0
    # a repetition code Tanner graph is cycle-free
    assert code_util.search_cycles(
        np.asarray(rep_code(5).todense()), 4
    ) is False


def test_avg_hamming_weights():
    H = np.asarray(rep_code(4).todense())
    col_w, row_w = code_util.compute_avg_hamming_weights(H)
    assert row_w == 2.0


# ----------------------------------------------------------------------
# alist
# ----------------------------------------------------------------------
def test_alist_roundtrip(tmp_path):
    H = np.asarray(hamming_code(3).todense(), np.int64)
    path = os.path.join(tmp_path, "h.alist")
    save_alist(path, H)
    H2 = alist2numpy(path)
    assert np.array_equal(H, H2)


# ----------------------------------------------------------------------
# protograph
# ----------------------------------------------------------------------
def test_ring_of_circulants_algebra():
    a = protograph.RingOfCirculantsF2([1, 2])
    b = protograph.RingOfCirculantsF2([0, 1])
    assert (a + a).len() == 0  # characteristic 2
    prod = a * b
    assert sorted(prod.coefficients) == [1, 2, 2, 3] or sorted(
        prod.coefficients
    ) == [1, 3]  # (1,2)*(0,1) = x+x^2+x^2+x^3 = x+x^3
    assert sorted(prod.coefficients) == [1, 3]
    assert a.T == protograph.RingOfCirculantsF2([-1, -2])
    assert 2 * a == protograph.RingOfCirculantsF2([])
    assert 3 * a == a


def test_protograph_lift():
    proto = protograph.array([[(0,), (1,)], [(), (0, 1)]])
    B = proto.to_binary(3)
    assert B.shape == (6, 6)
    # block (0,0) = identity, block (1,0) = zero
    assert np.array_equal(B[:3, :3], np.identity(3, dtype=int))
    assert not B[3:, :3].any()
    assert B[3:, 3:].sum() == 6  # two permutation matrices XORed
    eye = protograph.identity(2)
    assert np.array_equal(eye.to_binary(4), np.identity(8, dtype=int))
    stacked = protograph.vstack([proto, protograph.zeros((1, 2))])
    assert stacked.shape == (3, 2)


# ----------------------------------------------------------------------
# noise models + Monte Carlo
# ----------------------------------------------------------------------
def test_generate_bsc_error():
    np.random.seed(0)
    e = generate_bsc_error(1000, 0.1)
    assert e.shape == (1000,)
    assert 50 < e.sum() < 200


def test_monte_carlo_bsc_simulation():
    from ldpc_tpu import BpOsdDecoder

    H = rep_code(11)
    dec = BpOsdDecoder(H, error_rate=0.05, max_iter=15)
    sim = MonteCarloBscSimulation(
        parity_check_matrix=np.asarray(H.todense(), np.uint8),
        error_rate=0.05,
        Decoder=dec,
        target_run_count=300,
        tqdm_disable=True,
        seed=42,
        batch_size=128,
    )
    result = sim.run()
    assert result["run_count"] == 300
    # rep code at p=0.05: decoding usually succeeds
    assert result["logical_error_rate"] < 0.3
    # checkpoint/resume determinism
    state = sim.checkpoint()
    sim2 = MonteCarloBscSimulation(
        parity_check_matrix=np.asarray(H.todense(), np.uint8),
        error_rate=0.05,
        Decoder=dec,
        target_run_count=400,
        tqdm_disable=True,
        batch_size=128,
    )
    sim2.restore(state)
    r2 = sim2.run()
    sim.target_run_count = 400
    r1 = sim.run()
    assert r1["fail_count"] == r2["fail_count"]


def test_mcs_validation():
    with pytest.raises(ValueError):
        MonteCarloBscSimulation(parity_check_matrix=[[1, 0]], error_rate=0.1)
    with pytest.raises(ValueError):
        MonteCarloBscSimulation(
            parity_check_matrix=np.eye(2), error_rate=1.5
        )


# ----------------------------------------------------------------------
# multiround / sliding window
# ----------------------------------------------------------------------
def test_build_multiround_pcm_shape():
    H = np.asarray(rep_code(4).todense(), np.uint8)
    reps = 3
    H3D = build_multiround_pcm(H, reps)
    m, n = H.shape
    assert H3D.shape == ((reps + 1) * m, (reps + 1) * n + (reps + 1) * m)


def test_decode_multiround_rep_code():
    """Noiseless multi-round decode recovers a static data error."""
    from ldpc_tpu import BpOsdDecoder

    H = np.asarray(rep_code(5).todense(), np.uint8)
    m, n = H.shape
    reps = 4  # window of 4 rounds (2 commit + 2 tentative)
    H3D = build_multiround_pcm(H, reps - 1)
    channel = np.full(H3D.shape[1], 0.05)
    dec = BpOsdDecoder(
        H3D.tocsr(), error_channel=list(channel), max_iter=25,
        osd_method="osd_0",
    )
    err = np.zeros(n, np.uint8)
    err[2] = 1
    syndrome = np.tile((H @ err % 2)[:, None], (1, reps)).astype(np.int32)
    decoded, syndrome_out, _, _ = decode_multiround(
        syndrome.copy(), H, dec, channel, repetitions=reps, last_round=True,
    )
    assert np.array_equal(H @ decoded % 2, H @ err % 2)


def test_move_syndrome():
    s = np.arange(12).reshape(3, 4)
    moved = move_syndrome(s)
    assert np.array_equal(moved[:, :2], s[:, 2:])
    assert not moved[:, 2:].any()


def test_bp_params():
    p = BpParams.from_dict({"bp_method": "ms", "max_bp_iter": 7, "junk": 1})
    assert p.bp_method == "ms"
    assert p.max_bp_iter == 7


# ----------------------------------------------------------------------
# legacy v1 shims
# ----------------------------------------------------------------------
def test_legacy_v1_decoders():
    H = np.asarray(rep_code(8).todense(), np.uint8)
    with pytest.warns(UserWarning, match="ldpc v1"):
        dec = ldpc_tpu.bp_decoder(H, error_rate=0.1, bp_method="ps")
    e = np.zeros(8, np.uint8)
    e[3] = 1
    s = H @ e % 2
    x = dec.decode(s)
    assert np.array_equal(H @ x % 2, s)
    with pytest.warns(UserWarning, match="ldpc v1"):
        dec2 = ldpc_tpu.bposd_decoder(
            H, error_rate=0.1, bp_method="ms", osd_method="osd_cs", osd_order=2
        )
    x2 = dec2.decode(s)
    assert np.array_equal(H @ x2 % 2, s)
    # channel_probs constructor route
    with pytest.warns(UserWarning):
        dec3 = ldpc_tpu.bp_decoder(H, channel_probs=list(np.full(8, 0.1)))
    assert np.allclose(dec3.channel_probs, 0.1)


def test_classical_decode_sim_v1_shim():
    """LDPCv1 bp_decode_sim API shim (the reference's own example imports
    it though v2 no longer ships it)."""
    from ldpc_tpu.bp_decode_sim import classical_decode_sim

    out = classical_decode_sim(
        rep_code(50),
        0.2,
        target_runs=200,
        max_iter=10,
        seed=3,
        bp_method="ms",
        ms_scaling_factor=1.0,
        output_dict={"code_type": "rep_code_50"},
    )
    assert out["run_count"] == 200
    assert 0 <= out["fail_count"] <= 200
    assert out["code_type"] == "rep_code_50"
    assert out["word_error_rate"] == out["fail_count"] / 200


def test_examples_compile():
    import pathlib
    import py_compile

    root = pathlib.Path(__file__).resolve().parent.parent / "examples"
    for f in sorted(root.glob("*.py")):
        py_compile.compile(str(f), doraise=True)


def test_data_utils_merge_pipeline(tmp_path):
    """Round-trip of the result-merge pipeline: per-worker JSON files in
    subfolders merge into <parent>/<code_name>.json with summed tallies
    and recomputed rates (reference: data_utils.py:255-463)."""
    import json

    from ldpc_tpu.monte_carlo_simulation.data_utils import (
        _combine_xz_data,
        calculate_error_rates,
        extract_settings,
        load_data,
        merge_datasets,
        merge_json_files,
        merge_json_files_xz,
    )

    d1 = {
        "code_K": 2,
        "nr_runs": 100,
        "x_success_cnt": 90,
        "z_success_cnt": 95,
        "p": 0.01,
    }
    d2 = {
        "code_K": 2,
        "nr_runs": 300,
        "x_success_cnt": 280,
        "z_success_cnt": 290,
        "p": 0.01,
    }
    merged = merge_datasets([d1, d2])
    assert merged["nr_runs"] == 400
    assert merged["x_success_cnt"] == 370
    assert merged["z_success_cnt"] == 385
    ler, ler_eb, wer, wer_eb = calculate_error_rates(370, 400, {"k": 2})
    assert merged["x_ler"] == ler and merged["x_wer"] == wer

    # on-disk layout: <root>/<code>/<config>/<id>.json
    root = tmp_path / "results"
    cfg = root / "toric" / "per_1e-2"
    cfg.mkdir(parents=True)
    (cfg / "id_0.json").write_text(json.dumps(d1))
    (cfg / "id_1.json").write_text(json.dumps(d2))
    (cfg / "broken.json").write_text("{not json")  # skipped, not fatal
    merge_json_files(str(root / "toric"))
    out = json.loads((root / "toric.json").read_text())
    assert len(out) == 1 and out[0]["nr_runs"] == 400

    # x/z split merge: datasets missing a side are excluded from it
    (cfg / "id_0.json").write_text(
        json.dumps({"code_K": 2, "nr_runs": 100, "x_success_cnt": 90})
    )
    (cfg / "id_1.json").write_text(
        json.dumps({"code_K": 2, "nr_runs": 50, "z_success_cnt": 45})
    )
    merge_json_files_xz(str(root / "toric"))
    out = json.loads((root / "toric.json").read_text())[0]
    assert out["x_runs"] == 100 and out["x_success_cnt"] == 90
    assert out["z_runs"] == 50 and out["z_success_cnt"] == 45

    # load_data falls back to merging the per-worker directory
    loaded = load_data([str(root / "toric.json")])
    assert loaded[0][0]["x_runs"] == 100
    missing = root / "toric2"
    (missing / "cfg").mkdir(parents=True)
    (missing / "cfg" / "id_0.json").write_text(json.dumps(d1))
    loaded = load_data([str(root / "toric2.json")])
    assert loaded[0][0]["nr_runs"] == 100

    # settings extraction over a JSON-lines parameter file
    params = tmp_path / "params.jsonl"
    params.write_text(
        '{"p": 0.01, "code": "a"}\n{"p": 0.02, "code": "a"}\n'
    )
    settings = extract_settings(params)
    assert settings == {"p": [0.01, 0.02], "code": ["a"]}

    assert _combine_xz_data(None, None) == {}


def test_data_utils_create_outpath(tmp_path):
    from ldpc_tpu.monte_carlo_simulation.data_utils import create_outpath

    f1 = create_outpath(
        codename="toric",
        bias=[1.0, 1.0, 1.0],
        rounds=8,
        repetitions=4,
        data_err_rate=0.01,
        syndr_err_rate=0.02,
        results_root=str(tmp_path / "results"),
    )
    assert f1.endswith("id_0.json") and os.path.exists(f1)
    # no-overwrite: the next call reserves the next id
    f2 = create_outpath(
        codename="toric",
        bias=[1.0, 1.0, 1.0],
        rounds=8,
        repetitions=4,
        data_err_rate=0.01,
        syndr_err_rate=0.02,
        results_root=str(tmp_path / "results"),
    )
    assert f2.endswith("id_1.json")


def test_merge_decoder_bench_sweeps(tmp_path):
    """Sweep merging: best rate wins, notes survive, cross-sweep median
    and recomputed baselines land in the artifact."""
    import json
    import subprocess
    import sys

    s1 = tmp_path / "s1.jsonl"
    s2 = tmp_path / "s2.jsonl"
    out = tmp_path / "merged.jsonl"
    s1.write_text(
        json.dumps({"decoder": "X", "rate": 100.0, "rate_best": 110.0,
                    "baseline": 10.0, "note": "caveat"}) + "\n"
    )
    s2.write_text(
        json.dumps({"decoder": "X", "rate": 140.0, "rate_best": 150.0,
                    "baseline": 12.0}) + "\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run(
        [sys.executable, os.path.join(root, "tools", "merge_decoder_bench.py"),
         str(out), str(s1), str(s2)],
        check=True, capture_output=True,
    )
    rec = json.loads(out.read_text().strip())
    assert rec["rate"] == 140.0                      # best sweep wins
    assert rec["note"] == "caveat"                   # note survives
    assert rec["rate_median_sweeps"] == 140.0        # median of {100,140}
    assert rec["baseline"] == 11.0                   # median baseline
    assert rec["vs_matched_baseline"] == round(140.0 / 11.0, 2)
    assert rec["sweeps"] == 2


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and no other directory is set;
    without it the cache sits at the fixed <checkout>/.jax_cache."""
    import jax

    from ldpc_tpu.utils.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            want = os.path.join(root, ".jax_cache")
            assert enable_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py measures the GPU only: on the CPU it exits non-zero
    and never prints the success line."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "chip_smoke.py")],
        cwd=root, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
