"""GPU lane: every decoder family on the card, at full width.

The CPU suite pins the CPU backend (conftest.py), so these tests only run
under ``pytest -m gpu`` on a machine with a GPU; ``chip_smoke.py`` runs
them in its own process after it has taken the card. Whether a GPU is
present is decided in the ``gpu`` fixture, so every worker collects the
same tests. Workload: the unrotated surface code d=13 (n=313, m=156),
BSC p=0.01, min-sum alpha=0.625, at most 30 iterations, 4,096 syndromes.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu

P = 0.01
BP_KW = dict(
    error_rate=P, max_iter=30, bp_method="minimum_sum",
    ms_scaling_factor=0.625,
)


@pytest.fixture(scope="module")
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run: python chip_smoke.py)")


def _syndromes(H, B, seed, p=P):
    rng = np.random.default_rng(seed)
    errors = (rng.random((B, H.shape[1])) < p).astype(np.uint8)
    return errors, (errors @ H.T % 2).astype(np.uint8)


@pytest.fixture(scope="module")
def d13(gpu):
    from ldpc_tpu.codes import surface_code

    code = surface_code(13)
    H = np.asarray(code.hx.todense(), np.uint8)
    _, syn = _syndromes(H, 4096, seed=7)
    return code, H, syn


def _valid(out, H, syn):
    return ((np.asarray(out) @ H.T) % 2 == syn).all(axis=1)


def test_bp_decoder(d13):
    import ldpc_tpu

    code, H, syn = d13
    dec = ldpc_tpu.BpDecoder(code.hx, **BP_KW)
    out = dec.decode_batch(syn)
    conv = np.asarray(dec.converge_batch)
    assert out.shape == (syn.shape[0], H.shape[1])
    assert conv.mean() > 0.8
    assert _valid(out, H, syn)[conv].all()


def test_bposd_osd_cs2(d13):
    import ldpc_tpu

    code, H, syn = d13
    dec = ldpc_tpu.BpOsdDecoder(
        code.hx, osd_method="osd_cs", osd_order=2, **BP_KW
    )
    out = dec.decode_batch(syn)
    assert _valid(out, H, syn).all()
    # the OSD-w sweep's dense (B, n, m) and (B, C, m) working sets
    osd = dec._osd_decode_fn()
    llr = jnp.zeros((1024, H.shape[1]), jnp.float32)
    mem = osd.lower(jnp.asarray(syn[:1024]), llr).compile().memory_analysis()
    print(f"\nOSD-CS order 2, d=13, bucket 1024: {mem}")


@pytest.mark.parametrize("uf_method", ["inversion", "peeling"])
def test_belief_find(d13, uf_method):
    import ldpc_tpu

    code, H, syn = d13
    dec = ldpc_tpu.BeliefFindDecoder(code.hx, uf_method=uf_method, **BP_KW)
    assert _valid(dec.decode_batch(syn), H, syn).all()


def test_bplsd_lsd0(d13):
    import ldpc_tpu

    code, H, syn = d13
    dec = ldpc_tpu.BpLsdDecoder(code.hx, lsd_method="lsd_0", **BP_KW)
    assert _valid(dec.decode_batch(syn), H, syn).all()


@pytest.mark.parametrize("uf_method", [True, False])
def test_union_find(d13, uf_method):
    import ldpc_tpu

    code, H, syn = d13
    dec = ldpc_tpu.UnionFindDecoder(code.hx, uf_method=uf_method)
    out = dec.decode_batch(syn)
    assert _valid(out, H, syn).all()
    assert dec.valid_batch.all()


def test_lsd_decoder(d13):
    import ldpc_tpu

    code, H, syn = d13
    dec = ldpc_tpu.LsdDecoder(code.hx, bits_per_step=1)
    weights = np.full(H.shape[1], np.log((1 - P) / P), np.float32)
    assert _valid(dec.decode_batch(syn, weights), H, syn).all()


def test_bp_flip(d13):
    import ldpc_tpu

    code, H, syn = d13
    dec = ldpc_tpu.BpFlipDecoder(code.hx, flip_iterations=4, **BP_KW)
    out = dec.decode_batch(syn)
    conv = np.asarray(dec.converge_batch)
    assert conv.mean() > 0.8
    assert _valid(out, H, syn)[conv].all()


def test_mbp(gpu):
    import ldpc_tpu
    from ldpc_tpu.codes import surface_code

    code = surface_code(13)
    hx = np.asarray(code.hx.todense(), np.uint8)
    hz = np.asarray(code.hz.todense(), np.uint8)
    x_err, sz = _syndromes(hz, 4096, seed=5)
    syn = np.concatenate([sz, np.zeros((4096, hx.shape[0]), np.uint8)], 1)
    dec = ldpc_tpu.MbpDecoder(
        HX_CSS=hx, HZ_CSS=hz, error_rate=P, max_iter=30,
        dtype=jnp.float32,
    )
    out = dec.decode_batch(syn)
    conv = np.asarray(dec.converge_batch)
    outx = ((out == 1) | (out == 2)).astype(np.uint8)
    outz = ((out == 2) | (out == 3)).astype(np.uint8)
    assert conv.mean() > 0.5  # MBP at alpha=1 converges less often than BP
    assert ((outx @ hz.T % 2) == sz)[conv].all()
    assert ((outz @ hx.T % 2) == 0)[conv].all()


@pytest.mark.parametrize("postprocess", ["osd0", "lsd0"])
def test_window_scan(gpu, postprocess):
    """Device window scan on d=13 (W=4, 8 rounds, 256 shots): the last
    round is perfect, so the committed correction closes its syndrome."""
    from ldpc_tpu.codes import surface_code
    from ldpc_tpu.parallel import make_window_decoder

    code = surface_code(13)
    H = np.asarray(code.hx.todense(), np.uint8)
    m, n = H.shape
    W, R, B = 4, 8, 256
    rng = np.random.default_rng(3)
    syn = np.zeros((B, m, R), np.uint8)
    err = np.zeros((B, n), np.uint8)
    for t in range(R):
        err ^= (rng.random((B, n)) < 0.002).astype(np.uint8)
        s = (err @ H.T) % 2
        if t < R - 1:
            s = s ^ (rng.random((B, m)) < 0.002)
        syn[:, :, t] = s
    dec = make_window_decoder(
        code.hx, W, 0.002, 0.002, max_iter=30, postprocess=postprocess
    )
    corr = np.asarray(dec(jnp.asarray(syn)).correction)
    assert ((((err ^ corr) @ H.T) % 2) == 0).all(axis=1).mean() > 0.95


def test_owd_device_scan(gpu):
    """The DEM overlapping-window device scan on a distance-13
    repetition-code memory DEM equals the per-window host loop."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_ckt_noise import rep_code_memory_dem

    from ldpc_tpu.ckt_noise import BpOsdOverlappingWindowDecoder
    from ldpc_tpu.ckt_noise.dem_matrices import (
        detector_error_model_to_check_matrices,
    )

    dem = rep_code_memory_dem(n_checks=12, rounds=14)
    kwargs = dict(
        decodings=6, window=4, commit=2, num_checks=12,
        decoder_config={"max_iter": 30},
    )
    dec = BpOsdOverlappingWindowDecoder(dem, **kwargs)
    assert dec._maybe_device_scan() is not None
    host = BpOsdOverlappingWindowDecoder(dem, **kwargs)
    host._device_scan = None
    m = detector_error_model_to_check_matrices(
        dem, allow_undecomposed_hyperedges=True
    )
    Hd = np.asarray(m.check_matrix.todense(), np.uint8)
    _, shots = _syndromes(Hd, 512, seed=11, p=0.02)
    assert np.array_equal(
        dec.decode_batch(shots.copy()) % 2,
        host.decode_batch(shots.copy()) % 2,
    )


def test_toric20_bposd_osd0(gpu):
    import ldpc_tpu
    from ldpc_tpu.codes import toric_code

    code = toric_code(20)
    H = np.asarray(code.hx.todense(), np.uint8)
    _, syn = _syndromes(H, 4096, seed=9)
    dec = ldpc_tpu.BpOsdDecoder(code.hx, osd_method="osd_0", **BP_KW)
    assert _valid(dec.decode_batch(syn), H, syn).all()
    # compile only: the OSD-CS-2 sweep's dense working sets at n=800
    osd = ldpc_tpu.BpOsdDecoder(
        code.hx, osd_method="osd_cs", osd_order=2, **BP_KW
    )._osd_decode_fn()
    llr = jnp.zeros((1024, H.shape[1]), jnp.float32)
    mem = osd.lower(jnp.asarray(syn[:1024]), llr).compile().memory_analysis()
    print(f"\nOSD-CS order 2, toric d=20, bucket 1024: {mem}")
