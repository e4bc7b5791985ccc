"""Device-resident windowed (sequence-axis) decoding tests.

Covers the jitted window scan (`make_window_decoder`) against an
independent host-side offline window loop built from the public
BpOsdDecoder API, and the rounds-sharded pipeline
(`make_rounds_sharded_window_decoder`) for bit-exact 1-vs-N device
equivalence on the CPU mesh (SURVEY.md §4.3's multi-device test plan).
"""

import numpy as np
import pytest

import jax

from ldpc_tpu.codes import rep_code, surface_code
from ldpc_tpu.decoders.bposd_decoder import BpOsdDecoder
from ldpc_tpu.monte_carlo_simulation.memory_experiment import (
    build_multiround_pcm,
)
from ldpc_tpu.parallel import (
    make_mesh,
    make_rounds_sharded_window_decoder,
    make_window_decoder,
)


def gen_history(H, R, p_data, p_meas, B, seed):
    """Phenomenological memory-experiment data: cumulative data errors,
    noisy syndromes each round, perfect final round. Returns
    (syndromes (B, m, R) uint8, final_error (B, n) uint8)."""
    H = np.asarray(H.todense()) if hasattr(H, "todense") else np.asarray(H)
    m, n = H.shape
    rng = np.random.default_rng(seed)
    syn = np.zeros((B, m, R), np.uint8)
    err = np.zeros((B, n), np.uint8)
    for t in range(R):
        err ^= (rng.random((B, n)) < p_data).astype(np.uint8)
        s = (err @ H.T) % 2
        if t < R - 1:
            s = s ^ (rng.random((B, m)) < p_meas)
        syn[:, :, t] = s
    return syn, err


def host_offline_window_decode(H, syn_hist, W, data_channel, syndr_channel):
    """Independent host implementation of the offline window loop using
    the public BpOsdDecoder (semantics of decode_multiround,
    reference memory_experiment_v2.py:72-160, on recorded data)."""
    H = np.asarray(H.todense()) if hasattr(H, "todense") else np.asarray(H)
    m, n = H.shape
    T = W // 2
    B, _, R = syn_hist.shape
    NW = (R - W) // T + 1

    H3D = build_multiround_pcm(H, W - 1)
    channel_mid = np.concatenate(
        [
            np.tile(np.broadcast_to(data_channel, (n,)), W),
            np.tile(np.broadcast_to(syndr_channel, (m,)), W),
        ]
    )
    channel_last = channel_mid.copy()
    channel_last[-m:] = 1e-15
    kw = dict(
        max_iter=20,
        bp_method="minimum_sum",
        ms_scaling_factor=0.625,
        osd_method="osd_0",
        osd_order=0,
    )
    dec_mid = BpOsdDecoder(H3D.tocsr(), error_channel=channel_mid.tolist(), **kw)
    dec_last = BpOsdDecoder(
        H3D.tocsr(), error_channel=channel_last.tolist(), **kw
    )

    carry = np.zeros((B, m), np.uint8)
    tb = np.zeros((B, m), np.uint8)
    total = np.zeros((B, n), np.uint8)
    for w in range(NW):
        s_win = syn_hist[:, :, w * T : w * T + W] ^ carry[:, :, None]
        s_win[:, :, 0] ^= tb
        diff = s_win.copy()
        diff[:, :, 1:] ^= s_win[:, :, :-1]
        synf = diff.transpose(0, 2, 1).reshape(B, W * m)
        dec = dec_last if w == NW - 1 else dec_mid
        out = np.asarray(dec.decode_batch(synf)).astype(np.uint8)
        space = out[:, : n * W].reshape(B, W, n)
        ncom = W if w == NW - 1 else T
        commit = (space[:, :ncom].sum(axis=1) % 2).astype(np.uint8)
        tb = out[:, n * W :].reshape(B, W, m)[:, T - 1].astype(np.uint8)
        total ^= commit
        carry ^= ((commit @ H.T) % 2).astype(np.uint8)
    return total


def test_window_decoder_matches_host_loop_rep_code():
    H = rep_code(6)
    W, B, R = 4, 12, 10  # NW = 4 windows
    p_data, p_meas = 0.04, 0.03
    syn, _ = gen_history(H, R, p_data, p_meas, B, seed=11)

    decode = make_window_decoder(
        H, W, p_data, p_meas, max_iter=20
    )
    res = decode(syn)
    host = host_offline_window_decode(H, syn, W, p_data, p_meas)
    np.testing.assert_array_equal(np.asarray(res.correction), host)


def test_window_decoder_matches_host_loop_surface3():
    code = surface_code(3)
    H = code.hx
    W, B, R = 4, 8, 8  # NW = 3 windows
    p_data, p_meas = 0.02, 0.02
    syn, _ = gen_history(H, R, p_data, p_meas, B, seed=7)

    decode = make_window_decoder(
        H, W, p_data, p_meas, max_iter=20
    )
    res = decode(syn)
    host = host_offline_window_decode(H, syn, W, p_data, p_meas)
    np.testing.assert_array_equal(np.asarray(res.correction), host)


def test_window_decoder_zero_syndromes():
    H = rep_code(5)
    decode = make_window_decoder(H, 4, 0.05, 0.02)
    syn = np.zeros((3, H.shape[0], 8), np.uint8)
    res = decode(syn)
    assert not np.asarray(res.correction).any()


def test_window_decoder_low_noise_corrects():
    """At low noise the accumulated correction matches the true final
    cumulative error up to the code's stabilizers (here: exactly, for a
    repetition code at tiny p)."""
    H = rep_code(12)
    W, B, R = 6, 32, 15  # NW = 4
    syn, err = gen_history(H, R, 0.004, 0.003, B, seed=3)
    decode = make_window_decoder(H, W, 0.004, 0.003)
    corr = np.asarray(decode(syn).correction)
    residual = corr ^ err
    Hd = np.asarray(H.todense())
    # every residual must be in the code (valid correction); and at this
    # noise nearly all shots should be exactly corrected
    assert ((residual @ Hd.T) % 2 == 0).all(axis=1).mean() > 0.9
    assert (residual == 0).all(axis=1).mean() > 0.8


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_rounds_sharded_equivalence(ndev):
    """Bit-exact 1-vs-N device equivalence of the rounds-sharded pipeline
    (fixed data): the GPipe schedule + ppermute carries must not change a
    single bit vs the single-device scan."""
    H = rep_code(6)
    W, B = 4, 8
    NW = 8  # divides 1/2/4/8
    T = W // 2
    R = (NW + 1) * T
    syn, _ = gen_history(H, R, 0.03, 0.02, B, seed=21)

    plain = make_window_decoder(H, W, 0.03, 0.02, max_iter=16)
    want = plain(syn)

    mesh = make_mesh(ndev, axis_name="rounds")
    sharded = make_rounds_sharded_window_decoder(
        H,
        W,
        0.03,
        0.02,
        mesh=mesh,
        n_windows=NW,
        microbatches=4,
        max_iter=16,
    )
    got = sharded(syn)
    np.testing.assert_array_equal(
        np.asarray(got.correction), np.asarray(want.correction)
    )
    np.testing.assert_array_equal(
        np.asarray(got.bp_iterations), np.asarray(want.bp_iterations)
    )


def test_window_decoder_analog_mode():
    """Analog-syndrome (soft time-like priors) mode decodes and beats the
    noiseless-guess baseline at moderate noise."""
    H = rep_code(10)
    Hd = np.asarray(H.todense())
    m, n = Hd.shape
    W, B = 4, 24
    NW = 4
    T = W // 2
    R = (NW + 1) * T
    sigma = 0.4
    rng = np.random.default_rng(5)
    syn = np.zeros((B, m, R), np.uint8)
    analog = np.zeros((B, m, R), np.float64)
    err = np.zeros((B, n), np.uint8)
    for t in range(R):
        err ^= (rng.random((B, n)) < 0.01).astype(np.uint8)
        s = (err @ Hd.T) % 2
        if t < R - 1:
            noisy = (1.0 - 2.0 * s) + rng.normal(0, sigma, s.shape)
            analog[:, :, t] = noisy
            syn[:, :, t] = (noisy < 0).astype(np.uint8)
        else:
            analog[:, :, t] = 1.0 - 2.0 * s
            syn[:, :, t] = s
    decode = make_window_decoder(
        H, W, 0.01, 0.05, sigma=sigma
    )
    corr = np.asarray(decode(syn, analog).correction)
    residual = corr ^ err
    assert ((residual @ Hd.T) % 2 == 0).all(axis=1).mean() > 0.8


def test_window_decoder_lsd_engine():
    """The LSD-0 window engine (device-scan counterpart of the
    reference's LSD overlapping-window decoder,
    lsd_overlapping_window.py:11) corrects as well as the OSD-0 engine
    on a low-noise history."""
    H = rep_code(12)
    W, B, R = 6, 32, 15
    syn, err = gen_history(H, R, 0.004, 0.003, B, seed=5)
    decode = make_window_decoder(
        H, W, 0.004, 0.003, postprocess="lsd0"
    )
    corr = np.asarray(decode(syn).correction)
    residual = corr ^ err
    Hd = np.asarray(H.todense())
    assert ((residual @ Hd.T) % 2 == 0).all(axis=1).mean() > 0.9
    assert (residual == 0).all(axis=1).mean() > 0.8

    # surface-code variant: committed corrections close the final round
    Hs = surface_code(5).hx
    syn2, err2 = gen_history(Hs, 10, 0.01, 0.01, 8, seed=7)
    dec2 = make_window_decoder(
        Hs, 4, 0.01, 0.01, postprocess="lsd0"
    )
    corr2 = np.asarray(dec2(syn2).correction)
    Hd2 = np.asarray(Hs.todense())
    residual2 = err2 ^ corr2
    assert ((residual2 @ Hd2.T) % 2 == 0).all(axis=1).mean() > 0.8
