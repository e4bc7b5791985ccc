"""The fused single-dispatch chunk loop vs the host cascade.

``decode_batch`` has two device paths for parallel-schedule decoders:
the host cascade (host-built buckets, ``_postprocess_cascade_batch``),
which every backend takes, and the fused chunk loop (one jitted program
and one device->host pull per chunk, ``BpDecoderBase._decode_batch_fused``
and ``BpOsdDecoder._decode_batch_chunked``), which a decoder takes when
its ``_USE_FUSED`` switch is on. Per-lane BP, OSD, LSD and union-find
results do not depend on which lanes share a batch, so the two paths
must agree exactly.

Entry points that once chose a kernel by backend are also built here
with ``jax.default_backend`` reporting ``"gpu"`` while the computation
stays on the CPU.
"""

import numpy as np
import pytest

import jax

import ldpc_tpu
from ldpc_tpu.codes import rep_code, surface_code


@pytest.fixture
def as_gpu(monkeypatch):
    """Make every backend-dependent choice take its GPU branch."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def _workload(d=5, p=0.08, B=300, seed=3):
    code = surface_code(d)
    H = np.asarray(code.hx.todense(), np.uint8)
    rng = np.random.default_rng(seed)
    errors = (rng.random((B, H.shape[1])) < p).astype(np.uint8)
    syn = (errors @ H.T % 2).astype(np.uint8)
    syn[7] = 0  # the zero-syndrome fast path inside the programs
    return code, H, syn


_KW = dict(
    error_rate=0.08, max_iter=18, bp_method="minimum_sum",
    ms_scaling_factor=0.625,
)


@pytest.mark.parametrize(
    "family,extra",
    [
        ("BpDecoder", {}),
        ("BpOsdDecoder", dict(osd_method="osd_cs", osd_order=2)),
        ("BpLsdDecoder", dict(lsd_method="lsd_0")),
        ("BeliefFindDecoder", dict(uf_method="inversion")),
        ("BpFlipDecoder", dict(flip_iterations=4)),
    ],
)
def test_fused_loop_matches_host_cascade(family, extra):
    code, H, syn = _workload()
    cls = getattr(ldpc_tpu, family)
    host = cls(code.hx, **_KW, **extra)
    out_host = np.asarray(host.decode_batch(syn))
    assert not host._fused_ok()
    fused = cls(code.hx, **_KW, **extra)
    fused._USE_FUSED = True
    out_fused = np.asarray(fused.decode_batch(syn))
    assert (out_fused == out_host).all()
    assert (fused.converge_batch == host.converge_batch).all()
    assert (
        np.asarray(fused.iter_batch) == np.asarray(host.iter_batch)
    ).all()
    converged = np.asarray(fused.converge_batch)
    assert ((out_fused[converged] @ H.T) % 2 == syn[converged]).all()


def test_fused_decode_batch_two_phase_matches_plain_path():
    """The fused BpOsd program runs a two-phase cascade; its results must
    be element-for-element identical to a single-phase full-depth run of
    the same program (per-lane BP determinism), and its convergence
    flags and iteration counts identical to the host path's."""
    from ldpc_tpu.decoders.bposd_decoder import BpOsdDecoder

    code, H, syn = _workload(p=0.12, seed=3)
    B = syn.shape[0]

    def build():
        return BpOsdDecoder(
            code.hx, error_rate=0.12, max_iter=18,
            bp_method="minimum_sum", ms_scaling_factor=0.625,
            osd_method="osd_0", osd_order=0,
        )

    packed = np.packbits(syn, axis=1, bitorder="little")
    nonzero = syn.any(axis=1)

    ref = build()
    ref._CASCADE_ITERS = 18  # phase-1 == max_iter: single-phase program
    out_ref = ref.decode_batch(syn)  # host path on the CPU
    conv_ref = ref.converge_batch.copy()
    iter_ref = ref.iter_batch.copy()
    out_single = ref._decode_batch_chunked(packed, B, nonzero)
    llr_single = np.asarray(ref.log_prob_ratios_batch)

    dec = build()
    out_fused = dec._decode_batch_chunked(packed, B, nonzero)
    assert (out_fused == out_single).all()
    assert (np.asarray(dec.log_prob_ratios_batch) == llr_single).all()
    assert (dec.converge_batch == conv_ref).all()
    assert (dec.iter_batch == iter_ref).all()
    assert ((out_fused @ H.T) % 2 == syn).all()
    assert ((out_ref @ H.T) % 2 == syn).all()


def test_sparse_export_matches_dense_layout(monkeypatch):
    """The segmented sparse D2H export (base._sparse_export_plan) must
    reconstruct decodings bit-for-bit identical to the dense bit-packed
    layout, for both the generic fused cascade (BpDecoder) and the
    BpOsd fused program; a forced segment-count overflow must fall back
    to a dense redispatch with identical results."""
    from ldpc_tpu.decoders import base as base_mod
    from ldpc_tpu.decoders.bp_decoder import BpDecoder
    from ldpc_tpu.decoders.bposd_decoder import BpOsdDecoder

    code, H, syn = _workload(p=0.01, B=200, seed=5)
    syn[3] = 0

    def build(cls, **kw):
        return cls(
            code.hx, error_rate=0.01, max_iter=12,
            bp_method="minimum_sum", ms_scaling_factor=0.625, **kw,
        )

    B = syn.shape[0]
    packed_syn = np.packbits(syn, axis=1, bitorder="little")
    nonzero = syn.any(axis=1)

    def drive(dec, bit_packed_output=False):
        if isinstance(dec, BpOsdDecoder):
            return dec._decode_batch_chunked(
                packed_syn.copy(), B, nonzero,
                bit_packed_output=bit_packed_output,
            )
        return dec._decode_batch_fused(
            syn, nonzero, post_key="bp_only", post_builder=None,
            bit_packed_output=bit_packed_output,
        )[0]

    for cls, kw in [
        (BpDecoder, {}),
        (BpOsdDecoder, dict(osd_method="osd_0", osd_order=0)),
    ]:
        Bpad = 256
        Wb = -(-H.shape[1] // 8)
        wbar = 0.01 * H.shape[1]
        assert (
            base_mod._sparse_export_plan(Bpad, H.shape[1], Wb, wbar)
            is not None
        ), "sparse plan must engage at this workload"
        d_sparse = build(cls, **kw)
        out_sparse = drive(d_sparse)
        conv_s = d_sparse.converge_batch.copy()
        iter_s = d_sparse.iter_batch.copy()
        # dense layout: force the plan off
        monkeypatch.setattr(base_mod, "_sparse_export_plan", lambda *a: None)
        d_dense = build(cls, **kw)
        out_dense = drive(d_dense)
        monkeypatch.undo()
        assert (out_sparse == out_dense).all()
        assert (conv_s == d_dense.converge_batch).all()
        assert (iter_s == d_dense.iter_batch).all()
        # forced overflow: a 2-slot budget cannot hold real segments ->
        # host must redispatch dense and still return identical bits
        monkeypatch.setattr(
            base_mod,
            "_sparse_export_plan",
            lambda Bp, n, Wb_, w: (-(-(Bp * n) // base_mod._SEG_L), 2),
        )
        d_over = build(cls, **kw)
        out_over = drive(d_over)
        monkeypatch.undo()
        assert (out_over == out_dense).all()
        # bit-packed output goes through the same reconstruction
        packed = drive(build(cls, **kw), bit_packed_output=True)
        up = np.unpackbits(packed, axis=1, count=H.shape[1], bitorder="little")
        assert (up == out_dense).all()


def test_sparse_export_sticky_optout(monkeypatch):
    """One segment overflow must permanently switch the decoder to the
    dense export (base._plan_unless_disabled): heavy-correction codes
    would otherwise pay a dense redispatch on every chunk."""
    from ldpc_tpu.decoders import base as base_mod
    from ldpc_tpu.decoders.bposd_decoder import BpOsdDecoder

    code, H, syn = _workload(p=0.01, B=200, seed=9)
    dec = BpOsdDecoder(
        code.hx, error_rate=0.01, max_iter=12,
        bp_method="minimum_sum", ms_scaling_factor=0.625,
        osd_method="osd_0",
    )
    B = syn.shape[0]
    packed = np.packbits(syn, axis=1, bitorder="little")
    nonzero = syn.any(axis=1)
    # force an overflow: a 1-slot segment budget cannot hold anything
    monkeypatch.setattr(
        base_mod,
        "_sparse_export_plan",
        lambda Bp, n, Wb, w: (-(-(Bp * n) // base_mod._SEG_L), 1),
    )
    out1 = dec._decode_batch_chunked(packed, B, nonzero)
    assert getattr(dec, "_seg_plan_off", False), "overflow must set the flag"
    # once off, the (broken) plan function must not be consulted again
    monkeypatch.setattr(
        base_mod,
        "_sparse_export_plan",
        lambda *a: (_ for _ in ()).throw(AssertionError("consulted")),
    )
    out2 = dec._decode_batch_chunked(packed, B, nonzero)
    assert (out1 == out2).all()


# ----------------------------------------------------------------------
# entry points that once chose a kernel by backend, built as on the GPU
# ----------------------------------------------------------------------
def test_gpu_backend_decode_batch(as_gpu):
    code, H, syn = _workload(p=0.05, B=130, seed=13)
    dec = ldpc_tpu.BpOsdDecoder(code.hx, osd_method="osd_0", **_KW)
    out = dec.decode_batch(syn)
    assert out.shape == syn.shape[:1] + (H.shape[1],)
    assert ((out @ H.T) % 2 == syn).all()
    packed = dec.decode_batch(
        np.packbits(syn, axis=1, bitorder="little"),
        bit_packed_syndromes=True, bit_packed_output=True,
    )
    assert (np.unpackbits(packed, axis=1, count=H.shape[1],
                          bitorder="little") == out).all()


def test_gpu_backend_device_monte_carlo(as_gpu):
    from ldpc_tpu.monte_carlo_simulation import DeviceMonteCarlo

    code = surface_code(3, compute_logicals=True)
    mc = DeviceMonteCarlo(
        code.hx, 0.04, seed=7, logicals=code.lx, batch_size=256,
        rounds_per_call=2, max_iter=8,
    )
    res = mc.run(1024)
    assert res["run_count"] == 1024
    assert res["bucket_overflow"] == 0
    assert 0 <= res["fail_count"] < res["run_count"]


def test_gpu_backend_window_decoder(as_gpu):
    from ldpc_tpu.parallel import make_window_decoder

    H = rep_code(8)
    Hd = np.asarray(H.todense(), np.uint8)
    m, n = Hd.shape
    W, R, B = 4, 8, 16
    rng = np.random.default_rng(3)
    syn = np.zeros((B, m, R), np.uint8)
    err = np.zeros((B, n), np.uint8)
    for t in range(R):
        err ^= (rng.random((B, n)) < 0.01).astype(np.uint8)
        s = (err @ Hd.T) % 2
        if t < R - 1:
            s = s ^ (rng.random((B, m)) < 0.01)
        syn[:, :, t] = s
    res = make_window_decoder(H, W, 0.01, 0.01, max_iter=12)(syn)
    # the final round is perfect: the committed correction closes it
    residual = err ^ np.asarray(res.correction)
    assert ((residual @ Hd.T) % 2 == 0).all(axis=1).mean() > 0.9


def test_gpu_backend_owd_scan(as_gpu):
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_ckt_noise import rep_code_memory_dem

    from ldpc_tpu.ckt_noise import BpOsdOverlappingWindowDecoder
    from ldpc_tpu.ckt_noise.dem_matrices import (
        detector_error_model_to_check_matrices,
    )

    dem = rep_code_memory_dem(n_checks=3, rounds=14)
    kwargs = dict(
        decodings=6, window=4, commit=2, num_checks=3,
        decoder_config={"max_iter": 20},
    )
    dec = BpOsdOverlappingWindowDecoder(dem, **kwargs)
    assert dec._maybe_device_scan() is not None
    host = BpOsdOverlappingWindowDecoder(dem, **kwargs)
    host._device_scan = None  # force the pure host loop
    m = detector_error_model_to_check_matrices(
        dem, allow_undecomposed_hyperedges=True
    )
    Hd = np.asarray(m.check_matrix.todense(), np.uint8)
    rng = np.random.default_rng(11)
    errs = (rng.random((32, Hd.shape[1])) < 0.03).astype(np.uint8)
    shots = ((errs @ Hd.T) % 2).astype(np.uint8)
    assert np.array_equal(
        dec.decode_batch(shots.copy()) % 2,
        host.decode_batch(shots.copy()) % 2,
    )


def test_gpu_backend_union_find(as_gpu):
    code, H, syn = _workload(p=0.03, B=200, seed=17)
    for uf_method in (True, False):
        dec = ldpc_tpu.UnionFindDecoder(code.hx, uf_method=uf_method)
        out = dec.decode_batch(syn)
        assert ((out @ H.T) % 2 == syn).all()
        assert dec.valid_batch.all()
