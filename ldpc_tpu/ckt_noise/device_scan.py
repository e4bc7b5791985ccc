"""Device-resident overlapping-window decoding for DEM-based decoders.

The host OWD loop (base_overlapping_window_decoder.py) decodes windows
sequentially with one ``decode_batch`` round-trip per window — fine for a
handful of windows, but a 100-round memory experiment pays ~50 host
round-trips per batch. Circuit DEMs from repeated measurement rounds are
*time-translation invariant*: every window sees the same check
sub-matrix, shifted along the error-mechanism axis by a constant stride.
This module detects that structure and compiles the WHOLE window loop —
syndrome adjustment from committed corrections, per-window BP(+OSD-0 /
LSD-0), commits — into ONE ``lax.scan`` on device (the sequence-axis
analog of ``parallel/window.py``'s multiround-PCM scan, applied to the
reference's DEM-based decoder family,
reference: base_overlapping_window_decoder.py:89-137,
lsd_overlapping_window.py:11).

Irregular DEMs (boundary windows that differ structurally) return None
from :func:`analyze_uniform_windows` and keep the host loop.
"""

from typing import NamedTuple, Optional

import numpy as np
from scipy.sparse import csr_matrix

import jax
import jax.numpy as jnp
from jax import lax


class UniformWindows(NamedTuple):
    """Time-translation-invariant window structure of a DCM."""

    NW: int  # number of windows (= decodings)
    w_lo: int  # first scanned window (boundary windows stay on host)
    w_hi: int  # one past the last scanned window
    R: int  # detector rows per window
    stride_rows: int  # detector-row stride between windows
    lo0: int  # first window's first active column
    col_stride: int  # column stride between windows
    lookback: int  # columns of committed look-back inside each window
    wdec: int  # active columns per window (incl. look-back)
    commit_span: int  # columns committed per non-final window
    H_win: np.ndarray  # (R, wdec) uint8 canonical window matrix
    weights_win: np.ndarray  # (wdec,) base weights restricted to a window
    num_cols: int  # total DCM columns


def analyze_uniform_windows(
    dcm: csr_matrix,
    decodings: int,
    window: int,
    commit: int,
    num_checks: int,
    weights: np.ndarray,
) -> Optional[UniformWindows]:
    """Detect whether every window sees the same (shifted) sub-matrix.

    Mirrors ``current_round_inds`` (base_overlapping_window_decoder.py:
    287-334) for the active-column ranges, then requires: constant
    active width, constant column stride, identical canonical blocks,
    and identical restricted weight vectors. The look-back block is the
    column range shared with previously committed windows (window 0's
    block must be empty-equivalent: all-zero columns in its rows).
    """
    dcm = csr_matrix(dcm)
    R = num_checks * window
    stride_rows = num_checks * commit
    if decodings < 4:
        return None  # too few middle windows to be worth a device scan
    if window > 2 * commit:
        # the scan recomputes each window's committed-syndrome adjustment
        # from scratch; with more than two windows overlapping a row the
        # host loop's telescoping passes cannot be reproduced exactly
        return None
    w_lo, w_hi = 1, decodings - 1  # boundary windows stay on the host
    infos = []
    for w in range(decodings):
        start = w * stride_rows
        rows = dcm[start : start + R, :]
        cols = rows.nonzero()[1]
        if cols.size == 0:
            return None
        crows = dcm[start : start + num_checks * commit, :]
        ccols = crows.nonzero()[1]
        if ccols.size == 0:
            return None
        infos.append(
            dict(
                lo=int(cols.min()),
                hi=int(cols.max()),
                commit_lo=int(ccols.min()),
                commit_hi=int(ccols.max()),
                rows=rows,
            )
        )
    mids = infos[w_lo:w_hi]
    wdec = mids[0]["hi"] - mids[0]["lo"] + 1
    if any(i["hi"] - i["lo"] + 1 != wdec for i in mids):
        return None
    col_stride = mids[1]["lo"] - mids[0]["lo"]
    if any(
        mids[k + 1]["lo"] - mids[k]["lo"] != col_stride
        for k in range(len(mids) - 1)
    ):
        return None
    # committed look-back: columns shared with the previous window's
    # commit region (the host decodes window w_lo-1, so the first
    # scanned window's look-back is committed too)
    lookbacks = [
        infos[w - 1]["commit_hi"] + 1 - infos[w]["lo"]
        for w in range(w_lo, w_hi)
    ]
    lookback = lookbacks[0]
    if lookback < 0 or any(lb != lookback for lb in lookbacks):
        return None
    commit_spans = [i["commit_hi"] - i["lo"] + 1 for i in mids]
    if any(c != commit_spans[0] for c in commit_spans):
        return None
    commit_span = commit_spans[0]
    lo0 = mids[0]["lo"]

    def block(k):
        lo = lo0 + k * col_stride
        return mids[k]["rows"][:, lo : lo + wdec].toarray().astype(np.uint8)

    canon = block(0)
    for k in range(1, len(mids)):
        if block(k).tobytes() != canon.tobytes():
            return None
    weights = np.asarray(weights, np.float64)
    wts = weights[lo0 : lo0 + wdec]
    for k in range(1, len(mids)):
        lo = lo0 + k * col_stride
        if not np.allclose(weights[lo : lo + wdec], wts):
            return None
    return UniformWindows(
        NW=decodings,
        w_lo=w_lo,
        w_hi=w_hi,
        R=R,
        stride_rows=stride_rows,
        lo0=lo0,
        col_stride=col_stride,
        lookback=lookback,
        wdec=wdec,
        commit_span=commit_span,
        H_win=canon,
        weights_win=wts,
        num_cols=dcm.shape[1],
    )


def make_device_owd(
    uw: UniformWindows,
    min_weight: float,
    *,
    max_iter: int = 30,
    bp_method: str = "minimum_sum",
    ms_scaling_factor: float = 0.625,
    postprocess: str = "osd0",
    bits_per_step: int = 1,
):
    """Compile the whole overlapping-window loop into one jitted scan.

    Returns ``decode(shots: (B, num_detectors) uint8) ->
    total_corr (B, num_cols) uint8`` with the exact semantics of
    ``BaseOverlappingWindowDecoder._corr_multiple_rounds_batch``: per
    window, the recorded detectors are XOR-adjusted by the committed
    corrections' syndrome, decoded against the canonical window matrix
    (committed look-back columns re-weighted to ``min_weight``), and the
    commit region (everything, for the final window) accumulates into
    the global correction.
    """
    import scipy.sparse

    from ldpc_tpu.ops import bp as bp_ops
    from ldpc_tpu.ops.pcm import compile_pcm

    H_win = uw.H_win
    graph = compile_pcm(scipy.sparse.csr_matrix(H_win))
    method = (
        bp_ops.MINIMUM_SUM
        if str(bp_method).lower() in ("ms", "min_sum", "minimum_sum", "1")
        else bp_ops.PRODUCT_SUM
    )

    # OWD weights are error PRIORS (probabilities); committed look-back
    # columns get the subclass's _min_weight (0.0 for the BP family:
    # probability zero pins them off for later windows, exactly like the
    # host loop's `weights[commit_inds] = _min_weight` + error_channel
    # rebuild). Window 0's look-back columns are all-zero in its rows
    # (verified by analyze_uniform_windows), so one llr vector serves
    # every window.
    probs_mid = uw.weights_win.copy()
    probs_mid[: uw.lookback] = min_weight
    llr_mid = jnp.asarray(bp_ops.channel_llr(probs_mid, dtype=np.float32))

    bp_fn = bp_ops.make_parallel_decoder(
        graph, method, max_iter, ms_scaling_factor
    )
    if postprocess == "osd0":
        from ldpc_tpu.ops import osd as osd_ops

        _xla = osd_ops.make_osd_decoder(graph, probs_mid, osd_ops.OSD_0, 0)

        def post(syn, llr):
            d0, _, valid = _xla(syn, llr)
            return d0, valid

    elif postprocess == "lsd0":
        from ldpc_tpu.ops import lsd as lsd_ops

        _lsd = lsd_ops.make_lsd_decoder(
            graph,
            lsd_method=lsd_ops.LSD_0,
            lsd_order=0,
            bits_per_step=bits_per_step,
        )

        def post(syn, llr):
            return _lsd(syn, llr)

    else:
        raise ValueError(f"unsupported postprocess {postprocess!r}")

    # committed look-back -> window-syndrome adjustment matrix
    Mb_T = jnp.asarray(H_win[:, : uw.lookback].T.astype(np.float32))
    iota_w = jnp.arange(uw.wdec, dtype=jnp.int32)

    @jax.jit
    def decode(shots, total_in):
        """Scan windows [w_lo, w_hi) given the host-committed state so
        far; returns the updated global correction."""
        B, D = shots.shape
        shots = shots.astype(jnp.uint8)
        pad = uw.wdec
        total0 = jnp.concatenate(
            [total_in.astype(jnp.uint8), jnp.zeros((B, pad), jnp.uint8)],
            axis=1,
        )

        zero = jnp.int32(0)

        def body(total, k):
            w = k + jnp.int32(uw.w_lo)
            start = w * jnp.int32(uw.stride_rows)
            s_win = lax.dynamic_slice(shots, (zero, start), (B, uw.R))
            lo = jnp.int32(uw.lo0) + k * jnp.int32(uw.col_stride)
            lb = lax.dynamic_slice(
                total, (zero, lo), (B, max(uw.lookback, 1))
            )
            if uw.lookback:
                adj = jnp.dot(
                    lb[:, : uw.lookback].astype(jnp.float32),
                    Mb_T,
                    preferred_element_type=jnp.float32,
                )
                adj = (adj - 2.0 * jnp.floor(adj * 0.5)).astype(jnp.uint8)
                s_win = s_win ^ adj
            bp = bp_fn(s_win, llr_mid)
            dec = bp.decoding
            if post is not None:
                x0, _ = post(s_win, bp.llr_posterior)
                dec = jnp.where(bp.converged[:, None], dec, x0)
            commit = dec * (iota_w[None, :] < uw.commit_span).astype(
                dec.dtype
            )
            cur = lax.dynamic_slice(total, (zero, lo), (B, uw.wdec))
            total = lax.dynamic_update_slice(
                total, cur ^ commit, (zero, lo)
            )
            return total, None

        total, _ = lax.scan(
            body,
            total0,
            jnp.arange(uw.w_hi - uw.w_lo, dtype=jnp.int32),
        )
        return total[:, : uw.num_cols]

    return decode
