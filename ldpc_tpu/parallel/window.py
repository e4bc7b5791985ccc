"""Device-resident, rounds-sharded overlapping-window decoding.

The measurement-rounds axis is the "sequence length" of circuit-level
decoding (SURVEY.md §2.4/§5: the ring-attention analog). The reference
decodes it with a sequential host loop — one window at a time, one shot
at a time (reference:
src_python/ldpc/monte_carlo_simulation/memory_experiment_v2.py:72-160,
src_python/ldpc/ckt_noise/base_overlapping_window_decoder.py:89-137).
Here the whole window loop is a jitted ``lax.scan`` on device, batched
over shots, and the rounds axis can shard across a mesh:

- :func:`make_window_decoder` — single-program scan over windows of the
  space-time PCM (``build_multiround_pcm``). Per window: difference
  syndromes -> batched BP (+ OSD-0 fallback) -> commit the first half ->
  carry the committed correction's syndrome + the time-boundary bit
  forward. One dispatch decodes ``B`` shots x ``R`` rounds.

- :func:`make_rounds_sharded_window_decoder` — the same computation
  pipelined over a mesh axis: device ``d`` owns a contiguous block of
  windows; shots stream through the devices in microbatches (GPipe-style
  schedule) and the inter-window carry rides ``lax.ppermute`` to the
  right-hand neighbour. Results are bit-identical to the
  single-device scan for any device count: the (window, microbatch)
  computation DAG is unchanged — only its placement moves.

Window semantics (matching ``decode_multiround``, which mirrors
reference memory_experiment_v2.py:72-160):

- windows cover ``W = repetitions`` rounds and slide by ``T = W//2``;
- the decoded space correction of the first ``T`` rounds (XOR over
  rounds) commits; the last window commits all ``W`` rounds;
- the committed correction's syndrome ``H @ commit`` is XORed into every
  later round's syndrome (offline/recorded-data semantics: corrections
  are never fed back into the device under test, so the carry
  accumulates across all remaining windows);
- the committed time-correction of round ``T-1`` is XORed into the first
  column of the next window (reference memory_experiment_v2.py:141-144).
"""

from functools import partial
from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ldpc_tpu.helpers import convert_to_binary_sparse
from ldpc_tpu.monte_carlo_simulation.memory_experiment import (
    build_multiround_pcm,
)
from ldpc_tpu.ops import bp as bp_ops
from ldpc_tpu.ops.pcm import compile_pcm

ROUNDS_AXIS = "rounds"


class WindowDecodeResult(NamedTuple):
    """Result of a multi-window decode.

    correction: (B, n) uint8 — total committed data correction (XOR of
        every window's commit), the analog of the accumulated ``corr``
        in QssSimulator._single_sample.
    bp_iterations: (B,) int32 — BP iterations summed over windows.
    """

    correction: jnp.ndarray
    bp_iterations: jnp.ndarray


def _mod2_matmul_f32(x_u8: jnp.ndarray, Ht_f32: jnp.ndarray) -> jnp.ndarray:
    """(B, n) u8 @ (n, m) f32 -> (B, m) u8 mod 2 (0/1 operands: exact
    at any matmul precision)."""
    y = jnp.dot(
        x_u8.astype(jnp.float32), Ht_f32, preferred_element_type=jnp.float32
    )
    return (y - 2.0 * jnp.floor(y * 0.5)).astype(jnp.uint8)


class _WindowCore(NamedTuple):
    m: int
    n: int
    W: int
    T: int
    n_space: int  # n * W, the space-variable block size of H3D
    Ht_f32: jnp.ndarray  # (n, m) f32, base-PCM transpose for carry syndromes
    llr_mid: jnp.ndarray  # (n3d,) priors for non-final windows
    llr_last: jnp.ndarray  # (n3d,) priors for the final (perfect) window
    llr_space: jnp.ndarray  # (n_space,) space-block priors (analog mode)
    llr_time_last: jnp.ndarray  # scalar prior for the perfect last round
    window_decode: object  # fn(s_win, init_llr) -> (decoding, iterations)
    sigma: Optional[float]


def _build_core(
    pcm,
    repetitions: int,
    data_channel,
    syndr_channel,
    *,
    max_iter: int = 30,
    bp_method: str = "minimum_sum",
    ms_scaling_factor: float = 0.625,
    osd: bool = True,
    postprocess: str = "osd0",
    bits_per_step: int = 1,
    sigma: Optional[float] = None,
    last_round_rate: float = 1e-15,
) -> _WindowCore:
    """Compile the space-time PCM and build the per-window decode engine.

    ``postprocess`` selects the BP fallback inside each window:
    ``"osd0"`` (default, the reference OWD's BpOsd flavour) or
    ``"lsd0"`` (cluster decoding guided by the window BP's posteriors —
    the device-scan counterpart of the reference's LSD overlapping
    window decoder, lsd_overlapping_window.py:11)."""
    if repetitions % 2 != 0:
        raise ValueError("repetitions must be even")
    pcm = convert_to_binary_sparse(pcm)
    m, n = pcm.shape
    W = repetitions
    T = W // 2
    H3D = build_multiround_pcm(pcm, W - 1)
    graph3d = compile_pcm(H3D)
    n_space = n * W

    data_channel = np.broadcast_to(np.asarray(data_channel, np.float64), (n,))
    syndr_channel = np.broadcast_to(
        np.asarray(syndr_channel, np.float64), (m,)
    )
    channel_mid = np.concatenate(
        [np.tile(data_channel, W), np.tile(syndr_channel, W)]
    )
    channel_last = channel_mid.copy()
    channel_last[-m:] = last_round_rate  # the final round is perfect
    llr_mid = jnp.asarray(bp_ops.channel_llr(channel_mid))
    llr_last = jnp.asarray(bp_ops.channel_llr(channel_last))
    llr_space = jnp.asarray(bp_ops.channel_llr(np.tile(data_channel, W)))
    llr_time_last = jnp.float32(
        bp_ops.channel_llr(np.asarray([last_round_rate]))[0]
    )

    method = (
        bp_ops.MINIMUM_SUM
        if str(bp_method).lower() in ("ms", "min_sum", "minimum_sum", "1")
        else bp_ops.PRODUCT_SUM
    )
    if postprocess not in ("osd0", "lsd0"):
        raise ValueError(
            f"window postprocess must be 'osd0' or 'lsd0', not {postprocess}"
        )
    bp_fn = bp_ops.make_parallel_decoder(
        graph3d, method, max_iter, ms_scaling_factor
    )
    osd_fn = None
    if osd and postprocess == "osd0":
        from ldpc_tpu.ops import osd as osd_ops

        _xla_osd = osd_ops.make_osd_decoder(
            graph3d, channel_mid, osd_ops.OSD_0, 0
        )

        def osd_fn(syn, llr):
            d0, _, valid = _xla_osd(syn, llr)
            return d0, valid

    if osd and postprocess == "lsd0":
        from ldpc_tpu.ops import lsd as lsd_ops

        _lsd = lsd_ops.make_lsd_decoder(
            graph3d,
            lsd_method=lsd_ops.LSD_0,
            lsd_order=0,
            bits_per_step=bits_per_step,
        )

        def osd_fn(syn, llr):
            dec, valid = _lsd(syn, llr)
            return dec, valid

    def window_decode(syn_flat, init_llr):
        """Decode one window: (B, m*W) round-major difference syndromes ->
        ((B, n3d) uint8 decoding, (B,) int32 iterations)."""
        bp = bp_fn(syn_flat, init_llr)
        decoding = bp.decoding
        if osd_fn is not None:
            x0, _ = osd_fn(syn_flat, bp.llr_posterior)
            decoding = jnp.where(bp.converged[:, None], decoding, x0)
        return decoding, bp.iterations

    return _WindowCore(
        m=m,
        n=n,
        W=W,
        T=T,
        n_space=n_space,
        Ht_f32=jnp.asarray(np.asarray(pcm.todense(), np.float32).T),
        llr_mid=llr_mid,
        llr_last=llr_last,
        llr_space=llr_space,
        llr_time_last=llr_time_last,
        window_decode=window_decode,
        sigma=sigma,
    )


def _window_step(core: _WindowCore, carry, s_win, is_last, analog_win=None):
    """One window of the scan: apply carries, diff, decode, commit.

    carry = (carry_syn (B,m) u8, tb (B,m) u8, total (B,n) u8,
             iters (B,) i32). ``s_win`` is the raw (B, m, W) slice of the
    recorded syndrome history; ``is_last`` a traced scalar bool.
    """
    carry_syn, tb, total, iters_tot = carry
    m, n, W, T = core.m, core.n, core.W, core.T
    B = s_win.shape[0]

    s_win = s_win ^ carry_syn[:, :, None]
    s_win = s_win.at[:, :, 0].set(s_win[:, :, 0] ^ tb)
    # difference syndromes along the time axis (memory_experiment_v2.py:93-94)
    diff = jnp.concatenate(
        [s_win[:, :, :1], s_win[:, :, 1:] ^ s_win[:, :, :-1]], axis=2
    )
    syn_flat = diff.transpose(0, 2, 1).reshape(B, W * m)  # round-major

    if analog_win is None:
        init_llr = jnp.where(is_last, core.llr_last, core.llr_mid)
    else:
        # analog-syndrome priors: |2 y / sigma^2| per time-like bit
        # (simulation_utils.get_virtual_check_init_vals); the perfect last
        # round pins the final block to certainty
        a_flat = analog_win.transpose(0, 2, 1).reshape(B, W * m)
        llr_t = jnp.abs(2.0 * a_flat / jnp.float32(core.sigma) ** 2).astype(
            jnp.float32
        )
        last_blk = jnp.arange(W * m) >= (W - 1) * m
        llr_t = jnp.where(
            is_last & last_blk[None, :], core.llr_time_last, llr_t
        )
        init_llr = jnp.concatenate(
            [jnp.broadcast_to(core.llr_space[None, :], (B, core.n_space)), llr_t],
            axis=1,
        )

    decoding, iters = core.window_decode(syn_flat, init_llr)
    space = decoding[:, : core.n_space].reshape(B, W, n)
    n_commit = jnp.where(is_last, W, T)
    rmask = (jnp.arange(W)[None, :, None] < n_commit).astype(jnp.uint8)
    commit = (jnp.sum(space * rmask, axis=1) % 2).astype(jnp.uint8)
    tb_new = decoding[:, core.n_space :].reshape(B, W, m)[:, T - 1, :]

    total = total ^ commit
    carry_syn = carry_syn ^ _mod2_matmul_f32(commit, core.Ht_f32)
    return (carry_syn, tb_new.astype(jnp.uint8), total, iters_tot + iters)


def make_window_decoder(
    pcm,
    repetitions: int,
    data_channel,
    syndr_channel,
    *,
    sigma: Optional[float] = None,
    **engine_kwargs,
):
    """Build a jitted batched multi-window decoder.

    Returns ``decode(syndromes, analog=None) -> WindowDecodeResult`` where
    ``syndromes`` is ``(B, m, R)`` uint8 — the recorded cumulative
    syndrome history of ``R = (n_windows + 1) * repetitions//2`` rounds
    (final round perfect, as in a standard memory experiment) — and
    ``analog`` optionally carries (B, m, R) float analog syndrome values
    (requires ``sigma``; reference quasi_single_shot_v2 analog_tg mode).

    The window loop is a ``lax.scan``; everything — difference syndromes,
    BP, OSD-0 fallback, commits, carry propagation — runs in ONE device
    dispatch for the whole batch and history.
    """
    core = _build_core(
        pcm, repetitions, data_channel, syndr_channel, sigma=sigma,
        **engine_kwargs,
    )
    m, n, W, T = core.m, core.n, core.W, core.T

    @partial(jax.jit, static_argnames=())
    def decode(syndromes, analog=None):
        B, m_, R = syndromes.shape
        if m_ != m:
            raise ValueError(f"syndromes rows {m_} != checks {m}")
        if R < W or (R - W) % T:
            raise ValueError(
                f"history of {R} rounds does not tile into windows of "
                f"{W} sliding by {T}"
            )
        NW = (R - W) // T + 1
        syndromes = syndromes.astype(jnp.uint8)

        def body(carry, w):
            s_win = lax.dynamic_slice(
                syndromes, (0, 0, w * T), (B, m, W)
            )
            a_win = (
                lax.dynamic_slice(analog, (0, 0, w * T), (B, m, W))
                if analog is not None
                else None
            )
            carry = _window_step(core, carry, s_win, w == NW - 1, a_win)
            return carry, None

        carry0 = (
            jnp.zeros((B, m), jnp.uint8),
            jnp.zeros((B, m), jnp.uint8),
            jnp.zeros((B, n), jnp.uint8),
            jnp.zeros((B,), jnp.int32),
        )
        (_, _, total, iters), _ = lax.scan(
            body, carry0, jnp.arange(NW), length=NW
        )
        return WindowDecodeResult(correction=total, bp_iterations=iters)

    return decode


def make_rounds_sharded_window_decoder(
    pcm,
    repetitions: int,
    data_channel,
    syndr_channel,
    *,
    mesh,
    n_windows: int,
    microbatches: int = 4,
    axis_name: Optional[str] = None,
    **engine_kwargs,
):
    """Rounds-axis (sequence) parallel window decoding over a mesh.

    Device ``d`` of the ``axis_name`` mesh axis owns windows
    ``[d*wpd, (d+1)*wpd)`` (``wpd = n_windows / n_devices``) and holds
    only its halo'd slice of the syndrome history. Shots stream through
    the device chain in ``microbatches`` chunks on a GPipe-style
    schedule: at tick ``t`` device ``d`` decodes microbatch ``t - d``
    through its local windows, then hands the inter-window carry (the
    committed-correction syndrome + time-boundary bit) to device ``d+1``
    via ``lax.ppermute`` — the boundary exchange of SURVEY.md §2.4's
    sequence-parallel plan. Per-shot commits are disjoint across devices,
    so the total correction is one final psum (mod 2).

    The result is bit-identical to :func:`make_window_decoder` on one
    device: the same (window, microbatch) computations run, only their
    placement changes. Returns ``decode(syndromes (B, m, R) uint8) ->
    WindowDecodeResult`` (``B`` must divide by ``microbatches``).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    core = _build_core(
        pcm, repetitions, data_channel, syndr_channel, **engine_kwargs
    )
    m, n, W, T = core.m, core.n, core.W, core.T

    if axis_name is None:
        axis_name = (
            ROUNDS_AXIS
            if ROUNDS_AXIS in mesh.axis_names
            else mesh.axis_names[0]
        )
    D = mesh.shape[axis_name]
    NW = int(n_windows)
    if NW % D:
        raise ValueError(
            f"n_windows={NW} must divide evenly over {D} mesh devices"
        )
    wpd = NW // D
    LR = (wpd + 1) * T  # local rounds incl. the right halo
    R = (NW + 1) * T
    M = int(microbatches)

    def pipelined(slab):
        """slab: (1, B, m, LR) local shard -> replicated results."""
        slab = slab[0]
        B = slab.shape[0]
        mbs = B // M
        d = lax.axis_index(axis_name)

        def local_windows(raw_mb, carry_syn, tb):
            def wbody(carry, wl):
                s_win = lax.dynamic_slice(
                    raw_mb, (0, 0, wl * T), (mbs, m, W)
                )
                gw = d * wpd + wl
                carry = _window_step(core, carry, s_win, gw == NW - 1)
                return carry, None

            carry0 = (
                carry_syn,
                tb,
                jnp.zeros((mbs, n), jnp.uint8),
                jnp.zeros((mbs,), jnp.int32),
            )
            (carry_syn, tb, total, iters), _ = lax.scan(
                wbody, carry0, jnp.arange(wpd), length=wpd
            )
            return total, iters, carry_syn, tb

        def tick(state, t):
            acc, acc_it, cin_syn, cin_tb = state
            mb = t - d
            active = (mb >= 0) & (mb < M)
            mb_c = jnp.clip(mb, 0, M - 1)
            row0 = mb_c * mbs
            raw_mb = lax.dynamic_slice(slab, (row0, 0, 0), (mbs, m, LR))
            # device 0 starts every microbatch's chain from a zero carry
            use_in = (d != 0)
            carry_syn = jnp.where(use_in, cin_syn, jnp.zeros_like(cin_syn))
            tb = jnp.where(use_in, cin_tb, jnp.zeros_like(cin_tb))
            total, iters, cout_syn, cout_tb = local_windows(
                raw_mb, carry_syn, tb
            )
            upd = jnp.where(active, total.astype(jnp.int32), 0)
            upd_it = jnp.where(active, iters, 0)
            cur = lax.dynamic_slice(acc, (row0, 0), (mbs, n))
            acc = lax.dynamic_update_slice(acc, cur + upd, (row0, 0))
            cur_it = lax.dynamic_slice(acc_it, (row0,), (mbs,))
            acc_it = lax.dynamic_update_slice(
                acc_it, cur_it + upd_it, (row0,)
            )
            perm = [(i, (i + 1) % D) for i in range(D)]
            cin_syn = lax.ppermute(cout_syn, axis_name, perm)
            cin_tb = lax.ppermute(cout_tb, axis_name, perm)
            return (acc, acc_it, cin_syn, cin_tb), None

        state0 = (
            jnp.zeros((B, n), jnp.int32),
            jnp.zeros((B,), jnp.int32),
            jnp.zeros((mbs, m), jnp.uint8),
            jnp.zeros((mbs, m), jnp.uint8),
        )
        (acc, acc_it, _, _), _ = lax.scan(
            tick, state0, jnp.arange(M + D - 1), length=M + D - 1
        )
        total = (lax.psum(acc, axis_name) % 2).astype(jnp.uint8)
        iters = lax.psum(acc_it, axis_name)
        return total, iters

    spec_in = P(axis_name, None, None, None)
    fn = jax.jit(
        jax.shard_map(
            pipelined,
            mesh=mesh,
            in_specs=spec_in,
            out_specs=(P(), P()),
            check_vma=False,
        )
    )

    def decode(syndromes) -> WindowDecodeResult:
        syndromes = np.asarray(syndromes, np.uint8)
        B, m_, R_ = syndromes.shape
        if m_ != m or R_ != R:
            raise ValueError(
                f"expected (B, {m}, {R}) syndromes for n_windows={NW}, "
                f"got {syndromes.shape}"
            )
        if B % M:
            raise ValueError(f"batch {B} must divide by microbatches={M}")
        slab = np.stack(
            [
                syndromes[:, :, d * wpd * T : d * wpd * T + LR]
                for d in range(D)
            ]
        )
        slab = jax.device_put(
            jnp.asarray(slab), NamedSharding(mesh, spec_in)
        )
        total, iters = fn(slab)
        return WindowDecodeResult(correction=total, bp_iterations=iters)

    return decode
