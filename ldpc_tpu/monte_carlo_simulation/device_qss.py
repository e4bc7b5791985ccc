"""Device-resident quasi-single-shot (QSS) pipeline.

The reference QSS simulator decodes one shot at a time on the host:
per round it samples a Pauli error on top of the residual, extracts a
noisy syndrome, and every ``repetitions//2`` rounds runs a sliding
window of the space-time PCM through BP+OSD, feeding the committed
correction back into the running error (reference:
src_python/ldpc/monte_carlo_simulation/quasi_single_shot_v2.py:210-298,
memory_experiment_v2.py:72-160).

Here the WHOLE experiment lives on the accelerator, batched over shots:

    keys -> per-round Pauli sampling with residual feedback
         -> syndrome extraction (0/1 matmul) + measurement noise (binary or
            analog-Gaussian)
         -> sliding-window decode on the space-time PCM (fused BP +
            OSD-0 fallback) inside a ``lax.scan`` over windows
         -> committed-correction feedback (err ^= commit, tentative-
            region syndrome propagation, time-boundary bit carry)
         -> final logical check -> counter psum

One jitted call simulates ``batch_size`` complete multi-round shots;
the per-window decode engine is shared with
:mod:`ldpc_tpu.parallel.window` (the same fused kernels and priors).
Sampling uses ``jax.random`` counters, so results are reproducible and
the step shards over a mesh ``batch`` axis with one counter psum
(:func:`make_sharded_qss_step`).
"""

from typing import Dict, Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ldpc_tpu.helpers import convert_to_binary_sparse
from ldpc_tpu.monte_carlo_simulation.simulation_utils import (
    error_channel_setup,
    get_sigma_from_syndr_er,
)


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def make_qss_step(
    pcm,
    per: float,
    ser: float,
    logicals,
    *,
    repetitions: int,
    rounds: int,
    xyz_error_bias: Sequence[float] = (1.0, 1.0, 1.0),
    check_side: str = "X",
    analog_tg: bool = False,
    batch_size: int = 1024,
    max_iter: int = 30,
    bp_method: str = "minimum_sum",
    ms_scaling_factor: float = 0.625,
    osd: bool = True,
):
    """Build a jitted batched QSS step ``fn(key) -> counters``.

    Per call: ``batch_size`` complete shots of ``rounds`` noisy
    measurement rounds each, decoded with sliding windows of
    ``repetitions`` rounds (committing half a window at a time, final
    round perfect). Counters (int32):
    ``[runs, logical_fails, bp_iters_total, windows_decoded]``.

    Semantics match ``QssSimulator._single_sample`` (reference
    quasi_single_shot_v2.py:210-298) with a batched device RNG instead
    of the host's sequential numpy stream: per round one uniform per
    qubit selects Z/X/Y hits that flip the tracked residual component
    (reference simulation_utils.py:90-127); binary measurement noise is
    Bernoulli(``ser``-channel) per check, or with ``analog_tg`` a
    Gaussian-smeared signed syndrome whose sign gives the hard bit and
    whose magnitude re-initialises the time-like BP priors
    (simulation_utils.py:156-163).
    """
    if repetitions % 2 != 0:
        raise ValueError("repetitions must be even")
    W = int(repetitions)
    T = W // 2
    R = int(rounds)
    if R < W or R % T:
        raise ValueError(
            f"rounds={R} must be a multiple of {T} and >= repetitions={W} "
            "so every window fills completely"
        )
    NW = R // T - 1  # number of window decodes

    pcm = convert_to_binary_sparse(pcm)
    m, n = pcm.shape
    B = _round_up(int(batch_size), 8)

    # channels exactly as QssSimulator.__init__ (quasi_single_shot_v2.py)
    xb, yb, zb = error_channel_setup(per, xyz_error_bias, n)
    xs, ys, zs = error_channel_setup(ser, xyz_error_bias, m)
    if check_side == "X":
        err_idx = 1  # Z data errors flip X checks
        data_channel = yb + zb
        syndr_channel = zs + ys
    elif check_side == "Z":
        err_idx = 0
        data_channel = xb + yb
        syndr_channel = xs + ys
    else:
        raise ValueError("check_side must be 'X' or 'Z'")

    # deferred: ldpc_tpu.parallel.window itself imports from this package
    from ldpc_tpu.parallel.window import _build_core

    sigma = get_sigma_from_syndr_er(syndr_channel[0]) if analog_tg else None
    core = _build_core(
        pcm,
        W,
        data_channel,
        syndr_channel,
        max_iter=max_iter,
        bp_method=bp_method,
        ms_scaling_factor=ms_scaling_factor,
        osd=osd,
        sigma=sigma,
    )

    Hf = jnp.asarray(np.asarray(pcm.todense(), np.float32))  # (m, n)
    L = jnp.asarray(
        np.asarray(convert_to_binary_sparse(logicals).todense(), np.float32)
    )
    pz = jnp.asarray(zb if err_idx == 1 else np.zeros(n), jnp.float32)
    # threshold layout of one uniform draw per qubit (reference
    # simulation_utils.py:104-125): [0,pz) -> Z, [pz,pz+px) -> X,
    # [pz+px,pz+px+py) -> Y. The tracked component flips on Z|Y hits
    # (err_idx=1) or X|Y hits (err_idx=0).
    t0 = jnp.asarray(zb, jnp.float32)
    t1 = jnp.asarray(zb + xb, jnp.float32)
    t2 = jnp.asarray(zb + xb + yb, jnp.float32)
    p_syn = jnp.asarray(syndr_channel, jnp.float32)
    sig_f = jnp.float32(0.0 if sigma is None else sigma)

    def mod2_mm(x_u8, A_f32_t):
        y = jnp.dot(
            x_u8.astype(jnp.float32), A_f32_t,
            preferred_element_type=jnp.float32,
        )
        return (y - 2.0 * jnp.floor(y * 0.5)).astype(jnp.uint8)

    def sample_round(err, key, is_final):
        """One measurement round: flip residual, measure noisily."""
        ku, kn = jax.random.split(key)
        u = jax.random.uniform(ku, (B, n), jnp.float32)
        if err_idx == 1:
            hit = (u < t0[None, :]) | (
                (u >= t1[None, :]) & (u < t2[None, :])
            )
        else:
            hit = (u >= t0[None, :]) & (u < t2[None, :])
        err = err ^ hit.astype(jnp.uint8)
        s = mod2_mm(err, Hf.T)
        if analog_tg:
            g = jax.random.normal(kn, (B, m), jnp.float32)
            signed = 1.0 - 2.0 * s.astype(jnp.float32)
            analog = signed + jnp.where(is_final, 0.0, sig_f) * g
            s_noisy = (analog < 0).astype(jnp.uint8)
        else:
            flip = (
                jax.random.uniform(kn, (B, m), jnp.float32) < p_syn[None, :]
            ).astype(jnp.uint8)
            s_noisy = jnp.where(is_final, s, s ^ flip)
            analog = jnp.zeros((B, m), jnp.float32)
        return err, s_noisy, analog

    def fill_rounds(err, key, r0):
        """Sample T consecutive rounds starting at global round r0.

        Returns (err, (B, m, T) syndromes, (B, m, T) analog)."""

        def body(carry, t):
            err = carry
            gr = r0 + t
            err, s, a = sample_round(
                err, jax.random.fold_in(key, gr), gr == R - 1
            )
            return err, (s, a)

        err, (ss, aa) = lax.scan(body, err, jnp.arange(T), length=T)
        return err, ss.transpose(1, 2, 0), aa.transpose(1, 2, 0)

    def decode_window(err, buf, abuf, iters, is_last):
        """Decode the full (B, m, W) buffer; feed the commit back."""
        diff = jnp.concatenate(
            [buf[:, :, :1], buf[:, :, 1:] ^ buf[:, :, :-1]], axis=2
        )
        syn_flat = diff.transpose(0, 2, 1).reshape(B, W * m)
        if analog_tg:
            a_flat = abuf.transpose(0, 2, 1).reshape(B, W * m)
            llr_t = jnp.abs(2.0 * a_flat / sig_f**2).astype(jnp.float32)
            last_blk = jnp.arange(W * m) >= (W - 1) * m
            llr_t = jnp.where(
                is_last & last_blk[None, :], core.llr_time_last, llr_t
            )
            init_llr = jnp.concatenate(
                [
                    jnp.broadcast_to(
                        core.llr_space[None, :], (B, core.n_space)
                    ),
                    llr_t,
                ],
                axis=1,
            )
        else:
            init_llr = jnp.where(is_last, core.llr_last, core.llr_mid)
        decoding, bp_iters = core.window_decode(syn_flat, init_llr)
        space = decoding[:, : core.n_space].reshape(B, W, n)
        n_commit = jnp.where(is_last, W, T)
        rmask = (jnp.arange(W)[None, :, None] < n_commit).astype(jnp.uint8)
        commit = (jnp.sum(space * rmask, axis=1) % 2).astype(jnp.uint8)
        err = err ^ commit  # feedback: the decoder corrects the device
        # slide the window: tentative half ^ committed-correction
        # syndrome; its first column also absorbs the time-boundary bit
        # (decode_multiround, memory_experiment_v2.py:134-144)
        corr_syn = mod2_mm(commit, Hf.T)
        tc = decoding[:, core.n_space :].reshape(B, W, m)[:, T - 1, :]
        shifted = buf[:, :, T:] ^ corr_syn[:, :, None]
        shifted = shifted.at[:, :, 0].set(shifted[:, :, 0] ^ tc)
        buf = jnp.concatenate(
            [shifted, jnp.zeros((B, m, T), jnp.uint8)], axis=2
        )
        abuf = jnp.concatenate(
            [abuf[:, :, T:], jnp.zeros((B, m, T), jnp.float32)], axis=2
        )
        return err, buf, abuf, iters + bp_iters

    def step(key):
        err0 = jnp.zeros((B, n), jnp.uint8)
        err, s_first, a_first = fill_rounds(err0, key, 0)
        buf = jnp.concatenate(
            [s_first, jnp.zeros((B, m, T), jnp.uint8)], axis=2
        )
        abuf = jnp.concatenate(
            [a_first, jnp.zeros((B, m, T), jnp.float32)], axis=2
        )

        def body(carry, w):
            err, buf, abuf, iters = carry
            err, ss, aa = fill_rounds(err, key, (w + 1) * T)
            buf = lax.dynamic_update_slice(buf, ss, (0, 0, T))
            abuf = lax.dynamic_update_slice(abuf, aa, (0, 0, T))
            carry = decode_window(err, buf, abuf, iters, w == NW - 1)
            return carry, None

        carry0 = (err, buf, abuf, jnp.zeros((B,), jnp.int32))
        (err, _, _, iters), _ = lax.scan(
            body, carry0, jnp.arange(NW), length=NW
        )
        lpar = mod2_mm(err, L.T)
        fails = (lpar > 0).any(axis=1).sum().astype(jnp.int32)
        return jnp.stack(
            [
                jnp.int32(B),
                fails,
                iters.sum().astype(jnp.int32),
                jnp.int32(B * NW),
            ]
        )

    return jax.jit(step), B


def make_sharded_qss_step(
    pcm,
    per: float,
    ser: float,
    logicals,
    *,
    mesh=None,
    batch_size_per_device: int = 1024,
    **kwargs,
):
    """Multi-chip QSS: data-parallel over the mesh ``batch`` axis via
    ``jax.shard_map``; every device simulates its own shots on its own
    PRNG stream and the counters ride one psum."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ldpc_tpu.parallel import BATCH_AXIS, make_mesh

    if mesh is None:
        mesh = make_mesh()
    axis = BATCH_AXIS if BATCH_AXIS in mesh.axis_names else mesh.axis_names[0]
    ndev = mesh.shape[axis]
    local_step, runs_local = make_qss_step(
        pcm, per, ser, logicals, batch_size=batch_size_per_device, **kwargs
    )

    def sharded(keys):
        return jax.lax.psum(local_step(keys[0]), axis)

    fn = jax.jit(
        jax.shard_map(
            sharded,
            mesh=mesh,
            in_specs=P(axis),
            out_specs=P(),
            check_vma=False,
        )
    )

    def step(key):
        keys = jax.device_put(
            jax.random.split(key, ndev), NamedSharding(mesh, P(axis))
        )
        return fn(keys)

    return step, runs_local * ndev


class DeviceQss:
    """Accelerator-resident QSS logical-error-rate estimator.

    Batched drop-in for :class:`QssSimulator.run` on large sample
    counts: same channel setup, window schedule and feedback semantics,
    but thousands of shots per device dispatch. ``checkpoint()`` /
    ``restore()`` serialise the counters + PRNG position for exact
    resume, like :class:`DeviceMonteCarlo`.
    """

    def __init__(
        self,
        H,
        per: float,
        ser: float,
        L,
        *,
        seed: int = 0,
        code_params: Optional[Dict] = None,
        check_side: str = "X",
        **kwargs,
    ):
        self._step, self.runs_per_call = make_qss_step(
            H, per, ser, L, check_side=check_side, **kwargs
        )
        self.check_side = check_side
        self.per = per
        self.ser = ser
        L = convert_to_binary_sparse(L)
        self.code_params = code_params or {
            "n": convert_to_binary_sparse(H).shape[1],
            "k": max(L.shape[0], 1),
        }
        self.seed = seed
        self.calls = 0
        self.counters = np.zeros(4, np.int64)

    def run(self, samples: int) -> Dict:
        from ldpc_tpu.monte_carlo_simulation.data_utils import (
            calculate_error_rates,
        )

        while self.counters[0] < samples:
            out = self._step(
                jax.random.fold_in(jax.random.key(self.seed), self.calls)
            )
            self.calls += 1
            self.counters += np.asarray(out, np.int64)
        runs, fails, iters, windows = map(int, self.counters)
        ler, ler_eb, wer, wer_eb = calculate_error_rates(
            runs - fails, runs, self.code_params
        )
        side = "z" if self.check_side == "X" else "x"
        return {
            f"{side}_ler": ler,
            f"{side}_ler_eb": ler_eb,
            f"{side}_wer": wer,
            f"{side}_wer_eb": wer_eb,
            f"{side}_success_cnt": runs - fails,
            "nr_runs": runs,
            "p": self.per,
            "s": self.ser,
            "bp_iterations": iters / max(windows, 1),
            "windows_decoded": windows,
        }

    def checkpoint(self) -> Dict:
        return {
            "seed": self.seed,
            "calls": self.calls,
            "counters": self.counters.tolist(),
        }

    def restore(self, state: Dict) -> None:
        self.seed = int(state["seed"])
        self.calls = int(state["calls"])
        self.counters = np.asarray(state["counters"], np.int64)
