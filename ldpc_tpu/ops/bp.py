"""Batched belief-propagation engines (JAX/XLA).

Batched re-design of the reference BP decoder (reference: src_cpp/bp.hpp).
Instead of pointer-chasing one syndrome at a time, message passing runs over
a batch axis: messages are ``(E, batch)`` arrays in check-major padded edge
layout (batch minor => 128-lane aligned), and every update is a dense
reduction over the small static ``dc``/``dv`` axes plus row gathers.

Semantics matched to the reference:

- parallel schedule (bp.hpp:192-325): check->bit two-pass min/tanh
  reduction, bit LLR accumulation, hard decision, syndrome-equality
  convergence, bit->check extrinsic update (skipped on convergence);
  per-batch-element freezing reproduces the reference's per-syndrome early
  return.
- min-sum alpha: fixed ``ms_scaling_factor``, or dynamic ``1 - 2^-iter``
  when the factor is 0 (bp.hpp:223-228).
- sign convention: messages with value <= 0 count as negative
  (bp.hpp:240,253).
- serial / serial-relative schedules (bp.hpp:451-545): sequential bit-wise
  immediate propagation via ``lax.fori_loop`` over the schedule order,
  vectorized across the batch.

The returned decode functions are pure and jit-compiled once per
(code, config); shapes are static.
"""

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ldpc_tpu.ops.pcm import PcmGraph

PRODUCT_SUM = 0
MINIMUM_SUM = 1

PARALLEL = 1
SERIAL = 0
SERIAL_RELATIVE = 2

_BIG = 1e30


class BpResult(NamedTuple):
    """Batched BP outputs, batch-major at the API boundary."""

    decoding: jnp.ndarray  # (B, n) uint8
    llr_posterior: jnp.ndarray  # (B, n)
    converged: jnp.ndarray  # (B,) bool
    iterations: jnp.ndarray  # (B,) int32


def channel_llr(error_channel: np.ndarray, dtype=np.float32) -> np.ndarray:
    """log((1-p)/p) per bit (bp.hpp:150-151); p=0 -> +inf ("certainly
    not flipped"), matching the reference's IEEE semantics."""
    p = np.asarray(error_channel, dtype=np.float64)
    with np.errstate(divide="ignore"):
        return (np.log((1.0 - p) / p)).astype(dtype)


def _check_to_bit_min_sum(v2c3, mask3, syndrome_i, alpha, dtype):
    """Min-sum check update over the dc axis of (m, dc, B) messages.

    Exclusive-min via (min1, argmin, min2); sign parity of the *other*
    entries XOR the syndrome bit (bp.hpp:231-272).
    """
    absv = jnp.where(mask3, jnp.abs(v2c3), _BIG)
    neg = jnp.where(mask3, v2c3 <= 0, False).astype(jnp.int32)
    min1 = absv.min(axis=1)
    amin = absv.argmin(axis=1)
    slot = jax.lax.broadcasted_iota(jnp.int32, absv.shape, 1)
    is_min = slot == amin[:, None, :]
    min2 = jnp.where(is_min, _BIG, absv).min(axis=1)
    total_par = (syndrome_i[:, None, :] + neg.sum(axis=1, keepdims=True) + neg) % 2
    excl_min = jnp.where(is_min, min2[:, None, :], min1[:, None, :])
    sign = (1 - 2 * total_par).astype(dtype)
    return jnp.where(mask3, alpha * sign * excl_min, jnp.array(0, dtype))


def _check_to_bit_product_sum(v2c3, mask3, syndrome_i, dtype):
    """Product-sum check update: exclusive prefix/suffix tanh products
    (bp.hpp:201-218), numerically stabilised with clipping in f32."""
    t = jnp.where(mask3, jnp.tanh(v2c3 * jnp.array(0.5, dtype)), jnp.array(1, dtype))
    ones = jnp.ones_like(t[:, :1, :])
    prefix = jnp.concatenate([ones, jnp.cumprod(t, axis=1)[:, :-1, :]], axis=1)
    rev = jnp.flip(t, axis=1)
    suffix = jnp.flip(
        jnp.concatenate([ones, jnp.cumprod(rev, axis=1)[:, :-1, :]], axis=1), axis=1
    )
    p = prefix * suffix
    # f32 (the performance path) clips to avoid inf; f64 (the exact-parity
    # mode) reproduces the reference's saturate-to-inf semantics
    if dtype == jnp.float32:
        eps = jnp.array(1e-7, dtype)
        p = jnp.clip(p, -1 + eps, 1 - eps)
    mag = jnp.log((1 + p) / (1 - p))
    sign = (1 - 2 * syndrome_i[:, None, :]).astype(dtype)
    return jnp.where(mask3, sign * mag, jnp.array(0, dtype))


def make_parallel_decoder(
    graph: PcmGraph,
    bp_method: int,
    max_iter: int,
    ms_scaling_factor: float,
    dtype=jnp.float32,
):
    """Build a jitted batched parallel-schedule BP decoder.

    Two bodies share the same semantics:

    - f32 (the performance path): gather-only message passing — the
      variable->check extrinsic is recomputed as ``llr_post[bit] - c2v``
      at the top of the check update, so each iteration is three row
      gathers and zero scatters (floating-point association differs from
      the reference's sequential folds; decisions agree up to fp ties).
    - f64 (the exact-parity mode used by the golden tests): reproduces
      the reference's sequential prefix/suffix folds bit-for-bit
      (bp.hpp:277-318).

    Returns ``decode(syndrome_bm: (B, m) uint8, init_llr: (n,)) -> BpResult``.
    """
    if dtype == jnp.float32:
        return _make_parallel_decoder_fast(
            graph, bp_method, max_iter, ms_scaling_factor, dtype
        )
    return _make_parallel_decoder_exact(
        graph, bp_method, max_iter, ms_scaling_factor, dtype
    )


def make_single_scan_decoder(
    graph: PcmGraph,
    max_iter: int,
    ms_scaling_factor: float,
    dtype=jnp.float32,
):
    """Min-sum "single-scan" BP (reference: src_cpp/bp.hpp:327-449).

    The reference's single-scan variant stores only the posterior LLRs and
    the previous iteration's check->bit messages, forming the
    variable->check extrinsic as ``llr_old[bit] - c2v_old[edge]``. That
    recurrence is algebraically identical to the parallel schedule's
    (``llr_post = prior + sum(c2v)``, so ``llr_post - c2v[e]`` *is* the
    extrinsic bit->check message) — exactly the gather-only form the fast
    engine already uses, so the kernel is shared. The semantic
    differences that remain are preserved: single-scan is min-sum only and
    always applies the fixed ``ms_scaling_factor`` (no dynamic
    ``1 - 2^-iter`` fallback at 0.0, bp.hpp:399).
    """
    return _make_parallel_decoder_fast(
        graph,
        MINIMUM_SUM,
        max_iter,
        ms_scaling_factor,
        dtype,
        dynamic_alpha=False,
    )


def _make_parallel_decoder_fast(
    graph: PcmGraph,
    bp_method: int,
    max_iter: int,
    ms_scaling_factor: float,
    dtype=jnp.float32,
    dynamic_alpha: bool = True,
):
    """Gather-only batched parallel BP (see make_parallel_decoder)."""
    m, n, dc, dv = graph.m, graph.n, graph.dc, graph.dv
    E = m * dc
    chk_bits = jnp.asarray(graph.chk_bits.reshape(-1))  # (E,) pad = n
    mask3 = jnp.asarray(graph.chk_mask)[:, :, None]  # (m, dc, 1)
    var_edges = jnp.asarray(graph.var_edges.reshape(-1))  # (n*dv,) pad = E

    def decode(syndrome_bm: jnp.ndarray, init_llr: jnp.ndarray) -> BpResult:
        B = syndrome_bm.shape[0]
        syndrome = syndrome_bm.T.astype(jnp.int32)  # (m, B)
        init_llr = init_llr.astype(dtype)
        # per-shot priors: (B, n) -> (n, B) column layout (analog-syndrome
        # windows initialise time-like bits from per-shot analog LLRs)
        llr_col = init_llr.T if init_llr.ndim == 2 else init_llr[:, None]

        def one_iter(it, llr_post, c2v):
            if (
                dynamic_alpha
                and ms_scaling_factor == 0.0
                and bp_method == MINIMUM_SUM
            ):
                alpha = (1.0 - jnp.exp2(-it.astype(dtype))).astype(dtype)
            else:
                alpha = jnp.array(ms_scaling_factor, dtype)
            llr_pad = jnp.concatenate([llr_post, jnp.zeros((1, B), dtype)])
            v2c3 = llr_pad[chk_bits].reshape(m, dc, B) - c2v  # extrinsic
            if bp_method == MINIMUM_SUM:
                c2v = _check_to_bit_min_sum(v2c3, mask3, syndrome, alpha, dtype)
            else:
                c2v = _check_to_bit_product_sum(v2c3, mask3, syndrome, dtype)
            c2v_pad = jnp.concatenate(
                [c2v.reshape(E, B), jnp.zeros((1, B), dtype)]
            )
            per_bit = c2v_pad[var_edges].reshape(n, dv, B)
            llr_new = llr_col + per_bit.sum(axis=1)
            hard = llr_new <= 0  # (n, B)
            hard_pad = jnp.concatenate([hard, jnp.zeros((1, B), bool)])
            cand = hard_pad[chk_bits].reshape(m, dc, B).sum(axis=1) % 2
            conv_now = jnp.all(cand == syndrome, axis=0)  # (B,)
            return llr_new, c2v, hard, conv_now

        def body(state):
            it, llr_post, c2v, conv, dec_out, llr_out, iters = state
            it = it + 1
            llr_new, c2v, hard, conv_now = one_iter(it, llr_post, c2v)
            active = ~conv
            dec_out = jnp.where(active[None, :], hard, dec_out)
            llr_out = jnp.where(active[None, :], llr_new, llr_out)
            iters = jnp.where(active, it, iters)
            conv = conv | conv_now
            return (it, llr_new, c2v, conv, dec_out, llr_out, iters)

        def cond(state):
            it, _, _, conv, _, _, _ = state
            return (it < max_iter) & ~jnp.all(conv)

        llr0 = jnp.broadcast_to(llr_col, (n, B))
        state0 = (
            jnp.int32(0),
            llr0,
            jnp.zeros((m, dc, B), dtype),
            jnp.zeros(B, bool),
            jnp.zeros((n, B), bool),
            llr0,
            jnp.zeros(B, jnp.int32),
        )
        _, _, _, conv, dec, llr_out, iters = jax.lax.while_loop(
            cond, body, state0
        )
        return BpResult(
            decoding=dec.T.astype(jnp.uint8),
            llr_posterior=llr_out.T,
            converged=conv,
            iterations=iters,
        )

    return jax.jit(decode)


def _make_parallel_decoder_exact(
    graph: PcmGraph,
    bp_method: int,
    max_iter: int,
    ms_scaling_factor: float,
    dtype=jnp.float64,
):
    """Fold-exact batched parallel BP (see make_parallel_decoder)."""
    m, n, dc = graph.m, graph.n, graph.dc
    E = m * dc
    chk_bits = jnp.asarray(graph.chk_bits.reshape(-1))  # (E,) pad = n
    mask3 = jnp.asarray(graph.chk_mask)[:, :, None]  # (m, dc, 1)
    var_edges = jnp.asarray(graph.var_edges.reshape(-1))  # (n*dv,) pad = E
    var_mask = jnp.asarray(graph.var_mask)  # (n, dv)
    dv = graph.dv

    def decode(syndrome_bm: jnp.ndarray, init_llr: jnp.ndarray) -> BpResult:
        B = syndrome_bm.shape[0]
        syndrome = syndrome_bm.T.astype(jnp.int32)  # (m, B)
        init_llr = init_llr.astype(dtype)
        llr_pad0 = jnp.concatenate([init_llr, jnp.zeros(1, dtype)])
        v2c0 = jnp.broadcast_to(llr_pad0[chk_bits][:, None], (E, B))

        def one_iter(it, v2c):
            if ms_scaling_factor == 0.0 and bp_method == MINIMUM_SUM:
                alpha = (1.0 - jnp.exp2(-it.astype(dtype))).astype(dtype)
            else:
                alpha = jnp.array(ms_scaling_factor, dtype)
            v2c3 = v2c.reshape(m, dc, B)
            if bp_method == MINIMUM_SUM:
                c2v3 = _check_to_bit_min_sum(v2c3, mask3, syndrome, alpha, dtype)
            else:
                c2v3 = _check_to_bit_product_sum(v2c3, mask3, syndrome, dtype)
            c2v = c2v3.reshape(E, B)
            # bit-side accumulation, replicating the reference's sequential
            # left-fold over each column so tie-breaking at llr == 0 matches
            # bit-for-bit (bp.hpp:277-298); dv is small and static, so the
            # fold unrolls into dv fused vector adds
            c2v_pad = jnp.concatenate([c2v, jnp.zeros((1, B), dtype)])
            per_bit = c2v_pad[var_edges].reshape(n, dv, B)
            acc = jnp.broadcast_to(init_llr[:, None], (n, B))
            partials = []
            for k in range(dv):
                partials.append(acc)
                acc = jnp.where(var_mask[:, k : k + 1], acc + per_bit[:, k], acc)
            llr_post = acc
            hard = llr_post <= 0  # (n, B) bool
            hard_pad = jnp.concatenate([hard, jnp.zeros((1, B), bool)])
            cand = hard_pad[chk_bits].reshape(m, dc, B).sum(axis=1) % 2
            conv_now = jnp.all(cand == syndrome, axis=0)  # (B,)
            # extrinsic bit->check update: partial-llr + reverse suffix fold
            # (bp.hpp:312-318) rather than llr - c2v, again for fp-exactness
            suf = jnp.zeros((n, B), dtype)
            slots = [None] * dv
            for k in reversed(range(dv)):
                slots[k] = partials[k] + suf
                suf = jnp.where(var_mask[:, k : k + 1], suf + per_bit[:, k], suf)
            v2c_bits = jnp.stack(slots, axis=1).reshape(n * dv, B)
            v2c_new = (
                jnp.zeros((E + 1, B), dtype).at[var_edges].set(v2c_bits)[:E]
            )
            return llr_post, hard, conv_now, v2c_new

        def body(state):
            it, v2c, conv, dec_out, llr_out, iters = state
            it = it + 1
            llr_post, hard, conv_now, v2c_new = one_iter(it, v2c)
            active = ~conv
            dec_out = jnp.where(active[None, :], hard, dec_out)
            llr_out = jnp.where(active[None, :], llr_post, llr_out)
            iters = jnp.where(active, it, iters)
            v2c = jnp.where((active & ~conv_now)[None, :], v2c_new, v2c)
            conv = conv | conv_now
            return (it, v2c, conv, dec_out, llr_out, iters)

        def cond(state):
            it, _, conv, _, _, _ = state
            return (it < max_iter) & ~jnp.all(conv)

        state0 = (
            jnp.int32(0),
            v2c0,
            jnp.zeros(B, bool),
            jnp.zeros((n, B), bool),
            jnp.broadcast_to(init_llr[:, None], (n, B)),
            jnp.zeros(B, jnp.int32),
        )
        _, _, conv, dec, llr_out, iters = jax.lax.while_loop(cond, body, state0)
        return BpResult(
            decoding=dec.T.astype(jnp.uint8),
            llr_posterior=llr_out.T,
            converged=conv,
            iterations=iters,
        )

    return jax.jit(decode)


def make_soft_info_decoder(
    graph: PcmGraph,
    max_iter: int,
    ms_scaling_factor: float,
    dtype=jnp.float32,
):
    """Batched soft-syndrome serial min-sum BP (bp.hpp:547-665, arXiv:2205.02341).

    Syndrome LLRs ``2*s/sigma^2`` are treated as soft values; when a check's
    soft magnitude falls below ``cutoff`` *and* below the min incoming
    message magnitude, the virtual-update rules either shrink the soft
    syndrome or flip the hard syndrome bit in place during the serial sweep.

    Returns ``decode(soft_syndromes: (B, m), init_llr: (n,), cutoff, sigma)
    -> (BpResult, soft_syndrome_out: (B, m))``.
    """
    m, n, dc, dv = graph.m, graph.n, graph.dc, graph.dv
    E = m * dc
    chk_bits = jnp.asarray(graph.chk_bits.reshape(-1))
    chk_mask_pad = jnp.concatenate(
        [jnp.asarray(graph.chk_mask), jnp.zeros((1, dc), bool)]
    )
    var_edges = jnp.asarray(graph.var_edges)  # (n, dv) pad = E
    var_chks = jnp.asarray(graph.var_chks)  # (n, dv) pad = m
    var_slot = jnp.asarray(graph.var_slot)
    var_mask = jnp.asarray(graph.var_mask)
    alpha = jnp.array(ms_scaling_factor, dtype)

    def decode_one(soft_in, init_llr, cutoff):
        # syndrome llrs: 2*s/sigma^2 applied by caller; hard bit = (soft <= 0)
        soft0 = soft_in.astype(dtype)  # (m,) already scaled
        synd0 = (soft0 <= 0).astype(jnp.int32)
        init_llr = init_llr.astype(dtype)
        llr_pad0 = jnp.concatenate([init_llr, jnp.zeros(1, dtype)])
        v2c0 = jnp.concatenate([llr_pad0[chk_bits], jnp.zeros(dc, dtype)])

        def bit_step(idx, carry):
            v2c, soft, synd, llr_arr, dec, active = carry
            j = idx
            vedge = var_edges[j]
            vchk = var_chks[j]  # (dv,) pad = m
            vslot = var_slot[j]
            vmask = var_mask[j]
            row_ids = vchk[:, None] * dc + jnp.arange(dc)[None, :]
            row_ids = jnp.where(vchk[:, None] < m, row_ids, E)
            rows = v2c[row_ids]  # (dv, dc) b2c messages of each nbr check's row
            rmask = chk_mask_pad[vchk]
            excl = jnp.arange(dc)[None, :] == vslot[:, None]
            others = rmask & ~excl
            absr = jnp.where(others, jnp.abs(rows), _BIG)
            temp = absr.min(axis=1)  # (dv,) min |msg| over others
            negs = jnp.where(others, rows <= 0, False).astype(jnp.int32).sum(axis=1)
            sgn = negs % 2
            cur_msg = v2c[vedge]  # this entry's own b2c message
            ss = soft[vchk]
            s = synd[vchk]
            ss_mag = jnp.abs(ss)
            virt = (ss_mag < cutoff) & (ss_mag < temp)  # virtual-update rule fires
            propagated = jnp.where(virt, ss_mag, temp)
            check_node_sgn = sgn ^ (cur_msg <= 0).astype(jnp.int32)
            agree = check_node_sgn == s
            shrink = jnp.minimum(jnp.abs(cur_msg), temp)
            ss_new = jnp.where(
                virt & agree,
                (1 - 2 * s).astype(dtype) * shrink,
                jnp.where(virt & ~agree, -ss, ss),
            )
            s_new = jnp.where(virt & ~agree, s ^ 1, s)
            sgn_final = sgn ^ s_new
            c2v_j = alpha * (1 - 2 * sgn_final).astype(dtype) * propagated
            c2v_j = jnp.where(vmask, c2v_j, 0)
            # sequential left-fold + reverse suffix, as in serial BP
            llr_j = init_llr[j]
            partials = []
            for k in range(dv):
                partials.append(llr_j)
                llr_j = jnp.where(vmask[k], llr_j + c2v_j[k], llr_j)
            dec_j = llr_j <= 0
            suf = jnp.zeros((), dtype)
            v2c_slots = [None] * dv
            for k in reversed(range(dv)):
                v2c_slots[k] = partials[k] + suf
                suf = jnp.where(vmask[k], suf + c2v_j[k], suf)
            v2c_j = jnp.stack(v2c_slots)
            upd = vmask & active
            v2c = v2c.at[vedge].set(jnp.where(upd, v2c_j, v2c[vedge]))
            soft = soft.at[vchk].set(jnp.where(upd, ss_new, soft[vchk]), mode="drop")
            synd = synd.at[vchk].set(jnp.where(upd, s_new, synd[vchk]), mode="drop")
            llr_arr = llr_arr.at[j].set(jnp.where(active, llr_j, llr_arr[j]))
            dec = dec.at[j].set(jnp.where(active, dec_j, dec[j]))
            return (v2c, soft, synd, llr_arr, dec, active)

        def body(state):
            it, v2c, soft, synd, llr_arr, dec, conv, iters, cutoff = state
            it = it + 1
            active = ~conv
            carry = (v2c, soft, synd, llr_arr, dec, active)
            # the cost is the per-bit dependent-op chain itself, not the
            # loop machinery; the algorithm is serial by reference
            # semantics (see the SoftInfoBpDecoder bench-row note)
            v2c, soft, synd, llr_arr, dec, _ = jax.lax.fori_loop(0, n, bit_step, carry)
            dec_pad = jnp.concatenate([dec, jnp.zeros(1, bool)])
            cand = dec_pad[chk_bits].reshape(m, dc).sum(axis=1) % 2
            conv_now = jnp.all(cand == synd)
            iters = jnp.where(active, it, iters)
            conv = conv | conv_now
            return (it, v2c, soft, synd, llr_arr, dec, conv, iters, cutoff)

        def cond(state):
            it = state[0]
            conv = state[6]
            return (it < max_iter) & ~conv

        state0 = (
            jnp.int32(0),
            v2c0,
            soft0,
            synd0,
            init_llr,
            jnp.zeros(n, bool),
            jnp.array(False),
            jnp.int32(0),
            jnp.asarray(cutoff, dtype),
        )
        out = jax.lax.while_loop(cond, body, state0)
        _, _, soft, _, llr_arr, dec, conv, iters, _ = out
        return (
            BpResult(
                decoding=dec.astype(jnp.uint8),
                llr_posterior=llr_arr,
                converged=conv,
                iterations=iters,
            ),
            soft,
        )

    batched = jax.vmap(decode_one, in_axes=(0, None, None))

    def decode(soft_syndromes, init_llr, cutoff, sigma):
        scaled = soft_syndromes.astype(dtype) * (2.0 / (sigma * sigma))
        return batched(scaled, init_llr, cutoff)

    return jax.jit(decode)


def make_serial_decoder(
    graph: PcmGraph,
    bp_method: int,
    max_iter: int,
    ms_scaling_factor: float,
    schedule_mode: int = SERIAL,
    random_serial_schedule: bool = False,
    dtype=jnp.float32,
):
    """Build a jitted batched serial-schedule BP decoder (bp.hpp:451-545).

    Bits update sequentially (immediate message propagation) in the order
    given by ``schedule`` — vectorized across the syndrome batch so each of
    the n sequential steps still does (dv*dc*B) lanes of work.

    Returns ``decode(syndrome_bm: (B, m) uint8, init_llr: (n,),
    schedule: (n,) int32, key: PRNGKey) -> BpResult``.
    ``schedule`` is ignored when ``random_serial_schedule`` (shuffled per
    iteration from ``key``) or ``schedule_mode == SERIAL_RELATIVE``
    (re-sorted by descending LLR each iteration, bp.hpp:469-482).
    """
    m, n, dc, dv = graph.m, graph.n, graph.dc, graph.dv
    E = m * dc
    chk_bits = jnp.asarray(graph.chk_bits.reshape(-1))
    chk_mask_pad = jnp.concatenate(
        [jnp.asarray(graph.chk_mask), jnp.zeros((1, dc), bool)]
    )  # (m+1, dc)
    var_edges = jnp.asarray(graph.var_edges)  # (n, dv) pad = E
    var_chks = jnp.asarray(graph.var_chks)  # (n, dv) pad = m
    var_slot = jnp.asarray(graph.var_slot)
    var_mask = jnp.asarray(graph.var_mask)

    def decode_one(syndrome_v, init_llr, schedule, key) -> BpResult:
        """Single-syndrome serial BP; vmapped over the batch below.

        Updates are masked by the per-element ``active`` flag so that a
        vmapped while_loop (which keeps stepping every lane until all lanes'
        conditions are false) leaves converged elements frozen — this
        reproduces the reference's per-syndrome early return."""
        syndrome = syndrome_v.astype(jnp.int32)  # (m,)
        syndrome_pad = jnp.concatenate([syndrome, jnp.zeros(1, jnp.int32)])
        init_llr = init_llr.astype(dtype)
        llr_pad0 = jnp.concatenate([init_llr, jnp.zeros(1, dtype)])
        # v2c padded with dc rows so gathers of pad-check rows stay in bounds
        v2c0 = jnp.concatenate([llr_pad0[chk_bits], jnp.zeros(dc, dtype)])

        def bit_step(idx, carry):
            (v2c, llr_arr, dec, sched, active, alpha) = carry
            j = sched[idx]
            vedge = var_edges[j]  # (dv,)
            vchk = var_chks[j]  # (dv,)
            vslot = var_slot[j]
            vmask = var_mask[j]  # (dv,)
            row_ids = vchk[:, None] * dc + jnp.arange(dc)[None, :]  # (dv, dc)
            row_ids = jnp.where(vchk[:, None] < m, row_ids, E)  # pad rows
            rows = v2c[row_ids]  # (dv, dc)
            rmask = chk_mask_pad[vchk]  # (dv, dc)
            excl = jnp.arange(dc)[None, :] == vslot[:, None]
            others = rmask & ~excl  # (dv, dc)
            if bp_method == MINIMUM_SUM:
                absr = jnp.where(others, jnp.abs(rows), _BIG)
                temp = absr.min(axis=1)  # (dv,)
                negs = jnp.where(others, rows <= 0, False).astype(jnp.int32).sum(axis=1)
                sgn = (syndrome_pad[vchk] + negs) % 2
                c2v_j = alpha * (1 - 2 * sgn).astype(dtype) * temp
            else:
                # sequential left-fold product in row order (bp.hpp:489-498)
                # so f64 results are bit-exact vs the reference
                p = jnp.ones((dv,), dtype)
                for k in range(dc):
                    p = jnp.where(
                        others[:, k], p * jnp.tanh(rows[:, k] * jnp.array(0.5, dtype)), p
                    )
                if dtype == jnp.float32:
                    eps = jnp.array(1e-7, dtype)
                    p = jnp.clip(p, -1 + eps, 1 - eps)
                sgn = syndrome_pad[vchk]
                c2v_j = (1 - 2 * sgn).astype(dtype) * jnp.log((1 + p) / (1 - p))
            c2v_j = jnp.where(vmask, c2v_j, 0)  # (dv,)
            # left-fold llr accumulation + reverse suffix fold for the
            # extrinsic messages, matching the reference's sequential
            # column sweeps exactly (bp.hpp:500-535)
            llr_j = init_llr[j]
            partials = []
            for k in range(dv):
                partials.append(llr_j)
                llr_j = jnp.where(vmask[k], llr_j + c2v_j[k], llr_j)
            dec_j = llr_j <= 0
            suf = jnp.zeros((), dtype)
            v2c_slots = [None] * dv
            for k in reversed(range(dv)):
                v2c_slots[k] = partials[k] + suf
                suf = jnp.where(vmask[k], suf + c2v_j[k], suf)
            v2c_j = jnp.stack(v2c_slots)
            upd = vmask & active
            v2c = v2c.at[vedge].set(jnp.where(upd, v2c_j, v2c[vedge]))
            llr_arr = llr_arr.at[j].set(jnp.where(active, llr_j, llr_arr[j]))
            dec = dec.at[j].set(jnp.where(active, dec_j, dec[j]))
            return (v2c, llr_arr, dec, sched, active, alpha)

        def body(state):
            it, v2c, llr_arr, dec, conv, iters = state
            it = it + 1
            if ms_scaling_factor == 0.0 and bp_method == MINIMUM_SUM:
                alpha = (1.0 - jnp.exp2(-it.astype(dtype))).astype(dtype)
            else:
                alpha = jnp.array(ms_scaling_factor, dtype)
            if random_serial_schedule:
                sched = jax.random.permutation(jax.random.fold_in(key, it), n).astype(
                    jnp.int32
                )
            elif schedule_mode == SERIAL_RELATIVE:
                # most reliable (largest LLR) first; iteration 1 uses the
                # channel llrs, which equal the initial llr_arr (bp.hpp:469-482)
                sched = jnp.argsort(-llr_arr, stable=True).astype(jnp.int32)
            else:
                sched = schedule
            active = ~conv
            carry = (v2c, llr_arr, dec, sched, active, alpha)
            v2c, llr_arr, dec, _, _, _ = jax.lax.fori_loop(0, n, bit_step, carry)
            dec_pad = jnp.concatenate([dec, jnp.zeros(1, bool)])
            cand = dec_pad[chk_bits].reshape(m, dc).sum(axis=1) % 2
            conv_now = jnp.all(cand == syndrome)
            iters = jnp.where(active, it, iters)
            conv = conv | conv_now
            return (it, v2c, llr_arr, dec, conv, iters)

        def cond(state):
            it, _, _, _, conv, _ = state
            return (it < max_iter) & ~conv

        state0 = (
            jnp.int32(0),
            v2c0,
            init_llr,
            jnp.zeros(n, bool),
            jnp.array(False),
            jnp.int32(0),
        )
        _, _, llr_arr, dec, conv, iters = jax.lax.while_loop(cond, body, state0)
        return BpResult(
            decoding=dec.astype(jnp.uint8),
            llr_posterior=llr_arr,
            converged=conv,
            iterations=iters,
        )

    batched = jax.vmap(decode_one, in_axes=(0, None, None, None))

    def decode(syndrome_bm, init_llr, schedule, key) -> BpResult:
        return batched(syndrome_bm, init_llr, schedule, key)

    return jax.jit(decode)
