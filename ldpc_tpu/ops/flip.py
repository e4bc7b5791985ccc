"""Batched flip / p-flip decoder (reference: src_cpp/flip.hpp).

Greedy bit-flipping: sweep the bits in order; flip any bit whose
unsatisfied checks outnumber its satisfied checks, updating the syndrome
immediately (flip.hpp:95-108). Every ``pfreq``-th iteration, ties break
randomly with p=0.5 — the "p-flip" rule of arXiv:2212.06985
(flip.hpp:109-123). Convergence = syndrome weight 0, checked after every
flip (flip.hpp:129-134).

The immediate-propagation sweep is sequential per syndrome by
construction, so the layout mirrors the serial BP engine: a
``lax.fori_loop`` over bits, vmapped across the syndrome batch so each of
the n sequential steps still does a whole batch of work.
"""

import jax
import jax.numpy as jnp

from ldpc_tpu.ops.pcm import PcmGraph


def make_flip_decoder(graph: PcmGraph, max_iter: int, pfreq: int):
    """Build a jitted batched flip decoder.

    ``pfreq == 0`` disables the probabilistic tie-break (reference maps 0
    to INT_MAX, flip.hpp:40-42). Returns
    ``decode(syndromes: (B, m) uint8, key) ->
    (decoding: (B, n) uint8, converged: (B,) bool, iterations: (B,) int32)``.
    """
    m, n, dv = graph.m, graph.n, graph.dv
    var_chks = jnp.asarray(graph.var_chks)  # (n, dv) pad = m
    var_mask = jnp.asarray(graph.var_mask)  # (n, dv)

    def decode_one(syndrome, key):
        synd0 = syndrome.astype(jnp.int32)  # (m,)

        def bit_step(j, carry):
            synd, dec, weight, conv, iters, it, bkey = carry
            vchk = var_chks[j]
            vmask = var_mask[j]
            synd_pad = jnp.concatenate([synd, jnp.zeros(1, jnp.int32)])
            s = jnp.where(vmask, synd_pad[vchk], 0)  # (dv,)
            unsat = s.sum()
            sat = vmask.sum() - unsat
            flip = unsat > sat
            if pfreq > 0:
                bkey, sub = jax.random.split(bkey)
                coin = jax.random.uniform(sub) < 0.5
                flip = flip | ((it % pfreq == 0) & (sat == unsat) & coin)
            do = flip & ~conv
            # flipping toggles every adjacent check: weight delta = sat - unsat
            dec = dec.at[j].set(dec[j] ^ do)
            synd = synd.at[vchk].add(
                jnp.where(vmask & do, 1 - 2 * s, 0), mode="drop"
            )
            weight = jnp.where(do, weight + sat - unsat, weight)
            hit = (weight == 0) & ~conv
            iters = jnp.where(hit, it, iters)
            conv = conv | hit
            return (synd, dec, weight, conv, iters, it, bkey)

        def body(state):
            it, synd, dec, weight, conv, iters, key = state
            it = it + 1
            key, ikey = jax.random.split(key)
            carry = (synd, dec, weight, conv, iters, it, ikey)
            synd, dec, weight, conv, iters, _, _ = jax.lax.fori_loop(
                0, n, bit_step, carry
            )
            return (it, synd, dec, weight, conv, iters, key)

        def cond(state):
            it, _, _, _, conv, _, _ = state
            return (it < max_iter) & ~conv

        weight0 = synd0.sum()
        conv0 = weight0 == 0
        state0 = (
            jnp.int32(0),
            synd0,
            jnp.zeros(n, jnp.int32),
            weight0,
            conv0,
            jnp.int32(0),
            key,
        )
        _, _, dec, _, conv, iters, _ = jax.lax.while_loop(cond, body, state0)
        iters = jnp.where(conv, iters, max_iter)
        return dec.astype(jnp.uint8), conv, iters

    def decode(syndromes, key):
        keys = jax.random.split(key, syndromes.shape[0])
        return jax.vmap(decode_one)(syndromes, keys)

    return jax.jit(decode)
