"""Batched MBP (memory belief propagation) over GF(4) on device.

Batched re-design of the reference quaternary decoder
(reference: src_cpp/mbp.hpp, arXiv:2104.13659 "MBP"). Pauli noise is
decoded directly on the stabilizer matrix: each entry carries a Pauli
type (1=X, 2=Y, 3=Z); a qubit's error anticommutes with a stabilizer
entry iff it is non-identity and differs from the entry's Pauli
(mbp.hpp:43-56). Messages are 3-vectors (one per Pauli) on each edge.

The reference sweeps qubits serially with immediate propagation
(mbp.hpp:142-280); the layout mirrors the serial BP engine: a
``lax.fori_loop`` over qubits, vmapped across the syndrome batch.

Per the reference update (product-sum mbp.hpp:147-190, min-sum
:196-235): each row entry g contributes
``lambda_g = log(1e-12 + (1 + exp(-m_g[pauli_g])) /
sum_{w != pauli_g} exp(-m_g[w]))``; the stab->qubit message combines the
other entries' lambdas (tanh-product or gamma-scaled min with sign
parity); the per-Pauli posterior adds ``1/alpha``-scaled messages from
disagreeing entries and ``beta``-scaled ones from agreeing entries
(the "memory"/inhibition term, mbp.hpp:240-252); hard decision is the
argmin-LLR Pauli, identity when all LLRs are positive (mbp.hpp:255-269).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse

from ldpc_tpu.ops.pcm import PcmGraph, compile_pcm

PRODUCT_SUM = 0
MINIMUM_SUM = 1

_BIG = 1e30


class Gf4Graph(NamedTuple):
    """Binary ELL layout + per-entry Pauli values (1=X, 2=Y, 3=Z)."""

    graph: PcmGraph
    chk_val: np.ndarray  # (m, dc) uint8, pad 0
    var_val: np.ndarray  # (n, dv) uint8, pad 0


def compile_gf4(Hgf4) -> Gf4Graph:
    """Build the GF(4) device layout from a scipy/numpy matrix with
    entries in {0, 1, 2, 3}."""
    if scipy.sparse.issparse(Hgf4):
        dense = np.asarray(Hgf4.todense(), dtype=np.uint8)
    else:
        dense = np.asarray(Hgf4, dtype=np.uint8)
    graph = compile_pcm(scipy.sparse.csr_matrix((dense != 0).astype(np.uint8)))
    m, n, dc, dv = graph.m, graph.n, graph.dc, graph.dv
    chk_val = np.zeros((m, dc), np.uint8)
    for i in range(m):
        for s in range(dc):
            if graph.chk_mask[i, s]:
                chk_val[i, s] = dense[i, graph.chk_bits[i, s]]
    var_val = np.zeros((n, dv), np.uint8)
    for j in range(n):
        for k in range(dv):
            if graph.var_mask[j, k]:
                var_val[j, k] = dense[graph.var_chks[j, k], j]
    return Gf4Graph(graph=graph, chk_val=chk_val, var_val=var_val)


def pauli_syndrome(dense_gf4: np.ndarray, error_gf4: np.ndarray) -> np.ndarray:
    """Symplectic (anticommutation) syndrome of a GF(4) error batch
    (mbp.hpp:43-56). ``error_gf4``: (..., n) with entries 0..3."""
    e = error_gf4[..., None, :]  # (..., 1, n)
    H = dense_gf4[None, :, :] if error_gf4.ndim > 1 else dense_gf4
    anti = (H != 0) & (e != 0) & (e != H)
    return anti.sum(axis=-1) % 2


def make_mbp_decoder(
    g4: Gf4Graph,
    channel: np.ndarray,  # (3, n)
    max_iter: int,
    alpha: np.ndarray,  # (3, n)
    beta: float,
    bp_method: int,
    gamma: float,
    dtype=jnp.float64,
):
    """Build a jitted batched MBP decoder.

    Returns ``decode(syndromes: (B, m) uint8) ->
    (decoding_gf4: (B, n) uint8, llrs: (B, 3, n), converged: (B,),
    iterations: (B,))``.
    """
    graph = g4.graph
    m, n, dc, dv = graph.m, graph.n, graph.dc, graph.dv
    E = m * dc
    chk_bits = jnp.asarray(graph.chk_bits.reshape(-1))  # (E,)
    chk_mask = jnp.asarray(graph.chk_mask)  # (m, dc)
    chk_mask_pad = jnp.concatenate([chk_mask, jnp.zeros((1, dc), bool)])
    chk_val = jnp.asarray(g4.chk_val)  # (m, dc)
    chk_val_pad = jnp.concatenate([chk_val, jnp.zeros((1, dc), jnp.uint8)])
    var_edges = jnp.asarray(graph.var_edges)  # (n, dv)
    var_chks = jnp.asarray(graph.var_chks)  # (n, dv)
    var_slot = jnp.asarray(graph.var_slot)  # (n, dv)
    var_mask = jnp.asarray(graph.var_mask)  # (n, dv)
    var_val = jnp.asarray(g4.var_val)  # (n, dv)

    chan_llr = jnp.asarray(
        np.log((1.0 - np.asarray(channel, np.float64)) / np.asarray(channel)),
        dtype,
    )  # (3, n)
    inv_alpha = jnp.asarray(1.0 / np.asarray(alpha, np.float64), dtype)  # (3, n)
    beta_c = jnp.array(beta, dtype)
    gamma_c = jnp.array(gamma, dtype)
    eps = jnp.array(1e-12, dtype)

    # initial qubit->stab messages, edge-major (E, 3):
    # channel llr of the edge's bit per Pauli, zero on the agreeing Pauli
    w_axis = np.arange(1, 4, dtype=np.uint8)

    def lam(q2s_rows, val_rows, mask_rows):
        """Per-entry combination lambda (mbp.hpp:160-170).

        q2s_rows: (..., 3); val_rows: (...,) uint8 in 1..3."""
        exps = jnp.exp(-q2s_rows)  # (..., 3)
        agree = val_rows[..., None] == jnp.asarray(w_axis)[None, :]
        num = 1.0 + jnp.where(agree, exps, 0).sum(axis=-1)
        den = jnp.where(agree, 0, exps).sum(axis=-1)
        out = jnp.log(eps + num / den)
        return jnp.where(mask_rows, out, jnp.array(0, dtype))

    def decode_one(syndrome):
        synd = syndrome.astype(jnp.int32)  # (m,)
        synd_pad = jnp.concatenate([synd, jnp.zeros(1, jnp.int32)])
        bit_of_edge = chk_bits  # (E,) pad n
        chan_pad = jnp.concatenate(
            [chan_llr, jnp.zeros((3, 1), dtype)], axis=1
        )  # (3, n+1)
        edge_val = chk_val_pad.reshape(-1)[: E]  # flat (E,)
        q2s0 = jnp.where(
            (edge_val[:, None] == jnp.asarray(w_axis)[None, :]),
            0.0,
            chan_pad[:, bit_of_edge].T,
        ).astype(dtype)  # (E, 3)
        q2s0 = jnp.concatenate([q2s0, jnp.zeros((dc, 3), dtype)])  # pad rows

        def qubit_step(j, carry):
            q2s, llr_arr, dec, active = carry
            vchk = var_chks[j]  # (dv,)
            vslot = var_slot[j]
            vmask = var_mask[j]
            vedge = var_edges[j]  # (dv,) flat edge ids, pad E
            # all entries of each neighbouring stab's row
            row_ids = vchk[:, None] * dc + jnp.arange(dc)[None, :]  # (dv, dc)
            row_ids = jnp.where(vchk[:, None] < m, row_ids, E)
            rows_q2s = q2s[row_ids]  # (dv, dc, 3)
            rows_val = chk_val_pad[vchk]  # (dv, dc)
            rows_mask = chk_mask_pad[vchk]  # (dv, dc)
            lam_rows = lam(rows_q2s, rows_val, rows_mask)  # (dv, dc)
            excl = jnp.arange(dc)[None, :] == vslot[:, None]
            others = rows_mask & ~excl
            s = synd_pad[vchk]  # (dv,)
            if bp_method == PRODUCT_SUM:
                t = jnp.where(others, jnp.tanh(lam_rows * 0.5), 1.0)
                p = t.prod(axis=1)
                lim = jnp.array(1e-8, dtype)
                p = jnp.clip(p, -1 + lim, 1 - lim)
                msg = (1 - 2 * s).astype(dtype) * jnp.log((1 + p) / (1 - p))
            else:
                absl = jnp.where(others, jnp.abs(lam_rows), _BIG)
                mn = absl.min(axis=1)
                negs = (
                    jnp.where(others, lam_rows <= 0, False)
                    .astype(jnp.int32)
                    .sum(axis=1)
                )
                sgn = (s + negs) % 2
                msg = (1 - 2 * sgn).astype(dtype) * gamma_c * mn
            msg = jnp.where(vmask, msg, 0)  # (dv,)
            # per-Pauli posterior (mbp.hpp:240-252)
            agree = var_val[j][:, None] == jnp.asarray(w_axis)[None, :]  # (dv,3)
            coef = jnp.where(agree, beta_c, inv_alpha[:, j][None, :])
            llr_j = chan_llr[:, j] + (msg[:, None] * coef * vmask[:, None]).sum(
                axis=0
            )  # (3,)
            # hard decision: argmin Pauli, identity if all positive
            dec_j = jnp.where(
                (llr_j > 0).all(), 0, jnp.argmin(llr_j).astype(jnp.int32) + 1
            )
            # inhibition: new qubit->stab messages (mbp.hpp:272-277)
            sub = jnp.where(agree, 0.0, msg[:, None])
            q2s_j = llr_j[None, :] - sub  # (dv, 3)
            upd = (vmask & active)[:, None]
            q2s = q2s.at[vedge].set(jnp.where(upd, q2s_j, q2s[vedge]))
            llr_arr = llr_arr.at[:, j].set(
                jnp.where(active, llr_j, llr_arr[:, j])
            )
            dec = dec.at[j].set(jnp.where(active, dec_j, dec[j]))
            return (q2s, llr_arr, dec, active)

        def body(state):
            it, q2s, llr_arr, dec, conv, iters = state
            it = it + 1
            active = ~conv
            carry = (q2s, llr_arr, dec, active)
            q2s, llr_arr, dec, _ = jax.lax.fori_loop(0, n, qubit_step, carry)
            # candidate Pauli syndrome (mbp.hpp:43-56)
            dec_pad = jnp.concatenate([dec, jnp.zeros(1, jnp.int32)])
            dbits = dec_pad[chk_bits].reshape(m, dc)
            anti = (
                chk_mask & (dbits != 0) & (dbits != chk_val.astype(jnp.int32))
            )
            cand = anti.sum(axis=1) % 2
            conv_now = jnp.all(cand == synd)
            iters = jnp.where(active, it, iters)
            conv = conv | conv_now
            return (it, q2s, llr_arr, dec, conv, iters)

        def cond(state):
            it, _, _, _, conv, _ = state
            return (it < max_iter) & ~conv

        state0 = (
            jnp.int32(0),
            q2s0,
            jnp.zeros((3, n), dtype),
            jnp.zeros(n, jnp.int32),
            jnp.array(False),
            jnp.int32(0),
        )
        _, _, llr_arr, dec, conv, iters = jax.lax.while_loop(
            cond, body, state0
        )
        return dec.astype(jnp.uint8), llr_arr, conv, iters

    return jax.jit(jax.vmap(decode_one))
