"""Batched ordered-statistics decoding on device (JAX/XLA).

Batched re-design of the reference OSD post-processor
(reference: src_cpp/osd.hpp:110-185). The whole BP-failed subset decodes
at once:

1. per-element reliability ordering = stable argsort of the BP posterior
   LLRs (reference: sort.hpp:48);
2. one batched Gauss-Jordan pass over the column-permuted PCM augmented
   with the syndrome and a row-transform (``ops.gf2.batched_rref``) gives
   the OSD-0 solution for every element — the pivot column set matches the
   reference's ``fast_solve``/``lu_solve`` exactly;
3. higher orders evaluate the whole candidate block in one shot: the
   candidate-pattern matrix (C, k) hits the reduced non-pivot PCM columns
   in one 0/1 contraction to form all candidate solutions, and a weighted
   argmin (weights = log 1/p_i, reference: osd.hpp:163-180) selects the
   winner per element. The weight contractions run at HIGHEST precision:
   a float32 matmul may otherwise run in TF32, whose rounding can change
   the argmin.
"""

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ldpc_tpu.ops import gf2
from ldpc_tpu.ops.pcm import PcmGraph

OSD_OFF = -1
OSD_0 = 0
EXHAUSTIVE = 1
COMBINATION_SWEEP = 2


def candidate_strings(osd_method: int, osd_order: int, k: int) -> np.ndarray:
    """The (C, k) candidate block, row 0 = all-zero (the OSD-0 baseline).

    EXHAUSTIVE enumerates 1..2^order-1 LSB-first (reference: osd.hpp:75-80);
    COMBINATION_SWEEP takes every weight-1 pattern plus all weight-2
    patterns inside the first ``osd_order`` positions (osd.hpp:82-101).
    """
    order = min(osd_order, k)  # the reference indexes out of bounds past k
    cands = [np.zeros(k, dtype=np.uint8)]
    if osd_method == EXHAUSTIVE:
        for i in range(1, 2**order):
            cands.append(
                np.array([(i >> j) & 1 for j in range(k)], dtype=np.uint8)
            )
    elif osd_method == COMBINATION_SWEEP:
        for i in range(k):
            c = np.zeros(k, dtype=np.uint8)
            c[i] = 1
            cands.append(c)
        for i in range(order):
            for j in range(i + 1, order):
                c = np.zeros(k, dtype=np.uint8)
                c[i] = 1
                c[j] = 1
                cands.append(c)
    return np.stack(cands) if k else np.zeros((1, 0), np.uint8)


def make_osd_decoder(
    graph: PcmGraph,
    channel: np.ndarray,
    osd_method: int,
    osd_order: int,
    dtype=jnp.float32,
):
    """Build a jitted batched OSD decoder.

    Returns ``decode(syndromes: (B, m) uint8, llrs: (B, n)) ->
    (osd0: (B, n) uint8, osdw: (B, n) uint8, valid: (B,) bool)``.
    """
    m, n = graph.m, graph.n
    H_dev = jnp.asarray(graph.dense)  # (m, n) uint8
    rank = gf2.batched_rank(graph.dense)
    k = n - rank
    with np.errstate(divide="ignore"):
        weights = jnp.asarray(
            np.log(1.0 / np.asarray(channel, dtype=np.float64)), dtype
        )
    order0 = osd_method in (OSD_0, OSD_OFF) or osd_order == 0 or k == 0
    cands = (
        None
        if order0
        else jnp.asarray(candidate_strings(osd_method, osd_order, k))
    )

    def decode(syndromes: jnp.ndarray, llrs: jnp.ndarray):
        B = syndromes.shape[0]
        bidx = jnp.arange(B)[:, None]
        # least-reliable-first column ordering (sort.hpp:48); stable to
        # mirror qsort's deterministic handling of distinct keys
        order = jnp.argsort(llrs, axis=1, stable=True).astype(jnp.int32)
        H_perm = jnp.take(H_dev, order, axis=1).transpose(1, 0, 2)  # (B, m, n)
        res = gf2.batched_rref(
            H_perm,
            syndromes.astype(jnp.uint8),
            with_transform=False,
            with_reduced=not order0,
            # OSD-0 only consumes x0/valid, so the per-element fast-solve
            # exit (reference fast_solve semantics) is safe and skips the
            # long rank-completion tail of the elimination
            fast_exit=order0,
        )
        dec0 = (
            jnp.zeros((B, n), jnp.uint8).at[bidx, order].set(res.x0)
        )
        if order0:
            return dec0, dec0, res.valid

        # non-pivot permuted positions, ascending (stable argsort of the
        # pivot mask puts the k False entries first in position order)
        np_pos = jnp.argsort(res.is_pivot, axis=1, stable=True)[:, :k]
        np_orig = jnp.take_along_axis(order, np_pos, axis=1)  # (B, k)
        # candidate solutions read straight off the REDUCED matrix:
        # y_c = Ts ^ XOR of reduced non-pivot columns selected by c —
        # no m x m row transform is ever formed (select + contract as
        # one-hot matmuls; 0/1 sums < 2^24, exact in f32 and TF32)
        oh_np = (
            np_pos[:, :, None] == jnp.arange(n, dtype=np_pos.dtype)[None, None, :]
        ).astype(jnp.float32)  # (B, k, n)
        R_np = jnp.einsum(
            "bkn,bmn->bmk",
            oh_np,
            res.reduced.astype(jnp.float32),
            preferred_element_type=jnp.float32,
        )  # (B, m, k)
        yd = jnp.einsum(
            "ck,bmk->bcm",
            cands.astype(jnp.float32),
            R_np,
            preferred_element_type=jnp.float32,
        )
        yf = res.synd_red[:, None, :].astype(jnp.float32) + yd
        y = (yf - 2.0 * jnp.floor(yf * 0.5)).astype(jnp.uint8)  # (B, C, m)
        # pivot-coordinate solutions per candidate. xp[b,c,i] =
        # y[b,c,piv_row_of_col[b,i]] as a one-hot contraction. Non-pivot
        # columns have piv_row == m -> all-zero one-hot row -> xp 0.
        sel = (
            res.piv_row_of_col[:, :, None]
            == jnp.arange(m, dtype=jnp.int32)[None, None, :]
        ).astype(jnp.float32)  # (B, n, m)
        xpf = jnp.einsum(
            "bcj,bij->bci",
            y.astype(jnp.float32),
            sel,
            preferred_element_type=jnp.float32,
        )
        xp = xpf.astype(jnp.uint8)  # exact: one-hot selection of 0/1
        # weights: pivot part + candidate part (osd.hpp:163-180)
        wt_perm = weights[order]  # (B, n)
        hi = jax.lax.Precision.HIGHEST
        w_piv = jnp.einsum(
            "bcn,bn->bc", xp.astype(dtype), wt_perm, precision=hi
        )
        wt_np = weights[np_orig]  # (B, k)
        w_cand = jnp.einsum(
            "ck,bk->bc", cands.astype(dtype), wt_np, precision=hi
        )
        total_w = w_piv + w_cand  # (B, C)
        best = jnp.argmin(total_w, axis=1)  # first-minimum == strict < sweep
        xp_best = jnp.take_along_axis(
            xp, best[:, None, None], axis=1
        )[:, 0, :]
        cand_best = cands[best]  # (B, k)
        np_index = jnp.cumsum(~res.is_pivot, axis=1) - 1  # (B, n)
        cand_at_p = jnp.take_along_axis(
            cand_best, jnp.clip(np_index, 0, max(k - 1, 0)), axis=1
        )
        x_perm = jnp.where(res.is_pivot, xp_best, cand_at_p).astype(jnp.uint8)
        decw = jnp.zeros((B, n), jnp.uint8).at[bidx, order].set(x_perm)
        return dec0, decw, res.valid

    return jax.jit(decode)
