"""Batched localized-statistics decoding (LSD) on device (JAX/XLA).

Batched re-design of the reference LSD decoder
(reference: src_cpp/lsd.hpp, arXiv:2406.18655). The reference grows one
cluster per flipped syndrome bit with an incremental PLU per cluster and,
for ``lsd_order > 0``, runs a dense OSD search inside each cluster
(lsd.hpp:683-838, osd_dense.hpp:101-153). Here the whole failed batch
decodes at once:

- cluster growth + validity reuse the union-find machinery
  (``ops.uf.grow_until_valid``): min-label propagation for clusters, one
  batched Gauss-Jordan of the column-masked global PCM per round — valid
  per cluster by block-diagonality. LSD's on-the-fly incremental PLU
  (gf2dense.hpp:325-407) is replaced by re-eliminating the masked system,
  which is cheap when batched.
- ``lsd_order == 0``: the masked solve IS the per-cluster lu_solve
  (lsd.hpp:743-760).
- ``lsd_order == w > 0``: clusters first grow until their nullity
  (non-pivot count) reaches w (lsd.hpp:786-810); then every cluster's
  OSD-w candidate sweep runs as ONE global pass: flipping a cluster's
  non-pivot column only perturbs that cluster's block of the solution, so
  the *global* Hamming weight ranks candidates correctly within each
  cluster, and a per-label segment-min picks every cluster's winner
  simultaneously (osd_dense.hpp:106-140 scores per-cluster Hamming
  weight; tie-breaks prefer earlier candidates, as there).
"""

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ldpc_tpu.ops import gf2
from ldpc_tpu.ops.pcm import PcmGraph
from ldpc_tpu.ops.uf import (
    _INF,
    _propagate_labels,
    grow_until_valid,
    masked_solve,
)

LSD_0 = 0
LSD_E = 1
LSD_CS = 2


def _take1(x, idx):
    """``take_along_axis(x, idx, axis=1)`` as a flat row-major take."""
    B, L = x.shape
    base = (jnp.arange(B, dtype=jnp.int32) * L)[:, None]
    return jnp.take(
        x.reshape(-1), (base + idx).reshape(-1), axis=0
    ).reshape(idx.shape)


def _pattern_table(lsd_method: int, order: int) -> np.ndarray:
    """Per-cluster candidate patterns over the first ``order`` sorted
    non-pivot slots, in the reference's enumeration order
    (osd.hpp:75-101). Singles over *all* non-pivots (the CS rule) are
    handled separately; this table covers the slot-limited part:
    LSD_E -> all 2^order-1 nonzero patterns; LSD_CS -> weight-2 pairs.
    """
    pats = []
    if lsd_method == LSD_E:
        for i in range(1, 2**order):
            pats.append([(i >> j) & 1 for j in range(order)])
    elif lsd_method == LSD_CS:
        for a in range(order):
            for b in range(a + 1, order):
                row = [0] * order
                row[a] = 1
                row[b] = 1
                pats.append(row)
    if not pats:
        return np.zeros((0, max(order, 1)), np.uint8)
    return np.asarray(pats, np.uint8)


def make_lsd_decoder(
    graph: PcmGraph,
    lsd_method: int = LSD_0,
    lsd_order: int = 0,
    bits_per_step: int = 1,
    dtype=jnp.float32,
):
    """Build a jitted batched LSD decoder.

    Returns ``decode(syndromes: (B, m) uint8, llrs: (B, n)) ->
    (decoding: (B, n) uint8, valid: (B,) bool)``.
    """
    m, n = graph.m, graph.n
    if bits_per_step >= n:
        bits_per_step = 0  # grow-all fast path (see uf.make_uf_decoder)
    order0 = lsd_order == 0 or lsd_method == LSD_0
    W = lsd_order
    pats_np = None if order0 else _pattern_table(lsd_method, W)
    use_singles = (not order0) and lsd_method == LSD_CS
    lab_iota = None if order0 else jnp.arange(m + 1, dtype=jnp.int32)

    def bit_labels(labels_f, in_bit, adj):
        """Cluster label of each in-cluster column (min over its active
        adjacent checks) — one-hot matmul form; labels are f32 with
        ``_INF_F`` fill (see uf._propagate_labels_mm)."""
        from ldpc_tpu.ops.uf import _INF_F

        Gv, _, maskv, _, _ = adj
        out = None
        for k in range(Gv.shape[0]):
            g = jnp.dot(
                labels_f, Gv[k],
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            g = jnp.where(maskv[k][None, :] > 0, g, _INF_F)
            out = g if out is None else jnp.minimum(out, g)
        return jnp.where(in_bit, out, _INF_F)  # (B, n) f32

    def nonpivot_rank(collab_i, nonpiv_in, llrs):
        """Rank each non-pivot in-cluster column inside its cluster by
        ascending LLR (the reference's sort_non_pivot_cols,
        lsd.hpp:823). Returns (rank: (B, n) int32 or n, colof:
        (B, m+1, W) int32 column table, pad = n). Scatter-free: the
        rank un-permutation is an argsort-inverse gather and the colof
        table is built by per-slot one-hot reductions."""
        B = collab_i.shape[0]
        lab = jnp.where(nonpiv_in, collab_i, _INF)
        # one two-key sort-with-payload replaces the argsort+gather
        # cascade; stable ties on equal (lab, llr) resolve to the original column
        # order, matching argsort(llrs, stable) composition
        col_iota = jnp.broadcast_to(
            jnp.arange(n, dtype=jnp.int32)[None, :], lab.shape
        )
        lab_sorted, _, perm = jax.lax.sort(
            (lab, llrs.astype(dtype), col_iota),
            dimension=1,
            num_keys=2,
            is_stable=True,
        )
        pos = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :], (B, n))
        is_start = jnp.concatenate(
            [jnp.ones((B, 1), bool), lab_sorted[:, 1:] != lab_sorted[:, :-1]],
            axis=1,
        )
        seg_start = jax.lax.associative_scan(
            jnp.maximum, jnp.where(is_start, pos, 0), axis=1
        )
        rank_sorted = pos - seg_start
        # un-permute by sorting on the (permutation) column ids — an
        # inverse-permutation gather in sort clothing
        _, rank = jax.lax.sort(
            (perm, jnp.where(lab_sorted < _INF, rank_sorted, n)),
            dimension=1,
            num_keys=1,
            is_stable=True,
        )
        if W == 0:
            return rank, None
        put = (rank_sorted < W) & (lab_sorted < _INF)
        labc = jnp.where(put, jnp.minimum(lab_sorted, m), m + 1)
        oh = (
            labc[:, :, None] == lab_iota[None, None, :]
        )  # (B, n, m+1); the m+1 sentinel never matches
        colof_ws = []
        for w in range(W):
            sel = oh & (rank_sorted == w)[:, :, None]
            v = (
                sel * (perm + 1)[:, :, None]
            ).sum(axis=1)  # (B, m+1); <=1 match per (lane, label)
            colof_ws.append(jnp.where(v > 0, v - 1, n))
        colof = jnp.stack(colof_ws, axis=2)  # (B, m+1, W)
        return rank, colof

    def decode(syndromes: jnp.ndarray, llrs: jnp.ndarray):
        B = syndromes.shape[0]
        syndromes = syndromes.astype(jnp.uint8)
        bidx = jnp.arange(B)[:, None]
        seed_checks = syndromes == 1

        def msolve(in_bit, with_reduced=False):
            """Masked solve with everything in ORIGINAL column coords:
            (ispiv (B,n), synd_red (B,m), used (B,m), valid (B,),
            Rt (B,n+1,m) or None, prc (B,n) pivot row per column)."""
            res, order_ = masked_solve(
                graph, in_bit, syndromes, llrs, dtype,
                with_reduced=with_reduced,
            )
            ispiv = (
                jnp.zeros((B, n), bool).at[bidx, order_].set(res.is_pivot)
            )
            prc = (
                jnp.full((B, n), m, jnp.int32)
                .at[bidx, order_]
                .set(res.piv_row_of_col)
            )
            Rt = (
                jnp.zeros((B, n + 1, m), jnp.uint8)
                .at[bidx, order_]
                .set(res.reduced.transpose(0, 2, 1))
                if with_reduced
                else None
            )
            return ispiv, res.synd_red, res.row_used, res.valid, Rt, prc

        in_bit, res, order = grow_until_valid(
            graph, syndromes, llrs, bits_per_step, dtype
        )
        if order0:
            decoding = (
                jnp.zeros((B, n), jnp.uint8).at[bidx, order].set(res.x0)
            )
            return decoding, res.valid
        ispiv_orig = (
            jnp.zeros((B, n), bool).at[bidx, order].set(res.is_pivot)
        )

        # ---- grow every cluster until its nullity reaches lsd_order
        # (lsd.hpp:792-810; bounded to lsd_order extra single-bit rounds)
        # labels are threaded through the rounds as warm starts: label
        # fixpoints only decrease as clusters grow/merge, so each round's
        # propagation converges in ~1 sweep instead of ~graph-diameter.
        # All graph sweeps ride the one-hot matmul forms and all
        # per-label reductions are dense one-hot sums
        from ldpc_tpu.ops.uf import (
            _INF_F,
            _adj_constants,
            _grow_round_mm,
            _propagate_labels_mm,
        )

        adj = _adj_constants(graph)
        labels0, _ = _propagate_labels_mm(graph, adj, in_bit, seed_checks)
        _sub = jnp.argsort(llrs.astype(dtype), axis=1, stable=True)
        llr_rank = jnp.argsort(_sub, axis=1, stable=True).astype(
            jnp.float32
        )
        lab_iota_f = lab_iota.astype(jnp.float32)

        def dim_round(t, state):
            in_bit, ispiv, warm = state
            labels_f, _ = _propagate_labels_mm(
                graph, adj, in_bit, seed_checks, warm=warm
            )
            collab_f = bit_labels(labels_f, in_bit, adj)
            nonpiv_in = in_bit & ~ispiv
            # nullity per label: dense one-hot sum over columns
            lcf = jnp.where(
                nonpiv_in, jnp.minimum(collab_f, float(m)), float(m + 1)
            )
            oh = lcf[:, :, None] == lab_iota_f[None, None, :]
            nullity = oh.sum(axis=1).astype(jnp.int32)  # (B, m+1)
            # needs per check: pick each check's label's nullity
            chk_lf = jnp.where(
                labels_f < _INF_F, jnp.minimum(labels_f, float(m)),
                float(m + 1),
            )
            ohc = chk_lf[:, :, None] == lab_iota_f[None, None, :]
            nul_of_chk = (
                (ohc * nullity[:, None, :].astype(jnp.float32))
                .sum(axis=2)
                .astype(jnp.int32)
            )
            needs = (nul_of_chk < W) & (labels_f < _INF_F)
            new_in, _ = _grow_round_mm(
                graph, adj, in_bit, needs, llr_rank, 1
            )
            ispiv2, *_ = msolve(new_in)
            return new_in, ispiv2, labels_f

        in_bit, _, warm_labels = jax.lax.fori_loop(
            0, W, dim_round, (in_bit, ispiv_orig, labels0)
        )
        # final solve carries the REDUCED matrix for the candidate sweep
        # (candidate solutions read off as y = Ts ^ XOR of reduced
        # columns — no m x m row transform is ever formed)
        ispiv_orig, synd_red, row_used, valid_out, Rt_orig, prc_orig = (
            msolve(in_bit, with_reduced=True)
        )

        labels_f, _ = _propagate_labels_mm(
            graph, adj, in_bit, seed_checks, warm=warm_labels
        )
        collab_f = bit_labels(labels_f, in_bit, adj)
        nonpiv_in = in_bit & ~ispiv_orig
        collab_i = jnp.where(
            collab_f < _INF_F, collab_f, jnp.float32(_INF)
        ).astype(jnp.int32)
        rank, colof = nonpivot_rank(collab_i, nonpiv_in, llrs)

        # ---- candidate evaluation (block-structured, scatter-free) ----
        # Candidate order within a cluster (osd_dense.hpp:106-140):
        # baseline (enum 0) < singles by per-cluster rank (enum 1+rank,
        # rank < n) < slot patterns (enum 1+n+p). All keys inside a
        # cluster are distinct, so per-block minima + a cross-block min
        # reproduce the flat segment-argmin exactly. Scores ride bit-
        # PACKED rows (popcount) and per-label reductions are dense
        # one-hot sums in place of (B,*)->(B, m+1) scatters.
        Wm = -(-m // 8)
        Rt_packed = gf2.pack_bits_u8(
            Rt_orig.reshape(B * (n + 1), m)
        ).reshape(B, n + 1, Wm)  # pad bits beyond m are zero
        synd_packed = gf2.pack_bits_u8(synd_red)  # (B, Wm)
        used_packed = gf2.pack_bits_u8(row_used.astype(jnp.uint8))
        base_score = (
            jax.lax.population_count(synd_packed & used_packed)
            .astype(jnp.int32)
            .sum(axis=1)
        )  # (B,) baseline pivot-solution weight
        STRIDE = jnp.int32(2 * n + 2)
        BIG = jnp.int32(2**30)
        Rt_flat = Rt_packed.reshape(B * (n + 1), Wm)
        row_base = jnp.arange(B, dtype=jnp.int32) * (n + 1)

        # pattern block: gather each label's <=W ranked non-pivot
        # columns once (tiny: (B, m+1, W, Wm)), then score the P
        # patterns as XOR/popcount folds over those slots
        P = pats_np.shape[0]
        key_pat = jnp.full((B, m + 1), BIG)
        win_p = jnp.zeros((B, m + 1), jnp.int32)
        Rcol = slot_ok = None
        if P:
            Rcol = jnp.take(
                Rt_flat,
                (row_base[:, None, None] + colof).reshape(-1),
                axis=0,
            ).reshape(B, m + 1, W, Wm)
            slot_ok = colof < n  # (B, m+1, W)
            for p in range(P):
                patrow = pats_np[p]
                y = jnp.broadcast_to(
                    synd_packed[:, None, :], (B, m + 1, Wm)
                )
                okp = jnp.ones((B, m + 1), bool)
                for w in range(W):
                    if patrow[w]:
                        y = y ^ Rcol[:, :, w, :]
                        okp = okp & slot_ok[:, :, w]
                sc = (
                    jax.lax.population_count(y & used_packed[:, None, :])
                    .astype(jnp.int32)
                    .sum(axis=2)
                    + int(patrow.sum())
                )
                key = sc * STRIDE + jnp.int32(1 + n + p)
                key = jnp.where(okp, key, BIG)
                better = key < key_pat
                win_p = jnp.where(better, p, win_p)
                key_pat = jnp.minimum(key_pat, key)

        best = key_pat
        key_sing = arg_sing = None
        if use_singles:
            # singles: y_j = Ts ^ R[:, j]; per-label min via a dense
            # one-hot masked min (keys are unique within a cluster)
            ysing = synd_packed[:, None, :] ^ Rt_packed[:, :n, :]
            sc_s = (
                jax.lax.population_count(ysing & used_packed[:, None, :])
                .astype(jnp.int32)
                .sum(axis=2)
                + 1
            )  # (B, n)
            key_s = jnp.where(
                nonpiv_in,
                sc_s * STRIDE + 1 + jnp.minimum(rank, n),
                BIG,
            )
            labc = jnp.where(
                nonpiv_in, jnp.minimum(collab_i, m), m + 1
            )  # m+1 sentinel matches no label slot
            Msel = jnp.where(
                labc[:, :, None] == lab_iota[None, None, :],
                key_s[:, :, None],
                BIG,
            )  # (B, n, m+1)
            key_sing = Msel.min(axis=1)  # (B, m+1)
            arg_sing = jnp.where(
                (Msel == key_sing[:, None, :]) & (Msel < BIG),
                jnp.arange(n, dtype=jnp.int32)[None, :, None],
                n,
            ).min(axis=1)  # (B, m+1)
            best = jnp.minimum(best, key_sing)

        improved = best < base_score[:, None] * STRIDE  # (B, m+1)
        pat_won = improved & (best == key_pat)
        if use_singles:
            sing_won = improved & ~pat_won
        else:
            sing_won = jnp.zeros_like(improved)

        # ---- compose the global solution ------------------------------
        # y* = Ts ^ XOR of every improved cluster's winning columns'
        # reduced images — per-cluster winners compose because reduced
        # columns stay inside their cluster's rows (block diagonality)
        contrib = jnp.zeros((B, m + 1, Wm), jnp.uint8)
        flip_cols = []  # (B, m+1) winning-column tables, pad = n
        if P:
            pw = jnp.take(
                jnp.asarray(pats_np), win_p.reshape(-1), axis=0
            ).reshape(B, m + 1, W)
            use_slot = (
                (pw == 1) & slot_ok & pat_won[:, :, None]
            )  # (B, m+1, W)
            for w in range(W):
                contrib = contrib ^ jnp.where(
                    use_slot[:, :, w, None], Rcol[:, :, w, :], 0
                )
                flip_cols.append(
                    jnp.where(use_slot[:, :, w], colof[:, :, w], n)
                )
        if use_singles:
            # winning-single columns via a one-hot contraction (byte
            # values <= 255 are exact in bf16; f32 accumulation)
            oh_s = (
                (
                    jnp.where(sing_won, arg_sing, n)[:, :, None]
                    == jnp.arange(n, dtype=jnp.int32)[None, None, :]
                )
            ).astype(jnp.bfloat16)  # (B, m+1, n); n sentinel matches none
            scol = jax.lax.dot_general(
                oh_s,
                Rt_packed[:, :n, :].astype(jnp.bfloat16),
                dimension_numbers=(((2,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32,
            ).astype(jnp.uint8)
            contrib = contrib ^ jnp.where(sing_won[:, :, None], scol, 0)
            flip_cols.append(jnp.where(sing_won, arg_sing, n))
        ystar_packed = synd_packed ^ jax.lax.reduce(
            contrib, np.uint8(0), jax.lax.bitwise_xor, (1,)
        )
        # flip vector via a dense membership test (winning columns are
        # unique across clusters, so `any` is exact)
        wcs = jnp.concatenate(flip_cols, axis=1)  # (B, (W+1)*(m+1))
        flip = (
            (wcs[:, :, None] == jnp.arange(n, dtype=jnp.int32)[None, None, :])
            .any(axis=1)
            .astype(jnp.uint8)
        )  # (B, n)

        # readout: x[j] = y*[pivot row of column j] (original coords).
        # prc == m means "no pivot"; bit m of the packed row is a zero
        # pad bit when m % 8 != 0, and the appended zero byte covers the
        # m % 8 == 0 case.
        ystar = gf2.unpack_bits_u8_device(ystar_packed, m)  # (B, m)
        x_piv = (
            (
                (
                    prc_orig[:, :, None]
                    == jnp.arange(m, dtype=jnp.int32)[None, None, :]
                )
                & (ystar[:, None, :] != 0)
            )
            .any(axis=2)
            .astype(jnp.uint8)
        )  # (B, n); prc == m (no pivot) matches nothing
        decoding = x_piv | flip
        return decoding, valid_out

    return jax.jit(decode)

