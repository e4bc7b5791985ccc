"""Batched union-find decoding on device (JAX/XLA).

Batched re-design of the reference union-find decoder
(reference: src_cpp/union_find.hpp, Delfosse-Nickerson arXiv:1709.06218 +
the Higgott "BeliefFind" LLR-guided variant). The reference grows
pointer-linked clusters one syndrome at a time; here the whole batch
decodes simultaneously with dense primitives:

- **Cluster labels** = connected components of the active Tanner
  subgraph, found by iterative min-label propagation (check -> member
  bits -> checks), replacing the robin-set cluster merges
  (union_find.hpp:190-293). Seeds are the flipped syndrome checks.
- **Growth** (union_find.hpp:164-194): bits adjacent to invalid clusters
  join them; when LLR-guided, only the ``bits_per_step`` smallest-LLR
  boundary bits of each cluster join per round (rank-within-cluster via
  one lexicographic sort).
- **Inversion validity/solve** (union_find.hpp:365-392): the reference
  runs a per-cluster fast_solve; because distinct clusters touch
  disjoint bit/check sets, the column-masked *global* system is
  block-diagonal, so ONE batched Gauss-Jordan (ops.gf2.batched_rref) of
  the masked PCM yields every cluster's validity (a cluster is invalid
  iff some unreduced row carrying syndrome 1 has its label) and, at the
  end, every cluster's solution at once.
- **Peeling validity/solve** (union_find.hpp:85,205-312): for column
  degree <= 2, "parity even or boundary bit present" coincides with the
  inversion mode's syndrome-in-image rule, so growth is shared; the
  peeling result comes from an explicit BFS forest + parallel leaf
  peeling.
"""

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ldpc_tpu.ops import gf2
from ldpc_tpu.ops.pcm import PcmGraph

_INF = jnp.int32(2**30)


# ----------------------------------------------------------------------
# shared cluster machinery
# ----------------------------------------------------------------------
def _propagate_labels(graph: PcmGraph, in_bit, seed_checks, warm=None):
    """Min-label propagation over the active Tanner subgraph.

    Active checks = seeds U checks adjacent to in-cluster bits; two
    checks share a cluster iff connected through in-cluster bits.
    ``warm`` optionally warm-starts from a previous round's labels
    (exact: labels only decrease as clusters grow/merge, so any earlier
    fixpoint is a valid upper bound and convergence takes ~1 sweep).
    Returns ``(labels: (B, m) int32 with _INF outside clusters,
    active_chk: (B, m) bool)``.
    """
    m = graph.m
    chk_bits = jnp.asarray(graph.chk_bits)
    chk_mask = jnp.asarray(graph.chk_mask)
    var_chks = jnp.asarray(graph.var_chks)
    var_mask = jnp.asarray(graph.var_mask)
    B = in_bit.shape[0]
    in_bit_pad = jnp.concatenate([in_bit, jnp.zeros((B, 1), bool)], axis=1)
    chk_has_bit = jnp.take(in_bit_pad, chk_bits, axis=1) & chk_mask  # (B,m,dc)
    active_chk = seed_checks | chk_has_bit.any(axis=2)  # (B, m)
    lab0 = jnp.where(active_chk, jnp.arange(m, dtype=jnp.int32)[None, :], _INF)
    if warm is not None:
        lab0 = jnp.where(active_chk, jnp.minimum(lab0, warm), _INF)

    def step(state):
        lab, _ = state
        lab_pad = jnp.concatenate([lab, jnp.full((B, 1), _INF)], axis=1)
        bl = jnp.where(
            var_mask[None], jnp.take(lab_pad, var_chks, axis=1), _INF
        ).min(axis=2)
        bl = jnp.where(in_bit, bl, _INF)  # (B, n)
        bl_pad = jnp.concatenate([bl, jnp.full((B, 1), _INF)], axis=1)
        thru = jnp.where(
            chk_mask[None], jnp.take(bl_pad, chk_bits, axis=1), _INF
        ).min(axis=2)
        new = jnp.minimum(lab, thru)
        return new, jnp.any(new != lab)

    lab, _ = jax.lax.while_loop(lambda s: s[1], step, (lab0, jnp.array(True)))
    return lab, active_chk


def _grow(graph: PcmGraph, in_bit, labels, chk_invalid, llrs, bits_per_step, dtype):
    """One growth round: each invalid cluster admits its ``bits_per_step``
    lowest-LLR boundary bits.

    A bit bordering SEVERAL invalid clusters competes in each of them
    independently (joining — and thereby merging — whenever it ranks in
    any one's top ``bits_per_step``), mirroring the reference's
    per-cluster sequential growth, where every cluster draws from its
    own boundary list regardless of the round's other additions
    (union_find.hpp:164-194, lsd.hpp:111-148). Identical join sets to
    the matmul-form :func:`_grow_round_mm`."""
    n = graph.n
    var_chks = jnp.asarray(graph.var_chks)
    var_mask = jnp.asarray(graph.var_mask)
    B = in_bit.shape[0]
    chk_inv_pad = jnp.concatenate([chk_invalid, jnp.zeros((B, 1), bool)], axis=1)
    lab_pad = jnp.concatenate([labels, jnp.full((B, 1), _INF)], axis=1)
    nbr_inv = jnp.take(chk_inv_pad, var_chks, axis=1) & var_mask[None]
    cand0 = nbr_inv.any(axis=2) & ~in_bit  # (B, n)
    if bits_per_step == 0:
        return in_bit | cand0
    dv = graph.dv
    E2 = n * dv
    bidx = jnp.arange(B)[:, None]
    # expanded (bit, slot) pairs so a bit competes in EVERY adjacent
    # invalid cluster; each cluster's full candidate set lives in one
    # label group of the expanded sort
    lab_e0 = jnp.where(
        nbr_inv, jnp.take(lab_pad, var_chks, axis=1), _INF
    ).reshape(B, E2)
    bit_of_e = jnp.repeat(jnp.arange(n, dtype=jnp.int32), dv)  # (E2,)
    llr_e = jnp.repeat(llrs.astype(dtype), dv, axis=1)  # (B, E2)
    sub = jnp.argsort(llr_e, axis=1, stable=True).astype(jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(E2, dtype=jnp.int32)[None, :], (B, E2))
    grown = in_bit
    # one bit per cluster per sub-round, exactly like the matmul-form
    # iterated min-key pick (the candidate pool shrinks as other
    # clusters' picks land)
    for _ in range(bits_per_step):
        cand_e = jnp.repeat(cand0 & ~grown, dv, axis=1)
        lab_e = jnp.where(cand_e, lab_e0, _INF)
        lab_by_llr = jnp.take_along_axis(lab_e, sub, axis=1)
        seg = jnp.argsort(lab_by_llr, axis=1, stable=True).astype(jnp.int32)
        perm = jnp.take_along_axis(sub, seg, axis=1)  # (B, E2) pair ids
        lab_sorted = jnp.take_along_axis(lab_e, perm, axis=1)
        is_start = jnp.concatenate(
            [
                jnp.ones((B, 1), bool),
                lab_sorted[:, 1:] != lab_sorted[:, :-1],
            ],
            axis=1,
        )
        seg_start = jax.lax.associative_scan(
            jnp.maximum, jnp.where(is_start, pos, 0), axis=1
        )
        rank = pos - seg_start
        take = (rank < 1) & (lab_sorted < _INF)
        win_bits = jnp.where(take, bit_of_e[perm], n)
        grown = (
            jnp.zeros((B, n + 1), bool)
            .at[bidx, win_bits]
            .max(take)[:, :n]
            | grown
        )
    return grown


# ----------------------------------------------------------------------
# inversion (matrix) mode
# ----------------------------------------------------------------------
def masked_solve(
    graph: PcmGraph,
    in_bit,
    syndromes,
    llrs,
    dtype=jnp.float32,
    with_transform: bool = False,
    with_reduced: bool = False,
):
    """Gauss-Jordan of the column-masked PCM in ascending-LLR order
    (pivots land on the most error-likely bits, mirroring the
    soft-guided insertion order of the reference's cluster solve).

    Returns ``(RrefResult, order: (B, n) int32 permuted->original)``.
    """
    H_dev = jnp.asarray(graph.dense)
    key = jnp.where(in_bit, llrs.astype(dtype), jnp.array(np.inf, dtype))
    order = jnp.argsort(key, axis=1, stable=True).astype(jnp.int32)
    H_perm = jnp.take(H_dev, order, axis=1).transpose(1, 0, 2)  # (B, m, n)
    colmask = jnp.take_along_axis(in_bit, order, axis=1)
    H_perm = H_perm * colmask[:, None, :].astype(jnp.uint8)
    res = gf2.batched_rref(
        H_perm,
        syndromes,
        with_transform=with_transform,
        with_reduced=with_reduced,
    )
    return res, order


def invalid_checks_from_bad(bad_row, labels, m):
    """Per-check invalid-cluster flags from per-row "unreduced with
    syndrome 1" flags. A cluster is invalid iff one of its rows is
    flagged (valid by block-diagonality of the masked system across
    clusters)."""
    B = labels.shape[0]
    bidx = jnp.arange(B)[:, None]
    bad = bad_row.astype(jnp.int32)
    lab_clip = jnp.minimum(labels, m)
    invalid_of_label = (
        jnp.zeros((B, m + 1), jnp.int32).at[bidx, lab_clip].max(bad)
    )
    return (invalid_of_label[bidx, lab_clip] > 0) & (labels < _INF)


def invalid_checks_from_rref(res, labels, m):
    """Per-check invalid-cluster flags from a masked global rref."""
    return invalid_checks_from_bad(
        (res.synd_red == 1) & ~res.row_used, labels, m
    )


_INF_F = jnp.float32(1.0e7)  # exact in f32; > any label/key


def _adj_constants(graph: PcmGraph):
    """Dense one-hot slot-gather matrices for matmul-form graph sweeps.

    ``Gv[k]`` (m, n): column j selects check ``var_chks[j, k]`` — so
    ``x_chk @ Gv[k]`` gathers a per-check value onto bits, slot k.
    ``Gc[k]`` (n, m): column i selects bit ``chk_bits[i, k]``.
    """
    m, n, dc, dv = graph.m, graph.n, graph.dc, graph.dv
    Gv = np.zeros((dv, m, n), np.float32)
    for j in range(n):
        for k in range(dv):
            if graph.var_mask[j, k]:
                Gv[k, graph.var_chks[j, k], j] = 1.0
    Gc = np.zeros((dc, n, m), np.float32)
    for i in range(m):
        for k in range(dc):
            if graph.chk_mask[i, k]:
                Gc[k, graph.chk_bits[i, k], i] = 1.0
    maskv = graph.var_mask.T.astype(np.float32)  # (dv, n)
    maskc = graph.chk_mask.T.astype(np.float32)  # (dc, m)
    return (
        jnp.asarray(Gv),
        jnp.asarray(Gc),
        jnp.asarray(maskv),
        jnp.asarray(maskc),
        jnp.asarray(graph.dense.astype(np.float32)),  # A (m, n)
    )


def _propagate_labels_mm(graph: PcmGraph, adj, in_bit, seed_checks, warm=None):
    """:func:`_propagate_labels` with every graph sweep as one-hot
    matmuls + elementwise mins (identical fixpoint)."""
    Gv, Gc, maskv, maskc, A = adj
    m = graph.m
    B = in_bit.shape[0]
    in_f = in_bit.astype(jnp.float32)
    active_chk = seed_checks | (
        jax.lax.dot_general(
            in_f, A, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST
        )
        > 0.5
    )
    iota_m = jnp.arange(m, dtype=jnp.float32)[None, :]
    lab0 = jnp.where(active_chk, iota_m, _INF_F)
    if warm is not None:
        lab0 = jnp.where(active_chk, jnp.minimum(lab0, warm), _INF_F)
    dv, dc = Gv.shape[0], Gc.shape[0]

    def gather_chk_to_bit(x_chk, fill):
        out = None
        for k in range(dv):
            g = jnp.dot(x_chk, Gv[k], preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)
            g = jnp.where(maskv[k][None, :] > 0, g, fill)
            out = g if out is None else jnp.minimum(out, g)
        return out

    def gather_bit_to_chk(x_bit, fill):
        out = None
        for k in range(dc):
            g = jnp.dot(x_bit, Gc[k], preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)
            g = jnp.where(maskc[k][None, :] > 0, g, fill)
            out = g if out is None else jnp.minimum(out, g)
        return out

    def step(state):
        lab, _ = state
        bl = gather_chk_to_bit(lab, _INF_F)
        bl = jnp.where(in_bit, bl, _INF_F)
        thru = gather_bit_to_chk(bl, _INF_F)
        new = jnp.minimum(lab, thru)
        return new, jnp.any(new != lab)

    lab, _ = jax.lax.while_loop(lambda s: s[1], step, (lab0, jnp.array(True)))
    return lab, active_chk


def _grow_round_mm(graph, adj, in_bit, bad_row, llr_rank, bits_per_step):
    """One label-free growth round: every invalid cluster admits its
    ``bits_per_step`` lowest-LLR-rank boundary bits.

    Cluster labels are unnecessary here: floodfills confined to
    in-cluster connectivity cannot leak between clusters (distinct
    clusters are disconnected by definition), so ONE jointly-stacked
    min-floodfill of [badness ; candidate key] computes both the
    per-cluster invalid flag (badness 0 reachable from an unreduced
    syndrome-1 row — bad-row reachability through in-cluster bits) and the
    per-cluster minimum boundary key. A candidate bit joins iff some
    adjacent check carries badness 0 AND the cluster-min key equals the
    bit's own (globally unique) LLR rank — the identical join set to
    a label-scoped selection would compute, at a third of the sweeps.

    Returns ``(new_in, any_invalid: (B,) bool)``.
    """
    Gv, Gc, maskv, maskc, A = adj
    B = in_bit.shape[0]
    dv, dc = Gv.shape[0], Gc.shape[0]

    def mmdot(x, G):
        return jnp.dot(
            x, G,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    def flood(x0, inb):
        """Min-floodfill (C*B, m) channels through in-cluster bits."""

        def step(state):
            x, _ = state
            bl = None
            for k in range(dv):
                g = mmdot(x, Gv[k])
                g = jnp.where(maskv[k][None, :] > 0, g, _INF_F)
                bl = g if bl is None else jnp.minimum(bl, g)
            bl = jnp.where(inb, bl, _INF_F)
            back = None
            for k in range(dc):
                g = mmdot(bl, Gc[k])
                g = jnp.where(maskc[k][None, :] > 0, g, _INF_F)
                back = g if back is None else jnp.minimum(back, g)
            new = jnp.minimum(x, back)
            return new, jnp.any(new != x)

        x, _ = jax.lax.while_loop(
            lambda s: s[1], step, (x0, jnp.array(True))
        )
        return x

    badmin0 = jnp.where(bad_row, 0.0, _INF_F)  # (B, m)
    if bits_per_step == 0:
        badmin = flood(badmin0, in_bit)
        invalid = badmin == 0.0
        any_invalid = invalid.any(axis=1)
        # grow-all: every bit adjacent to an invalid check joins
        nbr_inv = mmdot(invalid.astype(jnp.float32), A) > 0.5
        return in_bit | nbr_inv, any_invalid

    in2 = jnp.concatenate([in_bit, in_bit], axis=0)  # stacked channels
    grown = in_bit
    taken = jnp.zeros((B, in_bit.shape[1]), bool)
    any_invalid = None
    for _ in range(bits_per_step):
        cand = ~grown & ~taken
        key_bits = jnp.where(cand, llr_rank, _INF_F)  # (B, n)
        keymin0 = None
        for k in range(dc):
            g = mmdot(key_bits, Gc[k])
            g = jnp.where(maskc[k][None, :] > 0, g, _INF_F)
            keymin0 = g if keymin0 is None else jnp.minimum(keymin0, g)
        both = flood(jnp.concatenate([badmin0, keymin0], axis=0), in2)
        badmin, keymin = both[:B], both[B:]
        invalid = badmin == 0.0
        if any_invalid is None:
            any_invalid = invalid.any(axis=1)
        # min-key selection: the bit whose rank IS an adjacent invalid
        # cluster's minimum joins it
        win = None
        for k in range(dv):
            gb = mmdot(jnp.where(invalid, 0.0, 1.0), Gv[k])
            gk = mmdot(jnp.where(invalid, keymin, _INF_F), Gv[k])
            ok = (maskv[k][None, :] > 0) & (gb < 0.5) & (gk == llr_rank)
            win = ok if win is None else (win | ok)
        win = win & cand
        grown = grown | win
        taken = taken | win
    return grown, any_invalid


def grow_until_valid(graph: PcmGraph, syndromes, llrs, bits_per_step, dtype):
    """The shared UF/LSD growth loop: grow invalid clusters until every
    cluster's syndrome is in the image of its sub-PCM
    (union_find.hpp:503-520, lsd.hpp:714-741).

    Returns ``(in_bit, res, order)`` of the final valid state.
    """
    m, n = graph.m, graph.n
    B = syndromes.shape[0]
    seed_checks = syndromes == 1

    def round_body(state_i):
        (in_bit, _, _, _), i = state_i
        labels, _ = _propagate_labels(graph, in_bit, seed_checks)
        res, order = masked_solve(graph, in_bit, syndromes, llrs, dtype)
        chk_invalid = invalid_checks_from_rref(res, labels, m)
        any_invalid = chk_invalid.any(axis=1)
        new_in = _grow(
            graph, in_bit, labels, chk_invalid, llrs, bits_per_step, dtype
        )
        new_in = jnp.where(any_invalid[:, None], new_in, in_bit)
        return (new_in, res, order, any_invalid), i + 1

    def cond(state_i):
        (_, _, _, any_invalid), i = state_i
        # every invalid cluster gains >= 1 bit per round -> n bounds it
        return jnp.any(any_invalid) & (i <= n)

    res0, order0 = masked_solve(
        graph, jnp.zeros((B, n), bool), syndromes, llrs, dtype
    )
    state0 = (
        (jnp.zeros((B, n), bool), res0, order0, jnp.ones(B, bool)),
        jnp.int32(0),
    )
    (in_bit, res, order, _), _ = jax.lax.while_loop(cond, round_body, state0)
    return in_bit, res, order


def make_uf_decoder(
    graph: PcmGraph,
    bits_per_step: int = 0,
    dtype=jnp.float32,
):
    """Build a jitted batched union-find inversion-mode decoder
    (union_find.hpp:485-532).

    ``bits_per_step == 0`` grows every boundary bit of every invalid
    cluster per round; otherwise the ``bits_per_step`` lowest-LLR
    boundary bits per cluster join per round (the BeliefFind mode).

    Returns ``decode(syndromes: (B, m) uint8, llrs: (B, n)) ->
    (decoding: (B, n) uint8, valid: (B,) bool)``.
    """
    if bits_per_step >= graph.n:
        # a per-cluster rank bound of >= n admits every boundary bit, so
        # this is exactly the grow-all fast path (the reference's
        # bits_per_step=0 -> n default maps here) — without it the
        # rank-selection machinery unrolls ``bits_per_step`` sweeps
        bits_per_step = 0

    def decode(syndromes: jnp.ndarray, llrs: jnp.ndarray):
        B = syndromes.shape[0]
        syndromes = syndromes.astype(jnp.uint8)
        bidx = jnp.arange(B)[:, None]
        _, res, order = grow_until_valid(
            graph, syndromes, llrs, bits_per_step, dtype
        )
        decoding = jnp.zeros((B, graph.n), jnp.uint8).at[bidx, order].set(res.x0)
        return decoding, res.valid

    return jax.jit(decode)


# ----------------------------------------------------------------------
# peeling mode (planar codes, column degree <= 2)
# ----------------------------------------------------------------------
def make_peel_decoder(
    graph: PcmGraph,
    bits_per_step: int = 0,
    dtype=jnp.float32,
):
    """Build a jitted batched union-find peeling decoder
    (union_find.hpp:428-480).

    Requires every column degree <= 2 (validated by the caller). Bits are
    edges between their two checks; degree-1 ("planar boundary") bits
    connect to a virtual boundary check (union_find.hpp:205-251).

    Three stages, every graph sweep a one-hot matmul:

    1. **Growth** is shared with the inversion decoder
       (:func:`grow_until_valid`): for column degree <= 2 a
       cluster's syndrome is in the image of its columns exactly when
       its parity is even or it contains a degree-1 (boundary) column —
       the reference's peel validity rule (union_find.hpp:460-463) — so
       the per-round invalid flags, and hence the growth sequence, are
       identical.
    2. **Spanning forest**: per-cluster BFS trees from each cluster's
       label root (+ at most one boundary edge per cluster to the
       virtual check). The reference's first-come sequential forest
       (union_find.hpp:205-236) spans the same components; the peeling
       solution on any spanning forest of a validity-passing cluster is
       exact, so forest choice only affects which of several equally
       valid corrections is returned.
    3. **Peeling** resolves every current leaf check per round; the tree
       solution is unique so parallel order is exact.

    Returns ``decode(syndromes: (B, m) uint8, llrs: (B, n)) ->
    (decoding: (B, n) uint8, valid: (B,) bool)``.
    """
    if bits_per_step >= graph.n:
        bits_per_step = 0  # grow-all (see make_uf_decoder)
    m, n = graph.m, graph.n
    var_chks = np.asarray(graph.var_chks)
    var_mask = np.asarray(graph.var_mask)
    if graph.dv > 2:
        raise ValueError("peeling requires column degree <= 2")
    dc = graph.dc
    adj = _adj_constants(graph)
    Gv, Gc, maskv, maskc, A = adj
    INF = _INF_F

    # edge endpoints: u = first check, v = second check or virtual
    u_np = var_chks[:, 0].astype(np.int32)
    if graph.dv == 2:
        v_np = np.where(var_mask[:, 1], var_chks[:, 1], m).astype(np.int32)
    else:
        v_np = np.full(n, m, dtype=np.int32)
    bnd_np = v_np == m  # degree-1 columns
    is_boundary = jnp.asarray(bnd_np)
    has_v = jnp.asarray(~bnd_np)
    A_T = jnp.asarray(np.asarray(graph.dense, np.float32).T)  # (n, m)

    # per-(check, slot) constants: the slot's bit index, whether this
    # check is that bit's u endpoint, and whether the bit is a boundary
    chk_bits_np = np.asarray(graph.chk_bits)
    chk_mask_np = np.asarray(graph.chk_mask)
    slot_bit = np.where(chk_mask_np, chk_bits_np, n).astype(np.float32)
    slot_is_u = np.zeros((m, dc), bool)
    slot_bnd = np.zeros((m, dc), bool)
    for i in range(m):
        for k in range(dc):
            if chk_mask_np[i, k]:
                e = chk_bits_np[i, k]
                slot_is_u[i, k] = u_np[e] == i
                slot_bnd[i, k] = bnd_np[e]
    slot_bit_d = jnp.asarray(slot_bit)  # (m, dc), pad = n
    slot_is_u_d = jnp.asarray(slot_is_u)
    slot_bnd_d = jnp.asarray(slot_bnd)
    iota_n = jnp.arange(n, dtype=jnp.float32)[None, :]
    iota_m = jnp.arange(m, dtype=jnp.float32)[None, :]

    def mm(x, G):
        return jnp.dot(
            x,
            G,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    def gather_chk_to_bit(x_chk, k, fill):
        """Value of each bit's k-th check (fill where no such check)."""
        g = mm(x_chk, Gv[k])
        return jnp.where(maskv[k][None, :] > 0, g, fill)

    def gather_bit_to_chk(x_bit, k, fill):
        """Value of each check's k-th slot bit (fill at padded slots)."""
        g = mm(x_bit, Gc[k])
        return jnp.where(maskc[k][None, :] > 0, g, fill)

    def build_forest(in_bit, labels):
        """Per-cluster BFS forest (tree edges as a (B, n) bool mask)."""
        B = in_bit.shape[0]
        in_f = in_bit.astype(jnp.float32)
        interior = in_bit & has_v[None, :]  # 2 real endpoints
        root = labels == iota_m  # cluster label roots
        dist0 = jnp.where(root, 0.0, INF)

        # BFS distance over interior edges: dist[c] = min over incident
        # interior edges of dist[other endpoint] + 1
        def dist_sweep(dist):
            d0 = jnp.where(interior, gather_chk_to_bit(dist, 0, INF), INF)
            d1 = (
                jnp.where(interior, gather_chk_to_bit(dist, 1, INF), INF)
                if graph.dv == 2
                else jnp.full_like(d0, INF)
            )
            new = dist
            for k in range(dc):
                du = gather_bit_to_chk(d0, k, INF)
                dv_ = gather_bit_to_chk(d1, k, INF)
                otherd = jnp.where(slot_is_u_d[:, k][None, :], dv_, du)
                new = jnp.minimum(new, otherd + 1.0)
            return new

        def dist_cond(s):
            return s[1]

        def dist_body(s):
            d, _ = s
            nd = dist_sweep(d)
            return nd, jnp.any(nd != d)

        dist, _ = jax.lax.while_loop(
            dist_cond, dist_body, (dist0, jnp.array(True))
        )

        # parent edge per non-root check: min-index interior edge whose
        # other endpoint is one BFS level closer to the root
        d0 = jnp.where(interior, gather_chk_to_bit(dist, 0, INF), INF)
        d1 = (
            jnp.where(interior, gather_chk_to_bit(dist, 1, INF), INF)
            if graph.dv == 2
            else jnp.full_like(d0, INF)
        )
        in_bit_f = interior.astype(jnp.float32)
        parent_bit = jnp.full((B, m), float(n), jnp.float32)
        for k in range(dc):
            du = gather_bit_to_chk(d0, k, INF)
            dv_ = gather_bit_to_chk(d1, k, INF)
            present = gather_bit_to_chk(in_bit_f, k, 0.0) > 0.5
            otherd = jnp.where(slot_is_u_d[:, k][None, :], dv_, du)
            ok = present & (otherd == dist - 1.0) & (dist < INF) & ~root
            cand = jnp.where(ok, slot_bit_d[:, k][None, :], float(n))
            parent_bit = jnp.minimum(parent_bit, cand)
        # a bit is a tree edge iff it is some endpoint's parent edge
        pb_u = gather_chk_to_bit(parent_bit, 0, float(n))
        tree = pb_u == iota_n
        if graph.dv == 2:
            pb_v = gather_chk_to_bit(parent_bit, 1, float(n))
            tree = tree | (pb_v == iota_n)
        tree = tree & interior

        # one boundary edge per cluster (lowest bit index): min-floodfill
        # the per-check boundary-edge key through each cluster
        bkey0 = jnp.full((B, m), INF, jnp.float32)
        for k in range(dc):
            present = gather_bit_to_chk(in_f, k, 0.0) > 0.5
            ok = present & slot_bnd_d[:, k][None, :]
            bkey0 = jnp.minimum(
                bkey0, jnp.where(ok, slot_bit_d[:, k][None, :], INF)
            )

        def bkey_sweep(bkey):
            bl = jnp.where(in_bit, gather_chk_to_bit(bkey, 0, INF), INF)
            if graph.dv == 2:
                bl = jnp.minimum(
                    bl, jnp.where(in_bit, gather_chk_to_bit(bkey, 1, INF), INF)
                )
            new = bkey
            for k in range(dc):
                new = jnp.minimum(new, gather_bit_to_chk(bl, k, INF))
            return new

        def bkey_body(s):
            b, _ = s
            nb = bkey_sweep(b)
            return nb, jnp.any(nb != b)

        bkey, _ = jax.lax.while_loop(
            lambda s: s[1], bkey_body, (bkey0, jnp.array(True))
        )
        # boundary bit joins the tree iff it IS its cluster's chosen key
        bk_u = gather_chk_to_bit(bkey, 0, INF)
        tree = tree | (
            in_bit & is_boundary[None, :] & (bk_u == iota_n)
        )
        return tree

    def peel(tree, syndromes):
        """Parallel leaf peeling: resolve every current leaf check per
        round (union_find.hpp:253-312); the tree solution is unique so
        order does not matter. All graph traffic rides one-hot
        contractions."""
        B = tree.shape[0]
        synd0 = syndromes.astype(jnp.float32)  # (B, m) real checks

        # deg[c] = number of remaining tree edges at check c
        def one_round(state):
            rem, synd, dec, _ = state
            rem_f = rem.astype(jnp.float32)
            deg = mm(rem_f, A_T)  # (B, m): A_T is (n, m)
            leaf = deg == 1.0
            leaf_f = leaf.astype(jnp.float32)
            lu = gather_chk_to_bit(leaf_f, 0, 0.0) > 0.5
            lv = (
                gather_chk_to_bit(leaf_f, 1, 0.0) > 0.5
                if graph.dv == 2
                else jnp.zeros_like(lu)
            )
            from_u = lu & rem
            from_v = lv & ~lu & rem & has_v[None, :]
            act = from_u | from_v
            s_u = gather_chk_to_bit(synd, 0, 0.0)
            s_v = (
                gather_chk_to_bit(synd, 1, 0.0)
                if graph.dv == 2
                else jnp.zeros_like(s_u)
            )
            x = jnp.where(from_u, s_u, s_v) * act.astype(jnp.float32)
            dec = jnp.where(act, x, dec)
            # push x across the edge into the other endpoint; clear the
            # resolver; virtual endpoints absorb silently (they are not
            # in the (B, m) node arrays at all)
            push_to_v = x * from_u.astype(jnp.float32)  # arrives at v
            push_to_u = x * from_v.astype(jnp.float32)  # arrives at u
            res_u = from_u.astype(jnp.float32)  # resolver is u
            res_v = from_v.astype(jnp.float32)  # resolver is v
            delta = jnp.zeros_like(synd)
            clr = jnp.zeros_like(synd)
            for k in range(dc):
                isu = slot_is_u_d[:, k][None, :]
                pv = gather_bit_to_chk(push_to_v, k, 0.0)
                pu = gather_bit_to_chk(push_to_u, k, 0.0)
                delta = delta + jnp.where(isu, pu, pv)
                ru = gather_bit_to_chk(res_u, k, 0.0)
                rv = gather_bit_to_chk(res_v, k, 0.0)
                clr = clr + jnp.where(isu, ru, rv)
            synd = synd + delta
            synd = synd - 2.0 * jnp.floor(synd * 0.5)  # mod 2
            synd = jnp.where(clr > 0.5, 0.0, synd)
            rem = rem & ~act
            return rem, synd, dec, act.any()

        state0 = (
            tree,
            synd0,
            jnp.zeros((B, n), jnp.float32),
            jnp.array(True),
        )
        rem, synd, dec, _ = jax.lax.while_loop(
            lambda s: s[3], one_round, state0
        )
        leftover = (synd > 0.5).any(axis=1)
        return dec.astype(jnp.uint8), ~leftover

    def decode(syndromes: jnp.ndarray, llrs: jnp.ndarray):
        syndromes = syndromes.astype(jnp.uint8)
        seed_checks = syndromes == 1
        in_bit, _, _ = grow_until_valid(
            graph, syndromes, llrs, bits_per_step, dtype
        )
        labels, _ = _propagate_labels_mm(graph, adj, in_bit, seed_checks)
        tree = build_forest(in_bit, labels)
        return peel(tree, syndromes)

    return jax.jit(decode)
