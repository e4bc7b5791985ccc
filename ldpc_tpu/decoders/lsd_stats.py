"""LSD decode statistics: per-cluster growth history recording.

The reference records per-cluster growth steps, merges, size history and
a timestep -> (cluster -> added bits) map while decoding
(reference: src_cpp/lsd.hpp:464-603,652-816 and
src_python/ldpc/bplsd_decoder/_bplsd_decoder.pyx:174-321). The batched
device decoder cannot cheaply emit ragged per-cluster records from
inside a ``while_loop``, so stats mode (``set_do_stats(True)``) replays
the growth loop for the decoded syndrome using the SAME jitted
primitives the decoder runs (``_propagate_labels`` / ``masked_solve`` /
``_grow`` from :mod:`ldpc_tpu.ops.uf`) — the cluster decomposition per
timestep is identical by construction — and derives the statistics on
the host.

Cluster-id convention: the reference ids clusters by creation order and
keeps the LARGER cluster on merge (lsd.hpp:190-293); the batched engine's
min-label propagation keeps the LOWEST seed-check index. Cluster
*contents* per timestep are identical; only which id survives a merge
differs (deterministically).
"""

from typing import Dict, Optional

import numpy as np

import jax
import jax.numpy as jnp

from ldpc_tpu.decoders.lsd_common import ClusterStatistics, Statistics
from ldpc_tpu.ops.pcm import PcmGraph
from ldpc_tpu.ops.uf import (
    _INF,
    _grow,
    _propagate_labels,
    invalid_checks_from_rref,
    masked_solve,
)

_INF_NP = int(_INF)


def _make_stat_round(graph: PcmGraph, bits_per_step: int, dtype):
    """One growth timestep, jitted once per (graph, bits_per_step):
    returns (labels, chk_invalid, new_in_bit, bit_cluster_of_new_bits)."""

    var_chks = jnp.asarray(graph.var_chks)
    var_mask = jnp.asarray(graph.var_mask)
    m = graph.m

    def round_fn(in_bit, syndromes, llrs):
        seed_checks = syndromes == 1
        labels, _ = _propagate_labels(graph, in_bit, seed_checks)
        res, _ = masked_solve(graph, in_bit, syndromes, llrs, dtype)
        chk_invalid = invalid_checks_from_rref(res, labels, m)
        new_in = _grow(
            graph, in_bit, labels, chk_invalid, llrs, bits_per_step, dtype
        )
        # cluster each bit joins: min label over its adjacent invalid
        # checks (the same rule _grow selects by)
        B = in_bit.shape[0]
        chk_inv_pad = jnp.concatenate(
            [chk_invalid, jnp.zeros((B, 1), bool)], axis=1
        )
        lab_pad = jnp.concatenate([labels, jnp.full((B, 1), _INF)], axis=1)
        nbr_inv = jnp.take(chk_inv_pad, var_chks, axis=1) & var_mask[None]
        joined_lab = jnp.where(
            nbr_inv, jnp.take(lab_pad, var_chks, axis=1), _INF
        ).min(axis=2)
        return labels, chk_invalid, new_in, joined_lab

    return jax.jit(round_fn)


def _bit_labels_np(H_csc, in_bit: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Per-bit cluster label: min over adjacent active checks (host)."""
    n = in_bit.shape[0]
    out = np.full(n, _INF_NP, np.int64)
    for j in np.flatnonzero(in_bit):
        rows = H_csc.indices[H_csc.indptr[j] : H_csc.indptr[j + 1]]
        if rows.size:
            out[j] = labels[rows].min()
    return out


def compute_lsd_statistics(
    graph: PcmGraph,
    H_csc,
    syndrome: np.ndarray,
    llrs: np.ndarray,
    bits_per_step: int,
    decoding: np.ndarray,
    dtype=jnp.float32,
    stats: Optional[Statistics] = None,
) -> Statistics:
    """Replay the grow-until-valid loop for one syndrome and fill the
    reference's statistics schema (lsd.hpp:683-784 timestep semantics:
    one timestep = one grow-all-invalid-clusters round)."""
    stats = stats if stats is not None else Statistics()
    m, n = graph.m, graph.n
    syndrome = np.asarray(syndrome).astype(np.uint8)
    if not syndrome.any():  # no clusters ever form
        stats.individual_cluster_stats = {}
        return stats
    round_fn = _make_stat_round(graph, bits_per_step, dtype)
    syn = jnp.asarray(syndrome[None, :], jnp.uint8)
    llr = jnp.asarray(np.asarray(llrs, np.float32)[None, :], dtype)

    in_bit_np = np.zeros(n, bool)
    in_bit = jnp.zeros((1, n), bool)
    cstats: Dict[int, ClusterStatistics] = {}
    # clusters are created one per flipped syndrome check (lsd.hpp:702-712)
    for c in np.flatnonzero(np.asarray(syndrome) == 1):
        cstats[int(c)] = ClusterStatistics(
            cluster_id=int(c), active=True, size_history=[0]
        )

    prev_labels = None
    labels = np.full(m, _INF_NP, np.int64)
    grew_last_round: set = set()
    timestep = 0
    max_rounds = n + 1
    while timestep < max_rounds:
        labels_d, chk_invalid_d, new_in_d, joined_d = round_fn(in_bit, syn, llr)
        labels = np.asarray(labels_d)[0]
        chk_invalid = np.asarray(chk_invalid_d)[0]
        new_in_np = np.asarray(new_in_d)[0]
        joined = np.asarray(joined_d)[0]

        active_ids = set(
            int(c) for c in np.unique(labels[labels < _INF_NP])
        )
        # size history: the reference pushes a cluster's size after its
        # growth step *and* any merges it triggered (lsd.hpp:714-725);
        # merges only become visible in the next round's labels, so the
        # append is deferred to here
        if grew_last_round:
            bl_now = _bit_labels_np(H_csc, in_bit_np, labels)
            for cid in grew_last_round:
                cs = cstats.get(cid)
                if cs is not None and cid in active_ids:
                    cs.size_history.append(int((bl_now == cid).sum()))
            grew_last_round = set()
        # merge bookkeeping: a previously-active id that is no longer a
        # label was absorbed by its check's new label
        if prev_labels is not None:
            for cid, cs in cstats.items():
                if cs.active and cid not in active_ids and cid < m:
                    absorber = int(labels[cid])
                    cs.active = False
                    cs.got_inactive_in_timestep = timestep
                    cs.absorbed_by_cluster = absorber
                    if absorber in cstats:
                        cstats[absorber].nr_merges += 1
                    # freeze membership at absorption time
                    bl_prev = _bit_labels_np(H_csc, in_bit_np, prev_labels)
                    cs.final_bits = [
                        int(b) for b in np.flatnonzero(bl_prev == cid)
                    ]
                    cs.final_bit_count = len(cs.final_bits)
        # validity per active cluster
        for cid in active_ids:
            cs = cstats.setdefault(
                cid, ClusterStatistics(cluster_id=cid, active=True, size_history=[0])
            )
            cluster_invalid = bool(chk_invalid[labels == cid].any())
            if not cluster_invalid and cs.got_valid_in_timestep < 0:
                cs.got_valid_in_timestep = timestep

        if not chk_invalid.any():
            break

        # growth: bits added this timestep, grouped by joined cluster
        added = new_in_np & ~in_bit_np
        if added.any():
            per_cluster: Dict[int, list] = {}
            for b in np.flatnonzero(added):
                per_cluster.setdefault(int(joined[b]), []).append(int(b))
            stats.global_timestep_bit_history[timestep] = per_cluster
            for cid in per_cluster:
                cs = cstats.get(cid)
                if cs is None or not cs.active:
                    continue
                cs.undergone_growth_steps += 1
                grew_last_round.add(cid)

        in_bit_np = new_in_np
        in_bit = new_in_d
        prev_labels = labels
        timestep += 1

    # final stats for still-active clusters (lsd.hpp:660-676)
    final_bl = _bit_labels_np(H_csc, in_bit_np, labels)
    H_csr = H_csc.tocsr()
    decoding = np.asarray(decoding).astype(np.uint8)
    for cid, cs in cstats.items():
        if not cs.active:
            continue
        bits = np.flatnonzero(final_bl == cid)
        cs.final_bits = [int(b) for b in bits]
        cs.final_bit_count = len(cs.final_bits)
        cs.solution = [int(decoding[b]) for b in bits]
        checks = np.flatnonzero(labels == cid)
        if bits.size and checks.size:
            nnz = int(H_csr[checks][:, bits].nnz)
            cs.nr_of_non_zero_check_matrix_entries = nnz
            cs.cluster_pcm_sparsity = 1.0 - nnz / float(
                bits.size * checks.size
            )
    stats.individual_cluster_stats = cstats
    return stats
