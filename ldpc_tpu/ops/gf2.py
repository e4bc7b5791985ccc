"""Batched GF(2) elimination on device (JAX/XLA, bit-packed uint32).

Batched replacement for the reference's sparse/dense row-reduction
engines (reference: src_cpp/gf2sparse_linalg.hpp:132-401,
src_cpp/gf2dense.hpp:184-440). Instead of pointer-chasing one system at a
time, a whole batch of GF(2) systems — typically the BP-failed syndromes,
each with its own reliability column ordering — is reduced simultaneously:

- the working matrix is the column-permuted PCM augmented with the
  syndrome and an m x m identity (the row-transform), bit-packed 32
  columns per uint32 lane;
- elimination is swap-free Gauss-Jordan: per column, pick the first
  unused row holding a 1 (batched argmax), XOR it into every other row
  with a 1 there (masked outer-product XOR);
- pivot bookkeeping (pivot row per column, pivot mask) replaces row
  permutations, so solutions read off directly.

Because the pivot *column set* depends only on the column order (not the
pivot-row choice), solutions agree bit-for-bit with the reference's
``lu_solve``/``fast_solve``.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def pack_u32(bits: jnp.ndarray) -> jnp.ndarray:
    """Pack a (..., n) 0/1 array into (..., ceil(n/32)) uint32 (LSB-first)."""
    n = bits.shape[-1]
    W = -(-n // 32)
    pad = W * 32 - n
    if pad:
        bits = jnp.concatenate(
            [bits, jnp.zeros(bits.shape[:-1] + (pad,), bits.dtype)], axis=-1
        )
    words = bits.reshape(bits.shape[:-1] + (W, 32)).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return (words << shifts).sum(axis=-1).astype(jnp.uint32)


def unpack_u32(words: jnp.ndarray, n: int) -> jnp.ndarray:
    """Inverse of :func:`pack_u32`: (..., W) uint32 -> (..., n) uint8."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (words[..., None] >> shifts) & jnp.uint32(1)
    return bits.reshape(words.shape[:-1] + (-1,))[..., :n].astype(jnp.uint8)


class RrefResult(NamedTuple):
    """Batched reduced-row-echelon state over permuted columns.

    All arrays are batch-major; ``n`` indexes *permuted* column positions.
    """

    piv_row_of_col: jnp.ndarray  # (B, n) int32, pivot row of column, m if none
    is_pivot: jnp.ndarray  # (B, n) bool
    row_used: jnp.ndarray  # (B, m) bool, rows consumed as pivots
    x0: jnp.ndarray  # (B, n) uint8, solution in permuted coords (non-pivots 0)
    transform: jnp.ndarray  # (B, m, Wm) uint32, packed row transform T
    synd_red: jnp.ndarray  # (B, m) uint8, T @ syndrome (solution bits per row)
    valid: jnp.ndarray  # (B,) bool, syndrome in image
    reduced: jnp.ndarray  # (B, m, n) uint8 reduced matrix (with_reduced only)


def batched_rref(
    H_perm_bits: jnp.ndarray,
    syndrome: jnp.ndarray,
    with_transform: bool = True,
    fast_exit: bool = False,
    with_reduced: bool = False,
) -> RrefResult:
    """Gauss-Jordan reduce a batch of column-permuted GF(2) systems.

    Args:
      H_perm_bits: (B, m, n) uint8 — the PCM with columns gathered in each
        batch element's processing order (most-reliable-pivot order).
      syndrome: (B, m) uint8.
      with_transform: also carry the m x m row-transform block (needed for
        re-solving against shifted syndromes, e.g. OSD-w candidates); skip
        it for plain solves — a third less elimination traffic.
      with_reduced: also return the reduced matrix bits (T @ H_perm);
        free (already computed) — candidate sweeps read shifted-syndrome
        solutions straight off it, so no m x m transform is needed.
      fast_exit: stop an element's participation once its syndrome is
        fully reduced (the reference's fast_solve,
        gf2sparse_linalg.hpp:298-401). ``x0``, ``valid`` and the
        per-row "unreduced syndrome 1" flags are provably unchanged, but
        ``is_pivot``/``piv_row_of_col``/``row_used`` are left incomplete
        for early-exited elements — only enable when callers consume the
        former set (OSD-0 does; LSD-w's nullity bookkeeping does not).
        Incompatible with ``with_transform``.
    """
    if fast_exit and with_transform:
        raise ValueError("fast_exit requires with_transform=False")
    B, m, n = H_perm_bits.shape
    # augmented: [H_perm | syndrome (| I_m)], packed along columns
    blocks = [
        H_perm_bits.astype(jnp.uint8),
        syndrome[:, :, None].astype(jnp.uint8),
    ]
    if with_transform:
        blocks.append(
            jnp.broadcast_to(jnp.eye(m, dtype=jnp.uint8)[None], (B, m, m))
        )
    aug_bits = jnp.concatenate(blocks, axis=2)
    M0 = pack_u32(aug_bits)  # (B, m, W)
    row_ids = jnp.arange(m, dtype=jnp.int32)
    sw, sb_shift = n // 32, jnp.uint32(n % 32)  # syndrome column position

    def step(carry):
        M, used, piv_row_of_col, done, j = carry
        w = j // 32
        b = (j % 32).astype(jnp.uint32)
        col = (jax.lax.dynamic_index_in_dim(M, w, axis=2, keepdims=False) >> b) & 1
        col = col.astype(jnp.bool_)  # (B, m)
        cand = col & ~used
        has = cand.any(axis=1)  # (B,)
        piv = jnp.argmax(cand, axis=1).astype(jnp.int32)  # first unused 1-row
        piv_vec = jnp.take_along_axis(M, piv[:, None, None], axis=1)  # (B,1,W)
        is_piv_row = row_ids[None, :] == piv[:, None]
        elim = col & ~is_piv_row & has[:, None]
        M = jnp.where(elim[:, :, None], M ^ piv_vec, M)
        used = used | (is_piv_row & has[:, None])
        piv_row_of_col = piv_row_of_col.at[:, j].set(jnp.where(has, piv, m))
        if fast_exit:
            # fast-solve (reference gf2sparse_linalg.hpp:298-401): once an
            # element has no unreduced syndrome 1 left, every later pivot
            # row carries syndrome bit 0, so no syndrome bit (hence no x0
            # readout or validity flag) can change — the element is done.
            sbit = (
                jax.lax.dynamic_index_in_dim(M, sw, axis=2, keepdims=False)
                >> sb_shift
            ) & 1
            solved = ~((sbit == 1) & ~used).any(axis=1)
            done = done | solved | used.all(axis=1)
        return (M, used, piv_row_of_col, done, j + 1)

    def cond(carry):
        _, used, _, done, j = carry
        # stop when every element is done: all rows used (no more pivots
        # possible) or — under fast_exit — its syndrome is solved
        if fast_exit:
            return (j < n) & ~jnp.all(done)
        return (j < n) & ~jnp.all(used)

    carry0 = (
        M0,
        jnp.zeros((B, m), bool),
        jnp.full((B, n), m, dtype=jnp.int32),
        jnp.zeros((B,), bool),
        jnp.int32(0),
    )
    with jax.named_scope("gf2_elim"):  # stage name in profiler traces
        M, used, piv_row_of_col, _, _ = jax.lax.while_loop(
            cond, step, carry0
        )

    is_pivot = piv_row_of_col < m
    all_bits = unpack_u32(M, n + 1 + (m if with_transform else 0))
    synd_red = all_bits[:, :, n]  # (B, m): reduced syndrome bit per row
    if with_transform:
        transform = pack_u32(all_bits[:, :, n + 1 :])  # (B, m, Wm)
    else:
        transform = jnp.zeros((B, m, 1), jnp.uint32)
    reduced = (
        all_bits[:, :, :n] if with_reduced else jnp.zeros((B, 1, 1), jnp.uint8)
    )
    # solution: x[col] = reduced syndrome bit at that column's pivot row
    synd_pad = jnp.concatenate([synd_red, jnp.zeros((B, 1), jnp.uint8)], axis=1)
    x0 = jnp.where(
        is_pivot,
        jnp.take_along_axis(synd_pad, piv_row_of_col, axis=1),
        0,
    ).astype(jnp.uint8)
    # consistent iff every non-pivot row has reduced syndrome 0
    valid = ~((synd_red == 1) & ~used).any(axis=1)
    return RrefResult(
        piv_row_of_col=piv_row_of_col,
        is_pivot=is_pivot,
        row_used=used,
        x0=x0,
        transform=transform,
        synd_red=synd_red,
        valid=valid,
        reduced=reduced,
    )


def apply_transform(transform: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Apply the packed row transform to new syndromes: (T @ t) % 2.

    Args:
      transform: (B, m, Wm) uint32 packed rows of T.
      t: (B, C, m) uint8 — C syndromes per batch element.
    Returns: (B, C, m) uint8.
    """
    tp = pack_u32(t)  # (B, C, Wm)
    ands = transform[:, None, :, :] & tp[:, :, None, :]  # (B, C, m, Wm)
    # popcount parity of each AND row
    x = ands
    x = x ^ (x >> jnp.uint32(16))
    x = x ^ (x >> jnp.uint32(8))
    x = x ^ (x >> jnp.uint32(4))
    x = x ^ (x >> jnp.uint32(2))
    x = x ^ (x >> jnp.uint32(1))
    parity = (x & jnp.uint32(1)).astype(jnp.uint8)
    return parity.sum(axis=-1) % 2  # XOR across words


def pack_bits_u8(bits: jnp.ndarray) -> jnp.ndarray:
    """Pack a (..., n) 0/1 array into (..., ceil(n/8)) uint8 (LSB-first).

    Device-side output compression: decode results travel bit-packed
    and are expanded host-side with
    ``np.unpackbits(..., bitorder='little')``.
    """
    n = bits.shape[-1]
    W = -(-n // 8)
    pad = W * 8 - n
    if pad:
        bits = jnp.concatenate(
            [bits, jnp.zeros(bits.shape[:-1] + (pad,), bits.dtype)], axis=-1
        )
    by = bits.reshape(bits.shape[:-1] + (W, 8)).astype(jnp.uint8)
    shifts = jnp.arange(8, dtype=jnp.uint8)
    return (by << shifts).sum(axis=-1).astype(jnp.uint8)


def unpack_bits_u8(packed: np.ndarray, n: int) -> np.ndarray:
    """Host-side inverse of :func:`pack_bits_u8` (numpy, C-speed)."""
    return np.unpackbits(
        np.asarray(packed, np.uint8), axis=-1, count=n, bitorder="little"
    )


def unpack_bits_u8_device(packed: jnp.ndarray, n: int) -> jnp.ndarray:
    """Device-side inverse of :func:`pack_bits_u8` for bit-packed inputs
    (hosts ship syndromes packed, 8x fewer H2D bytes)."""
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (packed[..., None] >> shifts) & jnp.uint8(1)
    return bits.reshape(packed.shape[:-1] + (-1,))[..., :n]


def batched_rank(dense: np.ndarray) -> int:
    """Host-side rank helper (order-invariant)."""
    from ldpc_tpu.mod2._gf2core import pack_rows, packed_row_reduce

    packed = pack_rows(np.asarray(dense, dtype=np.uint8))
    _, rank, _, _ = packed_row_reduce(packed, dense.shape[1])
    return rank
