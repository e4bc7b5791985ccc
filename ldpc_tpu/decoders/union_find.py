"""UnionFindDecoder: standalone union-find decoding (no BP stage).

API parity with the reference
(reference: src_python/ldpc/union_find_decoder/_union_find_decoder.pyx):
``uf_method`` truthy selects matrix-inversion mode, falsy selects peeling
(_union_find_decoder.pyx:64,145-157); ``decode(syndrome, llrs=None,
bits_per_step=0)`` optionally guides growth with soft information.
"""

from typing import Optional, Union

import numpy as np
import scipy.sparse

import jax.numpy as jnp

from ldpc_tpu.helpers import convert_to_binary_sparse
from ldpc_tpu.ops import uf as uf_ops
from ldpc_tpu.ops.pcm import compile_pcm


class UnionFindDecoder:
    """Union-find decoder (union_find.hpp; arXiv:1709.06218).

    ``uf_method=True`` -> matrix (inversion) mode, works on any PCM;
    ``uf_method=False`` (default) -> peeling mode, requires column
    degree <= 2 (point-like syndromes).
    """

    def __init__(self, pcm, uf_method: Union[bool, str] = False):
        if not isinstance(pcm, (np.ndarray, scipy.sparse.spmatrix)):
            raise TypeError(
                "The input matrix is of an invalid type. Please input "
                f"a np.ndarray or spmatrix object, not {type(pcm)}"
            )
        self._pcm = convert_to_binary_sparse(pcm)
        self.m, self.n = self._pcm.shape
        col_deg = np.asarray((self._pcm != 0).sum(axis=0)).ravel()
        if (col_deg == 0).any():
            raise ValueError(
                "Invalid parity check matrix. Column weight is zero."
            )
        self.uf_method = bool(uf_method)
        if not self.uf_method and col_deg.max() > 2:
            raise ValueError(
                "Peel decoder only works for planar codes. Use the "
                "matrix_decode method for more general codes."
            )
        self._graph = compile_pcm(self._pcm)
        self._cache = {}
        self._decoding = np.zeros(self.n, dtype=np.uint8)

    def _fn(self, bits_per_step: int, guided: bool):
        key = (self.uf_method, bits_per_step, guided)
        fn = self._cache.get(key)
        if fn is None:
            maker = uf_ops.make_uf_decoder if self.uf_method else uf_ops.make_peel_decoder
            fn = maker(self._graph, bits_per_step=bits_per_step if guided else 0)
            self._cache[key] = fn
        return fn

    def _packed_fn(self, bits_per_step: int, guided: bool, sparse_plan=None):
        """One-dispatch program: bit-packed syndromes in, ONE packed
        uint8 buffer (decodings + validity bits) out; the unguided path
        synthesizes its zero LLRs on device instead of uploading a
        (B, n) float block. ``sparse_plan`` switches the decodings to
        the segmented index-coded export (see
        decoders.base._sparse_export_plan)."""
        key = ("packed", self.uf_method, bits_per_step, guided, sparse_plan)
        fn = self._cache.get(key)
        if fn is None:
            import jax

            from ldpc_tpu.ops import gf2

            maker = (
                uf_ops.make_uf_decoder
                if self.uf_method
                else uf_ops.make_peel_decoder
            )
            inner = maker(
                self._graph, bits_per_step=bits_per_step if guided else 0
            )
            m, n = self.m, self.n

            def program(syn_packed, llrs):
                syn = gf2.unpack_bits_u8_device(syn_packed, m)
                if llrs is None:
                    llrs = jnp.zeros((syn.shape[0], n), jnp.float32)
                elif llrs.ndim == 1:
                    # shared channel llrs: broadcast on device instead of
                    # uploading a (B, n) float block
                    llrs = jnp.broadcast_to(llrs, (syn.shape[0], n))
                dec, valid = inner(syn, llrs)
                nonzero = syn.any(axis=1)
                dec = dec * nonzero[:, None].astype(dec.dtype)
                valid = valid | ~nonzero
                if sparse_plan is not None:
                    from ldpc_tpu.decoders import base as _base

                    S, Ks = sparse_plan
                    L = _base._SEG_L
                    flat = dec.reshape(-1)
                    xp = jnp.pad(
                        flat, (0, S * L - flat.shape[0])
                    ).reshape(S, L)
                    mask = xp != 0
                    keys = jnp.where(
                        mask, jnp.arange(L, dtype=jnp.int32)[None, :], L
                    )
                    sk = jax.lax.sort(keys, dimension=1)[:, :Ks]
                    cnts = jnp.minimum(mask.sum(axis=1), 255).astype(
                        jnp.uint8
                    )
                    head = jnp.concatenate(
                        [
                            jnp.minimum(sk, 255)
                            .astype(jnp.uint8)
                            .reshape(-1),
                            cnts,
                        ]
                    )
                else:
                    head = gf2.pack_bits_u8(dec).reshape(-1)
                return jnp.concatenate(
                    [
                        head,
                        gf2.pack_bits_u8(
                            valid[None, :].astype(jnp.uint8)
                        )[0],
                    ]
                )

            if guided:
                fn = jax.jit(program)
            else:
                prog = jax.jit(lambda sp: program(sp, None))
                fn = lambda sp, llrs: prog(sp)
            self._cache[key] = fn
        return fn

    def decode(
        self,
        syndrome: np.ndarray,
        llrs: Optional[np.ndarray] = None,
        bits_per_step: int = 0,
    ) -> np.ndarray:
        syndrome = np.asarray(syndrome)
        if not len(syndrome) == self.m:
            raise ValueError(
                f"The syndrome must have length {self.m}. Not {len(syndrome)}."
            )
        if llrs is not None and not len(llrs) == self.n:
            raise ValueError(
                f"The llrs must have length {self.n}. Not {len(llrs)}."
            )
        out = self.decode_batch(
            syndrome[None, :].astype(np.uint8),
            None if llrs is None else np.asarray(llrs)[None, :],
            bits_per_step,
        )[0]
        return out.astype(syndrome.dtype)

    def decode_batch(
        self,
        syndromes: np.ndarray,
        llrs: Optional[np.ndarray] = None,
        bits_per_step: int = 0,
    ) -> np.ndarray:
        syndromes = np.atleast_2d(np.asarray(syndromes, dtype=np.uint8))
        B0 = syndromes.shape[0]
        guided = llrs is not None
        shared_llr = None
        if guided:
            llrs = np.asarray(llrs, dtype=np.float32)
            if llrs.ndim == 1:  # one channel-llr vector for every row
                shared_llr = jnp.asarray(llrs)
            else:
                llrs = np.atleast_2d(llrs)
        # chunked single-pull pipeline: each chunk's H2D/compute/D2H
        # overlaps its neighbours' via async dispatch, everything
        # bit-packed both ways
        packed_all = np.packbits(syndromes, axis=1, bitorder="little")
        CH = 8192
        Wb = -(-self.n // 8)
        from ldpc_tpu.decoders import base as _base

        # no channel here: bound the expected decoding weight by the mean
        # syndrome weight (UF corrections are matching-like, weight <~
        # defects; overflow redispatches dense, so this is only a hint)
        wbar_est = max(2.0, float(syndromes.sum()) / max(B0, 1))
        launches = []
        for st in range(0, B0, CH) or [0]:
            chunk = packed_all[st : st + CH]
            Bc = chunk.shape[0]
            Bpad = (
                -(-Bc // 512) * 512
                if Bc >= 512
                else max(128, -(-Bc // 128) * 128)
            )
            if Bpad != Bc:
                chunk = np.concatenate(
                    [chunk, np.zeros((Bpad - Bc, chunk.shape[1]), np.uint8)]
                )
            llr_c = None
            if guided:
                if shared_llr is not None:
                    llr_c = shared_llr
                else:
                    llr_c = llrs[st : st + Bc]
                    if Bpad != Bc:
                        llr_c = np.concatenate(
                            [llr_c, np.zeros((Bpad - Bc, self.n), np.float32)]
                        )
                    llr_c = jnp.asarray(llr_c)
            plan = _base._plan_unless_disabled(self, Bpad, Wb, wbar_est)
            dev = jnp.asarray(chunk)
            buf = self._packed_fn(bits_per_step, guided, plan)(dev, llr_c)
            if hasattr(buf, "copy_to_host_async"):
                buf.copy_to_host_async()
            launches.append((st, Bc, Bpad, plan, dev, llr_c, buf))

        dec = np.empty((B0, self.n), np.uint8)
        valid = np.empty(B0, bool)
        for st, Bc, Bpad, plan, dev, llr_c, buf in launches:
            buf_np = np.asarray(buf)
            o1 = plan[0] * (plan[1] + 1) if plan else Bpad * Wb
            seg_over = bool(
                plan and buf_np[plan[0] * plan[1] : o1].max() > plan[1]
            )
            if seg_over:  # overflow: redo the chunk with the dense layout
                self._seg_plan_off = True  # see base._plan_unless_disabled
                plan = None
                fn = self._packed_fn(bits_per_step, guided, None)
                buf_np = np.asarray(fn(dev, llr_c))
                o1 = Bpad * Wb
            if plan:
                dec[st : st + Bc] = _base._reconstruct_segments(
                    buf_np, plan, Bpad, self.n
                )[:Bc]
            else:
                dec[st : st + Bc] = np.unpackbits(
                    buf_np[:o1].reshape(Bpad, Wb)[:Bc],
                    axis=1,
                    count=self.n,
                    bitorder="little",
                )
            valid[st : st + Bc] = np.unpackbits(
                buf_np[o1 : o1 + Bpad // 8],
                count=Bc,
                bitorder="little",
            ).astype(bool)
        self.valid_batch = valid
        self._decoding = dec[0]
        return dec

    @property
    def decoding(self) -> np.ndarray:
        return np.asarray(self._decoding).astype(np.uint8)
