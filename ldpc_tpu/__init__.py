"""ldpc_tpu — a batched JAX framework for decoding classical and quantum LDPC codes.

A ground-up JAX/XLA re-design with the capabilities of the reference
``ldpc`` package (quantumgizmos/ldpc v2.4.1): belief-propagation decoders
(product-sum / min-sum; parallel, serial, serial-relative schedules), OSD,
LSD, union-find/BeliefFind, flip/p-flip and MBP post-processing, GF(2)
linear algebra, code constructions, Monte-Carlo simulation harnesses and
circuit-level (DEM / overlapping-window) decoding.

Design notes (batched, not a port):
- decoding is *batched*: thousands of syndromes decode simultaneously;
  the syndrome batch is the data-parallel axis sharded over a device mesh.
- BP message passing keeps messages in a check-major padded edge layout
  ``(E, batch)``; each iteration is row gathers plus dense reductions over
  the small check and variable degrees.
- GF(2) fallbacks (OSD/LSD/UF solves) run device-side on the compacted
  failed-syndrome subset.
"""

__version__ = "0.1.0"

from ldpc_tpu import codes, helpers, mod2  # noqa: F401

_LAZY_SUBMODULES = (
    "alist",
    "bp_decode_sim",
    "ckt_noise",
    "code_util",
    "monte_carlo_simulation",
    "noise_models",
    "parallel",
    "protograph",
    "sinter_decoders",
)

_DECODER_EXPORTS = {
    "BpDecoder": "ldpc_tpu.decoders.bp_decoder",
    "SoftInfoBpDecoder": "ldpc_tpu.decoders.bp_decoder",
    "BpOsdDecoder": "ldpc_tpu.decoders.bposd_decoder",
    "SoftInfoBpOsdDecoder": "ldpc_tpu.decoders.bposd_decoder",
    "SinterBpOsdDecoder": "ldpc_tpu.sinter_decoders",
    "BpLsdDecoder": "ldpc_tpu.decoders.bplsd_decoder",
    "BeliefFindDecoder": "ldpc_tpu.decoders.belief_find",
    "UnionFindDecoder": "ldpc_tpu.decoders.union_find",
    "LsdDecoder": "ldpc_tpu.decoders.lsd_decoder",
    "BpFlipDecoder": "ldpc_tpu.decoders.bp_flip",
    "FlipDecoder": "ldpc_tpu.decoders.bp_flip",
    "MbpDecoder": "ldpc_tpu.decoders.mbp_decoder",
    "mbp_decoder": "ldpc_tpu.decoders.mbp_decoder",
    # ldpc v1 compatibility shims
    "bp_decoder": "ldpc_tpu._legacy_v1",
    "bposd_decoder": "ldpc_tpu._legacy_v1",
}


def __getattr__(name):
    """Lazy decoder/submodule imports (keeps `import ldpc_tpu` light and
    cycle-free)."""
    import importlib

    if name in _DECODER_EXPORTS:
        module = importlib.import_module(_DECODER_EXPORTS[name])
        return getattr(module, name)
    if name in _LAZY_SUBMODULES:
        return importlib.import_module(f"ldpc_tpu.{name}")
    raise AttributeError(f"module 'ldpc_tpu' has no attribute '{name}'")


__all__ = (
    ["codes", "helpers", "mod2", "__version__"]
    + list(_DECODER_EXPORTS)
    + list(_LAZY_SUBMODULES)
)
