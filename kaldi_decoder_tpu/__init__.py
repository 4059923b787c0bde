"""kaldi_decoder_tpu: a batched WFST decoding framework for accelerators.

A from-scratch reimplementation of the capabilities of
`k2-fsa/kaldi-decoder` in JAX/XLA: decoding graphs
are flattened to device-resident CSR arc tables, and token-passing beam
search runs as frame-synchronous fixed-shape array programs under ``jit``,
batched over utterances and shardable over device meshes.

Public API mirrors the reference package's exports
(`kaldi-decoder/python/kaldi_decoder/__init__.py:1-9`) plus the
batched device decoders.
"""

__version__ = "0.1.0"

from kaldi_decoder_tpu.decodable import (
    DecodableCtc,
    DecodableInterface,
    DecodableMatrix,
)
from kaldi_decoder_tpu.decoders import (
    BatchedLatticeDecoder,
    BatchedViterbiDecoder,
    FasterDecoder,
    FasterDecoderOptions,
    FrontierConfig,
    LatticeFasterDecoder,
    LatticeFasterDecoderConfig,
    LatticeSimpleDecoder,
    LatticeSimpleDecoderConfig,
    SimpleDecoder,
)

__all__ = [
    "DecodableCtc",
    "DecodableInterface",
    "DecodableMatrix",
    "BatchedLatticeDecoder",
    "BatchedViterbiDecoder",
    "FasterDecoder",
    "FasterDecoderOptions",
    "FrontierConfig",
    "LatticeFasterDecoder",
    "LatticeFasterDecoderConfig",
    "LatticeSimpleDecoder",
    "LatticeSimpleDecoderConfig",
    "SimpleDecoder",
    "__version__",
]
