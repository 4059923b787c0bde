"""Fixed-shape primitives of kaldi_decoder_tpu/ops/segment.py."""

import jax
import numpy as np

from kaldi_decoder_tpu.ops.segment import score_lookup


def test_score_lookup_is_exact_gather_at_bench_width():
    """56,832 lanes (2560 frontier lanes x block width 3 + 49,152
    remainder lanes) over V=500: bit-identical to a numpy gather."""
    rng = np.random.default_rng(0)
    V, A = 500, 2560 * 3 + 49152
    scores = rng.uniform(-30.0, 0.0, size=V).astype(np.float32)
    idx = rng.integers(0, V, size=A).astype(np.int32)
    got = np.asarray(jax.jit(score_lookup)(idx, scores))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, scores[idx])
