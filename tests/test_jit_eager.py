"""jit-vs-eager equivalence (SURVEY §5 sanitizers row).

The decoders' correctness story rests on jit tracing being semantics-
preserving; this pins it explicitly: one full lattice frame step produces
bit-identical frontiers/records under ``jax.disable_jit`` and under the
compiled path (the device analogue of running a sanitizer build —
`scripts/check_style_cpplint.sh` is the reference's only gate; we can do
better because the program is pure).
"""

import jax
import numpy as np
import pytest

from kaldi_decoder_tpu.decoders import BatchedLatticeDecoder
from kaldi_decoder_tpu.decoders.frontier import config_for_graph
from kaldi_decoder_tpu.fst import compile_fst, random_fst


@pytest.mark.parametrize("fold", [True, False])
def test_jit_and_eager_decodes_agree(fold):
    rng = np.random.default_rng(0)
    V, T = 6, 6
    g = compile_fst(random_fst(30, V, rng, eps_prob=0.3))
    scores = np.log(rng.dirichlet(np.ones(V), size=(1, T))).astype(np.float32)
    fc = config_for_graph(g, beam=12.0, min_active=0, frontier_size=32)

    def run():
        dec = BatchedLatticeDecoder(
            g, fc, lattice_beam=6.0, em_records=256, eps_records=64,
            pad_time_to=8, fold=fold,
        )
        return dec.decode(scores, device_prune=False)

    r_jit = run()
    with jax.disable_jit():
        r_eager = run()
    np.testing.assert_array_equal(r_jit.frame_states, r_eager.frame_states)
    np.testing.assert_allclose(
        r_jit.frame_costs, r_eager.frame_costs, rtol=0, atol=0
    )
    np.testing.assert_array_equal(r_jit.em_records, r_eager.em_records)
    np.testing.assert_array_equal(r_jit.eps_records, r_eager.eps_records)
    np.testing.assert_array_equal(r_jit.num_active, r_eager.num_active)
