"""Tests that need a GPU (marker ``chip``).

Run on a machine with one: ``python -m pytest tests/ -m chip --chip``
(``chip_smoke.py`` runs them too).  Elsewhere the ``gpu`` fixture skips
them.  What they pin is what only the card can show: that XLA's GPU
lowering of the decoder computes exactly what the CPU backend computes.
"""

import jax
import numpy as np
import pytest

from _lattice_util import device_link_set
from kaldi_decoder_tpu.decoders.frontier import config_for_graph
from kaldi_decoder_tpu.decoders.lattice import BatchedLatticeDecoder
from kaldi_decoder_tpu.fst import compile_fst, random_fst
from kaldi_decoder_tpu.ops.segment import score_lookup

pytestmark = pytest.mark.chip


def test_score_lookup_bitwise_on_gpu(gpu):
    """The acoustic lookup at bench width (56,832 lanes, V=500) returns
    the float32 scores bit for bit: no matmul precision in the way."""
    rng = np.random.default_rng(0)
    V, A = 500, 2560 * 3 + 49152
    scores = rng.uniform(-30.0, 0.0, size=V).astype(np.float32)
    idx = rng.integers(0, V, size=A).astype(np.int32)
    got = jax.jit(score_lookup)(
        jax.device_put(idx, gpu), jax.device_put(scores, gpu)
    )
    assert got.devices() == {gpu}
    np.testing.assert_array_equal(np.asarray(got), scores[idx])


@pytest.mark.parametrize("eps_prob", [0.0, 0.25])
def test_lattice_decoder_gpu_equals_cpu(gpu, eps_prob):
    """Batched lattice decode on the GPU and on the host CPU backend:
    identical words, pruned link sets and best-path costs."""
    rng = np.random.default_rng(7)
    V, B, T = 30, 3, 40
    graph = compile_fst(
        random_fst(num_states=400, num_symbols=V, rng=rng, eps_prob=eps_prob)
    )
    fc = config_for_graph(graph, beam=12.0, max_active=200, min_active=20)
    scores = np.log(
        rng.dirichlet(np.ones(V) * 0.3, size=(B, T)).astype(np.float32)
    ).astype(np.float32)
    lengths = np.array([T, T - 7, T - 19], np.int32)

    def run():
        dec = BatchedLatticeDecoder(graph, fc, lattice_beam=6.0, pad_time_to=8)
        return dec.decode(scores, lengths, chunk_frames=16)

    with jax.default_device(gpu):
        res_gpu = run()
    with jax.default_device(jax.devices("cpu")[0]):
        res_cpu = run()
    for b in range(B):
        assert res_gpu.best_path_labels(b) == res_cpu.best_path_labels(b)
        assert device_link_set(res_gpu, b) == device_link_set(res_cpu, b)
