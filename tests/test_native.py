"""Differential tests: native C++ host runtime vs the pure-Python layer.

Pattern follows the reference's hash-list-test.cc (property-test a native
data structure against a trivially-correct oracle,
`kaldi-decoder/csrc/hash-list-test.cc:21-101`): every native entry point
is compared against the Python implementation it accelerates on random
inputs.
"""

import os

import numpy as np
import pytest

from kaldi_decoder_tpu import native
from kaldi_decoder_tpu.fst import (
    Lattice,
    compile_fst,
    fst_to_text,
    load_graph,
    path_labels,
    path_total_cost,
    random_fst,
    read_fst,
    shortest_path,
    write_fst,
)
from kaldi_decoder_tpu.fst.io import _read_fst_body

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)


def _random_graphs(n=6):
    for seed in range(n):
        rng = np.random.default_rng(seed)
        yield random_fst(
            num_states=int(rng.integers(2, 300)),
            num_symbols=int(rng.integers(1, 40)),
            rng=rng,
            eps_prob=float(rng.uniform(0, 0.4)),
        )


def test_binary_read_matches_python(tmp_path):
    for i, fst in enumerate(_random_graphs()):
        path = tmp_path / f"g{i}.fst"
        write_fst(fst, path)
        got = read_fst(str(path))  # native path
        with open(path, "rb") as f:
            want = _read_fst_body(f)  # pure python
        assert got == want


def test_binary_read_lattice(tmp_path):
    lat = Lattice()
    s0, s1, s2 = lat.add_state(), lat.add_state(), lat.add_state()
    lat.set_start(s0)
    lat.add_arc(s0, 3, 7, (0.5, 1.25), s1)
    lat.add_arc(s1, 0, 0, (0.0, 0.0), s2)
    lat.set_final(s2, (2.0, 0.5))
    path = tmp_path / "l.fst"
    write_fst(lat, path)
    got = read_fst(str(path))
    assert got == lat


def test_csr_compile_matches_python(tmp_path):
    for i, fst in enumerate(_random_graphs()):
        path = tmp_path / f"g{i}.fst"
        write_fst(fst, path)
        g_native = load_graph(str(path))
        g_py = compile_fst(fst)
        for name in g_py.arrays._fields:
            assert np.array_equal(
                getattr(g_native.arrays, name), getattr(g_py.arrays, name)
            ), name
        assert g_native.num_states == g_py.num_states
        assert g_native.num_emitting_arcs == g_py.num_emitting_arcs
        assert g_native.num_eps_arcs == g_py.num_eps_arcs
        assert g_native.start_state == g_py.start_state
        assert g_native.eps_depth == g_py.eps_depth
        assert g_native.max_em_out_degree == g_py.max_em_out_degree
        assert g_native.max_eps_out_degree == g_py.max_eps_out_degree
        assert g_native.max_score_idx == g_py.max_score_idx


def test_text_parse_matches_python():
    from kaldi_decoder_tpu.fst.io import fst_from_text

    for fst in _random_graphs(4):
        text = fst_to_text(fst)
        arr = native.parse_fst_text_arrays(text, 1)
        want = fst_from_text(text).to_arrays()
        # fst_from_text loses trailing stateless states only if never
        # mentioned; random_fst mentions every state.
        assert np.array_equal(arr["row_ptr"], want["row_ptr"])
        assert np.array_equal(arr["ilabel"], want["ilabel"])
        assert np.array_equal(arr["olabel"], want["olabel"])
        assert np.array_equal(arr["nextstate"], want["nextstate"])
        assert np.allclose(arr["weight"], want["weight"])
        assert np.allclose(arr["final"], want["final"])
        assert arr["start"] == want["start"]


def test_shortest_path_matches_python():
    # Random DAG lattices (the decoder only produces acyclic lattices).
    for seed in range(8):
        rng = np.random.default_rng(100 + seed)
        S = int(rng.integers(3, 60))
        lat = Lattice()
        lat.add_states(S)
        lat.set_start(0)
        for s in range(S - 1):
            for _ in range(int(rng.integers(1, 4))):
                d = int(rng.integers(s + 1, S))
                lat.add_arc(
                    s,
                    int(rng.integers(0, 5)),
                    int(rng.integers(0, 5)),
                    (float(rng.uniform(0, 3)), float(rng.uniform(0, 3))),
                    d,
                )
        lat.set_final(S - 1, (0.0, 0.0))
        if rng.random() < 0.5:
            lat.set_final(int(rng.integers(1, S)), (1.0, 0.0))

        got = shortest_path(lat)  # native fast path
        os.environ["KDTPU_NATIVE"] = "1"
        # Force pure python by calling the DP directly on a copy with the
        # native module reporting unavailable.
        import kaldi_decoder_tpu.native as nat

        saved = nat.available
        nat.available = lambda: False
        try:
            want = shortest_path(lat)
        finally:
            nat.available = saved
        assert path_total_cost(got) == pytest.approx(
            path_total_cost(want), abs=1e-4
        )
        assert path_labels(got) == path_labels(want) or path_total_cost(
            got
        ) == pytest.approx(path_total_cost(want), abs=1e-4)


def test_shortest_path_no_path():
    lat = Lattice()
    s0, s1 = lat.add_state(), lat.add_state()
    lat.set_start(s0)
    lat.add_arc(s0, 1, 1, (1.0, 0.0), s1)
    # no final state
    out = shortest_path(lat)
    assert out.num_states == 0


def test_backtrace_matches_python():
    import kaldi_decoder_tpu.native as nat
    from kaldi_decoder_tpu.decoders.viterbi import BatchedViterbiDecoder

    rng = np.random.default_rng(7)
    fst = random_fst(num_states=60, num_symbols=10, rng=rng, eps_prob=0.25)
    graph = compile_fst(fst)
    dec = BatchedViterbiDecoder(graph, pad_time_to=8)
    scores = np.log(
        rng.dirichlet(np.ones(10), size=(3, 17)).astype(np.float32)
    ).astype(np.float32)
    res = dec.decode(scores)
    for b in range(3):
        lat_native = res.best_path(b)
        saved = nat.available
        nat.available = lambda: False
        try:
            lat_py = res.best_path(b)
        finally:
            nat.available = saved
        if lat_py is None:
            assert lat_native is None
        else:
            assert lat_native == lat_py


def test_get_cutoff_pins_cpp():
    """C++ GetCutoff (kd_get_cutoff) == device decision table
    (ops/cutoff.py) on random frontiers — exact reference semantics on
    both sides (faster-decoder.cc:244-336), including the
    (min_active+1)-th order statistic (`faster-decoder.cc:315-321`)."""
    import jax.numpy as jnp

    from kaldi_decoder_tpu.ops.cutoff import get_cutoff

    rng = np.random.default_rng(11)
    for _ in range(60):
        K = int(rng.choice([64, 256]))
        n = int(rng.integers(1, K + 1))
        costs = rng.uniform(0.0, 30.0, n).astype(np.float32)
        beam = float(rng.uniform(0.5, 20.0))
        max_active = int(
            rng.choice([2, max(2, n // 3), max(2, n - 1), n + 4, 2**31 - 1])
        )
        min_active = int(rng.integers(0, min(max_active, n + 2)))
        beam_delta = float(rng.uniform(0.1, 1.0))

        c_cut, c_ab = native.get_cutoff(
            costs, beam, max_active, min_active, beam_delta
        )
        padded = np.full(K, np.inf, np.float32)
        padded[:n] = costs
        d = get_cutoff(
            jnp.asarray(padded), beam, max_active, min_active, beam_delta
        )
        assert float(d.cutoff) == pytest.approx(c_cut, rel=1e-5, abs=1e-4)
        assert float(d.adaptive_beam) == pytest.approx(
            c_ab, rel=1e-5, abs=1e-4
        )
        assert int(d.count) == n


def test_best_path_labels_matches_fst_path():
    """The array fast path (flat_arc_arrays + native ShortestPath) yields
    the same 1-best labels as ShortestPath(GetRawLattice) through the
    Python FST object (`lattice-simple-decoder.cc:574-580`)."""
    from kaldi_decoder_tpu.decoders.lattice import BatchedLatticeDecoder

    rng = np.random.default_rng(3)
    fst = random_fst(num_states=80, num_symbols=12, rng=rng, eps_prob=0.2)
    graph = compile_fst(fst)
    dec = BatchedLatticeDecoder(graph, lattice_beam=6.0, pad_time_to=8)
    scores = np.log(
        rng.dirichlet(np.ones(12), size=(3, 21)).astype(np.float32)
    ).astype(np.float32)
    res = dec.decode(scores)
    for b in range(3):
        p = res.best_path(b)
        want = path_labels(p) if p is not None else None
        got = res.best_path_labels(b)
        assert got == want, (b, got, want)


def test_library_keyed_by_source_hash(tmp_path):
    """A library built from other source is never loaded in its place: a
    changed source gets a new library, an unchanged one reuses it."""
    src = tmp_path / "kdtpu_host.cc"
    with open(native._SRC) as f:
        src.write_text(f.read())
    lib_dir = str(tmp_path / "lib")
    first = native._build(str(src), lib_dir)
    assert first is not None and os.path.exists(first)
    mtime = os.path.getmtime(first)
    assert native._build(str(src), lib_dir) == first
    assert os.path.getmtime(first) == mtime
    src.write_text(src.read_text() + "\n// changed\n")
    second = native._build(str(src), lib_dir)
    assert second is not None and second != first
    assert os.path.exists(second)
