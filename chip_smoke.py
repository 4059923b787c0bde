#!/usr/bin/env python
"""End-to-end check of the batched lattice decoder on a GPU.

Run from the repository root on a machine with an NVIDIA GPU:

    python chip_smoke.py             # one card: phases 0-3 below
    python chip_smoke.py --chips 4   # four cards: the multi-card checks only

Everything runs in ONE process: JAX reserves most of a card's memory when
it first touches it, so a second JAX process on the card would fail.

0. Environment: card name and power limit (nvidia-smi), JAX version and
   devices, native host library.  No GPU, or no native library, exits
   non-zero: the host finalize and the C++ comparisons need the library,
   and a silent pure-Python fallback would hide a broken install.
1. Main path at bench width (bench.py's HLG workload and decoder: B=16,
   T<=1000, beam 15, max_active 2560): ``decode_async(...).result()`` and
   ``best_path_labels`` for every utterance.  Prints set-up (compile)
   time, device-only and pipelined end-to-end audio-s/s, WER, truncation
   counts and peak device memory.  These are bring-up readings, not a
   benchmark.
2. Correctness against references (each tolerance states its reason):
   the same program on the host CPU backend, the C++ reference
   algorithmics, the API classes and the CLI.
3. The tests marked ``chip`` (tests/test_chip.py), in this process.

The last line of stdout is ``{"ok": true, "device": {...}}``; a failed
phase exits non-zero before it is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import itertools
import json
import pathlib
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

# Best-path costs are sums of the same float32 arc weights and acoustic
# scores along a path, accumulated in float64 on the host (lattice prune)
# and in double in the C++ decoders; equal paths agree to ~1e-9 relative.
# 1e-3 absolute admits only a different path that ties the best to 1e-3.
COST_TOL = 1e-3
# The posteriors are synthesized from the reference transcripts (peaked,
# aligned), so a working decoder scores a few per cent; a broken score
# lookup or pruning drives WER toward 100%.
MAX_WER = 0.10


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def say(msg: str) -> None:
    print(msg, flush=True)


def peak_bytes(device) -> int:
    return int(device.memory_stats()["peak_bytes_in_use"])


def best_cost(res, b: int) -> float:
    from kaldi_decoder_tpu.fst.ops import path_total_cost

    bp = res.best_path(b)
    return float("inf") if bp is None else float(path_total_cost(bp))


def flagged(res, b: int) -> bool:
    """True when utterance b hit a capacity limit (arc budget, records,
    frontier or sweep buffers): its lattice may then legitimately differ
    from an uncapped reference."""
    L = int(res.lengths[b])
    return bool(
        res.overflows[:L, b].any()
        or res.saturations[:L, b].any()
        or res.sweep_overflowed(b)
    )


# ---------------------------------------------------------------------------
# Phase 1: main path at bench width
# ---------------------------------------------------------------------------


def phase_main_path(dec, scores, lengths, refs, card: str):
    import jax

    import bench
    from kaldi_decoder_tpu.utils.wer import wer

    B = scores.shape[0]
    t0 = time.perf_counter()
    res = dec.decode_async(
        scores, lengths, chunk_frames=bench.CHUNK_FRAMES
    ).result()
    hyps = bench.finalize_batch(res)
    say(f"[1] compile + first batch (set-up): {time.perf_counter() - t0:.1f} s "
        f"(B={B}, T<={scores.shape[1]})")

    audio = bench.audio_seconds(lengths)
    times = bench.device_seconds(dec, scores, lengths)
    say(f"[1] device-only (forward scan, block_until_ready): "
        f"{audio / min(times):.2f} audio-s/s, passes {['%.3f' % t for t in times]} s "
        f"for {audio:.0f} audio-s | card: {card}")
    marks, hyps_pipe = bench.e2e_pipelined(dec, scores, lengths)
    say(f"[1] e2e pipelined (decode_async one ahead, host words fetched): "
        f"{bench.steady_rate(marks, lengths):.2f} audio-s/s steady, "
        f"batch-ready marks {['%.2f' % m for m in marks]} s | card: {card}")
    check(hyps_pipe == hyps, "pipelined batches give the first batch's words")

    st = wer(refs, hyps)
    say(f"[1] {st}")
    check(st.wer <= MAX_WER, f"WER {st.wer:.4f} <= {MAX_WER}")
    n_flag = sum(flagged(res, b) for b in range(B))
    say(f"[1] overflow frame-events {int(res.overflows.sum())}, saturated "
        f"frame-events {int(res.saturations.sum())}, sweep overflows "
        f"{sum(res.sweep_overflowed(b) for b in range(B))}, flagged "
        f"utterances {n_flag}/{B}")
    say(f"[1] peak_bytes_in_use: {peak_bytes(jax.devices()[0])}")
    check(all(len(h) > 0 for h in hyps), "every utterance decodes to words")
    return res, hyps


# ---------------------------------------------------------------------------
# Phase 2: correctness against references
# ---------------------------------------------------------------------------


def compare_results(got, want, utts, what: str) -> None:
    """Identical words and pruned link sets (which carry every link's
    costs, so the best-path costs agree too) for utterances ``utts`` of
    two LatticeResults."""
    from _lattice_util import device_link_set

    for b in utts:
        wg, ww = got.best_path_labels(b), want.best_path_labels(b)
        check(wg == ww, f"{what}: words of utterance {b}")
        lg, lw = device_link_set(got, b), device_link_set(want, b)
        check(lg == lw, f"{what}: link set of utterance {b} "
              f"({len(lg - lw)} extra, {len(lw - lg)} missing)")


def phase_gpu_vs_cpu(dec, make_decoder, scores, lengths, chunk_frames: int):
    """The same program on the host CPU backend, utterances 0-1, first
    chunk: the CPU backend needs minutes for two full-length utterances
    (~340 s on an H100 host), too long for this run.  The device's
    float32 link slack is compared with the host's float64 prune under a
    1e-3 margin (decoders/sweep.py), so a score lookup rounded to TF32
    would show here as missing links."""
    import jax

    n = 2
    sc = scores[:n, :chunk_frames]
    ln = np.minimum(lengths[:n], chunk_frames)
    t0 = time.perf_counter()
    with jax.default_device(jax.devices("cpu")[0]):
        res_cpu = make_decoder().decode(sc, ln, chunk_frames=chunk_frames)
    t_cpu = time.perf_counter() - t0
    res_gpu = dec.decode(sc, ln, chunk_frames=chunk_frames)
    compare_results(res_gpu, res_cpu, range(n), "GPU vs CPU backend")
    for b in range(n):
        cg, cc = best_cost(res_gpu, b), best_cost(res_cpu, b)
        check(abs(cg - cc) <= COST_TOL,
              f"GPU vs CPU backend: best-path cost of utterance {b} "
              f"({cg} vs {cc})")
    say(f"[2] GPU == CPU backend on utterances 0-{n - 1}, first "
        f"{chunk_frames}-frame chunk only (B={n}): words, link sets, "
        f"best-path cost within {COST_TOL} (CPU run {t_cpu:.0f} s incl. "
        f"compile)")


def phase_native(graph, res, scores, lengths, cfg: dict) -> None:
    """Best-path cost of every unflagged utterance against the C++
    LatticeSimple + max-active decoder (kd_decode_lattice)."""
    from kaldi_decoder_tpu import native

    B = scores.shape[0]
    worst, n_flag, flag_diffs = 0.0, 0, []
    for b in range(B):
        L = int(lengths[b])
        want, _ = native.decode_lattice(
            graph, scores[b, :L], prune_interval=25, **cfg
        )
        got = best_cost(res, b)
        if flagged(res, b):
            n_flag += 1
            flag_diffs.append(got - want)
            continue
        worst = max(worst, abs(got - want))
        check(abs(got - want) <= COST_TOL,
              f"C++ decode_lattice: best-path cost of utterance {b} "
              f"({got} vs {want})")
    say(f"[2] GPU == C++ decode_lattice best-path cost on {B - n_flag}/{B} "
        f"unflagged utterances (max |diff| {worst:.2e}, tol {COST_TOL}); "
        f"{n_flag} flagged, not compared (their GPU - C++ cost: "
        f"{['%.3f' % d for d in flag_diffs]})")


def phase_api(graph, scores, lengths, words0, cfg: dict) -> None:
    from kaldi_decoder_tpu import (
        DecodableCtc,
        FasterDecoder,
        FasterDecoderOptions,
        LatticeFasterDecoder,
        LatticeFasterDecoderConfig,
        native,
    )
    from kaldi_decoder_tpu.fst import path_labels
    from kaldi_decoder_tpu.fst.ops import path_total_cost

    L = int(lengths[0])
    logp = scores[0, :L]
    fd = FasterDecoder(graph, FasterDecoderOptions(
        beam=cfg["beam"], max_active=cfg["max_active"],
        min_active=cfg["min_active"],
    ))
    fd.decode(DecodableCtc(logp))
    ok, bp = fd.get_best_path()
    check(ok, "FasterDecoder found a path")
    got = path_total_cost(bp)
    want, _, _ = native.decode_faster(
        graph, logp, beam=cfg["beam"], max_active=cfg["max_active"],
        min_active=cfg["min_active"],
    )
    st = fd._result().stats(0)
    n_ovf, n_sat = st.arc_budget_overflows, st.frontier_saturated_frames
    if n_ovf or n_sat:
        say(f"[2] FasterDecoder on utterance 0 flagged ({n_ovf} overflow, "
            f"{n_sat} saturated frames), not compared: cost {got:.4f} vs "
            f"C++ decode_faster {want:.4f}")
    else:
        check(abs(got - want) <= COST_TOL,
              f"FasterDecoder vs C++ decode_faster cost ({got} vs {want})")
        say(f"[2] FasterDecoder == C++ decode_faster on utterance 0 "
            f"(cost {got:.4f} vs {want:.4f}, tol {COST_TOL})")

    ld = LatticeFasterDecoder(graph, LatticeFasterDecoderConfig(**cfg))
    ld.decode(DecodableCtc(logp))
    ok, bp = ld.get_best_path()
    check(ok, "LatticeFasterDecoder found a path")
    check(path_labels(bp) == words0,
          "LatticeFasterDecoder words equal the batched decoder's on utterance 0")
    say("[2] LatticeFasterDecoder words == batched decoder words on utterance 0")


def phase_cli(seed: int = 0) -> None:
    """CLI decode over the CTC topology H of V=500 tokens.  Every frame
    label sequence is a path of H, so the best path is the per-frame
    argmax and the hypothesis is its greedy CTC collapse — exactly."""
    from kaldi_decoder_tpu import cli
    from kaldi_decoder_tpu.fst import ctc_topo, write_fst

    V, T = 500, 300
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        write_fst(ctc_topo(V), tmp / "H.fst")
        paths, refs = [], []
        for u in range(2):
            ids = np.repeat(rng.integers(0, V, size=T // 3), 3)
            ids[rng.random(T) < 0.3] = 0  # blanks
            logits = rng.normal(size=(T, V)).astype(np.float32)
            logits[np.arange(T), ids] += 8.0
            m = logits - logits.max(axis=1, keepdims=True)
            logp = m - np.log(np.exp(m).sum(axis=1, keepdims=True))
            best = logp.argmax(axis=1)
            refs.append([int(k) for k, _ in itertools.groupby(best) if k != 0])
            paths.append(str(tmp / f"utt{u}.npy"))
            np.save(paths[-1], logp.astype(np.float32))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["decode", "--graph", str(tmp / "H.fst"),
                           "--logits", *paths])
    check(rc == 0, "CLI exit code 0")
    lines = [json.loads(x) for x in out.getvalue().splitlines() if x.strip()]
    hyps = [[int(t) for t in x["hyp"].split()] for x in lines]
    check(hyps == refs, "CLI hypotheses equal the greedy CTC collapse")
    say(f"[2] CLI on H (V={V}): {len(hyps)} hypotheses == greedy CTC collapse")


# ---------------------------------------------------------------------------
# Phase 3: chip tests
# ---------------------------------------------------------------------------


class _Outcomes:
    def __init__(self):
        self.counts: dict = {}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] = self.counts.get(report.outcome, 0) + 1


def phase_chip_tests() -> None:
    import pytest

    outcomes = _Outcomes()
    rc = pytest.main(
        ["-q", "-m", "chip", "--chip", "-p", "no:cacheprovider",
         str(REPO / "tests" / "test_chip.py")],
        plugins=[outcomes],
    )
    say(f"[3] chip tests: {outcomes.counts}")
    check(rc == 0 and outcomes.counts.get("passed", 0) > 0
          and not outcomes.counts.get("skipped")
          and not outcomes.counts.get("failed"),
          "every chip test passed")


# ---------------------------------------------------------------------------
# Four cards: data-parallel mesh and sharded-graph decoders
# ---------------------------------------------------------------------------


def compare_data_parallel(graph, scores, lengths, make_decoder, n_dev: int,
                          chunk_frames: int) -> None:
    """BatchedLatticeDecoder on a 1-D data mesh of n_dev cards against a
    single-card decode of the same utterances: identical words and link
    sets per utterance (the per-utterance program does not depend on
    where its batch row runs)."""
    import jax

    from kaldi_decoder_tpu.parallel import make_mesh

    devs = jax.devices()[:n_dev]
    res_m = make_decoder(mesh=make_mesh(n_dev)).decode(
        scores, lengths, chunk_frames=chunk_frames
    )
    say(f"[4] data mesh x{n_dev}, B={scores.shape[0]}: peak_bytes_in_use per "
        f"device {[peak_bytes(d) for d in devs]}")
    res_1 = make_decoder().decode(scores, lengths, chunk_frames=chunk_frames)
    compare_results(res_m, res_1, range(scores.shape[0]),
                    f"data mesh x{n_dev} vs one card")
    say(f"[4] data mesh x{n_dev} == one card on all {scores.shape[0]} "
        f"utterances: words and link sets")


def compare_sharded_graph(n_dev: int, num_words: int = 600) -> None:
    """ShardedViterbiDecoder and ShardedLatticeDecoder on an n_dev-way
    ``model`` mesh against the unsharded decoders on an HL graph, compared
    as tests/test_graph_shard.py compares them (words, best-path cost,
    exact link set)."""
    import jax
    from jax.sharding import Mesh

    from _lattice_util import device_link_set
    from kaldi_decoder_tpu.decoders import (
        BatchedLatticeDecoder,
        BatchedViterbiDecoder,
        config_for_graph,
    )
    from kaldi_decoder_tpu.fst import compile_fst, ctc_topo, path_labels
    from kaldi_decoder_tpu.fst.ops import compose, path_total_cost
    from kaldi_decoder_tpu.fst.topo import lexicon_fst
    from kaldi_decoder_tpu.parallel.graph_shard import (
        ShardedLatticeDecoder,
        ShardedViterbiDecoder,
    )

    rng = np.random.default_rng(0)
    V, T = 50, 30
    lex = [(1000 + w, rng.integers(1, V, size=int(rng.integers(3, 9))).tolist())
           for w in range(num_words)]
    Lfst = lexicon_fst(lex, word_weights=rng.uniform(0, 4, len(lex)).tolist())
    g = compile_fst(compose(ctc_topo(V), Lfst))
    ids = []
    while len(ids) < T:
        ids.extend(lex[int(rng.integers(len(lex)))][1])
        ids.append(0)
    logp = np.log(rng.dirichlet(np.ones(V) * 0.3, size=T))
    logp[np.arange(T), np.array(ids[:T])] += 3.2
    logp -= np.log(np.exp(logp).sum(1, keepdims=True))
    scores = logp.astype(np.float32)[None]
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("model",))
    kw = dict(beam=8.0, max_active=1500, min_active=100)

    cfg_plain = config_for_graph(g, frontier_size=4096, **kw)
    cfg_shard = config_for_graph(g, frontier_size=2048, **kw)
    vp = BatchedViterbiDecoder(g, cfg_plain, pad_time_to=T, fold=False)
    vs = ShardedViterbiDecoder(g, cfg_shard, mesh=mesh, pad_time_to=T)
    rp, rs = vp.decode(scores), vs.decode(scores)
    lp, ls = rp.best_path(0), rs.best_path(0)
    check(lp is not None and ls is not None, "sharded Viterbi found a path")
    check(path_labels(lp) == path_labels(ls), "sharded Viterbi words")
    check(abs(path_total_cost(lp) - path_total_cost(ls)) <= 1e-4,
          "sharded Viterbi best-path cost")

    lp_dec = BatchedLatticeDecoder(
        g, cfg_plain, lattice_beam=5.0, pad_time_to=T, fold=False,
        em_records=12288, eps_records=2048,
    )
    ls_dec = ShardedLatticeDecoder(
        g, cfg_shard, lattice_beam=5.0, mesh=mesh, pad_time_to=T,
        em_records=8192, eps_records=1024,
    )
    rp, rs = lp_dec.decode(scores), ls_dec.decode(scores)
    lp, ls = rp.best_path(0), rs.best_path(0)
    check(lp is not None and ls is not None, "sharded lattice found a path")
    check(path_labels(lp) == path_labels(ls), "sharded lattice words")
    check(device_link_set(rp, 0) == device_link_set(rs, 0),
          "sharded lattice link set")
    say(f"[4] sharded-graph Viterbi and lattice decoders on a {n_dev}-way "
        f"model mesh == unsharded ({g.num_states} states): words, cost, links")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the multi-card checks")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    say(f"[0] jax {jax.__version__}: platform {devs[0].platform}, "
        f"device_kind {devs[0].device_kind!r}, count {len(devs)}")
    if devs[0].platform != "gpu":
        raise SystemExit("FAILED: JAX found no GPU")
    check(len(devs) >= args.chips, f"{args.chips} cards present")

    import bench
    from kaldi_decoder_tpu import native
    from kaldi_decoder_tpu.utils.compile_cache import enable_compile_cache

    card = bench.card_line()
    say(f"[0] card (name, power limit): {card}")
    say(f"[0] native host library available: {native.available()}")
    check(native.available(), "native host library built and loaded")
    say(f"[0] compilation cache: {enable_compile_cache()}")

    chunk = bench.CHUNK_FRAMES
    if args.chips == 4:
        graph, scores, lengths, _ = bench.build_hlg_workload(batch=64)
        compare_data_parallel(
            graph, scores, lengths,
            lambda mesh=None: bench.make_decoder(graph, mesh=mesh), 4, chunk,
        )
        compare_sharded_graph(4)
    else:
        graph, scores, lengths, refs = bench.build_hlg_workload()
        say(f"[1] HLG: {graph.num_states} states, {graph.num_emitting_arcs} "
            f"emitting arcs, {graph.num_eps_arcs} eps arcs")
        dec = bench.make_decoder(graph)
        res, hyps = phase_main_path(dec, scores, lengths, refs, card)
        phase_gpu_vs_cpu(dec, lambda: bench.make_decoder(graph), scores,
                         lengths, chunk)
        cfg = dict(beam=bench.BEAM, max_active=bench.MAX_ACTIVE,
                   min_active=200, lattice_beam=bench.LATTICE_BEAM)
        phase_native(graph, res, scores, lengths, cfg)
        phase_api(graph, scores, lengths, hyps[0], cfg)
        phase_cli()
        phase_chip_tests()

    say(f"card (name, power limit): {card}")
    print(json.dumps({"ok": True, "device": bench.device_info()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
