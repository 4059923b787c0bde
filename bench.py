#!/usr/bin/env python
"""Benchmark: native-HLG lattice decode throughput (+WER) on the local GPU.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "audio_seconds_per_second_per_chip",
   "vs_baseline": N, "e2e_with_lattices": N, "device": {...}}

Workload (BASELINE.json config #3): batched lattice decoding of
conformer-CTC-like posteriors (V=500, 25 frames/s) through a **real-structure
native HLG** — ``connect(ctc_topo(500) ∘ L(5000 words) ∘ bigram G)``,
>=100k states / ~4M arcs with genuine backoff epsilons and word olabels
(`kaldi_decoder_tpu/fst/hlg.py`) — with beam=15, max_active=2560, lattice
records emitted per frame: the full LatticeFasterDecoder capability.
Posteriors are CTC-aligned to known transcripts so the run also reports a
WER (the north star's accuracy metric).  Set KDTPU_BENCH_GRAPH=synthetic
for a random HLG-shaped graph instead.

vs_baseline: ratio against a single-threaded C++ decoder with the
reference's lattice algorithmics (native/csrc/kdtpu_host.cc
kd_decode_lattice), measured on the same graph/scores here, since the
reference publishes no numbers and its wheel cannot be built offline.

A run without a GPU exits non-zero before decoding anything: a CPU number
is never reported under a device metric.  Stage timings (graph load,
compile + first batch, steady-state passes, host lattice finalization) go
to stderr.
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

SEED = 0
V = 500
B = int(os.environ.get("KDTPU_BENCH_B", "16"))
T = int(os.environ.get("KDTPU_BENCH_T", "1000"))
# 500-frame chunks: the windowed sweep keeps ~a frontier's worth of
# conservatively-alive rows per chunk BOUNDARY, so fewer, longer chunks
# download fewer survivor rows per batch at identical output (chunk
# boundaries are lattice-exact, tests/test_sweep.py).
CHUNK_FRAMES = int(os.environ.get("KDTPU_BENCH_CHUNK", "500"))
FRAME_SECONDS = 0.04  # conformer subsampling-4 frame rate
BEAM = float(os.environ.get("KDTPU_BENCH_BEAM", "15"))
# The default is the *recall-qualified operating point*: lattice-link
# recall vs the exact same-config oracle is >= 0.95
# (scripts/measure_recall.py --save; carried in the metric string below).
# max_active trades accuracy for expansion demand exactly as in Kaldi: the
# tighter cutoff cuts expansion lanes AND truncation pressure.
MAX_ACTIVE = int(os.environ.get("KDTPU_BENCH_MAXACTIVE", "2560"))
LATTICE_BEAM = 8.0
EM_RECORDS = int(os.environ.get("KDTPU_BENCH_EM_RECORDS", "8192"))
REM_BUDGET = int(os.environ.get("KDTPU_BENCH_REM", "49152"))
EPS_REM_BUDGET = int(os.environ.get("KDTPU_BENCH_EPS_REM", "2048"))
FRONTIER = int(os.environ.get("KDTPU_BENCH_FRONTIER", "4096"))
# Remainder packing G: G=8 halves the remainder row-gather count of G=4
# at identical results (lane count and semantics are G-independent).
FLAT_GROUP = int(os.environ.get("KDTPU_BENCH_FLAT_GROUP", "8"))
BLOCK_W = os.environ.get("KDTPU_BENCH_W")  # block width override
GRAPH_KIND = os.environ.get("KDTPU_BENCH_GRAPH", "hlg")
CACHE_DIR = REPO / ".bench_cache"

# Native HLG build parameters (deterministic from SEED).
HLG_WORDS = 5000
HLG_SENTS_SHORT, HLG_LEN_SHORT = 2500, 12.0
HLG_SENTS_LONG, HLG_LEN_LONG = 400, 75.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _stage(msg, t0=[time.time()]):
    log(f"[{time.time() - t0[0]:7.1f}s] {msg}")


def build_hlg_workload(batch: int = B):
    """Native >=100k-state HLG + aligned posteriors for ``batch`` known
    transcripts.

    The compiled graph is cached under .bench_cache (deterministic build
    takes ~100s of pure-host compose; the cache keeps cold runs about the
    decode, not graph compilation)."""
    from kaldi_decoder_tpu.fst.csr import load_graph_npz, save_graph_npz
    from kaldi_decoder_tpu.fst.hlg import (
        build_hlg,
        random_lexicon,
        sample_corpus,
        synth_posteriors,
        words_to_tokens,
    )

    CACHE_DIR.mkdir(exist_ok=True)
    gpath = CACHE_DIR / f"hlg_v{V}_w{HLG_WORDS}_s{SEED}.npz"
    rng = np.random.default_rng(SEED)
    lex = random_lexicon(HLG_WORDS, V, rng, 3, 8)
    corpus = sample_corpus(HLG_WORDS, HLG_SENTS_SHORT, rng, mean_len=HLG_LEN_SHORT)
    corpus += sample_corpus(HLG_WORDS, HLG_SENTS_LONG, rng, mean_len=HLG_LEN_LONG)
    if gpath.exists():
        graph = load_graph_npz(gpath)
        _stage(f"HLG loaded from cache ({graph.num_states} states, "
               f"{graph.num_emitting_arcs} em arcs)")
    else:
        hlg = build_hlg(lex, corpus, V)
        from kaldi_decoder_tpu.fst.csr import compile_fst

        graph = compile_fst(hlg)
        save_graph_npz(graph, gpath)
        _stage(f"HLG built natively ({graph.num_states} states, "
               f"{graph.num_emitting_arcs} em arcs, eps={graph.num_eps_arcs})")
    assert graph.num_states >= 100_000

    # Transcripts: long corpus sentences, trimmed to fill ~T frames.
    rng2 = np.random.default_rng(SEED + 1)
    pron = dict(lex)
    longs = [s for s in corpus if len(s) >= 40]
    scores = np.full((batch, T, V), np.log(1.0 / V), np.float32)
    lengths = np.zeros(batch, np.int32)
    refs = []
    for b in range(batch):
        words = list(longs[int(rng2.integers(len(longs)))])
        sc = None
        while True:
            toks = words_to_tokens(words, pron)
            sc = synth_posteriors(toks, V, np.random.default_rng(SEED + 10 + b))
            if sc.shape[0] <= T or len(words) <= 1:
                break
            words = words[: max(1, int(len(words) * 0.9))]
        refs.append(words)
        L = min(sc.shape[0], T)
        scores[b, :L] = sc[:L]
        lengths[b] = L
    return graph, scores, lengths, refs


def build_synthetic_workload():
    from kaldi_decoder_tpu.fst.synthetic import synthetic_graph

    graph = synthetic_graph(200_000, 1_000_000, V, seed=SEED, eps_arcs=100_000)
    rng = np.random.default_rng(SEED)
    scores = np.log(
        rng.dirichlet(np.ones(V), size=(B, T)).astype(np.float32)
    ).astype(np.float32)
    lengths = np.full(B, T, np.int32)
    return graph, scores, lengths, None


def make_decoder(graph, mesh=None):
    from kaldi_decoder_tpu.decoders.frontier import config_for_graph
    from kaldi_decoder_tpu.decoders.lattice import BatchedLatticeDecoder

    fc = config_for_graph(
        graph,
        beam=BEAM,
        max_active=MAX_ACTIVE,
        min_active=200,
        frontier_size=FRONTIER,
        rem_budget=REM_BUDGET,
        eps_rem_budget=EPS_REM_BUDGET,
        flat_group=FLAT_GROUP,
        **({"block_width": int(BLOCK_W)} if BLOCK_W else {}),
    )
    return BatchedLatticeDecoder(
        graph, fc, lattice_beam=LATTICE_BEAM,
        em_records=EM_RECORDS, eps_records=1024, pad_time_to=CHUNK_FRAMES,
        mesh=mesh,
    )




def device_info() -> dict:
    """The accelerator as JAX reports it."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def require_gpu() -> dict:
    """:func:`device_info`, or exit non-zero when JAX found no GPU."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(
            f"no GPU found (JAX platform {info['platform']!r}); "
            "device metrics are measured on a GPU only"
        )
    return info


def card_line() -> str:
    """Name and power limit of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def audio_seconds(lengths) -> float:
    return float(np.sum(lengths)) * FRAME_SECONDS


def device_seconds(dec, scores, lengths, passes: int = 3):
    """Wall seconds of each of ``passes`` chunked forward passes over the
    batch (the jitted frame scan only: no sweep, no download), each
    ending in ``block_until_ready``.  The chunk program must already be
    compiled (run one decode first)."""
    import jax
    import jax.numpy as jnp

    lengths_d = jnp.asarray(lengths)
    st0 = dec._init(scores.shape[0])[0]
    chunks = [
        jnp.asarray(scores[:, lo : lo + CHUNK_FRAMES])
        for lo in range(0, scores.shape[1], CHUNK_FRAMES)
    ]

    def one_pass():
        stc, rem = st0, lengths_d
        for c in chunks:
            stc, _ = dec._chunk_fn(dec._pg_dev, c, rem, stc)
            rem = jnp.maximum(rem - c.shape[1], 0)
        jax.block_until_ready(stc)

    one_pass()  # warm
    times = []
    for _ in range(passes):
        t0 = time.perf_counter()
        one_pass()
        times.append(time.perf_counter() - t0)
    return times


def finalize_batch(res):
    """Per-utterance lattice finalization + best-path extraction, serial.

    The host work rides under the device decode of the next pipelined
    batch.  1-best runs on the pruned array lattice
    (``best_path_labels``: native ShortestPath over flat arrays, no
    per-arc Python FST construction)."""
    return [res.best_path_labels(b) or [] for b in range(res.batch_size)]


def e2e_pipelined(dec, scores, lengths, n_batches: int = 4):
    """End to end through the public batched API, one batch ahead: batch
    i+1 is dispatched before batch i is fetched and host-finalized, so
    the host work overlaps device compute.  Returns (marks, hyps):
    ``marks[i]`` is the wall second at which batch i's words were ready;
    the steady per-batch period is ``(marks[-1] - marks[0]) /
    (n_batches - 1)`` (the first batch also pays the pipeline fill)."""
    t0 = time.perf_counter()
    pending = dec.decode_async(scores, lengths, chunk_frames=CHUNK_FRAMES)
    marks, hyps = [], None
    for i in range(n_batches):
        nxt = (
            dec.decode_async(scores, lengths, chunk_frames=CHUNK_FRAMES)
            if i + 1 < n_batches else None
        )
        hyps = finalize_batch(pending.result())
        marks.append(time.perf_counter() - t0)
        pending = nxt
    return marks, hyps


def steady_rate(marks, lengths) -> float:
    """Audio-s/s of the pipeline's steady per-batch period."""
    return audio_seconds(lengths) / ((marks[-1] - marks[0]) / (len(marks) - 1))


def baseline_throughput_native(graph, scores, lengths):
    """Native baselines: single-threaded C++ decodes with the reference's
    algorithmics on the same graph (native/csrc/kdtpu_host.cc):
    kd_decode_faster (best-path only: GetCutoff/nth_element, hash-map
    frontier, eps worklist) and kd_decode_lattice (LatticeSimpleDecoder
    token/ForwardLink structure + windowed backward pruning + max-active —
    the same lattice-mode work the device metric measures).  Returns the
    LATTICE-mode audio-s/s (the vs_baseline denominator)."""
    from kaldi_decoder_tpu import native

    # Full first utterance, same min_active as the device config (the C++
    # decoder is single-threaded, so its per-utterance rate IS its batch
    # rate).
    frames = int(lengths[0])
    best = np.inf
    for _ in range(2):
        t0 = time.perf_counter()
        _, nf, toks = native.decode_faster(
            graph, scores[0, :frames], beam=BEAM, max_active=MAX_ACTIVE,
            min_active=200,
        )
        best = min(best, time.perf_counter() - t0)
    log(f"  C++ single-thread best-path decoder: {nf} frames in {best:.2f}s "
        f"({nf * FRAME_SECONDS / best:.2f} audio-s/s, {toks} tokens)")
    best_l = np.inf
    for _ in range(2):
        t0 = time.perf_counter()
        _, st = native.decode_lattice(
            graph, scores[0, :frames], beam=BEAM, max_active=MAX_ACTIVE,
            min_active=200, lattice_beam=LATTICE_BEAM, prune_interval=25,
        )
        best_l = min(best_l, time.perf_counter() - t0)
    sps_l = st["frames"] * FRAME_SECONDS / best_l
    log(f"  C++ single-thread LATTICE decoder: {st['frames']} frames in "
        f"{best_l:.2f}s ({sps_l:.2f} audio-s/s, {st['links']} links, "
        f"{st['links_live']} live)")
    return sps_l


def main():
    from kaldi_decoder_tpu import native
    from kaldi_decoder_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = require_gpu()
    card = card_line()
    log(f"device: {dev['platform']} {dev['kind']} x{dev['count']} | "
        f"card (name, power limit): {card}")
    if not native.available():
        raise SystemExit("native host library did not build")
    if GRAPH_KIND == "hlg":
        graph, scores, lengths, refs = build_hlg_workload()
        name = "native HLG"
    else:
        graph, scores, lengths, refs = build_synthetic_workload()
        name = "HLG-shaped synthetic"
    log(f"bench: lattice decode  {name}  S={graph.num_states} "
        f"E={graph.num_emitting_arcs}+{graph.num_eps_arcs}eps V={V} "
        f"B={B} T={T} em_records={EM_RECORDS}")
    dec = make_decoder(graph)
    audio_s = audio_seconds(lengths)

    t0 = time.perf_counter()
    res = dec.decode(scores, lengths, chunk_frames=CHUNK_FRAMES)
    _stage(f"compile + first batch: {time.perf_counter() - t0:.1f}s")
    log(f"  overflow frame-events: {int(res.overflows.sum())}, saturated "
        f"frame-events: {int(res.saturations.sum())}")
    times = device_seconds(dec, scores, lengths)
    dev_sps = audio_s / min(times)
    log(f"  device decode: {min(times):.3f}s for {audio_s:.0f} audio-s "
        f"times={['%.3f' % x for x in times]}")

    t0 = time.perf_counter()
    hyps = finalize_batch(dec.decode(scores, lengths, chunk_frames=CHUNK_FRAMES))
    log(f"  e2e single batch (nothing overlapped): "
        f"{audio_s / (time.perf_counter() - t0):.1f} audio-s/s")
    marks, hyps = e2e_pipelined(dec, scores, lengths)
    e2e_sps = steady_rate(marks, lengths)
    log(f"  e2e pipelined: batch-ready marks (s) "
        f"{['%.2f' % m for m in marks]} -> {e2e_sps:.1f} audio-s/s steady")
    wer_val = None
    if refs is not None:
        from kaldi_decoder_tpu.utils.wer import wer

        st = wer(refs, hyps)
        wer_val = st.wer
        log(f"  WER vs known transcripts: {st}")
    base_sps = baseline_throughput_native(graph, scores, lengths)
    # Link recall of this config vs the exact oracle, as measured by
    # scripts/measure_recall.py --save (stored beside the graph cache).
    recall_note = ""
    rfile = CACHE_DIR / "recall.json"
    if GRAPH_KIND == "hlg" and rfile.exists():
        key = (
            f"em{EM_RECORDS}_rem{REM_BUDGET}_f{FRONTIER}_b{BEAM:g}"
            f"_ma{MAX_ACTIVE}"
        )
        rec = json.loads(rfile.read_text()).get(key)
        recall_note = (
            f", link recall {rec:.3f} vs oracle" if rec is not None
            else ", recall unmeasured"
        )
    cfg_tag = (
        f"B{B} beam{BEAM:g} ma{MAX_ACTIVE} em{EM_RECORDS} rem{REM_BUDGET}"
    )
    out = {
        "metric": f"{name} lattice decode throughput per chip"
        + (f" (WER {100 * wer_val:.2f}%" + recall_note + f"; {cfg_tag})"
           if wer_val is not None else f" ({cfg_tag})"),
        "value": round(dev_sps, 2),
        "unit": "audio_seconds_per_second_per_chip",
        "vs_baseline": round(dev_sps / base_sps, 2),
        # End to end including host lattices: the steady period of the
        # one-ahead decode_async pipeline (e2e_pipelined).
        "e2e_with_lattices": round(e2e_sps, 2),
        "e2e_vs_baseline": round(e2e_sps / base_sps, 2),
        "device": dev,
        "card": card,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
