"""Lattice decoder API: batched device decoding + reference-parity classes.

* :class:`BatchedLatticeDecoder` — batched device lattice decoding.
* :class:`LatticeSimpleDecoder` + :class:`LatticeSimpleDecoderConfig` —
  exact API parity with the reference
  (`kaldi-decoder/python/csrc/lattice-simple-decoder.cc:11-68`).
* :class:`LatticeFasterDecoder` + :class:`LatticeFasterDecoderConfig` —
  the capability the reference declares but leaves unimplemented
  (`kaldi-decoder/csrc/lattice-faster-decoder.cc:12-13` empty stub;
  config fields from `lattice-faster-decoder.h:23-134`): lattice
  generation with adaptive-beam/max-active pruning.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_decoder_tpu.decodable import DecodableInterface, scores_from_decodable
from kaldi_decoder_tpu.decoders.frontier import (
    FrontierConfig,
    StepState,
    config_for_graph,
)
from kaldi_decoder_tpu.decoders.lattice_dev import (
    LatticeDevConfig,
    build_lattice_chunk_fn,
    init_closure_rec,
    lattice_config_for_graph,
)
from kaldi_decoder_tpu.decoders.viterbi import _round_up
from kaldi_decoder_tpu.fst.csr import CsrGraph, compile_fst
from kaldi_decoder_tpu.fst.fst import INF, Lattice, StdVectorFst
from kaldi_decoder_tpu.lattice.prune import (
    IncrementalLattice,
    PrunedLattice,
    prune_lattice,
    raw_lattice_to_fst,
)
from kaldi_decoder_tpu.fst.ops import shortest_path
from kaldi_decoder_tpu.utils.logging import DecodeStats

INT32_MAX = 2**31 - 1


# ---------------------------------------------------------------------------
# Configs (reference field names and defaults)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LatticeSimpleDecoderConfig:
    """lattice-simple-decoder.h:24-84 parity."""

    beam: float = 16.0
    lattice_beam: float = 10.0
    prune_interval: int = 25
    determinize_lattice: bool = True
    prune_lattice: bool = True
    beam_ratio: float = 0.9
    prune_scale: float = 0.1

    def check(self) -> None:
        if not (self.beam > 0 and self.lattice_beam > 0 and self.prune_interval > 0):
            raise ValueError(
                "need beam > 0, lattice_beam > 0, prune_interval > 0"
            )

    def __str__(self) -> str:
        return (
            f"LatticeSimpleDecoderConfig(beam={self.beam:g}, "
            f"lattice_beam={self.lattice_beam:g}, "
            f"prune_interval={self.prune_interval}, "
            f"determinize_lattice={self.determinize_lattice}, "
            f"prune_lattice={self.prune_lattice}, "
            f"beam_ratio={self.beam_ratio:g}, prune_scale={self.prune_scale:g})"
        )


@dataclasses.dataclass
class LatticeFasterDecoderConfig:
    """lattice-faster-decoder.h:23-134 parity (memory-pool block sizes are
    accepted for compatibility; the device decoder has no token pools)."""

    beam: float = 16.0
    max_active: int = INT32_MAX
    min_active: int = 200
    lattice_beam: float = 10.0
    prune_interval: int = 25
    determinize_lattice: bool = True
    beam_delta: float = 0.5
    hash_ratio: float = 2.0
    prune_scale: float = 0.1
    memory_pool_tokens_block_size: int = 256
    memory_pool_links_block_size: int = 256

    def check(self) -> None:
        # lattice-faster-decoder.h:120-127 Check().
        if not (
            self.beam > 0.0
            and self.max_active > 1
            and self.lattice_beam > 0.0
            and self.min_active <= self.max_active
            and self.prune_interval > 0
            and self.beam_delta > 0.0
            and self.hash_ratio >= 1.0
            and self.prune_scale > 0.0
            and self.prune_scale < 1.0
        ):
            raise ValueError("invalid LatticeFasterDecoderConfig")

    def __str__(self) -> str:
        return (
            f"LatticeFasterDecoderConfig(beam={self.beam:g}, "
            f"max_active={self.max_active}, min_active={self.min_active}, "
            f"lattice_beam={self.lattice_beam:g}, "
            f"prune_interval={self.prune_interval}, "
            f"determinize_lattice={self.determinize_lattice}, "
            f"beam_delta={self.beam_delta:g}, hash_ratio={self.hash_ratio:g}, "
            f"prune_scale={self.prune_scale:g})"
        )


# ---------------------------------------------------------------------------
# Batched decoder
# ---------------------------------------------------------------------------


def _merge_tokens(
    frontier_states: np.ndarray,
    frontier_costs: np.ndarray,
    extra_states: np.ndarray,
    extra_alphas: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted-unique union of the device frontier with synthesized tokens.

    Frontier alphas win on collision (they are true per-state minima; a
    synthesized path-prefix cost is always >= them — see
    ``FoldedGraph.expand_with_alphas``).  Returns (states, alphas) sorted
    by state, the layout ``prune_lattice`` tokens expect.
    """
    ok = np.isfinite(frontier_costs)
    fst_states = frontier_states[ok].astype(np.int64)
    fst_costs = frontier_costs[ok].astype(np.float64)
    states = np.concatenate([fst_states, np.asarray(extra_states, np.int64)])
    costs = np.concatenate([fst_costs, np.asarray(extra_alphas, np.float64)])
    # Stable lexsort with frontier entries first on ties of (state, cost):
    # sort by (state, cost) and keep the first of each state.
    order = np.lexsort((costs, states))
    states, costs = states[order], costs[order]
    first = np.ones(len(states), bool)
    first[1:] = states[1:] != states[:-1]
    return states[first], costs[first]


def _as_graph(fst) -> CsrGraph:
    if isinstance(fst, CsrGraph):
        return fst
    if isinstance(fst, StdVectorFst):
        return compile_fst(fst)
    raise TypeError(f"expected StdVectorFst or CsrGraph, got {type(fst)!r}")


@dataclasses.dataclass
class LatticeResult:
    """Host-side batched lattice decode result.

    Two data sources (identical final lattices, proven by
    ``tests/test_sweep.py``):

    * full mode (``device_prune=False``): the complete per-frame frontier
      and record buffers are downloaded (``frame_states`` .. ``eps_records``);
    * swept mode (default): the device backward sweep
      (:mod:`kaldi_decoder_tpu.decoders.sweep`) pruned the structure to
      its survivors on device and only those rows were downloaded
      (``survivors``) — typically 100-1000x less wire traffic.
    """

    graph: CsrGraph
    cfg: LatticeDevConfig
    lattice_beam: float
    scores: np.ndarray  # (B, T, V)
    lengths: np.ndarray  # (B,)
    init_states: np.ndarray  # (K,)
    init_costs: np.ndarray  # (K,)
    init_eps_records: np.ndarray  # (D, R_eps, >=2)
    num_active: np.ndarray  # (T, B)
    cutoffs: np.ndarray  # (T, B)
    overflows: np.ndarray  # (T, B)
    saturations: np.ndarray  # (T, B) bool — frontier capacity hit
    frame_states: Optional[np.ndarray] = None  # (T, B, K)
    frame_costs: Optional[np.ndarray] = None  # (T, B, K)
    em_records: Optional[np.ndarray] = None  # (T, B, R_em, 4)
    eps_records: Optional[np.ndarray] = None  # (T, B, D, R_eps, 4)
    # Swept mode: list of per-chunk dicts with keys
    #   frame0 (int), tok_rows (B, _, 3), tok_count (B,),
    #   em_rows (B, _, 3), em_count (B,), eps_rows (B, _, 3),
    #   eps_count (B,), overflow (B,)
    survivors: Optional[List[dict]] = None
    fold: object = None  # Optional[FoldedGraph] — records carry folded ids
    # Wall-clock seconds of the batch device decode incl. one sync
    # fetch (remaining result downloads happen outside the timer).
    wall_seconds: float = 0.0

    def __post_init__(self):
        self._pruned: dict = {}

    @property
    def batch_size(self) -> int:
        return self.scores.shape[0]

    def sweep_overflowed(self, b: int) -> bool:
        """True if the device sweep's survivor buffers overflowed for
        utterance ``b`` (lattice may be missing links; re-run with
        device_prune=False or larger sweep caps)."""
        if self.survivors is None:
            return False
        return bool(any(np.asarray(c["overflow"])[b] for c in self.survivors))

    def _survivor_frames(self, b: int, L: int):
        """Group downloaded survivor rows into per-frame structures.

        Returns (frame_states list (L+1), frame_costs list, em_records
        list (L), eps_records list (L))."""
        K = self.cfg.frontier.frontier_size
        tok_f = [None] * (L + 1)
        tok_c = [None] * (L + 1)
        em = [np.zeros((0, 2), np.int32) for _ in range(L)]
        eps = [np.zeros((1, 0, 2), np.int32) for _ in range(L)]
        tok_f[0] = self.init_states
        tok_c[0] = self.init_costs
        for chunk in self.survivors:
            f0 = chunk["frame0"]
            tr = chunk["tok_rows"][b][: int(chunk["tok_count"][b])]
            if len(tr):
                frames = tr[:, 0]
                alphas = tr[:, 2].view(np.float32)
                order = np.argsort(frames, kind="stable")
                frames, states, alphas = (
                    frames[order], tr[order, 1], alphas[order]
                )
                bounds = np.searchsorted(
                    frames, np.arange(frames[0], frames[-1] + 2)
                )
                for i, f in enumerate(range(int(frames[0]), int(frames[-1]) + 1)):
                    gf = f0 + f
                    if gf > L:
                        continue
                    sl = slice(bounds[i], bounds[i + 1])
                    if sl.start == sl.stop:
                        continue
                    # Min-alpha dedup by state: duplicates only occur when
                    # a sweep buffer overflowed (clobbered rows); keep the
                    # structure well-formed either way.
                    order2 = np.lexsort((alphas[sl], states[sl]))
                    ss, aa = states[sl][order2], alphas[sl][order2]
                    first = np.ones(len(ss), bool)
                    first[1:] = ss[1:] != ss[:-1]
                    tok_f[gf] = ss[first]
                    tok_c[gf] = aa[first]
            er = chunk["em_rows"][b][: int(chunk["em_count"][b])]
            if len(er):
                for t in np.unique(er[:, 0]):
                    gt = f0 + int(t)
                    if gt >= L:
                        continue
                    em[gt] = er[er[:, 0] == t][:, 1:3]
            zr = chunk["eps_rows"][b][: int(chunk["eps_count"][b])]
            if len(zr):
                for f in np.unique(zr[:, 0]):
                    gf = f0 + int(f)
                    if gf > L or gf < 1:
                        continue
                    eps[gf - 1] = zr[zr[:, 0] == f][None, :, 1:3]
        # Frames with no surviving tokens: empty arrays (prune_lattice
        # treats an empty frame as search death, matching the reference).
        for f in range(L + 1):
            if tok_f[f] is None:
                tok_f[f] = np.zeros((0,), np.int32)
                tok_c[f] = np.zeros((0,), np.float32)
        return tok_f, tok_c, em, eps

    def _prune(self, b: int, use_final_probs: bool = True) -> Optional[PrunedLattice]:
        key = (b, use_final_probs)
        if key not in self._pruned:
            L = int(self.lengths[b])
            if self.survivors is not None:
                frame_states, frame_costs, em_recs, eps_recs = (
                    self._survivor_frames(b, L)
                )
            else:
                frame_states = np.concatenate(
                    [self.init_states[None], self.frame_states[:L, b]], axis=0
                )
                frame_costs = np.concatenate(
                    [self.init_costs[None], self.frame_costs[:L, b]], axis=0
                )
                em_recs = self.em_records[:L, b]
                eps_recs = self.eps_records[:L, b]
            if self.fold is not None:
                # Expand folded arc records back to original-graph em/eps
                # records (fst/fold.py), synthesizing any eps-intermediate
                # token the device frontier evicted (its alpha = record
                # path prefix cost) so reconstruction never depends on
                # intermediate frontier survival; init links/tokens come
                # from the host start closure.
                sc = self.fold.start
                fs: list = [None] * (L + 1)
                fc: list = [None] * (L + 1)
                fs[0], fc[0] = _merge_tokens(
                    frame_states[0], frame_costs[0], sc.states,
                    sc.costs.astype(np.float64),
                )
                em_list, eps_list = [], []
                for t in range(L):
                    em, eps, ts, ta = self.fold.expand_with_alphas(
                        em_recs[t], fs[t], fc[t],
                        self.scores[b, t],
                    )
                    em_list.append(em)
                    eps_list.append(eps)
                    fs[t + 1], fc[t + 1] = _merge_tokens(
                        frame_states[t + 1], frame_costs[t + 1], ts, ta
                    )
                init_eps = sc.eps_records
                em_records, eps_records = em_list, eps_list
                frame_states, frame_costs = fs, fc
            else:
                init_eps = self.init_eps_records
                em_records = em_recs
                eps_records = eps_recs
            self._pruned[key] = prune_lattice(
                frame_states=frame_states,
                frame_costs=frame_costs,
                init_eps_records=init_eps,
                em_records=em_records,
                eps_records=eps_records,
                scores=self.scores[b, :L],
                graph=self.graph,
                lattice_beam=self.lattice_beam,
                use_final_probs=use_final_probs,
            )
        return self._pruned[key]

    def raw_lattice(self, b: int = 0, use_final_probs: bool = True) -> Optional[Lattice]:
        pl = self._prune(b, use_final_probs)
        if pl is None:
            return None
        return raw_lattice_to_fst(pl, use_final_probs)

    def best_path(self, b: int = 0, use_final_probs: bool = True) -> Optional[Lattice]:
        """GetBestPath == ShortestPath(GetRawLattice)
        (`lattice-simple-decoder.cc:574-580`)."""
        lat = self.raw_lattice(b, use_final_probs)
        if lat is None:
            return None
        sp = shortest_path(lat)
        return sp if sp.num_states > 0 else None

    def best_path_labels(
        self, b: int = 0, use_final_probs: bool = True, side: str = "olabel"
    ) -> Optional[list]:
        """1-best label sequence straight from the pruned array lattice.

        The production serving path: ShortestPath runs on the flat arc
        arrays (`lattice-simple-decoder.cc:574-580` semantics incl. the
        LatticeWeight natural-order tie-break), skipping the Python FST
        object entirely — identical labels to
        ``path_labels(self.best_path(b))`` at a fraction of the host
        cost.  Falls back to that exact path when the native library is
        unavailable.  Returns None when decoding failed (no lattice)."""
        from kaldi_decoder_tpu import native
        from kaldi_decoder_tpu.fst.ops import path_labels

        if not native.available():
            p = self.best_path(b, use_final_probs)
            return None if p is None else path_labels(p, side=side)
        pl = self._prune(b, use_final_probs)
        if pl is None:
            return None
        from kaldi_decoder_tpu.lattice.prune import flat_arc_arrays

        flat = flat_arc_arrays(pl, use_final_probs)
        if flat is None:
            return None
        n, src, dst, il, ol, wg, wa, final_graph, start = flat
        path = native.shortest_path_arrays(
            n, src, wg + wa, dst,
            final_graph,  # acoustic final component is 0
            start,
            w_graph=wg,
            final_graph=np.where(
                np.isfinite(final_graph), final_graph, 0.0
            ).astype(np.float32),
        )
        if path is None:
            return None
        labels = (il if side == "ilabel" else ol)[path]
        return [int(x) for x in labels[labels != 0]]

    def reached_final(self, b: int = 0) -> bool:
        pl = self._prune(b)
        return pl is not None and np.isfinite(pl.final_relative_cost)

    def final_relative_cost(self, b: int = 0) -> float:
        pl = self._prune(b)
        return INF if pl is None else pl.final_relative_cost

    def stats(self, b: int = 0) -> DecodeStats:
        L = int(self.lengths[b])
        return DecodeStats(
            num_frames=L,
            active_per_frame=self.num_active[:L, b],
            cutoff_per_frame=self.cutoffs[:L, b],
            arc_budget_overflows=int(np.sum(self.overflows[:L, b])),
            frontier_saturated_frames=int(np.sum(self.saturations[:L, b])),
            wall_seconds=self.wall_seconds,
            batch_frames=int(np.sum(self.lengths)),
        )


class BatchedLatticeDecoder:
    """Batched lattice-generating decoder over a device-resident graph.

    The union capability: LatticeSimpleDecoder's lattice generation
    (`lattice-simple-decoder.cc`) + FasterDecoder's adaptive-beam and
    max-active pruning (`faster-decoder.cc:244-336`).
    """

    def __init__(
        self,
        graph,
        frontier: Optional[FrontierConfig] = None,
        lattice_beam: float = 10.0,
        em_records: Optional[int] = None,
        eps_records: Optional[int] = None,
        pad_time_to: int = 128,
        mesh=None,
        data_axis: str = "data",
        fold: bool = True,
    ):
        from kaldi_decoder_tpu.decoders.viterbi import (
            _cfg_for_device_graph,
            _maybe_fold,
        )

        self.graph = _as_graph(graph)
        self.fold = _maybe_fold(self.graph, fold)
        dev_graph = self.fold.device if self.fold is not None else self.graph
        self._dev_graph = dev_graph
        fc = _cfg_for_device_graph(dev_graph, frontier)
        fc.validate()
        self.lattice_beam = float(lattice_beam)
        self.cfg = lattice_config_for_graph(
            dev_graph, fc, em_records=em_records, eps_records=eps_records,
            lattice_beam=self.lattice_beam,
        )
        self.pad_time_to = pad_time_to
        self.mesh = mesh
        self.data_axis = data_axis
        self._batch_multiple = mesh.devices.size if mesh is not None else 1
        from kaldi_decoder_tpu.fst.pack import pack_graph_device

        fc2 = self.cfg.frontier
        self._pg_dev = pack_graph_device(
            dev_graph, fc2.block_width, fc2.eps_block_width, fc2.flat_group
        )
        self._chunk_fn = build_lattice_chunk_fn(dev_graph, self.cfg, mesh, data_axis)
        self._init_cache: dict = {}

    def _init(self, batch: int):
        # Memoized: the start closure depends only on (graph, config,
        # batch).  Recomputing per decode would not just waste work — its
        # np.asarray fetches would BLOCK until every previously-dispatched
        # batch drains the device queue, serializing the decode_async
        # pipeline (the host must touch nothing queue-ordered at dispatch
        # time).
        cached = self._init_cache.get(batch)
        if cached is not None:
            return cached
        out = self._init_uncached(batch)
        self._init_cache[batch] = out
        return out

    def _init_uncached(self, batch: int):
        if self.fold is not None:
            from kaldi_decoder_tpu.decoders.viterbi import _folded_init

            stb, _ = _folded_init(self.fold, self.cfg.frontier, batch)
            D = self.cfg.frontier.eps_iters
            recs = np.full((D, self.cfg.eps_records, 4), -1, np.int32)
            return (
                stb,
                np.asarray(stb.states[0]),
                np.asarray(stb.costs[0]),
                recs,
            )
        st, recs = init_closure_rec(
            self._pg_dev, self.graph.start_state, self.graph.num_states, self.cfg
        )
        stb = StepState(
            states=jnp.broadcast_to(st.states, (batch,) + st.states.shape),
            costs=jnp.broadcast_to(st.costs, (batch,) + st.costs.shape),
            base=jnp.broadcast_to(st.base, (batch,)),
        )
        return stb, np.asarray(st.states), np.asarray(st.costs), np.asarray(recs)

    def decode(
        self,
        scores: np.ndarray,
        lengths: Optional[np.ndarray] = None,
        chunk_frames: Optional[int] = None,
        device_prune: bool = True,
    ) -> LatticeResult:
        """Batched lattice decode.

        ``chunk_frames``: decode in fixed-size time chunks through one
        compiled program (the streaming shape) instead of one T-sized
        program — avoids per-T recompiles for long/varied utterances.

        ``device_prune`` (default): run the windowed backward extra-cost
        sweep on device per chunk (:mod:`kaldi_decoder_tpu.decoders.sweep`)
        and download only surviving tokens/links; the final lattice is
        identical to ``device_prune=False`` (everything dropped is
        provably outside it) at a small fraction of the transfer and host
        cost.  Host reconstruction of chunk c overlaps the device decode
        of chunk c+1 (chunk c's downloads block only on its own device
        work while later chunks keep executing — the async-dispatch
        pipeline the reference cannot express single-threaded).
        """
        return self.decode_async(
            scores, lengths, chunk_frames, device_prune
        ).result()

    def decode_async(
        self,
        scores: np.ndarray,
        lengths: Optional[np.ndarray] = None,
        chunk_frames: Optional[int] = None,
        device_prune: bool = True,
    ) -> "PendingDecode":
        """Dispatch a batched decode and return immediately.

        All device work (forward chunks + sweeps) is enqueued
        asynchronously; call :meth:`PendingDecode.result` to download and
        assemble.  Production pipelining: dispatch batch i+1, then fetch
        and host-finalize batch i while the device decodes i+1 — host
        lattice finalization rides entirely under device compute.
        """
        scores = np.asarray(scores, dtype=np.float32)
        if scores.ndim == 2:
            scores = scores[None]
        B, T, V = scores.shape
        if self.graph.max_score_idx >= V:
            raise ValueError(
                f"graph references score index {self.graph.max_score_idx} but "
                f"scores have only {V} columns"
            )
        if lengths is None:
            lengths = np.full((B,), T, np.int32)
        lengths = np.asarray(lengths, dtype=np.int32)

        Tp = max(_round_up(T, self.pad_time_to), self.pad_time_to)
        if chunk_frames is not None:
            # Whole chunks only: the last chunk is padded rather than
            # shortened, so one compiled (forward, sweep) pair serves
            # every chunk.
            C0 = max(_round_up(chunk_frames, self.pad_time_to), 1)
            Tp = _round_up(Tp, C0)
        Bp = _round_up(B, self._batch_multiple)
        if Tp != T or Bp != B:
            scores_p = np.zeros((Bp, Tp, V), np.float32)
            scores_p[:B, :T] = scores
            lengths_p = np.zeros((Bp,), np.int32)
            lengths_p[:B] = lengths
        else:
            scores_p, lengths_p = scores, lengths

        st0, init_states, init_costs, init_recs = self._init(Bp)
        from kaldi_decoder_tpu.utils.profiling import WallTimer, annotate

        C = Tp if chunk_frames is None else max(
            _round_up(chunk_frames, self.pad_time_to), 1
        )
        sweep_fn = None
        if device_prune:
            from kaldi_decoder_tpu.decoders.sweep import (
                build_sweep_fn, sweep_config,
            )

            sweep_fn = build_sweep_fn(sweep_config(self.cfg, C))

        if self.mesh is None:
            put = jnp.asarray
        else:
            from kaldi_decoder_tpu.parallel.mesh import batch_sharding

            # Inputs go straight to their batch shard on every device
            # instead of landing whole on the first one.
            sharding = batch_sharding(self.mesh, self.data_axis)
            put = lambda x: jax.device_put(x, sharding)  # noqa: E731

        timer = WallTimer()
        with timer, annotate("kdtpu.lattice_decode"):
            # Dispatch every chunk (forward + sweep) asynchronously; the
            # device queue serializes them while the host is free to
            # download/assemble earlier work.
            rem = put(lengths_p)
            stc = st0
            chunks = []
            for lo in range(0, Tp, C):
                chunk_init = stc.states
                stc, o = self._chunk_fn(
                    self._pg_dev, put(scores_p[:, lo : lo + C]), rem, stc,
                )
                sw = None
                dl = None
                if device_prune:
                    sw = sweep_fn(
                        o.frontier_states, o.frontier_costs,
                        o.em_records, o.eps_records, chunk_init, rem,
                    )
                    # The record buffers are consumed by the sweep; keep
                    # only the small per-frame stats on the Python side so
                    # the backing HBM can be released as chunks retire.
                    o = o._replace(
                        em_records=None, eps_records=None,
                        frontier_states=None, frontier_costs=None,
                    )
                    # Dispatch-time download slices at static caps: the
                    # slice ops execute at THIS batch's position in the
                    # device queue (slicing at result() time would
                    # enqueue them behind any already-dispatched next
                    # batch, serializing the pipeline).  _finish falls
                    # back to the retained full buffers if a count
                    # exceeds its cap.
                    ct, ce, cz = self._dl_caps(C)
                    dl = (
                        sw.tok_rows[:, :ct],
                        sw.em_rows[:, :ce],
                        sw.eps_rows[:, :cz],
                    )
                    # Start every device-to-host copy _finish will need
                    # as soon as its chunk is computed, so the copies
                    # overlap later device work instead of queueing
                    # behind the fetch in result().
                    for x in (
                        *dl, sw.tok_count, sw.em_count, sw.eps_count,
                        sw.overflow, o.num_active, o.cutoff, o.overflow,
                        o.saturated,
                    ):
                        x.copy_to_host_async()
                else:
                    # Full-record mode: fetch each chunk to host as it is
                    # produced so peak HBM stays one chunk's buffers, not
                    # T-proportional (this mode is also the sweep-overflow
                    # fallback, i.e. exactly the workloads most likely to
                    # OOM).  The fetch is synchronous; async dispatch is
                    # kept only for the swept path, whose big buffers are
                    # dropped on device.
                    o = jax.tree.map(
                        lambda x: np.asarray(x) if x is not None else None, o
                    )
                rem = jnp.maximum(rem - C, 0)
                chunks.append((lo, o, sw, dl))
        return PendingDecode(
            decoder=self,
            scores=scores,
            lengths=lengths,
            chunk_frames=chunk_frames,
            device_prune=device_prune,
            chunks=chunks,
            init_states=init_states,
            init_costs=init_costs,
            init_recs=init_recs,
            timer=timer,
        )

    def _dl_caps(self, chunk_frames: int) -> Tuple[int, int, int]:
        """Static survivor-download caps (rows per buffer).

        Sized from measured windowed-sweep survivor densities at bench
        scale: rows(C) fits a fixed boundary/utterance-end block plus a
        steady per-frame rate (tok ~18/frame + ~15k block, em ~27/frame
        + ~31k block at B=16), with ~1.2-1.45x margin.  Large enough
        that the fallback full-buffer download in ``_finish`` is rare,
        small enough that the per-batch D2H bytes track the real
        survivor volume instead of the in-buffer worst-case caps
        (~16x typical density)."""
        C = chunk_frames
        fc = self.cfg.frontier
        K, R = fc.frontier_size, self.cfg.em_records
        tok = min(_round_up(5 * K + 36 * C, 1024), K + 192 * C + K)
        em = min(_round_up(5 * R + 56 * C, 1024), R + 320 * C + R)
        eps_total = max(64 * C, 8) + max(fc.eps_iters, 1) * self.cfg.eps_records
        eps = (
            min(_round_up(24 * C, 512), eps_total) if fc.eps_iters else 8
        )
        return tok, em, eps

    def _finish(self, pending: "PendingDecode") -> LatticeResult:
        chunks = pending.chunks
        device_prune = pending.device_prune
        from kaldi_decoder_tpu.utils.profiling import WallTimer

        timer = WallTimer()
        with timer:
            survivors = None
            if device_prune:
                survivors = []
                # The download slices were dispatched inside
                # decode_async; fetching them waits only on this batch's
                # own device work.  Check the counts fit the static caps
                # and fall back to the retained full buffer when one does
                # not (rare — caps cover measured worst-case density).
                for lo, o, sw, dl in chunks:
                    tc, ec, zc, ovf = jax.tree.map(
                        np.asarray,
                        (sw.tok_count, sw.em_count, sw.eps_count, sw.overflow),
                    )
                    tr, er, zr = dl
                    if int(tc.max()) > tr.shape[1]:
                        tr = sw.tok_rows
                    if int(ec.max()) > er.shape[1]:
                        er = sw.em_rows
                    if int(zc.max()) > zr.shape[1]:
                        zr = sw.eps_rows
                    survivors.append(
                        {
                            "frame0": lo,
                            "tok_rows": np.asarray(tr),
                            "tok_count": tc,
                            "em_rows": np.asarray(er),
                            "em_count": ec,
                            "eps_rows": np.asarray(zr),
                            "eps_count": zc,
                            "overflow": ovf,
                        }
                    )
                if any(c["overflow"].any() for c in survivors):
                    # Worst-case workloads (wide beams on high-entropy
                    # scores) can keep nearly every record alive, in
                    # which case the windowed sweep saves nothing and its
                    # buffers overflow.  Correctness first: fall back to
                    # the full download + host prune.
                    import logging

                    logging.getLogger(__name__).warning(
                        "device sweep survivor buffers overflowed; "
                        "falling back to full host pruning"
                    )
                    return self.decode(
                        pending.scores, pending.lengths,
                        chunk_frames=pending.chunk_frames,
                        device_prune=False,
                    )
                stats = [
                    jax.tree.map(
                        np.asarray,
                        (o.num_active, o.cutoff, o.overflow, o.saturated),
                    )
                    for _, o, _, _ in chunks
                ]
                num_active, cutoffs, overflows, saturations = (
                    np.concatenate([s[i] for s in stats], axis=0)
                    for i in range(4)
                )
                frame_states = frame_costs = em_records = eps_records = None
            else:
                outs = jax.tree.map(
                    lambda *xs: np.concatenate(
                        [np.asarray(x) for x in xs], axis=0
                    ),
                    *[o for _, o, _, _ in chunks],
                )
                frame_states = outs.frontier_states
                frame_costs = outs.frontier_costs
                em_records = outs.em_records
                eps_records = outs.eps_records
                num_active = outs.num_active
                cutoffs = outs.cutoff
                overflows = outs.overflow
                saturations = outs.saturated
        return LatticeResult(
            graph=self.graph,
            cfg=self.cfg,
            lattice_beam=self.lattice_beam,
            scores=pending.scores,
            lengths=pending.lengths,
            init_states=pending.init_states,
            init_costs=pending.init_costs,
            init_eps_records=pending.init_recs,
            frame_states=frame_states,
            frame_costs=frame_costs,
            em_records=em_records,
            eps_records=eps_records,
            survivors=survivors,
            num_active=num_active,
            cutoffs=cutoffs,
            overflows=overflows,
            saturations=saturations,
            fold=self.fold,
            wall_seconds=pending.timer.elapsed + timer.elapsed,
        )


@dataclasses.dataclass
class PendingDecode:
    """A dispatched batched decode (device work enqueued, not fetched).

    ``result()`` downloads and assembles into a :class:`LatticeResult`.
    Fetch blocks only on this batch's own device work — a batch
    dispatched after this one keeps the device busy while the host
    finalizes this one (the production overlap; see ``bench.py``
    ``e2e_with_lattices``)."""

    decoder: "BatchedLatticeDecoder"
    scores: np.ndarray
    lengths: np.ndarray
    chunk_frames: Optional[int]
    device_prune: bool
    chunks: list
    init_states: np.ndarray
    init_costs: np.ndarray
    init_recs: np.ndarray
    timer: object

    def result(self) -> LatticeResult:
        return self.decoder._finish(self)


# ---------------------------------------------------------------------------
# Reference-parity streaming classes
# ---------------------------------------------------------------------------


class _StreamingLattice:
    """Shared streaming machinery for the lattice decoder API classes.

    Host memory is bounded: each ``advance_decoding`` chunk's records are
    folded into an :class:`IncrementalLattice` immediately (acoustic
    scores are consumed, not retained) and every ``prune_interval`` frames
    the backward extra-cost sweep discards provably-dead tokens/links —
    the reference's PruneActiveTokens loop
    (`lattice-simple-decoder.cc:53-73`, `:198-223`).  The final lattice is
    identical to a one-shot decode.
    """

    chunk_pad: int = 64

    def __init__(self, fst, frontier_kw: dict, lattice_beam: float, config):
        self._graph = _as_graph(fst)
        fc = config_for_graph(self._graph, **frontier_kw)
        self._lattice_beam = float(lattice_beam)
        self._dev_cfg = lattice_config_for_graph(
            self._graph, fc, lattice_beam=self._lattice_beam
        )
        self._config = config
        self._prune_interval = int(getattr(config, "prune_interval", 25))
        self._prune_scale = float(getattr(config, "prune_scale", 0.1))
        from kaldi_decoder_tpu.fst.pack import pack_graph_device

        fcw = self._dev_cfg.frontier
        self._pg_dev = pack_graph_device(
            self._graph, fcw.block_width, fcw.eps_block_width, fcw.flat_group
        )
        self._chunk_fn = build_lattice_chunk_fn(self._graph, self._dev_cfg)
        self._reset()

    def _reset(self):
        self._num_frames_decoded = -1
        self._state: Optional[StepState] = None
        self._inc: Optional[IncrementalLattice] = None
        self._stats: List[dict] = []
        self._wall_s = 0.0
        self._since_prune = 0
        self._finalized = False
        self._pruned_cache: dict = {}

    def get_config(self):
        return self._config

    def init_decoding(self) -> None:
        self._reset()
        st, recs = init_closure_rec(
            self._pg_dev, self._graph.start_state, self._graph.num_states,
            self._dev_cfg,
        )
        self._state = StepState(st.states[None], st.costs[None], st.base[None])
        self._inc = IncrementalLattice(
            self._graph, self._lattice_beam, self._prune_scale
        )
        self._inc.init_frame(
            np.asarray(st.states), np.asarray(st.costs), np.asarray(recs)
        )
        self._num_frames_decoded = 0

    def advance_decoding(
        self, decodable: DecodableInterface, max_num_frames: int = -1
    ) -> None:
        assert self._num_frames_decoded >= 0, "call init_decoding() first"
        assert not self._finalized, "cannot advance after finalize_decoding()"
        num_frames_ready = decodable.num_frames_ready()
        assert num_frames_ready >= self._num_frames_decoded
        target = num_frames_ready
        if max_num_frames >= 0:
            target = min(target, self._num_frames_decoded + max_num_frames)
        n_new = target - self._num_frames_decoded
        if n_new <= 0:
            return
        scores = scores_from_decodable(decodable, self._num_frames_decoded, target)
        if self._graph.max_score_idx >= scores.shape[1]:
            raise ValueError(
                f"graph references score index {self._graph.max_score_idx} but "
                f"decodable has only {scores.shape[1]} indices"
            )
        Tp = _round_up(n_new, self.chunk_pad)
        scores_p = np.zeros((1, Tp, scores.shape[1]), np.float32)
        scores_p[0, :n_new] = scores
        from kaldi_decoder_tpu.utils.profiling import WallTimer, annotate

        with WallTimer() as timer, annotate(
            "kdtpu.advance_decoding", step=self._num_frames_decoded
        ):
            stf, outs = self._chunk_fn(
                self._pg_dev, jnp.asarray(scores_p),
                jnp.array([n_new], jnp.int32), self._state,
            )
            frame_states_all = np.asarray(outs.frontier_states)  # sync barrier
        self._wall_s += timer.elapsed
        self._state = stf
        frame_states = frame_states_all[:n_new, 0]
        frame_costs = np.asarray(outs.frontier_costs)[:n_new, 0]
        em_records = np.asarray(outs.em_records)[:n_new, 0]
        eps_records = np.asarray(outs.eps_records)[:n_new, 0]
        for t in range(n_new):
            self._inc.append_frame(
                frame_states[t], frame_costs[t], em_records[t],
                eps_records[t], scores[t],
            )
            self._since_prune += 1
            if self._since_prune >= self._prune_interval:
                self._inc.prune_active_tokens()
                self._since_prune = 0
        self._stats.append(
            {
                "num_active": np.asarray(outs.num_active)[:n_new, 0],
                "cutoffs": np.asarray(outs.cutoff)[:n_new, 0],
                "overflows": np.asarray(outs.overflow)[:n_new, 0],
                "saturations": np.asarray(outs.saturated)[:n_new, 0],
            }
        )
        self._pruned_cache.clear()
        self._num_frames_decoded = target

    def decode(self, decodable: DecodableInterface) -> bool:
        """Full decode + FinalizeDecoding; True iff final costs exist
        (`lattice-simple-decoder.cc:53-73`)."""
        self.init_decoding()
        self.advance_decoding(decodable)
        self.finalize_decoding()
        return self.reached_final()

    def finalize_decoding(self) -> None:
        """FinalizeDecoding parity (`lattice-simple-decoder.cc:407-420`).

        The full backward prune happens lazily on the host when a lattice
        is requested; this locks in final-probs semantics
        (`:588-591` forbids use_final_probs=False after)."""
        self._finalized = True

    def num_frames_decoded(self) -> int:
        return self._num_frames_decoded

    def _pruned(self, use_final_probs: bool = True) -> Optional[PrunedLattice]:
        assert self._inc is not None, "call init_decoding() first"
        if use_final_probs not in self._pruned_cache:
            self._pruned_cache[use_final_probs] = self._inc.finalize(
                use_final_probs
            )
        return self._pruned_cache[use_final_probs]

    def stats(self) -> DecodeStats:
        T = self._num_frames_decoded
        cat = lambda k: (
            np.concatenate([c[k] for c in self._stats], axis=0)
            if self._stats
            else np.zeros((0,))
        )
        return DecodeStats(
            num_frames=T,
            active_per_frame=cat("num_active"),
            cutoff_per_frame=cat("cutoffs"),
            arc_budget_overflows=int(np.sum(cat("overflows"))),
            frontier_saturated_frames=int(np.sum(cat("saturations"))),
            wall_seconds=self._wall_s,
            batch_frames=T,
        )

    def reached_final(self) -> bool:
        pl = self._pruned(True)
        return pl is not None and np.isfinite(pl.final_relative_cost)

    def final_relative_cost(self) -> float:
        """ComputeFinalCosts semantics (`lattice-simple-decoder.cc:522-560`)."""
        st = self._state
        if st is None:
            return INF
        costs = np.asarray(st.base)[:, None] + np.asarray(st.costs)
        costs = costs[0]
        if not np.any(np.isfinite(costs)):
            return INF
        fc = self._graph.arrays.final_cost[np.asarray(st.states)[0]]
        best = float(np.min(costs))
        with np.errstate(invalid="ignore"):
            best_final = float(np.min(costs + fc))
        if not np.isfinite(best_final):
            return INF
        return best_final - best

    def get_raw_lattice(self, use_final_probs: bool = True) -> Tuple[bool, Lattice]:
        if self._finalized and not use_final_probs:
            raise RuntimeError(
                "You cannot call finalize_decoding() and then call "
                "get_raw_lattice() with use_final_probs == false"
            )  # lattice-simple-decoder.cc:588-591
        pl = self._pruned(use_final_probs)
        lat = raw_lattice_to_fst(pl, use_final_probs) if pl is not None else None
        if lat is None:
            return False, Lattice()
        return True, lat

    def get_best_path(self, use_final_probs: bool = True) -> Tuple[bool, Lattice]:
        ok, lat = self.get_raw_lattice(use_final_probs)
        if not ok:
            return False, Lattice()
        sp = shortest_path(lat)
        return sp.num_states > 0, sp


class LatticeSimpleDecoder(_StreamingLattice):
    """LatticeSimpleDecoder parity (`lattice-simple-decoder.h:90-320`):
    beam-only pruning, lattice output."""

    def __init__(self, fst, config: Optional[LatticeSimpleDecoderConfig] = None):
        config = config or LatticeSimpleDecoderConfig()
        config.check()
        super().__init__(
            fst,
            dict(beam=config.beam, max_active=INT32_MAX, min_active=0),
            config.lattice_beam,
            config,
        )


class LatticeFasterDecoder(_StreamingLattice):
    """The reference's declared-but-unimplemented decoder, realized:
    lattice generation + max-active/adaptive-beam pruning (BASELINE
    config #3)."""

    def __init__(self, fst, config: Optional[LatticeFasterDecoderConfig] = None):
        config = config or LatticeFasterDecoderConfig()
        config.check()
        super().__init__(
            fst,
            dict(
                beam=config.beam,
                max_active=config.max_active,
                min_active=config.min_active,
                beam_delta=config.beam_delta,
            ),
            config.lattice_beam,
            config,
        )
