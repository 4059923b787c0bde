"""Batched device Viterbi decoder (the FasterDecoder capability).

One jitted ``lax.scan`` over frames advances B utterances in lockstep
(reference: one-utterance-at-a-time Python loops, SURVEY §2.5); each frame
runs :func:`kaldi_decoder_tpu.decoders.frontier.frame_step` (GetCutoff +
arc expansion + dedup + eps closure) vmapped over the batch.  Per-frame
backpointers ``(prev_slot, arc_id)`` are logged to device memory and
downloaded once; the host reconstructs best paths by walking them
backwards, exactly like the reference's ``Token::prev_`` chain walk
(`kaldi-decoder/csrc/faster-decoder.cc:356-424`) including the
(graph_cost, acoustic_cost) split per arc and the final-prob preference
rules, and finishes with RemoveEpsLocal (`faster-decoder.cc:422`).

Shapes are static per (B, T, V); decode() pads and caches the compiled
executable per shape bucket.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_decoder_tpu.decoders.frontier import (
    NO_ARC,
    FrontierConfig,
    StepOut,
    StepState,
    config_for_graph,
    init_closure,
)
from kaldi_decoder_tpu.fst.csr import CsrGraph
from kaldi_decoder_tpu.fst.fst import INF, Lattice
from kaldi_decoder_tpu.fst.pack import pack_graph_device
from kaldi_decoder_tpu.fst.ops import remove_eps_local
from kaldi_decoder_tpu.utils.logging import DecodeStats, get_logger

logger = get_logger()

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Jitted chunk function
# ---------------------------------------------------------------------------


def build_chunk_fn(graph: CsrGraph, cfg: FrontierConfig, mesh=None, data_axis="data"):
    """Returns jitted fn(ga, scores(B,T,V), lengths(B,), st0) -> (stF, outs).

    ``lengths`` counts frames *within this chunk* still to decode (frames
    t >= lengths are no-ops, freezing that utterance's frontier) — this is
    what makes streaming AdvanceDecoding and ragged batches work.

    With ``mesh`` set, the graph is replicated and every batch-leading
    array (scores, lengths, carried frontier, outputs) is sharded over
    ``data_axis`` — data-parallel decode across chips with no collectives
    in the hot loop.
    """
    return _build_chunk_fn_cached(graph.num_states, cfg, mesh, data_axis)


@functools.lru_cache(maxsize=None)
def _build_chunk_fn_cached(S: int, cfg: FrontierConfig, mesh, data_axis: str):
    # Cached on static info only — the graph's arrays are runtime args, so
    # one compiled executable serves every decoder instance with the same
    # state count, config and array shapes (jit re-specializes on shapes).
    from kaldi_decoder_tpu.decoders.frontier import frame_step_batched

    def chunk(pg, scores, lengths, st0: StepState):
        scores_tm = jnp.moveaxis(scores, 1, 0)  # (T, B, V)
        T = scores_tm.shape[0]

        def body(st, inp):
            scores_t, t = inp
            active = t < lengths
            return frame_step_batched(st, scores_t, active, pg, cfg, S)

        ts = jnp.arange(T, dtype=jnp.int32)
        stf, outs = jax.lax.scan(body, st0, (scores_tm, ts))
        return stf, outs

    if mesh is None:
        return jax.jit(chunk)
    from jax.sharding import NamedSharding, PartitionSpec as P

    repl = NamedSharding(mesh, P())
    batch = NamedSharding(mesh, P(data_axis))
    time_batch = NamedSharding(mesh, P(None, data_axis))
    return jax.jit(
        chunk,
        in_shardings=(repl, batch, batch, StepState(batch, batch, batch)),
        out_shardings=(
            StepState(batch, batch, batch),
            StepOut(*([time_batch] * len(StepOut._fields))),
        ),
    )


@functools.lru_cache(maxsize=None)
def _build_init_fn(S: int, cfg: FrontierConfig):
    def init(pg, start):
        return init_closure(pg, start, S, cfg)

    return jax.jit(init)


def _batched_init(pg_dev, graph: CsrGraph, cfg: FrontierConfig, batch: int):
    """Initial frontier (start state + eps closure) broadcast over B."""
    st, bp_init = _build_init_fn(graph.num_states, cfg)(
        pg_dev, jnp.int32(graph.start_state)
    )
    stb = StepState(
        states=jnp.broadcast_to(st.states, (batch,) + st.states.shape),
        costs=jnp.broadcast_to(st.costs, (batch,) + st.costs.shape),
        base=jnp.broadcast_to(st.base, (batch,)),
    )
    return stb, np.asarray(bp_init)


def _maybe_fold(graph: CsrGraph, fold: bool):
    """Eps precomposition when beneficial (acyclic, nonneg, bounded)."""
    if not fold or not graph.has_eps:
        return None
    from kaldi_decoder_tpu.fst.fold import fold_eps

    return fold_eps(graph)


_CAPACITY_FIELDS = (
    "frontier_size",
    "block_width",
    "rem_budget",
    "eps_block_width",
    "eps_rem_budget",
    "eps_iters",
)


def _cfg_for_device_graph(dev_graph: CsrGraph, config: Optional[FrontierConfig]):
    """Config sized for the (possibly eps-folded) device graph.

    Reference-semantic fields (beam/max_active/...) always come from the
    caller.  Capacity fields the caller set *explicitly* (recorded by
    ``config_for_graph``, or all of them for a hand-built config) are kept;
    only unset capacities are re-derived for the transformed graph.  The
    eps capacities are forced to match the device graph's actual eps
    structure either way (a folded graph has none; a cyclic-eps graph
    needs iterations even if the caller's config predates folding).
    """
    if config is None:
        return config_for_graph(dev_graph)
    keep = _CAPACITY_FIELDS if config.explicit is None else tuple(
        f for f in _CAPACITY_FIELDS if f in config.explicit
    )
    kw = {f: getattr(config, f) for f in keep}
    if not dev_graph.has_eps:
        # Eps fields are meaningless on an eps-free device graph; let
        # config_for_graph's eps-free branch zero them out.
        for f in ("eps_block_width", "eps_rem_budget", "eps_iters"):
            kw.pop(f, None)
    elif config.eps_iters == 0:
        # Config was built for an eps-free graph; re-derive eps fields.
        for f in ("eps_block_width", "eps_rem_budget", "eps_iters"):
            kw.pop(f, None)
    return config_for_graph(
        dev_graph,
        beam=config.beam,
        max_active=config.max_active,
        min_active=config.min_active,
        beam_delta=config.beam_delta,
        **kw,
    )


def _folded_init(fold, cfg: FrontierConfig, batch: int):
    """Initial frontier from the host-computed start closure."""
    K = cfg.frontier_size
    sc = fold.start
    n = min(len(sc.states), K)
    order = np.argsort(sc.costs, kind="stable")[:n]
    states = np.zeros(K, np.int32)
    costs = np.full(K, np.float32(np.inf))
    states[:n] = sc.states[order]
    costs[:n] = sc.costs[order]
    stb = StepState(
        states=jnp.broadcast_to(jnp.asarray(states), (batch, K)),
        costs=jnp.broadcast_to(jnp.asarray(costs), (batch, K)),
        base=jnp.zeros((batch,), jnp.float32),
    )
    bp_init = np.zeros((0, K, 2), np.int32)
    return stb, bp_init


# ---------------------------------------------------------------------------
# Results + host backtrace
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ViterbiResult:
    """Host-side decode result for a batch.

    Backpointer layout per utterance: the init closure's (D, K, 2) block,
    then per frame an emitting (K, 2) block and a (D, K, 2) eps block.

    With ``fold`` set (eps-precomposed decode,
    :mod:`kaldi_decoder_tpu.fst.fold`), D == 0, arcs in ``bp_emit`` are
    folded ids, and ``graph`` is the ORIGINAL graph — the backtrace
    expands each folded arc into its original arc path.
    """

    graph: CsrGraph
    cfg: FrontierConfig
    scores: np.ndarray  # (B, T, V) float32 (unpadded view)
    lengths: np.ndarray  # (B,) int32
    bp_init: np.ndarray  # (D, K, 2)
    bp_emit: np.ndarray  # (T, B, K, 2)
    bp_eps: np.ndarray  # (T, B, D, K, 2)
    frontier_states: np.ndarray  # (B, K) int32
    frontier_costs: np.ndarray  # (B, K) float32, absolute
    num_active: np.ndarray  # (T, B)
    best_costs: np.ndarray  # (T, B) absolute best cost per frame
    cutoffs: np.ndarray  # (T, B)
    overflows: np.ndarray  # (T, B) bool
    saturations: np.ndarray  # (T, B) bool — frontier capacity hit
    fold: object = None  # Optional[FoldedGraph]
    # Wall-clock seconds of the batch device decode incl. one sync
    # fetch (remaining result downloads happen outside the timer).
    wall_seconds: float = 0.0

    @property
    def batch_size(self) -> int:
        return self.scores.shape[0]

    # -- final-frame semantics (faster-decoder.cc:347-390) -------------------

    def _final_costs(self, b: int) -> np.ndarray:
        states = self.frontier_states[b]
        return self.graph.arrays.final_cost[states]

    def reached_final(self, b: int = 0) -> bool:
        costs = self.frontier_costs[b]
        return bool(np.any(np.isfinite(costs) & np.isfinite(self._final_costs(b))))

    def final_relative_cost(self, b: int = 0) -> float:
        """simple-decoder.cc:78-100 semantics (INF when nothing survived)."""
        costs = self.frontier_costs[b]
        if not np.any(np.isfinite(costs)):
            return INF
        best = float(np.min(costs))
        with np.errstate(invalid="ignore"):
            best_final = float(np.min(costs + self._final_costs(b)))
        extra = best_final - best
        return INF if np.isnan(extra) else extra

    def best_cost(self, b: int = 0, use_final_probs: bool = True) -> float:
        costs = self.frontier_costs[b].copy()
        if use_final_probs and self.reached_final(b):
            costs = costs + self._final_costs(b)
        return float(np.min(costs))

    def _best_slot(self, b: int, use_final_probs: bool) -> Optional[int]:
        costs = self.frontier_costs[b].copy()
        if not np.any(np.isfinite(costs)):
            return None
        if use_final_probs and self.reached_final(b):
            costs = costs + self._final_costs(b)
            if not np.any(np.isfinite(costs)):
                return None
        return int(np.argmin(costs))

    # -- backtrace ------------------------------------------------------------

    def best_path(self, b: int = 0, use_final_probs: bool = True) -> Optional[Lattice]:
        """Best path as a linear lattice (GetBestPath parity,
        `faster-decoder.cc:356-424`), or None if no tokens survived."""
        slot = self._best_slot(b, use_final_probs)
        if slot is None:
            return None
        ga = self.graph.arrays
        L = int(self.lengths[b])
        D = self.cfg.eps_iters
        is_final = use_final_probs and self.reached_final(b)
        final_state = int(self.frontier_states[b, slot])

        from kaldi_decoder_tpu import native

        if native.available():
            fwd = native.backtrace(
                slot,
                self.bp_init,
                np.ascontiguousarray(self.bp_emit[:L, b]),
                np.ascontiguousarray(self.bp_eps[:L, b]),
            )
            if fwd is None:
                logger.warning("backtrace hit a dead slot (utt %d)", b)
                return None
            rev = [(bool(e[0]), int(e[1]), int(e[2])) for e in fwd[::-1]]
        else:
            # Arc list built back-to-front: (is_eps, arc_id, frame).
            rev = []

            def walk_eps(bp_block, frame):
                nonlocal slot
                for d in range(D - 1, -1, -1):
                    prev_slot, arc = (
                        int(bp_block[d, slot, 0]),
                        int(bp_block[d, slot, 1]),
                    )
                    if arc != NO_ARC:
                        rev.append((True, arc, frame))
                    slot = prev_slot

            for t in range(L - 1, -1, -1):
                walk_eps(self.bp_eps[t, b], t)
                prev_slot, arc = (
                    int(self.bp_emit[t, b, slot, 0]),
                    int(self.bp_emit[t, b, slot, 1]),
                )
                if arc == NO_ARC:
                    # Dead backpointer on an active frame: search failure.
                    logger.warning(
                        "backtrace hit a dead slot at frame %d (utt %d)", t, b
                    )
                    return None
                rev.append((False, arc, t))
                slot = prev_slot
            walk_eps(self.bp_init, -1)

        fwd_arcs = list(reversed(rev))
        if self.fold is not None:
            fwd_arcs = self._expand_folded(fwd_arcs, final_state)

        out = Lattice()
        cur = out.add_state()
        out.set_start(cur)
        for is_eps, arc, t in fwd_arcs:
            nxt = out.add_state()
            if is_eps:
                out.add_arc(
                    cur, 0, int(ga.eps_olabel[arc]),
                    (float(ga.eps_weight[arc]), 0.0), nxt,
                )
            else:
                g = float(ga.em_weight[arc])
                ac = -float(self.scores[b, t, int(ga.em_score_idx[arc])])
                out.add_arc(
                    cur, int(ga.em_ilabel[arc]), int(ga.em_olabel[arc]), (g, ac), nxt
                )
            cur = nxt
        if is_final:
            out.set_final(cur, (float(ga.final_cost[final_state]), 0.0))
        else:
            out.set_final(cur, (0.0, 0.0))
        return remove_eps_local(out)

    def _expand_folded(self, fwd_arcs, final_state: int):
        """Map folded arc ids back to original-arc sequences and prepend
        the start state's eps path (see fst/fold.py)."""
        f = self.fold
        orig = f.orig.arrays
        out = []
        # Initial eps path: from start to the first emitting arc's source
        # state (or to the final state when no frames were decoded).
        if fwd_arcs:
            first_em = f.em_arc_of(np.int64(fwd_arcs[0][1]))
            s0 = int(
                np.searchsorted(orig.em_row_ptr, int(first_em), side="right") - 1
            )
        else:
            s0 = final_state
        where = np.flatnonzero(f.start.states == s0)
        if len(where):
            for a in f.start.paths[int(where[0])]:
                out.append((True, int(a), -1))
        for is_eps, arc, t in fwd_arcs:
            assert not is_eps, "folded decode emits no device eps arcs"
            lo, hi = int(f.path_ptr[arc]), int(f.path_ptr[arc + 1])
            out.append((False, int(f.path_arcs[lo]), t))
            for a in f.path_arcs[lo + 1 : hi]:
                out.append((True, int(a), t))
        return out

    def stats(self, b: int = 0) -> DecodeStats:
        L = int(self.lengths[b])
        return DecodeStats(
            num_frames=L,
            active_per_frame=self.num_active[:L, b],
            best_cost_per_frame=self.best_costs[:L, b],
            cutoff_per_frame=self.cutoffs[:L, b],
            arc_budget_overflows=int(np.sum(self.overflows[:L, b])),
            frontier_saturated_frames=int(np.sum(self.saturations[:L, b])),
            wall_seconds=self.wall_seconds,
            batch_frames=int(np.sum(self.lengths)),
        )


# ---------------------------------------------------------------------------
# Decoder object
# ---------------------------------------------------------------------------


class BatchedViterbiDecoder:
    """Best-path WFST decoder over a device-resident CSR graph.

    Device equivalent of ``FasterDecoder`` (`faster-decoder.h:65-200`)
    with utterance batching.  Construct once per graph; ``decode`` accepts
    ``(T, V)`` or ``(B, T, V)`` log-prob arrays.
    """

    def __init__(
        self,
        graph: CsrGraph,
        config: Optional[FrontierConfig] = None,
        pad_time_to: int = 128,
        mesh=None,
        data_axis: str = "data",
        fold: bool = True,
    ):
        self.graph = graph
        self.fold = _maybe_fold(graph, fold)
        dev_graph = self.fold.device if self.fold is not None else graph
        self._dev_graph = dev_graph
        self.cfg = _cfg_for_device_graph(dev_graph, config)
        self.cfg.validate()
        self.pad_time_to = pad_time_to
        self.mesh = mesh
        self._batch_multiple = mesh.devices.size if mesh is not None else 1
        self._pg_dev = pack_graph_device(
            dev_graph, self.cfg.block_width, self.cfg.eps_block_width,
            self.cfg.flat_group,
        )
        self._chunk_fn = build_chunk_fn(dev_graph, self.cfg, mesh, data_axis)

    def decode(
        self,
        scores: np.ndarray,
        lengths: Optional[np.ndarray] = None,
    ) -> ViterbiResult:
        scores = np.asarray(scores, dtype=np.float32)
        if scores.ndim == 2:
            scores = scores[None]
        B, T, V = scores.shape
        if self.graph.max_score_idx >= V:
            raise ValueError(
                f"graph references score index {self.graph.max_score_idx} but "
                f"scores have only {V} columns (graph ilabels are 1-based: "
                f"need V >= max ilabel - 1; decodable-ctc.cc:22-29)"
            )
        if lengths is None:
            lengths = np.full((B,), T, np.int32)
        lengths = np.asarray(lengths, dtype=np.int32)

        Tp = max(_round_up(T, self.pad_time_to), self.pad_time_to)
        Bp = _round_up(B, self._batch_multiple)
        if Tp != T or Bp != B:
            scores_p = np.zeros((Bp, Tp, V), np.float32)
            scores_p[:B, :T] = scores
            lengths_p = np.zeros((Bp,), np.int32)
            lengths_p[:B] = lengths
        else:
            scores_p, lengths_p = scores, lengths

        if self.fold is not None:
            st0, bp_init = _folded_init(self.fold, self.cfg, Bp)
        else:
            st0, bp_init = _batched_init(self._pg_dev, self.graph, self.cfg, Bp)
        from kaldi_decoder_tpu.utils.profiling import WallTimer, annotate

        with WallTimer() as timer, annotate("kdtpu.viterbi_decode"):
            stf, outs = self._chunk_fn(
                self._pg_dev, jnp.asarray(scores_p), jnp.asarray(lengths_p), st0
            )
            # Host fetches below double as the device sync barrier; pull
            # one array inside the timed region so dispatch isn't free.
            bp_emit = np.asarray(outs.bp_emit)
        return ViterbiResult(
            graph=self.graph,
            cfg=self.cfg,
            scores=scores,
            lengths=lengths,
            bp_init=bp_init,
            fold=self.fold,
            wall_seconds=timer.elapsed,
            bp_emit=bp_emit,
            bp_eps=np.asarray(outs.bp_eps),
            frontier_states=np.asarray(stf.states),
            frontier_costs=np.asarray(stf.base)[:, None] + np.asarray(stf.costs),
            num_active=np.asarray(outs.num_active),
            best_costs=np.asarray(outs.best_cost),
            cutoffs=np.asarray(outs.cutoff),
            overflows=np.asarray(outs.overflow),
            saturations=np.asarray(outs.saturated),
        )
