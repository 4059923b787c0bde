"""Batched device lattice decoder (LatticeSimple + LatticeFaster capability).

Device side: the same frame-synchronous frontier scan as the Viterbi
decoder, but instead of one backpointer per surviving token it emits **all**
surviving arc candidates per frame as records ``(src_state, arc_id)`` — the
array equivalent of the reference's ``ForwardLink`` lists
(`kaldi-decoder/csrc/lattice-simple-decoder.h:164-180`, created at
`lattice-simple-decoder.cc:393-398` for emitting arcs and `:122-191` for
epsilon arcs).  Records are compacted to a bounded per-frame buffer.

Host side (:mod:`kaldi_decoder_tpu.lattice`): tokens are keyed by
``(frame, state)`` exactly as the reference keys them by Token pointers per
frame; the backward extra-cost sweep, lattice-beam pruning, final-prob
folding and raw-lattice construction reproduce
``FinalizeDecoding``/``PruneForwardLinks``/``GetRawLattice``
(`lattice-simple-decoder.cc:407-420`, `:228-305`, `:584-657`).

The union of LatticeSimpleDecoder semantics with FasterDecoder's
adaptive-beam/max-active pruning is exactly the capability the reference
declares but never implements (`lattice-faster-decoder.cc:12-13` is an
empty stub): record emission rides the same cutoffs the Viterbi frontier
uses.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from kaldi_decoder_tpu.decoders.frontier import (
    NO_ARC,
    FrontierConfig,
    StepState,
    expand_emitting,
    expand_eps,
    start_state,
)
from kaldi_decoder_tpu.fst.csr import CsrGraph
from kaldi_decoder_tpu.fst.pack import PackedGraph
from kaldi_decoder_tpu.ops.cutoff import get_cutoff
from kaldi_decoder_tpu.ops.segment import dedup_select_rec

INF = jnp.inf

# Record-row columns: [src_state, arc_id, dst_state, slack_bits].
REC_COLS = 4


@dataclasses.dataclass(frozen=True)
class LatticeDevConfig:
    """Static lattice-decode parameters: frontier config + record buffers."""

    frontier: FrontierConfig
    # Per-frame emitting-record buffer size.
    em_records: int = 4096
    # Per-eps-iteration record buffer size.
    eps_records: int = 1024
    # Lattice beam used as the device-side link slack filter: a link whose
    # slack (cand_cost - winner_cost(dst)) exceeds this is provably pruned
    # by the backward sweep (extra = extra(dst) + slack >= slack,
    # lattice-simple-decoder.cc:254-296), so it never spends record budget.
    lattice_beam: float = 10.0


def lattice_config_for_graph(
    graph: CsrGraph, frontier: FrontierConfig, em_records=None, eps_records=None,
    lattice_beam: float = 10.0,
) -> LatticeDevConfig:
    # Default: room for every frontier winner plus a slack-selected extra
    # pool (em_records == frontier_size would record winners only — a
    # best-incoming-edge forest, not a lattice).
    em_r = em_records or min(
        frontier.num_candidates, max(4096, frontier.frontier_size + 2048)
    )
    em_r = min(em_r, frontier.num_candidates)
    eps_cands = (
        frontier.frontier_size * (frontier.eps_block_width + 1)
        + frontier.eps_rem_budget
    )
    eps_r = eps_records or min(max(eps_cands // 4, 8), 2048)
    eps_r = min(eps_r, eps_cands)
    return LatticeDevConfig(
        frontier=frontier, em_records=em_r, eps_records=eps_r,
        lattice_beam=float(lattice_beam),
    )


class LatticeStepOut(NamedTuple):
    # Record rows carry REC_COLS columns:
    #   [src_state, arc_id, dst_state, slack_bits(f32)]
    # cols 0-1 are the lattice link (host reconstruction); cols 2-3 feed
    # the device-side backward extra-cost sweep (decoders/sweep.py).
    em_records: jnp.ndarray  # (R_em, 4): links of frame t -> t+1
    eps_records: jnp.ndarray  # (D, R_eps, 4): eps links within frame t+1
    frontier_states: jnp.ndarray  # (K,) tokens of frame t+1
    frontier_costs: jnp.ndarray  # (K,) absolute costs (alpha values)
    num_active: jnp.ndarray
    best_cost: jnp.ndarray
    cutoff: jnp.ndarray
    overflow: jnp.ndarray
    # More distinct in-beam states than frontier slots this frame (hidden
    # max_active=K divergence; see frontier.StepOut.saturated).
    saturated: jnp.ndarray


def eps_iteration_rec(
    st: StepState,
    cutoff_rel,
    pg: PackedGraph,
    cfg: FrontierConfig,
    num_states: int,
    r_eps: int,
    slack_beam: float = INF,
):
    """Epsilon relaxation that also emits link records.

    Unlike the Viterbi variant, *every* in-beam eps candidate becomes a
    record (the reference creates a ForwardLink per eps arc under the
    cutoff, `lattice-simple-decoder.cc:170-186`), while the frontier still
    keeps only per-state minima.
    """
    K = cfg.frontier_size
    active = jnp.isfinite(st.costs) & (st.costs <= cutoff_rel)
    cand = expand_eps(st, active, pg, cfg)
    nvalid = jnp.isfinite(cand.cost) & (cand.cost <= cutoff_rel)
    ncost = jnp.where(nvalid, cand.cost, INF)

    cand_state = jnp.concatenate([st.states, cand.dst])
    cand_cost = jnp.concatenate([st.costs, ncost])
    # Incumbent entries (first K) are carried tokens, not links; their
    # payload is -1 so a stray row would be host-filtered anyway.
    pay_src = jnp.concatenate(
        [jnp.full((K,), -1, jnp.int32), cand.src_state]
    )
    pay_arc = jnp.concatenate(
        [jnp.full((K,), NO_ARC, jnp.int32), cand.arc_id]
    )
    # Budget K + r_eps so fresh winner links never crowd out the slack
    # extras; the record columns come back valid-first (winner links,
    # then ascending slack), so the first r_eps rows ARE the compaction.
    sel = dedup_select_rec(
        cand_state, cand_cost, K, num_states, K + r_eps,
        slack_beam=slack_beam, num_incumbents=K,
        payload=(pay_src, pay_arc), sweep_cols=True,
    )
    rec = jnp.stack(
        [
            sel.recs[0][:r_eps],
            sel.recs[1][:r_eps],
            sel.rec_dst[:r_eps],
            jax.lax.bitcast_convert_type(sel.rec_slack[:r_eps], jnp.int32),
        ],
        axis=-1,
    )
    # A valid row just beyond the slice means links were dropped.
    spill = sel.recs[1][r_eps] >= 0
    # changed: any selected slot won via a fresh candidate (index >= K).
    changed = jnp.any((sel.cand_idx >= K) & jnp.isfinite(sel.costs))
    ovf = cand.overflow | sel.rec_overflow | spill
    sat = sel.num_unique > K
    return StepState(sel.states, sel.costs, st.base), rec, changed, ovf, sat


def eps_closure_rec(
    st: StepState,
    cutoff_rel,
    pg: PackedGraph,
    cfg: FrontierConfig,
    num_states: int,
    r_eps: int,
    slack_beam: float = INF,
):
    D = cfg.eps_iters
    if D == 0:
        f = jnp.bool_(False)
        return st, jnp.full((0, r_eps, REC_COLS), -1, jnp.int32), f, f
    empty = jnp.full((r_eps, REC_COLS), -1, jnp.int32)

    def body(carry, _):
        cur, stop, ovf, sat = carry
        nxt, rec, changed, o, s = eps_iteration_rec(
            cur, cutoff_rel, pg, cfg, num_states, r_eps, slack_beam
        )
        nxt = jax.tree.map(lambda new, old: jnp.where(stop, old, new), nxt, cur)
        rec = jnp.where(stop, empty, rec)
        return (nxt, stop | ~changed, ovf | (~stop & o), sat | (~stop & s)), rec

    f = jnp.bool_(False)
    (st, stop, ovf, sat), recs = jax.lax.scan(
        body, (st, f, f, f), None, length=D
    )
    if not cfg.eps_exact:
        ovf = ovf | ~stop  # cyclic-eps budget: possibly unconverged
    return st, recs, ovf, sat


def lattice_emit_stage(
    st: StepState,
    scores_t: jnp.ndarray,
    pg: PackedGraph,
    fc: FrontierConfig,
    num_states: int,
    r_em: int,
    slack_beam: float = INF,
):
    """Per-utterance lattice emitting stage with record emission."""
    K = fc.frontier_size
    cut = get_cutoff(
        st.costs, fc.beam, fc.max_active, fc.min_active, fc.beam_delta,
        costs_sorted=True,
    )
    active = jnp.isfinite(st.costs) & (st.costs < cut.cutoff)
    cand = expand_emitting(st, active, scores_t, pg, fc)

    best_new = jnp.min(cand.cost)
    next_cutoff = best_new + cut.adaptive_beam
    nvalid = jnp.isfinite(cand.cost) & (cand.cost < next_cutoff)
    ncost = jnp.where(nvalid, cand.cost, INF)

    # Dedup + frontier selection + records in one fused op: winners
    # first (lattice connectivity guaranteed), then smallest-slack
    # extras.  The (src_state, arc_id) record columns ride the sorts as
    # payload operands — no post-hoc gathers.
    # need_idx=False: the lattice path takes no backpointers from the
    # frontier (links come from the record columns), so the sort skips
    # the candidate-index operand (~one of five operands of the frame's
    # biggest sort).
    sel = dedup_select_rec(
        cand.dst, ncost, K, num_states, r_em, slack_beam=slack_beam,
        payload=(cand.src_state, cand.arc_id), sweep_cols=True,
        need_idx=False,
    )
    em_rec = jnp.stack(
        sel.recs
        + (
            sel.rec_dst,
            jax.lax.bitcast_convert_type(sel.rec_slack, jnp.int32),
        ),
        axis=-1,
    )
    mid = StepState(sel.states, sel.costs, st.base)
    ovf = cand.overflow | sel.rec_overflow
    sat = sel.num_unique > K
    return mid, em_rec, next_cutoff, st.base + cut.cutoff, ovf, sat


def eps_closure_rec_batched(
    st: StepState,  # batched (B, K)
    cutoff_rel: jnp.ndarray,  # (B,)
    row_active: jnp.ndarray,  # (B,) bool
    pg: PackedGraph,
    fc: FrontierConfig,
    num_states: int,
    r_eps: int,
    slack_beam: float = INF,
):
    """Batch-level record-emitting eps closure with real early exit
    (see frontier.eps_closure_batched). Returns recs (D, B, R, 2)."""
    D = fc.eps_iters
    B = st.states.shape[0]
    if D == 0:
        z = jnp.zeros((B,), bool)
        return st, jnp.full((0, B, r_eps, REC_COLS), -1, jnp.int32), z, z
    recs0 = jnp.full((D, B, r_eps, REC_COLS), -1, jnp.int32)

    def cond(carry):
        it, _, go, _, _, _ = carry
        return (it < D) & go

    def body(carry):
        it, cur, _, ovf, sat, recs = carry
        nxt, rec, changed, o, s = jax.vmap(
            lambda st_, c: eps_iteration_rec(
                st_, c, pg, fc, num_states, r_eps, slack_beam
            )
        )(cur, cutoff_rel)
        recs = jax.lax.dynamic_update_slice(
            recs, rec[None].astype(jnp.int32), (it, 0, 0, 0)
        )
        go = jnp.any(changed & row_active)
        return (
            it + 1, nxt, go, ovf | (o & row_active), sat | (s & row_active), recs
        )

    z = jnp.zeros((B,), bool)
    _, stf, go, ovf, sat, recs = jax.lax.while_loop(
        cond,
        body,
        (jnp.int32(0), st, jnp.bool_(True), z, z, recs0),
    )
    if not fc.eps_exact:
        ovf = ovf | (go & row_active)  # cyclic-eps budget: unconverged
    return stf, recs, ovf, sat


def lattice_frame_step(
    st: StepState,
    scores_t: jnp.ndarray,
    frame_active,
    pg: PackedGraph,
    cfg: LatticeDevConfig,
    num_states: int,
) -> Tuple[StepState, LatticeStepOut]:
    """One lattice frame: emitting expansion with record emission, then
    record-emitting epsilon closure, then rebase."""
    fc = cfg.frontier

    sb = cfg.lattice_beam + 1e-4  # headroom: host prune re-checks in f64
    mid, em_rec, next_cutoff, cutoff_abs, em_ovf, em_sat = lattice_emit_stage(
        st, scores_t, pg, fc, num_states, cfg.em_records, sb
    )
    mid, eps_recs, eps_ovf, eps_sat = eps_closure_rec(
        mid, next_cutoff, pg, fc, num_states, cfg.eps_records, sb
    )

    m = mid.costs[0]
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    out_state = StepState(mid.states, mid.costs - m_safe, mid.base + m_safe)

    final_state = jax.tree.map(
        lambda new, old: jnp.where(frame_active, new, old), out_state, st
    )
    empty_em = jnp.full((cfg.em_records, REC_COLS), -1, jnp.int32)
    empty_eps = jnp.full(
        (fc.eps_iters, cfg.eps_records, REC_COLS), -1, jnp.int32
    )
    out = LatticeStepOut(
        em_records=jnp.where(frame_active, em_rec, empty_em),
        eps_records=jnp.where(frame_active, eps_recs, empty_eps),
        frontier_states=final_state.states,
        frontier_costs=final_state.base + final_state.costs,
        num_active=jnp.sum(jnp.isfinite(final_state.costs)).astype(jnp.int32),
        best_cost=final_state.base,
        cutoff=cutoff_abs,
        overflow=frame_active & (em_ovf | eps_ovf),
        saturated=frame_active & (em_sat | eps_sat),
    )
    return final_state, out


def lattice_frame_step_batched(
    st: StepState,  # (B, K)
    scores_t: jnp.ndarray,  # (B, V)
    frame_active: jnp.ndarray,  # (B,)
    pg: PackedGraph,
    cfg: LatticeDevConfig,
    num_states: int,
) -> Tuple[StepState, LatticeStepOut]:
    """Whole-batch lattice frame: vmapped emit stage + batch-level
    record-emitting eps closure with real early exit."""
    fc = cfg.frontier
    B = st.states.shape[0]

    sb = cfg.lattice_beam + 1e-4
    mid, em_rec, next_cutoff, cutoff_abs, em_ovf, em_sat = jax.vmap(
        lambda s, sc: lattice_emit_stage(
            s, sc, pg, fc, num_states, cfg.em_records, sb
        )
    )(st, scores_t)
    mid, recs, eps_ovf, eps_sat = eps_closure_rec_batched(
        mid, next_cutoff, frame_active, pg, fc, num_states, cfg.eps_records, sb
    )
    eps_recs = jnp.moveaxis(recs, 0, 1)  # (B, D, R, 2)

    m = mid.costs[:, 0]
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    out_state = StepState(
        mid.states, mid.costs - m_safe[:, None], mid.base + m_safe
    )
    fa = frame_active
    final_state = jax.tree.map(
        lambda new, old: jnp.where(
            fa.reshape((B,) + (1,) * (new.ndim - 1)), new, old
        ),
        out_state,
        st,
    )
    empty_em = jnp.full((B, cfg.em_records, REC_COLS), -1, jnp.int32)
    empty_eps = jnp.full(
        (B, fc.eps_iters, cfg.eps_records, REC_COLS), -1, jnp.int32
    )
    out = LatticeStepOut(
        em_records=jnp.where(fa[:, None, None], em_rec, empty_em),
        eps_records=jnp.where(fa[:, None, None, None], eps_recs, empty_eps),
        frontier_states=final_state.states,
        frontier_costs=final_state.base[:, None] + final_state.costs,
        num_active=jnp.sum(jnp.isfinite(final_state.costs), axis=1).astype(
            jnp.int32
        ),
        best_cost=final_state.base,
        cutoff=cutoff_abs,
        overflow=fa & (em_ovf | eps_ovf),
        saturated=fa & (em_sat | eps_sat),
    )
    return final_state, out


def init_closure_rec(pg, start: int, num_states: int, cfg: LatticeDevConfig):
    """InitDecoding + its eps closure, emitting records
    (`lattice-simple-decoder.cc:17-34`)."""
    return _build_init_rec_fn(num_states, cfg)(pg, jnp.int32(start))


@functools.lru_cache(maxsize=None)
def _build_init_rec_fn(S: int, cfg: LatticeDevConfig):
    def init(pg, start):
        st = start_state(start, cfg.frontier)
        st, recs, _, _ = eps_closure_rec(
            st, jnp.float32(INF), pg, cfg.frontier, S, cfg.eps_records,
            cfg.lattice_beam + 1e-4,
        )
        return st, recs

    return jax.jit(init)


def build_lattice_chunk_fn(
    graph: CsrGraph, cfg: LatticeDevConfig, mesh=None, data_axis="data"
):
    return _build_lattice_chunk_fn_cached(graph.num_states, cfg, mesh, data_axis)


@functools.lru_cache(maxsize=None)
def _build_lattice_chunk_fn_cached(
    S: int, cfg: LatticeDevConfig, mesh, data_axis: str
):
    # Cached on static info only (see viterbi._build_chunk_fn_cached).
    def chunk(pg, scores, lengths, st0: StepState):
        scores_tm = jnp.moveaxis(scores, 1, 0)

        def body(st, inp):
            scores_t, t = inp
            active = t < lengths
            return lattice_frame_step_batched(st, scores_t, active, pg, cfg, S)

        ts = jnp.arange(scores_tm.shape[0], dtype=jnp.int32)
        stf, outs = jax.lax.scan(body, st0, (scores_tm, ts))
        return stf, outs

    if mesh is None:
        return jax.jit(chunk)
    from jax.sharding import NamedSharding, PartitionSpec as P

    repl = NamedSharding(mesh, P())
    batch = NamedSharding(mesh, P(data_axis))
    tb = NamedSharding(mesh, P(None, data_axis))
    return jax.jit(
        chunk,
        in_shardings=(repl, batch, batch, StepState(batch, batch, batch)),
        out_shardings=(
            StepState(batch, batch, batch),
            LatticeStepOut(*([tb] * len(LatticeStepOut._fields))),
        ),
    )
