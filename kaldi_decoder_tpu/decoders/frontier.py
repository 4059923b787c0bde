"""Device token-frontier machinery: the per-frame decoding step.

This is the device core of the framework.  The reference's per-frame
work — ``ProcessEmitting`` over a hash-indexed token list
(`kaldi-decoder/csrc/faster-decoder.cc:155-241`) followed by a
``ProcessNonemitting`` epsilon worklist (`faster-decoder.cc:59-119`) —
becomes a fixed-shape array program:

1. cutoff/adaptive-beam from the (cost-sorted) frontier
   (:mod:`kaldi_decoder_tpu.ops.cutoff`, GetCutoff parity);
2. **block expansion**: one row gather pulls each frontier state's first W
   packed arcs (:mod:`kaldi_decoder_tpu.fst.pack`) — W chosen to cover
   ~p70 of out-degrees, so the common case is a single fully regular
   gather + broadcast; a **remainder path** (scatter+cummax lane mapping,
   :func:`kaldi_decoder_tpu.ops.segment.map_lanes`) covers fat states
   exactly;
3. the acoustic gather ``-scores[t, score_idx]`` fused into the expansion
   (the reference's per-arc virtual ``LogLikelihood`` call,
   `faster-decoder.cc:209`);
4. post-hoc beam prune at ``best_new + adaptive_beam``.  The C++ evolves
   ``next_weight_cutoff`` token-by-token (`faster-decoder.cc:192-230`),
   an order-dependent upper bound of this value; pruning at the final
   bound is tighter but never drops a token the reference's final cutoff
   keeps, so results agree;
5. scatter-min dedup by destination state + top-K frontier selection
   (replaces ``HashList::Insert`` collisions);
6. bounded epsilon-closure iteration with the same block+remainder
   expansion (the worklist's fixed point; iteration count = precomputed
   eps depth, with early-out).

Costs are kept *relative* to a carried per-utterance base (the per-frame
minimum is subtracted and accumulated), so float32 stays precise for
arbitrarily long utterances — the reference needs double accumulators
instead (`faster-decoder.h:119`); the same idea is hinted at in
`lattice-faster-decoder.h:174-175`.

Everything here is single-utterance; batching is ``vmap`` outside.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from kaldi_decoder_tpu.fst.csr import CsrGraph
from kaldi_decoder_tpu.fst.pack import EM_FIELDS, EPS_FIELDS, PackedGraph
from kaldi_decoder_tpu.ops.cutoff import get_cutoff
from kaldi_decoder_tpu.ops.segment import dedup_select, score_lookup

INF = jnp.inf

# Backpointer arc-id sentinel: "no arc, token carried over" (identity).
NO_ARC = -1


@dataclasses.dataclass(frozen=True)
class FrontierConfig:
    """Static (shape-determining) decode parameters.

    ``beam``/``max_active``/``min_active``/``beam_delta`` carry the exact
    reference semantics (`faster-decoder.h:24-63`); the rest are static shape
    capacities with no reference analogue (the C++ grows its hash instead,
    `faster-decoder.cc:338-345`).
    """

    beam: float = 16.0
    max_active: int = 2**31 - 1
    min_active: int = 20
    beam_delta: float = 0.5
    # Frontier capacity K: max unique states tracked per frame.
    frontier_size: int = 2048
    # Emitting block width W: arcs per state expanded via the regular
    # block path; arcs beyond W go through the remainder lanes.
    block_width: int = 8
    # Flat lane budget for emitting remainder arcs (fat states).
    rem_budget: int = 4096
    # Epsilon block width and remainder budget.
    eps_block_width: int = 4
    eps_rem_budget: int = 1024
    # Emitting arcs per remainder row gather (fst/pack.py FLAT_GROUP).
    # Big groups cut the remainder gather count; ragged ends waste ~G/2
    # lanes per fat state.
    flat_group: int = 4
    # Epsilon-closure iterations per frame (graph eps depth if known).
    eps_iters: int = 0
    # True when eps_iters equals the graph's exact (acyclic) eps depth.
    # False = cyclic-eps fallback: eps_iters is a fixed-point iteration
    # budget, and a frame whose LAST iteration still improved a token is
    # flagged via the overflow output (the closure may be incomplete —
    # `faster-decoder.cc:59-119`'s worklist has no such bound, so this is
    # the one place the device decoder can silently under-relax without it).
    eps_exact: bool = True
    # Which capacity fields the caller set explicitly.  None == hand-built
    # config (every field intentional); config_for_graph records the
    # caller-passed keys so capacity re-derivation for a transformed
    # (e.g. eps-folded) device graph preserves explicit tuning.  Excluded
    # from eq/hash: it never changes the compiled program.
    explicit: Optional[Tuple[str, ...]] = dataclasses.field(
        default=None, compare=False, repr=False
    )

    def validate(self) -> None:
        if self.beam <= 0:
            raise ValueError("beam must be > 0")
        if self.max_active <= 1:
            raise ValueError("max_active must be > 1")  # faster-decoder.cc:27
        if not (0 <= self.min_active < self.max_active):
            raise ValueError("need 0 <= min_active < max_active")
        if self.frontier_size < 1 or self.block_width < 1:
            raise ValueError("frontier_size and block_width must be >= 1")
        if self.rem_budget < 1 or self.eps_rem_budget < 1:
            raise ValueError("lane budgets must be >= 1")

    @property
    def expand_lanes(self) -> int:
        """Frontier prefix length the emitting expansion reads.

        The frontier is cost-sorted and ``GetCutoff`` admits at most
        ``max_active`` tokens under its strict ``<`` cutoff in every
        branch (`faster-decoder.cc:297-336`: the max-active branch cuts
        at the (max_active+1)-th order statistic; the min-active branch
        at the (min_active+1)-th with min_active < max_active; the beam
        branch only fires when the max-active statistic already bounds
        the strict count), so active lanes are always a prefix of length
        <= max_active: lanes beyond it need no arc gather at all.  This
        is the single biggest HBM-gather saving at bench shapes
        (K=4096, max_active=3000 -> 25% fewer block rows and candidate
        lanes)."""
        if self.max_active >= self.frontier_size:
            return self.frontier_size
        return min(
            self.frontier_size, max(8, -(-self.max_active // 8) * 8)
        )

    @property
    def num_candidates(self) -> int:
        units = -(-self.rem_budget // self.flat_group)
        return self.expand_lanes * self.block_width + units * self.flat_group


def _next_pow2(x: int) -> int:
    return 1 << max(3, (x - 1).bit_length())


def config_for_graph(graph: CsrGraph, base: Optional[FrontierConfig] = None, **kw):
    """Derive a FrontierConfig with capacities sized for ``graph``."""
    import numpy as np

    cfg = base or FrontierConfig()
    kw.pop("explicit", None)
    explicit = tuple(sorted(kw))
    kw.setdefault("beam", cfg.beam)
    kw.setdefault("max_active", cfg.max_active)
    kw.setdefault("min_active", cfg.min_active)
    kw.setdefault("beam_delta", cfg.beam_delta)
    kw.setdefault("flat_group", cfg.flat_group)

    K = kw.get("frontier_size", cfg.frontier_size)
    K = max(8, min(K, _next_pow2(max(graph.num_states, 2))))
    kw["frontier_size"] = K

    # Block lanes cost one row gather per frontier state; remainder
    # lanes cost a row gather per FLAT_GROUP arcs plus downstream
    # sort/score work per lane.  W ~ p70 of out-degrees balances block
    # lanes against expected remainder mass; the remainder budget is sized
    # to ~2x the expected tail so overflow (flagged, never silent) is
    # rare.
    deg = np.diff(graph.arrays.em_row_ptr)
    nz = deg[deg > 0]
    p70 = int(np.quantile(nz, 0.7)) if len(nz) else 1
    W = kw.get("block_width", max(1, min(p70, 24, graph.max_em_out_degree or 1)))
    kw["block_width"] = max(1, W)

    if "rem_budget" not in kw:
        # ~2x expected remainder lanes for a full frontier, plus slack.
        exp_rem = float(np.maximum(nz - W, 0).mean()) if len(nz) else 0.0
        rem = int(max(2048, min(6 * K, 2 * exp_rem * K + 2048)))
        kw["rem_budget"] = min(rem, max(graph.num_emitting_arcs, 8))
    kw["rem_budget"] = max(8, kw["rem_budget"])

    if graph.num_eps_arcs:
        edeg = np.diff(graph.arrays.eps_row_ptr)
        enz = edeg[edeg > 0]
        ep50 = int(np.quantile(enz, 0.5)) if len(enz) else 1
        We = kw.get(
            "eps_block_width",
            max(1, min(ep50, 8, graph.max_eps_out_degree or 1)),
        )
        kw["eps_block_width"] = max(1, We)
        kw["eps_rem_budget"] = max(
            8, kw.get("eps_rem_budget", min(max(512, K // 2), graph.num_eps_arcs))
        )
        depth = graph.eps_depth
        if depth is None:
            depth = 16  # cyclic eps subgraph: bounded fixed-point iterations
            kw.setdefault("eps_exact", False)
        kw.setdefault("eps_iters", depth)
    else:
        kw["eps_block_width"] = 1
        kw["eps_rem_budget"] = 8
        kw["eps_iters"] = 0
    out = FrontierConfig(explicit=explicit, **kw)
    out.validate()
    return out


class StepState(NamedTuple):
    """Carried frontier: states/costs sorted by increasing cost.

    ``costs`` are relative to ``base``; absolute cost = base + costs.
    Empty slots have cost +inf.
    """

    states: jnp.ndarray  # (K,) int32
    costs: jnp.ndarray  # (K,) float32
    base: jnp.ndarray  # () float32


class Candidates(NamedTuple):
    """Flat candidate arcs from one expansion (block + remainder lanes)."""

    dst: jnp.ndarray  # (N,) int32
    cost: jnp.ndarray  # (N,) float32, +inf invalid
    src_slot: jnp.ndarray  # (N,) int32
    # Source STATE per lane (st.states[src_slot], materialized for free at
    # expansion: a broadcast for block lanes, and it rides the remainder
    # path's existing owner-indexed gathers).  Lattice record payload —
    # XLA dead-code-eliminates it for the Viterbi decoder, which only
    # uses src_slot.
    src_state: jnp.ndarray  # (N,) int32
    arc_id: jnp.ndarray  # (N,) int32, global arc index
    overflow: jnp.ndarray  # () bool — remainder budget exceeded


def _bitcast_f32(x: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.bitcast_convert_type(x, jnp.float32)


def _owner_of_lanes(n_units: jnp.ndarray, budget: int):
    """Map ``budget`` flat lanes to their owning slots.

    Given per-slot unit counts, returns the 3-tuple ``(owner, starts,
    total)``: ``owner[(budget,)]`` — which slot owns each lane (segment
    starts scattered + running max; :func:`map_lanes` semantics but
    withOUT the per-lane ``within`` gathers — callers recover per-slot
    fields through one fused info-row gather indexed by ``owner``
    instead); ``starts[(K,)]`` — each slot's first lane (exclusive prefix
    sum of ``n_units``); ``total`` () — total units requested (lanes
    beyond it are invalid; ``total > budget`` means overflow)."""
    K = n_units.shape[0]
    csum = jnp.cumsum(n_units)
    starts = csum - n_units
    slot_ids = jnp.arange(K, dtype=jnp.int32)
    owner0 = jnp.zeros(budget, jnp.int32).at[
        jnp.where(n_units > 0, starts, budget)
    ].max(slot_ids, mode="drop")
    return jax.lax.associative_scan(jnp.maximum, owner0), starts, csum[-1]


def expand_emitting(
    st: StepState,
    active: jnp.ndarray,  # (K,) bool
    scores_t: jnp.ndarray,  # (V,) float32
    pg: PackedGraph,
    cfg: FrontierConfig,
) -> Candidates:
    K, W = cfg.expand_lanes, cfg.block_width
    R = cfg.rem_budget
    if K < cfg.frontier_size:
        # Cost-sorted frontier + GetCutoff's <=max_active guarantee:
        # lanes beyond the prefix are never active (see
        # FrontierConfig.expand_lanes) — slot ids stay valid because the
        # prefix preserves slot numbering.
        st = StepState(st.states[:K], st.costs[:K], st.base)
        active = active[:K]
    safe = jnp.where(active, st.states, 0)

    # Block lanes: ONE row gather of (K, W*5+2) -> every field of the first
    # W arcs of every frontier state, plus its [row_lo, deg] header (saves
    # two separate row_ptr element gathers).
    row = pg.em_block[safe]
    row_lo = row[:, W * EM_FIELDS]
    deg = jnp.where(active, row[:, W * EM_FIELDS + 1], 0)
    blk = row[:, : W * EM_FIELDS].reshape(K, W, EM_FIELDS)
    w_arc = _bitcast_f32(blk[..., 0])  # +inf on padding lanes
    nxt = blk[..., 1]
    sidx = blk[..., 2]
    lane_w = jnp.arange(W, dtype=jnp.int32)
    cost_blk = jnp.where(
        active[:, None], st.costs[:, None] + w_arc, INF
    )
    arc_blk = row_lo[:, None] + lane_w[None, :]
    src_blk = jnp.broadcast_to(
        jnp.arange(K, dtype=jnp.int32)[:, None], (K, W)
    )

    # Remainder lanes: arcs W.. of fat states, exact via lane mapping over
    # flat_group-arc units — each row gather covers G arcs (see
    # fst/pack.py).  Every per-slot field a remainder lane needs (unit
    # base, segment start, tail range, cost, state) rides ONE fused
    # info-row gather indexed by the lane's owner, where the naive
    # formulation needs seven element gathers.
    G = cfg.flat_group
    Ru = -(-R // G)
    tail_lo = row_lo + W
    tail_hi = row_lo + deg
    has_rem = deg > W
    u_first = jnp.where(has_rem, tail_lo // G, 0)
    n_units = jnp.where(has_rem, (tail_hi - 1) // G - u_first + 1, 0)
    owner, starts, total = _owner_of_lanes(n_units, Ru)
    info = jnp.stack(
        [
            u_first - starts,  # unit = this + lane index
            tail_lo,
            tail_hi,
            jax.lax.bitcast_convert_type(st.costs, jnp.int32),
            safe,
        ],
        axis=1,
    )
    j = jnp.arange(Ru, dtype=jnp.int32)
    io = info[owner]  # (Ru, 5): the ONE per-slot gather
    valid = j < total
    unit = io[:, 0] + j
    rows = pg.em_flat[jnp.where(valid, unit, 0)].reshape(Ru, G, EM_FIELDS)
    arc_rem = unit[:, None] * G + jnp.arange(G, dtype=jnp.int32)[None, :]
    in_range = (
        valid[:, None]
        & (arc_rem >= io[:, 1, None])
        & (arc_rem < io[:, 2, None])
    )
    own_cost = _bitcast_f32(io[:, 3])
    cost_rem = jnp.where(
        in_range, own_cost[:, None] + _bitcast_f32(rows[..., 0]), INF
    )
    src_rem = jnp.broadcast_to(owner[:, None], (Ru, G))

    dst = jnp.concatenate([nxt.reshape(-1), rows[..., 1].reshape(-1)])
    sidx_all = jnp.concatenate([sidx.reshape(-1), rows[..., 2].reshape(-1)])
    cost = jnp.concatenate([cost_blk.reshape(-1), cost_rem.reshape(-1)])
    # Acoustic scores fused in (decodable-ctc.cc:22-29 lookup).
    ac = -score_lookup(sidx_all, scores_t)
    cost = cost + ac  # inf + finite stays inf
    state_blk = jnp.broadcast_to(safe[:, None], (K, W))
    state_rem = jnp.broadcast_to(io[:, 4, None], (Ru, G))
    return Candidates(
        dst=dst,
        cost=cost,
        src_slot=jnp.concatenate([src_blk.reshape(-1), src_rem.reshape(-1)]),
        src_state=jnp.concatenate(
            [state_blk.reshape(-1), state_rem.reshape(-1)]
        ),
        arc_id=jnp.concatenate([arc_blk.reshape(-1), arc_rem.reshape(-1)]),
        overflow=total > Ru,
    )


def expand_eps(
    st: StepState,
    active: jnp.ndarray,
    pg: PackedGraph,
    cfg: FrontierConfig,
) -> Candidates:
    K, W = cfg.frontier_size, cfg.eps_block_width
    R = cfg.eps_rem_budget
    safe = jnp.where(active, st.states, 0)

    row = pg.eps_block[safe]
    row_lo = row[:, W * EPS_FIELDS]
    deg = jnp.where(active, row[:, W * EPS_FIELDS + 1], 0)
    blk = row[:, : W * EPS_FIELDS].reshape(K, W, EPS_FIELDS)
    w_arc = _bitcast_f32(blk[..., 0])
    nxt = blk[..., 1]
    lane_w = jnp.arange(W, dtype=jnp.int32)
    cost_blk = jnp.where(active[:, None], st.costs[:, None] + w_arc, INF)
    arc_blk = row_lo[:, None] + lane_w[None, :]
    src_blk = jnp.broadcast_to(
        jnp.arange(K, dtype=jnp.int32)[:, None], (K, W)
    )

    # Remainder lanes with the same fused per-slot info-row gather as
    # expand_emitting (one gather instead of four element gathers).
    rem_deg = jnp.maximum(deg - W, 0)
    owner, starts, total = _owner_of_lanes(rem_deg, R)
    info = jnp.stack(
        [
            row_lo + W - starts,  # arc = this + lane index
            jax.lax.bitcast_convert_type(st.costs, jnp.int32),
            safe,
        ],
        axis=1,
    )
    io = info[owner]
    j = jnp.arange(R, dtype=jnp.int32)
    valid = j < total
    arc_rem = io[:, 0] + j
    rows = pg.eps_flat[jnp.where(valid, arc_rem, 0)]
    cost_rem = jnp.where(
        valid, _bitcast_f32(io[:, 1]) + _bitcast_f32(rows[:, 0]), INF
    )

    state_blk = jnp.broadcast_to(safe[:, None], (K, W))
    return Candidates(
        dst=jnp.concatenate([nxt.reshape(-1), rows[:, 1]]),
        cost=jnp.concatenate([cost_blk.reshape(-1), cost_rem]),
        src_slot=jnp.concatenate([src_blk.reshape(-1), owner]),
        src_state=jnp.concatenate([state_blk.reshape(-1), io[:, 2]]),
        arc_id=jnp.concatenate([arc_blk.reshape(-1), arc_rem]),
        overflow=total > R,
    )


class StepOut(NamedTuple):
    bp_emit: jnp.ndarray  # (K, 2) int32: (prev_slot, emitting arc id)
    bp_eps: jnp.ndarray  # (D, K, 2) int32: per eps iteration
    num_active: jnp.ndarray  # () int32
    best_cost: jnp.ndarray  # () float32, absolute
    cutoff: jnp.ndarray  # () float32, absolute cutoff used for expansion
    overflow: jnp.ndarray  # () bool — any lane budget overflow this frame
    # More distinct in-beam states than frontier slots: the frontier kept
    # only its K cheapest, a hidden max_active=K the reference does not
    # have (beam-only decoders silently diverge when this fires).
    saturated: jnp.ndarray  # () bool


def _identity_bp(k: int) -> jnp.ndarray:
    return jnp.stack(
        [jnp.arange(k, dtype=jnp.int32), jnp.full((k,), NO_ARC, jnp.int32)], axis=-1
    )


def start_state(start, cfg: FrontierConfig) -> StepState:
    """Frontier containing only the start token at cost 0
    (`faster-decoder.cc:42-56` InitDecoding, before its eps closure)."""
    K = cfg.frontier_size
    states = jnp.zeros((K,), jnp.int32).at[0].set(start)
    costs = jnp.full((K,), INF, jnp.float32).at[0].set(0.0)
    return StepState(states, costs, jnp.float32(0.0))


def eps_iteration(
    st: StepState,
    cutoff_rel: jnp.ndarray,
    pg: PackedGraph,
    cfg: FrontierConfig,
    num_states: int,
):
    """One epsilon relaxation: expand eps arcs of every live token, merge
    with the incumbent frontier keeping per-state minima.

    Reference semantics (`faster-decoder.cc:59-119`): tokens with cost >
    cutoff are not expanded, new tokens with cost > cutoff are dropped,
    and an incumbent token is only replaced by a strictly cheaper one.
    """
    K = cfg.frontier_size
    active = jnp.isfinite(st.costs) & (st.costs <= cutoff_rel)
    cand = expand_eps(st, active, pg, cfg)
    ncost = jnp.where(cand.cost <= cutoff_rel, cand.cost, INF)

    # Incumbents first: stable sort makes them win cost ties, so `changed`
    # only fires on strict improvement (matching FindOrAddToken/Insert).
    cand_state = jnp.concatenate([st.states, cand.dst])
    cand_cost = jnp.concatenate([st.costs, ncost])
    cand_slot = jnp.concatenate([jnp.arange(K, dtype=jnp.int32), cand.src_slot])
    cand_arc = jnp.concatenate(
        [jnp.full((K,), NO_ARC, jnp.int32), cand.arc_id]
    )

    sel = dedup_select(cand_state, cand_cost, K, num_states)
    ok = sel.cand_idx >= 0
    safe_idx = jnp.where(ok, sel.cand_idx, 0)
    bp = jnp.stack(
        [
            jnp.where(ok, cand_slot[safe_idx], 0),
            jnp.where(ok, cand_arc[safe_idx], NO_ARC),
        ],
        axis=-1,
    ).astype(jnp.int32)
    changed = jnp.any(ok & (bp[:, 1] != NO_ARC))
    sat = sel.num_unique > K
    return StepState(sel.states, sel.costs, st.base), bp, changed, cand.overflow, sat


def eps_closure(
    st: StepState,
    cutoff_rel,
    pg: PackedGraph,
    cfg: FrontierConfig,
    num_states: int,
):
    """Run up to ``cfg.eps_iters`` epsilon relaxations with early-out.

    Iterations after convergence produce identity backpointers (the host
    backtrace skips them).  Returns (state, bps, overflow, saturated).
    """
    K, D = cfg.frontier_size, cfg.eps_iters
    ident = _identity_bp(K)
    if D == 0:
        return st, jnp.zeros((0, K, 2), jnp.int32), jnp.bool_(False), jnp.bool_(False)

    def body(carry, _):
        cur, stop, ovf, sat = carry
        nxt, bp, changed, o, s = eps_iteration(cur, cutoff_rel, pg, cfg, num_states)
        nxt = jax.tree.map(lambda new, old: jnp.where(stop, old, new), nxt, cur)
        bp = jnp.where(stop, ident, bp)
        new_stop = stop | ~changed
        return (nxt, new_stop, ovf | (~stop & o), sat | (~stop & s)), bp

    (st, stop, ovf, sat), bps = jax.lax.scan(
        body,
        (st, jnp.bool_(False), jnp.bool_(False), jnp.bool_(False)),
        None,
        length=D,
    )
    if not cfg.eps_exact:
        # Cyclic-eps budget: the last iteration still improving means the
        # fixed point may not have been reached — surface as overflow.
        ovf = ovf | ~stop
    return st, bps, ovf, sat


def eps_closure_batched(
    st: StepState,  # batched: (B, K) slot arrays
    cutoff_rel: jnp.ndarray,  # (B,)
    row_active: jnp.ndarray,  # (B,) bool — frames past length don't gate exit
    pg: PackedGraph,
    cfg: FrontierConfig,
    num_states: int,
) -> Tuple[StepState, jnp.ndarray, jnp.ndarray]:
    """Whole-batch epsilon closure with a *real* early exit.

    The per-utterance ``eps_closure`` runs all ``eps_iters`` iterations
    under ``vmap`` (the early-out only masks results).  At batch level a
    ``lax.while_loop`` stops as soon as no active utterance improved —
    on typical graphs most frames converge after one iteration, halving
    the epsilon cost (the reference's worklist just empties,
    `faster-decoder.cc:59-119`).

    Returns (state, bp (D, B, K, 2) identity-padded, overflow (B,),
    saturated (B,)).
    """
    K, D = cfg.frontier_size, cfg.eps_iters
    B = st.states.shape[0]
    ident = jnp.broadcast_to(_identity_bp(K), (B, K, 2))
    if D == 0:
        z = jnp.zeros((B,), bool)
        return st, jnp.zeros((0, B, K, 2), jnp.int32), z, z
    bps0 = jnp.broadcast_to(ident[None], (D, B, K, 2)).astype(jnp.int32)

    def cond(carry):
        it, _, go, _, _, _ = carry
        return (it < D) & go

    def body(carry):
        it, cur, _, ovf, sat, bps = carry
        nxt, bp, changed, o, s = jax.vmap(
            lambda st_, c: eps_iteration(st_, c, pg, cfg, num_states)
        )(cur, cutoff_rel)
        bps = jax.lax.dynamic_update_slice(
            bps, bp[None].astype(jnp.int32), (it, 0, 0, 0)
        )
        go = jnp.any(changed & row_active)
        return it + 1, nxt, go, ovf | (o & row_active), sat | (s & row_active), bps

    z = jnp.zeros((B,), bool)
    _, stf, go, ovf, sat, bps = jax.lax.while_loop(
        cond,
        body,
        (jnp.int32(0), st, jnp.bool_(True), z, z, bps0),
    )
    if not cfg.eps_exact:
        # Cyclic-eps budget exhausted while still improving: flag every
        # active row (per-row convergence is not tracked by the batch
        # early-exit).
        ovf = ovf | (go & row_active)
    return stf, bps, ovf, sat


def init_closure(
    pg: PackedGraph, start, num_states: int, cfg: FrontierConfig
) -> Tuple[StepState, jnp.ndarray]:
    """InitDecoding's unbounded eps closure (`faster-decoder.cc:53`)."""
    st = start_state(start, cfg)
    st, bp, _, _ = eps_closure(st, jnp.float32(INF), pg, cfg, num_states)
    return st, bp


def frame_emit_stage(
    st: StepState,
    scores_t: jnp.ndarray,  # (V,)
    pg: PackedGraph,
    cfg: FrontierConfig,
    num_states: int,
):
    """Per-utterance emitting stage: cutoff, expansion, dedup, bp.

    Returns (mid_state, bp_emit, next_cutoff_rel, cutoff_abs, overflow,
    saturated).
    """
    K = cfg.frontier_size
    cut = get_cutoff(
        st.costs,
        cfg.beam,
        cfg.max_active,
        cfg.min_active,
        cfg.beam_delta,
        costs_sorted=True,
    )
    active = jnp.isfinite(st.costs) & (st.costs < cut.cutoff)
    cand = expand_emitting(st, active, scores_t, pg, cfg)

    best_new = jnp.min(cand.cost)
    next_cutoff = best_new + cut.adaptive_beam
    ncost = jnp.where(cand.cost < next_cutoff, cand.cost, INF)

    sel = dedup_select(cand.dst, ncost, K, num_states)
    ok = sel.cand_idx >= 0
    safe_idx = jnp.where(ok, sel.cand_idx, 0)
    bp_emit = jnp.stack(
        [
            jnp.where(ok, cand.src_slot[safe_idx], 0),
            jnp.where(ok, cand.arc_id[safe_idx], NO_ARC),
        ],
        axis=-1,
    ).astype(jnp.int32)
    mid = StepState(sel.states, sel.costs, st.base)
    sat = sel.num_unique > K
    return mid, bp_emit, next_cutoff, st.base + cut.cutoff, cand.overflow, sat


def _frame_finish(st, mid, frame_active, cfg: FrontierConfig):
    """Per-utterance rebase + frame_active freeze. Returns (state, m_safe)."""
    m = mid.costs[0]
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    out_state = StepState(mid.states, mid.costs - m_safe, mid.base + m_safe)
    final_state = jax.tree.map(
        lambda new, old: jnp.where(frame_active, new, old), out_state, st
    )
    return final_state, m_safe


def frame_step(
    st: StepState,
    scores_t: jnp.ndarray,  # (V,) float32 log-probs for this frame
    frame_active,  # () bool — False once past this utterance's length
    pg: PackedGraph,
    cfg: FrontierConfig,
    num_states: int,
) -> Tuple[StepState, StepOut]:
    """Process one frame: emitting expansion + epsilon closure + rebase."""
    K = cfg.frontier_size

    mid, bp_emit, next_cutoff, cutoff_abs, em_ovf, em_sat = frame_emit_stage(
        st, scores_t, pg, cfg, num_states
    )
    # Epsilon closure under the emitting-stage cutoff
    # (ProcessNonemitting(weight_cutoff), faster-decoder.cc:149-151).
    mid, bp_eps, eps_ovf, eps_sat = eps_closure(
        mid, next_cutoff, pg, cfg, num_states
    )

    final_state, m_safe = _frame_finish(st, mid, frame_active, cfg)

    # Inactive frames (t >= length) freeze the frontier with identity bps.
    ident = _identity_bp(K)
    ident_eps = jnp.broadcast_to(ident, (cfg.eps_iters, K, 2))
    out = StepOut(
        bp_emit=jnp.where(frame_active, bp_emit, ident),
        bp_eps=jnp.where(frame_active, bp_eps, ident_eps),
        num_active=jnp.where(
            frame_active,
            jnp.sum(jnp.isfinite(mid.costs)),
            jnp.sum(jnp.isfinite(st.costs)),
        ).astype(jnp.int32),
        best_cost=jnp.where(
            frame_active,
            mid.base + m_safe,
            st.base + jnp.where(jnp.isfinite(st.costs[0]), st.costs[0], 0.0),
        ),
        cutoff=cutoff_abs,
        overflow=frame_active & (em_ovf | eps_ovf),
        saturated=frame_active & (em_sat | eps_sat),
    )
    return final_state, out


def frame_step_batched(
    st: StepState,  # (B, K) slot arrays
    scores_t: jnp.ndarray,  # (B, V)
    frame_active: jnp.ndarray,  # (B,) bool
    pg: PackedGraph,
    cfg: FrontierConfig,
    num_states: int,
) -> Tuple[StepState, StepOut]:
    """Whole-batch frame step: vmapped emit stage + batch-level epsilon
    closure whose ``while_loop`` genuinely stops once every utterance
    converged (see :func:`eps_closure_batched`)."""
    K = cfg.frontier_size
    B = st.states.shape[0]

    mid, bp_emit, next_cutoff, cutoff_abs, em_ovf, em_sat = jax.vmap(
        lambda s, sc: frame_emit_stage(s, sc, pg, cfg, num_states)
    )(st, scores_t)
    mid, bps, eps_ovf, eps_sat = eps_closure_batched(
        mid, next_cutoff, frame_active, pg, cfg, num_states
    )
    bp_eps = jnp.moveaxis(bps, 0, 1)  # (B, D, K, 2)

    final_state, m_safe = jax.vmap(
        lambda s, m, a: _frame_finish(s, m, a, cfg)
    )(st, mid, frame_active)

    ident = jnp.broadcast_to(_identity_bp(K), (B, K, 2))
    ident_eps = jnp.broadcast_to(
        _identity_bp(K)[None, None], (B, cfg.eps_iters, K, 2)
    )
    fa = frame_active
    out = StepOut(
        bp_emit=jnp.where(fa[:, None, None], bp_emit, ident),
        bp_eps=jnp.where(fa[:, None, None, None], bp_eps, ident_eps),
        num_active=jnp.where(
            fa,
            jnp.sum(jnp.isfinite(mid.costs), axis=1),
            jnp.sum(jnp.isfinite(st.costs), axis=1),
        ).astype(jnp.int32),
        best_cost=jnp.where(
            fa,
            mid.base + m_safe,
            st.base
            + jnp.where(jnp.isfinite(st.costs[:, 0]), st.costs[:, 0], 0.0),
        ),
        cutoff=cutoff_abs,
        overflow=fa & (em_ovf | eps_ovf),
        saturated=fa & (em_sat | eps_sat),
    )
    return final_state, out
