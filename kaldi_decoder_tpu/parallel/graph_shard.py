"""Sharded-graph decoding: states partitioned across a ``model`` mesh axis.

For graphs too large for one chip's HBM (or to scale per-graph bandwidth),
states are partitioned contiguously across P devices; each device owns the
out-arcs of its states.  Per frame, every device expands its local
frontier, then routes each candidate token to its destination state's
owner with one ``all_to_all`` over the mesh axis, and dedups/prunes
locally — global per-state dedup holds because ownership is a partition.

The reference has no distributed anything (SURVEY §2.5); this is the
greenfield "graph sharding (TP analogue)" component from SURVEY §2.5 /
BASELINE config #5, designed as SPMD: ``shard_map`` over the mesh, XLA
collectives between fixed-shape local steps.

v1 semantics: beam pruning is global (the cutoff uses the global best via
``pmin``); ``max_active`` capacity is per shard (each shard keeps at most
its ``frontier_size`` cheapest states).  Backpointers use *global* slot
ids (``device * K_local + slot``), so the host backtrace and results
machinery (:class:`kaldi_decoder_tpu.decoders.viterbi.ViterbiResult`) is
reused unchanged.

**When is sharding actually required?**  The device graph takes ~16
bytes/emitting arc (12 B packed flat row + ~4 B amortized block/row_ptr
overhead at W=3) plus a few GB of decode buffers at bench shapes, so an
80 GB card holds a few billion emitting arcs — far beyond a LibriSpeech
4-gram HLG (~400M).  Below that, shard for per-graph bandwidth only if
profiling says so.  **Local pre-routing dedup** (see ``_route``): each
source shard routes only per-(owner, state) minima (best-path decode) or
minima + within-lattice-beam extras (lattice decode, provably lossless
since local slack lower-bounds global slack), which cuts routed volume
and interconnect bytes by the local duplication factor.

**Why epsilon precomposition (``fst/fold.py``) is NOT used here** (the
unsharded decoders fold by default):
a folded composite arc collapses an emitting arc plus an eps chain whose
intermediate states generally live on *other* shards.  Sharding the
folded graph would (a) route each composite directly to its final owner,
skipping the shards that own the intermediates — so the host lattice
expansion would need cross-shard alpha context the routing no longer
carries — and (b) concentrate the eps-dense hub states' composite
fan-out (backoff hubs have thousands of arcs) onto single shards,
skewing the all_to_all.  Runtime closure instead routes eps candidates
through their owners with the same global-cutoff semantics, preserving
exact parity with the unsharded decoder (proven at HL scale in
``tests/test_graph_shard.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from kaldi_decoder_tpu.decoders.frontier import (
    NO_ARC,
    FrontierConfig,
    StepState,
    expand_emitting,
    expand_eps,
)
from kaldi_decoder_tpu.fst.csr import CsrGraph, GraphArrays
from kaldi_decoder_tpu.fst.pack import EM_FIELDS, EPS_FIELDS, PackedGraph, pack_graph
from kaldi_decoder_tpu.ops.segment import dedup_select, dedup_select_rec

INF = jnp.inf


# ---------------------------------------------------------------------------
# Graph partitioning
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """A CsrGraph partitioned into P contiguous state ranges.

    ``packed`` is a PackedGraph pytree whose arrays carry a leading (P,)
    parts axis (sharded over the mesh's model axis at decode time).
    Local arc ids + ``em_arc_offset[p]`` recover *global* arc ids, because
    contiguous state partitioning slices the global CSR arc order.
    """

    graph: CsrGraph  # the original, for host-side result reconstruction
    packed: PackedGraph  # leading (P,) axis on every array
    num_parts: int
    part_size: int  # Sp: states per part (last part padded)
    em_arc_offset: np.ndarray  # (P,) int32
    eps_arc_offset: np.ndarray  # (P,) int32


def _slice_part(ga: GraphArrays, lo: int, hi: int, sp: int) -> CsrGraph:
    """Local CsrGraph for states [lo, hi), padded to sp states.

    nextstate / score_idx stay GLOBAL (routing happens after expansion).
    """
    em_lo, em_hi = int(ga.em_row_ptr[lo]), int(ga.em_row_ptr[hi])
    eps_lo, eps_hi = int(ga.eps_row_ptr[lo]), int(ga.eps_row_ptr[hi])
    em_row = np.zeros(sp + 1, np.int32)
    em_row[: hi - lo + 1] = ga.em_row_ptr[lo : hi + 1] - em_lo
    em_row[hi - lo + 1 :] = em_row[hi - lo]
    eps_row = np.zeros(sp + 1, np.int32)
    eps_row[: hi - lo + 1] = ga.eps_row_ptr[lo : hi + 1] - eps_lo
    eps_row[hi - lo + 1 :] = eps_row[hi - lo]
    final = np.full(sp, np.float32(np.inf))
    final[: hi - lo] = ga.final_cost[lo:hi]
    la = GraphArrays(
        em_row_ptr=em_row,
        em_ilabel=ga.em_ilabel[em_lo:em_hi],
        em_olabel=ga.em_olabel[em_lo:em_hi],
        em_weight=ga.em_weight[em_lo:em_hi],
        em_next=ga.em_next[em_lo:em_hi],
        em_score_idx=ga.em_score_idx[em_lo:em_hi],
        eps_row_ptr=eps_row,
        eps_olabel=ga.eps_olabel[eps_lo:eps_hi],
        eps_weight=ga.eps_weight[eps_lo:eps_hi],
        eps_next=ga.eps_next[eps_lo:eps_hi],
        final_cost=final,
    )
    em_deg = np.diff(em_row)
    eps_deg = np.diff(eps_row)
    return CsrGraph(
        arrays=la,
        num_states=sp,
        num_emitting_arcs=em_hi - em_lo,
        num_eps_arcs=eps_hi - eps_lo,
        start_state=0,  # unused locally
        eps_depth=None,
        max_em_out_degree=int(em_deg.max()) if sp else 0,
        max_eps_out_degree=int(eps_deg.max()) if sp else 0,
        max_score_idx=-1,
    )


def shard_graph(
    graph: CsrGraph, num_parts: int, w_em: int, w_eps: int, flat_group: int = 4
) -> ShardedGraph:
    """Partition states contiguously into ``num_parts`` and pack each part."""
    S = graph.num_states
    sp = -(-S // num_parts)  # ceil
    parts = []
    em_off = np.zeros(num_parts, np.int32)
    eps_off = np.zeros(num_parts, np.int32)
    for p in range(num_parts):
        lo, hi = min(p * sp, S), min((p + 1) * sp, S)
        em_off[p] = graph.arrays.em_row_ptr[lo]
        eps_off[p] = graph.arrays.eps_row_ptr[lo]
        parts.append(
            pack_graph(
                _slice_part(graph.arrays, lo, hi, sp), w_em, w_eps, flat_group
            )
        )
    # Pad flat arc tables to a common length, then stack part-major.
    e_max = max(p.em_flat.shape[0] for p in parts)
    z_max = max(p.eps_flat.shape[0] for p in parts)

    def pad_flat(flat, n, fields):
        # Pad rows mark every packed arc's weight column +inf so stray
        # lanes self-invalidate (em rows hold FLAT_GROUP arcs of `fields`
        # ints each; eps rows hold one arc).
        if flat.shape[0] == n:
            return flat
        pad = np.zeros((n - flat.shape[0], flat.shape[1]), np.int32)
        pad[:, ::fields] = np.float32(np.inf).view(np.int32)
        return np.concatenate([flat, pad], axis=0)

    stacked = PackedGraph(
        em_row_ptr=np.stack([p.em_row_ptr for p in parts]),
        em_block=np.stack([p.em_block for p in parts]),
        em_flat=np.stack([pad_flat(p.em_flat, e_max, EM_FIELDS) for p in parts]),
        eps_row_ptr=np.stack([p.eps_row_ptr for p in parts]),
        eps_block=np.stack([p.eps_block for p in parts]),
        eps_flat=np.stack([pad_flat(p.eps_flat, z_max, EPS_FIELDS) for p in parts]),
        final_cost=np.stack([p.final_cost for p in parts]),
    )
    return ShardedGraph(
        graph=graph,
        packed=stacked,
        num_parts=num_parts,
        part_size=sp,
        em_arc_offset=em_off,
        eps_arc_offset=eps_off,
    )


# ---------------------------------------------------------------------------
# Token routing
# ---------------------------------------------------------------------------


class Routed(NamedTuple):
    """Per-device receive buffers after the all_to_all (flattened P*C)."""

    state_local: jnp.ndarray  # (B, P*C) int32, Sp == invalid sentinel
    cost: jnp.ndarray  # (B, P*C) float32, +inf invalid
    gslot: jnp.ndarray  # (B, P*C) int32 global source slot
    arc: jnp.ndarray  # (B, P*C) int32 global arc id
    overflow: jnp.ndarray  # (B,) bool — a (src, dst) bucket overflowed


def _route(
    dst_g: jnp.ndarray,  # (B, N) global destination states
    cost: jnp.ndarray,  # (B, N) +inf invalid
    gslot: jnp.ndarray,  # (B, N) global source slot
    arc_g: jnp.ndarray,  # (B, N) global arc id
    sp: int,
    num_parts: int,
    cap: int,
    axis: str,
    local_slack_beam: Optional[float] = None,
) -> Routed:
    """Bucket candidates by owner device and exchange over ``axis``.

    One 3-key sort by (owner, local state, cost) groups candidates AND
    performs the **local pre-routing dedup** (VERDICT r3 #6): each
    (owner, state) run's leader is its local per-state minimum, so
    non-leader duplicates never spend bucket capacity or interconnect bandwidth.

    * ``local_slack_beam=None`` (best-path decode): ONLY leaders are
      routed — duplicates can never win the destination's global dedup,
      so dropping them is exact.
    * ``local_slack_beam=beta`` (lattice decode): non-leaders are routed
      only while their LOCAL slack (cost - local per-state min) is
      <= beta.  The destination's global winner cost is <= the local
      minimum, so global slack >= local slack: everything dropped here
      is provably beyond the lattice beam — exact, never lossy.

    Within-run positions place survivors into the fixed (P, cap) send
    buffer (unique-target scatter).  Bucket overflow drops candidates and
    sets the flag — capacity plays the role the reference's growable
    hash played (faster-decoder.cc:338).
    """
    B, N = dst_g.shape
    owner = dst_g // sp

    def one(dstb, costb, slotb, arcb, ownerb):
        valid = jnp.isfinite(costb)
        key = jnp.where(valid, ownerb, num_parts)
        k2, d2, c2, s2, a2 = jax.lax.sort(
            (key, jnp.where(valid, dstb - ownerb * sp, sp), costb, slotb,
             arcb),
            num_keys=3,
        )
        idx = jnp.arange(N, dtype=jnp.int32)
        # (owner, state)-run leaders: the local per-state minima.
        state_leader = jnp.concatenate(
            [jnp.ones((1,), bool), (k2[1:] != k2[:-1]) | (d2[1:] != d2[:-1])]
        )
        if local_slack_beam is None:
            keep = state_leader & (k2 < num_parts)
        else:
            def fill_op(x, y):
                fx, cx = x
                fy, cy = y
                return (fx | fy, jnp.where(fy, cy, cx))

            _, run_min = jax.lax.associative_scan(
                fill_op, (state_leader, c2)
            )
            keep = (k2 < num_parts) & (c2 - run_min <= local_slack_beam)
        # Position among kept lanes within each OWNER run (segmented
        # prefix-count; owner runs start where k2 changes).
        owner_leader = jnp.concatenate(
            [jnp.ones((1,), bool), k2[1:] != k2[:-1]]
        )

        def cnt_op(x, y):
            fx, nx = x
            fy, ny = y
            return (fx | fy, jnp.where(fy, ny, nx + ny))

        _, csum = jax.lax.associative_scan(
            cnt_op, (owner_leader, keep.astype(jnp.int32))
        )
        within = csum - keep.astype(jnp.int32)  # exclusive prefix
        ok = keep & (within < cap)
        tgt = jnp.where(ok, k2 * cap + within, num_parts * cap)
        flat = num_parts * cap
        send_d = jnp.zeros((flat,), jnp.int32).at[tgt].set(d2, mode="drop")
        send_c = jnp.full((flat,), INF, jnp.float32).at[tgt].set(
            jnp.where(ok, c2, INF), mode="drop"
        )
        send_s = jnp.zeros((flat,), jnp.int32).at[tgt].set(s2, mode="drop")
        send_a = jnp.full((flat,), NO_ARC, jnp.int32).at[tgt].set(a2, mode="drop")
        ovf = jnp.any(keep & (within >= cap))
        return (
            send_d.reshape(num_parts, cap),
            send_c.reshape(num_parts, cap),
            send_s.reshape(num_parts, cap),
            send_a.reshape(num_parts, cap),
            ovf,
        )

    send_d, send_c, send_s, send_a, ovf = jax.vmap(one)(
        dst_g, cost, gslot, arc_g, owner
    )
    # (B, P, cap): slice p goes to device p; receive the same layout back.
    recv = [
        jax.lax.all_to_all(x, axis, split_axis=1, concat_axis=1, tiled=True)
        for x in (send_d, send_c, send_s, send_a)
    ]
    d, c, s, a = (x.reshape(B, num_parts * cap) for x in recv)
    # Invalid entries carry cost=+inf; make their state the dedup sentinel.
    d = jnp.where(jnp.isfinite(c), d, sp)
    return Routed(d, c, s, a, ovf)


# ---------------------------------------------------------------------------
# Sharded decode step
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """Static sharded-decode parameters.

    ``frontier`` holds per-shard capacities (frontier_size = K per shard);
    beam semantics are global (cutoff from the global best via pmin),
    max_active is per-shard capacity in v1.
    """

    frontier: FrontierConfig
    num_parts: int
    part_size: int
    route_cap: int  # per (src_dev, dst_dev) bucket capacity, emitting
    eps_route_cap: int

    @property
    def k_local(self) -> int:
        return self.frontier.frontier_size

    @property
    def k_total(self) -> int:
        return self.num_parts * self.frontier.frontier_size


def shard_config_for(
    sg: ShardedGraph, base: FrontierConfig, route_cap=None, eps_route_cap=None
) -> ShardConfig:
    fc = base
    n = fc.num_candidates
    cap = route_cap or max(64, min(n, 2 * n // sg.num_parts))
    ne = fc.frontier_size * fc.eps_block_width + fc.eps_rem_budget
    ecap = eps_route_cap or max(64, min(ne, 2 * ne // sg.num_parts))
    return ShardConfig(
        frontier=fc,
        num_parts=sg.num_parts,
        part_size=sg.part_size,
        route_cap=cap,
        eps_route_cap=ecap,
    )


def _pick_local(pg: PackedGraph) -> PackedGraph:
    """Drop the leading parts axis inside shard_map (block size 1)."""
    return jax.tree.map(lambda x: x[0], pg)


def _identity_bp_g(k: int, my_base: jnp.ndarray) -> jnp.ndarray:
    slots = my_base + jnp.arange(k, dtype=jnp.int32)
    return jnp.stack([slots, jnp.full((k,), NO_ARC, jnp.int32)], axis=-1)


def _pmin(x, axis):
    return -jax.lax.pmax(-x, axis)


def _sharded_eps_iteration(st, cutoff_rel, pg, cfg: ShardConfig, axis, my_base, eps_off):
    """One routed epsilon relaxation over all shards."""
    fc = cfg.frontier
    K, Sp, Pn = fc.frontier_size, cfg.part_size, cfg.num_parts
    B = st.states.shape[0]
    active = jnp.isfinite(st.costs) & (st.costs <= cutoff_rel)
    cand = jax.vmap(lambda s, a: expand_eps(s, a, pg, fc))(st, active)
    ncost = jnp.where(cand.cost <= cutoff_rel, cand.cost, INF)
    gslot = my_base + cand.src_slot
    rt = _route(
        cand.dst, ncost, gslot, eps_off + cand.arc_id,
        Sp, Pn, cfg.eps_route_cap, axis,
    )
    # Incumbents first (win cost ties, like FindOrAddToken keep-existing).
    inc_slots = my_base + jnp.arange(K, dtype=jnp.int32)
    cand_state = jnp.concatenate(
        [st.states, rt.state_local], axis=1
    )
    cand_cost = jnp.concatenate([st.costs, rt.cost], axis=1)
    cand_slot = jnp.concatenate(
        [jnp.broadcast_to(inc_slots, (B, K)), rt.gslot], axis=1
    )
    cand_arc = jnp.concatenate(
        [jnp.full((B, K), NO_ARC, jnp.int32), rt.arc], axis=1
    )
    sel = jax.vmap(lambda s, c: dedup_select(s, c, K, Sp))(cand_state, cand_cost)
    ok = sel.cand_idx >= 0
    safe = jnp.where(ok, sel.cand_idx, 0)
    bp = jnp.stack(
        [
            jnp.where(ok, jnp.take_along_axis(cand_slot, safe, axis=1), 0),
            jnp.where(ok, jnp.take_along_axis(cand_arc, safe, axis=1), NO_ARC),
        ],
        axis=-1,
    ).astype(jnp.int32)
    changed_local = jnp.any(ok & (bp[..., 1] != NO_ARC))
    changed = jax.lax.pmax(changed_local.astype(jnp.int32), axis) > 0
    ovf = jnp.any(rt.overflow) | cand.overflow.any()
    sat = jnp.any(sel.num_unique > K)
    return StepState(sel.states, sel.costs, st.base), bp, changed, ovf, sat


def _sharded_eps_closure(st, cutoff_rel, pg, cfg, axis, my_base, eps_off):
    fc = cfg.frontier
    K, D = fc.frontier_size, fc.eps_iters
    B = st.states.shape[0]
    ident = jnp.broadcast_to(_identity_bp_g(K, my_base), (B, K, 2))
    if D == 0:
        f = jnp.bool_(False)
        return st, jnp.zeros((0, B, K, 2), jnp.int32), f, f

    def body(carry, _):
        cur, stop, ovf, sat = carry
        nxt, bp, changed, o, s = _sharded_eps_iteration(
            cur, cutoff_rel, pg, cfg, axis, my_base, eps_off
        )
        nxt = jax.tree.map(lambda new, old: jnp.where(stop, old, new), nxt, cur)
        bp = jnp.where(stop, ident, bp)
        return (nxt, stop | ~changed, ovf | (~stop & o), sat | (~stop & s)), bp

    f = jnp.bool_(False)
    (st, _, ovf, sat), bps = jax.lax.scan(
        body, (st, f, f, f), None, length=D
    )
    return st, bps, ovf, sat


def _global_cutoff(st: StepState, cfg: ShardConfig, axis):
    """GetCutoff with *global* semantics over all shards' frontiers
    (`faster-decoder.cc:244-336`): beam cutoff from the global best, the
    max/min-active order statistics over the union of the per-shard
    (sorted) frontiers.  Returns (cutoff (B,), adaptive_beam (B,)).

    When neither bound can bind (max_active >= total capacity and
    min_active == 0) only the global best is exchanged; otherwise each
    shard contributes its cost prefix of length m = min(needed+1, K) —
    the global n-th smallest is always within the union of per-shard
    n+1-prefixes — via one all_gather, and the order statistics are read
    off a local sort of the merged prefixes.
    """
    fc = cfg.frontier
    K = fc.frontier_size
    local_best = jnp.min(jnp.where(jnp.isfinite(st.costs), st.costs, INF), axis=1)
    best = _pmin(local_best, axis)  # (B,)
    beam_cutoff = best + fc.beam
    if fc.max_active >= cfg.k_total and fc.min_active == 0:
        return beam_cutoff, jnp.full_like(best, fc.beam)

    count = jax.lax.psum(
        jnp.sum(jnp.isfinite(st.costs), axis=1).astype(jnp.int32), axis
    )  # (B,) global live tokens
    m = int(min(max(fc.max_active, fc.min_active) + 1, K))
    prefix = st.costs[:, :m]  # per-shard frontiers are cost-sorted
    merged = jax.lax.all_gather(prefix, axis, axis=1, tiled=True)  # (B, P*m)
    merged = jnp.sort(merged, axis=1)
    PM = merged.shape[1]
    max_cut = jnp.where(
        count > fc.max_active,
        merged[:, min(fc.max_active, PM - 1)],
        INF,
    )
    min_cut = jnp.where(
        count > fc.min_active,
        best if fc.min_active == 0 else merged[:, min(fc.min_active, PM - 1)],
        INF,
    )
    use_max = max_cut < beam_cutoff
    use_min = (~use_max) & (min_cut > beam_cutoff)
    cutoff = jnp.where(
        use_max, max_cut, jnp.where(use_min, min_cut, beam_cutoff)
    )
    adaptive = jnp.where(
        use_max,
        max_cut - best + fc.beam_delta,
        jnp.where(use_min, min_cut - best + fc.beam_delta, fc.beam),
    ).astype(jnp.float32)
    return cutoff, adaptive


def _sharded_frame(
    st, scores_t, frame_active, pg, cfg: ShardConfig, axis, my_base, em_off, eps_off
):
    """One sharded frame: local expand -> route -> local dedup -> routed
    eps closure -> global rebase."""
    fc = cfg.frontier
    K, Sp, Pn = fc.frontier_size, cfg.part_size, cfg.num_parts
    B = st.states.shape[0]

    # Global GetCutoff: beam + max/min-active over all shards' frontiers.
    cutoff, adaptive_beam = _global_cutoff(st, cfg, axis)
    active = jnp.isfinite(st.costs) & (st.costs < cutoff[:, None])

    cand = jax.vmap(lambda s, a, sc: expand_emitting(s, a, sc, pg, fc))(
        st, active, scores_t
    )
    best_new = _pmin(jnp.min(cand.cost, axis=1), axis)
    next_cutoff = best_new + adaptive_beam
    ncost = jnp.where(cand.cost < next_cutoff[:, None], cand.cost, INF)

    rt = _route(
        cand.dst, ncost, my_base + cand.src_slot, em_off + cand.arc_id,
        Sp, Pn, cfg.route_cap, axis,
    )
    sel = jax.vmap(lambda s, c: dedup_select(s, c, K, Sp))(rt.state_local, rt.cost)
    ok = sel.cand_idx >= 0
    safe = jnp.where(ok, sel.cand_idx, 0)
    bp_emit = jnp.stack(
        [
            jnp.where(ok, jnp.take_along_axis(rt.gslot, safe, axis=1), 0),
            jnp.where(ok, jnp.take_along_axis(rt.arc, safe, axis=1), NO_ARC),
        ],
        axis=-1,
    ).astype(jnp.int32)

    em_sat = jnp.any(sel.num_unique > K)
    mid = StepState(sel.states, sel.costs, st.base)
    mid, bp_eps, eps_ovf, eps_sat = _sharded_eps_closure(
        mid, next_cutoff[:, None], pg, cfg, axis, my_base, eps_off
    )

    # Global rebase.
    m = _pmin(jnp.min(jnp.where(jnp.isfinite(mid.costs), mid.costs, INF), axis=1), axis)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    out_state = StepState(mid.states, mid.costs - m_safe[:, None], mid.base + m_safe)

    ident = jnp.broadcast_to(_identity_bp_g(K, my_base), (B, K, 2))
    ident_eps = jnp.broadcast_to(ident, (fc.eps_iters, B, K, 2))
    fa = frame_active
    final_state = jax.tree.map(
        lambda new, old: jnp.where(
            fa.reshape((B,) + (1,) * (new.ndim - 1)), new, old
        ),
        out_state,
        st,
    )
    num_active = jax.lax.psum(
        jnp.sum(jnp.isfinite(mid.costs), axis=1).astype(jnp.int32), axis
    )
    # Per-shard flags must be OR-reduced over the model axis: the output
    # spec replicates them, so an unreduced flag from one shard would be
    # silently dropped.
    ovf_all = (
        jax.lax.pmax(
            (jnp.any(cand.overflow | rt.overflow) | eps_ovf).astype(jnp.int32),
            axis,
        )
        > 0
    )
    sat_all = jax.lax.pmax((em_sat | eps_sat).astype(jnp.int32), axis) > 0
    outs = (
        jnp.where(fa[:, None, None], bp_emit, ident),
        jnp.where(fa[None, :, None, None], bp_eps, ident_eps),
        jnp.where(fa, num_active, 0),
        jnp.where(fa, mid.base + m_safe, st.base),
        st.base + cutoff,
        fa & ovf_all,
        fa & sat_all,
    )
    return final_state, outs


@functools.lru_cache(maxsize=None)
def _build_sharded_chunk_fn(cfg: ShardConfig, mesh, model_axis: str, data_axis):
    """jit(shard_map(...)) over the model axis (and optional data axis).

    Signature: fn(pg_parts, scores, lengths, st0) with
      * pg_parts: PackedGraph with leading (P,) axis (sharded over model)
      * scores (B, T, V) (sharded over data if given, replicated over model)
      * st0: StepState with (B, K_total) slot arrays (slots over model)
    Returns (stF, (bp_emit (T,B,K_total,2), bp_eps (T,D,B,K,2)->(T,B,D,K,2),
    num_active (T,B), best (T,B), cutoff (T,B), overflow (T,B))).
    """
    fc = cfg.frontier
    axis = model_axis

    def chunk(pg_parts, em_off, eps_off, scores, lengths, st0):
        pg = _pick_local(pg_parts)
        me = jax.lax.axis_index(axis)
        my_base = me.astype(jnp.int32) * fc.frontier_size
        scores_tm = jnp.moveaxis(scores, 1, 0)
        ts = jnp.arange(scores_tm.shape[0], dtype=jnp.int32)

        def body(st, inp):
            sc_t, t = inp
            return _sharded_frame(
                st, sc_t, t < lengths, pg, cfg, axis, my_base,
                em_off[0], eps_off[0],
            )

        stf, outs = jax.lax.scan(body, st0, (scores_tm, ts))
        bp_emit, bp_eps, num_active, best, cutoff, ovf, sat = outs
        # (T, D, B, K) -> (T, B, D, K)
        bp_eps = jnp.moveaxis(bp_eps, 1, 2)
        return stf, (bp_emit, bp_eps, num_active, best, cutoff, ovf, sat)

    mspec = P(model_axis)
    pg_specs = PackedGraph(*([mspec] * len(PackedGraph._fields)))
    slot = P(data_axis, model_axis)  # (B, K_total): K sharded over model
    st_spec = StepState(states=slot, costs=slot, base=P(data_axis))
    bspec = P(None, data_axis)  # (T, B)
    out_specs = (
        st_spec,
        (
            P(None, data_axis, model_axis),  # bp_emit (T, B, K_total, 2)
            P(None, data_axis, None, model_axis),  # bp_eps (T, B, D, K, 2)
            bspec, bspec, bspec, bspec, bspec,
        ),
    )
    fn = shard_map(
        chunk,
        mesh=mesh,
        in_specs=(
            pg_specs, mspec, mspec,
            P(data_axis), P(data_axis), st_spec,
        ),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def _build_sharded_init_fn(cfg: ShardConfig, mesh, model_axis: str, data_axis):
    """Start-state frontier + its routed eps closure (InitDecoding)."""
    fc = cfg.frontier

    def init(pg_parts, eps_off, st0):
        pg = _pick_local(pg_parts)
        me = jax.lax.axis_index(model_axis)
        my_base = me.astype(jnp.int32) * fc.frontier_size
        st, bps, _, _ = _sharded_eps_closure(
            st0, jnp.float32(INF), pg, cfg, model_axis, my_base, eps_off[0]
        )
        return st, jnp.moveaxis(bps, 1, 0) if bps.ndim == 4 else bps

    mspec = P(model_axis)
    pg_specs = PackedGraph(*([mspec] * len(PackedGraph._fields)))
    slot = P(data_axis, model_axis)
    st_spec = StepState(states=slot, costs=slot, base=P(data_axis))
    fn = shard_map(
        init,
        mesh=mesh,
        in_specs=(pg_specs, mspec, st_spec),
        out_specs=(st_spec, P(data_axis, None, model_axis)),
        check_vma=False,
    )
    return jax.jit(fn)


# ---------------------------------------------------------------------------
# Decoder object
# ---------------------------------------------------------------------------


class ShardedViterbiDecoder:
    """Best-path decoder over a state-sharded graph on a device mesh.

    ``mesh`` must have a ``model`` axis (P = its size); an optional
    ``data`` axis shards the utterance batch as well.  Host-side results
    reuse :class:`ViterbiResult` — backpointers use global slot ids.
    """

    def __init__(
        self,
        graph: CsrGraph,
        config: Optional[FrontierConfig] = None,
        mesh: Optional[Mesh] = None,
        model_axis: str = "model",
        data_axis: str = "data",
        route_cap: Optional[int] = None,
        pad_time_to: int = 32,
    ):
        from kaldi_decoder_tpu.decoders.frontier import config_for_graph

        if mesh is None:
            raise ValueError("ShardedViterbiDecoder requires a mesh")
        self.graph = graph
        self.mesh = mesh
        self.model_axis = model_axis
        self.data_axis = data_axis if data_axis in mesh.axis_names else None
        self.pad_time_to = pad_time_to
        P_ = mesh.shape[model_axis]
        fc = config if config is not None else config_for_graph(graph)
        self._sg = shard_graph(
            graph, P_, fc.block_width, fc.eps_block_width, fc.flat_group
        )
        self.cfg = shard_config_for(self._sg, fc, route_cap=route_cap)
        self._pg_dev = jax.tree.map(jnp.asarray, self._sg.packed)
        self._em_off = jnp.asarray(self._sg.em_arc_offset)
        self._eps_off = jnp.asarray(self._sg.eps_arc_offset)
        self._chunk_fn = _build_sharded_chunk_fn(
            self.cfg, mesh, model_axis, self.data_axis
        )
        self._init_fn = _build_sharded_init_fn(
            self.cfg, mesh, model_axis, self.data_axis
        )

    # Effective result config: global frontier of K_total slots.
    def _result_cfg(self) -> FrontierConfig:
        return dataclasses.replace(
            self.cfg.frontier, frontier_size=self.cfg.k_total
        )

    def _init_state(self, batch: int) -> StepState:
        K_tot, Sp = self.cfg.k_total, self.cfg.part_size
        start = self.graph.start_state
        owner, local = divmod(start, Sp)
        states = np.zeros((batch, K_tot), np.int32)
        costs = np.full((batch, K_tot), np.float32(np.inf))
        slot = owner * self.cfg.k_local
        states[:, slot] = local
        costs[:, slot] = 0.0
        return StepState(
            jnp.asarray(states), jnp.asarray(costs),
            jnp.zeros((batch,), jnp.float32),
        )

    def decode(self, scores: np.ndarray, lengths: Optional[np.ndarray] = None):
        from kaldi_decoder_tpu.decoders.viterbi import ViterbiResult, _round_up

        scores = np.asarray(scores, np.float32)
        if scores.ndim == 2:
            scores = scores[None]
        B, T, V = scores.shape
        if lengths is None:
            lengths = np.full((B,), T, np.int32)
        lengths = np.asarray(lengths, np.int32)
        bmul = self.mesh.shape[self.data_axis] if self.data_axis else 1
        Bp = _round_up(B, bmul)
        Tp = max(_round_up(T, self.pad_time_to), self.pad_time_to)
        scores_p = np.zeros((Bp, Tp, V), np.float32)
        scores_p[:B, :T] = scores
        lengths_p = np.zeros((Bp,), np.int32)
        lengths_p[:B] = lengths

        st0 = self._init_state(Bp)
        st0, bp_init = self._init_fn(self._pg_dev, self._eps_off, st0)
        stf, (bp_emit, bp_eps, num_active, best, cutoff, ovf, sat) = self._chunk_fn(
            self._pg_dev, self._em_off, self._eps_off,
            jnp.asarray(scores_p), jnp.asarray(lengths_p), st0,
        )
        # Local state ids -> global (clamped for padded tail states).
        Sp, Kl = self.cfg.part_size, self.cfg.k_local
        offs = np.repeat(np.arange(self.cfg.num_parts, dtype=np.int32) * Sp, Kl)
        f_states = np.asarray(stf.states) + offs[None, :]
        f_states = np.minimum(f_states, self.graph.num_states - 1)
        return ViterbiResult(
            graph=self.graph,
            cfg=self._result_cfg(),
            scores=scores,
            lengths=lengths,
            bp_init=np.asarray(bp_init)[0],  # init closure is batch-invariant
            bp_emit=np.asarray(bp_emit),
            bp_eps=np.asarray(bp_eps),
            frontier_states=f_states,
            frontier_costs=np.asarray(stf.base)[:, None] + np.asarray(stf.costs),
            num_active=np.asarray(num_active),
            best_costs=np.asarray(best),
            cutoffs=np.asarray(cutoff),
            overflows=np.asarray(ovf),
            saturations=np.asarray(sat),
        )


# ---------------------------------------------------------------------------
# Sharded lattice decoding (BASELINE config #5: sharded-graph HLG lattice)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardLatticeConfig:
    """ShardConfig + per-shard record budgets (lattice_dev analogue)."""

    shard: ShardConfig
    em_records: int  # per shard: frontier winners + slack-selected extras
    eps_records: int  # per shard, per eps iteration
    lattice_beam: float = 10.0


def shard_lattice_config_for(
    sg: ShardedGraph,
    base: FrontierConfig,
    lattice_beam: float,
    em_records=None,
    eps_records=None,
    route_cap=None,
    eps_route_cap=None,
) -> ShardLatticeConfig:
    sc = shard_config_for(sg, base, route_cap, eps_route_cap)
    K = sc.k_local
    em_r = em_records or (K + max(512, 2048 // sg.num_parts))
    eps_r = eps_records or max(64, (sc.num_parts * sc.eps_route_cap) // 4)
    return ShardLatticeConfig(
        shard=sc,
        em_records=int(em_r),
        eps_records=int(eps_r),
        lattice_beam=float(lattice_beam),
    )


def _rec_from_idx(idx, state_of, arc_of, offset=0):
    """Map record indices (−1 padded; entries < offset are non-links) to
    (state, arc) rows."""
    ok = idx >= offset
    ci = jnp.where(ok, idx - offset, 0)
    return jnp.stack(
        [
            jnp.where(ok, state_of[ci], -1),
            jnp.where(ok, arc_of[ci], -1),
        ],
        axis=-1,
    ).astype(jnp.int32), ok


def _sharded_lattice_eps_iteration(
    st, cutoff_rel, pg, cfg: ShardLatticeConfig, axis, eps_off
):
    """Routed epsilon relaxation emitting (src_state, arc) link records."""
    sc = cfg.shard
    fc = sc.frontier
    K, Sp, Pn = fc.frontier_size, sc.part_size, sc.num_parts
    B = st.states.shape[0]
    me = jax.lax.axis_index(axis).astype(jnp.int32)
    active = jnp.isfinite(st.costs) & (st.costs <= cutoff_rel)
    cand = jax.vmap(lambda s, a: expand_eps(s, a, pg, fc))(st, active)
    ncost = jnp.where(cand.cost <= cutoff_rel, cand.cost, INF)
    # Route (dst, cost, GLOBAL src state, global arc): the lattice needs
    # source states, not slots.
    src_state_g = jnp.where(
        jnp.isfinite(ncost), st.states[
            jnp.arange(B)[:, None], cand.src_slot
        ] + me * Sp, 0
    )
    rt = _route(
        cand.dst, ncost, src_state_g, eps_off + cand.arc_id,
        Sp, Pn, sc.eps_route_cap, axis,
        local_slack_beam=cfg.lattice_beam + 1e-4,
    )
    cand_state = jnp.concatenate([st.states, rt.state_local], axis=1)
    cand_cost = jnp.concatenate([st.costs, rt.cost], axis=1)
    sb = cfg.lattice_beam + 1e-4
    sel = jax.vmap(
        lambda s, c: dedup_select_rec(
            s, c, K, Sp, K + cfg.eps_records, slack_beam=sb,
            num_incumbents=K,
        )
    )(cand_state, cand_cost)
    rec_all, is_link = jax.vmap(
        lambda idx, sg_, ag_: _rec_from_idx(idx, sg_, ag_, offset=K)
    )(sel.recs[0], rt.gslot, rt.arc)
    # Compact the winners-first/slack-ascending link rows into eps_records
    # slots (winner links and extras are disjoint by construction in
    # dedup_select_rec, so the compaction never sees duplicates).
    n_idx = sel.recs[0].shape[1]
    keykeep = jnp.where(is_link, n_idx - jnp.arange(n_idx)[None, :], 0)
    _, takepos = jax.lax.top_k(keykeep, cfg.eps_records)
    got = jnp.take_along_axis(keykeep, takepos, axis=1) > 0
    rec = jnp.where(
        got[..., None],
        jnp.take_along_axis(rec_all, takepos[..., None], axis=1),
        -1,
    )
    changed_local = jnp.any((sel.cand_idx >= K) & jnp.isfinite(sel.costs))
    changed = jax.lax.pmax(changed_local.astype(jnp.int32), axis) > 0
    # Spill check: eligible links beyond the eps_records slots are dropped
    # by the compaction above — that is record overflow (potential lattice
    # loss) and must be flagged, mirroring lattice_dev.eps_iteration_rec's
    # spill test.
    spill = jnp.any(jnp.sum(is_link, axis=1) > cfg.eps_records)
    ovf = (
        jnp.any(rt.overflow) | cand.overflow.any()
        | jnp.any(sel.rec_overflow) | spill
    )
    sat = jnp.any(sel.num_unique > K)
    return StepState(sel.states, sel.costs, st.base), rec, changed, ovf, sat


def _sharded_lattice_eps_closure(st, cutoff_rel, pg, cfg, axis, eps_off):
    fc = cfg.shard.frontier
    D = fc.eps_iters
    B = st.states.shape[0]
    if D == 0:
        f = jnp.bool_(False)
        return st, jnp.full((0, B, cfg.eps_records, 2), -1, jnp.int32), f, f
    empty = jnp.full((B, cfg.eps_records, 2), -1, jnp.int32)

    def body(carry, _):
        cur, stop, ovf, sat = carry
        nxt, rec, changed, o, s = _sharded_lattice_eps_iteration(
            cur, cutoff_rel, pg, cfg, axis, eps_off
        )
        nxt = jax.tree.map(lambda new, old: jnp.where(stop, old, new), nxt, cur)
        rec = jnp.where(stop, empty, rec)
        return (nxt, stop | ~changed, ovf | (~stop & o), sat | (~stop & s)), rec

    f = jnp.bool_(False)
    (st, _, ovf, sat), recs = jax.lax.scan(
        body, (st, f, f, f), None, length=D
    )
    return st, recs, ovf, sat


def _sharded_lattice_frame(
    st, scores_t, frame_active, pg, cfg: ShardLatticeConfig, axis, em_off, eps_off
):
    """One sharded lattice frame: global GetCutoff, expand, route with
    source states, per-shard dedup + slack-selected records, routed
    record-emitting eps closure, global rebase."""
    sc = cfg.shard
    fc = sc.frontier
    K, Sp, Pn = fc.frontier_size, sc.part_size, sc.num_parts
    B = st.states.shape[0]
    me = jax.lax.axis_index(axis).astype(jnp.int32)

    cutoff, adaptive_beam = _global_cutoff(st, sc, axis)
    active = jnp.isfinite(st.costs) & (st.costs < cutoff[:, None])
    cand = jax.vmap(lambda s, a, sct: expand_emitting(s, a, sct, pg, fc))(
        st, active, scores_t
    )
    best_new = _pmin(jnp.min(cand.cost, axis=1), axis)
    next_cutoff = best_new + adaptive_beam
    ncost = jnp.where(cand.cost < next_cutoff[:, None], cand.cost, INF)

    src_state_g = jnp.where(
        jnp.isfinite(ncost),
        st.states[jnp.arange(B)[:, None], cand.src_slot] + me * Sp,
        0,
    )
    rt = _route(
        cand.dst, ncost, src_state_g, em_off + cand.arc_id,
        Sp, Pn, sc.route_cap, axis,
        local_slack_beam=cfg.lattice_beam + 1e-4,
    )
    sb = cfg.lattice_beam + 1e-4
    sel = jax.vmap(
        lambda s, c: dedup_select_rec(
            s, c, K, Sp, cfg.em_records, slack_beam=sb
        )
    )(rt.state_local, rt.cost)
    em_rec, _ = jax.vmap(lambda idx, sg_, ag_: _rec_from_idx(idx, sg_, ag_))(
        sel.recs[0], rt.gslot, rt.arc
    )
    em_sat = jnp.any(sel.num_unique > K)
    em_ovf = jnp.any(rt.overflow) | cand.overflow.any() | jnp.any(sel.rec_overflow)

    mid = StepState(sel.states, sel.costs, st.base)
    mid, eps_recs, eps_ovf, eps_sat = _sharded_lattice_eps_closure(
        mid, next_cutoff[:, None], pg, cfg, axis, eps_off
    )

    m = _pmin(jnp.min(jnp.where(jnp.isfinite(mid.costs), mid.costs, INF), axis=1), axis)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    out_state = StepState(mid.states, mid.costs - m_safe[:, None], mid.base + m_safe)
    fa = frame_active
    final_state = jax.tree.map(
        lambda new, old: jnp.where(
            fa.reshape((B,) + (1,) * (new.ndim - 1)), new, old
        ),
        out_state,
        st,
    )
    num_active = jax.lax.psum(
        jnp.sum(jnp.isfinite(mid.costs), axis=1).astype(jnp.int32), axis
    )
    ovf_all = jax.lax.pmax((em_ovf | eps_ovf).astype(jnp.int32), axis) > 0
    sat_all = jax.lax.pmax((em_sat | eps_sat).astype(jnp.int32), axis) > 0
    D = fc.eps_iters
    empty_em = jnp.full((B, cfg.em_records, 2), -1, jnp.int32)
    empty_eps = jnp.full((D, B, cfg.eps_records, 2), -1, jnp.int32)
    outs = (
        jnp.where(fa[:, None, None], em_rec, empty_em),
        jnp.where(fa[None, :, None, None], eps_recs, empty_eps),
        final_state.states,
        final_state.base[:, None] + final_state.costs,
        jnp.where(fa, num_active, 0),
        st.base + cutoff,
        fa & ovf_all,
        fa & sat_all,
    )
    return final_state, outs


@functools.lru_cache(maxsize=None)
def _build_sharded_lattice_chunk_fn(
    cfg: ShardLatticeConfig, mesh, model_axis: str, data_axis
):
    """jit(shard_map(...)): per-frame sharded lattice scan.

    Returns (stF, (em_rec (T,B,P*R,2), eps_rec (T,B,D,P*Re,2),
    frame_states (T,B,K_total local ids), frame_costs (T,B,K_total abs),
    num_active, cutoff, overflow, saturated — all (T,B)))."""
    fc = cfg.shard.frontier
    axis = model_axis

    def chunk(pg_parts, em_off, eps_off, scores, lengths, st0):
        pg = _pick_local(pg_parts)
        scores_tm = jnp.moveaxis(scores, 1, 0)
        ts = jnp.arange(scores_tm.shape[0], dtype=jnp.int32)

        def body(st, inp):
            sc_t, t = inp
            return _sharded_lattice_frame(
                st, sc_t, t < lengths, pg, cfg, axis, em_off[0], eps_off[0]
            )

        stf, outs = jax.lax.scan(body, st0, (scores_tm, ts))
        em_rec, eps_rec, fstates, fcosts, num_active, cutoff, ovf, sat = outs
        eps_rec = jnp.moveaxis(eps_rec, 1, 2)  # (T, B, D, Re, 2)
        return stf, (
            em_rec, eps_rec, fstates, fcosts, num_active, cutoff, ovf, sat
        )

    mspec = P(model_axis)
    pg_specs = PackedGraph(*([mspec] * len(PackedGraph._fields)))
    slot = P(data_axis, model_axis)
    st_spec = StepState(states=slot, costs=slot, base=P(data_axis))
    bspec = P(None, data_axis)
    out_specs = (
        st_spec,
        (
            P(None, data_axis, model_axis),  # em_rec (T, B, P*R, 2)
            P(None, data_axis, None, model_axis),  # eps_rec (T,B,D,P*Re,2)
            P(None, data_axis, model_axis),  # frame_states (T, B, K_total)
            P(None, data_axis, model_axis),  # frame_costs
            bspec, bspec, bspec, bspec,
        ),
    )
    fn = shard_map(
        chunk,
        mesh=mesh,
        in_specs=(
            pg_specs, mspec, mspec, P(data_axis), P(data_axis), st_spec,
        ),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def _build_sharded_lattice_init_fn(
    cfg: ShardLatticeConfig, mesh, model_axis: str, data_axis
):
    """Start-state frontier + record-emitting routed eps closure."""

    def init(pg_parts, eps_off, st0):
        pg = _pick_local(pg_parts)
        st, recs, _, _ = _sharded_lattice_eps_closure(
            st0, jnp.float32(INF), pg, cfg, model_axis, eps_off[0]
        )
        return st, jnp.moveaxis(recs, 0, 1)  # (B, D, Re, 2)

    mspec = P(model_axis)
    pg_specs = PackedGraph(*([mspec] * len(PackedGraph._fields)))
    slot = P(data_axis, model_axis)
    st_spec = StepState(states=slot, costs=slot, base=P(data_axis))
    fn = shard_map(
        init,
        mesh=mesh,
        in_specs=(pg_specs, mspec, st_spec),
        out_specs=(st_spec, P(data_axis, None, model_axis)),
        check_vma=False,
    )
    return jax.jit(fn)


class ShardedLatticeDecoder:
    """Lattice-generating decoder over a state-sharded graph (the sharded
    LatticeFasterDecoder capability: lattice generation + global
    adaptive-beam/max-active pruning — BASELINE config #5).

    Host-side results reuse :class:`..decoders.lattice.LatticeResult`
    unchanged: records carry global (state, arc) ids and per-frame
    frontiers are concatenated across shards.
    """

    def __init__(
        self,
        graph: CsrGraph,
        config: Optional[FrontierConfig] = None,
        lattice_beam: float = 10.0,
        mesh: Optional[Mesh] = None,
        model_axis: str = "model",
        data_axis: str = "data",
        em_records: Optional[int] = None,
        eps_records: Optional[int] = None,
        route_cap: Optional[int] = None,
        pad_time_to: int = 32,
    ):
        from kaldi_decoder_tpu.decoders.frontier import config_for_graph

        if mesh is None:
            raise ValueError("ShardedLatticeDecoder requires a mesh")
        self.graph = graph
        self.mesh = mesh
        self.model_axis = model_axis
        self.data_axis = data_axis if data_axis in mesh.axis_names else None
        self.pad_time_to = pad_time_to
        self.lattice_beam = float(lattice_beam)
        P_ = mesh.shape[model_axis]
        fc = config if config is not None else config_for_graph(graph)
        self._sg = shard_graph(
            graph, P_, fc.block_width, fc.eps_block_width, fc.flat_group
        )
        self.cfg = shard_lattice_config_for(
            self._sg, fc, lattice_beam, em_records, eps_records, route_cap
        )
        self._pg_dev = jax.tree.map(jnp.asarray, self._sg.packed)
        self._em_off = jnp.asarray(self._sg.em_arc_offset)
        self._eps_off = jnp.asarray(self._sg.eps_arc_offset)
        self._chunk_fn = _build_sharded_lattice_chunk_fn(
            self.cfg, mesh, model_axis, self.data_axis
        )
        self._init_fn = _build_sharded_lattice_init_fn(
            self.cfg, mesh, model_axis, self.data_axis
        )

    def _slot_offsets(self) -> np.ndarray:
        sc = self.cfg.shard
        return np.repeat(
            np.arange(sc.num_parts, dtype=np.int32) * sc.part_size, sc.k_local
        )

    def _init_state(self, batch: int) -> StepState:
        sc = self.cfg.shard
        start = self.graph.start_state
        owner, local = divmod(start, sc.part_size)
        states = np.zeros((batch, sc.k_total), np.int32)
        costs = np.full((batch, sc.k_total), np.float32(np.inf))
        slot = owner * sc.k_local
        states[:, slot] = local
        costs[:, slot] = 0.0
        return StepState(
            jnp.asarray(states), jnp.asarray(costs),
            jnp.zeros((batch,), jnp.float32),
        )

    def decode(self, scores: np.ndarray, lengths: Optional[np.ndarray] = None):
        from kaldi_decoder_tpu.decoders.lattice import LatticeResult
        from kaldi_decoder_tpu.decoders.lattice_dev import LatticeDevConfig
        from kaldi_decoder_tpu.decoders.viterbi import _round_up

        scores = np.asarray(scores, np.float32)
        if scores.ndim == 2:
            scores = scores[None]
        B, T, V = scores.shape
        if lengths is None:
            lengths = np.full((B,), T, np.int32)
        lengths = np.asarray(lengths, np.int32)
        bmul = self.mesh.shape[self.data_axis] if self.data_axis else 1
        Bp = _round_up(B, bmul)
        Tp = max(_round_up(T, self.pad_time_to), self.pad_time_to)
        scores_p = np.zeros((Bp, Tp, V), np.float32)
        scores_p[:B, :T] = scores
        lengths_p = np.zeros((Bp,), np.int32)
        lengths_p[:B] = lengths

        st0 = self._init_state(Bp)
        st0, init_recs = self._init_fn(self._pg_dev, self._eps_off, st0)
        stf, outs = self._chunk_fn(
            self._pg_dev, self._em_off, self._eps_off,
            jnp.asarray(scores_p), jnp.asarray(lengths_p), st0,
        )
        em_rec, eps_rec, fstates, fcosts, num_active, cutoff, ovf, sat = outs
        offs = self._slot_offsets()
        S = self.graph.num_states
        init_states = np.minimum(np.asarray(st0.states)[0] + offs, S - 1)
        init_costs = np.asarray(st0.base)[0, None] + np.asarray(st0.costs)[0]
        frame_states = np.minimum(np.asarray(fstates) + offs[None, None, :], S - 1)
        sc = self.cfg.shard
        result_cfg = LatticeDevConfig(
            frontier=dataclasses.replace(
                sc.frontier, frontier_size=sc.k_total
            ),
            em_records=sc.num_parts * self.cfg.em_records,
            eps_records=sc.num_parts * self.cfg.eps_records,
            lattice_beam=self.lattice_beam,
        )
        return LatticeResult(
            graph=self.graph,
            cfg=result_cfg,
            lattice_beam=self.lattice_beam,
            scores=scores,
            lengths=lengths,
            init_states=init_states,
            init_costs=init_costs,
            init_eps_records=np.asarray(init_recs)[0],
            frame_states=frame_states,
            frame_costs=np.asarray(fcosts),
            em_records=np.asarray(em_rec),
            eps_records=np.asarray(eps_rec),
            num_active=np.asarray(num_active),
            cutoffs=np.asarray(cutoff),
            overflows=np.asarray(ovf),
            saturations=np.asarray(sat),
            fold=None,
        )
