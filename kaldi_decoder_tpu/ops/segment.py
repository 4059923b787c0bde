"""Fixed-shape segmented primitives for frontier expansion and dedup.

These replace the reference's pointer/hash machinery with dense array ops
that XLA compiles without data-dependent shapes:

* :func:`map_lanes` — map ragged per-slot counts onto a flat lane budget
  (the exclusive-scan + "which slot owns lane j" problem).  Both the lane
  ids and the segment starts are sorted, so a scatter of slot ids at
  segment starts followed by a running max (``associative_scan``)
  computes the mapping in O(A + K) vector ops, with no per-lane binary
  search.
* :func:`dedup_select` — scatter-min dedup by destination state plus
  top-K frontier selection, replacing ``HashList::Insert``'s
  keep-the-cheaper-token rule (`hash-list-inl.h:128-173` as used at
  `faster-decoder.cc:212-228`): candidates sorted by (state, cost), the
  first of each state segment is its minimum, then the K cheapest
  winners form the new frontier.  Ties prefer the earlier candidate,
  matching the reference's keep-existing-on-tie behavior when incumbents
  are passed first.
* :func:`score_lookup` — acoustic-score gather ``scores[t, idx]``.

Everything is fixed-shape and jit/vmap-friendly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

INF = jnp.inf


class LaneMap(NamedTuple):
    owner: jnp.ndarray  # (A,) int32 — slot that owns each lane
    within: jnp.ndarray  # (A,) int32 — lane's index within the owner's segment
    valid: jnp.ndarray  # (A,) bool
    total: jnp.ndarray  # () int32 — true number of lanes needed (may be > A)


def map_lanes(counts: jnp.ndarray, budget: int) -> LaneMap:
    """Distribute ``counts[i]`` consecutive lanes per slot over ``budget``
    flat lanes.  Lanes beyond the budget are dropped (callers keep slots
    sorted by cost, so dropped lanes belong to the worst slots)."""
    K = counts.shape[0]
    csum = jnp.cumsum(counts)
    total = csum[-1]
    starts = csum - counts
    slot_ids = jnp.arange(K, dtype=jnp.int32)
    # Scatter each non-empty slot's id at its segment start, then running
    # max fills the segment.  Starts of non-empty slots are strictly
    # increasing, so there are no collisions; drop-mode handles starts
    # beyond the budget.
    owner0 = jnp.zeros(budget, jnp.int32).at[
        jnp.where(counts > 0, starts, budget)
    ].max(slot_ids, mode="drop")
    owner = jax.lax.associative_scan(jnp.maximum, owner0)
    j = jnp.arange(budget, dtype=jnp.int32)
    within = j - (csum[owner] - counts[owner])
    valid = j < total
    return LaneMap(owner=owner, within=within, valid=valid, total=total)


class Selection(NamedTuple):
    states: jnp.ndarray  # (K,) int32 — new frontier states (sorted by cost)
    costs: jnp.ndarray  # (K,) float32 — +inf for empty slots
    cand_idx: jnp.ndarray  # (K,) int32 — winning candidate index (into inputs)
    # True number of distinct in-beam states (may exceed K: the frontier
    # then silently capped the beam at its K cheapest — a capacity
    # semantics divergence from the reference, which has no such limit).
    num_unique: jnp.ndarray  # () int32


class SelectionRec(NamedTuple):
    states: jnp.ndarray
    costs: jnp.ndarray
    cand_idx: jnp.ndarray
    num_unique: jnp.ndarray
    # Lattice records: a tuple of (R,) arrays (one per payload input, or a
    # single candidate-index array when no payload was given), -1 padded.
    # Winner links ride first, then smallest-slack extras — see
    # dedup_select_rec.  NOT aligned with frontier slots; consumers treat
    # records as a masked set (lattice/prune.py filters arc >= 0).
    recs: tuple
    rec_overflow: jnp.ndarray  # () bool — eligible links exceeded R
    # With sweep_cols=True: per record its destination STATE and link
    # slack (cand_cost - winner_cost(dst), >= 0), the two quantities the
    # device-side backward extra-cost sweep needs
    # (`lattice-simple-decoder.cc:254-296` slack semantics).  -1 / +inf
    # on padding rows.  Both ride the existing sorts (dst is the first
    # sort key; slack is the record-selection key), so they are free of
    # extra gathers.
    rec_dst: Optional[jnp.ndarray] = None  # (R,) int32
    rec_slack: Optional[jnp.ndarray] = None  # (R,) float32


def _sort_by_state(cand_state, cand_cost, num_states, payload=(),
                   need_idx=True):
    """One stable 2-key sort by (state, cost).

    With cost as the second key, each equal-state run is internally
    cost-ascending, so the run's FIRST lane is its per-state minimum —
    the scatter-min winner — with ties keeping the earliest candidate
    (matching HashList keep-existing-on-tie when incumbents are passed
    first, `hash-list-inl.h:128-173`).  Payload arrays ride the sort as
    extra operands, so no post-hoc random gather of the same data is
    needed.

    ``need_idx=False`` drops the candidate-index operand (callers that
    use neither ``cand_idx`` backpointers nor incumbent filtering — the
    lattice emitting stage — save one sort operand; ``i2`` comes back
    None).
    """
    n = cand_state.shape[0]
    invalid = ~jnp.isfinite(cand_cost)
    skey = jnp.where(invalid, num_states, cand_state)
    if need_idx:
        idx = jnp.arange(n, dtype=jnp.int32)
        s2, c2, i2, *pay2 = jax.lax.sort(
            (skey, cand_cost, idx) + tuple(payload), num_keys=2
        )
    else:
        s2, c2, *pay2 = jax.lax.sort(
            (skey, cand_cost) + tuple(payload), num_keys=2
        )
        i2 = None
    leader = jnp.concatenate([jnp.ones((1,), bool), s2[1:] != s2[:-1]])
    return s2, c2, i2, tuple(pay2), leader


def _select(s2, c2, i2, leader, k: int, num_states: int):
    """K cheapest run leaders form the new frontier (no scan needed: the
    leader lane already holds the run minimum after the 2-key sort).
    Returns (Selection, pos) with ``pos`` the winning sorted positions.
    With ``i2=None`` (need_idx=False sort) ``cand_idx`` is all -1."""
    lcost = jnp.where(leader & (s2 < num_states), c2, INF)
    # top_k ties keep the lower index, i.e. the earlier state-sorted
    # position — the same tie-break a stable cost-sort gives.
    neg, pos = jax.lax.top_k(-lcost, k)
    costs = -neg
    live = jnp.isfinite(costs)
    if i2 is None:
        cand_idx = jnp.full((k,), -1, jnp.int32)
    else:
        cand_idx = jnp.where(live, i2[pos], -1).astype(jnp.int32)
    sel = Selection(
        states=jnp.where(live, s2[pos], 0).astype(jnp.int32),
        costs=costs,
        cand_idx=cand_idx,
        num_unique=jnp.sum(jnp.isfinite(lcost)).astype(jnp.int32),
    )
    return sel, pos


def dedup_select(
    cand_state: jnp.ndarray,  # (N,) int32 destination state per candidate
    cand_cost: jnp.ndarray,  # (N,) float32 (+inf == invalid candidate)
    k: int,  # frontier capacity (static)
    num_states: int,  # S — used as the invalid-state sentinel (static)
) -> Selection:
    """Per-state min-cost dedup, then keep the K cheapest states.

    The returned frontier is sorted by increasing cost (empty slots at the
    end with cost +inf); ``cand_idx`` recovers backpointer info for each
    selected slot.
    """
    s2, c2, i2, _, leader = _sort_by_state(cand_state, cand_cost, num_states)
    sel, _ = _select(s2, c2, i2, leader, k, num_states)
    return sel


def dedup_select_rec(
    cand_state: jnp.ndarray,
    cand_cost: jnp.ndarray,
    k: int,
    num_states: int,
    r: int,  # record buffer capacity (static)
    slack_beam: float = INF,  # lattice_beam: links above can never survive
    num_incumbents: int = 0,  # leading candidates that are carried tokens,
    # not links (the eps-relaxation incumbent-first pattern)
    payload: Optional[tuple] = None,  # (N,) int32 arrays to emit as records
    sweep_cols: bool = False,  # also emit (rec_dst, rec_slack) per record
    need_idx: bool = True,  # False drops the sort's candidate-index
    # operand (valid only with num_incumbents=0 and an explicit payload;
    # cand_idx comes back -1)
) -> SelectionRec:
    """dedup_select + lattice record selection by link slack.

    Records (`lattice-simple-decoder.cc:393-398`) are the frontier
    winners' own links (every surviving token's BEST incoming link —
    lattice connectivity and the exact best path are never lost to
    record overflow) plus up to the remaining budget of extra links
    chosen by smallest **slack** ``cand_cost - winner_cost(dst)``.  A
    link's eventual extra cost in the backward sweep is
    ``extra(dst) + slack >= slack`` (`lattice-simple-decoder.cc:254-296`),
    so links with ``slack > lattice_beam`` are *provably* pruned later
    and are filtered out here for free — the budget holds exactly the
    links that can still matter, and record overflow means actual
    potential lattice loss, with the largest-slack (least likely to
    survive) links dropped first.

    The record columns are ``payload`` values carried through the sorts
    (zero gathers); with ``payload=None`` the single record column is the
    candidate index.  Records come out winners-first then slack-ascending
    — consumers must treat them as a masked set, not slot-aligned rows.
    """
    if payload is None:
        n = cand_state.shape[0]
        payload = (jnp.arange(n, dtype=jnp.int32),)
    if not need_idx:
        assert num_incumbents == 0, "need_idx=False requires no incumbents"
    s2, c2, i2, pay2, leader = _sort_by_state(
        cand_state, cand_cost, num_states, payload, need_idx=need_idx
    )
    sel, pos = _select(s2, c2, i2, leader, k, num_states)
    n = c2.shape[0]

    if r <= k:
        # Winners-only budget: records are the frontier winners in slot
        # order (the 1-best Viterbi-forest mode).
        posk = pos[:r]
        okr = jnp.isfinite(sel.costs[:r])
        if num_incumbents:
            okr = okr & (sel.cand_idx[:r] >= num_incumbents)
        recs = tuple(
            jnp.where(okr, p[posk], -1).astype(jnp.int32) for p in pay2
        )
        num_valid = jnp.sum(jnp.isfinite(c2)).astype(jnp.int32)
        rec_dst = rec_slack = None
        if sweep_cols:
            # Winner links: dst is the slot's own state, slack 0.
            rec_dst = jnp.where(okr, sel.states[:r], -1)
            rec_slack = jnp.where(okr, 0.0, INF).astype(jnp.float32)
        return SelectionRec(
            states=sel.states,
            costs=sel.costs,
            cand_idx=sel.cand_idx,
            num_unique=sel.num_unique,
            recs=recs,
            rec_overflow=num_valid > r,
            rec_dst=rec_dst,
            rec_slack=rec_slack,
        )

    # Per-lane run minimum via a segmented forward fill (copy the leader's
    # cost down its run); one small 2-tuple scan.
    def fill_op(a, b):
        fa, ca = a
        fb, cb = b
        return (fa | fb, jnp.where(fb, cb, ca))

    _, run_min = jax.lax.associative_scan(fill_op, (leader, c2))
    slack = c2 - run_min

    # Did this lane's run make the frontier?  Exactly when its minimum is
    # within the K-th selected leader cost (sel.costs is ascending; empty
    # slots are +inf so a non-full frontier keeps every live run).  On a
    # boundary cost-tie under saturation this may admit a run top_k
    # dropped — a stray record into a token absent from the next
    # frontier, which the host link collector discards (prune.py filters
    # dst tokens), so only budget is spent, never correctness.
    run_sel = run_min <= sel.costs[k - 1]
    finite = jnp.isfinite(c2)
    is_link = i2 >= num_incumbents if num_incumbents else jnp.ones((n,), bool)
    win_link = leader & run_sel & finite & is_link
    extra_ok = (
        (~leader) & run_sel & finite & is_link & (slack <= slack_beam)
    )
    # Winner links first (key -1 guarantees them a slot), then extras by
    # ascending slack; the stable sort keeps state-sorted order on ties.
    key = jnp.where(win_link, -1.0, jnp.where(extra_ok, slack, INF))
    ops2 = (key,) + pay2 + ((s2,) if sweep_cols else ())
    sorted2 = jax.lax.sort(ops2, num_keys=1)
    take = min(r, n)
    ok_r = sorted2[0][:take] < INF
    npay = len(pay2)
    recs = tuple(
        jnp.where(ok_r, p[:take], -1).astype(jnp.int32)
        for p in sorted2[1 : 1 + npay]
    )
    rec_dst = rec_slack = None
    if sweep_cols:
        rec_dst = jnp.where(ok_r, sorted2[1 + npay][:take], -1).astype(
            jnp.int32
        )
        # Winner rows carry key -1 but their true slack is 0 by
        # definition (the leader lane is its run's minimum).
        rec_slack = jnp.where(
            ok_r, jnp.maximum(sorted2[0][:take], 0.0), INF
        ).astype(jnp.float32)
    if take < r:  # record budget beyond the candidate count: pad
        pad = jnp.full((r - take,), -1, jnp.int32)
        recs = tuple(jnp.concatenate([p, pad]) for p in recs)
        if sweep_cols:
            rec_dst = jnp.concatenate([rec_dst, pad])
            rec_slack = jnp.concatenate(
                [rec_slack, jnp.full((r - take,), INF, jnp.float32)]
            )
    rec_overflow = jnp.sum(key < INF) > r
    return SelectionRec(
        states=sel.states,
        costs=sel.costs,
        cand_idx=sel.cand_idx,
        num_unique=sel.num_unique,
        recs=recs,
        rec_overflow=rec_overflow,
        rec_dst=rec_dst,
        rec_slack=rec_slack,
    )


def score_lookup(
    score_idx: jnp.ndarray,  # (A,) int32 in [0, V)
    scores_t: jnp.ndarray,  # (V,) float32 log-probs for this frame
) -> jnp.ndarray:
    """Acoustic log-prob per lane (the fused DecodableCtc lookup,
    `decodable-ctc.cc:22-29`).  A plain gather: exact in float32, where a
    one-hot matmul would round the scores to the matmul's precision."""
    return scores_t[score_idx]
