"""Packed device graph layout for fast frontier expansion.

Why this exists: expanding tens of thousands of arcs per frame through
3-5 separate per-field element gathers pays the per-index gather cost
once per field.  Row gathers amortize it: one gather of K packed rows
fetches every field of K arcs at once.

So the per-arc fields the device reads (weight, nextstate, score_idx) are
bit-packed into int32 rows:

* ``em_block (S, W*3 + 2)`` — each state's first W emitting arcs plus a
  trailing ``[row_lo, deg]`` header, one row per state: the frontier's
  block expansion is ONE row gather (the header rides along for free —
  row-gather cost is per *row*, not per byte — and eliminates the two
  separate ``row_ptr`` element gathers per expansion).
* ``em_flat (ceil(E/4), 4*3)`` — all emitting arcs packed FLAT_GROUP=4 per
  row, for the remainder path (arcs beyond W of fat states).  Each
  remainder row-gather covers 4 arcs: 4x the lane capacity per gather
  index (a remainder "unit" u holds arcs
  [4u, 4u+4), and a state's tail [row_lo+W, row_lo+deg) maps to the unit
  range containing it, with per-arc masks for the ragged ends).
* analogous ``eps_block (S, We*2 + 2)`` / ``eps_flat (E_eps, 2)`` with
  fields (weight, nextstate).

Labels (ilabel/olabel) are *host-only*: lattice reconstruction and
backtrace look them up by global arc id in ``graph.arrays``, so they never
cross to the device.  For the same reason the block tables are built **on
device** from the flat arrays by :func:`pack_graph_device` (blocks
duplicate flat data ~W-fold, so this cuts the host→device bytes of a
cold start).

Weights are float32 bit-cast into the int32 word (lossless);
``jax.lax.bitcast_convert_type`` recovers them on device.  Arc order in
blocks matches the flat CSR order, so ``arc_id = row_ptr[s] + w`` holds
for block lanes and backpointers/lattice records stay globally indexed.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from kaldi_decoder_tpu.fst.csr import CsrGraph

INF_BITS = np.float32(np.inf).view(np.int32)

EM_FIELDS = 3  # weight, next, score_idx
EPS_FIELDS = 2  # weight, next
# Default emitting arcs per em_flat row (remainder packing).  Larger
# groups cut the remainder path's gather count proportionally; the price
# is ragged-end lane waste (~G/2 lanes per fat state), so graphs whose
# remainder mass comes from a few long-tailed hubs want G=8..16 while
# graphs with many short tails want G=4.  FrontierConfig.flat_group
# selects per decoder; this constant is only the default.
FLAT_GROUP = 4


class PackedGraph(NamedTuple):
    """Device pytree of packed graph tables."""

    em_row_ptr: object  # (S+1,) int32
    em_block: object  # (S, W_em * 3 + 2) int32 — arcs + [row_lo, deg]
    em_flat: object  # (ceil(E_em/4), 4*3) int32 — FLAT_GROUP arcs per row
    eps_row_ptr: object  # (S+1,) int32
    eps_block: object  # (S, W_eps * 2 + 2) int32 — arcs + [row_lo, deg]
    eps_flat: object  # (E_eps, 2) int32
    final_cost: object  # (S,) float32


def _pack_rows(fields, pad_values):
    """Stack per-arc int32 field columns -> (E, F) int32."""
    return np.stack(fields, axis=1).astype(np.int32)


def pack_graph(
    graph: CsrGraph, w_em: int, w_eps: int, flat_group: int = FLAT_GROUP
) -> PackedGraph:
    ga = graph.arrays
    S = graph.num_states
    E = graph.num_emitting_arcs
    Ee = graph.num_eps_arcs

    em_w_bits = np.ascontiguousarray(ga.em_weight).view(np.int32)
    em_flat = np.stack(
        [em_w_bits, ga.em_next, ga.em_score_idx],
        axis=1,
    ).astype(np.int32) if E else np.zeros((0, EM_FIELDS), np.int32)

    em_block = np.empty((S, w_em, EM_FIELDS), np.int32)
    em_block[..., 0] = INF_BITS  # weight = +inf marks padding
    em_block[..., 1:] = 0
    deg = np.diff(ga.em_row_ptr)
    take = np.minimum(deg, w_em)
    # Vectorized fill: lane (s, w) holds arc em_row_ptr[s] + w when w < take.
    s_idx = np.repeat(np.arange(S), take)
    w_idx = np.arange(int(take.sum())) - np.repeat(np.cumsum(take) - take, take)
    arc_idx = ga.em_row_ptr[:-1].astype(np.int64).repeat(take) + w_idx
    em_block[s_idx, w_idx] = em_flat[arc_idx]
    em_hdr = np.stack(
        [ga.em_row_ptr[:-1].astype(np.int32), deg.astype(np.int32)], axis=1
    )

    eps_w_bits = (
        np.ascontiguousarray(ga.eps_weight).view(np.int32)
        if Ee
        else np.zeros(0, np.int32)
    )
    eps_flat = (
        np.stack([eps_w_bits, ga.eps_next], axis=1).astype(np.int32)
        if Ee
        else np.zeros((0, EPS_FIELDS), np.int32)
    )
    eps_block = np.empty((S, w_eps, EPS_FIELDS), np.int32)
    eps_block[..., 0] = INF_BITS
    eps_block[..., 1:] = 0
    edeg = np.diff(ga.eps_row_ptr)
    if Ee:
        etake = np.minimum(edeg, w_eps)
        s_idx = np.repeat(np.arange(S), etake)
        w_idx = np.arange(int(etake.sum())) - np.repeat(
            np.cumsum(etake) - etake, etake
        )
        arc_idx = ga.eps_row_ptr[:-1].astype(np.int64).repeat(etake) + w_idx
        eps_block[s_idx, w_idx] = eps_flat[arc_idx]
    eps_hdr = np.stack(
        [ga.eps_row_ptr[:-1].astype(np.int32), edeg.astype(np.int32)], axis=1
    )

    # Pack the flat table flat_group arcs per row (pad rows get +inf
    # weights so stray lanes self-invalidate).
    G = flat_group
    n_units = (E + G - 1) // G if E else 0
    em_flat_p = np.empty((n_units * G, EM_FIELDS), np.int32)
    em_flat_p[:, 0] = INF_BITS
    em_flat_p[:, 1:] = 0
    em_flat_p[:E] = em_flat

    return PackedGraph(
        em_row_ptr=ga.em_row_ptr,
        em_block=np.concatenate(
            [em_block.reshape(S, w_em * EM_FIELDS), em_hdr], axis=1
        ),
        em_flat=em_flat_p.reshape(n_units, G * EM_FIELDS),
        eps_row_ptr=ga.eps_row_ptr,
        eps_block=np.concatenate(
            [eps_block.reshape(S, w_eps * EPS_FIELDS), eps_hdr], axis=1
        ),
        eps_flat=eps_flat,
        final_cost=ga.final_cost,
    )


@functools.lru_cache(maxsize=None)
def _build_blocks_fn(w_em: int, w_eps: int):
    """Jitted device construction of the block tables from flat arrays.

    The blocks duplicate the flat arc data ~W-fold; building them on device
    keeps them off the host→device copy (an HLG-scale packed graph is tens
    of MB of blocks vs a few MB of flat arrays)."""
    import jax
    import jax.numpy as jnp

    def blocks(row_ptr, flat, w: int, nfields: int):
        S = row_ptr.shape[0] - 1
        lo = row_ptr[:-1].astype(jnp.int32)
        deg = (row_ptr[1:] - row_ptr[:-1]).astype(jnp.int32)
        lane = jnp.arange(w, dtype=jnp.int32)
        valid = lane[None, :] < deg[:, None]
        arc = jnp.where(valid, lo[:, None] + lane[None, :], 0)
        if flat.shape[0] == 0:
            rows = jnp.zeros((S, w, nfields), jnp.int32)
        else:
            rows = flat.reshape(-1, nfields)[arc]
        w_bits = jnp.where(valid, rows[..., 0], jnp.int32(INF_BITS))
        rest = jnp.where(valid[..., None], rows[..., 1:], 0)
        blk = jnp.concatenate([w_bits[..., None], rest], axis=-1)
        return jnp.concatenate(
            [blk.reshape(S, w * nfields), lo[:, None], deg[:, None]], axis=1
        ).astype(jnp.int32)

    @jax.jit
    def build(em_row_ptr, em_flat, eps_row_ptr, eps_flat, final_cost):
        return PackedGraph(
            em_row_ptr=em_row_ptr,
            em_block=blocks(em_row_ptr, em_flat, w_em, EM_FIELDS),
            em_flat=em_flat,
            eps_row_ptr=eps_row_ptr,
            eps_block=blocks(eps_row_ptr, eps_flat, w_eps, EPS_FIELDS),
            eps_flat=eps_flat,
            final_cost=final_cost,
        )

    return build


def pack_graph_device(
    graph: CsrGraph, w_em: int, w_eps: int, flat_group: int = FLAT_GROUP
) -> PackedGraph:
    """Packed graph as device arrays, transferring only the flat tables
    (em/eps CSR + final costs) and building the block tables on device —
    same result as ``jax.tree.map(jnp.asarray, pack_graph(...))`` with a
    fraction of the wire bytes."""
    import jax.numpy as jnp

    ga = graph.arrays
    E = graph.num_emitting_arcs
    Ee = graph.num_eps_arcs
    G = flat_group

    em_w_bits = (
        np.ascontiguousarray(ga.em_weight).view(np.int32)
        if E
        else np.zeros(0, np.int32)
    )
    em_flat = (
        np.stack([em_w_bits, ga.em_next, ga.em_score_idx], axis=1).astype(
            np.int32
        )
        if E
        else np.zeros((0, EM_FIELDS), np.int32)
    )
    n_units = (E + G - 1) // G if E else 0
    em_flat_p = np.empty((n_units * G, EM_FIELDS), np.int32)
    em_flat_p[:, 0] = INF_BITS
    em_flat_p[:, 1:] = 0
    em_flat_p[:E] = em_flat

    eps_w_bits = (
        np.ascontiguousarray(ga.eps_weight).view(np.int32)
        if Ee
        else np.zeros(0, np.int32)
    )
    eps_flat = (
        np.stack([eps_w_bits, ga.eps_next], axis=1).astype(np.int32)
        if Ee
        else np.zeros((0, EPS_FIELDS), np.int32)
    )

    build = _build_blocks_fn(w_em, w_eps)
    return build(
        jnp.asarray(ga.em_row_ptr.astype(np.int32)),
        jnp.asarray(em_flat_p.reshape(n_units, G * EM_FIELDS)),
        jnp.asarray(ga.eps_row_ptr.astype(np.int32)),
        jnp.asarray(eps_flat),
        jnp.asarray(ga.final_cost),
    )


def degree_percentile(graph: CsrGraph, q: float = 0.95, eps: bool = False) -> int:
    ga = graph.arrays
    deg = np.diff(ga.eps_row_ptr if eps else ga.em_row_ptr)
    if len(deg) == 0 or deg.max() == 0:
        return 1
    return int(np.quantile(deg[deg > 0], q)) if (deg > 0).any() else 1
