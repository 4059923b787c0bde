"""Device-side windowed backward extra-cost sweep.

The reference prunes its token/link structure with a backward sweep every
``prune_interval`` frames (``PruneActiveTokens``,
`kaldi-decoder/csrc/lattice-simple-decoder.cc:198-223`, link extra cost
recurrence at `:254-296`).  Running that sweep on the host would mean
downloading the FULL per-frame record buffers (~0.5 GB per bench batch).

This module runs the same *windowed* sweep on device, as a reverse
``lax.scan`` over the chunk's stacked frame outputs, and compacts the
surviving tokens/links into small cross-frame buffers; the host then
reconstructs and exact-prunes only survivors (typically 100-1000x fewer
rows).  Semantics mirror :class:`kaldi_decoder_tpu.lattice.prune
.IncrementalLattice`: the chunk-boundary frontier gets extra cost 0 (the
Token-constructor initialisation, `lattice-simple-decoder.h:200`), so
everything pruned here is *provably* outside the final lattice; the
host's final exact sweep (float64) reproduces the reference's
``FinalizeDecoding`` on the survivors.

Conservativeness invariants (nothing the exact sweep keeps is dropped):

* chunk boundaries and utterance-final frames use extra = 0 — a LOWER
  bound on any token's true extra cost, so the window-boundary argument
  is conservative by construction;
* the intra-frame eps Bellman converges to its fixed point FROM ABOVE
  (each pass only lowers the min), so an under-iterated estimate would
  OVER-prune — the iteration therefore runs to quiescence with an
  early-out (bounded by the acyclic eps depth, or by the live-state
  count for cyclic-eps graphs) and any frame still improving at the
  bound raises the sweep overflow flag, which makes ``_finish`` fall
  back to the exact full-download host prune;
* all float32 comparisons carry a +1e-3 margin vs the host's float64.

Record rows are ``[src_state, arc_id, dst_state, slack_bits]`` (see
``lattice_dev.REC_COLS``); slack is the link's
``alpha(src)+graph+acoustic-alpha(dst)`` computed exactly at emission, so
the sweep needs no arc-weight or acoustic gathers at all.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

INF = jnp.inf
MARGIN = 1e-3  # f32 sweep vs f64 host-final-prune safety margin


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Static sweep shapes (capacities scale with the chunk length)."""

    frontier_size: int  # K
    em_records: int  # R per frame
    eps_records: int  # Re per frame per iteration
    eps_iters: int  # D
    eps_exact: bool  # D is the graph's exact acyclic eps depth
    chunk_frames: int  # T
    lattice_beam: float
    tok_cap: int  # token buffer rows per utterance (excl. final K block)
    em_cap: int  # em-link buffer rows (excl. final R block)
    eps_cap: int  # eps-link buffer rows


def sweep_config(cfg, chunk_frames: int) -> SweepConfig:
    """Derive sweep capacities from a LatticeDevConfig + chunk length.

    The zero-extra chunk boundary keeps ~the full frontier at the last
    frame and decays within a few frames (slack accumulates per frame),
    so capacities are one frontier/record block plus a per-frame
    allowance."""
    fc = cfg.frontier
    T = chunk_frames
    # At bench scale the zero-boundary windowed prune keeps ~30-140
    # links/frame on noisy stretches, so the caps allow ~16x the
    # final-lattice density before flagging.
    return SweepConfig(
        frontier_size=fc.frontier_size,
        em_records=cfg.em_records,
        eps_records=cfg.eps_records,
        eps_iters=fc.eps_iters,
        eps_exact=fc.eps_exact,
        chunk_frames=T,
        lattice_beam=float(cfg.lattice_beam),
        tok_cap=fc.frontier_size + 192 * T,
        em_cap=cfg.em_records + 320 * T,
        eps_cap=max(64 * T, 8),
    )


class SweepOut(NamedTuple):
    """Per-utterance survivor buffers (rows beyond count are garbage)."""

    tok_rows: jnp.ndarray  # (tok_cap + K, 3): [frame, state, alpha_bits]
    tok_count: jnp.ndarray  # () int32
    em_rows: jnp.ndarray  # (em_cap + R, 3): [frame, src_state, arc_id]
    em_count: jnp.ndarray  # () int32
    eps_rows: jnp.ndarray  # (eps_cap + Re*D, 3): [frame, src_state, arc_id]
    eps_count: jnp.ndarray  # () int32
    overflow: jnp.ndarray  # () bool — any buffer exceeded its cap


def _join_min(keys: jnp.ndarray, states: jnp.ndarray, vals: jnp.ndarray):
    """min over {vals[k] : states[k] == key} per key (+inf when absent).

    Dense compare-reduce over an (n_keys, K) elementwise grid: no
    gathers or scatters, and fixed shapes."""
    eq = keys[:, None] == states[None, :]
    return jnp.min(jnp.where(eq, vals[None, :], INF), axis=1)


def _compact_rows(keep: jnp.ndarray, cols: tuple, frame, n: int):
    """Sort keep-rows first (stable), return ((n,3) rows, count)."""
    key = jnp.where(keep, jnp.arange(n, dtype=jnp.int32), n)
    sorted_ = jax.lax.sort((key,) + cols, num_keys=1)
    count = jnp.sum(keep).astype(jnp.int32)
    ok = sorted_[0] < n
    frame_col = jnp.where(ok, frame, -1).astype(jnp.int32)
    rows = jnp.stack(
        [frame_col]
        + [jnp.where(ok, c, -1).astype(jnp.int32) for c in sorted_[1:]],
        axis=-1,
    )
    return rows, count


def _append(buf, off, rows, count, cap):
    """Write a rows-block at off (clamped to cap); returns new (buf, off,
    overflowed)."""
    off_w = jnp.minimum(off, cap)
    buf = jax.lax.dynamic_update_slice(buf, rows, (off_w, 0))
    new_off = off_w + count
    return buf, jnp.minimum(new_off, cap + rows.shape[0]), new_off > cap


def _sweep_one(
    frontier_states,  # (T, K) i32
    frontier_costs,  # (T, K) f32 absolute alphas
    em_records,  # (T, R, 4) i32
    eps_records,  # (T, D, Re, 4) i32
    init_states,  # (K,) chunk-entry frontier states
    rem,  # () int32 — remaining utterance frames at chunk start
    sc: SweepConfig,
):
    T, K = sc.chunk_frames, sc.frontier_size
    beam = sc.lattice_beam

    boundary = jnp.minimum(rem, T)  # token-frame index with extra == 0

    tok_buf = jnp.full((sc.tok_cap + K, 3), -1, jnp.int32)
    em_buf = jnp.full((sc.em_cap + sc.em_records, 3), -1, jnp.int32)
    eps_buf = jnp.full(
        (sc.eps_cap + max(sc.eps_iters, 1) * sc.eps_records, 3), -1, jnp.int32
    )
    z = jnp.int32(0)

    def step(carry, inp):
        # carry: extras of token-frame t+1 (frontier[t] slot layout)
        extra_next, tok_off, em_off, eps_off, tok_buf, em_buf, eps_buf, ovf = (
            carry
        )
        t, states_t1, alpha_t1, em_t, eps_t = inp
        f = t + 1  # token-frame index of frontier[t]
        live = jnp.isfinite(alpha_t1)

        # Boundary: the chunk's last frame and utterance-final frames get
        # extra 0 (IncrementalLattice live-frontier semantics).
        at_boundary = f >= boundary
        emit = f <= boundary  # frames past the boundary are frozen
        extra = jnp.where(
            at_boundary, jnp.where(live, 0.0, INF), extra_next
        )

        # Epsilon refinement within frame f.  The Bellman iteration
        # converges to its fixed point FROM ABOVE (each pass only lowers
        # the min), so stopping early would leave extras too HIGH and
        # OVER-prune.  Iterate to quiescence with an early-out; the pass
        # bound is D+2 when the recorded eps subgraph is provably acyclic
        # with depth D (a recorded chain is <= D links), else the
        # live-state bound K (non-negative slacks converge in <= #states
        # passes; a negative-slack cycle — possible only when the forward
        # closure itself under-relaxed — never converges and is caught by
        # the bound).  A frame still improving at the bound raises the
        # sweep overflow flag -> exact host fallback.  eps_t: (D, Re, 4).
        D = sc.eps_iters
        eps_flat_keep = None
        eps_nonconv = jnp.bool_(False)
        if D:
            flat = eps_t.reshape(-1, 4)
            evalid = flat[:, 1] >= 0
            eslack = jax.lax.bitcast_convert_type(flat[:, 3], jnp.float32)

            def bell(ex):
                ex_dst = _join_min(flat[:, 2], states_t1, ex)
                le = jnp.where(evalid, ex_dst + eslack, INF)
                upd = _join_min(states_t1, flat[:, 0], jnp.maximum(le, 0.0))
                return jnp.minimum(ex, upd)

            bound = D + 2 if sc.eps_exact else min(K, flat.shape[0]) + 2

            def bell_cond(c):
                it, _, changed = c
                return changed & (it < bound)

            def bell_body(c):
                it, ex, _ = c
                ex2 = bell(ex)
                return it + 1, ex2, jnp.any(ex2 < ex)

            _, extra, still_changing = jax.lax.while_loop(
                bell_cond, bell_body, (jnp.int32(0), extra, jnp.bool_(True))
            )
            eps_nonconv = still_changing & emit
            ex_dst = _join_min(flat[:, 2], states_t1, extra)
            le_eps = jnp.where(evalid, ex_dst + eslack, INF)
            eps_flat_keep = le_eps <= beam + MARGIN

        # Emit frame-f tokens (skip frozen frames past the boundary).
        tok_keep = emit & live & (extra <= beam + 2 * MARGIN)
        tok_rows, tok_n = _compact_rows(
            tok_keep,
            (states_t1, jax.lax.bitcast_convert_type(alpha_t1, jnp.int32)),
            f,
            K,
        )
        tok_buf, tok_off, o1 = _append(tok_buf, tok_off, tok_rows, tok_n, sc.tok_cap)

        # Emit kept eps links of frame f.
        o2 = jnp.bool_(False)
        if D:
            flat_keep = emit & eps_flat_keep
            eps_rows, eps_n = _compact_rows(
                flat_keep, (flat[:, 0], flat[:, 1]), f, flat.shape[0]
            )
            eps_buf, eps_off, o2 = _append(
                eps_buf, eps_off, eps_rows, eps_n, sc.eps_cap
            )

        # Emitting links token-frame t -> t+1 (em_records[t]); their keep
        # test uses frame-(t+1) extras; the min over kept links per source
        # state becomes frame-t's base extra.
        valid = em_t[:, 1] >= 0
        slack = jax.lax.bitcast_convert_type(em_t[:, 3], jnp.float32)
        ex_dst = _join_min(em_t[:, 2], states_t1, extra)
        le = jnp.where(valid, ex_dst + slack, INF)
        keep = emit & (le <= beam + MARGIN)
        em_rows, em_n = _compact_rows(
            keep, (em_t[:, 0], em_t[:, 1]), t, sc.em_records
        )
        em_buf, em_off, o3 = _append(em_buf, em_off, em_rows, em_n, sc.em_cap)

        # Base extras for frame t (joined on the PREVIOUS frontier, which
        # the next reverse step receives as states_t1).
        prev_states = jnp.where(
            t > 0,
            frontier_states[jnp.maximum(t - 1, 0)],
            init_states,
        )
        base_prev = _join_min(
            prev_states, em_t[:, 0], jnp.where(keep, jnp.maximum(le, 0.0), INF)
        )
        new_carry = (
            base_prev, tok_off, em_off, eps_off, tok_buf, em_buf, eps_buf,
            ovf | o1 | o2 | o3 | eps_nonconv,
        )
        return new_carry, None

    ts = jnp.arange(T - 1, -1, -1, dtype=jnp.int32)
    inputs = (
        ts,
        frontier_states[::-1],
        frontier_costs[::-1],
        em_records[::-1],
        eps_records[::-1],
    )
    carry0 = (
        jnp.full((K,), INF, jnp.float32),  # overwritten by boundary at f>=T
        z, z, z, tok_buf, em_buf, eps_buf, jnp.bool_(False),
    )
    (extra0, tok_off, em_off, eps_off, tok_buf, em_buf, eps_buf, ovf), _ = (
        jax.lax.scan(step, carry0, inputs)
    )
    return SweepOut(
        tok_rows=tok_buf,
        tok_count=jnp.minimum(tok_off, sc.tok_cap),
        em_rows=em_buf,
        em_count=jnp.minimum(em_off, sc.em_cap),
        eps_rows=eps_buf,
        eps_count=jnp.minimum(eps_off, sc.eps_cap),
        overflow=ovf,
    )


@functools.lru_cache(maxsize=None)
def build_sweep_fn(sc: SweepConfig):
    """Jitted batched sweep: (outs arrays (T, B, ...), init_states (B, K),
    rem (B,)) -> SweepOut batched over B."""

    def sweep(frontier_states, frontier_costs, em_records, eps_records,
              init_states, rem):
        return jax.vmap(
            lambda fs, fc_, em, ep, ini, r: _sweep_one(
                fs, fc_, em, ep, ini, r, sc
            ),
            in_axes=(1, 1, 1, 1, 0, 0),
        )(frontier_states, frontier_costs, em_records, eps_records,
          init_states, rem)

    return jax.jit(sweep)
