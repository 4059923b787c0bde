"""Beam / max-active / min-active cutoff computation (GetCutoff parity).

Reimplements the decision logic of ``FasterDecoder::GetCutoff``
(`kaldi-decoder/csrc/faster-decoder.cc:244-336`) on a dense frontier:

* no constraints → cutoff = best + beam, adaptive_beam = beam;
* if more than ``max_active`` tokens: candidate cutoff = the
  (max_active+1)-th smallest cost (the C++ ``nth_element`` at `:298`);
  when that is tighter than the beam cutoff it wins and
  ``adaptive_beam = max_active_cutoff - best + beam_delta``;
* else if more than ``min_active`` tokens: the (min_active+1)-th smallest
  cost (`:315`) *loosens* the cutoff when the plain beam would leave fewer
  than ``min_active`` tokens, with the analogous adaptive beam.

The C++ uses ``nth_element`` over a scratch vector; on the device the
frontier is already a fixed-K array so a single sort (or the incumbent sorted order)
provides every order statistic at once.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

INF = jnp.inf


class Cutoff(NamedTuple):
    cutoff: jnp.ndarray  # () f32 — expand tokens with cost < cutoff
    adaptive_beam: jnp.ndarray  # () f32 — beam for the *next* token generation
    best_cost: jnp.ndarray  # () f32
    count: jnp.ndarray  # () int32 — number of live tokens


def get_cutoff(
    costs: jnp.ndarray,  # (K,) f32, +inf for empty slots; sorted not required
    beam: float,
    max_active: int,
    min_active: int,
    beam_delta: float,
    costs_sorted: bool = False,
) -> Cutoff:
    K = costs.shape[0]
    live = jnp.isfinite(costs)
    count = jnp.sum(live).astype(jnp.int32)
    if not costs_sorted:
        sorted_costs = jnp.sort(costs)
    else:
        sorted_costs = costs
    best = sorted_costs[0]
    beam_cutoff = best + beam

    if max_active >= K and min_active == 0:
        # Unconstrained fast path (faster-decoder.cc:252-275): the frontier
        # can never exceed K tokens, so max_active can't bind.
        return Cutoff(beam_cutoff, jnp.float32(beam), best, count)

    max_cut = jnp.where(
        count > max_active,
        sorted_costs[min(max_active, K - 1)],
        INF,
    )
    min_cut = jnp.where(
        count > min_active,
        best if min_active == 0 else sorted_costs[min(min_active, K - 1)],
        INF,
    )

    use_max = max_cut < beam_cutoff
    use_min = (~use_max) & (min_cut > beam_cutoff)

    cutoff = jnp.where(use_max, max_cut, jnp.where(use_min, min_cut, beam_cutoff))
    adaptive = jnp.where(
        use_max,
        max_cut - best + beam_delta,
        jnp.where(use_min, min_cut - best + beam_delta, beam),
    ).astype(jnp.float32)
    return Cutoff(cutoff, adaptive, best, count)
