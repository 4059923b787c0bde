"""Tracing / profiling hooks (SURVEY §5).

The reference has no profiling at all (its only hook is a commented-out
token-count log, `kaldi-decoder/csrc/faster-decoder.cc:164`).  This
package provides:

* :func:`trace` — :func:`jax.profiler.trace` around any decode call, to
  capture a TensorBoard/XPlane device trace (per-op device timings of the
  frame scan, host-device transfers, etc.);
* :func:`annotate` — a ``StepTraceAnnotation`` so each decode chunk shows
  up as a named step in the trace viewer;
* wall-clock decode timing threaded into :class:`DecodeStats`
  (``wall_seconds`` / ``frames_per_second`` /
  ``audio_seconds_per_second``), the frames/s observability the
  reference never reports.

A profiler that cannot start raises: a trace that silently records
nothing would be read as an idle device.
"""

from __future__ import annotations

import time


def trace(logdir: str):
    """Capture a device trace of everything inside the block.

    Usage::

        with profiling.trace("/tmp/kdtpu-trace"):
            result = decoder.decode(scores)

    View with TensorBoard's profile plugin (or xprof), or read the
    ``.xplane.pb`` with ``jax.profiler.ProfileData``.
    """
    import jax

    return jax.profiler.trace(logdir)


def annotate(name: str, step: int = 0):
    """Named step annotation for the trace viewer (free without a trace)."""
    import jax

    return jax.profiler.StepTraceAnnotation(name, step_num=step)


class WallTimer:
    """Tiny wall-clock timer; ``elapsed`` is valid after the block exits.

    Callers are responsible for device synchronization: JAX dispatch is
    asynchronous, so the timed block must end in ``block_until_ready``
    or a host fetch of the result.
    """

    def __enter__(self):
        self.elapsed = 0.0
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False
