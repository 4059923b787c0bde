"""Native (C++) host runtime: build, load, and ctypes bindings.

The reference's host layer is native C++ (OpenFst/kaldifst graph code,
`cmake/kaldifst.cmake:1-69`; `fst::ShortestPath` at
`lattice-simple-decoder.cc:574-580`; the token backpointer walk at
`faster-decoder.cc:393-406`).  This package provides the framework's
native equivalents (csrc/kdtpu_host.cc), compiled on demand with the
system toolchain into a shared library and loaded via ctypes — no
pybind11 dependency.

Every entry point has a pure-Python fallback at its call site; import
never fails.  Set ``KDTPU_NATIVE=0`` to disable the native path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
# Single source of truth: csrc/ lives inside the package (shipped as
# package data per pyproject [tool.setuptools.package-data]), so the same
# file serves development checkouts and installed wheels.
_SRC = os.path.join(_HERE, "csrc", "kdtpu_host.cc")
_LIB_DIR = os.path.join(_HERE, "lib")
_CXXFLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_i64 = ctypes.c_int64
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _build(src: str = _SRC, lib_dir: str = _LIB_DIR) -> Optional[str]:
    """Path of the shared library built from ``src``, compiling it first
    if no library with the same key exists; None if it cannot be built.

    The file name carries a hash of the source, the compiler command and
    the compiler's version, so a library built from other source or by
    another toolchain (say, a copy of the checkout moved to another
    machine) is never loaded in its place."""
    if not os.path.exists(src):
        return None
    cxx = os.environ.get("CXX", "g++")
    try:
        version = subprocess.run(
            [cxx, "--version"], check=True, capture_output=True, timeout=60
        ).stdout
    except (subprocess.SubprocessError, OSError):
        return None
    key = hashlib.sha256()
    with open(src, "rb") as f:
        key.update(f.read())
    key.update("\0".join((cxx,) + _CXXFLAGS).encode())
    key.update(version)
    lib = os.path.join(lib_dir, f"libkdtpu_host-{key.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(lib_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            [cxx, *_CXXFLAGS, "-o", tmp, src],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, lib)
    except (subprocess.SubprocessError, OSError):
        return None
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    c_char_p = ctypes.c_char_p
    lib.kd_fst_open.restype = ctypes.c_void_p
    lib.kd_fst_open.argtypes = [c_char_p, c_char_p, ctypes.c_int]
    lib.kd_fst_open_text.restype = ctypes.c_void_p
    lib.kd_fst_open_text.argtypes = [
        c_char_p, _i64, ctypes.c_int, c_char_p, ctypes.c_int,
    ]
    lib.kd_fst_free.restype = None
    lib.kd_fst_free.argtypes = [ctypes.c_void_p]
    lib.kd_fst_info.restype = None
    lib.kd_fst_info.argtypes = [ctypes.c_void_p, _i64p]
    lib.kd_fst_fill.restype = None
    lib.kd_fst_fill.argtypes = [
        ctypes.c_void_p, _i64p, _i32p, _i32p, _f32p, _i32p, _f32p,
    ]
    lib.kd_csr_sizes.restype = ctypes.c_int
    lib.kd_csr_sizes.argtypes = [ctypes.c_void_p, _i64p]
    lib.kd_csr_fill.restype = ctypes.c_int
    lib.kd_csr_fill.argtypes = [
        ctypes.c_void_p, _i32p, _i32p, _i32p, _f32p, _i32p, _i32p,
        _i32p, _i32p, _f32p, _i32p, _f32p, _i64p,
    ]
    lib.kd_backtrace.restype = _i64
    lib.kd_backtrace.argtypes = [
        _i64, _i64, _i64, _i64, _i64, _i32p, _i32p, _i32p, _i32p, _i64,
    ]
    lib.kd_shortest_path.restype = _i64
    lib.kd_shortest_path.argtypes = [
        _i64, _i64, _i32p, _f32p, _f32p, _i32p, _f32p, _f32p, _i64,
        _i32p, _i64,
    ]
    lib.kd_decode_faster.restype = ctypes.c_double
    lib.kd_decode_faster.argtypes = [
        _i64, _i32p, _i32p, _f32p, _i32p, _i32p, _i32p, _f32p, _f32p,
        _i64, _i64, _i64, _f32p, ctypes.c_float, _i64, _i64,
        ctypes.c_float, _i64p,
    ]
    lib.kd_decode_lattice.restype = ctypes.c_double
    lib.kd_decode_lattice.argtypes = [
        _i64, _i32p, _i32p, _f32p, _i32p, _i32p, _i32p, _f32p, _f32p,
        _i64, _i64, _i64, _f32p, ctypes.c_float, _i64, _i64,
        ctypes.c_float, ctypes.c_float, _i64, _i64p,
    ]
    lib.kd_get_cutoff.restype = None
    lib.kd_get_cutoff.argtypes = [
        _f32p, _i64, ctypes.c_float, _i64, _i64, ctypes.c_float, _f64p,
    ]


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("KDTPU_NATIVE", "1") == "0":
            return None
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
            _declare(lib)
            _lib = lib
        except OSError:
            _lib = None
    return _lib


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# High-level wrappers
# ---------------------------------------------------------------------------


class _Handle:
    """Owns a native FST handle."""

    def __init__(self, lib, ptr):
        self._lib = lib
        self.ptr = ptr

    def __del__(self):
        if getattr(self, "ptr", None):
            self._lib.kd_fst_free(self.ptr)
            self.ptr = None


def _open_path(path: str) -> _Handle:
    lib = get_lib()
    err = ctypes.create_string_buffer(256)
    ptr = lib.kd_fst_open(os.fsencode(path), err, len(err))
    if not ptr:
        raise ValueError(err.value.decode() or f"cannot read FST {path}")
    return _Handle(lib, ptr)


def _open_text(text: str, weight_dim: int) -> _Handle:
    lib = get_lib()
    err = ctypes.create_string_buffer(256)
    raw = text.encode()
    ptr = lib.kd_fst_open_text(raw, len(raw), weight_dim, err, len(err))
    if not ptr:
        raise ValueError(err.value.decode() or "cannot parse FST text")
    return _Handle(lib, ptr)


def _fst_arrays(h: _Handle) -> dict:
    lib = h._lib
    info = np.zeros(4, np.int64)
    lib.kd_fst_info(h.ptr, info)
    S, A, start, wd = (int(x) for x in info)
    row_ptr = np.empty(S + 1, np.int64)
    il = np.empty(A, np.int32)
    ol = np.empty(A, np.int32)
    w = np.empty(A * wd, np.float32)
    ns = np.empty(A, np.int32)
    fin = np.empty(S * wd, np.float32)
    lib.kd_fst_fill(h.ptr, row_ptr, il, ol, w, ns, fin)
    return {
        "row_ptr": row_ptr,
        "ilabel": il,
        "olabel": ol,
        "weight": w if wd == 1 else w.reshape(A, 2),
        "nextstate": ns,
        "final": fin if wd == 1 else fin.reshape(S, 2),
        "start": start,
        "weight_dim": wd,
    }


def read_fst_arrays(path: str) -> dict:
    """Parse an OpenFst binary VectorFst file into flat numpy arrays."""
    return _fst_arrays(_open_path(path))


def parse_fst_text_arrays(text: str, weight_dim: int) -> dict:
    """Parse OpenFst text format into flat numpy arrays."""
    return _fst_arrays(_open_text(text, weight_dim))


def _csr_from_handle(h: _Handle, start_override: Optional[int] = None):
    """Build a CsrGraph from a native handle (tropical FSTs only)."""
    from kaldi_decoder_tpu.fst.csr import CsrGraph, GraphArrays

    lib = h._lib
    info = np.zeros(4, np.int64)
    lib.kd_fst_info(h.ptr, info)
    S, _A, start, wd = (int(x) for x in info)
    if wd != 1:
        raise ValueError("CSR compile requires a tropical (StdArc) FST")
    if start_override is not None:
        start = start_override
    if start < 0:
        raise ValueError("FST has no start state")
    sizes = np.zeros(2, np.int64)
    lib.kd_csr_sizes(h.ptr, sizes)
    n_em, n_eps = int(sizes[0]), int(sizes[1])
    em_row_ptr = np.empty(S + 1, np.int32)
    em_il = np.empty(n_em, np.int32)
    em_ol = np.empty(n_em, np.int32)
    em_w = np.empty(n_em, np.float32)
    em_next = np.empty(n_em, np.int32)
    em_sidx = np.empty(n_em, np.int32)
    eps_row_ptr = np.empty(S + 1, np.int32)
    eps_ol = np.empty(n_eps, np.int32)
    eps_w = np.empty(n_eps, np.float32)
    eps_next = np.empty(n_eps, np.int32)
    final_cost = np.empty(S, np.float32)
    meta = np.zeros(4, np.int64)
    rc = lib.kd_csr_fill(
        h.ptr, em_row_ptr, em_il, em_ol, em_w, em_next, em_sidx,
        eps_row_ptr, eps_ol, eps_w, eps_next, final_cost, meta,
    )
    if rc != 0:
        raise ValueError("native CSR compile failed")
    ga = GraphArrays(
        em_row_ptr=em_row_ptr,
        em_ilabel=em_il,
        em_olabel=em_ol,
        em_weight=em_w,
        em_next=em_next,
        em_score_idx=em_sidx,
        eps_row_ptr=eps_row_ptr,
        eps_olabel=eps_ol,
        eps_weight=eps_w,
        eps_next=eps_next,
        final_cost=final_cost,
    )
    eps_depth = None if meta[0] < 0 else int(meta[0])
    return CsrGraph(
        arrays=ga,
        num_states=S,
        num_emitting_arcs=n_em,
        num_eps_arcs=n_eps,
        start_state=start,
        eps_depth=eps_depth,
        max_em_out_degree=int(meta[1]),
        max_eps_out_degree=int(meta[2]),
        max_score_idx=int(meta[3]),
    )


def load_csr(path: str):
    """OpenFst binary file -> CsrGraph without materializing a VectorFst.

    The production graph-load path for million-arc HLGs.
    """
    return _csr_from_handle(_open_path(path))


def backtrace(
    slot0: int,
    bp_init: np.ndarray,  # (D_init, K, 2) int32
    bp_emit: np.ndarray,  # (T, K, 2) int32
    bp_eps: np.ndarray,  # (T, D, K, 2) int32
) -> Optional[np.ndarray]:
    """Walk backpointers; returns (n, 3) int32 (is_eps, arc_id, frame) in
    forward order, or None on a dead slot (search failure)."""
    lib = get_lib()
    T, K = bp_emit.shape[0], bp_emit.shape[1]
    D = bp_eps.shape[1] if bp_eps.ndim == 4 else 0
    D_init = bp_init.shape[0] if bp_init.size else 0
    cap = 3 * (T + D_init + T * D + 1)
    out = np.empty((cap, 3), np.int32)
    n = lib.kd_backtrace(
        T, K, D, D_init, slot0,
        np.ascontiguousarray(bp_init, np.int32).reshape(-1)
        if bp_init.size else np.zeros(1, np.int32),
        np.ascontiguousarray(bp_emit, np.int32).reshape(-1)
        if bp_emit.size else np.zeros(1, np.int32),
        np.ascontiguousarray(bp_eps, np.int32).reshape(-1)
        if bp_eps.size else np.zeros(1, np.int32),
        out.reshape(-1), cap,
    )
    if n == -1:
        return None
    if n < 0:
        raise RuntimeError("kd_backtrace capacity error")
    return out[:n]


def decode_faster(
    graph,
    scores: np.ndarray,  # (T, V) float32 log-probs
    beam: float = 16.0,
    max_active: int = 2**63 - 1,
    min_active: int = 20,
    beam_delta: float = 0.5,
):
    """Single-threaded C++ decode with the reference FasterDecoder's
    algorithmics over a CsrGraph (the honest native CPU baseline; see
    kd_decode_faster in csrc/kdtpu_host.cc).

    Returns (best_final_cost, frames_decoded, tokens_created).
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    ga = graph.arrays
    scores = np.ascontiguousarray(scores, np.float32)
    T, V = scores.shape
    stats = np.zeros(2, np.int64)
    best = lib.kd_decode_faster(
        graph.num_states,
        np.ascontiguousarray(ga.em_row_ptr, np.int32),
        np.ascontiguousarray(ga.em_next, np.int32),
        np.ascontiguousarray(ga.em_weight, np.float32),
        np.ascontiguousarray(ga.em_score_idx, np.int32),
        np.ascontiguousarray(ga.eps_row_ptr, np.int32),
        np.ascontiguousarray(ga.eps_next, np.int32),
        np.ascontiguousarray(ga.eps_weight, np.float32),
        np.ascontiguousarray(ga.final_cost, np.float32),
        graph.start_state, T, V, scores.reshape(-1),
        float(beam), int(max_active), int(min_active), float(beam_delta),
        stats,
    )
    return float(best), int(stats[0]), int(stats[1])


def decode_lattice(
    graph,
    scores: np.ndarray,  # (T, V) float32 log-probs
    beam: float = 16.0,
    max_active: int = 2**63 - 1,
    min_active: int = 20,
    beam_delta: float = 0.5,
    lattice_beam: float = 10.0,
    prune_interval: int = 25,
):
    """Single-threaded C++ LATTICE-mode decode: LatticeSimpleDecoder's
    token/ForwardLink structure + windowed backward pruning, unioned with
    FasterDecoder's max-active cutoffs (kd_decode_lattice in
    csrc/kdtpu_host.cc) — the apples-to-apples CPU baseline for the
    bench's lattice decode.

    Returns (best_final_cost, {frames, tokens, links, tokens_live,
    links_live})."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    ga = graph.arrays
    scores = np.ascontiguousarray(scores, np.float32)
    T, V = scores.shape
    stats = np.zeros(5, np.int64)
    best = lib.kd_decode_lattice(
        graph.num_states,
        np.ascontiguousarray(ga.em_row_ptr, np.int32),
        np.ascontiguousarray(ga.em_next, np.int32),
        np.ascontiguousarray(ga.em_weight, np.float32),
        np.ascontiguousarray(ga.em_score_idx, np.int32),
        np.ascontiguousarray(ga.eps_row_ptr, np.int32),
        np.ascontiguousarray(ga.eps_next, np.int32),
        np.ascontiguousarray(ga.eps_weight, np.float32),
        np.ascontiguousarray(ga.final_cost, np.float32),
        graph.start_state, T, V, scores.reshape(-1),
        float(beam), int(max_active), int(min_active), float(beam_delta),
        float(lattice_beam), int(prune_interval), stats,
    )
    keys = ("frames", "tokens", "links", "tokens_live", "links_live")
    return float(best), dict(zip(keys, (int(x) for x in stats)))


def get_cutoff(
    costs: np.ndarray,
    beam: float,
    max_active: int,
    min_active: int,
    beam_delta: float,
):
    """C++ GetCutoff with exact reference semantics
    (faster-decoder.cc:244-336) over a vector of finite token costs.
    Returns (cutoff, adaptive_beam); used by tests to pin the native
    decision table against ops/cutoff.py."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    costs = np.ascontiguousarray(costs, np.float32)
    out = np.zeros(2, np.float64)
    lib.kd_get_cutoff(
        costs, len(costs), float(beam), int(max_active), int(min_active),
        float(beam_delta), out,
    )
    return float(out[0]), float(out[1])


def shortest_path_arrays(
    num_states: int,
    src: np.ndarray,
    w_total: np.ndarray,
    dst: np.ndarray,
    final_total: np.ndarray,
    start: int,
    w_graph: Optional[np.ndarray] = None,
    final_graph: Optional[np.ndarray] = None,
) -> Optional[np.ndarray]:
    """Best-path arc indices (forward order) over flat lattice arrays,
    or None if no successful path.  Raises on cyclic input.

    ``w_graph``/``final_graph`` enable the LatticeWeight natural-order
    tie-break (equal totals -> smaller graph cost wins)."""
    lib = get_lib()
    A = int(len(src))
    cap = max(A, 1)
    out = np.empty(cap, np.int32)
    if w_graph is None:
        w_graph = np.zeros(A, np.float32)
    if final_graph is None:
        final_graph = np.zeros(num_states, np.float32)
    n = lib.kd_shortest_path(
        num_states, A,
        np.ascontiguousarray(src, np.int32),
        np.ascontiguousarray(w_total, np.float32),
        np.ascontiguousarray(w_graph, np.float32),
        np.ascontiguousarray(dst, np.int32),
        np.ascontiguousarray(final_total, np.float32),
        np.ascontiguousarray(final_graph, np.float32),
        start, out, cap,
    )
    if n == -1:
        return None
    if n == -2:
        raise ValueError("shortest_path requires an acyclic FST")
    if n < 0:
        raise RuntimeError("kd_shortest_path capacity error")
    return out[:n]
