#!/usr/bin/env python
"""Lattice-link recall at bench scale (VERDICT r2 weak #2 / next #4).

Decodes one bench-workload utterance (the native >=100k-state HLG,
beam/max_active of bench.py) at several em_records budgets and compares
the device lattice's link set against the exact oracle
(OracleLatticeDecoder in deterministic-cutoff + GetCutoff max_active
mode, running directly on the compiled graph via CsrFstView).

Prints one JSON line per budget:
  {"em_records": N, "recall": r, "extra": n, "overflow_frames": m,
   "best_path_match": true}

Run on CPU or GPU; the oracle is host Python either way (~minutes at
T=1000).  KDTPU_RECALL_T trims the utterance for faster runs.
"""

import json
import os
import pathlib
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from kaldi_decoder_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import bench as B  # noqa: E402
from kaldi_decoder_tpu.decodable import DecodableCtc  # noqa: E402
from kaldi_decoder_tpu.decoders.ref_lattice import OracleLatticeDecoder  # noqa: E402
from kaldi_decoder_tpu.fst import path_labels  # noqa: E402
from kaldi_decoder_tpu.fst.csr import CsrFstView  # noqa: E402

sys.path.insert(0, str(REPO / "tests"))
from _lattice_util import device_link_set, oracle_link_set  # noqa: E402

T_LIMIT = int(os.environ.get("KDTPU_RECALL_T", "1000"))
BUDGETS = [int(x) for x in os.environ.get(
    "KDTPU_RECALL_BUDGETS", "4096,8192,16384").split(",")]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    graph, scores, lengths, refs = B.build_hlg_workload()
    T = min(int(lengths[0]), T_LIMIT)
    sc = scores[:1, :T]
    ln = np.array([T], np.int32)

    t0 = time.time()
    oracle = OracleLatticeDecoder(
        CsrFstView(graph), beam=B.BEAM, lattice_beam=B.LATTICE_BEAM,
        deterministic_cutoff=True, max_active=B.MAX_ACTIVE, min_active=200,
    )
    oracle.decode(DecodableCtc(sc[0]))
    olinks = oracle_link_set(oracle)
    olat = oracle.get_best_path()
    olabels = path_labels(olat) if olat is not None else None
    log(f"oracle: {time.time()-t0:.0f}s, {len(olinks)} links, "
        f"T={T}, best path {len(olabels or [])} words")

    for r_em in BUDGETS:
        os.environ["KDTPU_BENCH_EM_RECORDS"] = str(r_em)
        B.EM_RECORDS = r_em
        dec = B.make_decoder(graph)
        t0 = time.time()
        res = dec.decode(sc, ln, chunk_frames=B.CHUNK_FRAMES, device_prune=False)
        dlat = res.best_path(0)
        dlinks = device_link_set(res)
        st = res.stats(0)
        recall = len(olinks & dlinks) / max(len(olinks), 1)
        extra = len(dlinks - olinks)
        out = {
            "em_records": r_em,
            "recall": round(recall, 4),
            "device_links": len(dlinks),
            "oracle_links": len(olinks),
            "extra": extra,
            "overflow_frames": int(st.arc_budget_overflows),
            "saturated_frames": int(st.frontier_saturated_frames),
            "best_path_match": bool(
                dlat is not None and path_labels(dlat) == olabels
            ),
            "seconds": round(time.time() - t0, 1),
        }
        print(json.dumps(out), flush=True)
        if "--save" in sys.argv:
            # Persist for bench.py's metric string (keyed by config).
            rfile = B.CACHE_DIR / "recall.json"
            data = (
                json.loads(rfile.read_text()) if rfile.exists() else {}
            )
            key = (
                f"em{r_em}_rem{B.REM_BUDGET}_f{B.FRONTIER}_b{B.BEAM:g}"
                f"_ma{B.MAX_ACTIVE}"
            )
            data[key] = out["recall"]
            rfile.write_text(json.dumps(data, indent=1))


if __name__ == "__main__":
    main()
