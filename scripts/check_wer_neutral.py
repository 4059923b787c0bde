#!/usr/bin/env python
"""WER decoder-neutrality at bench scale (VERDICT r3 #3).

Decodes KDTPU_NEUTRAL_N (default 2) bench utterances with BOTH the device
decoder (bench configuration) and the exact host oracle
(OracleLatticeDecoder with GetCutoff max_active semantics) on the SAME
noisy posteriors, and asserts the hypotheses match word-for-word — so the
bench's 4.03% WER is attributable to the posteriors, not the decoder
(the north star's "match reference WER" clause).

Prints one JSON line: {"utts": N, "exact_match": N, "oracle_wer": x,
"device_wer": x}.
"""

import json
import os
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from kaldi_decoder_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import bench as B  # noqa: E402
from kaldi_decoder_tpu.decodable import DecodableCtc  # noqa: E402
from kaldi_decoder_tpu.decoders.ref_lattice import OracleLatticeDecoder  # noqa: E402
from kaldi_decoder_tpu.fst import path_labels  # noqa: E402
from kaldi_decoder_tpu.fst.csr import CsrFstView  # noqa: E402
from kaldi_decoder_tpu.utils.wer import wer  # noqa: E402

N = int(os.environ.get("KDTPU_NEUTRAL_N", "2"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    graph, scores, lengths, refs = B.build_hlg_workload()
    dec = B.make_decoder(graph)
    res = dec.decode(scores, lengths, chunk_frames=B.CHUNK_FRAMES)
    dev_hyps = []
    for b in range(N):
        bp = res.best_path(b)
        dev_hyps.append(path_labels(bp) if bp is not None else [])

    view = CsrFstView(graph)
    oracle_hyps = []
    for b in range(N):
        t0 = time.time()
        oracle = OracleLatticeDecoder(
            view, beam=B.BEAM, lattice_beam=B.LATTICE_BEAM,
            deterministic_cutoff=True, max_active=B.MAX_ACTIVE,
            min_active=200,
        )
        oracle.decode(DecodableCtc(scores[b, : int(lengths[b])]))
        ol = oracle.get_best_path()
        oracle_hyps.append(path_labels(ol) if ol is not None else [])
        log(f"oracle utt {b}: {time.time()-t0:.0f}s, "
            f"{len(oracle_hyps[-1])} words")

    exact = sum(
        1 for b in range(N) if dev_hyps[b] == oracle_hyps[b]
    )
    out = {
        "utts": N,
        "exact_match": exact,
        "oracle_wer": round(wer(refs[:N], oracle_hyps).wer, 4),
        "device_wer": round(wer(refs[:N], dev_hyps).wer, 4),
    }
    for b in range(N):
        if dev_hyps[b] != oracle_hyps[b]:
            log(f"MISMATCH utt {b}:\n  dev   : {dev_hyps[b]}\n"
                f"  oracle: {oracle_hyps[b]}")
    print(json.dumps(out))
    sys.exit(0 if exact == N else 1)


if __name__ == "__main__":
    main()
