"""Command-line decoding, mirroring the icefall decode-script workflow
(`/root/reference/README.md:16-20`: load graph, load posteriors, decode,
map output labels to words).

Usage:
  python -m kaldi_decoder_tpu.cli decode --graph HLG.fst --logits utt.npy
  python -m kaldi_decoder_tpu.cli decode --graph H.fst --logits a.npy b.npy \\
      --decoder lattice --lattice-dir lats/ --words words.txt --nbest 10
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _load_words(path):
    """OpenFst symbol table text format: '<word> <id>' per line."""
    table = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                table[int(parts[1])] = parts[0]
    return table


def cmd_decode(args) -> int:
    from kaldi_decoder_tpu import (
        FasterDecoder,
        FasterDecoderOptions,
        LatticeFasterDecoder,
        LatticeFasterDecoderConfig,
    )
    from kaldi_decoder_tpu.decodable import DecodableCtc
    from kaldi_decoder_tpu.fst import path_labels, read_fst, write_fst

    graph = read_fst(args.graph)
    words = _load_words(args.words) if args.words else None

    if args.decoder == "faster":
        dec = FasterDecoder(
            graph,
            FasterDecoderOptions(
                beam=args.beam,
                max_active=args.max_active,
                min_active=args.min_active,
            ),
        )
    else:
        dec = LatticeFasterDecoder(
            graph,
            LatticeFasterDecoderConfig(
                beam=args.beam,
                max_active=args.max_active,
                min_active=args.min_active,
                lattice_beam=args.lattice_beam,
            ),
        )

    for path in args.logits:
        t0 = time.time()
        logits = np.load(path)
        if args.apply_log_softmax:
            m = logits - logits.max(axis=-1, keepdims=True)
            logits = m - np.log(np.exp(m).sum(axis=-1, keepdims=True))
        dec.decode(DecodableCtc(logits.astype(np.float32)))
        ok, best = dec.get_best_path()
        elapsed = time.time() - t0
        if not ok:
            print(json.dumps({"utt": path, "error": "no tokens survived"}))
            continue
        labels = path_labels(best)
        hyp = (
            " ".join(words.get(l, f"<{l}>") for l in labels)
            if words
            else " ".join(map(str, labels))
        )
        out = {
            "utt": path,
            "hyp": hyp,
            "reached_final": bool(dec.reached_final()),
            "seconds": round(elapsed, 3),
        }
        if args.decoder == "lattice":
            if args.lattice_dir:
                import os

                okl, lat = dec.get_raw_lattice()
                if okl:
                    dst = os.path.join(
                        args.lattice_dir,
                        os.path.basename(path) + ".lat.fst",
                    )
                    write_fst(lat, dst)
                    out["lattice"] = dst
            if args.nbest > 1:
                from kaldi_decoder_tpu.lattice.post import nbest as _nbest

                okl, lat = dec.get_raw_lattice()
                if okl:
                    out["nbest"] = [
                        {
                            "hyp": " ".join(
                                words.get(l, f"<{l}>") for l in ols
                            )
                            if words
                            else " ".join(map(str, ols)),
                            "cost": round(g + a, 4),
                        }
                        for _, ols, g, a in _nbest(
                            lat, args.nbest, unique_word_sequences=True
                        )
                    ]
        print(json.dumps(out))
    return 0


def cmd_info(args) -> int:
    from kaldi_decoder_tpu.fst import compile_fst, read_fst

    fst = read_fst(args.graph)
    g = compile_fst(fst)
    print(
        json.dumps(
            {
                "num_states": g.num_states,
                "num_emitting_arcs": g.num_emitting_arcs,
                "num_eps_arcs": g.num_eps_arcs,
                "start_state": g.start_state,
                "eps_depth": g.eps_depth,
                "max_em_out_degree": g.max_em_out_degree,
                "max_score_idx": g.max_score_idx,
            }
        )
    )
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kaldi_decoder_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("decode", help="decode CTC log-probs through a WFST")
    d.add_argument("--graph", required=True, help="OpenFst binary H/HL/HLG")
    d.add_argument("--logits", nargs="+", required=True, help=".npy (T, V) files")
    d.add_argument("--decoder", choices=["faster", "lattice"], default="lattice")
    d.add_argument("--beam", type=float, default=16.0)
    d.add_argument("--max-active", type=int, default=7000)
    d.add_argument("--min-active", type=int, default=200)
    d.add_argument("--lattice-beam", type=float, default=10.0)
    d.add_argument("--words", help="words.txt symbol table for olabels")
    d.add_argument("--lattice-dir", help="write raw lattices here")
    d.add_argument("--nbest", type=int, default=1)
    d.add_argument(
        "--apply-log-softmax",
        action="store_true",
        help="logits are unnormalized; apply log-softmax first",
    )
    d.set_defaults(fn=cmd_decode)

    i = sub.add_parser("info", help="print compiled graph statistics")
    i.add_argument("--graph", required=True)
    i.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    from kaldi_decoder_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
