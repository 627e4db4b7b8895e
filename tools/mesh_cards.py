#!/usr/bin/env python3
"""The PyTorch port's mesh path on several CUDA cards against one card.

    python3 tools/mesh_cards.py [pregraph_pairs [map_pairs]]

Needs at least two visible cards.  On simulated reads
(``perf_e2e.synth``: 2x100 bp, insert 300, seed 0, 100 pairs a
transcript), K = 23, through ``cli.main``:

1. ``pregraph`` on ``pregraph_pairs`` pairs (default 500,000) three
   times: on ``cuda:0``, on as many LOGICAL shards of ``cuda:0`` as there
   are cards, and on one shard a card.  The three runs must write the
   same files byte for byte; the seconds by phase, the peak bytes of
   every card and the exchanges (number, bytes) are printed.
2. ``pregraph``, ``contig`` and ``map`` on ``map_pairs`` pairs (default
   100,000) on ``cuda:0``, then ``map -g`` on one shard a card on a copy
   of the contig files: the same .readOnContig, .ctg2Read and .peGrads.

The last line is a JSON object of the numbers, with the cards' names
and power limits as ``nvidia-smi`` gives them.  Exits non-zero on any
difference.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the file helpers)
import perf_e2e  # noqa: E402
from soapdenovo_trans_tpu_torch import cli  # noqa: E402
from soapdenovo_trans_tpu_torch.kernels import merge_path  # noqa: E402

K = 23


def run(argv, spec: str, n_cards: int):
    """One CLI call under a device list: (result, seconds, peak bytes
    of every card, merge-kernel launches)."""
    for i in range(n_cards):
        torch.cuda.synchronize(i)
        torch.cuda.reset_peak_memory_stats(i)
    merge_path.LAUNCHES = 0
    os.environ["SOAPDENOVO_TORCH_DEVICE"] = spec
    t0 = time.time()
    res = cli.main(argv)
    for i in range(n_cards):
        torch.cuda.synchronize(i)
    return res, time.time() - t0, [
        torch.cuda.max_memory_allocated(i) for i in range(n_cards)], \
        merge_path.LAUNCHES


def main() -> int:
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 2:
        print("mesh_cards: needs at least two CUDA cards", file=sys.stderr)
        return 1
    pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 500_000
    map_pairs = int(sys.argv[2]) if len(sys.argv) > 2 else 100_000
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()
    specs = {"one_card": "cuda:0",
             "logical_shards": ",".join(["cuda:0"] * n_cards),
             "cards": ",".join(f"cuda:{i}" for i in range(n_cards))}
    numbers = {"cards": smi, "k": K, "pregraph_pairs": pairs,
               "map_pairs": map_pairs, "pregraph": {}, "map": {}}

    with tempfile.TemporaryDirectory() as tmp:
        cfg = perf_e2e.synth(tmp, n_tx=pairs // 100, n_pairs=pairs, seed=0)
        for name, spec in specs.items():
            out = os.path.join(tmp, name)
            res, sec, peaks, launches = run(
                ["pregraph", "-s", cfg, "-K", str(K), "-o", out], spec,
                n_cards)
            numbers["pregraph"][name] = {
                "devices": spec, "seconds": sec,
                "phase_s": res.phase_seconds, "peak_bytes": peaks,
                "exchanges": res.exchanges,
                "exchange_bytes": res.exchange_bytes,
                "merge_launches": launches,
                "distinct_kmers": res.n_distinct,
                "edges": res.edges.n_edges, "pre_arcs": res.arcs.n}
            print(f"[mesh_cards] pregraph {name}: " +
                  json.dumps(numbers["pregraph"][name]), flush=True)
            del res
            if name != "one_card":
                for ext in chip_smoke.STAGE_FILES:
                    if chip_smoke.read_stage_file(out + ext) != \
                            chip_smoke.read_stage_file(
                                os.path.join(tmp, "one_card") + ext):
                        raise AssertionError(
                            f"pregraph on {spec}: {ext} differs from the "
                            f"one-card run's")

    with tempfile.TemporaryDirectory() as tmp:
        cfg = perf_e2e.synth(tmp, n_tx=map_pairs // 100, n_pairs=map_pairs,
                             seed=0)
        one = os.path.join(tmp, "one")
        run(["pregraph", "-s", cfg, "-K", str(K), "-o", one], "cuda:0",
            n_cards)
        run(["contig", "-g", one], "cuda:0", n_cards)
        many = os.path.join(tmp, "many")
        chip_smoke.copy_prefix(one, many, chip_smoke.RESUME_INPUTS)
        for name, out in (("one_card", one), ("cards", many)):
            res, sec, peaks, _ = run(["map", "-s", cfg, "-g", out],
                                     specs[name], n_cards)
            numbers["map"][name] = {
                "devices": specs[name], "seconds": sec,
                "phase_s": res.phase_seconds, "peak_bytes": peaks,
                "exchanges": res.exchanges,
                "exchange_bytes": res.exchange_bytes, "mapped": res.mapped}
        for ext in chip_smoke.MAP_FILES + (".peGrads",):
            if chip_smoke.read_stage_file(many + ext) != \
                    chip_smoke.read_stage_file(one + ext):
                raise AssertionError(f"map on {specs['cards']}: {ext} "
                                     f"differs from the one-card run's")
    print(f"[mesh_cards] {n_cards} cards: the pregraph files of the "
          f"logical-shard and the one-shard-a-card runs, and the map files "
          f"of the one-shard-a-card run, equal the one-card run's")
    print(json.dumps(numbers))
    return 0


if __name__ == "__main__":
    sys.exit(main())
