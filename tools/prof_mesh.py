#!/usr/bin/env python3
"""Where the mesh path's device time goes: ``torch.profiler`` over the
PyTorch port's ``pregraph`` on logical shards of one CUDA card.

    python3 tools/prof_mesh.py [pairs [shards]]

Simulated reads (``perf_e2e.synth``, seed 0, 100 pairs a transcript;
default 100,000 pairs), K = 23, through ``cli.main`` with
``SOAPDENOVO_TORCH_DEVICE=cuda:0,...`` (default 4 shards).  Prints the
stage's seconds by phase, the device-busy share of the stage (the union
of kernel, copy and memset intervals over wall time) and the twelve kernels with the most device
time; the last line is a JSON object of the same.  Imports nothing of
JAX.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import perf_e2e  # noqa: E402
import profsum  # noqa: E402
from soapdenovo_trans_tpu_torch import cli  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("prof_mesh: torch sees no CUDA device", file=sys.stderr)
        return 1
    pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    shards = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    card = profsum.card()
    os.environ["SOAPDENOVO_TORCH_DEVICE"] = ",".join(["cuda:0"] * shards)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = perf_e2e.synth(tmp, n_tx=pairs // 100, n_pairs=pairs, seed=0)
        argv = ["pregraph", "-s", cfg, "-K", "23", "-o",
                os.path.join(tmp, "warm")]
        cli.main(argv)  # warm-up: the kernel build, the allocator
        argv[-1] = os.path.join(tmp, "prof")
        torch.cuda.synchronize()
        t0 = time.time()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = cli.main(argv)
            torch.cuda.synchronize()
        wall = time.time() - t0
    summary = profsum.device_summary(prof, wall)
    numbers = {
        "card": card, "pairs": pairs, "shards": shards,
        "what": f"{shards} logical shards on one card, profiler on",
        "stage_s": wall, "phase_s": res.phase_seconds,
        "exchanges": res.exchanges, **summary}
    profsum.print_top("prof_mesh", summary)
    print(json.dumps(numbers))
    return 0


if __name__ == "__main__":
    sys.exit(main())
