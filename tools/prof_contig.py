#!/usr/bin/env python3
"""Where the contig stage's device time goes: ``torch.profiler`` over the
PyTorch port's ``contig`` on one CUDA card.

    python3 tools/prof_contig.py [pairs]

Simulated reads (``perf_e2e.synth``, seed 0, 100 pairs a transcript;
default 100,000 pairs), K = 23: ``pregraph`` through ``cli.main``, then
``contig -g`` twice on its files, the first unprofiled (the kernel
builds, the allocator warms; its seconds are the stage's without the
profiler), the second under the profiler.  Prints the stage's seconds,
the Tour-Bus waves and seconds a wave, the device-busy share of the
profiled stage (the sum of kernel time over wall time), the LCS kernel's
device time a launch, and the twelve kernels with the most device time.
Then the LCS kernel alone at a wave's full 1,024 x 384 with la = lb =
384 (20 launches under the profiler): its device time a launch, which
CUDA events around one call cannot separate from the wrapper's host
time.  The last line is a JSON object of the same.  Imports nothing of
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
from soapdenovo_trans_tpu_torch.kernels import lcs  # noqa: E402


def timed_contig(prefix: str):
    torch.cuda.synchronize()
    t0 = time.time()
    res = cli.main(["contig", "-g", prefix])[0]
    torch.cuda.synchronize()
    return res, time.time() - t0


def lcs_alone_us(reps: int = 20) -> float:
    """Device microseconds a launch of the LCS kernel on 1,024 pairs of
    384 bases (a wave's full width), 10-15% substitutions."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    a = torch.randint(0, 4, (1024, 384), generator=gen, device="cuda",
                      dtype=torch.uint8)
    noise = torch.randint(0, 4, a.shape, generator=gen, device="cuda",
                          dtype=torch.uint8)
    b = torch.where(torch.rand(a.shape, generator=gen, device="cuda")
                    < 0.12, noise, a)
    la = torch.full((1024,), 384, dtype=torch.int64, device="cuda")
    lcs.lcs_scores(a, b, la, la, 384)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            lcs.lcs_scores(a, b, la, la, 384)
        torch.cuda.synchronize()
    seconds, launches = profsum.kernel_time(prof, "lcs_kernel")
    return 1e6 * seconds / max(launches, 1)


def main() -> int:
    if not torch.cuda.is_available():
        print("prof_contig: torch sees no CUDA device", file=sys.stderr)
        return 1
    pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    card = profsum.card()
    os.environ["SOAPDENOVO_TORCH_DEVICE"] = "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        cfg = perf_e2e.synth(tmp, n_tx=pairs // 100, n_pairs=pairs, seed=0)
        prefix = os.path.join(tmp, "asm")
        cli.main(["pregraph", "-s", cfg, "-K", "23", "-o", prefix])
        plain_res, plain_s = timed_contig(prefix)
        lcs.LAUNCHES = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res, wall = timed_contig(prefix)
    waves = res.tourbus["waves"]
    if lcs.LAUNCHES != waves or plain_res.tourbus["waves"] != waves:
        raise AssertionError(f"{lcs.LAUNCHES} LCS launches over {waves} "
                             f"waves")
    summary = profsum.device_summary(prof, wall)
    lcs_s, lcs_n = profsum.kernel_time(prof, "lcs_kernel")
    numbers = {
        "card": card, "pairs": pairs, "what": "contig -g on one card",
        "stage_s": plain_s, "profiled_stage_s": wall,
        "phase_s": res.phase_seconds, "waves": waves,
        "productive_waves": res.tourbus["productive"],
        "s_per_wave": plain_s / max(waves, 1),
        "launches_per_wave": summary["kernel_launches"] / max(waves, 1),
        "lcs_kernel": {"seconds": lcs_s, "launches": lcs_n,
                       "us_per_launch": 1e6 * lcs_s / max(lcs_n, 1)},
        **summary,
        "lcs_alone_1024x384_full_us": lcs_alone_us()}
    profsum.print_top("prof_contig", summary)
    print(json.dumps(numbers))
    return 0


if __name__ == "__main__":
    sys.exit(main())
