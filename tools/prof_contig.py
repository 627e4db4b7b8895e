#!/usr/bin/env python3
"""Where the contig stage's device time goes: ``torch.profiler`` over the
PyTorch port's ``contig`` on one CUDA card.

    python3 tools/prof_contig.py [pairs] [--unprofiled]

Simulated reads (``perf_e2e.synth``, seed 0, 100 pairs a transcript;
default 100,000 pairs), K = 23: ``pregraph`` through ``cli.main``, then
``contig -g`` twice on its files, the first unprofiled (the kernel
builds, the allocator warms; its seconds are the stage's without the
profiler), the second under the profiler.  The stage's Tour-Bus waves
run as one wave program (``graph/tourbus.WaveProgram``): the first wave
eagerly, the rest as replays of one captured CUDA graph.  Prints the
stage's seconds, the Tour-Bus waves and seconds a wave, the captures and
replays, the device-busy share of the profiled stage (the union of
kernel, copy and memset intervals over wall time), the kernels executed a wave and the graph launches
(``cudaGraphLaunch`` calls) a wave, the device time a launch of each
kernel of ``csrc/lcs.cu`` and ``csrc/wave.cu`` a wave runs (the front's
eight, the identity check, the back's four; a tree from before the front
and the back reports the kernels it has) and the device us a wave of the
front's and the back's kernels together, and the twelve kernels with the
most device time, those run by the replays included.  Then the hand
kernels of the wave alone, 20 calls each under the profiler: the
identity kernel at a real wave's shape (12 of 1,024 rows compared, paths
of 24 bases) and at 1,024 x 384 with full paths, and the front and the
back (with ok rows and without) on the ``mixed`` front case of
``tests/test_torch_wave_kernels_gpu.py`` at 1,024 candidates, m = 3;
their device time a call, which CUDA events around one call cannot
separate from the wrapper's host time.  The last line is a JSON object of the
same.  With ``--unprofiled`` only the first ``contig -g`` runs (a size whose
profile would not fit, such as 1,000,000 pairs): its seconds, waves,
seconds a wave and peak bytes.  Imports nothing of JAX.
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
from soapdenovo_trans_tpu_torch.graph import tourbus  # noqa: E402
from soapdenovo_trans_tpu_torch.kernels import lcs, wave  # noqa: E402
from tests import test_torch_wave_kernels_gpu as wave_cases  # noqa: E402
from tests.test_torch_lcs_gpu import (identity_case,  # noqa: E402
                                      identity_to_device)

# the hand kernels a wave runs, by name: the front's, the identity
# check's, the back's
FRONT_KERNELS = ("front_forest_kernel", "front_cand_kernel",
                 "front_select_kernel", "front_count_kernel",
                 "front_scatter_kernel", "front_sort_kernel", "chains_kernel")
BACK_KERNELS = ("back_head_kernel", "claim_kernel", "apply_kernel",
                "arcs_kernel")
WAVE_KERNELS = FRONT_KERNELS + ("identity_kernel",) + BACK_KERNELS


def timed_contig(prefix: str):
    torch.cuda.synchronize()
    t0 = time.time()
    res = cli.main(["contig", "-g", prefix])[0]
    torch.cuda.synchronize()
    return res, time.time() - t0


def identity_alone_us(name: str, reps: int = 20) -> float:
    """Device microseconds a launch of the identity kernel on 1,024 rows
    of the ``name`` case of tests/test_torch_lcs_gpu.py (m = 3, seq_cap =
    384, diff = 2)."""
    xs = identity_to_device(identity_case(name, 1024, 3, 384, 2, 7), "cuda")
    return device_us(lambda: lcs.identity_check(*xs, 2, 384),
                     "identity_kernel", reps)


def front_back_alone_us(reps: int = 20) -> dict:
    """Device microseconds a call of the front (its eight kernels) and of
    the back (its four; with ok rows, and without, where three return at
    once) on the ``mixed`` front case of
    tests/test_torch_wave_kernels_gpu.py at 1,024 candidates, m = 3; {}
    on a tree without them."""
    if not hasattr(wave, "front"):
        return {}
    case = wave_cases.front_case("mixed", 1024, 3, 7)
    front_in = (*wave_cases.front_inputs(case, "cuda"), 3, 1024)
    out = {"front_alone_1024x3_us": device_us(
        lambda: wave.front(*front_in), FRONT_KERNELS, reps)}
    for productive in (True, False):
        back_in = wave_cases.back_inputs(case, 3, 1024, 7, productive,
                                         "cuda")
        key = "merged" if productive else "unproductive"
        out[f"back_alone_1024x3_{key}_us"] = device_us(
            lambda: wave.back(*back_in), BACK_KERNELS, reps)
    return out


def device_us(fn, kernels, reps: int) -> float:
    """Device microseconds a call of fn() spends in the kernels whose
    names hold one of ``kernels`` (one name or a tuple), over ``reps``
    calls under the profiler, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names = (kernels,) if isinstance(kernels, str) else kernels
    return 1e6 * sum(profsum.kernel_time(prof, k)[0] for k in names) / reps


def executions() -> dict:
    """Executions of each hand-kernel entry of the wave since the last
    reset: those of ``tourbus._KERNELS``."""
    return {f"{module.__name__.rsplit('.', 1)[-1]}.{counter}":
            getattr(module, counter)
            for module, counter, _ in tourbus._KERNELS}


def reset_counts() -> None:
    for module, counter, _ in tourbus._KERNELS:
        setattr(module, counter, 0)
    tourbus.CAPTURES = tourbus.REPLAYS = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("prof_contig: torch sees no CUDA device", file=sys.stderr)
        return 1
    args = [a for a in sys.argv[1:] if a != "--unprofiled"]
    pairs = int(args[0]) if args else 100_000
    card = profsum.card()
    os.environ["SOAPDENOVO_TORCH_DEVICE"] = "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        cfg = perf_e2e.synth(tmp, n_tx=pairs // 100, n_pairs=pairs, seed=0)
        prefix = os.path.join(tmp, "asm")
        cli.main(["pregraph", "-s", cfg, "-K", "23", "-o", prefix])
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        plain_res, plain_s = timed_contig(prefix)
        plain = {"card": card, "pairs": pairs,
                 "what": "contig -g on one card, unprofiled",
                 "stage_s": plain_s, "phase_s": plain_res.phase_seconds,
                 **plain_res.tourbus,
                 "s_per_wave_stage": plain_s / max(
                     plain_res.tourbus["waves"], 1),
                 "captures": tourbus.CAPTURES, "replays": tourbus.REPLAYS,
                 **executions(),
                 "peak_bytes": torch.cuda.max_memory_allocated()}
        if "--unprofiled" in sys.argv:
            print(json.dumps(plain))
            return 0
        reset_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res, wall = timed_contig(prefix)
    waves = res.tourbus["waves"]
    counts = executions()
    if set(counts.values()) != {waves} or \
            plain_res.tourbus["waves"] != waves:
        raise AssertionError(f"{counts} kernel executions over {waves} "
                             f"waves")
    if (tourbus.CAPTURES, tourbus.REPLAYS) != (int(waves >= 2),
                                               max(waves - 1, 0)):
        raise AssertionError(f"{tourbus.CAPTURES} captures and "
                             f"{tourbus.REPLAYS} replays over {waves} waves")
    summary = profsum.device_summary(prof, wall)
    per_launch = {}
    for name in WAVE_KERNELS:
        sec, n = profsum.kernel_time(prof, name)
        if n:
            per_launch[name] = {"seconds": sec, "launches": n,
                                "us_per_launch": 1e6 * sec / n}
    per_wave = {f"{part}_us_per_wave": 1e6 * sum(
        per_launch[k]["seconds"] for k in kernels if k in per_launch)
        / max(waves, 1) for part, kernels in (("front", FRONT_KERNELS),
                                              ("back", BACK_KERNELS))}
    numbers = {
        "card": card, "pairs": pairs, "what": "contig -g on one card",
        "stage_s": plain_s, "profiled_stage_s": wall,
        "phase_s": res.phase_seconds, "waves": waves,
        "productive_waves": res.tourbus["productive"],
        "s_per_wave": plain_s / max(waves, 1),
        "captures": tourbus.CAPTURES, "replays": tourbus.REPLAYS,
        "launches_per_wave": summary["kernel_launches"] / max(waves, 1),
        "graph_launches_per_wave": profsum.runtime_calls(
            prof, "cudaGraphLaunch") / max(waves, 1),
        "unprofiled": plain,
        "wave_kernels": per_launch, **per_wave,
        **summary,
        "identity_alone_wave_1024x384_us": identity_alone_us("wave"),
        "identity_alone_1024x384_full_us": identity_alone_us("full"),
        **front_back_alone_us()}
    profsum.print_top("prof_contig", summary)
    print(json.dumps(numbers))
    return 0


if __name__ == "__main__":
    sys.exit(main())
