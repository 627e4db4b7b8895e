"""The CUDA LCS kernel against its plain PyTorch version, on the card.
Imports no JAX, so it runs where only torch is installed:

    python -m pytest --noconftest tests/test_torch_lcs_gpu.py -m gpu

The case generators here are shared with tests/test_torch_lcs.py (the
CPU tests) and chip_smoke.py, which loads this file by path.
"""

import numpy as np
import pytest
import torch

from soapdenovo_trans_tpu_torch.kernels import lcs

WAVE_P, WAVE_CAP = 1024, 384  # CAND_CAP x SEQ_CAP of the Tour-Bus wave
DIFF = 10                     # the largest length difference a wave compares


def wave_pairs(rng, p: int = WAVE_P, cap: int = WAVE_CAP, alphabet: int = 4):
    """(a, b, la, lb) numpy arrays shaped like a wave's: bases from
    ``alphabet``, half the pairs similar (10-15% substitutions, an indel
    made by shifting the tail), half unrelated; la in 0..cap and
    |la - lb| <= DIFF."""
    a = rng.integers(0, alphabet, (p, cap)).astype(np.uint8)
    b = a.copy()
    hit = rng.random((p, cap)) < rng.uniform(0.10, 0.15, (p, 1))
    b[hit] = rng.integers(0, alphabet, int(hit.sum()))
    for r in range(p):
        at, shift = rng.integers(0, cap), rng.integers(-3, 4)
        b[r, at:] = np.roll(b[r, at:], shift)
    unrelated = rng.random(p) < 0.5
    b[unrelated] = rng.integers(0, alphabet, (int(unrelated.sum()), cap))
    la = rng.integers(0, cap + 1, p)
    lb = np.clip(la + rng.integers(-DIFF, DIFF + 1, p), 0, cap)
    return a, b, la, lb


def edge_case(name: str, rng, p: int = 64, cap: int = 64):
    """(a, b, la, lb, cap) of one named edge case."""
    alphabet = 250 if name == "bytes_0_249" else 4
    a, b, la, lb = wave_pairs(rng, p, cap, alphabet)
    if name in ("la_0", "both_0"):
        la[:] = 0
    if name in ("lb_0", "both_0"):
        lb[:] = 0
    if name == "full":
        la[:] = lb[:] = cap
    if name == "over_cap":  # clamped to cap
        la = cap + rng.integers(1, 50, p)
        lb = cap + rng.integers(0, 50, p)
    if name == "identical":
        b, lb = a.copy(), la.copy()
    return a, b, la, lb, cap


EDGE_CASES = ["la_0", "lb_0", "both_0", "full", "over_cap", "identical",
              "bytes_0_249"]

# the card's cases: the CPU tests' edge cases, the wave's 1,024 x 384,
# every word of the kernel in use, one pair and 4,096, and caps that are
# not multiples of 64
GPU_CASES = ([(name, 64, 64) for name in EDGE_CASES]
             + [("wave", WAVE_P, WAVE_CAP), ("full", 32, lcs.MAX_CAP),
                ("wave", 1, WAVE_CAP), ("wave", 4096, WAVE_CAP),
                ("wave", 256, 48), ("wave", 256, 100),
                ("full", 256, 100)])


def gpu_case(name: str, p: int, cap: int, seed: int):
    rng = np.random.default_rng(seed)
    if name == "wave":
        return (*wave_pairs(rng, p, cap), cap)
    return edge_case(name, rng, p, cap)


def to_device(a, b, la, lb, dev):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in (a, b, la.astype(np.int64), lb.astype(np.int64)))


@pytest.mark.gpu
@pytest.mark.parametrize("i", range(len(GPU_CASES)))
def test_cuda_kernel_matches_plain(i):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    name, p, cap = GPU_CASES[i]
    a, b, la, lb = to_device(*gpu_case(name, p, cap, 100 + i)[:4],
                             torch.device("cuda"))
    before = lcs.LAUNCHES
    got = lcs.lcs_scores(a, b, la, lb, cap)
    want = lcs.lcs_scores_plain(a, b, la, lb, cap)
    torch.cuda.synchronize()
    assert lcs.LAUNCHES == before + 1
    assert torch.equal(got, want), (name, p, cap)
