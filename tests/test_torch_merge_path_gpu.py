"""The CUDA merge-path kernel against its plain PyTorch version, on the
card.  Imports no JAX, so it runs where only torch is installed:

    python -m pytest --noconftest tests/test_torch_merge_path_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from soapdenovo_trans_tpu_torch.kernels import merge_path

CASES = [
    (5000, 3000, False),
    (4096, 4096, True),    # heavy duplicates
    (1, 7000, False),      # extreme imbalance
    (6000, 0, False),      # empty side
    (2048, 2048, True),    # all keys from a tiny space
    (3_000_000, 2_500_000, False),
]


def _sorted_rows(rng, n, live, dup, dev):
    hi = rng.integers(0, 50 if dup else 2**32 - 1, n, dtype=np.int64)
    lo = rng.integers(0, 20 if dup else 2**32, n, dtype=np.int64)
    order = np.lexsort((lo, hi))
    rows = np.stack([hi[order], lo[order]], 1)
    rows[live:] = 0xFFFFFFFF  # rows past the live count are sentinels
    cnt = rng.integers(1, 100, n).astype(np.int32)
    return torch.from_numpy(rows).to(dev), torch.from_numpy(cnt).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,dup", CASES)
def test_cuda_kernel_matches_plain(n, m, dup):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(42 + n + m)
    a_rows, a_cnt = _sorted_rows(rng, max(n, 1), n, dup, dev)
    b_rows, b_cnt = _sorted_rows(rng, max(m, 1), m, dup, dev)
    n_t, m_t = torch.tensor(n, device=dev), torch.tensor(m, device=dev)
    before = merge_path.LAUNCHES
    rows, cnt = merge_path.merge_sorted_rows(a_rows, a_cnt, b_rows, b_cnt,
                                             n_t, m_t)
    want_rows, want_cnt = merge_path.merge_sorted_rows_plain(
        a_rows, a_cnt, b_rows, b_cnt, n_t, m_t)
    torch.cuda.synchronize()
    assert merge_path.LAUNCHES == before + 1
    assert torch.equal(rows, want_rows) and torch.equal(cnt, want_cnt)
