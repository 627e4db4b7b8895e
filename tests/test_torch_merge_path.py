"""Port parity: the merge-path merge.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the JAX Pallas kernel run in interpret mode on the five cases of
tests/test_merge_path.py: rows by position, counts as sums per key.  The
CUDA kernel is compared with the plain version on the card in
test_torch_merge_path_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from soapdenovo_trans_tpu.kernels import merge_path as jmp
from soapdenovo_trans_tpu_torch.kernels import merge_path as tmp

CASES = [
    (5000, 3000, 0.0),
    (4096, 4096, 0.3),   # heavy duplicates
    (1, 7000, 0.0),      # extreme imbalance
    (6000, 0, 0.0),      # empty side
    (2048, 2048, 1.0),   # all keys from a tiny space
]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rand_sorted(rng, n, dup_rate):
    hi = rng.integers(0, 50 if dup_rate else 2**32 - 1, n).astype(np.uint64)
    lo = rng.integers(0, 20 if dup_rate else 2**32, n).astype(np.uint64)
    v = np.sort((hi << np.uint64(32)) | lo)
    rows = np.stack([(v >> np.uint64(32)).astype(np.uint32),
                     (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)], -1)
    return rows, rng.integers(1, 100, n).astype(np.int32)


def _case(n, m, dup):
    rng = np.random.default_rng(42 + n + m)
    a_rows, a_cnt = _rand_sorted(rng, max(n, 1), dup)
    b_rows, b_cnt = _rand_sorted(rng, max(m, 1), dup)
    # rows past the live count are sentinels, as the callers keep them
    a_rows[n:] = 0xFFFFFFFF
    b_rows[m:] = 0xFFFFFFFF
    return a_rows, a_cnt, b_rows, b_cnt


def _per_key(rows, cnt, total):
    keys = (rows[:total, 0].astype(np.uint64) << np.uint64(32)) | \
        rows[:total, 1].astype(np.uint64)
    out = {}
    for key, c in zip(keys.tolist(), cnt[:total].tolist()):
        out[key] = out.get(key, 0) + c
    return out


@pytest.mark.parametrize("n,m,dup", CASES)
def test_plain_merge_matches_pallas_interpret(n, m, dup):
    a_rows, a_cnt, b_rows, b_cnt = _case(n, m, dup)
    j_rows, j_cnt = jmp.merge_sorted_rows(
        jnp.asarray(a_rows), jnp.asarray(a_cnt), jnp.asarray(b_rows),
        jnp.asarray(b_cnt), n, m, interpret=True)
    j_rows, j_cnt = np.asarray(j_rows), np.asarray(j_cnt)

    t_rows, t_cnt = tmp.merge_sorted_rows(
        torch.from_numpy(a_rows.astype(np.int64)), torch.from_numpy(a_cnt),
        torch.from_numpy(b_rows.astype(np.int64)), torch.from_numpy(b_cnt),
        torch.tensor(n), torch.tensor(m))
    t_rows, t_cnt = t_rows.numpy(), t_cnt.numpy()

    na, nb = a_rows.shape[0], b_rows.shape[0]
    assert t_rows.shape == (na + nb, 2) and t_cnt.shape == (na + nb,)
    total = n + m
    np.testing.assert_array_equal(t_rows[:total], j_rows[:total])
    assert (t_rows[total:] == 0xFFFFFFFF).all()
    assert (t_cnt[total:] == 0).all()
    assert _per_key(t_rows, t_cnt, total) == _per_key(j_rows, j_cnt, total)
    assert tmp.LAUNCHES == 0  # the CPU never launches the kernel


def test_wrapper_rejects_bad_inputs():
    rows = torch.zeros((4, 2), dtype=torch.int64)
    cnt = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        tmp._check(rows[:, :1], cnt, rows.device)
    with pytest.raises(TypeError):
        tmp._check(rows.to(torch.int32), cnt, rows.device)
    with pytest.raises(ValueError):
        tmp._check(rows.t().contiguous().t(), cnt, rows.device)
