"""Port parity: soapdenovo_trans_tpu_torch.ops.ranking.list_rank vs JAX,
on random chains with even and odd cycles and absent elements."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from soapdenovo_trans_tpu.ops import ranking as jr
from soapdenovo_trans_tpu_torch.ops import ranking as tr


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _forest(seed, n=3000):
    """prev pointers over a random permutation: chains of random length,
    some closed into cycles (odd and even), some elements absent."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    prev = np.full(n, -1, np.int32)
    exists = rng.random(n) > 0.05
    i = 0
    while i < n:
        ln = int(rng.integers(1, 40))
        seg = [x for x in perm[i:i + ln] if exists[x]]
        for a, b in zip(seg[:-1], seg[1:]):
            prev[b] = a
        if len(seg) > 1 and rng.random() < 0.3:
            prev[seg[0]] = seg[-1]  # close a cycle
        i += ln
    return prev, exists


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_list_rank_matches_jax(seed):
    prev, exists = _forest(seed)
    want = jr.list_rank(jnp.asarray(prev), jnp.asarray(exists))
    got = tr.list_rank(torch.from_numpy(prev.astype(np.int64)),
                       torch.from_numpy(exists))
    for name, w, g in zip(("head", "rank", "is_head"), want, got):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64),
                                      g.numpy().astype(np.int64),
                                      err_msg=name)


def test_cycles_break_at_minimum():
    # 0->1->2->0 (odd) and 3->4->5->6->3 (even), 7 alone
    prev = torch.tensor([2, 0, 1, 6, 3, 4, 5, -1])
    head, rank, is_head = tr.list_rank(prev, torch.ones(8, dtype=torch.bool))
    assert head.tolist() == [0, 0, 0, 3, 3, 3, 3, 7]
    assert rank.tolist() == [0, 1, 2, 0, 1, 2, 3, 0]
    assert is_head.tolist() == [True, False, False, True, False, False,
                                False, True]
