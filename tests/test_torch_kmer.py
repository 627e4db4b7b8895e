"""Port parity: soapdenovo_trans_tpu_torch.ops.kmer.chop_reads vs JAX."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from soapdenovo_trans_tpu.ops import kmer as jkmer
from soapdenovo_trans_tpu_torch.ops import kmer as tkmer


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _reads(seed, r=37, l=90):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(r, l)).astype(np.uint8)
    codes[rng.random((r, l)) < 0.01] = 4          # sprinkle N
    lengths = rng.integers(0, l + 1, r).astype(np.int32)
    lengths[:3] = l
    for i, ln in enumerate(lengths):
        codes[i, ln:] = 4
    return codes, lengths


@pytest.mark.parametrize("k", [13, 23, 31, 33, 63])
def test_chop_reads_matches_jax(k):
    codes, lengths = _reads(k)
    want = jkmer.chop_reads(jnp.asarray(codes), jnp.asarray(lengths), k)
    got = tkmer.chop_reads(torch.from_numpy(codes),
                           torch.from_numpy(lengths), k)
    for field in want._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(want, field)).astype(np.int64),
            getattr(got, field).numpy().astype(np.int64), err_msg=field)
