"""The plain LCS of the Tour-Bus identity check
(``kernels/lcs.lcs_scores_plain``, the LCS inside
``identity_check_plain``) on the CPU: against the JAX package's
``graph/tourbus._lcs_scores`` at a wave's full width and against a numpy
DP on edge cases.  Exact comparison (tolerance 0): LCS lengths are
integers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from soapdenovo_trans_tpu.graph import tourbus as jtour
from soapdenovo_trans_tpu_torch.kernels import lcs
from tests.test_torch_lcs_gpu import (EDGE_CASES, WAVE_CAP, edge_case,
                                      to_device, wave_pairs)


def lcs_dp(a, b, la, lb):
    """The textbook LCS table over all rows at once; row r's answer is
    the cell (min(la, cap), min(lb, cap))."""
    p, cap = a.shape
    f = np.zeros((p, cap + 1, cap + 1), np.int64)
    for i in range(cap):
        for j in range(cap):
            f[:, i + 1, j + 1] = np.where(
                a[:, i] == b[:, j], f[:, i, j] + 1,
                np.maximum(f[:, i, j + 1], f[:, i + 1, j]))
    ia, ib = np.clip(la, 0, cap), np.clip(lb, 0, cap)
    return f[np.arange(p), ia, ib]


def test_lcs_scores_match_jax_at_wave_width():
    a, b, la, lb = wave_pairs(np.random.default_rng(8))
    want = np.asarray(jtour._lcs_scores(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(la, jnp.int32),
        jnp.asarray(lb, jnp.int32), WAVE_CAP))
    got = lcs.lcs_scores_plain(*to_device(a, b, la, lb, "cpu"),
                               WAVE_CAP)
    assert got.dtype == torch.int64 and got.shape == (a.shape[0],)
    np.testing.assert_array_equal(want, got.numpy())
    # the pairs are what they claim: similar ones score high
    assert (got.numpy() > 0.8 * np.maximum(la, lb)).mean() > 0.3


@pytest.mark.parametrize("name", EDGE_CASES)
def test_plain_matches_dp(name):
    a, b, la, lb, cap = edge_case(name, np.random.default_rng(
        EDGE_CASES.index(name)))
    got = lcs.lcs_scores_plain(*to_device(a, b, la, lb, "cpu"), cap)
    np.testing.assert_array_equal(got.numpy(), lcs_dp(a, b, la, lb))
