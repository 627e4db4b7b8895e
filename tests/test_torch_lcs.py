"""The LCS wrapper of the Tour-Bus identity check (kernels/lcs.py) on the
CPU, where it runs its plain version: against the JAX package's
``graph/tourbus._lcs_scores`` at a wave's full width, against a numpy
DP on edge cases, its refusals, and the wave's route through it.  Exact
comparison (tolerance 0): LCS lengths are integers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from soapdenovo_trans_tpu.graph import tourbus as jtour
from soapdenovo_trans_tpu_torch.graph import tourbus as ttour
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
    got = lcs.lcs_scores(*to_device(a, b, la, lb, "cpu"), WAVE_CAP)
    assert got.dtype == torch.int64 and got.shape == (a.shape[0],)
    np.testing.assert_array_equal(want, got.numpy())
    # the pairs are what they claim: similar ones score high
    assert (got.numpy() > 0.8 * np.maximum(la, lb)).mean() > 0.3


@pytest.mark.parametrize("name", EDGE_CASES)
def test_plain_matches_dp(name):
    a, b, la, lb, cap = edge_case(name, np.random.default_rng(
        EDGE_CASES.index(name)))
    got = lcs.lcs_scores(*to_device(a, b, la, lb, "cpu"), cap)
    np.testing.assert_array_equal(got.numpy(), lcs_dp(a, b, la, lb))


def _inputs(dev="cpu", cap=8, dtype=torch.uint8, len_dtype=torch.int64):
    a = torch.zeros((4, cap), dtype=dtype, device=dev)
    la = torch.full((4,), cap, dtype=len_dtype, device=dev)
    return a, a.clone(), la, la.clone(), cap


@pytest.mark.parametrize("bad", [
    dict(dev="meta"), dict(dtype=torch.int32), dict(dtype=torch.int64),
    dict(len_dtype=torch.int32), dict(cap=lcs.MAX_CAP + 1)])
def test_wrapper_refuses(bad):
    with pytest.raises((ValueError, TypeError)):
        lcs.lcs_scores(*_inputs(**bad))


def test_wrapper_refuses_bad_shapes():
    a, b, la, lb, cap = _inputs()
    with pytest.raises(ValueError):
        lcs.lcs_scores(a, b[:3], la, lb, cap)
    with pytest.raises(ValueError):
        lcs.lcs_scores(a, b, la, lb, cap + 1)
    with pytest.raises(ValueError):  # not contiguous
        lcs.lcs_scores(a[:, ::2], b[:, ::2], la, lb, cap // 2)


def test_wave_goes_through_wrapper(monkeypatch):
    calls = []
    real = lcs.lcs_scores

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(lcs, "lcs_scores", spy)
    a, b, la, lb = wave_pairs(np.random.default_rng(3), p=16, cap=32)
    got = ttour._lcs_scores(*to_device(a, b, la, lb, "cpu"), 32)
    assert len(calls) == 1
    np.testing.assert_array_equal(got.numpy(), lcs_dp(a, b, la, lb))
