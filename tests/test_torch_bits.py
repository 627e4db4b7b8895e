"""Port parity: soapdenovo_trans_tpu_torch.ops.bits vs the JAX ops/bits.

Random k-mers made with numpy go through both packages; every result is
an integer, so every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from soapdenovo_trans_tpu.ops import bits as jbits
from soapdenovo_trans_tpu_torch.ops import bits as tbits

KS = [13, 23, 31, 33, 63, 127]  # W = 1, 2, 2, 3, 4, 8 lanes


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _kmers(k, n, seed):
    rng = np.random.default_rng(seed)
    km = rng.integers(0, 2**32, size=(n, jbits.words_for_k(k)),
                      dtype=np.uint64).astype(np.uint32)
    return km & jbits.mask_np(k)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _eq(jax_out, torch_out):
    np.testing.assert_array_equal(
        np.asarray(jax_out).astype(np.int64), torch_out.numpy())


@pytest.mark.parametrize("k", KS)
def test_kmer_ops_match_jax(k):
    km = _kmers(k, 257, seed=k)
    base = np.random.default_rng(k + 1).integers(0, 5, 257).astype(np.uint8)
    jk, tk = jnp.asarray(km), _t(km)
    _eq(jbits.next_kmer(jk, jnp.asarray(base), k),
        tbits.next_kmer(tk, torch.from_numpy(base), k))
    _eq(jbits.prev_kmer(jk, jnp.asarray(base), k),
        tbits.prev_kmer(tk, torch.from_numpy(base), k))
    _eq(jbits.reverse_complement(jk, k), tbits.reverse_complement(tk, k))
    jc, jrc = jbits.canonical(jk, k)
    tc, trc = tbits.canonical(tk, k)
    _eq(jc, tc)
    _eq(jrc, trc)
    _eq(jbits.first_base(jk, k), tbits.first_base(tk, k))
    _eq(jbits.last_base(jk), tbits.last_base(tk))
    pos = np.arange(257) % k
    _eq(jbits.get_base(jk, jnp.asarray(pos), k),
        tbits.get_base(tk, torch.from_numpy(pos), k))
    _eq(jbits.append_base(jk, jnp.asarray(base & 3), k),
        tbits.append_base(tk, torch.from_numpy(base & 3), k))
    for s in (1, 7, 31):
        _eq(jbits.shl_const(jk, s), tbits.shl_const(tk, s))
        _eq(jbits._shr_const(jk, s), tbits.shr_const(tk, s))
    w = km.shape[1]
    _eq(jbits.widen(jk, w + 2), tbits.widen(tk, w + 2))
    other = _kmers(k, 257, seed=k + 2)
    other[::3] = km[::3]  # some equal pairs
    _eq(jbits.lex_less(jk, jnp.asarray(other)),
        tbits.lex_less(tk, _t(other)))
    _eq(jbits.lex_eq(jk, jnp.asarray(other)), tbits.lex_eq(tk, _t(other)))


@pytest.mark.parametrize("w", [1, 2, 3, 4])
def test_lex_order_sorts_like_numpy(w):
    rng = np.random.default_rng(w)
    rows = rng.integers(0, 4, size=(500, w)).astype(np.int64)  # many ties
    rows[::7] = 0xFFFFFFFF
    rows[1::11, 0] = 0xFFFFFFFE
    want = np.lexsort(rows.T[::-1])  # stable, first lane most significant
    got = tbits.lex_order(torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got, want)


def test_fold2_roundtrip_and_order():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 2**32, size=(1000, 2), dtype=np.int64)
    rows[0] = 0xFFFFFFFF
    rows[1] = 0
    t = torch.from_numpy(rows)
    key = tbits.fold2(t)
    assert key[0] == torch.iinfo(torch.int64).max
    np.testing.assert_array_equal(tbits.unfold2(key).numpy(), rows)
    big = (rows[:, 0].astype(object) << 32) | rows[:, 1].astype(object)
    np.testing.assert_array_equal(np.argsort(key.numpy(), kind="stable"),
                                  np.argsort(big, kind="stable"))


@pytest.mark.parametrize("k", KS)
def test_host_helpers_match_jax(k):
    rng = np.random.default_rng(k)
    s = "".join(rng.choice(list("ACGT"), size=k))
    lanes = jbits.kmer_from_string(s).astype(np.int64)
    assert tbits.kmer_to_string(lanes, k) == s
    np.testing.assert_array_equal(tbits.encode_seq(s + "Nn"),
                                  jbits.encode_seq(s + "Nn"))
    np.testing.assert_array_equal(tbits._CHAR2CODE, jbits._CHAR2CODE)
    assert tbits.BASE_CHARS == jbits.BASE_CHARS
