"""The Tour-Bus wave's identity check (``kernels/lcs.identity_check``) on
the CPU, where it runs its plain version: against the composition of the
JAX package's own functions (``_path_seq`` for each path, the length
gate, ``_lcs_scores`` and the verdict of ``graph/tourbus._wave``) on
synthetic edge graphs, against a numpy statement of what it computes,
its refusals, the wave's one call of it, and the bases that every writer
of an ``EdgeGraph`` pool puts there (the kernel's match table holds
0-3).  Exact comparison (tolerance 0): lengths, LCS and verdicts are
integers and flags."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import perf_e2e
from soapdenovo_trans_tpu.graph import tourbus as jtour
from soapdenovo_trans_tpu_torch import cli as tcli
from soapdenovo_trans_tpu_torch import convert
from soapdenovo_trans_tpu_torch.graph import split_reps as tsr
from soapdenovo_trans_tpu_torch.graph import tourbus as ttour
from soapdenovo_trans_tpu_torch.io import graph_files
from soapdenovo_trans_tpu_torch.kernels import lcs
from tests.test_torch_lcs_gpu import (IDENTITY_CASES, identity_case,
                                      identity_to_device)

from .test_arcs import build_all
from .test_bubbles import build, snp_variant, unique_kmer_seq
from .test_split_reps import _read_paths, _repeat_fixture, _triples

# the card's cases at most 1,024 x 384 (the JAX scan runs seq_cap steps)
CPU_CASES = [case for case in IDENTITY_CASES if case[1] * case[3] <= 1024 * 384]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def jax_identity(maj, mnr, found, length, seq_off, seq_pool, diff, seq_cap):
    """The identity-check block of the JAX ``_wave`` (tourbus.py:221-230)
    on numpy inputs, through the JAX package's ``_path_seq`` and
    ``_lcs_scores``."""
    eg = types.SimpleNamespace(length=jnp.asarray(length, jnp.int32),
                               seq_off=jnp.asarray(seq_off, jnp.int32),
                               seq_pool=jnp.asarray(seq_pool))
    seq_a, len_a = jtour._path_seq(jnp.asarray(maj, jnp.int32), eg, seq_cap)
    seq_b, len_b = jtour._path_seq(jnp.asarray(mnr, jnp.int32), eg, seq_cap)
    len_ok = (jnp.abs(len_a - len_b) <= diff) & (len_a <= seq_cap) & \
        (len_b <= seq_cap)
    compared = jnp.asarray(found) & len_ok
    score = jtour._lcs_scores(seq_a, seq_b, jnp.where(compared, len_a, 0),
                              jnp.where(compared, len_b, 0), seq_cap)
    ok = compared & (score * 10 >= 9 * jnp.maximum(len_a, len_b))
    return tuple(np.asarray(x) for x in (len_a, len_b, compared, ok, score))


@pytest.mark.parametrize("i", range(len(CPU_CASES)))
def test_identity_matches_jax(i):
    name, c, m, seq_cap, diff = CPU_CASES[i]
    arrays = identity_case(name, c, m, seq_cap, diff, 300 + i)
    got = lcs.identity_check(*identity_to_device(arrays, "cpu"), diff,
                             seq_cap)
    want = jax_identity(*arrays, diff, seq_cap)
    for g, w, dtype in zip(got, want, (torch.int64, torch.int64, torch.bool,
                                       torch.bool, torch.int64)):
        assert g.dtype == dtype and g.shape == (c,)
        np.testing.assert_array_equal(g.numpy(), w)
    len_a, len_b, compared, ok, _ = (g.numpy() for g in got)
    found = arrays[2]
    assert ok.sum() > 0
    if name in ("mixed", "bytes") and c > 1:
        # the case reaches every branch of the gate and of the walk
        gap = np.abs(len_a - len_b)
        assert (compared & (gap == diff)).any()
        assert (found & (gap == diff + 1) & (len_a <= seq_cap)
                & (len_b <= seq_cap)).any()
        assert (found & (gap <= diff) & (np.maximum(len_a, len_b)
                                          > seq_cap)).any()
        assert (~found).any() and (compared & ~ok).any()
        assert ((arrays[0] < 0).all(1) & (arrays[1] < 0).all(1)).any()
        if seq_cap > 64:
            assert (compared & (len_a > 64) & (len_b > 64)).any()


def _lcs_dp(a, b) -> int:
    row = np.zeros(len(b) + 1, np.int64)
    for x in a:
        cand = np.maximum(row[1:], row[:-1] + (b == x))
        row = np.concatenate([[0], np.maximum.accumulate(cand)])
    return int(row[-1])


def _path_bases(nodes, length, seq_off, seq_pool):
    out = []
    for n in nodes[nodes >= 0]:
        idx = np.clip(seq_off[n] + np.arange(length[n]), 0,
                      seq_pool.shape[0] - 1)
        out.append(seq_pool[idx])
    return np.concatenate(out + [np.zeros(0, np.uint8)])


@pytest.mark.parametrize("name", ["mixed", "bytes"])
def test_identity_is_what_it_states(name):
    """Each row against its statement: the concatenated path bases (pool
    index clamped), the gate, the LCS and the 90% verdict."""
    diff, seq_cap = 3, 100
    maj, mnr, found, length, seq_off, seq_pool = arrays = identity_case(
        name, 96, 9, seq_cap, diff, 11)
    got = [g.numpy() for g in lcs.identity_check(
        *identity_to_device(arrays, "cpu"), diff, seq_cap)]
    for r in range(maj.shape[0]):
        a = _path_bases(maj[r], length, seq_off, seq_pool)
        b = _path_bases(mnr[r], length, seq_off, seq_pool)
        cmp_ = bool(found[r]) and abs(len(a) - len(b)) <= diff and \
            max(len(a), len(b)) <= seq_cap
        score = _lcs_dp(a, b) if cmp_ else 0
        want = (len(a), len(b), cmp_,
                cmp_ and score * 10 >= 9 * max(len(a), len(b)), score)
        assert tuple(g[r] for g in got) == want, r


def _inputs(**bad):
    maj, mnr, found, length, seq_off, seq_pool = identity_to_device(
        identity_case("mixed", 8, 3, 64, 2, 0), "cpu")
    xs = dict(maj=maj, mnr=mnr, found=found, length=length, seq_off=seq_off,
              seq_pool=seq_pool, diff=2, seq_cap=64)
    for key, fn in bad.items():
        xs[key] = fn(xs[key])
    return xs


@pytest.mark.parametrize("bad", [
    dict(maj=lambda x: x.int()), dict(mnr=lambda x: x.int()),
    dict(found=lambda x: x.to(torch.uint8)), dict(length=lambda x: x.int()),
    dict(seq_off=lambda x: x.int()), dict(seq_pool=lambda x: x.long()),
    dict(seq_pool=lambda x: x.to("meta")), dict(maj=lambda x: x.to("meta")),
    dict(seq_cap=lambda x: lcs.MAX_CAP + 1), dict(seq_cap=lambda x: -1),
    dict(mnr=lambda x: x[:, :2].contiguous()), dict(found=lambda x: x[:5]),
    dict(seq_off=lambda x: x[1:]), dict(seq_pool=lambda x: x[:0]),
    dict(maj=lambda x: x.reshape(-1)), dict(maj=lambda x: x.t().contiguous().t()),
])
def test_identity_wrapper_refuses(bad):
    with pytest.raises((ValueError, TypeError)):
        lcs.identity_check(**_inputs(**bad))


def test_identity_on_meta_refused():
    xs = _inputs(**{k: (lambda x: x.to("meta")) for k in (
        "maj", "mnr", "found", "length", "seq_off", "seq_pool")})
    with pytest.raises(ValueError, match="no identity kernel"):
        lcs.identity_check(**xs)


def _bubble_graph():
    rng = np.random.default_rng(21)
    t = unique_kmer_seq(rng, 200)
    _table, eg, aset = build([t] * 9 + [snp_variant(t, 100)] * 3)
    return convert.to_torch(eg, "cpu"), convert.to_torch(aset, "cpu")


def test_wave_goes_through_identity_check(monkeypatch):
    calls = []
    real = lcs.identity_check

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(lcs, "identity_check", spy)
    eg, aset = _bubble_graph()
    failed = torch.zeros_like(aset.from_ed, dtype=torch.bool)
    m_max, diff = ttour._params_for(1)
    out = ttour._wave(eg, aset, failed, m_max, diff, ttour.SEQ_CAP,
                      ttour.CAND_CAP)
    assert len(calls) == 1
    assert int(out[7]) == 1  # the SNP bubble merged
    assert int(out[6]) == int(real(*calls[0])[2].sum()) >= 1
    _eg, _aset, stats = ttour.pinch(eg, aset, 23, 1)
    assert len(calls) == 1 + stats["waves"]


def test_edge_graph_pools_hold_bases(tmp_path, monkeypatch):
    """The writers of an EdgeGraph's seq_pool that Tour-Bus reads put
    only bases 0-3 there: the pregraph condense (graph/unitigs), the
    ``contig -g`` loader (io/graph_files) and the repeat split of
    ``contig -R`` (graph/split_reps)."""
    monkeypatch.setenv("SOAPDENOVO_TORCH_DEVICE", "cpu")
    cfg = perf_e2e.synth(str(tmp_path), n_tx=10, n_pairs=400, seed=2)
    prefix = str(tmp_path / "asm")
    res = tcli.main(["pregraph", "-s", cfg, "-K", "23", "-o", prefix])
    loaded = graph_files.load_pregraph_files(prefix, "cpu")[1]
    t1, t2 = _repeat_fixture()
    table, eg, patch, aset = build_all([t1, t1, t2, t2])
    tri = _triples(_read_paths([t1, t2], table, eg, patch))
    split, _aset, n_split = tsr.solve_reps(convert.to_torch(eg, "cpu"),
                                           convert.to_torch(aset, "cpu"), tri)
    assert n_split == 1 and split.seq_pool.shape[0] > eg.seq_pool.shape[0]
    for what, g in (("unitigs", res.edges), ("loader", loaded),
                    ("split_reps", split)):
        live = g.length > 0
        assert live.any() and g.seq_pool.shape[0] > 0, what
        assert int(g.seq_pool.max()) <= 3, what
