"""The Tour-Bus wave as one program at a fixed arc capacity
(graph/tourbus.py ``WaveProgram``, ``_wave_step``), on the CPU.

A pinch keeps its arc table in buffers sized at entry, padded with
(-1, -1, 0) rows after each rebuild, and updates ``failed`` inside the
wave.  Held here: one ``_wave`` on a padded table equals ``_wave`` on the
exact table on the real rows; the in-wave ``failed`` update equals the
host update of the JAX package's pinch (numpy here); ``pinch`` returns
an exact-size table and equals the JAX ``pinch`` at -M 1 and -M 3 over
productive and unproductive waves.  Exact comparison (tolerance 0)."""

import functools

import numpy as np
import pytest
import torch

from soapdenovo_trans_tpu.graph import tourbus as jtour
from soapdenovo_trans_tpu.ops import dictionary as jd
from soapdenovo_trans_tpu_torch import convert
from soapdenovo_trans_tpu_torch.graph import arcs as tarcs
from soapdenovo_trans_tpu_torch.graph import edge_clean
from soapdenovo_trans_tpu_torch.graph import tourbus as ttour
from tests.test_bubbles import (_multinode_bubble_reads, build, snp_variant,
                                unique_kmer_seq)
from tests.test_torch_tourbus import _many_bubbles, _pinch_both

# (fixture, candidates a wave): every fixture has several candidates in
# a wave; chunks of 8 leave most of them to later waves and retire some
# (a ``failed`` mask that is not empty)
FIXTURES = [("mixed", 1024), ("mixed", 8), ("multinode", 1024)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _graph(name):
    """The port's (EdgeGraph, exact ArcSet) of a named fixture (no test
    writes into them: ``_wave`` is pure, ``WaveProgram`` copies)."""
    if name == "mixed":  # SNPs and never-merging insertions
        _table, eg, aset = _many_bubbles(60, indel_every=3)
    else:
        _t, _v, _spur, reads = _multinode_bubble_reads(
            np.random.default_rng(7))
        _table, eg, aset = build(reads)
    teg = convert.to_torch(eg, "cpu")
    tas = convert.to_torch(aset, "cpu")
    n = tas.n
    return teg, tarcs.ArcSet(tas.from_ed[:n], tas.to_ed[:n], tas.mult[:n],
                             n)


def _pad(aset, extra):
    return tarcs.ArcSet(*(torch.cat([x, x.new_full((extra,), fill)])
                          for x, fill in zip(aset[:3], (-1, -1, 0))), aset.n)


def _host_failed(failed, cid_arc, fail_mark):
    """The JAX pinch's host update (``failed.at[where(fail_mark, cid_arc,
    a_cap)].set(True, mode="drop")``), in numpy."""
    out = failed.numpy().copy()
    out[cid_arc.numpy()[fail_mark.numpy()]] = True
    return out


@pytest.mark.parametrize("name,cand_cap", FIXTURES)
def test_padded_wave_equals_exact(name, cand_cap):
    """Up to eight waves' states of a pinch: ``_wave`` on the table padded to
    a larger capacity gives the exact table's outputs on the real rows,
    (-1, -1, 0) on the padding, and the same rejected candidates."""
    eg, aset = _graph(name)
    m_max, diff = ttour._params_for(1)
    failed = torch.zeros(aset.n, dtype=torch.bool)
    saw_two = saw_failed = False
    for _ in range(8):
        a, extra = aset.from_ed.shape[0], aset.n + 37
        got = ttour._wave(eg, _pad(aset, extra), torch.cat(
            [failed, failed.new_zeros(extra)]), m_max, diff, ttour.SEQ_CAP,
            cand_cap)
        want = ttour._wave(eg, aset, failed, m_max, diff, ttour.SEQ_CAP,
                           cand_cap)
        for i in (0, 1, 5, 6, 7, 8):  # cvg2, deleted2 and the counts
            torch.testing.assert_close(got[i], want[i], rtol=0, atol=0)
        for i, fill in ((2, -1), (3, -1), (4, 0)):  # the remapped arcs
            torch.testing.assert_close(got[i][:a], want[i], rtol=0, atol=0)
            assert bool((got[i][a:] == fill).all())
        # the candidates the checks rejected: the same rows, none padding
        np.testing.assert_array_equal(
            _host_failed(torch.cat([failed, failed.new_zeros(extra)]),
                         got[9], got[10]),
            np.concatenate([_host_failed(failed, want[9], want[10]),
                            np.zeros(extra, bool)]))
        saw_two |= int(want[5]) >= 2
        saw_failed |= bool(failed.any())
        if int(want[7]):
            aset = edge_clean.rebuild_arcs(want[2], want[3], want[4], eg.twin)
            eg = eg._replace(cvg=want[0], deleted=want[1])
            failed = torch.zeros(aset.n, dtype=torch.bool)
        elif int(want[8]):
            failed = torch.from_numpy(_host_failed(failed, want[9], want[10]))
        else:
            break
    assert saw_two  # several candidates reached the identity check
    assert saw_failed == (cand_cap == 8)


def test_in_wave_failed_update_equals_host(monkeypatch):
    """Over a run of unproductive waves (chunks of 8 among SNPs and
    never-merging insertions) the wave's own ``failed`` update equals the
    host update of the JAX pinch, wave by wave."""
    monkeypatch.setattr(ttour, "CAND_CAP", 8)
    eg, aset = _graph("mixed")
    m_max, diff = ttour._params_for(1)
    prog = ttour.WaveProgram(eg, _pad(aset, 11), m_max, diff)
    unproductive = 0
    while True:
        before = prog.failed.clone()
        want = ttour._wave(prog.eg, prog.aset, before, m_max, diff,
                           ttour.SEQ_CAP, 8)
        n, over, back, cmp_, dropped = prog.launch().tolist()
        assert [n, over, back, cmp_] == [int(want[i]) for i in (7, 8, 5, 6)]
        assert dropped == (int(((prog.aset.from_ed >= 0)
                                & (want[2] < 0)).sum()) if n else 0)
        if n:
            prog.apply()
            assert not bool(prog.failed.any())
            continue
        np.testing.assert_array_equal(prog.failed.numpy(),
                                      _host_failed(before, want[9], want[10]))
        if not over:
            break
        unproductive += 1
    assert unproductive >= 3 and prog.graph is None  # no graph on the CPU


def test_pinch_returns_exact_arcs():
    """The pinch's table is exact-size with no (-1, -1) row, as the JAX
    pinch's first n rows; a pinch that merges nothing returns its
    input table and graph."""
    rng = np.random.default_rng(21)
    t = unique_kmer_seq(rng, 200)
    _table, eg, aset = build([t] * 9 + [snp_variant(t, 100)] * 3)
    _jeg, jas, _ = jtour.pinch(eg, aset, 15, 1)
    teg, tas, stats = ttour.pinch(convert.to_torch(eg, "cpu"),
                                  convert.to_torch(aset, "cpu"), 15, 1)
    assert stats["merged"] == 1
    assert tas.from_ed.shape[0] == tas.n == int(jas.n)
    assert bool((np.asarray(jas.from_ed)[:tas.n] >= 0).all())
    for x in tas[:3]:
        assert x.shape == (tas.n,)
    assert bool((tas.from_ed >= 0).all()) and bool((tas.to_ed >= 0).all())

    p, q = unique_kmer_seq(rng, 80), unique_kmer_seq(rng, 80)
    _table, eg, aset = build([p + unique_kmer_seq(rng, 40) + q] * 5
                             + [p + unique_kmer_seq(rng, 60) + q] * 5)
    teg_in, tas_in = convert.to_torch(eg, "cpu"), convert.to_torch(aset, "cpu")
    teg, tas, stats = ttour.pinch(teg_in, tas_in, 15, 1)
    assert stats["merged"] == 0 and tas is tas_in and teg is teg_in


@pytest.mark.parametrize("level", [1, 3])
def test_pinch_matches_jax_mixed_waves(monkeypatch, level):
    """Chunks of 16 over SNP bubbles and never-merging insertions: the
    pinch takes productive and unproductive waves, and equals the JAX
    pinch (graph, table, counters) at -M 1 and -M 3."""
    monkeypatch.setattr(jd, "CAP_MODE", "pow2")
    monkeypatch.setattr(jtour, "CAND_CAP", 16)
    monkeypatch.setattr(ttour, "CAND_CAP", 16)
    table, eg, aset = _many_bubbles(60, indel_every=3)
    stats = _pinch_both(table, eg, aset, level, k=23)
    assert 1 <= stats["productive"] < stats["waves"]
    assert stats["merged"] >= 30
