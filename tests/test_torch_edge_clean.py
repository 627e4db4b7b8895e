"""Port parity of the edge-cleaning passes (graph/edge_clean.py).

One JAX pregraph result on a seeded fixture feeds both packages
(through soapdenovo_trans_tpu_torch.convert); each JAX pass's output is
fed on to the next pair of passes, so every comparison sees identical
inputs.  Exact comparison (tolerance 0) of live prefixes: the JAX
package pads its capacities, the port's merged arc sets are exact."""

import numpy as np
import pytest
import torch

import perf_e2e
from soapdenovo_trans_tpu import cli as jcli
from soapdenovo_trans_tpu.graph import contig_merge as jmerge
from soapdenovo_trans_tpu.graph import edge_clean as jclean
from soapdenovo_trans_tpu.io import libconfig as jlibconfig
from soapdenovo_trans_tpu.stages import contig as jcontig
from soapdenovo_trans_tpu.stages import pregraph as jpg
from soapdenovo_trans_tpu_torch import convert
from soapdenovo_trans_tpu_torch.graph import edge_clean as tclean

K = 23


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pre(tmp_path_factory):
    """JAX pregraph state (edges, arcs) of a 1,500-pair fixture."""
    cfg = perf_e2e.synth(str(tmp_path_factory.mktemp("reads")), n_tx=30,
                         n_pairs=1500, seed=3)
    factory = jcli._CountingFactory(jlibconfig.parse_config(cfg), 4096)
    res = jpg.run_pregraph(factory, K)
    return res.edges, res.arcs


@pytest.fixture(scope="module")
def cleaned(pre):
    """The JAX state after weak edges, tips and compaction."""
    je, ja = pre
    je = jclean.cut_tips(jclean.delete_weak_edges(je, 20), ja, K)
    return je, jclean.compact_arcs(ja, je)


@pytest.fixture(scope="module")
def merged(cleaned):
    """A concatenated graph (JAX), as the light-arc laps see it."""
    je, ja = cleaned
    ja = jclean.delow_high_arc(jclean.delete_unlike_arcs(ja, je), je, 200)
    ctg = jmerge.concatenate(je, ja)
    return jcontig._as_edgegraph(ctg), ctg.arcs


def _t(nt):
    return convert.to_torch(nt, "cpu")


def _eq(want, got, n=None, msg=""):
    want = np.asarray(want).astype(np.int64)
    got = got.cpu().numpy().astype(np.int64)
    if n is not None:
        want, got = want[:n], got[:n]
    np.testing.assert_array_equal(want, got, err_msg=msg)


def _arcs_eq(want, got):
    assert got.n == int(want.n)
    for field in ("from_ed", "to_ed", "mult"):
        _eq(getattr(want, field), getattr(got, field), got.n, field)


def test_delete_weak_edges(pre):
    je, _ = pre
    for cutoff in (20, 40):  # 40 is capped at MAX_WEAK_CVG
        want = jclean.delete_weak_edges(je, cutoff)
        got = tclean.delete_weak_edges(_t(je), cutoff)
        _eq(want.deleted, got.deleted)
        assert got.deleted.sum() > 0


def test_edge_chain_state_and_cut_tips(pre):
    je, ja = pre
    je = jclean.delete_weak_edges(je, 20)
    te, ta = _t(je), _t(ja)
    wants = jclean._edge_chain_state(je, ja)
    one = np.asarray(wants[0]) == 1
    for want, got, name in zip(wants, tclean._edge_chain_state(te, ta),
                               ("out_deg", "in_deg", "only_to", "only_mult",
                                "max_in_mult")):
        if name in ("only_to", "only_mult"):  # meaningful at out_deg == 1
            want, got = np.asarray(want)[one], got.numpy()[one]
            np.testing.assert_array_equal(want, got, err_msg=name)
        else:
            _eq(want, got, msg=name)
    deleted, n = jclean._cut_tips_once(je, ja, 2 * K)
    t_deleted, t_n = tclean._cut_tips_once(te, ta, 2 * K)
    _eq(deleted, t_deleted)
    assert int(t_n) == int(n) > 0
    _eq(jclean.cut_tips(je, ja, K).deleted, tclean.cut_tips(te, ta, K).deleted)


def test_compact_arcs_and_twin_index(cleaned, pre):
    je, _ = cleaned
    _, ja = pre
    _arcs_eq(jclean.compact_arcs(ja, je), tclean.compact_arcs(_t(ja), _t(je)))
    jc = jclean.compact_arcs(ja, je)
    got = tclean.twin_arc_index(_t(jc), _t(je).twin)
    _eq(jclean.twin_arc_index(jc, je.twin), got)
    assert (got[:int(jc.n)] >= 0).all()  # the arc set is symmetric


def test_unlike_and_high_arcs(cleaned):
    je, ja = cleaned
    te, ta = _t(je), _t(ja)
    want = jclean.delete_unlike_arcs(ja, je)
    got = tclean.delete_unlike_arcs(ta, te)
    _eq(want.mult, got.mult)
    assert (got.mult == 0).sum() > (ta.mult == 0).sum()
    _eq(jclean.out_weights(want, je.length.shape[0]),
        tclean.out_weights(got, te.length.shape[0]))
    for multi in (200, 1):  # the default, and one that clamps arcs
        w = jclean.delow_high_arc(want, je, multi)
        g = tclean.delow_high_arc(_t(want), te, multi)
        _eq(w.mult, g.mult, msg=f"multi={multi}")


def test_simple_loops_and_light_arcs(merged):
    jg, ja = merged
    tg, ta = _t(jg), _t(ja)
    want = jclean.delete_simple_loops(ja, jg)
    got = tclean.delete_simple_loops(ta, tg)
    _eq(want.mult, got.mult, int(ja.n))
    for da, dA in ((5, 2), (40, 30)):
        w, w_changed = jclean.delete_light_arcs(want, jg, da, dA)
        g, g_changed = tclean.delete_light_arcs(_t(want), tg, da, dA)
        _eq(w.mult, g.mult, int(ja.n), msg=f"{da} {dA}")
        assert w_changed == g_changed
    assert g_changed  # the 40/30 thresholds drop arcs
    _arcs_eq(jclean.compact_arcs(w, jg), tclean.compact_arcs(g, tg))


@pytest.mark.parametrize("cutoff", [48, 400])
def test_delete_short_components(merged, cutoff):
    jg, ja = merged
    want = jclean.delete_short_components(jg, ja, cutoff)
    got = tclean.delete_short_components(_t(jg), _t(ja), cutoff)
    _eq(want.deleted, got.deleted)
    if cutoff == 400:
        assert got.deleted.sum() > 0
