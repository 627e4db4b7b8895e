"""The Tour-Bus wave around its identity check (``kernels/wave.py``:
``front`` and ``back``, and their halves ``chains_plain`` and
``claim_apply_plain``), on the CPU.

Held here: the port's ``_wave``, which goes through the front, the
identity check and the back (their plain versions on the CPU), equals
the JAX ``_wave`` on every wave of a pinch at -M 1, 2 and 3, with 8 and
1,024 candidates a wave, on two fixtures, all 11 outputs, but for the
arc rows that the port's arc rule drops (``tests/tourbus_rule.py``);
``front_plain`` equals a numpy loop written here (each node's live predecessor by
(coverage, -from-edge), the candidates by (coverage, row), then the
chains) on the front cases of tests/test_torch_wave_kernels_gpu.py (equal
coverages, few values, int32-limit coverages, duplicate and padded rows
with deleted edges and failed rows, no candidate, fewer, as many and
more candidates than cand_cap); ``back_plain``'s counts and ``failed``
update equal those of the wave step before the back (claim_apply_plain,
then the mark and the counts), with ok rows and without; and
``chains_plain`` and ``claim_apply_plain`` equal a numpy loop that takes
one candidate at a time, on the named cases of the same file (ties at
the meeting point, clash, palindrome, not found, equal rank, a shared
edge, the cover fallback, a created self-loop beside a genuine one,
coverage at the 16,000 cap, padded rows, and the arc rule's: a majority
path of two edges, a twin bubble with arcs from outside, no cover),
every row they leave joining.  Exact comparison (tolerance
0)."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from soapdenovo_trans_tpu.graph import arcs as jarcs
from soapdenovo_trans_tpu.graph import tourbus as jtour
from soapdenovo_trans_tpu.graph import unitigs as junitigs
from soapdenovo_trans_tpu_torch import convert
from soapdenovo_trans_tpu_torch.graph import arcs as tarcs
from soapdenovo_trans_tpu_torch.graph import tourbus as ttour
from soapdenovo_trans_tpu_torch.kernels import wave
from tests.test_bubbles import _multinode_bubble_reads, build
from tests.test_torch_tourbus import _many_bubbles
from tests.test_torch_wave_kernels_gpu import (CHAIN_CASES, CLAIM_CASES,
                                               FRONT_CASES, MAX_COV,
                                               RULE_CASES,
                                               back_inputs, chains_inputs,
                                               check_front_case,
                                               claim_inputs, front_case,
                                               front_inputs, joins,
                                               wave_case)
from tests.tourbus_rule import apply_loop, wave_rule


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# --- the numpy loops: one candidate at a time ------------------------

def _get(x, i, fill):
    return int(x[i]) if 0 <= i < len(x) else fill


def chains_loop(prev, u, t0, cmask, twin, m):
    """``chains`` one candidate at a time."""
    c = len(u)
    maj, mnr = np.full((c, m), -1), np.full((c, m), -1)
    tw_maj, tw_mnr = np.full((c, m), -1), np.full((c, m), -1)
    s_node, ends = np.full(c, -1), np.full((c, 4), -1)
    found = np.zeros(c, bool)
    n_back = 0
    for r in range(c):
        ca, cb = [int(t0[r])], [int(u[r])]
        while len(ca) < m + 2:
            ca.append(_get(prev, ca[-1], -1))
        while len(cb) < m + 1:
            cb.append(_get(prev, cb[-1], -1))
        meet = None  # the least i + j, then the least i
        for i in range(1, m + 2):
            for j in range(m + 1):
                if ca[i] >= 0 and ca[i] == cb[j] and (
                        meet is None or i + j < sum(meet)):
                    meet = (i, j)
        fnd = meet is not None and bool(cmask[r])
        n_back += fnd
        if fnd:
            i_s, j_s = meet
            s_node[r] = ca[i_s]
            path_a = ca[1:i_s][::-1]
            path_b = cb[:j_s][::-1]
            maj[r, :len(path_a)] = path_a
            mnr[r, :len(path_b)] = path_b
        tw_maj[r] = [_get(twin, x, -1) for x in maj[r]]
        tw_mnr[r] = [_get(twin, x, -1) for x in mnr[r]]
        ends[r] = [s_node[r], t0[r], _get(twin, s_node[r], -1),
                   _get(twin, t0[r], -1)]
        side_a = set(maj[r]) | set(tw_maj[r]) | set(ends[r])
        clash = any(x >= 0 and x in side_a
                    for x in list(mnr[r]) + list(tw_mnr[r]))
        clash |= any(x >= 0 and x == y for x, y in zip(mnr[r], tw_mnr[r]))
        found[r] = fnd and not clash and (mnr[r] >= 0).any() and \
            (maj[r] >= 0).any()
    return maj, mnr, tw_maj, tw_mnr, s_node, ends, found, n_back


def front_loop(n_edges, deleted, cvg, twin, from_ed, to_ed, mult, failed,
               m, cand_cap):
    """``front`` one row at a time: each node's live predecessor with the
    greatest (coverage, -from-edge), the candidates sorted by (coverage,
    row) and the other rows after them in row order, then
    ``chains_loop``."""
    e, a = len(cvg), len(from_ed)
    live = [i < n_edges and not deleted[i] for i in range(e)]
    varc = [mult[i] > 0 and 0 <= from_ed[i] < e and 0 <= to_ed[i] < e
            and live[from_ed[i]] and live[to_ed[i]] for i in range(a)]
    best = {}
    for i in np.flatnonzero(varc):
        f, t = int(from_ed[i]), int(to_ed[i])
        best[t] = max(best.get(t, (int(cvg[f]), -f)), (int(cvg[f]), -f))
    prev = np.full(e, -1)
    for t, (_cv, neg_f) in best.items():
        prev[t] = -neg_f
    cand = np.array([varc[i] and prev[to_ed[i]] != from_ed[i]
                     and not failed[i] for i in range(a)], bool)
    order = [i for _cv, i in sorted((int(cvg[from_ed[i]]), i)
                                    for i in np.flatnonzero(cand))]
    order += [i for i in range(a) if not cand[i]]
    cid_arc = np.array(order[:min(cand_cap, a)], np.int64)
    cmask = cand[cid_arc]
    u = np.where(cmask, from_ed[cid_arc], -1)
    t0 = np.where(cmask, to_ed[cid_arc], -1)
    maj, mnr, tw_maj, tw_mnr, _s, ends, found, n_back = chains_loop(
        prev, u, t0, cmask, twin, m)
    return (cid_arc, cmask, u, t0, maj, mnr, tw_maj, tw_mnr, ends, found,
            n_back, int(cand.sum()))


def _assert_equal(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64),
                                      np.asarray(w).astype(np.int64),
                                      err_msg=f"output {i}")


@pytest.mark.parametrize("m", [3, 30])
@pytest.mark.parametrize("name", CHAIN_CASES)
def test_chains_plain_matches_loop(name, m):
    case = wave_case(name, 48, m, 11)
    xs = chains_inputs(case, "cpu")
    got = wave.chains_plain(*xs, m)
    want = chains_loop(*(case[k] for k in ("prev", "u", "t0", "cmask",
                                           "twin")), m)
    _assert_equal(got, want)
    found, n_back = want[6], want[7]
    if name == "not_found":
        assert n_back == 0
    elif name in ("clash", "palindrome"):  # some met and were refused
        assert 0 < found.sum() < n_back
    else:
        assert found.sum() > 0
    if name == "ties":  # (2, 3) beat (3, 2): one majority node each
        assert ((want[0] >= 0).sum(1) == 1).all()
        assert ((want[1] >= 0).sum(1) == 3).all()


@pytest.mark.parametrize("m", [3, 9])
@pytest.mark.parametrize("name", CLAIM_CASES)
def test_claim_apply_plain_matches_loop(name, m):
    case = wave_case(name, 48, m, 21)
    xs = claim_inputs(case, m, 5, "cpu")
    got = wave.claim_apply_plain(*xs)
    want = apply_loop(*(x.numpy() for x in xs), MAX_COV)
    _assert_equal(got, want)
    cvg2, new_f, n_merged = want[0], want[2], want[5]
    ok = xs[5].numpy()
    from_ed, to_ed = case["from_ed"], case["to_ed"]
    # every row the wave leaves joins, as every row it was given does
    assert joins(from_ed, to_ed, case["from_node"], case["to_node"])
    assert joins(new_f, want[3], case["from_node"], case["to_node"])
    if name in RULE_CASES:
        check_rule_case(name, xs, want)
    if name in ("equal_rank", "shared_edge"):  # some ok rows lost
        assert 0 < n_merged < ok.sum()
    if name == "equal_rank":  # of two equal ranks on one edge, the lower
        info = want[6]         # candidate wins or neither does
        ties = [(r1, r2) for r1 in range(len(ok)) for r2 in range(r1)
                if ok[r1] and ok[r2] and info["rank"][r1] == info["rank"][r2]
                and set(info["claims"][r1]) & set(info["claims"][r2])]
        assert ties and not any(info["win"][r1] for r1, _r2 in ties)
    if name == "cvg_cap":
        assert (cvg2 == MAX_COV).any()
    if name == "padded_rows":
        pad = from_ed < 0
        assert pad.sum() >= 40
        assert (want[2][pad] == -1).all() and (want[3][pad] == -1).all() \
            and (want[4][pad] == 0).all()
    if name == "created_loop":
        dropped = (new_f < 0) & (from_ed >= 0)
        assert dropped.any()  # a self-loop the merge made
        genuine = (from_ed == to_ed) & (from_ed >= 0)
        # kept, but for a loop on a winner's minority node: the rule
        # drops it (the bubble's own arc), where the JAX wave moves it
        assert (new_f[genuine & ~want[6]["rule"]] >= 0).all()
        assert (new_f[genuine] >= 0).any()
    if name == "cover_fallback":  # a winner's node no majority span holds
        assert want[6]["fallbacks"] > 0


def check_rule_case(name, xs, want):
    """The rule's cases: the rule dropped rows; each winner's majority
    path (fork, its nodes, join) keeps every arc row it had, and so does
    its twin path; a winner with no majority path (``no_cover``) keeps no
    row of its minority nodes (the JAX wave sends them to edge 0)."""
    maj, mnr, tw_maj, tw_mnr, ends = (x.numpy() for x in xs[:5])
    from_ed, to_ed = xs[12].numpy(), xs[13].numpy()
    new_f, new_t, info = want[2], want[3], want[6]
    assert info["rule"].any()
    kept = set(zip(new_f.tolist(), new_t.tolist()))
    bare_winners = 0
    for r in np.flatnonzero(info["win"]):
        path = [ends[r, 0], *maj[r][maj[r] >= 0], ends[r, 1]]
        if len(path) == 2:  # no cover
            bare_winners += 1
            bare = set(mnr[r][mnr[r] >= 0]) | set(tw_mnr[r][tw_mnr[r] >= 0])
            touched = np.isin(from_ed, list(bare)) | np.isin(to_ed, list(bare))
            assert touched.any() and (new_f[touched] == -1).all()
            continue
        tw = [ends[r, 3], *tw_maj[r][tw_maj[r] >= 0][::-1], ends[r, 2]]
        for p in (path, tw):
            for f, t in zip(p, p[1:]):
                if ((from_ed == f) & (to_ed == t)).any():
                    assert (int(f), int(t)) in kept, (r, f, t)
    assert (bare_winners > 0) == (name == "no_cover")


@pytest.mark.parametrize("cap", [8, 1024])
@pytest.mark.parametrize("name", FRONT_CASES)
def test_front_plain_matches_loop(name, cap):
    m = 3
    xs = front_inputs(front_case(name, cap, m, 31), "cpu")
    got = wave.front(*xs, m, cap)
    want = front_loop(xs[0], *(x.numpy() for x in xs[1:]), m, cap)
    _assert_equal(got, want)
    check_front_case(name, cap, want[11])
    if name not in ("none", "below", "at"):
        assert want[11] > cap  # the select cut the candidates
    if name in ("ties", "few_values"):  # the cut falls inside a tie
        cvg_f = xs[2][xs[4][want[0][want[1]]]]
        assert int((cvg_f == cvg_f[-1]).sum()) >= 2


@pytest.mark.parametrize("productive", [True, False])
@pytest.mark.parametrize("cap", [8, 1024])
@pytest.mark.parametrize("name", FRONT_CASES)
def test_back_plain_matches_wave_step(name, cap, productive):
    """``back_plain`` against the wave step before the back: claim_apply
    (claim_apply_plain), then failed[cid_arc] marked where cmask & ~ok
    when nothing merged, and the counts merged, max(n_cand - cand_cap,
    0), backtracked, compared."""
    m = 3
    xs = back_inputs(front_case(name, cap, m, 31), m, cap, 5, productive,
                     "cpu")
    failed = xs[-1].clone()
    got = wave.back(*xs[:-1], failed)
    want = wave.claim_apply_plain(*xs[:17])
    ok, (compared, cmask, cid_arc, n_cand, n_back) = xs[5], xs[17:22]
    n_merged = int(want[5])
    want_failed = xs[-1].numpy().copy()
    if n_merged == 0:
        want_failed[cid_arc.numpy()[(cmask & ~ok).numpy()]] = True
    dropped = int(((xs[12] >= 0) & (want[2] < 0)).sum())
    assert got[0].tolist() == [n_merged, max(int(n_cand) - cap, 0),
                               int(n_back), int(compared.sum()), dropped]
    _assert_equal(got[1:], want[:5])
    np.testing.assert_array_equal(failed.numpy(), want_failed)
    assert (n_merged > 0) == bool(ok.any())
    if n_merged == 0 and bool(cmask.any()):
        assert failed.sum() > xs[-1].sum()  # the examined rows retired


# --- the port's _wave against the JAX _wave, every wave of a pinch ----

@functools.lru_cache(maxsize=None)
def _graph(name):
    """The port's (EdgeGraph, exact ArcSet) of a named fixture."""
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


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("name,cand_cap", [("mixed", 1024), ("mixed", 8),
                                           ("multinode", 1024),
                                           ("multinode", 8)])
def test_wave_matches_jax_every_wave(monkeypatch, name, cand_cap, level):
    """A pinch on the port's wave program; before each wave, the JAX
    ``_wave`` and the port's ``_wave`` on the same state (the table at
    the pinch's fixed capacity) give the same 11 outputs, but for the
    arc rows that the port's rule drops (``tests/tourbus_rule.py``,
    recomputed here from the wave's paths and the edges' end nodes):
    there the port's rows are (-1, -1, 0), and the rule drops some."""
    monkeypatch.setattr(ttour, "CAND_CAP", cand_cap)
    eg, aset = _graph(name)
    m_max, diff = ttour._params_for(level)
    prog = ttour.WaveProgram(eg, aset, m_max, diff)
    args = (m_max, diff, ttour.SEQ_CAP, cand_cap)
    waves = productive = dropped = 0
    while True:
        jeg = convert.to_numpy(prog.eg, junitigs.EdgeGraph)
        jas = convert.to_numpy(prog.aset, jarcs.ArcSet)
        want = [np.asarray(w) for w in jtour._wave(
            jeg, jas, jnp.asarray(prog.failed.numpy()), *args)]
        got = ttour._wave(prog.eg, prog.aset, prog.failed.clone(), *args)
        if int(want[7]):
            rule = wave_rule(jeg, jas, prog.failed.numpy(), *args, MAX_COV)
            dropped += int(rule.sum())
            for i, fill in ((2, -1), (3, -1), (4, 0)):
                want[i] = np.where(rule, fill, want[i])
        _assert_equal(got, want)
        waves += 1
        n, over = prog.launch().tolist()[:2]
        if n:
            productive += 1
            prog.apply()
        elif not over:
            break
    assert productive >= 1 and dropped > 0
    assert waves > productive or cand_cap == 1024
