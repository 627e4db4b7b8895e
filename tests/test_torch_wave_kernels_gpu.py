"""The CUDA kernels of the Tour-Bus wave around its identity check
(``front_launch`` and ``back_launch`` of csrc/wave.cu) against their
plain PyTorch versions, on the card, and a captured replay of a wave
against the eager wave.  Imports no JAX, so it runs where only torch is
installed:

    python -m pytest --noconftest tests/test_torch_wave_kernels_gpu.py -m gpu

The case generators here are shared with tests/test_torch_wave_kernels.py
(the CPU tests) and chip_smoke.py, which loads this file by path.  Exact
comparison (tolerance 0); the back's E- and A-sized outputs are compared
where it merged something (they are undefined where it did not).
"""

import functools
import os

import numpy as np
import pytest
import torch

from soapdenovo_trans_tpu_torch.kernels import wave
from soapdenovo_trans_tpu_torch.ops import index

MAX_COV = 16000  # wave.MAX_EDGE_COV

# the kinds of candidate row a case is made of (``wave_case``)
ROW_KINDS = ("bubble", "shared", "ties", "clash", "palindrome", "no_meet",
             "masked", "deep", "zero_length", "skip", "twin")
# named cases: the rows each is made of
CASES = {
    "ties": ("ties",),
    "clash": ("clash", "bubble"),
    "palindrome": ("palindrome", "bubble"),
    "not_found": ("no_meet", "masked", "deep"),
    "equal_rank": ("shared",),
    "shared_edge": ("shared", "bubble"),
    "cover_fallback": ("zero_length",),
    "created_loop": ("bubble",),
    "cvg_cap": ("bubble", "shared"),
    "padded_rows": ("bubble", "masked"),
    "skip_join": ("skip",),
    "twin_bubble": ("twin",),
    "no_cover": ("bubble", "skip"),
    "mixed": ROW_KINDS,
    "random": (),
}
CHAIN_CASES = ["ties", "clash", "palindrome", "not_found", "mixed",
               "random"]
CLAIM_CASES = ["equal_rank", "shared_edge", "cover_fallback",
               "created_loop", "cvg_cap", "padded_rows", "skip_join",
               "twin_bubble", "no_cover", "mixed", "random"]
# the cases of the arc rule: every row a wave leaves joins, and the
# majority paths survive
RULE_CASES = ["skip_join", "twin_bubble", "no_cover"]


class _Graph:
    """A synthetic graph grown node by node: each node a forest parent
    (prev), a twin, a length, a coverage; and a list of arc rows."""

    def __init__(self, rng):
        self.rng = rng
        self.prev, self.twin, self.length, self.cvg = [], [], [], []
        self.arcs = []

    def node(self, prev=-1, twin=True) -> int:
        """A new node, with a new twin node of its own unless told not."""
        n = len(self.prev)
        self.prev.append(prev)
        self.twin.append(n)
        self.length.append(int(self.rng.integers(1, 40)))
        self.cvg.append(int(self.rng.integers(0, 200)))
        if twin:
            t = self.node(twin=False)
            self.twin[n], self.twin[t] = t, n
        return n

    def pair(self, a: int, b: int) -> None:
        """Make a and b each other's twins (their own twins unpaired)."""
        for x in (a, b):
            old = self.twin[x]
            self.twin[old] = old
        self.twin[a], self.twin[b] = b, a

    def path(self, start: int, n: int) -> list:
        """n new nodes hanging from start, each the next one's prev."""
        nodes, at = [], start
        for _ in range(n):
            at = self.node(prev=at)
            nodes.append(at)
        return nodes

    def arc(self, f: int, t: int) -> None:
        self.arcs.append((f, t))

    def twin_arcs(self, rows) -> None:
        """The twin of each row (f, t): twin(t) -> twin(f)."""
        for f, t in rows:
            self.arc(self.twin[t], self.twin[f])


def _bubble(g: _Graph, m: int, p=None, q=None, fork=None, maj=None):
    """A bubble in the forest: fork s, a majority path of p nodes then t
    (t's prev the last of them), a minority path of q nodes ending in u;
    the candidate arc u -> t.  ``fork``/``maj`` reuse another bubble's s
    and (majority nodes, t).  Returns (u, t, s, majority, minority)."""
    rng = g.rng
    s = g.node() if fork is None else fork
    if maj is None:
        p = int(rng.integers(1, m + 1)) if p is None else p
        a_nodes = g.path(s, p)
        t = g.node(prev=a_nodes[-1] if a_nodes else s)
    else:
        a_nodes, t = maj
    q = int(rng.integers(1, m + 1)) if q is None else q
    b_nodes = g.path(s, q)
    for f, to in zip([s] + a_nodes, a_nodes + [t]):
        g.arc(f, to)
    for f, to in zip([s] + b_nodes, b_nodes + [t]):
        g.arc(f, to)
    return b_nodes[-1], t, s, a_nodes, b_nodes


def _row(g: _Graph, kind: str, m: int, last):
    """One candidate row of ``kind``: (u, t0, cmask, bubble)."""
    rng = g.rng
    if kind == "shared" and last is not None and last[3]:
        # another minority path onto the previous bubble's fork and
        # majority path: the two claim the same edges
        b = _bubble(g, m, fork=last[2], maj=(last[3], last[1]))
        return b[0], b[1], True, b
    if kind == "skip":
        # two majority nodes, one minority node: the JAX remap joins the
        # fork or the minority node's cover past a majority node; an arc
        # from outside into the minority node, and one out of it
        n_arcs = len(g.arcs)
        b = _bubble(g, m, p=2, q=1)
        g.arc(g.node(), b[4][0])
        g.arc(b[4][0], g.node())
        g.twin_arcs(g.arcs[n_arcs:])
        return b[0], b[1], True, b
    if kind == "twin":
        # a bubble and its twin bubble, with arcs from outside into the
        # minority path and its twin: an outside edge x with x -> the
        # first majority node and x -> the first minority node (its
        # remap joins), and one with x -> a later minority node only
        n_arcs = len(g.arcs)
        b = _bubble(g, m, p=int(rng.integers(1, m + 1)),
                    q=int(rng.integers(2, m + 1)))
        x, y = g.node(), g.node()
        g.arc(x, b[3][0])
        g.arc(x, b[4][0])
        g.arc(y, b[4][-1])
        g.twin_arcs(g.arcs[n_arcs:])
        return b[0], b[1], True, b
    if kind in ("bubble", "shared", "clash", "palindrome", "zero_length"):
        b = _bubble(g, m)
        u, t, _s, a_nodes, b_nodes = b
        if kind == "clash":  # a minority node's twin on the majority side
            g.pair(b_nodes[0], a_nodes[0])
        if kind == "palindrome":  # a minority node its own twin
            g.pair(b_nodes[-1], b_nodes[-1])
        if kind == "zero_length":  # no majority span holds the midpoint
            g.length[b_nodes[-1]] = 0
            if rng.random() < 0.5:
                for x in a_nodes:
                    g.length[x] = 0
        return u, t, True, b
    if kind == "ties":
        # chain_a = t, a1, x, y, ..; chain_b = u, b1, y, x, ..: (2, 3) and
        # (3, 2) both cost 5, and the smaller i must win; the arcs x -> y
        # and y -> x give the front's forest the same cycle
        x, y = g.node(), g.node()
        g.prev[x], g.prev[y] = y, x
        a1 = g.node(prev=x)
        t = g.node(prev=a1)
        b1 = g.node(prev=y)
        u = g.node(prev=b1)
        for f, to in ((x, a1), (a1, t), (y, b1), (b1, u), (u, t), (x, y),
                      (y, x)):
            g.arc(f, to)
        return u, t, True, (u, t, x, [a1], [y, b1, u])
    if kind == "no_meet":
        a_nodes = g.path(g.node(), m + 3)
        b_nodes = g.path(g.node(), m + 3)
        g.arc(b_nodes[-1], a_nodes[-1])
        return b_nodes[-1], a_nodes[-1], True, None
    if kind == "deep":  # the fork one step past the walk
        b = _bubble(g, m, p=m + 1)
        return b[0], b[1], True, None
    # masked: a real bubble the wave does not examine
    b = _bubble(g, m)
    return -1, -1, False, None


def wave_case(name: str, c: int, m: int, seed: int):
    """A dict of numpy arrays: the inputs of ``chains_plain`` (prev, u,
    t0, cmask, twin) on a synthetic graph of C candidate rows made of the
    row kinds of ``CASES[name]``, and the graph's length, cvg, deleted
    and arc rows (from_ed, to_ed, mult) for ``claim_apply_plain``.  ``random``
    is a random forest (every node's prev a few ids lower) with random
    twins and candidate arcs between nearby nodes.  Named cases shape
    what they name: ``cvg_cap`` coverage at and near 16,000,
    ``padded_rows`` (-1, -1, 0) rows after the real ones, ``created_loop``
    arcs between minority nodes and genuine self-loops; every case has a
    few self-loops and padded rows."""
    rng = np.random.default_rng(seed)
    g = _Graph(rng)
    kinds = CASES[name]
    u, t0, cmask = [], [], []
    if name == "random":
        e = 4 * c + 64
        prev = np.arange(e) - rng.integers(1, 5, e)
        prev[(prev < 0) | (rng.random(e) < 0.05)] = -1
        perm = rng.permutation(e)
        twin = np.arange(e)
        twin[perm[0::2][:e // 2]] = perm[1::2][:e // 2]
        twin[perm[1::2][:e // 2]] = perm[0::2][:e // 2]
        t0 = rng.integers(0, e, c)
        u = np.clip(t0 + rng.integers(-8, 9, c), 0, e - 1)
        cmask = rng.random(c) < 0.9
        g.prev, g.twin = list(prev), list(twin)
        g.length = list(rng.integers(0, 40, e))
        g.cvg = list(rng.integers(0, 300, e))
        g.arcs = list(zip(rng.integers(0, e, 3 * c), rng.integers(0, e, 3 * c)))
        u, t0 = np.where(cmask, u, -1), np.where(cmask, t0, -1)
    else:
        last = None
        for i in range(c):
            kind = kinds[int(rng.integers(0, len(kinds)))]
            if kind == "shared" and rng.random() < 0.5:
                kind = "bubble"  # a fresh pair every other row
            ui, ti, mi, b = _row(g, kind, m, last)
            last = b if b is not None else last
            u.append(ui), t0.append(ti), cmask.append(mi)
        u, t0, cmask = (np.array(u, np.int64), np.array(t0, np.int64),
                        np.array(cmask, bool))
    e = len(g.prev)
    cvg = np.array(g.cvg, np.int64)
    if name == "equal_rank":  # every rank 0: the candidate index decides
        cvg[:] = 0
    if name in ("cvg_cap", "mixed"):
        cvg[:] = rng.choice([0, 1, 7, 7, 7], e)  # many equal ranks
    if name in ("cvg_cap", "mixed"):
        cvg[rng.random(e) < 0.5] = MAX_COV - rng.integers(0, 3)
        cvg[rng.random(e) < 0.2] = MAX_COV
    arcs = list(g.arcs)
    if name in ("created_loop", "mixed", "random"):
        # arcs between two nodes of one path: both may map onto one cover
        for f in rng.integers(0, e, max(c // 2, 4)):
            arcs.append((int(f), int(g.prev[f]) if g.prev[f] >= 0 else
                         int(f)))
    loops = rng.integers(0, e, 4)  # genuine self-loops stay
    arcs += [(int(x), int(x)) for x in loops]
    order = rng.permutation(len(arcs))
    arcs = np.array(arcs, np.int64).reshape(-1, 2)[order]
    pad = 40 if name == "padded_rows" else 3
    from_ed = np.concatenate([arcs[:, 0], np.full(pad, -1)])
    to_ed = np.concatenate([arcs[:, 1], np.full(pad, -1)])
    mult = np.concatenate([rng.integers(1, 30, len(arcs)), np.zeros(pad)])
    from_node, to_node = end_nodes(e, arcs)
    return {"prev": np.array(g.prev, np.int64), "u": np.asarray(u, np.int64),
            "t0": np.asarray(t0, np.int64), "cmask": np.asarray(cmask, bool),
            "twin": np.array(g.twin, np.int64),
            "length": np.array(g.length, np.int64), "cvg": cvg,
            "deleted": rng.random(e) < 0.05,
            "from_ed": from_ed.astype(np.int64),
            "to_ed": to_ed.astype(np.int64), "mult": mult.astype(np.int64),
            "from_node": from_node, "to_node": to_node,
            "no_cover": name == "no_cover"}


def end_nodes(e: int, arcs) -> tuple:
    """(from_node, to_node) of e edges under which every arc row (f, t)
    joins: to_node[f] == from_node[t].  Each edge's start and end are
    nodes, and an arc makes its from-edge's end and its to-edge's start
    one node (union-find); an edge no arc touches keeps two nodes of its
    own."""
    parent = list(range(2 * e))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x
    for f, t in arcs:
        if 0 <= f < e and 0 <= t < e:
            parent[find(2 * f + 1)] = find(2 * t)
    node = np.array([find(x) for x in range(2 * e)], np.int64)
    return node[0::2].copy(), node[1::2].copy()


def joins(new_f, new_t, from_node, to_node) -> bool:
    """Whether every row with a from-edge joins (-1 rows are dropped)."""
    f, t = np.asarray(new_f), np.asarray(new_t)
    live = f >= 0
    return bool((t[live] >= 0).all()) and bool(
        (np.asarray(to_node)[f[live]] == np.asarray(from_node)[t[live]]).all())


def chains_inputs(case, dev):
    """(prev, u, t0, cmask, twin) of a ``wave_case`` on ``dev``."""
    return tuple(torch.from_numpy(case[k]).to(dev)
                 for k in ("prev", "u", "t0", "cmask", "twin"))


def claim_inputs(case, m: int, seed: int, dev):
    """The 17 inputs of ``claim_apply_plain`` on ``dev``: ``chains_plain``'s
    outputs on the case's graph, ok = found on ~90% of the found rows,
    len_a and len_b the paths' summed lengths (as the identity check
    gives them), and the graph's arrays.  In the ``no_cover`` case every
    third ok row loses its majority path (no cover for its minority
    nodes; the front never gives such a row)."""
    rng = np.random.default_rng(seed)
    maj, mnr, tw_maj, tw_mnr, _s, ends, found, _n = wave.chains_plain(
        *chains_inputs(case, "cpu"), m)
    ok = found & torch.from_numpy(rng.random(found.shape[0]) < 0.9)
    if case["no_cover"]:
        bare = torch.nonzero(ok).flatten()[::3]
        maj[bare], tw_maj[bare] = -1, -1
    length = torch.from_numpy(case["length"])
    sums = [index.gather2(length, x, 0).sum(1) for x in (maj, mnr)]
    xs = (maj, mnr, tw_maj, tw_mnr, ends, ok, *sums,
          *(torch.from_numpy(case[k]) for k in (
              "cvg", "length", "twin", "deleted", "from_ed", "to_ed",
              "mult", "from_node", "to_node")))
    return tuple(x.contiguous().to(dev) for x in xs)


# the front's cases (``front_case``): each a wave's arc table with the
# candidates it names
FRONT_CASES = ("ties", "few_values", "extreme", "dup_pad", "none", "below",
               "at", "above", "mixed", "random")
# coverages at and beyond the limits of int32 and of the wave's clamp
EXTREME_COV = (-2**31, -2**31 + 1, -16001, -1, 0, 1, 16000, 16001,
               2**31 - 2, 2**31 - 1)
FRONT_KEYS = ("n_edges", "deleted", "cvg", "twin", "from_ed", "to_ed",
              "mult", "failed")


@functools.lru_cache(maxsize=None)
def front_case(name: str, cand_cap: int, m: int, seed: int):
    """A dict of numpy arrays: the inputs of ``front`` (FRONT_KEYS) and the
    edges' length, on the arc table of a ``wave_case`` of 64 rows (1,536
    when cand_cap > 8; ``random`` on that case's random graph, the rest
    on ``mixed``), 5% of the rows failed.  ``ties``: every coverage 7;
    ``few_values``: coverages 0, 1 and 7; ``extreme``: EXTREME_COV;
    ``dup_pad``: a fifth of the rows repeated, 50 (-1, -1, 0) rows, some
    mult 0, all shuffled, a tenth of the edges deleted and of the rows
    failed, the last tenth of the edges not in use (n_edges); ``none``:
    every row failed; ``below``, ``at``: the candidates cut to cand_cap
    // 2 and cand_cap by failing the others; ``above``: more candidates
    than cand_cap (the tests check it)."""
    rng = np.random.default_rng(seed)
    rows = 64 if cand_cap <= 8 else 1536
    base = wave_case("random" if name == "random" else "mixed", rows, m,
                     seed)
    e = len(base["cvg"])
    out = {"n_edges": e, "deleted": base["deleted"].copy(),
           "cvg": base["cvg"].copy(), "twin": base["twin"],
           "length": base["length"], "from_ed": base["from_ed"],
           "to_ed": base["to_ed"], "mult": base["mult"],
           "from_node": base["from_node"], "to_node": base["to_node"]}
    if name == "ties":
        out["cvg"][:] = 7
    elif name == "few_values":
        out["cvg"] = rng.choice([0, 1, 7], e).astype(np.int64)
    elif name == "extreme":
        out["cvg"] = rng.choice(EXTREME_COV, e).astype(np.int64)
    elif name == "dup_pad":
        a = len(out["from_ed"])
        dup = np.flatnonzero(rng.random(a) < 0.2)
        order = rng.permutation(a + len(dup) + 50)
        for key, fill in (("from_ed", -1), ("to_ed", -1), ("mult", 0)):
            x = out[key]
            out[key] = np.concatenate([x, x[dup], np.full(50, fill)])[order]
        out["mult"][rng.random(len(order)) < 0.05] = 0
        out["deleted"] = rng.random(e) < 0.1
        out["n_edges"] = e - e // 10
    a = len(out["from_ed"])
    out["failed"] = rng.random(a) < (0.1 if name == "dup_pad" else 0.05)
    if name == "none":
        out["failed"][:] = True
    if name in ("below", "at"):
        cand = candidate_rows(out)
        keep = cand_cap // 2 if name == "below" else cand_cap
        assert len(cand) >= keep, (name, cand_cap, len(cand))
        out["failed"][rng.permutation(cand)[keep:]] = True
    return {k: (v.astype(np.int64) if isinstance(v, np.ndarray)
                and v.dtype != bool else v) for k, v in out.items()}


def candidate_rows(case) -> np.ndarray:
    """The rows of a ``front_case`` that are candidates, in row order."""
    xs = front_inputs(case, "cpu")
    _prev, order, cmask, *_ = wave.candidates_plain(
        *xs[:3], *xs[4:], cand_cap=len(case["from_ed"]))
    return np.sort(order[cmask].numpy())


def front_inputs(case, dev):
    """(n_edges, deleted, cvg, twin, from_ed, to_ed, mult, failed) of a
    ``front_case`` on ``dev``."""
    return (case["n_edges"], *(torch.from_numpy(np.asarray(case[k])).to(dev)
                               for k in FRONT_KEYS[1:]))


def back_inputs(case, m: int, cand_cap: int, seed: int, productive: bool,
                dev):
    """The 24 inputs of ``back`` on ``dev``: ``front_plain``'s outputs on
    a ``front_case``, ok = found on ~90% of the found rows (none unless
    ``productive``), compared = ok and half the other found rows, len_a
    and len_b the paths' summed lengths, the coverage clipped into [0,
    16,000] (the claim key's ranks need it, and every wave's clamp keeps
    it), a copy of the case's failed."""
    rng = np.random.default_rng(seed)
    (cid_arc, cmask, _u, _t0, maj, mnr, tw_maj, tw_mnr, ends, found, n_back,
     n_cand) = wave.front_plain(*front_inputs(case, "cpu"), m, cand_cap)
    c = found.shape[0]
    ok = found & torch.from_numpy(rng.random(c) < 0.9) & productive
    compared = ok | (found & torch.from_numpy(rng.random(c) < 0.5))
    length = torch.from_numpy(case["length"])
    sums = [index.gather2(length, x, 0).sum(1) for x in (maj, mnr)]
    cvg = torch.from_numpy(case["cvg"]).clamp(0, MAX_COV)
    xs = (maj, mnr, tw_maj, tw_mnr, ends, ok, *sums, cvg, length,
          *(torch.from_numpy(np.asarray(case[k])) for k in (
              "twin", "deleted", "from_ed", "to_ed", "mult", "from_node",
              "to_node")),
          compared, cmask, cid_arc, n_cand, n_back)
    failed = torch.from_numpy(case["failed"].copy())
    return (*(x.contiguous().to(dev) for x in xs), cand_cap, failed.to(dev))


def max_abs_err(got, want) -> int:
    """The largest |got - want| over matching outputs; raises on a shape
    or type mismatch."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{tuple(g.shape)} {g.dtype} != "
                                 f"{tuple(w.shape)} {w.dtype}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


# the card's cases: every named case at m = 3, 9 and 30, and random ones
# at a wave's C = 1,024
GPU_CASES = ([(name, 64, m) for name in CASES for m in (3, 9, 30)]
             + [(name, 1024, m) for name in ("random", "mixed")
                for m in (3, 9, 30)])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# the front's and the back's cases: every front case at cand_cap 8 and
# 1,024 and m = 3, 9 and 30; the back on each, with ok rows and without
FRONT_GPU_CASES = [(name, cap, m) for name in FRONT_CASES
                   for cap in (8, 1024) for m in (3, 9, 30)]
BACK_GPU_CASES = [(*case, productive) for case in FRONT_GPU_CASES
                  for productive in (True, False)]


def check_front_case(name: str, cap: int, n_cand: int) -> None:
    """The case holds the candidates it names."""
    if name == "none":
        assert n_cand == 0
    elif name == "below":
        assert n_cand == cap // 2
    elif name == "at":
        assert n_cand == cap
    elif name == "above":
        assert n_cand > cap


def back_err(got, want, failed_got, failed_want) -> int:
    """The largest |got - want| of the back: the counts and failed always,
    the other outputs where the wave merged something."""
    n = 6 if int(want[0][0]) > 0 else 1
    return max(max_abs_err(got[:n], want[:n]),
               max_abs_err((failed_got,), (failed_want,)))


@pytest.mark.gpu
@pytest.mark.parametrize("i", range(len(FRONT_GPU_CASES)))
def test_front_kernel_matches_plain(i):
    dev = _card()
    name, cap, m = FRONT_GPU_CASES[i]
    case = front_case(name, cap, m, i)
    xs = front_inputs(case, dev)
    before = wave.FRONT_LAUNCHES
    got = wave.front(*xs, m, cap)
    want = wave.front_plain(*xs, m, cap)
    torch.cuda.synchronize()
    assert wave.FRONT_LAUNCHES == before + 1
    assert max_abs_err(got, want) == 0, (name, cap, m)
    check_front_case(name, cap, int(want[11]))
    # the forest scratch is empty again
    scratch = wave.forest_scratch(dev, xs[2].shape[0])
    assert bool((scratch == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("i", range(len(BACK_GPU_CASES)))
def test_back_kernel_matches_plain(i):
    dev = _card()
    name, cap, m, productive = BACK_GPU_CASES[i]
    xs = back_inputs(front_case(name, cap, m, i // 2), m, cap, i,
                     productive, dev)
    failed, failed_plain = xs[-1], xs[-1].clone()
    before = wave.BACK_LAUNCHES
    got = wave.back(*xs[:-1], failed)
    want = wave.back_plain(*xs[:-1], failed_plain)
    torch.cuda.synchronize()
    assert wave.BACK_LAUNCHES == before + 1
    assert back_err(got, want, failed, failed_plain) == 0, (name, cap, m)
    merged = int(want[0][0])
    assert (merged > 0) == bool(xs[5].any())
    if not merged and bool(xs[18].any()):
        assert bool(failed.any())  # the examined rows were retired
    scratch = wave.claim_scratch(dev, xs[8].shape[0])
    assert bool((scratch == wave.EMPTY).all())


def claim_back_inputs(name: str, c: int, m: int, seed: int, dev):
    """The 24 inputs of ``back`` on a ``wave_case`` of C rows:
    ``claim_inputs``, every row with a minority path examined (cmask,
    cid_arc its own row), compared = ok, cand_cap = C, no row failed."""
    case = wave_case(name, c, m, seed)
    xs = claim_inputs(case, m, seed, "cpu")
    c = xs[0].shape[0]
    ok = xs[5]
    more = (ok.clone(), ok | (xs[1] >= 0).any(1), torch.arange(c),
            torch.tensor(c), (xs[1] >= 0).any(1).sum())
    failed = torch.zeros(xs[12].shape[0], dtype=torch.bool)
    return (*(x.contiguous().to(dev) for x in xs + more), c,
            failed.to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("name", RULE_CASES)
@pytest.mark.parametrize("m", [3, 9, 30])
def test_back_kernel_rule_cases(name, m):
    """The back's kernels against ``back_plain`` where the arc rule
    drops rows: the counts (the dropped rows among them), the rows, and
    every row left joins."""
    dev = _card()
    xs = claim_back_inputs(name, 64, m, 500 + m, dev)
    failed, failed_plain = xs[-1], xs[-1].clone()
    got = wave.back(*xs[:-1], failed)
    want = wave.back_plain(*xs[:-1], failed_plain)
    torch.cuda.synchronize()
    assert int(want[0][0]) > 0 and int(want[0][4]) > 0
    assert back_err(got, want, failed, failed_plain) == 0, (name, m)
    assert joins(got[3].cpu(), got[4].cpu(), xs[15].cpu(), xs[16].cpu())
    scratch = wave.claim_scratch(dev, xs[8].shape[0])
    assert bool((scratch == wave.EMPTY).all())


def case_front_inputs(case, dev):
    """``front``'s inputs on the arc table a ``wave_case``'s graph built:
    every edge in use, no row failed."""
    return front_inputs({**case, "n_edges": len(case["cvg"]),
                         "failed": np.zeros(len(case["from_ed"]), bool)},
                        dev)


@pytest.mark.gpu
@pytest.mark.parametrize("i", range(len(GPU_CASES)))
def test_front_kernel_on_wave_cases(i):
    """The front's kernels against ``front_plain`` on the arc table of
    every named case and the random ones: the forest comes from the
    case's arcs, so chains_kernel walks what the main path gives it.
    Paths are found in every case but ``random``, whose hand-set forest
    has no arcs behind it (the front's walks on its random arcs meet in
    a few rows, each refused by the clash test or an empty path)."""
    dev = _card()
    name, c, m = GPU_CASES[i]
    xs = case_front_inputs(wave_case(name, c, m, 300 + i), dev)
    before = wave.FRONT_LAUNCHES
    got = wave.front(*xs, m, 1024)
    want = wave.front_plain(*xs, m, 1024)
    torch.cuda.synchronize()
    assert wave.FRONT_LAUNCHES == before + 1
    assert max_abs_err(got, want) == 0, (name, c, m)
    assert int(want[10]) > 0  # walks met
    assert bool(want[9].any()) == (name != "random")
    scratch = wave.forest_scratch(dev, xs[2].shape[0])
    assert bool((scratch == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("i", range(len(GPU_CASES)))
def test_back_kernel_on_wave_cases(i):
    """The back's kernels against ``back_plain`` on every named case and
    the random ones, with ok rows (its productive branch; ``not_found``
    has none): the counts and failed, and where it merged every other
    output; the claim scratch empty after."""
    dev = _card()
    name, c, m = GPU_CASES[i]
    xs = claim_back_inputs(name, c, m, 400 + i, dev)
    failed, failed_plain = xs[-1], xs[-1].clone()
    before = wave.BACK_LAUNCHES
    got = wave.back(*xs[:-1], failed)
    want = wave.back_plain(*xs[:-1], failed_plain)
    torch.cuda.synchronize()
    assert wave.BACK_LAUNCHES == before + 1
    assert back_err(got, want, failed, failed_plain) == 0, (name, c, m)
    assert (int(want[0][0]) > 0) == (name != "not_found")
    scratch = wave.claim_scratch(dev, xs[8].shape[0])
    assert bool((scratch == wave.EMPTY).all())


@pytest.fixture(scope="module")
def small_graph(tmp_path_factory):
    """(EdgeGraph, ArcSet, k) of the port's pregraph of 3,000 simulated
    pairs (``perf_e2e.synth``, seed 1), built on the CPU."""
    _card()
    import perf_e2e
    from soapdenovo_trans_tpu_torch import cli
    from soapdenovo_trans_tpu_torch.io import graph_files

    folder = str(tmp_path_factory.mktemp("wave_gpu"))
    cfg = perf_e2e.synth(folder, n_tx=40, n_pairs=3000, seed=1)
    prefix = os.path.join(folder, "asm")
    saved = os.environ.get("SOAPDENOVO_TORCH_DEVICE")
    os.environ["SOAPDENOVO_TORCH_DEVICE"] = "cpu"
    try:
        cli.main(["pregraph", "-s", cfg, "-K", "23", "-o", prefix])
    finally:
        if saved is None:
            del os.environ["SOAPDENOVO_TORCH_DEVICE"]
        else:
            os.environ["SOAPDENOVO_TORCH_DEVICE"] = saved
    _table, eg, aset, k = graph_files.load_pregraph_files(
        prefix, torch.device("cpu"))
    return eg, aset, k


@pytest.mark.gpu
@pytest.mark.parametrize("level", [1, 3])
def test_replayed_wave_equals_eager(small_graph, level):
    """Each replayed wave of a pinch's program equals ``_wave_step`` run
    eagerly on copies of the same state: the counts and ``failed``, and
    all outputs where the wave merged (they are undefined where it did
    not); the front, identity and back kernels execute once a wave."""
    from soapdenovo_trans_tpu_torch.graph import tourbus

    eg, aset, _k = small_graph
    dev = torch.device("cuda")
    eg = type(eg)(*(x.to(dev) if isinstance(x, torch.Tensor) else x
                    for x in eg))
    aset = type(aset)(*(x.to(dev) if isinstance(x, torch.Tensor) else x
                        for x in aset))
    m_max, diff = tourbus._params_for(level)
    prog = tourbus.WaveProgram(eg, aset, m_max, diff)
    replays = productive = 0
    while True:
        state = (prog.eg._replace(cvg=prog.cvg.clone(),
                                  deleted=prog.deleted.clone()),
                 type(prog.aset)(*(x.clone() for x in prog.aset[:3]),
                                 prog.aset.n),
                 prog.failed.clone())
        before = executions()
        counts = prog.launch()
        # one execution of each kernel a wave, eager or replayed
        assert executions() == tuple(n + 1 for n in before)
        want = tourbus._wave_step(*state, *prog.args)
        torch.cuda.synchronize()
        n, over = counts.tolist()[:2]
        if prog.graph is not None:
            replays += 1
            k = 6 if n else 1  # the counts alone when nothing merged
            assert max_abs_err(prog.outs[:k], want[:k]) == 0
            assert torch.equal(prog.failed, state[2])
        if n:
            productive += 1
            prog.apply()
        elif not over:
            break
    assert replays >= 1 and productive >= 1


def executions() -> tuple:
    """Executions of the front, identity and back kernels."""
    from soapdenovo_trans_tpu_torch.kernels import lcs

    return wave.FRONT_LAUNCHES, lcs.IDENTITY_LAUNCHES, wave.BACK_LAUNCHES
