"""The CUDA kernels of the Tour-Bus wave's candidate body (``chains_launch``
and ``claim_apply_launch`` of csrc/wave.cu) against their plain PyTorch
versions, on the card, and a captured replay of a wave against the eager
wave.  Imports no JAX, so it runs where only torch is installed:

    python -m pytest --noconftest tests/test_torch_wave_kernels_gpu.py -m gpu

The case generators here are shared with tests/test_torch_wave_kernels.py
(the CPU tests) and chip_smoke.py, which loads this file by path.  Exact
comparison (tolerance 0).
"""

import os

import numpy as np
import pytest
import torch

from soapdenovo_trans_tpu_torch.kernels import wave

MAX_COV = 16000  # unitigs.MAX_EDGE_COV

# the kinds of candidate row a case is made of (``wave_case``)
ROW_KINDS = ("bubble", "shared", "ties", "clash", "palindrome", "no_meet",
             "masked", "deep", "zero_length")
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
    "mixed": ROW_KINDS,
    "random": (),
}
CHAIN_CASES = ["ties", "clash", "palindrome", "not_found", "mixed",
               "random"]
CLAIM_CASES = ["equal_rank", "shared_edge", "cover_fallback",
               "created_loop", "cvg_cap", "padded_rows", "mixed", "random"]


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
        # (3, 2) both cost 5, and the smaller i must win
        x, y = g.node(), g.node()
        g.prev[x], g.prev[y] = y, x
        a1 = g.node(prev=x)
        t = g.node(prev=a1)
        b1 = g.node(prev=y)
        u = g.node(prev=b1)
        for f, to in ((x, a1), (a1, t), (y, b1), (b1, u), (u, t)):
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
    """A dict of numpy arrays: the inputs of ``chains`` (prev, u, t0,
    cmask, twin) on a synthetic graph of C candidate rows made of the
    row kinds of ``CASES[name]``, and the graph's length, cvg, deleted
    and arc rows (from_ed, to_ed, mult) for ``claim_apply``.  ``random``
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
    return {"prev": np.array(g.prev, np.int64), "u": np.asarray(u, np.int64),
            "t0": np.asarray(t0, np.int64), "cmask": np.asarray(cmask, bool),
            "twin": np.array(g.twin, np.int64),
            "length": np.array(g.length, np.int64), "cvg": cvg,
            "deleted": rng.random(e) < 0.05,
            "from_ed": from_ed.astype(np.int64),
            "to_ed": to_ed.astype(np.int64), "mult": mult.astype(np.int64)}


def chains_inputs(case, dev):
    """(prev, u, t0, cmask, twin) of a ``wave_case`` on ``dev``."""
    return tuple(torch.from_numpy(case[k]).to(dev)
                 for k in ("prev", "u", "t0", "cmask", "twin"))


def claim_inputs(case, m: int, seed: int, dev):
    """The 15 inputs of ``claim_apply`` on ``dev``: ``chains_plain``'s
    outputs on the case's graph, ok = found on ~90% of the found rows,
    len_a and len_b the paths' summed lengths (as the identity check
    gives them), and the graph's arrays."""
    rng = np.random.default_rng(seed)
    maj, mnr, tw_maj, tw_mnr, _s, ends, found, _n = wave.chains_plain(
        *chains_inputs(case, "cpu"), m)
    ok = found & torch.from_numpy(rng.random(found.shape[0]) < 0.9)
    length = torch.from_numpy(case["length"])
    sums = [wave._gather2(length, x, 0).sum(1) for x in (maj, mnr)]
    xs = (maj, mnr, tw_maj, tw_mnr, ends, ok, *sums,
          *(torch.from_numpy(case[k]) for k in (
              "cvg", "length", "twin", "deleted", "from_ed", "to_ed",
              "mult")))
    return tuple(x.contiguous().to(dev) for x in xs)


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


@pytest.mark.gpu
@pytest.mark.parametrize("i", range(len(GPU_CASES)))
def test_chains_kernel_matches_plain(i):
    dev = _card()
    name, c, m = GPU_CASES[i]
    xs = chains_inputs(wave_case(name, c, m, 300 + i), dev)
    before = wave.CHAINS_LAUNCHES
    got = wave.chains(*xs, m)
    want = wave.chains_plain(*xs, m)
    torch.cuda.synchronize()
    assert wave.CHAINS_LAUNCHES == before + 1
    assert max_abs_err(got, want) == 0, (name, c, m)


@pytest.mark.gpu
@pytest.mark.parametrize("i", range(len(GPU_CASES)))
def test_claim_apply_kernel_matches_plain(i):
    dev = _card()
    name, c, m = GPU_CASES[i]
    xs = claim_inputs(wave_case(name, c, m, 400 + i), m, i, dev)
    before = wave.CLAIM_APPLY_LAUNCHES
    got = wave.claim_apply(*xs)
    want = wave.claim_apply_plain(*xs)
    torch.cuda.synchronize()
    assert wave.CLAIM_APPLY_LAUNCHES == before + 1
    assert max_abs_err(got, want) == 0, (name, c, m)
    # the scratch is empty again
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
    eagerly on copies of the same state, all outputs and ``failed``; the
    kernels execute once a wave."""
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
        before = (wave.CHAINS_LAUNCHES, wave.CLAIM_APPLY_LAUNCHES)
        counts = prog.launch()
        # one execution of each kernel a wave, eager or replayed
        assert (wave.CHAINS_LAUNCHES, wave.CLAIM_APPLY_LAUNCHES) == \
            (before[0] + 1, before[1] + 1)
        want = tourbus._wave_step(*state, *prog.args)
        torch.cuda.synchronize()
        if prog.graph is not None:
            replays += 1
            assert max_abs_err(prog.outs, want) == 0
            assert torch.equal(prog.failed, state[2])
        n, over = counts.tolist()[:2]
        if n:
            productive += 1
            prog.apply()
        elif not over:
            break
    assert replays >= 1 and productive >= 1
