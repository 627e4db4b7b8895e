"""The CUDA kernel of the Tour-Bus identity check (``identity_launch`` of
csrc/lcs.cu) against its plain PyTorch version, on the card.  Imports
no JAX, so it runs where only torch is installed:

    python -m pytest --noconftest tests/test_torch_lcs_gpu.py -m gpu

The case generators here are shared with tests/test_torch_lcs.py and
tests/test_torch_identity.py (the CPU tests) and chip_smoke.py, which
loads this file by path.
"""

import numpy as np
import pytest
import torch

from soapdenovo_trans_tpu_torch.kernels import lcs

WAVE_P, WAVE_CAP = 1024, 384  # CAND_CAP x SEQ_CAP of the Tour-Bus wave
DIFF = 10                     # the largest length difference a wave compares


def wave_pairs(rng, p: int = WAVE_P, cap: int = WAVE_CAP, alphabet: int = 4):
    """(a, b, la, lb) numpy arrays shaped like a wave's: bases from
    ``alphabet``, half the pairs similar (10-15% substitutions, an indel
    made by shifting the tail), half unrelated; la in 0..cap and
    |la - lb| <= DIFF."""
    a = rng.integers(0, alphabet, (p, cap)).astype(np.uint8)
    b = a.copy()
    hit = rng.random((p, cap)) < rng.uniform(0.10, 0.15, (p, 1))
    b[hit] = rng.integers(0, alphabet, int(hit.sum()))
    for r in range(p):
        at, shift = rng.integers(0, cap), rng.integers(-3, 4)
        b[r, at:] = np.roll(b[r, at:], shift)
    unrelated = rng.random(p) < 0.5
    b[unrelated] = rng.integers(0, alphabet, (int(unrelated.sum()), cap))
    la = rng.integers(0, cap + 1, p)
    lb = np.clip(la + rng.integers(-DIFF, DIFF + 1, p), 0, cap)
    return a, b, la, lb


def edge_case(name: str, rng, p: int = 64, cap: int = 64):
    """(a, b, la, lb, cap) of one named edge case."""
    alphabet = 250 if name == "bytes_0_249" else 4
    a, b, la, lb = wave_pairs(rng, p, cap, alphabet)
    if name in ("la_0", "both_0"):
        la[:] = 0
    if name in ("lb_0", "both_0"):
        lb[:] = 0
    if name == "full":
        la[:] = lb[:] = cap
    if name == "over_cap":  # clamped to cap
        la = cap + rng.integers(1, 50, p)
        lb = cap + rng.integers(0, 50, p)
    if name == "identical":
        b, lb = a.copy(), la.copy()
    return a, b, la, lb, cap


EDGE_CASES = ["la_0", "lb_0", "both_0", "full", "over_cap", "identical",
              "bytes_0_249"]

def to_device(a, b, la, lb, dev):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in (a, b, la.astype(np.int64), lb.astype(np.int64)))


class _Edges:
    """The edges of a synthetic EdgeGraph, each a base sequence; laid out
    in its pool in a shuffled order."""

    def __init__(self, rng, alphabet: int):
        self.rng, self.alphabet, self.seqs = rng, alphabet, []

    def add(self, seq) -> int:
        self.seqs.append(np.asarray(seq, np.uint8))
        return len(self.seqs) - 1

    def random(self, n: int) -> int:
        return self.add(self.rng.integers(0, self.alphabet, n))

    def variant(self, e: int, n=None, sub: float = 0.06) -> int:
        """A copy of edge e with substitutions, cut or padded to n bases
        (random bases past e's end)."""
        seq = self.seqs[e].copy()
        hit = self.rng.random(seq.shape[0]) < sub
        seq[hit] = self.rng.integers(0, self.alphabet, int(hit.sum()))
        if n is not None:
            seq = np.concatenate([seq, self.rng.integers(
                0, self.alphabet, max(n - seq.shape[0], 0))])[:n]
        return self.add(seq)

    def arrays(self, clamp=()):
        """(length, seq_off, seq_pool); the edges of ``clamp`` start a few
        bases before the pool's end, so their reads are clamped."""
        length = np.array([s.shape[0] for s in self.seqs], np.int64)
        seq_off = np.zeros(len(self.seqs), np.int64)
        order = self.rng.permutation(len(self.seqs))
        seq_off[order] = np.cumsum(length[order]) - length[order]
        pool = np.concatenate([self.seqs[e] for e in order]
                              + [np.zeros(1, np.uint8)])
        for e in clamp:
            seq_off[e] = pool.shape[0] - int(self.rng.integers(1, 8))
        return length, seq_off, pool


def _place(rng, nodes, m: int):
    """A row of m slots holding ``nodes`` in order, -1 between them."""
    row = np.full(m, -1, np.int64)
    row[np.sort(rng.choice(m, len(nodes), replace=False))] = nodes
    return row


def identity_case(name: str, c: int, m: int, seq_cap: int, diff: int,
                  seed: int):
    """(maj, mnr, found, length, seq_off, seq_pool) numpy arrays of one
    identity-check call: C candidate rows of m node slots over a
    synthetic EdgeGraph.

    ``mixed`` (and ``bytes``, the same over bytes 0-249): edges of 0-60
    bases and a variant of each (6% substitutions); rows of 1-m nodes
    with -1 slots between them and the variants on the other side
    (similar), other edges (unrelated), |len_a - len_b| made exactly
    diff or diff + 1 (gate), paths made seq_cap - 5 .. seq_cap + 20
    long (long), all -1 (empty); a few edges read past the pool's end
    (clamped); found false on ~15% of the rows.  ``wave``: a real
    wave's shape, 12 rows found, SNP paths of K + 1 = 24 bases (two with
    lengths over diff apart), the rest -1.  ``full``: every row found,
    both paths seq_cap bases in up to 3 nodes, 12% substitutions."""
    rng = np.random.default_rng(seed)
    g = _Edges(rng, 250 if name == "bytes" else 4)
    maj = np.full((c, m), -1, np.int64)
    mnr = np.full((c, m), -1, np.int64)
    clamp = []
    if name == "wave":
        found = np.zeros(c, bool)
        rows = rng.choice(c, 12, replace=False)
        for i, r in enumerate(rows):
            a = g.random(24)
            b = g.variant(a, 24 + (diff + 1 + i if i < 2 else 0), sub=0.04)
            maj[r, :1], mnr[r, :1] = a, b
        found[rows] = True
        for _ in range(c):  # the graph's other edges
            g.random(int(rng.integers(1, 60)))
    elif name == "full":
        found = np.ones(c, bool)
        for r in range(c):
            cuts = np.sort(rng.integers(0, seq_cap + 1, min(m, 3) - 1))
            sizes = np.diff(np.concatenate([[0], cuts, [seq_cap]]))
            a_nodes = [g.random(int(n)) for n in sizes]
            maj[r, :len(a_nodes)] = a_nodes
            mnr[r, :len(a_nodes)] = [g.variant(e, sub=0.12)
                                     for e in a_nodes]
    else:
        n_base = 256
        base = [g.random(0 if rng.random() < 0.1 else
                         int(rng.integers(1, 61))) for _ in range(n_base)]
        var = [g.variant(e) for e in base]
        clamp = [g.random(20) for _ in range(3)]
        found = rng.random(c) > 0.15
        for r in range(c):
            kind = rng.choice(["similar", "unrelated", "gate", "long",
                               "empty"], p=[0.45, 0.15, 0.2, 0.12, 0.08])
            pick = rng.integers(0, n_base, int(rng.integers(1, m + 1)))
            a_nodes = [base[i] for i in pick]
            b_nodes = [var[i] for i in pick]
            if rng.random() < 0.1:
                a_nodes[-1] = b_nodes[-1] = clamp[int(rng.integers(3))]
            lens = lambda nodes: sum(g.seqs[e].shape[0] for e in nodes)
            if kind == "unrelated":
                b_nodes = [int(rng.integers(0, 2 * n_base)) for _ in
                           range(int(rng.integers(1, m + 1)))]
            elif kind in ("gate", "long"):
                s = int(rng.integers(len(a_nodes)))
                if kind == "long":  # a is seq_cap - 5 .. seq_cap + 20
                    want = seq_cap + int(rng.choice([-5, 0, 1, 20]))
                    rest = lens(a_nodes) - g.seqs[a_nodes[s]].shape[0]
                    a_nodes[s] = g.variant(a_nodes[s], max(want - rest, 0))
                    b_nodes[s] = g.variant(a_nodes[s])
                gap = int(rng.choice([diff, diff + 1])) * \
                    int(rng.choice([-1, 1]))
                if kind == "long":
                    gap = int(rng.integers(-diff, diff + 1))
                rest = lens(b_nodes) - g.seqs[b_nodes[s]].shape[0]
                n = lens(a_nodes) - gap - rest
                if n >= 0:
                    b_nodes[s] = g.variant(a_nodes[s], n)
            elif kind == "empty":
                which = rng.integers(3)
                a_nodes = [] if which != 1 else a_nodes
                b_nodes = [] if which != 0 else b_nodes
            maj[r] = _place(rng, a_nodes, m)
            mnr[r] = _place(rng, b_nodes, m)
        if c > 1:  # always one row of -1 slots only
            maj[-1] = mnr[-1] = -1
    length, seq_off, seq_pool = g.arrays(clamp)
    return maj, mnr, found, length, seq_off, seq_pool


# (name, C, m, seq_cap, diff): the three -M levels' m and diff, the
# wave's 1,024 x 384, a real wave's shape, full paths, bytes that are not
# bases (the kernel's other mask path), one row and 4,096, and caps that
# are not multiples of 64
IDENTITY_CASES = [("mixed", 64, 3, 64, 2), ("mixed", 256, 9, 100, 3),
                  ("mixed", 256, 30, 200, 10), ("mixed", 1024, 3, 384, 2),
                  ("mixed", 1024, 9, 384, 3), ("mixed", 1024, 30, 384, 10),
                  ("bytes", 128, 9, 200, 3), ("wave", 1024, 3, 384, 2),
                  ("full", 1024, 3, 384, 2), ("mixed", 1, 3, 384, 2),
                  ("mixed", 4096, 9, 512, 3), ("full", 64, 9, 512, 3)]


def identity_to_device(arrays, dev):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in arrays)


@pytest.mark.gpu
@pytest.mark.parametrize("i", range(len(IDENTITY_CASES)))
def test_identity_kernel_matches_plain(i):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    name, c, m, seq_cap, diff = IDENTITY_CASES[i]
    xs = identity_to_device(identity_case(name, c, m, seq_cap, diff, 200 + i),
                            torch.device("cuda"))
    before = lcs.IDENTITY_LAUNCHES
    got = lcs.identity_check(*xs, diff, seq_cap)
    want = lcs.identity_check_plain(*xs, diff, seq_cap)
    torch.cuda.synchronize()
    assert lcs.IDENTITY_LAUNCHES == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), (name, c, m, seq_cap)
