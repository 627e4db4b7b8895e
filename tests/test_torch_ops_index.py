"""The port's shared index helpers (``ops/index.py``) on small tensors,
and the layering they make possible: no module of ``kernels/`` imports
from the graph passes, the stages, the readers and writers, the mesh
path or the CLI."""

import ast
import pathlib

import pytest
import torch

from soapdenovo_trans_tpu_torch.ops import index

X = torch.tensor([10, 11, 12, 13])
N = X.shape[0]


def _gather_at_minus_one():
    return index.gather_or(X, torch.tensor([-1, 0, -1]), -7), [-7, 10, -7]


def _gather_at_n():
    return index.gather_or(X, torch.tensor([N, 3, N + 5]), -7), [-7, 13, -7]


def _gather_in_range():
    return index.gather_or(X, torch.tensor([3, 1, 0, 2, 1]), -7), \
        [13, 11, 10, 12, 11]


def _gather_empty():
    got = index.gather_or(X, torch.zeros(0, dtype=torch.int64), -7)
    assert got.dtype == X.dtype
    return got, []


def _gather2_table():
    nodes = torch.tensor([[0, -1, 3], [N, 2, -1]])
    got = index.gather2(X, nodes, 0)
    assert got.shape == nodes.shape
    return got.flatten(), [10, 0, 13, 0, 12, 0]


def _scatter_true_drops_n():
    return index.scatter_true(N, torch.tensor([2, N, 0, 2, N])), \
        [True, False, True, False]


def _scatter_drops_n():
    got = index.scatter(N, torch.tensor([N, 1, 3, N]),
                        torch.tensor([5, 6, 7, 8]), -1)
    return got, [-1, 6, -1, 7]


def _segment_sum_drop_slot():
    got = index.segment_sum(torch.tensor([1, 2, 4, 8, 16]),
                            torch.tensor([0, N, 2, 0, N]), N)
    return got, [9, 0, 4, 0]


CASES = {f.__name__[1:]: f for f in (
    _gather_at_minus_one, _gather_at_n, _gather_in_range, _gather_empty,
    _gather2_table, _scatter_true_drops_n, _scatter_drops_n,
    _segment_sum_drop_slot)}


@pytest.mark.parametrize("name", CASES)
def test_index_helper(name):
    got, want = CASES[name]()
    assert got.tolist() == want


PKG = pathlib.Path(__file__).resolve().parent.parent / \
    "soapdenovo_trans_tpu_torch"
ABOVE_KERNELS = ("graph", "stages", "io", "parallel", "cli")


def _imported(tree):
    """The package modules a module imports, as dotted names relative to
    the package (``from ..graph import arcs`` gives graph.arcs)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level == 0 and base.startswith(PKG.name):
                base = base[len(PKG.name):].lstrip(".")
            elif node.level < 2:  # the kernels package itself, or absolute
                continue
            for alias in node.names:
                yield f"{base}.{alias.name}".lstrip(".")
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.startswith(PKG.name + "."):
                    yield alias.name[len(PKG.name) + 1:]


def test_kernels_import_nothing_above_ops():
    modules = sorted((PKG / "kernels").glob("*.py"))
    assert len(modules) >= 4
    bad = [(m.name, name) for m in modules
           for name in _imported(ast.parse(m.read_text()))
           if name.split(".")[0] in ABOVE_KERNELS]
    assert not bad
