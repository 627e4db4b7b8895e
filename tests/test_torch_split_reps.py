"""Repeat splitting of the PyTorch port against the JAX package's
``graph/split_reps``: the three cases of ``tests/test_split_reps.py``
(a solvable repeat, crossing reads, unpaired evidence) through both
``solve_reps`` on the same graph and triples — edges and arcs equal after
``convert`` (the JAX package pads its arrays, the port keeps exact
sizes, so live prefixes are compared) — and ``path_triples`` /
``_mirror`` and the port's ``leading_paths`` against the JAX package's
per-read loops.  Integer results: tolerance 0."""

import numpy as np
import pytest
import torch

from soapdenovo_trans_tpu.graph import contig_merge as jcm
from soapdenovo_trans_tpu.graph import split_reps as jsr
from soapdenovo_trans_tpu.io import stagefiles as jsf
from soapdenovo_trans_tpu_torch import convert
from soapdenovo_trans_tpu_torch.graph import arcs as tarcs
from soapdenovo_trans_tpu_torch.graph import contig_merge as tcm
from soapdenovo_trans_tpu_torch.graph import split_reps as tsr
from soapdenovo_trans_tpu_torch.io import stagefiles as tsf

from .test_arcs import K, build_all, pad_batch
from .test_split_reps import _read_paths, _repeat_fixture, _triples

EDGE_FIELDS = ("from_node", "to_node", "length", "cvg", "twin", "seq_off",
               "deleted")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cases():
    t1, t2 = _repeat_fixture()
    cross = t1[:100] + t2[100:]  # A M D chimera
    return {"solvable": ([t1, t1, t2, t2], [t1, t2], 1),
            "crossing_reads": ([t1, t1, t2, t2, cross], [t1, t2, cross], 0),
            "unpaired_evidence": ([t1, t1, t2, t2], [t1], 0)}


CASES = _cases()


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_reps_matches_jax(case):
    reads, path_reads, want_split = CASES[case]
    table, eg, patch, aset = build_all(reads)
    tri = _triples(_read_paths(path_reads, table, eg, patch))
    j_eg, j_aset, j_split = jsr.solve_reps(eg, aset, tri)

    t_eg, t_aset, t_split = tsr.solve_reps(
        convert.to_torch(eg, "cpu"), convert.to_torch(aset, "cpu"), tri)
    assert t_split == j_split == want_split

    n_e = int(j_eg.n_edges)
    assert t_eg.n_edges == n_e
    got = convert.to_numpy(t_eg)
    for field in EDGE_FIELDS:
        np.testing.assert_array_equal(
            _np(getattr(got, field))[:n_e], _np(getattr(j_eg, field))[:n_e],
            err_msg=field)
    pool = int((_np(j_eg.seq_off) + _np(j_eg.length))[:n_e].max())
    np.testing.assert_array_equal(got.seq_pool[:pool],
                                  np.asarray(j_eg.seq_pool)[:pool])
    n_a = int(j_aset.n)
    assert t_aset.n == n_a
    for field in ("from_ed", "to_ed", "mult"):
        np.testing.assert_array_equal(
            getattr(t_aset, field).numpy()[:n_a],
            _np(getattr(j_aset, field))[:n_a],
            err_msg=field)
    if want_split:
        # exact sizes: no padding row follows the appended copies
        assert t_eg.twin.shape[0] == n_e == int(eg.n_edges) + 2
        assert t_aset.from_ed.shape[0] == n_a
        # and both full transcripts concatenate straight through, in
        # both packages' concatenation
        j_seqs = jcm.contig_sequences(jcm.concatenate(j_eg, j_aset), table, K)
        t_seqs = tcm.contig_sequences(
            tcm.concatenate(t_eg, t_aset), convert.to_torch(table, "cpu"), K)
        assert sorted(t_seqs) == sorted(j_seqs)
        assert all(t in t_seqs for t in path_reads)
    else:  # nothing to split: the graph comes back as it went in
        assert t_eg.twin.shape == eg.twin.shape


def test_path_triples_and_mirror_match_jax():
    rng = np.random.default_rng(3)
    file_to_row = np.concatenate([[-1], rng.permutation(40)])
    file_to_row[7] = -1  # an id without a row
    paths = [rng.integers(1, 41, n) for n in (2, 3, 5, 9, 3, 30)]
    want = jsr.path_triples(paths, file_to_row)
    got = tsr.path_triples(paths, file_to_row)
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] > 0
    twin = np.arange(40) ^ 1
    np.testing.assert_array_equal(tsr._mirror(got, twin),
                                  jsr._mirror(want, twin))
    assert tsr.path_triples([], file_to_row).shape == (0, 3)


def _jax_recorder_bytes(tmp_path, slots, arc_ok, file_id, n_file):
    rec = jsf.PathRecorder(str(tmp_path / "jax.path"), file_id, n_file)
    rec.add_batch(slots, arc_ok)
    return rec.close(), rec.n_reads, (tmp_path / "jax.path").read_bytes()


@pytest.mark.parametrize("seed", [0, 1])
def test_leading_paths_and_recorder_match_jax(seed, tmp_path):
    """Random path slots (one read longer than the 255 ids a record
    holds): ``leading_paths`` + ``PathRecorder.add_paths`` write the
    bytes of the JAX package's per-read ``add_batch``."""
    rng = np.random.default_rng(seed)
    r, p2, n_edges = 50, 600, 30
    slots = np.where(rng.random((r, p2)) < 0.2,
                     rng.integers(0, n_edges, (r, p2)), -1)
    arc_ok = rng.random((r, p2)) < 0.97
    slots[3] = rng.integers(0, 2, p2)  # 600 unbroken entries on two edges
    arc_ok[3] = True
    slots[4] = -1                            # a padded row
    file_id = rng.permutation(n_edges) + 1
    want_marks, want_reads, want_bytes = _jax_recorder_bytes(
        tmp_path, slots, arc_ok, file_id, n_edges + 1)

    n_run, path = tarcs.leading_paths(
        torch.from_numpy(slots.reshape(-1)),
        torch.from_numpy(arc_ok.reshape(-1)), r, tsf.PathRecorder.MIN_PATH)
    rec = tsf.PathRecorder(str(tmp_path / "port.path"), file_id, n_edges + 1)
    half = int(n_run.shape[0]) // 2  # two batches
    cut = int(n_run[:half].sum())
    rec.add_paths(n_run[:half].numpy(), path[:cut].numpy())
    rec.add_paths(n_run[half:].numpy(), path[cut:].numpy())
    marks = rec.close()
    assert rec.n_reads == want_reads > 10 and int(n_run.max()) == p2
    np.testing.assert_array_equal(marks, want_marks)
    assert marks.max() == 255  # saturated
    assert (tmp_path / "port.path").read_bytes() == want_bytes
    got = tsf.read_path_bin(str(tmp_path / "port.path"))
    want = jsf.read_path_bin(str(tmp_path / "jax.path"))
    assert len(got) == want_reads and max(map(len, got)) == 255
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    for mod, name in ((jsf, "jax.marks"), (tsf, "port.marks")):
        mod.write_mark_on_edge(str(tmp_path / name), marks, n_edges + 3)
    assert (tmp_path / "port.marks").read_bytes() == \
        (tmp_path / "jax.marks").read_bytes()


def test_recorder_takes_an_empty_batch(tmp_path):
    rec = tsf.PathRecorder(str(tmp_path / "e.path"), np.arange(1, 5), 5)
    rec.add_paths(np.zeros(0, np.int64), np.zeros(0, np.int64))
    assert rec.close().sum() == 0 and rec.n_reads == 0
    assert (tmp_path / "e.path").read_bytes() == b""


def test_leading_paths_on_threaded_reads_match_jax_loop():
    """The repeat fixture's reads threaded by the JAX package: its test
    suite's per-read loop and the port's ``leading_paths`` agree."""
    from soapdenovo_trans_tpu.graph import arcs as jarcs

    t1, t2 = _repeat_fixture()
    table, eg, patch, _aset = build_all([t1, t1, t2, t2])
    want = [p for p in _read_paths([t1, t2], table, eg, patch)
            if p.shape[0] >= 3]
    padded, lens = pad_batch([t1, t2])
    _f, t, v = jarcs.thread_reads(padded, lens, table, eg, patch, K)
    n_run, path = tarcs.leading_paths(
        torch.from_numpy(_np(t)), torch.from_numpy(np.array(v)), 2, 3)
    assert n_run.tolist() == [p.shape[0] for p in want]
    np.testing.assert_array_equal(path.numpy(), np.concatenate(want))
