"""The generator: deterministic from the seed, and the frozen copy of
``perf_e2e.synth`` draws that function's reads."""

import os

import numpy as np

from port_bench import synth


def _reads(seed, **kw):
    args = dict(n_tx=20, pairs=300, read_len=100, insert=300)
    args.update(kw)
    return synth.make_reads(seed, **args)


def test_same_seed_same_reads_and_large_seeds_work():
    for seed in (0, 2**31 + 11, 2**40 + 3):
        a, b = _reads(seed), _reads(seed)
        assert np.array_equal(a.r1, b.r1) and np.array_equal(a.r2, b.r2)
        assert np.array_equal(a.pool, b.pool)
    assert not np.array_equal(_reads(1).r1, _reads(2).r1)


def test_skewed_law_is_deterministic_with_one_set_of_depths():
    a = _reads(5, pairs=4000, expression="lognormal", sigma=2.0)
    b = _reads(5, pairs=4000, expression="lognormal", sigma=2.0)
    assert np.array_equal(a.r1, b.r1)
    w5 = synth.expression_weights(np.random.default_rng(5), 30,
                                  "lognormal", 2.0)
    w6 = synth.expression_weights(np.random.default_rng(6), 30,
                                  "lognormal", 2.0)
    assert np.array_equal(np.sort(w5), np.sort(w6))
    assert not np.array_equal(w5, w6)
    assert w5.max() / w5.min() > 100  # sigma 2 spans orders of magnitude


def test_matches_perf_e2e_synth(tmp_path):
    import perf_e2e

    cfg = perf_e2e.synth(str(tmp_path), 20, 300, seed=3)
    mine = synth.make_reads(3, 20, 300, perf_e2e.READ_LEN, perf_e2e.INS)
    code = {c: i for i, c in enumerate("ACGT")}
    for name, reads in (("reads_1.fa", mine.r1), ("reads_2.fa", mine.r2)):
        with open(os.path.join(tmp_path, name)) as fh:
            seqs = fh.read().split("\n")[1::2]
        got = np.array([[code[c] for c in s] for s in seqs if s])
        assert np.array_equal(got, reads)
    assert os.path.exists(cfg)


def test_fasta_writer(tmp_path):
    r = _reads(4, pairs=12)
    path = os.path.join(tmp_path, "x.fa")
    synth.write_fasta(path, r.r1)
    with open(path) as fh:
        lines = fh.read().split("\n")
    assert lines[0] == ">r000000000" and lines[22] == ">r000000011"
    assert lines[1] == "".join("ACGT"[b] for b in r.r1[0])


def test_interleaved_is_mate_one_then_mate_two():
    r = _reads(6, pairs=5)
    il = r.interleaved()
    assert np.array_equal(il[0::2], r.r1) and np.array_equal(il[1::2], r.r2)
