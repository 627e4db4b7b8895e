"""Port parity of the scaff stage's legacy dict pipeline (stages/scaff.py:
``delete_weak``, ``get_loci``, ``_oriented_locus``, then ``linearize``,
``delete_inconsistent``, ``avoid_loops``, ``delete_unlikely``,
``build_transcripts`` and ``transcript_sequences``) against the JAX
package on the same numpy connection graphs: the twin of the legacy half
of tests/test_scaff.py's ``build_structure`` check.  Exact comparison."""

import numpy as np
import pytest

from soapdenovo_trans_tpu.stages import scaff as jscaff
from soapdenovo_trans_tpu_torch.stages import scaff as tscaff
from tests.test_torch_scaff import K, _key, handmade_graph, random_graph

GRAPHS = {"handmade": handmade_graph,
          "random-77": lambda: random_graph(77, 400, 300, 0.0),
          "random-5": lambda: random_graph(5, 200, 400, 0.3),
          "random-3": lambda: random_graph(3, 1000, 500, 0.2)}


def legacy(mod, conn, twin, full_len, unique, cvg, max_cnt):
    """tests/test_scaff.py's global-dict pipeline on one module; returns
    the loci before and after the locus passes, each locus's oriented
    membership, the transcripts and their records."""
    params = mod.ScaffParams(max_cnt=max_cnt)
    n_ctg = twin.shape[0]
    g = mod.ConnGraph(conn, twin, full_len, unique)
    mod.delete_weak(g, params.weak_cnt)
    first = mod.get_loci(g, n_ctg)
    oriented = [mod._oriented_locus(g, locus, twin) for locus in first]
    for locus in first:
        mod.linearize(g, locus, params, K)
        mod.delete_inconsistent(g, locus)
        mod.avoid_loops(g, locus)
        mod.linearize(g, locus, params, K)
    mod.delete_unlikely(g, n_ctg, params.max_cnt)
    loci = mod.get_loci(g, n_ctg)
    transcripts = mod.build_transcripts([(g, locus) for locus in loci], cvg,
                                        params)
    rng = np.random.default_rng(n_ctg)
    seqs = ["".join(rng.choice(list("ACGT"), size=int(n))) for n in full_len]
    used = np.zeros(n_ctg, bool)
    recs = mod.transcript_sequences(transcripts, seqs, used)
    return first, oriented, loci, transcripts, recs, used


@pytest.mark.parametrize("graph,max_cnt", [
    ("handmade", 0), ("random-77", 2), ("random-77", 0), ("random-5", 3),
    ("random-3", 2)])
def test_dict_pipeline_matches_jax(graph, max_cnt):
    args = GRAPHS[graph]()
    conn, twin, full_len, unique, cvg = args
    want = legacy(jscaff, conn, twin, full_len, unique, cvg, max_cnt)
    got = legacy(tscaff, conn, twin, full_len, unique, cvg, max_cnt)
    first, oriented, loci, transcripts, recs, used = got
    assert first == want[0] and loci == want[2] and len(loci) > 0
    assert oriented == want[1]
    # a locus of get_loci is its own oriented membership
    assert [sorted(o) for o in oriented] == [sorted(c) for c in first]
    assert _key(transcripts) == _key(want[3])
    assert recs == want[4] and len(recs) == len(transcripts) > 0
    np.testing.assert_array_equal(used, want[5])
    assert used.any()
    # and the vectorized structure builds the same transcripts
    fast = tscaff.build_structure(conn, twin, full_len, unique, cvg,
                                  tscaff.ScaffParams(max_cnt=max_cnt), K)
    assert sorted(_key(fast)) == sorted(_key(transcripts))
