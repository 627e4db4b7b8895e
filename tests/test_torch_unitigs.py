"""Port parity of ``graph/unitigs.edge_sequences``: the port's decode of
every edge equals the JAX package's, string for string, on the same
condensed graph carried across with ``convert``, at K = 23 and 31.  The
reads come from both strands, so edges start on odd-strand nodes too."""

import numpy as np
import pytest
import torch

from soapdenovo_trans_tpu.graph import dbg as jdbg
from soapdenovo_trans_tpu.graph import kmer_clean as jclean
from soapdenovo_trans_tpu.graph import unitigs as junitigs
from soapdenovo_trans_tpu_torch import convert
from soapdenovo_trans_tpu_torch.graph import unitigs as tunitigs
from tests.test_torch_graph import _reads, _table


@pytest.mark.parametrize("k", [23, 31])
def test_edge_sequences_match_jax(k):
    torch.set_num_threads(1)
    jt = jclean.clip_tip_kmers(_table(*_reads(k), k), k)
    je = junitigs.condense(jdbg.build_dbg(jt, k), jt, k)
    want = junitigs.edge_sequences(je, jt, k)
    te = convert.to_torch(je, "cpu")
    got = tunitigs.edge_sequences(te, convert.to_torch(jt, "cpu"), k)
    assert got == want
    n = te.n_edges
    odd = te.from_node[:n] % 2 == 1
    assert odd.any() and (~odd).any()
    lengths = te.length[:n].tolist()
    assert [len(s) for s in got] == [k + ln for ln in lengths]
    assert len(got) == n > 0 and not "".join(got).strip("ACGT")
    # a twin reads as the reverse complement
    rc = str.maketrans("ACGT", "TGCA")
    twin = np.asarray(te.twin[:n])
    assert all(got[int(twin[e])] == got[e].translate(rc)[::-1]
               for e in range(n))
