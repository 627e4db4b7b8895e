"""Port parity of the pregraph graph passes: dbg.build_dbg, kmer_clean,
unitigs.condense, arcs.build_patch / thread_reads / count_arcs /
count_arcs_many / ArcForest.  One JAX k-mer table is fed to both packages (through
soapdenovo_trans_tpu_torch.convert); each pass's JAX output is fed on
to the next port pass, so every comparison sees identical inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from soapdenovo_trans_tpu.graph import arcs as jarcs
from soapdenovo_trans_tpu.graph import dbg as jdbg
from soapdenovo_trans_tpu.graph import kmer_clean as jclean
from soapdenovo_trans_tpu.graph import unitigs as junitigs
from soapdenovo_trans_tpu.ops import dictionary as jd
from soapdenovo_trans_tpu_torch import convert
from soapdenovo_trans_tpu_torch.graph import arcs as tarcs
from soapdenovo_trans_tpu_torch.graph import dbg as tdbg
from soapdenovo_trans_tpu_torch.graph import kmer_clean as tclean
from soapdenovo_trans_tpu_torch.graph import unitigs as tunitigs


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _reads(seed, n_tx=6, tx_len=300, r=900, l=60, err=0.004):
    """Reads from both strands of a few transcripts (+ SNP isoforms),
    with sequencing errors: tips, bubbles and length-1 edges."""
    rng = np.random.default_rng(seed)
    txs = rng.integers(0, 4, size=(n_tx, tx_len)).astype(np.uint8)
    iso = txs[:2].copy()
    iso[:, tx_len // 2] ^= 1
    pool = np.concatenate([txs, iso])
    s = rng.integers(0, tx_len - l + 1, r)
    codes = pool[rng.integers(0, len(pool), r)[:, None],
                 s[:, None] + np.arange(l)]
    rc = rng.random(r) < 0.5
    codes[rc] = (codes[rc] ^ 2)[:, ::-1]
    hit = rng.random(codes.shape) < err
    codes[hit] = (codes[hit] + rng.integers(1, 4, hit.sum())) % 4
    codes[5, 10] = 4  # an N
    lengths = np.full(r, l, np.int32)
    lengths[-3:] = 0  # padding rows
    return codes.astype(np.uint8), lengths


def _table(codes, lengths, k):
    return jd.finalize_run(jd.sorted_run_from_reads(
        jnp.asarray(codes), jnp.asarray(lengths), k), k)


def _eq(want, got, n=None, msg=""):
    want = np.asarray(want).astype(np.int64)
    got = got.cpu().numpy().astype(np.int64)
    if n is not None:
        want, got = want[:n], got[:n]
    np.testing.assert_array_equal(want, got, err_msg=msg)


@pytest.fixture(params=[23, 31], scope="module")
def case(request):
    k = request.param
    codes, lengths = _reads(k)
    return k, codes, lengths, _table(codes, lengths, k)


def test_build_dbg_matches_jax(case):
    k, _codes, _lengths, jt = case
    want = jdbg.build_dbg(jt, k)
    got = tdbg.build_dbg(convert.to_torch(jt, "cpu"), k)
    for field in want._fields:
        _eq(getattr(want, field), getattr(got, field), msg=field)


def test_kmer_cleaning_matches_jax(case):
    k, _codes, _lengths, jt = case
    steps = [(jclean.minor_out, tclean.minor_out),
             (jclean.single_tips, tclean.single_tips),
             (jclean.minor_tips, tclean.minor_tips)]
    for jfn, tfn in steps:
        want = jfn(jt, k)
        got = tfn(convert.to_torch(jt, "cpu"), k)
        _eq(want.deleted, got.deleted, msg=jfn.__name__)
        jt = want
    assert int(np.asarray(jt.deleted).sum()) > 0  # the fixture has tips


def test_condense_patch_thread_match_jax(case):
    k, codes, lengths, jt = case
    jt = jclean.clip_tip_kmers(jt, k)
    tt = convert.to_torch(jt, "cpu")
    jg = jdbg.build_dbg(jt, k)
    je = junitigs.condense(jg, jt, k)
    te = tunitigs.condense(convert.to_torch(jg, "cpu"), tt)
    n_e = int(je.n_edges)
    assert te.n_edges == n_e > 0
    for field in ("from_node", "to_node", "length", "cvg", "twin",
                  "seq_off"):
        _eq(getattr(je, field), getattr(te, field), n_e, field)
    n_arcs = int(np.asarray(jg.exists).sum())
    _eq(je.seq_pool, te.seq_pool, n_arcs, "seq_pool")
    _eq(je.node_edge, te.node_edge, msg="node_edge")
    _eq(je.node_pos, te.node_pos, msg="node_pos")

    jp = jarcs.build_patch(je, jt, k)
    te = convert.to_torch(je, "cpu")
    tp = tarcs.build_patch(te, tt, k)
    assert tp.n == int(jp.n)
    assert tp.n > 0 or k == 31  # the K=23 fixture has length-1 edges
    _eq(jp.keys, tp.keys, tp.n, "patch keys")
    _eq(jp.edge, tp.edge, tp.n, "patch edge")

    tp = convert.to_torch(jp, "cpu")
    forest = tarcs.ArcForest(te.twin)
    jforest = jarcs.ArcForest(je.twin)
    jcands, tcands = [], []
    for lo in range(0, codes.shape[0], 300):  # three batches
        c, ln = codes[lo:lo + 300], lengths[lo:lo + 300]
        jf, jto, jv = jarcs.thread_reads(jnp.asarray(c), jnp.asarray(ln),
                                         jt, je, jp, k)
        tf, tto, tv = tarcs.thread_reads(torch.from_numpy(c),
                                         torch.from_numpy(ln), tt, te, tp, k)
        _eq(jv, tv, msg="arc valid")
        _eq(jto, tto, msg="to_ed")
        valid = np.asarray(jv)
        np.testing.assert_array_equal(np.asarray(jf)[valid],
                                      tf.numpy()[valid])
        jset = jarcs.count_arcs(jf, jto, jv, je.twin)
        tset = tarcs.count_arcs(tf, tto, tv, te.twin)
        assert tset.n == int(jset.n)
        for field in ("from_ed", "to_ed", "mult"):
            _eq(getattr(jset, field), getattr(tset, field), tset.n, field)
        jforest.insert(jset)
        forest.insert(tset)
        jcands.append((jf, jto, jv))
        tcands.append((tf, tto, tv))
    jall, tall = jforest.finish(), forest.finish()
    assert tall.n == int(jall.n) > 0
    for field in ("from_ed", "to_ed", "mult"):
        _eq(getattr(jall, field), getattr(tall, field), tall.n, field)
    # all batches counted at once give the same arcs as the forest
    jmany = jarcs.count_arcs_many(jcands, je.twin)
    tmany = tarcs.count_arcs_many(tcands, te.twin)
    assert tmany.n == int(jmany.n) == tall.n
    for field in ("from_ed", "to_ed", "mult"):
        _eq(getattr(jmany, field), getattr(tmany, field), tmany.n, field)
