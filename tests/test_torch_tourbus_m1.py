"""The port's ``all`` at the default merge level (-M 1) on the CPU, judged
by the benchmark's plain-PyTorch reference (``port_bench/reference.py``,
which imports no JAX), in three cases of ``port_bench/synth.py`` data at
seed 2, one for each ``-M 1`` cell of the benchmark: 1,000 pairs of 2x100
bp over 10 transcripts and their SNP isoforms at K = 23 (where the JAX
package's arc remap makes contigs with K-mers no read has and scaffold
pieces that are not their contigs' bases); 3,335 pairs of 2x150 bp, 350
bp inserts, over 50 transcripts at K = 31 (three-lane K-mer rows); and
the first case's reads under log-normal expression (sigma 2).  Every number
of the reference must be within its limit.  The same run, under the
profiler, records Tour-Bus's spans inside ``contig.tourbus``:
``contig.tourbus.launch`` and ``contig.tourbus.read`` once a wave,
``contig.tourbus.apply`` once a productive wave, and its counters."""

import json

import pytest
import torch

from port_bench import reference, synth
from soapdenovo_trans_tpu_torch import cli
from soapdenovo_trans_tpu_torch.graph import tourbus
from soapdenovo_trans_tpu_torch.utils import profiling

SEED = 2
# (K, transcripts, pairs, read length, insert, expression, sigma).  The
# K = 31 case has the cell's pairs a pool sequence (44) over 50
# transcripts: each SNP bubble that Tour-Bus folds takes K solid K-mers
# out of the contigs, and over 10 transcripts (5 bubbles, 667 pairs) the
# share of folded K-mers is a few bubbles' worth, 1.16% at this seed,
# where the cell's 1,250 bubbles read 0.57-0.63% on an H100.
CASES = {
    "k23_pe100_uniform": (23, 10, 1000, 100, 300, "uniform", 0.0),
    "k31_pe150_uniform": (31, 50, 3335, 150, 350, "uniform", 0.0),
    "k23_pe100_skewed": (23, 10, 1000, 100, 300, "lognormal", 2.0),
}
SPANS = ("contig.tourbus", "contig.tourbus.launch", "contig.tourbus.read",
         "contig.tourbus.apply")


@pytest.fixture(scope="module", params=list(CASES), ids=list(CASES))
def m1_run(request, tmp_path_factory):
    """(K, the reads, the output prefix, the result, the trace's
    intervals of each of ``SPANS``) of one ``all -M 1`` under the
    profiler."""
    k, transcripts, pairs, read_len, insert, expression, sigma = \
        CASES[request.param]
    folder = tmp_path_factory.mktemp("m1")
    reads = synth.make_reads(SEED, transcripts, pairs, read_len, insert,
                             expression=expression, sigma=sigma)
    cfg = synth.write_dataset(str(folder / "data"), reads, read_len, insert)
    prefix = str(folder / "out")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SOAPDENOVO_TORCH_DEVICE", "cpu")
        mp.setenv("SOAPDENOVO_TORCH_NO_SHARD", "1")
        torch.set_num_threads(1)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            res = cli.main(["all", "-s", cfg, "-K", str(k), "-M", "1", "-o",
                            prefix])
    path = folder / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = {}
    wanted = {profiling.PREFIX + n for n in SPANS}
    for ev in json.loads(path.read_text())["traceEvents"]:
        name = ev.get("name", "")
        if ev.get("ph") == "X" and name in wanted:
            start = float(ev["ts"])
            spans.setdefault(name[len(profiling.PREFIX):], []).append(
                (start, start + float(ev["dur"])))
    return k, reads.interleaved(), prefix, res, spans


def test_all_m1_meets_every_limit_of_the_reference(m1_run):
    k, reads, prefix, _res, _spans = m1_run
    numbers = reference.check(prefix, reads, k, torch.device("cpu"))
    assert set(numbers) == set(reference.LIMITS)
    over = {name: v for name, v in numbers.items()
            if v > reference.LIMITS[name]}
    assert not over
    assert numbers["contig_kmers_unread"] == 0
    assert numbers["transcript_pieces_off"] == 0


def test_tourbus_span_and_counters(m1_run):
    """One ``contig.tourbus.launch`` and one ``contig.tourbus.read`` a
    wave and one ``contig.tourbus.apply`` a productive wave, inside the
    pinch's ``contig.tourbus`` and together no longer than it; the
    counters are the pinch's stats and the waves' shapes (arc buffer rows
    and candidate rows a wave, m = 3 at -M 1)."""
    _k, _reads, _prefix, res, spans = m1_run
    counters, totals = res.counters, res.spans
    stats = {k: counters["tourbus." + k] for k in (
        "waves", "productive", "merged", "compared", "arcs_dropped")}
    assert stats == {k: res.contig.tourbus[k] for k in stats}
    assert stats["productive"] >= 1 and stats["arcs_dropped"] > 0
    calls = {"contig.tourbus": 1, "contig.tourbus.launch": stats["waves"],
             "contig.tourbus.read": stats["waves"],
             "contig.tourbus.apply": stats["productive"]}
    for name, n in calls.items():
        assert totals[name][1] == n, name
        assert len(spans[name]) == n, name
    (lo, hi), = spans["contig.tourbus"]
    for name in SPANS[1:]:
        assert all(lo <= s and e <= hi for s, e in spans[name]), name
    assert sum(totals[name][0] for name in SPANS[1:]) <= \
        totals["contig.tourbus"][0]
    waves = stats["waves"]
    rows = counters["tourbus.arc_rows"] // waves
    assert counters["tourbus.arc_rows"] == rows * waves > 0
    assert counters["tourbus.cand_rows"] == min(tourbus.CAND_CAP,
                                                rows) * waves
    m_max, _diff = tourbus._params_for(1)
    assert counters["tourbus.path_slots"] == \
        m_max * counters["tourbus.cand_rows"]
