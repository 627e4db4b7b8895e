"""The port's ``all`` at the default merge level (-M 1) on the CPU, judged
by the benchmark's plain-PyTorch reference (``port_bench/reference.py``,
which imports no JAX): 1,000 pairs of 2x100 bp over 10 transcripts and
their SNP isoforms (``port_bench/synth.py``, seed 2), where the JAX
package's arc remap makes contigs with K-mers no read has and scaffold
pieces that are not their contigs' bases.  Every number of the reference
must be within its limit.  The same run, under the profiler, records
Tour-Bus's span ``contig.tourbus.apply`` inside ``contig.tourbus`` once a
productive wave, and its counters."""

import json

import pytest
import torch

from port_bench import reference, synth
from soapdenovo_trans_tpu_torch import cli
from soapdenovo_trans_tpu_torch.graph import tourbus
from soapdenovo_trans_tpu_torch.utils import profiling

K, PAIRS, TRANSCRIPTS, SEED = 23, 1000, 10, 2


@pytest.fixture(scope="module")
def m1_run(tmp_path_factory):
    """(the reads, the output prefix, the result, the trace's
    ``contig.tourbus`` and ``contig.tourbus.apply`` intervals) of one
    ``all -M 1`` under the profiler."""
    folder = tmp_path_factory.mktemp("m1")
    reads = synth.make_reads(SEED, TRANSCRIPTS, PAIRS, 100, 300)
    cfg = synth.write_dataset(str(folder / "data"), reads, 100, 300)
    prefix = str(folder / "out")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SOAPDENOVO_TORCH_DEVICE", "cpu")
        mp.setenv("SOAPDENOVO_TORCH_NO_SHARD", "1")
        torch.set_num_threads(1)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            res = cli.main(["all", "-s", cfg, "-K", str(K), "-M", "1", "-o",
                            prefix])
    path = folder / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = {}
    for ev in json.loads(path.read_text())["traceEvents"]:
        name = ev.get("name", "")
        if ev.get("ph") == "X" and name in (
                profiling.PREFIX + "contig.tourbus",
                profiling.PREFIX + "contig.tourbus.apply"):
            start = float(ev["ts"])
            spans.setdefault(name[len(profiling.PREFIX):], []).append(
                (start, start + float(ev["dur"])))
    return reads.interleaved(), prefix, res, spans


def test_all_m1_meets_every_limit_of_the_reference(m1_run):
    reads, prefix, _res, _spans = m1_run
    numbers = reference.check(prefix, reads, K, torch.device("cpu"))
    assert set(numbers) == set(reference.LIMITS)
    over = {name: v for name, v in numbers.items()
            if v > reference.LIMITS[name]}
    assert not over
    assert numbers["contig_kmers_unread"] == 0
    assert numbers["transcript_pieces_off"] == 0


def test_tourbus_span_and_counters(m1_run):
    """One ``contig.tourbus.apply`` a productive wave, inside the pinch's
    ``contig.tourbus``; the counters are the pinch's stats and the waves'
    shapes (arc buffer rows and candidate rows a wave, m = 3 at -M 1)."""
    _reads, _prefix, res, spans = m1_run
    counters, totals = res.counters, res.spans
    stats = {k: counters["tourbus." + k] for k in (
        "waves", "productive", "merged", "compared", "arcs_dropped")}
    assert stats == {k: res.contig.tourbus[k] for k in stats}
    assert stats["productive"] >= 1 and stats["arcs_dropped"] > 0
    assert totals["contig.tourbus.apply"][1] == stats["productive"]
    assert totals["contig.tourbus"][1] == 1
    (lo, hi), = spans["contig.tourbus"]
    assert len(spans["contig.tourbus.apply"]) == stats["productive"]
    assert all(lo <= s and e <= hi for s, e in spans["contig.tourbus.apply"])
    waves = stats["waves"]
    rows = counters["tourbus.arc_rows"] // waves
    assert counters["tourbus.arc_rows"] == rows * waves > 0
    assert counters["tourbus.cand_rows"] == min(tourbus.CAND_CAP,
                                                rows) * waves
    m_max, _diff = tourbus._params_for(1)
    assert counters["tourbus.path_slots"] == \
        m_max * counters["tourbus.cand_rows"]
