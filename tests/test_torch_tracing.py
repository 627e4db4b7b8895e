"""The port's spans and counters (``utils/profiling``): a small ``all``
on the CPU under ``torch.profiler`` puts every span in the exported trace
as ``soap/<name>``, nested as the program nests them and as long as the
record says; the stages' ``phase_seconds`` and ``stage_seconds`` are the
span totals; with no profiler no ``record_function`` is entered; the
read passes' waits, the decoder's seconds, the merge rows and the
``.edge.gz`` deflate's chunks, workers and bytes are counted where the
work happens; a mesh's routes and exchanges are spans inside the stages
that exchange, and its counters are the mesh's own totals, while a
one-device run records none of them; counters added from many threads
lose nothing."""

import glob
import gzip
import json
import shutil
import sys
import threading

import pytest
import torch

import perf_e2e
from soapdenovo_trans_tpu_torch import cli
from soapdenovo_trans_tpu_torch.io import fastx, graph_files, stagefiles
from soapdenovo_trans_tpu_torch.kernels import merge_path
from soapdenovo_trans_tpu_torch.stages import pregraph
from soapdenovo_trans_tpu_torch.utils import profiling

# child -> the spans one of which holds each of its intervals
PARENTS = {
    "pregraph": ("all",), "contig": ("all",), "map": ("all",),
    "scaff": ("all",),
    **{f"pregraph.{p}": ("pregraph",) for p in
       ("count", "clip", "condense", "thread", "write")},
    **{f"pregraph.write.{p}": ("pregraph.write",) for p in
       ("host", "vertex", "edge", "arc")},
    "pregraph.write.edge.deflate": ("pregraph.write.edge",),
    **{f"contig.{p}": ("contig",) for p in
       ("bubbles", "clean", "laps", "short", "write")},
    "map.index": ("map",), "map.reads": ("map",), "map.write": ("map",),
    "map.vote": ("map.reads",),
    **{f"scaff.{p}": ("scaff",) for p in
       ("links", "structure", "routes", "render", "write")},
    "reads.wait": ("pregraph.count", "pregraph.thread", "map.reads"),
}


def _shrink(mp):
    """Map batches of 1,024 reads and build units of 4,096: the 5,000
    reads take one batch in each pregraph pass, five in map's, and two
    build units, so counting merges."""
    torch.set_num_threads(1)
    mp.setenv("SOAPDENOVO_TORCH_DEVICE", "cpu")
    mp.setattr(cli, "MAP_BATCH", 1024)
    mp.setattr(pregraph, "TARGET_BUILD_ROWS", 1)


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    _shrink(monkeypatch)


@pytest.fixture(scope="module")
def reads_cfg(tmp_path_factory):
    return perf_e2e.synth(str(tmp_path_factory.mktemp("reads")), n_tx=30,
                          n_pairs=2500, seed=3)


def _all(cfg, out, *flags):
    return cli.main(["all", "-s", cfg, "-K", "23", "-M", "0", *flags,
                     "-o", str(out)])


class _Counted:
    """A wrapper that counts the calls of the function it wraps."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


@pytest.fixture(scope="module")
def traced(reads_cfg, tmp_path_factory):
    """One ``all`` under the profiler: (result, the trace's ``soap/``
    events by name, record_function entries, batches and passes of the
    read-ahead, rows of every merge call and the output prefix)."""
    tmp = tmp_path_factory.mktemp("traced")
    seen = {"batches": 0, "passes": 0, "merge_rows": 0,
            "prefix": str(tmp / "out")}
    read_batches = fastx.config_read_batches
    merge = merge_path.merge_sorted_rows

    def batches(*args, **kwargs):
        seen["passes"] += 1
        for x in read_batches(*args, **kwargs):
            seen["batches"] += 1
            yield x

    def merge_rows(*args):
        seen["merge_rows"] += args[0].shape[0] + args[2].shape[0]
        return merge(*args)

    rf = _Counted(torch.profiler.record_function)
    with pytest.MonkeyPatch.context() as mp:
        _shrink(mp)
        mp.setattr(fastx, "config_read_batches", batches)
        mp.setattr(merge_path, "merge_sorted_rows", merge_rows)
        mp.setattr(torch.profiler, "record_function", rf)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            res = _all(reads_cfg, tmp / "out")
    path = tmp / "trace.json"
    prof.export_chrome_trace(str(path))
    events = {}
    for ev in json.loads(path.read_text())["traceEvents"]:
        name = ev.get("name", "")
        if ev.get("ph") == "X" and name.startswith(profiling.PREFIX):
            start = float(ev["ts"])
            events.setdefault(name[len(profiling.PREFIX):], []).append(
                (start, start + float(ev["dur"])))
    return res, events, rf.calls, seen


def test_every_span_is_in_the_trace_inside_its_parent(traced):
    res, events, entered, _ = traced
    assert set(events) == set(res.spans) >= set(PARENTS) | {"all"}
    assert entered == sum(calls for _, calls in res.spans.values())
    for name, parents in PARENTS.items():
        holders = [iv for p in parents for iv in events[p]]
        for s, e in events[name]:
            assert any(ps <= s and e <= pe for ps, pe in holders), name


def test_trace_durations_match_the_record(traced):
    res, events, _, _ = traced
    for name, (seconds, calls) in res.spans.items():
        assert len(events[name]) == calls, name
        traced_s = sum(e - s for s, e in events[name]) / 1e6
        assert abs(traced_s - seconds) <= max(0.05 * seconds, 0.010), name


def _span_of(stage, key):
    """The span a phase key reads (gap filling's phases nest in fill)."""
    return f"{stage}.{key}".replace("scaff.fill_", "scaff.fill.")


@pytest.mark.parametrize("devices,flags", [
    ("cpu", ()), ("cpu", ("-F",)), ("cpu,cpu", ())],
    ids=["one_device", "fill", "mesh"])
def test_phase_and_stage_seconds_are_the_span_totals(
        reads_cfg, tmp_path, monkeypatch, devices, flags):
    monkeypatch.setenv("SOAPDENOVO_TORCH_DEVICE", devices)
    res = _all(reads_cfg, tmp_path / "out", *flags)
    assert set(res.stage_seconds) == {"pregraph", "contig", "map", "scaff"}
    for stage, secs in res.stage_seconds.items():
        assert res.spans[stage] == (pytest.approx(secs, abs=1e-12), 1)
    for stage, phases in (("pregraph", res.pregraph.phase_seconds),
                          ("contig", res.contig.phase_seconds),
                          ("map", res.map.phase_seconds),
                          ("scaff", res.scaff.phase_seconds)):
        assert phases
        for key, secs in phases.items():
            got = res.spans[_span_of(stage, key)][0]
            assert got == pytest.approx(secs, abs=1e-12), (stage, key)
    assert ("scaff.fill" in res.spans) == ("-F" in flags)
    assert res.spans["map.vote"][1] >= 5  # one a batch of the map pass


def test_no_profiler_enters_no_record_function(reads_cfg, tmp_path,
                                               monkeypatch):
    rf = _Counted(torch.profiler.record_function)
    monkeypatch.setattr(torch.profiler, "record_function", rf)
    res = _all(reads_cfg, tmp_path / "out")
    assert rf.calls == 0
    assert res.spans["all"][1] == 1 and res.spans["reads.wait"][1] > 0


def test_read_waits_decode_seconds_and_merge_rows(traced):
    res, _, _, seen = traced
    # count, thread and map passes; each ends with one more step, the
    # wait for the end of the stream
    assert seen["passes"] == 3 and seen["batches"] == 1 + 1 + 5
    assert res.spans["reads.wait"][1] == seen["batches"] + seen["passes"]
    assert res.counters["reads.decode_s"] > 0
    assert seen["merge_rows"] > 0
    assert res.counters["merge_path.rows"] == seen["merge_rows"]


def test_edge_deflate_counters(reads_cfg, tmp_path, monkeypatch):
    """A pregraph run records the .edge.gz deflate's chunks, workers and
    bytes: the text's (the file gunzipped) and the file's."""
    monkeypatch.setattr(graph_files, "_CHUNK", 1 << 12)
    args = cli.build_parser().parse_args(
        ["pregraph", "-s", reads_cfg, "-K", "23", "-o", str(tmp_path / "p")])
    rec = profiling.StageTimings()
    with profiling.active(rec):
        cli.run_pregraph_cmd(args, torch.device("cpu"))
    got = {name: rec.counters["pregraph.write.edge." + name]
           for name in ("chunks", "workers", "text_bytes", "gz_bytes")}
    path = tmp_path / "p.edge.gz"
    assert got["text_bytes"] == len(gzip.decompress(path.read_bytes()))
    assert got["gz_bytes"] == path.stat().st_size < got["text_bytes"]
    assert 1 <= got["workers"] <= got["chunks"]
    assert got["chunks"] == -(-got["text_bytes"] // graph_files._CHUNK) > 1


def test_placement_table_counters(reads_cfg, traced, tmp_path,
                                  monkeypatch):
    """A map run on the traced ``all``'s contig files records the rows
    of .readOnContig and .ctg2Read, their chunks of ``_ROWS_PER_CHUNK``
    rows and the most threads one table used."""
    src = traced[3]["prefix"]
    for path in glob.glob(src + ".*"):
        shutil.copy(path, str(tmp_path / "m") + path[len(src):])
    monkeypatch.setattr(stagefiles, "_ROWS_PER_CHUNK", 1 << 9)
    args = cli.build_parser().parse_args(
        ["map", "-s", reads_cfg, "-g", str(tmp_path / "m")])
    rec = profiling.StageTimings()
    with profiling.active(rec):
        cli.run_map_cmd(args, torch.device("cpu"))
    rows = [len((tmp_path / ("m" + ext)).read_text().splitlines()) - 1
            for ext in (".readOnContig", ".ctg2Read")]
    got = {name: rec.counters["map.write." + name]
           for name in ("rows", "chunks", "workers")}
    assert got["rows"] == sum(rows) and min(rows) > 1 << 9
    assert got["chunks"] == sum(-(-r // (1 << 9)) for r in rows)
    assert 1 <= got["workers"] <= got["chunks"]


MESH_SPANS = ("mesh.route", "mesh.exchange")
MESH_COUNTERS = ("mesh.exchanges", "mesh.exchange_bytes", "mesh.peer_bytes",
                 "mesh.shards")


@pytest.fixture(scope="module")
def traced_mesh(reads_cfg, tmp_path_factory):
    """One ``all`` on four logical CPU shards under the profiler: (result,
    the trace's ``soap/`` intervals by name, the run's mesh)."""
    tmp = tmp_path_factory.mktemp("traced_mesh")
    meshes = []
    make_mesh = cli.mesh_from_env

    def keep_mesh():
        meshes.append(make_mesh())
        return meshes[-1]

    with pytest.MonkeyPatch.context() as mp:
        _shrink(mp)
        mp.setenv("SOAPDENOVO_TORCH_DEVICE", "cpu,cpu,cpu,cpu")
        mp.setattr(cli, "mesh_from_env", keep_mesh)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            res = _all(reads_cfg, tmp / "out")
    path = tmp / "trace.json"
    prof.export_chrome_trace(str(path))
    events = {}
    for ev in json.loads(path.read_text())["traceEvents"]:
        name = ev.get("name", "")
        if ev.get("ph") == "X" and name.startswith(profiling.PREFIX):
            start = float(ev["ts"])
            events.setdefault(name[len(profiling.PREFIX):], []).append(
                (start, start + float(ev["dur"])))
    assert len(meshes) == 1
    return res, events, meshes[0]


def test_mesh_routes_and_exchanges_are_spans_inside_pregraph_and_map(
        traced_mesh):
    res, events, _ = traced_mesh
    for name in MESH_SPANS:
        assert len(events[name]) == res.spans[name][1] > 0, name
        inside = {stage: sum(ps <= s and e <= pe for s, e in events[name]
                             for ps, pe in events[stage])
                  for stage in ("pregraph", "map")}
        # every one inside a stage that exchanges, and both stages do
        assert sum(inside.values()) == len(events[name]), name
        assert min(inside.values()) > 0, (name, inside)
    # a route's host read is not part of an exchange's enqueue
    for s, e in events["mesh.exchange"]:
        assert not any(rs <= s and e <= re_ for rs, re_ in
                       events["mesh.route"])


def test_mesh_counters_are_the_mesh_totals(traced_mesh):
    res, _, mesh = traced_mesh
    got = {name: res.counters[name] for name in MESH_COUNTERS}
    assert got == {"mesh.exchanges": mesh.exchanges,
                   "mesh.exchange_bytes": mesh.exchange_bytes,
                   "mesh.peer_bytes": 0, "mesh.shards": 4}
    assert mesh.exchanges == res.pregraph.exchanges + res.map.exchanges > 0
    assert mesh.exchange_bytes == \
        res.pregraph.exchange_bytes + res.map.exchange_bytes > 0
    # logical shards of one device copy nothing between cards, and only
    # a mesh of cards reads their peaks
    assert not [k for k in res.counters if k.startswith("mesh.peak_bytes")]


def test_one_device_records_no_mesh_span_or_counter(traced):
    res, events, _, _ = traced
    assert not [k for k in [*res.spans, *res.counters, *events]
                if k.startswith("mesh.")]


def test_spans_and_counters_go_to_the_active_recorder_only():
    rec = profiling.StageTimings()
    with profiling.span("nowhere"):
        pass
    profiling.counter("nowhere", 1)
    with pytest.raises(KeyError), profiling.active(rec):
        with profiling.span("x") as sp:
            profiling.counter("n", 2)
            raise KeyError("a failed step is still timed")
    with profiling.span("nowhere"):
        pass
    assert rec.span_totals() == {"x": (sp.seconds, 1)}
    assert rec.counters == {"n": 2} and not rec.seconds


def test_counters_from_many_threads_lose_nothing():
    rec = profiling.StageTimings()
    n_threads, n_adds = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            rec.counter("c", 1) for _ in range(n_adds)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert rec.counters["c"] == n_threads * n_adds
