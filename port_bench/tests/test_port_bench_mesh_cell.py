"""The four-card cell of BENCHMARK.json: ``pe100_k23.mesh4`` runs
``pe100_k23_m0_mesh4`` (``pe100_k23_m0.json`` at four times the reads, on
the mesh) under ``uniform10k`` (``uniform.json`` over four times the
transcripts) on 4 chips; the mesh's four metrics list it alone and no
other metric lists it.  At a small size on four logical CPU shards, its
``all`` passes ``reference.check`` and writes the one-device files.  Each
mesh metric's reader on a synthetic trace, and nothing where the port
recorded nothing."""

import gzip
import json
import os
import types

import pytest
import torch

from port_bench import reference, run

ROOT = run.ROOT
CELL = "pe100_k23.mesh4"
MESH_METRICS = ("mesh.route_s", "mesh.exchange_s", "mesh.exchange.roofline",
                "mesh.peak_bytes")
LAYER = "mesh: parallel/mesh.py, parallel/sharded_*.py"


def _load(kind, name):
    with open(os.path.join(ROOT, "port_bench", kind, name + ".json")) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_the_cell_takes_four_chips_on_its_configuration_and_mix(bench):
    cells = {w["name"]: w for w in bench["workloads"]}
    cell = cells[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "pe100_k23_m0_mesh4", "uniform10k", 4)
    # the only cell of four chips
    assert [w["name"] for w in bench["workloads"] if w["chips"] == 4] == [
        CELL]
    configs = {c["name"]: c for c in bench["configs"]}
    assert configs["pe100_k23_m0_mesh4"]["file"] == \
        "port_bench/configs/pe100_k23_m0_mesh4.json"
    assert configs["pe100_k23_m0_mesh4"]["reduced"] == ["read_bases"]


def test_the_configuration_is_pe100_k23_m0_at_four_times_the_reads():
    one, mesh = _load("configs", "pe100_k23_m0"), _load(
        "configs", "pe100_k23_m0_mesh4")
    differ = {k for k in set(one) | set(mesh) if one.get(k) != mesh.get(k)}
    assert differ == {"name", "source", "read_bases", "reduced", "assumed",
                      "deployment", "reference"}
    assert mesh["read_bases"] == 4 * one["read_bases"] == 200_000_000
    assert set(mesh["reduced"]) == set(one["reduced"]) == {"read_bases"}
    assert {k for k in one["assumed"]
            if one["assumed"][k] != mesh["assumed"][k]} == {"transcripts"}
    assert set(mesh["assumed"]) == set(one["assumed"])
    assert (mesh["K"], mesh["flags"], mesh["lib"], mesh["guarantees"],
            mesh["warmup_pairs"]) == (23, ["-M", "0"], one["lib"],
                                      one["guarantees"], 4000)


def test_the_mix_is_uniform_over_four_times_the_transcripts():
    uniform, wide = _load("mixes", "uniform"), _load("mixes", "uniform10k")
    differ = {k for k in set(uniform) | set(wide)
              if uniform.get(k) != wide.get(k)}
    assert differ == {"transcripts", "why"}
    assert wide["transcripts"] == 4 * uniform["transcripts"] == 10_000


def test_the_mesh_metrics_list_the_cell_alone(bench):
    metrics = {m["name"]: m for m in bench["per_layer"]}
    for name in MESH_METRICS:
        m = metrics[name]
        assert m["workloads"] == [CELL] and m["layer"] == LAYER, name
    assert (metrics["mesh.peak_bytes"]["moves"],
            metrics["mesh.exchange.roofline"]["unit"]) == (
        "peak_device_bytes", "%")
    for m in bench["per_layer"]:
        if m["name"] not in MESH_METRICS:
            assert CELL not in m.get("workloads", []), m["name"]
    per = {m["name"] for m in run.cell_spec(CELL, bench)[4]}
    assert set(MESH_METRICS) <= per
    for other in bench["workloads"]:
        if other["name"] != CELL:
            assert not per & set(MESH_METRICS) & {
                m["name"] for m in run.cell_spec(other["name"], bench)[4]}


def _read(path, name):
    with open(path, "rb") as fh:
        data = fh.read()
    return gzip.decompress(data) if name.endswith(".gz") else data


def test_the_cells_all_on_four_cpu_shards_is_correct_and_the_one_device_run(
        tmp_path, monkeypatch):
    _, config, mix, _, _ = run.cell_spec(CELL)
    mix = {**mix, "transcripts": 30}
    cfg, reads = run.make_dataset(str(tmp_path / "data"), config, mix,
                                  2**31 + 41, 3000)
    from soapdenovo_trans_tpu_torch import cli

    monkeypatch.delenv("SOAPDENOVO_TORCH_NO_SHARD", raising=False)
    out = {}
    for spec in ("cpu", "cpu,cpu,cpu,cpu"):
        monkeypatch.setenv("SOAPDENOVO_TORCH_DEVICE", spec)
        prefix = tmp_path / spec.replace(",", "_") / "out"
        prefix.parent.mkdir()
        res = cli.main(run.assembly_argv(config, cfg, str(prefix)))
        out[spec] = prefix
    assert res.counters["mesh.shards"] == 4
    checks = reference.check(str(out["cpu,cpu,cpu,cpu"]), reads,
                             config["K"], torch.device("cpu"))
    assert checks and all(v <= reference.LIMITS[k]
                          for k, v in checks.items()), checks
    one, mesh = (sorted(os.listdir(p.parent)) for p in out.values())
    assert one == mesh and len(one) >= 19
    for name in one:
        a = _read(os.path.join(out["cpu"].parent, name), name)
        b = _read(os.path.join(out["cpu,cpu,cpu,cpu"].parent, name), name)
        if name.endswith(".scafStatistics"):  # names its own path
            a, b = (x.replace(str(p).encode(), b"P") for x, p in
                    ((a, out["cpu"]), (b, out["cpu,cpu,cpu,cpu"])))
        assert a == b, name


def _trace(spans=None, counters=None, device=()):
    return types.SimpleNamespace(result=types.SimpleNamespace(
        spans=spans or {}, counters=counters or {}), device=list(device))


def test_the_span_metrics_read_the_mesh_spans():
    trace = _trace(spans={"mesh.route": (1.25, 40), "mesh.exchange": (
        0.5, 80), "all": (9.0, 1)})
    assert run.load_metric("mesh.route_s").read(trace) == 1.25
    assert run.load_metric("mesh.exchange_s").read(trace) == 0.5


def test_the_peak_metric_reads_the_largest_card():
    trace = _trace(counters={"mesh.peak_bytes": 7e9,
                             "mesh.peak_bytes.cuda:1": 7e9,
                             "mesh.peak_bytes.cuda:0": 6e9})
    assert run.load_metric("mesh.peak_bytes").read(trace) == 7e9


def test_the_roofline_at_known_bytes_and_duration():
    roof = run.load_metric("mesh.exchange.roofline")
    copy = "Memcpy PtoP (Device -> Device)"
    # 225 MB in 1 ms of peer copies is half of 450 GB/s; two copies at
    # once between other cards add their durations, and other copies and
    # kernels count nothing
    trace = _trace(counters={"mesh.peer_bytes": 225e6}, device=[
        (copy, 0.0, 600.0), (copy, 100.0, 400.0),
        ("Memcpy DtoD (Device -> Device)", 0.0, 1e6),
        ("Memcpy HtoD (Pinned -> Device)", 0.0, 1e6),
        ("void merge_kernel<1>(...)", 0.0, 1e6)])
    assert roof.peer_copy_us(trace.device) == 1000.0
    assert roof.read(trace) == pytest.approx(50.0)
    full = _trace(counters={"mesh.peer_bytes": 450e6},
                  device=[(copy, 5.0, 1000.0)])
    assert roof.read(full) == pytest.approx(100.0)


@pytest.mark.parametrize("trace", [
    _trace(counters={"mesh.peer_bytes": 1e6}, device=[
        ("Memcpy DtoD (Device -> Device)", 0.0, 10.0)]),
    _trace(counters={"mesh.peer_bytes": 0.0}, device=[
        ("Memcpy PtoP (Device -> Device)", 0.0, 10.0)]),
    _trace(device=[("Memcpy PtoP (Device -> Device)", 0.0, 10.0)]),
], ids=["no_peer_copy", "no_peer_byte", "no_counter"])
def test_the_roofline_reads_nothing_without_peer_copies(trace):
    assert run.load_metric("mesh.exchange.roofline").read(trace) is None


@pytest.mark.parametrize("result", [
    types.SimpleNamespace(spans={"all": (9.0, 1), "pregraph": (3.0, 1)},
                          counters={"merge_path.rows": 8}),
    types.SimpleNamespace(spans={}, counters={}),
    object(),  # an AllResult from before the port kept spans
], ids=["one_device_record", "empty", "no_record"])
def test_a_record_without_a_mesh_reads_nothing(result):
    trace = types.SimpleNamespace(result=result, device=[
        ("Memcpy PtoP (Device -> Device)", 0.0, 10.0)])
    for name in MESH_METRICS:
        assert run.load_metric(name).read(trace) is None, name
