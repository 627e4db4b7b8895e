"""``tourbus.read_s``: a traced run of ``pe100_k23_m1.uniform`` on the CPU
at a small size reads the span ``contig.tourbus.read``, which with
``tourbus.apply_s`` lies inside ``tourbus_s``; on the record of a ``-M 0``
run, where Tour-Bus does not run, the metric reads nothing and raises
nothing."""

import types

import pytest

from port_bench import run

CELL = "pe100_k23_m1.uniform"


def test_traced_run_reads_the_wave_read_span(monkeypatch, tmp_path):
    for key in ("SOAPDENOVO_TORCH_DEVICE", "SOAPDENOVO_TORCH_NO_SHARD"):
        monkeypatch.setenv(key, "")
    out = run.run_cell(CELL, 2**31 + 23, 0.5, True, device_name="cpu",
                       pairs=1000, warmup_pairs=300, transcripts=10,
                       workroot=str(tmp_path))
    assert out["correct"] is True
    m = {name: v["value"] for name, v in out["metrics"].items()}
    assert m.get("tourbus.read_s") is not None and m["tourbus.read_s"] > 0
    assert m["tourbus.apply_s"] + m["tourbus.read_s"] < m["tourbus_s"]
    assert out["metrics"]["tourbus.read_s"]["unit"] == "s"


def test_the_metric_reads_the_span():
    trace = types.SimpleNamespace(result=types.SimpleNamespace(
        spans={"contig.tourbus": (0.5, 1), "contig.tourbus.read": (0.125, 9)},
        counters={"tourbus.waves": 9}), device=[])
    assert run.load_metric("tourbus.read_s").read(trace) == 0.125


@pytest.mark.parametrize("result", [
    types.SimpleNamespace(spans={"contig": (0.2, 1), "all": (9.0, 1)},
                          counters={"merge_path.rows": 8}),
    types.SimpleNamespace(spans={}, counters={}),
    object(),  # an AllResult from before the port kept spans
], ids=["m0_record", "empty", "no_record"])
def test_a_record_without_tourbus_reads_nothing(result):
    trace = types.SimpleNamespace(result=result, device=[])
    assert run.load_metric("tourbus.read_s").read(trace) is None
