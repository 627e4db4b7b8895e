"""The per-layer metrics that read the port's own spans and counters
(``AllResult.spans``, ``AllResult.counters``): a traced run on the CPU
reads all four, each a part of the stage it lies in; on a record
without its name (a port that keeps no such span or counter) each reads
nothing and raises nothing."""

import types

import pytest

from port_bench import run

CELL = "pe100_k23_m0.uniform"
NEW = ("pregraph.write_s", "reads.wait_s", "reads.decode_s", "map.reads_s")


def test_traced_run_reads_the_program_metrics(monkeypatch, tmp_path):
    for key in ("SOAPDENOVO_TORCH_DEVICE", "SOAPDENOVO_TORCH_NO_SHARD"):
        monkeypatch.setenv(key, "")
    out = run.run_cell(CELL, 2**31 + 11, 0.5, True, device_name="cpu",
                       pairs=2500, warmup_pairs=300, transcripts=25,
                       workroot=str(tmp_path))
    assert out["correct"] is True
    m = {name: v["value"] for name, v in out["metrics"].items()}
    assert all(m.get(name) is not None and m[name] > 0 for name in NEW)
    assert out["metrics"]["reads.decode_s"]["unit"] == "s"
    assert m["pregraph.write_s"] < m["pregraph_s"]
    assert m["map.reads_s"] < m["map_s"]


@pytest.mark.parametrize("result", [
    types.SimpleNamespace(spans={}, counters={}),
    types.SimpleNamespace(spans={"all": (1.0, 1)},
                          counters={"merge_path.rows": 8}),
    object(),  # an AllResult from before the port kept spans
], ids=["empty", "other_names", "no_record"])
@pytest.mark.parametrize("name", NEW)
def test_a_record_without_the_name_reads_nothing(name, result):
    trace = types.SimpleNamespace(result=result)
    assert run.load_metric(name).read(trace) is None
