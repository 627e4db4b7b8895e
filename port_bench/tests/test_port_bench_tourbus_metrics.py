"""The Tour-Bus metrics of the cell ``pe100_k23_m1.uniform``: a traced run
of the cell on the CPU at a small size is correct and reads
``tourbus_s``, ``tourbus.ms_per_wave`` and ``tourbus.apply_s`` (the
port's span and counters); ``wave.roofline`` reads the profiler's device
time of the wave's kernels, which a CPU run has none of, so it is held
here on device intervals made by hand.  On the record of a ``-M 0`` run,
where Tour-Bus does not run, all four read nothing and raise nothing."""

import types

import pytest

from port_bench import run
from port_bench import trace as tr

CELL = "pe100_k23_m1.uniform"
NEW = ("tourbus_s", "tourbus.ms_per_wave", "tourbus.apply_s",
       "wave.roofline")


def test_traced_run_reads_the_tourbus_metrics(monkeypatch, tmp_path):
    for key in ("SOAPDENOVO_TORCH_DEVICE", "SOAPDENOVO_TORCH_NO_SHARD"):
        monkeypatch.setenv(key, "")
    out = run.run_cell(CELL, 2**31 + 19, 0.5, True, device_name="cpu",
                       pairs=1000, warmup_pairs=300, transcripts=10,
                       workroot=str(tmp_path))
    assert out["correct"] is True
    assert out["checks"]["contig_kmers_unread"]["value"] == 0
    m = {name: v["value"] for name, v in out["metrics"].items()}
    for name in NEW[:3]:
        assert m.get(name) is not None and m[name] > 0, name
    assert "wave.roofline" not in m  # no device interval on the CPU
    assert m["tourbus.apply_s"] < m["tourbus_s"] < m["contig_s"]
    assert out["metrics"]["tourbus.ms_per_wave"]["unit"] == "ms"


def _trace(counters, device):
    return types.SimpleNamespace(
        result=types.SimpleNamespace(spans={}, counters=counters),
        device=device)


def test_wave_roofline_on_device_intervals():
    """Bytes: 25 an arc row, 88 a candidate row, 48 a node slot; time:
    the wave kernels' device intervals alone, by name."""
    mod = run.load_metric("wave.roofline")
    counters = {"tourbus.arc_rows": 4 * 100_000, "tourbus.cand_rows":
                4 * 1024, "tourbus.path_slots": 4 * 1024 * 3}
    floor = 25 * 400_000 + 88 * 4096 + 48 * 12_288
    assert mod.wave_bytes(400_000, 4096, 12_288) == floor
    us = 1e6 * floor / tr.PEAKS["hbm_bytes_per_s"]  # the bound's time
    device = [("(anonymous namespace)::front_forest_kernel(long long "
               "const*)", 0.0, us / 4),
              ("void (anonymous namespace)::identity_kernel(long long "
               "const*, int)", 10.0, us / 4),
              ("(anonymous namespace)::arcs_kernel(Claims, unsigned char "
               "const*)", 20.0, us / 2),
              ("void at::native::vectorized_elementwise_kernel<4>()", 30.0,
               1e6),
              ("Memcpy DtoH (Device -> Pinned)", 40.0, 1e6)]
    assert mod.read(_trace(counters, device)) == pytest.approx(100.0)
    device[0] = (device[0][0], 0.0, us / 4 + us)  # twice the bound's time
    assert mod.read(_trace(counters, device)) == pytest.approx(50.0)
    assert mod.read(_trace(counters, device[3:])) is None


@pytest.mark.parametrize("result", [
    types.SimpleNamespace(spans={"contig": (0.2, 1), "all": (9.0, 1)},
                          counters={"merge_path.rows": 8}),
    types.SimpleNamespace(spans={}, counters={}),
    object(),  # an AllResult from before the port kept spans
], ids=["m0_record", "empty", "no_record"])
@pytest.mark.parametrize("name", NEW)
def test_a_record_without_tourbus_reads_nothing(name, result):
    trace = types.SimpleNamespace(result=result, device=[
        ("(anonymous namespace)::arcs_kernel(Claims)", 0.0, 5.0)])
    assert run.load_metric(name).read(trace) is None
