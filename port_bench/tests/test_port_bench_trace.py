"""The interval union, the idle gaps and the roofline arithmetic on
hand-made traces."""

import json
import os

import pytest

from port_bench import trace as tr


def test_interval_union_merges_overlap_and_touching():
    assert tr.interval_union([(5, 7), (0, 2), (1, 3), (3, 4), (9, 9)]) == [
        (0, 4), (5, 7)]
    assert tr.interval_union([]) == []
    assert tr.clip([(0, 4), (5, 7)], 2, 6) == [(2, 4), (5, 6)]


def _trace():
    # a kernel and a copy that overlap, a memset later, inside 0..100 us
    device = [("void merge_kernel<4>(long2 const*)", 10.0, 20.0),
              ("Memcpy HtoD (Pageable -> Device)", 25.0, 10.0),
              ("Memset (Device)", 60.0, 5.0),
              ("partition_kernel(long2 const*)", 90.0, 30.0)]
    spans = [("port_bench/assembly", 0.0, 100.0),
             ("port_bench/run_pregraph_cmd", 0.0, 50.0),
             ("port_bench/run_map_cmd", 50.0, 50.0)]
    return tr.Trace(device, spans, (0.0, 100.0), [1000])


def test_busy_is_the_union_inside_the_window():
    t = _trace()
    # 10..35 (kernel and copy), 60..65, 90..100 (clipped)
    assert t.busy_us() == pytest.approx(25 + 5 + 10)
    assert t.window_us() == 100.0


def test_idle_gaps_are_named_by_the_innermost_span():
    gaps = _trace().idle_gaps()
    # the middle of 35..60 (47.5) lies in pregraph's span, of 65..90 in map's
    assert [g[0] for g in gaps] == ["port_bench/run_pregraph_cmd",
                                    "port_bench/run_map_cmd",
                                    "port_bench/run_pregraph_cmd"]
    assert [g[1] for g in gaps] == pytest.approx([25e-6, 25e-6, 10e-6])


def test_top_ops_by_kernel_name():
    ops = dict(_trace().top_ops())
    assert ops["merge_kernel"] == pytest.approx(20e-6)
    assert ops["partition_kernel"] == pytest.approx(30e-6)
    assert tr.kernel_name("void a::b_kernel<int, 3>(int*, long)") == \
        "a::b_kernel"
    assert tr.kernel_name("void at::native::(anonymous namespace)::k<"
                          "float>(float*)") == "at::native::k"
    assert tr.kernel_name("Memcpy DtoH (Device -> Pageable)") == \
        "Memcpy DtoH"


def test_merge_roofline_arithmetic():
    # 64M rows: 2.56 GB at 3.35 TB/s is 0.764 ms, so 0.764 ms reads 100%
    rows = 64 * 2**20
    bound_s = tr.merge_bytes(rows) / tr.PEAKS["hbm_bytes_per_s"]
    assert tr.roofline_share(tr.merge_bytes(rows), bound_s) == \
        pytest.approx(100.0)
    assert tr.roofline_share(tr.merge_bytes(rows), 2 * bound_s) == \
        pytest.approx(50.0)
    assert tr.roofline_share(0, 1.0) is None
    assert tr.roofline_share(1, 0.0) is None


def test_metric_readers_on_a_hand_made_trace():
    from port_bench import run

    t = _trace()
    idle = run.load_metric("device.idle_share").read(t)
    assert idle == pytest.approx(60.0)
    roof = run.load_metric("merge_path.roofline").read(t)
    want = 100 * tr.merge_bytes(1000) / tr.PEAKS["hbm_bytes_per_s"] / 50e-6
    assert roof == pytest.approx(want)
    t.merge_rows = []
    assert run.load_metric("merge_path.roofline").read(t) is None
    t.device = []
    assert run.load_metric("device.idle_share").read(t) is None


def test_read_chrome_trace(tmp_path):
    ev = [{"ph": "X", "cat": "kernel", "name": "k1", "ts": 5, "dur": 2},
          {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 8, "dur": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1,
           "dur": 1},
          {"ph": "X", "cat": "user_annotation",
           "name": "port_bench/assembly", "ts": 0, "dur": 20},
          {"ph": "i", "cat": "kernel", "name": "marker", "ts": 3}]
    path = os.path.join(tmp_path, "t.json")
    with open(path, "w") as fh:
        json.dump({"traceEvents": ev}, fh)
    device, spans, window = tr.read_chrome_trace(path,
                                                 "port_bench/assembly")
    assert device == [("k1", 5.0, 2.0), ("c", 8.0, 1.0)]
    assert spans == [("port_bench/assembly", 0.0, 20.0)]
    assert window == (0.0, 20.0)
    with pytest.raises(RuntimeError):
        tr.read_chrome_trace(path, "port_bench/missing")
