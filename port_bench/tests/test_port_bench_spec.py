"""BENCHMARK.json against the contract's character and shape rules, and
every file a cell names."""

import json
import os
import re

import pytest

from port_bench import run

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in bench["paths"])
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_names_units_and_keys_use_allowed_characters(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        keys = {"name", "unit", "better", "source"}
        keys |= {"bound"} if m in bench["end_to_end"] else \
            {"layer", "moves"}
        assert set(m) - {"workloads"} == keys
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))


def test_bounds_sources_and_what_each_cell_reports(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
    for w in bench["workloads"]:
        _, _, _, ends, per = run.cell_spec(w["name"], bench)
        got = {m["name"] for m in ends}
        assert "setup_s" in got and len(got) >= 2 and per
        for m in per:
            assert m["moves"] in got
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(
        1, len(bench["workloads"]) // 4)


def test_every_file_a_cell_names_exists(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for c in configs.values():
        assert c["file"].startswith("port_bench/")
        with open(os.path.join(ROOT, c["file"])) as fh:
            body = json.load(fh)
        assert body["name"] == c["name"]
        assert set(c["reduced"]) <= set(body["reduced"])
    for w in bench["workloads"]:
        assert w["config"] in configs
        assert os.path.exists(os.path.join(
            ROOT, "port_bench", "mixes", w["traffic"] + ".json"))
    used = {w["config"] for w in bench["workloads"]}
    assert used == set(configs)


def test_metric_files_agree_with_the_benchmark(bench):
    for m in bench["per_layer"]:
        mod = run.load_metric(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
            m["layer"], m["unit"], m["source"], m["moves"])
        assert callable(mod.read)


def test_pairs_come_from_the_configured_bases(bench):
    from port_bench import synth

    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            body = json.load(fh)
        pairs = synth.n_pairs(body, body["lib"]["max_rd_len"])
        assert pairs * 2 * body["lib"]["max_rd_len"] >= body["read_bases"]
