"""The `-M 1` cells of BENCHMARK.json: ``pe150_k31_m1.uniform`` and
``pe100_k23_m1.skewed`` take one chip each beside ``pe100_k23_m1.uniform``;
``pe150_k31_m1.json`` is ``pe150_k31_m0.json`` at the default merge level;
and every Tour-Bus metric lists the three cells."""

import json
import os

import pytest

from port_bench import run

ROOT = run.ROOT
M1_CELLS = ["pe100_k23_m1.uniform", "pe150_k31_m1.uniform",
            "pe100_k23_m1.skewed"]
TOURBUS_METRICS = ("tourbus_s", "tourbus.ms_per_wave", "tourbus.apply_s",
                   "tourbus.read_s", "wave.roofline")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_the_m1_cells_take_one_chip_each(bench):
    cells = {w["name"]: w for w in bench["workloads"]}
    assert {name: (cells[name]["config"], cells[name]["traffic"],
                   cells[name]["chips"]) for name in M1_CELLS} == {
        "pe100_k23_m1.uniform": ("pe100_k23_m1", "uniform", 1),
        "pe150_k31_m1.uniform": ("pe150_k31_m1", "uniform", 1),
        "pe100_k23_m1.skewed": ("pe100_k23_m1", "skewed", 1)}


def test_pe150_k31_m1_is_pe150_k31_m0_at_the_default_merge_level(bench):
    def load(name):
        with open(os.path.join(ROOT, "port_bench", "configs",
                               name + ".json")) as fh:
            return json.load(fh)

    m0, m1 = load("pe150_k31_m0"), load("pe150_k31_m1")
    differ = {k for k in set(m0) | set(m1) if m0.get(k) != m1.get(k)}
    assert differ == {"name", "source", "flags", "merge_level", "reference"}
    assert (m1["flags"], m1["merge_level"]) == (["-M", "1"], 1)
    configs = {c["name"]: c for c in bench["configs"]}
    assert configs["pe150_k31_m1"]["file"] == \
        "port_bench/configs/pe150_k31_m1.json"
    assert configs["pe150_k31_m1"]["reduced"] == ["read_bases"]


def test_every_tourbus_metric_lists_the_m1_cells(bench):
    metrics = {m["name"]: m for m in bench["per_layer"]}
    for name in TOURBUS_METRICS:
        assert set(M1_CELLS) <= set(metrics[name]["workloads"]), name
    # K = 31 rows bypass the merge kernel
    merge = metrics["merge_path.roofline"]["workloads"]
    assert "pe100_k23_m1.skewed" in merge
    assert "pe150_k31_m1.uniform" not in merge
