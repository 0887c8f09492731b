"""BENCHMARK.json against the benchmark's contract, and every name in it
found in its own file."""

import json
import os
import re

import pytest

from tnbench import manifest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH_KEY = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                       r"projection|head|expansion|experts_per")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "tnbench/run.py"]
    assert bench["paths"] == ["tnbench"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_one_line_texts(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200
                    assert "\n" not in e[key] and "\t" not in e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert len(names) == len(set(names))


def test_entries_have_just_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert not c["reduced"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_every_cell_reports_enough(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for cell in cells:
        got = [m["name"] for m in bench["end_to_end"]
               if manifest.applies(m, cell)]
        assert "setup_s" in got and len(got) >= 2
        assert any(manifest.applies(m, cell) for m in bench["per_layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert manifest.applies(e2e[m["moves"]], cell)
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    configs = {c["name"] for c in bench["configs"]}
    assert configs == {w["config"] for w in bench["workloads"]}


def test_configs_found_by_name(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert c["file"].startswith("tnbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"]
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert not any(WIDTH_KEY.search(k) for k in c["reduced"])


def test_cells_and_metrics_found_by_name(bench):
    for w in bench["workloads"]:
        cell = manifest.cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert os.path.exists(cell.plan_path)
        assert set(cell.limits) == {"err_l2", "err_max"}
        assert all(0 < v < 1 for v in cell.limits.values())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_files_are_named_from_name_characters():
    for dirpath, dirnames, filenames in os.walk(HERE):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        rel = os.path.relpath(dirpath, ROOT)
        for f in filenames:
            path = os.path.join(rel, f)
            assert re.match(r"^[A-Za-z0-9_./-]+$", path), path
