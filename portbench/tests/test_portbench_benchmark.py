"""BENCHMARK.json and the files it names: they load, their names and
units keep to the allowed characters, and every metric is reported where
it claims to be."""

import json
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (harness.ROOT / p).is_dir()
    assert bench["command"][1].startswith(bench["paths"][0] + "/")


def test_names_and_units(bench):
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.append((kind, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                        and "\t" not in e[k]
    assert len(names) == len(set(names))
    metric_names = [e["name"] for e in bench["end_to_end"] +
                    bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_files_load(bench):
    for c in bench["configs"]:
        assert c["file"].startswith(bench["paths"][0] + "/")
        cfg = harness.config_of(bench, {"config": c["name"]})
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"])
    for w in bench["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        traffic = harness.traffic_of(w)
        assert harness.driver_of(traffic) is not None
        for m in harness.metrics_of(bench, w["name"], "end_to_end"):
            if m["name"] != "setup_s":
                assert m["name"] in traffic["end_to_end"]
    for m in bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]).read)


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(bench, w["name"],
                                                     "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(bench, w["name"], "per_layer")


def test_moves_target_reported_in_each_cell(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            target = e2e[m["moves"]]
            assert cell in target.get("workloads", [cell])


def test_layers_are_named_alike(bench):
    by_prefix = {}
    for m in bench["per_layer"]:
        by_prefix.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values())


def test_roofline_and_mfu_names(bench):
    for m in bench["per_layer"]:
        if "roofline" in m["name"] or m["name"].startswith("mfu"):
            assert m["unit"] == "%" and m["better"] == "higher"
