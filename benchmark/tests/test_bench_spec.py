"""``BENCHMARK.json`` against the contract's shape, and every file it
names found by name."""

import json
import re

import pytest

from benchmark.spec import BENCH_DIR, ROOT, Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
SPEC = Spec.load()


def one_line(s, most=200):
    return isinstance(s, str) and 1 <= len(s) <= most and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert DOC["paths"] == ["benchmark"]
    assert 1 <= len(DOC["command"]) <= 32
    for word in DOC["command"]:
        assert one_line(word) and not word.startswith("/") \
            and ".." not in word
    assert (ROOT / DOC["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in DOC[group]]
        assert len(names) == len(set(names))
        for e in DOC[group]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e and group != "end_to_end" and group != "per_layer":
                    assert one_line(e[key]), (e["name"], key)
            if "layer" in e:
                assert one_line(e["layer"])
    metric_names = [m["name"] for m in DOC["end_to_end"] + DOC["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_each_entry_has_just_its_keys():
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    assert len({c["file"] for c in DOC["configs"]}) == len(DOC["configs"])
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
    for m in DOC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in DOC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_finds_its_files_and_reports_what_it_must():
    e2e = {m["name"] for m in DOC["end_to_end"]}
    assert "setup_s" in e2e
    used = set()
    for w in DOC["workloads"]:
        cell = SPEC.cell(w["name"])
        used.add(w["config"])
        assert (BENCH_DIR / "drivers" / f"{cell.traffic['driver']}.py").is_file()
        ends = {m.name for m in SPEC.end_to_end_for(w["name"])}
        assert "setup_s" in ends and len(ends) >= 2
        assert SPEC.per_layer_for(w["name"])
        for m in SPEC.metrics_for(w["name"], False) + \
                SPEC.metrics_for(w["name"], True):
            assert (BENCH_DIR / "metrics" / f"{m.name}.py").is_file()
    assert used == {c["name"] for c in DOC["configs"]}


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    for m in SPEC.per_layer:
        assert m.moves in {e.name for e in SPEC.end_to_end}
        for cell in m.workloads:
            assert m.moves in {e.name for e in SPEC.end_to_end_for(cell)}
    layers = {}
    for m in SPEC.per_layer:
        layers.setdefault(m.layer, []).append(m.name)
    assert all(isinstance(k, str) for k in layers)


def test_configs_keep_the_sources_shapes():
    for c in DOC["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["reduced"] == c["reduced"] == []
        assert f["name"] == c["name"] and one_line(c["source"])
    sift = json.loads((BENCH_DIR / "configs" / "sift1m.json").read_text())
    assert (sift["num_data"], sift["num_queries"], sift["num_attrs"]) == \
        (1_000_000, 10_000, 128)
    fm = json.loads((BENCH_DIR / "configs" / "fashion_mnist.json").read_text())
    assert (fm["num_data"], fm["num_queries"], fm["num_attrs"]) == \
        (60_000, 10_000, 784)


def test_run_seconds_fits_the_full_check():
    rs = DOC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    n4 = sum(w["chips"] == 4 for w in DOC["workloads"])
    assert n4 <= max(1, len(DOC["workloads"]) // 4)


@pytest.mark.parametrize("mix", sorted(p.stem for p in
                                       (BENCH_DIR / "traffic").glob("*.json")))
def test_traffic_files_name_a_driver_and_limits(mix):
    t = json.loads((BENCH_DIR / "traffic" / f"{mix}.json").read_text())
    assert (BENCH_DIR / "drivers" / f"{t['driver']}.py").is_file()
    assert t["limits"]
