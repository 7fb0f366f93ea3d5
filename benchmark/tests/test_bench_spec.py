"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re

import pytest

from harness import spec
from reference import brick

B = spec.load_benchmark()
CELLS = [w["name"] for w in B["workloads"]]
TEXT_RE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert list(B) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]


def test_command_and_paths():
    assert 1 <= len(B["command"]) <= 32
    for word in B["command"]:
        assert TEXT_RE.match(word) and not word.startswith("/") and \
            ".." not in word
    assert 1 <= len(B["paths"]) <= 16
    for p in B["paths"]:
        assert re.match(r"^[A-Za-z0-9_./\-]{1,200}$", p)
        assert (spec.ROOT / p).is_dir()
    assert B["command"][1].startswith(B["paths"][0] + "/")


def test_run_seconds_fit_a_full_check():
    rs = B["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entries_have_the_contract_keys_only():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_units_and_text():
    entries = B["configs"] + B["workloads"] + B["end_to_end"] + \
        B["per_layer"]
    for e in entries:
        assert spec.NAME_RE.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert TEXT_RE.match(e[key]), (e["name"], key)
    for m in B["end_to_end"] + B["per_layer"]:
        assert spec.UNIT_RE.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in B["workloads"]:
        assert spec.NAME_RE.match(w["config"])
        assert spec.NAME_RE.match(w["traffic"])
    for c in B["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(spec.NAME_RE.match(k) for k in c["reduced"])
    groups = [B["configs"], B["workloads"], B["end_to_end"] + B["per_layer"]]
    for g in groups:
        names = [e["name"] for e in g]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(B)) <= 64 * 1024


def test_every_configuration_is_used_and_states_what_it_runs():
    used = {w["config"] for w in B["workloads"]}
    for c in B["configs"]:
        assert c["name"] in used
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert c["file"].startswith(B["paths"][0] + "/")
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert {"parameters", "products"} <= set(cfg["precision"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_are_found_by_name(name):
    cell = spec.find_cell(name, B)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(cell.readers[m["name"]])
    assert set(cell.limits["numbers"])


@pytest.mark.parametrize("name", [c["name"] for c in B["configs"]])
def test_counted_table_matches_the_configuration(name):
    cell = spec.find_cell(next(w["name"] for w in B["workloads"]
                               if w["config"] == name), B)
    cfg = cell.config
    kw = cfg["program"]["kwargs"]["field_cfg"]
    enc = kw.get("encoding_cfg") or kw["surface_cfg"]["encoding_cfg"]
    levels = brick.make_levels(enc["lotd_cfg"]["lod_res"],
                               enc["lotd_cfg"]["lod_types"],
                               enc["hashmap_rows"])
    tab = cfg["counted"]["encoding_table"]
    assert tab == {"levels": len(levels),
                   "rows": sum(lv.n_rows for lv in levels)}


def test_occupied_share_is_the_bands():
    from harness.scene import Scene, band_grid

    for c in B["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        res = cfg["program"]["kwargs"]["accel_cfg"]["resolution"]
        g = band_grid(Scene(cfg["scene"], "cpu"), res,
                      cfg["occupancy"]["band"], "cpu")
        assert float(g.float().mean()) == pytest.approx(
            cfg["occupancy"]["occupied_share"], abs=1e-9)


def test_four_chip_cells_within_the_share():
    four = sum(w["chips"] == 4 for w in B["workloads"])
    assert four <= max(1, len(B["workloads"]) // 4)
