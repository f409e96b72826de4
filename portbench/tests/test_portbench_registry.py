"""``BENCHMARK.json`` against the contract the checker holds it to, the
harness finding a cell's files by name, and a new configuration, mix, cell
and metric picked up as new files with no file edited."""

import json
import os
import re
import shutil

import pytest

from portbench import harness, plugins, workload
from portbench.reference import link_kind
from portbench.tests.tiny import SEED, tiny_base

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    return harness.load_benchmark()


def test_benchmark_json_keeps_the_contract():
    b = bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs", "workloads",
                       "end_to_end", "per_layer"]
    assert b["paths"] == ["portbench"] and b["command"][:2] == ["python3", "-m"]
    assert 1 <= b["run_seconds"] <= 51
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(harness.REPO_DIR, c["file"]))
        assert harness.load_config(c["name"])["reduced"] == c["reduced"]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
        reported = harness.cell_metrics(b, w["name"], False)
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert harness.cell_metrics(b, w["name"], True)
    assert len(json.dumps(b)) <= 64 * 1024


def test_every_cell_and_metric_is_found_by_name():
    b = bench()
    for w in b["workloads"]:
        cell = harness.find_cell(b, w["name"])
        cfg, mix = harness.load_config(cell["config"]), harness.load_mix(cell["traffic"])
        assert cfg["name"] == cell["config"]
        assert callable(plugins.load("entries", mix["entry"]).call)
        assert callable(plugins.load("robots", cfg["robot"]["kind"]).write)
        kind = plugins.load("links", link_kind(cfg["links"]))
        assert callable(kind.program_link_cls) and callable(kind.Table)
        assert harness.load_limits(w["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def test_files_under_paths_are_named_from_name_characters():
    for root, _, files in os.walk(harness.BENCH_DIR):
        if "__pycache__" in root:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), harness.REPO_DIR)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_a_new_config_mix_cell_and_metric_are_new_files(tmp_path):
    """A later change adds files only: here a tighter arm, a smaller grid
    mix, its cell, its limits and a metric, read by the same harness."""
    base = tiny_base(str(tmp_path))
    before = {p: open(os.path.join(base, p), "rb").read()
              for p in ("configs/arm7.json", "mixes/grid15k.fwd.json")}
    cfg = json.load(open(os.path.join(base, "configs/arm7.json")))
    cfg.update(name="arm7tight")
    cfg["links"]["padding"] = 0.1
    json.dump(cfg, open(os.path.join(base, "configs/arm7tight.json"), "w"))
    mix = json.load(open(os.path.join(base, "mixes/grid15k.fwd.json")))
    mix["configs"] = mix["chunk"] = 4
    json.dump(mix, open(os.path.join(base, "mixes/grid15k.fwd.n4.json"), "w"))
    shutil.copy(os.path.join(base, "limits/arm7.grid15k.fwd.json"),
                os.path.join(base, "limits/arm7tight.grid15k.fwd.n4.json"))
    with open(os.path.join(base, "metrics/entry.calls.py"), "w") as f:
        f.write("def read(run):\n    return float(run['calls'])\n")
    b = bench()
    b["configs"].append({"name": "arm7tight", "source": "x", "file": "f", "reduced": [],
                         "why": "y"})
    b["workloads"].append({"name": "arm7tight.grid15k.fwd.n4", "config": "arm7tight",
                           "traffic": "grid15k.fwd.n4", "chips": 1, "why": "z"})
    b["end_to_end"].append({"name": "entry.calls", "unit": "calls", "better": "higher",
                            "bound": 0.05, "source": "host_clock",
                            "workloads": ["arm7tight.grid15k.fwd.n4"]})
    line = harness.run_cell("arm7tight.grid15k.fwd.n4", SEED, 0.3, False, device="cpu",
                            bench=b, base=base)
    assert line["correct"] is True
    assert line["metrics"]["entry.calls"]["value"] == line["attempted"]
    assert set(line["metrics"]) == {"queries_per_s", "setup_s", "entry.calls"}
    for p, data in before.items():
        assert open(os.path.join(base, p), "rb").read() == data


@pytest.mark.parametrize("kind", ["entries", "robots", "meshes", "links", "metrics"])
def test_a_new_kind_is_a_new_file(tmp_path, kind):
    """Each kind of code is found by name under the benchmark's folder."""
    base = tiny_base(str(tmp_path))
    os.makedirs(os.path.join(base, kind), exist_ok=True)
    with open(os.path.join(base, kind, "probe.py"), "w") as f:
        f.write("MARK = 'new'\n")
    assert plugins.load(kind, "probe", base).MARK == "new"
    with pytest.raises(KeyError):
        plugins.load(kind, "absent", base)


def test_a_new_object_and_entry_are_new_files(tmp_path):
    """A free object with a mesh kind of its own, queried through an entry
    of its own, both new files, proves correct with the harness unchanged."""
    base = tiny_base(str(tmp_path))
    with open(os.path.join(base, "meshes", "tetra.py"), "w") as f:
        f.write("import numpy as np\n\n\ndef make(size):\n"
                "    v = size * np.array([[0., 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])\n"
                "    return v, np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]],"
                " dtype=np.int32)\n")
    with open(os.path.join(base, "entries", "query_grid_values.py"), "w") as f:
        f.write("def call(robot, mix, q, inputs):\n"
                "    return robot.query_grid(q, mix['grid']['range'], mix['grid']['resolution'],"
                " values_only=True)\n")
    cfg = json.load(open(os.path.join(base, "configs/wrench_free.json")))
    cfg.update(name="tetra_free")
    cfg["robot"].update(object_name="tetra", mesh={"kind": "tetra", "size": 0.1})
    json.dump(cfg, open(os.path.join(base, "configs/tetra_free.json"), "w"))
    mix = json.load(open(os.path.join(base, "mixes/grid697k.values.json")))
    mix["entry"] = "query_grid_values"
    json.dump(mix, open(os.path.join(base, "mixes/grid697k.values2.json"), "w"))
    shutil.copy(os.path.join(base, "limits/wrench_free.grid697k.values.json"),
                os.path.join(base, "limits/tetra_free.grid697k.values2.json"))
    assert workload.make_mesh({"kind": "tetra", "size": 0.1}, base)[1].shape == (4, 3)
    b = bench()
    b["workloads"].append({"name": "tetra_free.grid697k.values2", "config": "tetra_free",
                           "traffic": "grid697k.values2", "chips": 1, "why": "z"})
    line = harness.run_cell("tetra_free.grid697k.values2", SEED, 0.3, False, device="cpu",
                            bench=b, base=base)
    assert line["correct"] is True and line["attempted"] > 0
