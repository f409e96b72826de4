"""A run of each cell on the CPU at the tiny sizes of ``tiny.py``: the result
line, the comparison that decides ``correct`` (passing on the program,
failing on the control and on faults planted in the program), the refusals
of the command."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import control, harness
from portbench.tests.tiny import SEED, tiny_base

CELLS = ("arm7.grid1m.fwdbwd", "arm7.grid15k.fwd", "wrench_free.grid697k.values",
         "arm7.points15k.fwdbwd")
BACKWARD_CELLS = ("arm7.grid1m.fwdbwd", "arm7.points15k.fwdbwd")


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tiny_base(str(tmp_path_factory.mktemp("portbench")))


def run(base, cell, trace=False, seconds=0.3):
    return harness.run_cell(cell, SEED, seconds, trace, device="cpu", base=base)


@pytest.mark.parametrize("cell", CELLS)
def test_run_is_correct_and_its_line_has_the_contract_keys(base, cell):
    line = run(base, cell)
    run_rec = line.pop("_run")
    assert harness.forbidden_modules() == []
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] == run_rec["calls"] > 0 and line["failed"] == 0
    bench = harness.load_benchmark()
    assert set(line["metrics"]) == {m["name"] for m in harness.cell_metrics(bench, cell, False)}
    for m in line["metrics"].values():
        assert m["value"] > 0 and set(m) == {"value", "unit"}
    assert set(line["checks"]) == set(harness.load_limits(cell, base))
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(line, allow_nan=False)


def test_traced_run_reports_the_per_layer_metrics_it_can_read_here(base):
    line = run(base, "arm7.grid1m.fwdbwd", trace=True)
    line.pop("_run")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    assert line["correct"] is True
    # the CPU has no device timeline: only the host's metrics are read
    assert set(line["metrics"]) == {"entry.host_ms_per_call"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _faulty(kind):
    """Wrap the program's union queries so that their answers carry a fault."""
    from pytorch_volumetric_tpu_torch import model_to_sdf, sdf

    def alter(v, g):
        if kind == "answer":            # configuration 0 of every call answers wrong
            v = torch.cat([v[:1] + 0.01, v[1:]])
        elif kind == "half_batch":      # half of the batch left out, the rest repeated
            h = v.shape[0] - v.shape[0] // 2
            v = torch.cat([v[:h], v[:v.shape[0] - h]])
            g = None if g is None else torch.cat([g[:h], g[:g.shape[0] - h]])
        elif kind == "backward":        # the value's derivative dropped
            v = v.detach() + 0.0 * v
        return v, g

    def wrap(fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if isinstance(out, tuple):
                return alter(*out)
            return alter(out, None)[0]
        return wrapped

    return [(sdf, "compose_query_coherent", wrap(sdf.compose_query_coherent)),
            (model_to_sdf, "compose_query", wrap(model_to_sdf.compose_query))]


@pytest.mark.parametrize("cell,kind", [(c, k) for c in CELLS for k in ("answer", "half_batch")]
                         + [(c, "backward") for c in BACKWARD_CELLS])
def test_a_fault_in_the_program_makes_the_run_incorrect(base, cell, kind, monkeypatch):
    for mod, name, fn in _faulty(kind):
        monkeypatch.setattr(mod, name, fn)
    line = run(base, cell)
    assert line["correct"] is False
    assert line["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(base, cell):
    """The reference in TF32 put in the program's place reads as not
    correct (its limits are the cell's own)."""
    out = control.run_control(cell, SEED, "cpu", base=base)
    assert out["correct"] is False, out["checks"]


def test_a_reader_that_imports_jax_stops_the_result(tmp_path, monkeypatch, capsys):
    """The look for JAX comes after every metric's reader: a reader that
    imports a module named in ``FORBIDDEN`` (here a stand-in named ``flax``)
    leaves the run with exit code 3 and no result."""
    from portbench import run as run_mod
    base = tiny_base(str(tmp_path))
    stand_in = tmp_path / "stand_in"
    stand_in.mkdir()
    (stand_in / "flax.py").write_text("")
    monkeypatch.syspath_prepend(str(stand_in))
    with open(os.path.join(base, "metrics", "setup_s.py"), "a") as f:
        f.write("\nimport flax  # noqa: E402,F401\n")
    monkeypatch.setattr(run_mod, "fixed_caches", lambda: None)
    threads = torch.get_num_threads()
    argv = ["--workload", CELLS[1], "--seed", str(SEED), "--seconds", "0.3", "--trace", "0"]
    try:
        assert harness.forbidden_modules() == []
        rc = run_mod.main(argv, device="cpu", base=base)
    finally:
        sys.modules.pop("flax", None)
        torch.set_num_threads(threads)
    assert rc == 3
    assert capsys.readouterr().out == ""
    # with the stand-in gone from sys.modules the same run prints its result
    try:
        rc = run_mod.main(argv, device="cpu", base=base)
    finally:
        torch.set_num_threads(threads)
    assert rc == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["correct"] is True


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[1],
                        "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                       cwd=harness.REPO_DIR, capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout == ""


def test_the_command_refuses_in_a_checkout_without_the_program(tmp_path):
    import shutil
    shutil.copy(os.path.join(harness.REPO_DIR, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[1],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
def test_a_cell_on_the_card_is_correct():
    """One short run of the cheapest cell through the command, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[1],
                        "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
                       cwd=harness.REPO_DIR, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
