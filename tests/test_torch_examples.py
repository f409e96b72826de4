"""Smoke tests of the port's four examples (``examples/torch_*.py``, the
twins of ``tests/test_examples.py``'s): each runs end to end as a
subprocess on the CPU under ``PVT_EXAMPLE_SMOKE=1`` (small sizes, the same
code paths), so the examples cannot silently rot."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES_DIR = os.path.join(REPO, "examples")


@pytest.mark.parametrize("script", ["torch_trajectory_optimization.py",
                                    "torch_pose_estimation.py",
                                    "torch_neural_distillation.py",
                                    "torch_serving_export.py"])
def test_example_runs(script):
    env = dict(os.environ)
    env["PVT_EXAMPLE_SMOKE"] = "1"
    # the suite runs in parallel workers: a subprocess taking every core
    # for its plain sweep would oversubscribe them
    env.setdefault("OMP_NUM_THREADS", "2")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    p = subprocess.run([sys.executable, os.path.join(EXAMPLES_DIR, script), "--device", "cpu"],
                       capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert p.returncode == 0, f"{script} failed:\n{p.stdout}\n{p.stderr}"
