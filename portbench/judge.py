"""The comparison that decides ``correct``.

Every call of the window keeps, right after it returns, its answers at
sample positions drawn from the seed (``workload.Inputs``) and, with a
backward, its d/dq.  Once the window has closed and the program's state is
freed, the reference works out what each sampled answer may be, and every
kept answer of every call is held to it:

- ``value_gap_m``: the largest distance of a value from the reference's
  admissible interval (metres);
- ``grad_gap``: the largest component gap of a gradient, where the
  reference's gradient is settled;
- ``dq_gap``: the largest gap of a d/dq component beyond the reference's
  rounding slack, over that configuration's largest |d/dq|.

A NaN or an infinity in an answer reads as an infinite gap.  A number
passes when it is at most its limit (``limits/<cell>.json``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def _worst(x: torch.Tensor) -> float:
    if x.numel() == 0:
        return 0.0
    x = torch.where(torch.isnan(x), torch.full_like(x, float("inf")), x)
    return float(x.max())


def call_gaps(rec: dict, exp: dict, dq_ref: Dict[int, Tuple[torch.Tensor, torch.Tensor]],
              chunk: int) -> Dict[str, float]:
    """One call's numbers: ``rec`` its kept answers (``v [S]``, ``g [S, 3]``
    or None, ``dq [C, dof]`` or None, chunk ``k``), ``exp`` the reference's
    admissible answers at the same positions, ``dq_ref`` the reference's
    ``(dq, slack)`` by configuration index in the batch."""
    v = rec["v"].double()
    v = torch.where(torch.isfinite(v), v, torch.full_like(v, float("nan")))
    out = {"value_gap_m": _worst(torch.clamp(torch.maximum(exp["lo"] - v, v - exp["hi"]), min=0))}
    if rec.get("g") is not None:
        g = rec["g"].double()
        gap = (g - exp["g"]).abs().amax(-1)
        gap = torch.where(torch.isfinite(g).all(-1), gap, torch.full_like(gap, float("nan")))
        out["grad_gap"] = _worst(gap[exp["g_ok"]])
    if rec.get("dq") is not None:
        worst = 0.0
        k0 = rec["k"] * chunk
        for i, (ref, slack) in dq_ref.items():
            if k0 <= i < k0 + chunk:
                d = rec["dq"][i - k0].double()
                gap = torch.clamp((d - ref).abs() - slack, min=0) / ref.abs().max().clamp(min=1e-30)
                worst = max(worst, _worst(gap))
        out["dq_gap"] = worst
    return out


def judge(records: List[dict], expected: dict, dq_expected: dict, chunk: int,
          limits: Dict[str, float]) -> Tuple[bool, int, Dict[str, dict]]:
    """``(correct, failed calls, checks)``: ``checks`` holds each number
    (its worst over every call) beside its limit."""
    worst: Dict[str, float] = {}
    failed = 0
    for rec in records:
        gaps = call_gaps(rec, expected[(rec["b"], rec["k"])], dq_expected.get(rec["b"], {}), chunk)
        if any(not (x <= limits[name]) for name, x in gaps.items()):
            failed += 1
        for name, x in gaps.items():
            worst[name] = max(worst.get(name, 0.0), x) if not math.isnan(x) else float("inf")
    checks = {name: {"value": worst.get(name, float("inf")), "limit": limit}
              for name, limit in limits.items()}
    correct = bool(records) and failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    return correct, failed, checks
