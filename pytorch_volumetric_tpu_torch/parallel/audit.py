"""Count the cross-rank collectives a sharded call dispatches.

The sharded forward query is pure data parallelism over (configurations x
points) with replicated tables, so it must dispatch ZERO collectives:
every rank computes its output block from local inputs, and its time does
not depend on the number of ranks.  The collision training step is the
one call that must communicate: the joint gradient and the loss are
partial sums over the point dimension, so it all-reduces and does nothing
else.

Eager PyTorch has no optimized HLO.  :func:`optimized_hlo` runs the call
once under a ``TorchDispatchMode`` and returns the log of the operators it
dispatched, one per line (``%i = name()``), with every ``c10d`` /
``_c10d_functional`` collective under the XLA opcode that moves the same
data (``c10d.allreduce_`` -> ``all-reduce``); :func:`count_collectives`
reads that log.
"""

from __future__ import annotations

import re
from typing import Dict, Sequence

from torch.utils._python_dispatch import TorchDispatchMode

# every cross-device collective opcode, as XLA names them
COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "all-to-all",
    "collective-broadcast",
    "collective-permute",
    "reduce-scatter",
    "ragged-all-to-all",
)

# torch's collective operators (their names in the c10d and
# _c10d_functional namespaces) by the opcode that moves the same data; a
# rooted reduce / gather / scatter counts as its all-to-all form
_TORCH_COLLECTIVES = (
    (re.compile(r"reduce_scatter"), "reduce-scatter"),
    (re.compile(r"all_?reduce|^reduce_|barrier"), "all-reduce"),
    (re.compile(r"all_?gather|^gather_"), "all-gather"),
    (re.compile(r"all_?to_?all"), "all-to-all"),
    (re.compile(r"broadcast|^scatter_"), "collective-broadcast"),
    (re.compile(r"send|recv"), "collective-permute"),
)

_OPCODE_RE = re.compile(
    r"^%\d+ = (" + "|".join(re.escape(op) for op in COLLECTIVE_OPS) + r")\(", re.M)


def _opcode(func) -> str:
    namespace, _, name = str(func).partition(".")
    if namespace in ("c10d", "_c10d_functional"):
        for pattern, opcode in _TORCH_COLLECTIVES:
            if pattern.search(name):
                return opcode
    return str(func)


class _DispatchLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.lines = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.lines.append(f"%{len(self.lines)} = {_opcode(func)}({func})")
        return func(*args, **(kwargs or {}))


def count_collectives(hlo_text: str) -> Dict[str, int]:
    """Histogram of collective opcodes in a log from :func:`optimized_hlo`
    (one per dispatched collective)."""
    counts: Dict[str, int] = {}
    for match in _OPCODE_RE.finditer(hlo_text):
        op = match.group(1)
        counts[op] = counts.get(op, 0) + 1
    return counts


def optimized_hlo(fn, *example_args) -> str:
    """The operators one call of a sharded callable dispatches, one per
    line, collectives under their XLA opcodes.  The call runs once on
    ``example_args`` (a training step updates its state): through
    ``fn.program`` with the tables of ``fn.extra_args`` as arguments, as
    ``parallel.sharding`` builds them, or ``fn`` itself."""
    program = getattr(fn, "program", fn)
    extra = tuple(getattr(fn, "extra_args", ()))
    with _DispatchLog() as log:
        program(*example_args, *extra)
    return "\n".join(log.lines)


def audit_sharded_callable(fn, *example_args) -> Dict[str, int]:
    """Collective histogram of one call of a sharded callable."""
    return count_collectives(optimized_hlo(fn, *example_args))


def assert_collectives(counts: Dict[str, int],
                       allowed: Sequence[str] = (),
                       require: Sequence[str] = ()) -> None:
    """Raise AssertionError unless ``counts`` only contains ``allowed``
    opcodes and contains every ``require`` opcode at least once."""
    extra = {op: n for op, n in counts.items() if op not in allowed}
    assert not extra, (
        f"unexpected cross-rank collectives in the call: {extra} "
        f"(allowed: {list(allowed)}) — a scaling regression: the sharded "
        f"forward must stay communication-free")
    missing = [op for op in require if counts.get(op, 0) == 0]
    assert not missing, (
        f"expected collectives missing from the call: {missing} "
        f"(found only {counts}) — the gradient all-reduce disappeared")
