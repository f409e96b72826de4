#!/usr/bin/env python3
"""Instruction census of the port's CUDA kernels (run on a machine with the
CUDA toolkit).

    python3 scripts/sass_census_torch.py [--out FILE]

Builds every library of ``pytorch_volumetric_tpu_torch/csrc`` (as
``ops.cuda_build`` does), disassembles each with ``cuobjdump -sass`` and
counts, per kernel, the static SASS instructions by class: of the whole
kernel and of its hot loop (the longest span closed by a backward branch
that holds no barrier).
The classes say what the loop spends its issue slots on: FP32 arithmetic,
special-function unit (MUFU: reciprocals, square roots, the atan2's
pieces), compares and selects, integer and address arithmetic, memory,
tensor-core products and control.  Static counts of one iteration, not a
dynamic profile.  Prints one JSON line.
"""

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CLASSES = (
    ("fp32", ("FADD", "FMUL", "FFMA", "FMNMX", "FSWZADD", "FRND")),
    ("mufu", ("MUFU",)),
    ("compare_select", ("FSETP", "FSEL", "ISETP", "SEL", "PLOP3", "FCHK", "P2R", "R2P")),
    ("integer", ("IMAD", "IADD3", "LEA", "LOP3", "SHF", "IABS", "I2F", "F2I", "FLO",
                 "IMNMX", "POPC", "PRMT", "MOV", "S2R", "CS2R", "UMOV", "ULDC", "S2UR",
                 "UIADD3", "ULEA", "USHF", "ULOP3", "UIMAD", "VIADD", "IMUL")),
    ("memory", ("LDS", "STS", "LDG", "STG", "LDC", "LD", "ST", "LDL", "STL")),
    ("tensor", ("HMMA",)),
    ("shuffle", ("SHFL",)),
    ("control", ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "BAR", "WARPSYNC",
                 "NOP", "YIELD", "BPT", "JMP")),
)
_CLASS_OF = {op: name for name, ops in CLASSES for op in ops}
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\.[\w.]+)?\s*(.*?);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def classify(op: str) -> str:
    return _CLASS_OF.get(op, "other")


def parse(sass: str):
    """``{function: [(address, opcode, operands)]}`` and
    ``{function: {label: address}}``."""
    funcs, labels, cur, pending = {}, {}, None, []
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :", 1)[1].strip()
            funcs[cur], labels[cur], pending = [], {}, []
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[cur][lab] = addr
            pending = []
            funcs[cur].append((addr, m.group(3), (m.group(4) or "") + " " + m.group(5)))
    return funcs, labels


def hot_loop(insns, labels):
    """The longest [target, branch] span of a backward branch that holds no
    barrier: the per-pair loop inside a tile, not the loop over tiles."""
    best = []
    for addr, op, operands in insns:
        if op != "BRA":
            continue
        tm = re.search(r"(0x[0-9a-f]+)|(\.L_x_\d+)", operands)
        if not tm:
            continue
        target = int(tm.group(1), 16) if tm.group(1) else labels.get(tm.group(2))
        if target is None or target >= addr:
            continue
        span = [i for i in insns if target <= i[0] <= addr]
        if len(span) > len(best) and not any(i[1] == "BAR" for i in span):
            best = span
    return best


def census(insns):
    """Instruction counts by class, and the special functions by kind."""
    by_class = collections.Counter(classify(op) for _, op, _ in insns)
    mufu = collections.Counter(op + rest.split()[0] for _, op, rest in insns
                               if op == "MUFU" and rest.strip())
    return {"total": len(insns), "by_class": dict(by_class), "mufu": dict(mufu)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    from pytorch_volumetric_tpu_torch.ops import cuda_build
    cuda_build.build()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for name in cuda_build.SOURCES:
        sass = subprocess.run([tool, "-sass", cuda_build.library_path(name)],
                              capture_output=True, text=True, check=True).stdout
        funcs, labels = parse(sass)
        for fn, insns in funcs.items():
            loop = hot_loop(insns, labels[fn])
            out[f"{name}:{fn}"] = {"kernel": census(insns), "hot_loop": census(loop)}
    line = json.dumps({"metric": "sass_census", "kernels": out})
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
