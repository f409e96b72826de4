#!/usr/bin/env python3
"""Instruction census of the port's CUDA kernels (run on a machine with the
CUDA toolkit).

    python3 scripts/sass_census_torch.py [--out FILE] [--dump DIR]

Builds every library of ``pytorch_volumetric_tpu_torch/csrc`` (as
``ops.cuda_build`` does), disassembles each with ``cuobjdump -sass`` and
counts, per kernel, the static SASS instructions by class: of the whole
kernel and of each innermost loop (a span closed by a backward branch that
holds no other loop, and no barrier unless it issues tensor-core products),
labelled by what it computes.
The classes say what the loop spends its issue slots on: FP32 arithmetic,
special-function unit (MUFU: reciprocals, square roots, the atan2's
pieces), compares and selects, integer and address arithmetic, memory,
tensor-core products and control.  Static counts of one iteration, not a
dynamic profile; ``pairs_per_iteration`` says how many pairs one iteration
of a thread covers.  Prints one JSON line.
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
    ("tensor", ("HMMA", "HGMMA")),
    ("shuffle", ("SHFL",)),
    ("control", ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "BAR", "WARPSYNC",
                 "NOP", "YIELD", "BPT", "JMP", "WARPGROUP", "DEPBAR")),
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


def loops(insns, labels):
    """The innermost loops: each [target, branch] span of a backward branch
    that holds no other backward branch, and no barrier unless it issues
    tensor-core products, in address order.  In the sweep kernel these are
    its per-pair loops (closest point and solid angle, closest point only,
    solid angle only), not the loops over clusters and tiles around them;
    in the tensor-core sweep, its loop over a tile's groups (one product
    step, whose barrier shares the warpgroup's decision to issue it)."""
    spans = []
    for addr, op, operands in insns:
        if op != "BRA":
            continue
        tm = re.search(r"(0x[0-9a-f]+)|(\.L_x_\d+)", operands)
        if not tm:
            continue
        target = int(tm.group(1), 16) if tm.group(1) else labels.get(tm.group(2))
        if target is not None and target < addr:
            spans.append((target, addr))
    inner = [(t, a) for t, a in spans
             if not any(t <= t2 and a2 < a for t2, a2 in spans if (t2, a2) != (t, a))]
    out = []
    for t, a in sorted(inner):
        span = [i for i in insns if t <= i[0] <= a]
        if not any(i[1] == "BAR" for i in span) or any(classify(i[1]) == "tensor"
                                                        for i in span):
            out.append(span)
    return out


def loop_kind(span) -> str:
    """What a sweep loop computes, from its instructions: the closest
    point's two IEEE divisions (two FCHK; the atan2 has one) and the solid
    angle's square roots (MUFU.RSQ)."""
    ops = collections.Counter(op + rest.split()[0] if op == "MUFU" and rest.strip() else op
                              for _, op, rest in span)
    kind = [k for k, hit in (("closest", ops["FCHK"] >= 2),
                             ("winding", ops["MUFU.RSQ"] > 0)) if hit]
    return "+".join(kind) or "other"


def pairs_per_iteration(fn: str) -> int:
    """(point, triangle) pairs a thread handles in one iteration of a sweep
    loop: one in K1's per-pair loops; four in the tensor-core sweep's group
    loop (two points x two faces of the accumulator fragment), whose static
    count holds every path of the step (closest point, the solid angle from
    the products and from the direct forms)."""
    return 4 if "sweep_mma_kernel" in fn else 1


def template_args(fn: str) -> dict:
    """``kWinding`` of a sweep kernel instantiation, from its mangled name
    (``...closest_point_sweep_kernelILb1EE...``)."""
    m = re.search(r"sweep_kernelILb([01])E", fn)
    return {"winding": m.group(1) == "1"} if m else {}


def census(insns):
    """Instruction counts by class, and the special functions by kind."""
    by_class = collections.Counter(classify(op) for _, op, _ in insns)
    mufu = collections.Counter(op + rest.split()[0] for _, op, rest in insns
                               if op == "MUFU" and rest.strip())
    return {"total": len(insns), "by_class": dict(by_class), "mufu": dict(mufu)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="")
    ap.add_argument("--dump", default="",
                    help="a directory to write each library's disassembly to")
    args = ap.parse_args()
    from pytorch_volumetric_tpu_torch.ops import cuda_build
    cuda_build.build()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for name in cuda_build.SOURCES:
        sass = subprocess.run([tool, "-sass", cuda_build.library_path(name)],
                              capture_output=True, text=True, check=True).stdout
        if args.dump:
            os.makedirs(args.dump, exist_ok=True)
            with open(os.path.join(args.dump, f"{name}.sass"), "w") as f:
                f.write(sass)
        funcs, labels = parse(sass)
        for fn, insns in funcs.items():
            found = [dict(census(span), kind=loop_kind(span),
                          pairs_per_iteration=pairs_per_iteration(fn))
                     for span in loops(insns, labels[fn])]
            out[f"{name}:{fn}"] = {"kernel": census(insns), **template_args(fn),
                                   "loops": found}
    line = json.dumps({"metric": "sass_census", "kernels": out})
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
