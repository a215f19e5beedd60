#!/usr/bin/env python3
"""Static SASS instruction mix of the port's CUDA kernels.

    python3 tools/sass_mix.py [STEM ...]

Builds the kernels as the port does at first use, disassembles each library
(``src/repro_torch/kernels/csrc/<STEM>.cu``, default ``sinkhorn_step``) with
the CUDA toolkit's ``cuobjdump -sass``, and prints one JSON line a kernel:
its static instruction count, the count in each class below, and its IEEE
division sites (``FCHK`` in f32, ``MUFU.RCP64H`` in f64): one for each
element that an unrolled pass of its loop divides.  Static counts include
the prologue, the epilogue and the slow paths that the hot loop does not
take, so instructions over division sites bound the instructions an element
from above.  For kernels without a division (the Dykstra half-sweep) it
also prints the instructions of the kernel's longest loop (the span of its
longest backward branch, "main_loop_instructions"): one pass of the main
loop, to divide by the values a thread takes a pass.  Needs the CUDA
toolkit, not a card.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

CLASSES = {
    "fp64": {"DFMA", "DADD", "DMUL", "DSETP", "DMNMX"},
    "fp32": {"FFMA", "FADD", "FMUL", "FSETP", "FMNMX", "FSEL", "FCHK",
             "HFMA2"},
    "mufu": {"MUFU"},
    "memory": {"LDG", "STG", "LDS", "STS", "LDGSTS", "LDGDEPBAR", "DEPBAR",
               "SHFL", "LD", "ST"},
    "branch_sync": {"BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "BAR",
                    "WARPSYNC", "NOP", "BMOV"},
}
INSTR = re.compile(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
                   r"((?:\.[A-Z0-9_]+)*)")
BRANCH = re.compile(r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?BRA\s+(?:`\(\.L_x_\d+\)|"
                    r"0x([0-9a-f]+))")


def longest_loop(body: str) -> int:
    """Instructions spanned by the longest backward branch (16 bytes an
    instruction), 0 without one."""
    spans = [(int(at, 16) - int(to, 16)) // 16 + 1
             for at, to in BRANCH.findall(body)
             if to and int(to, 16) < int(at, 16)]
    return max(spans, default=0)


def mix(sass: str):
    """Yield (mangled kernel name, Counter of opcodes, division sites,
    longest loop)."""
    for section in re.split(r"\n\s+Function : ", sass)[1:]:
        name, body = section.split("\n", 1)
        ops, divisions = Counter(), 0
        for op, mods in INSTR.findall(body):
            ops[op] += 1
            divisions += op == "FCHK" or (op == "MUFU" and ".RCP64H" in mods)
        yield name.strip(), ops, divisions, longest_loop(body)


def main() -> int:
    from repro_torch.kernels import build

    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    libs = build.build_all()
    for stem in sys.argv[1:] or ["sinkhorn_step"]:
        sass = subprocess.run([str(cuobjdump), "-sass", str(libs[stem])],
                              capture_output=True, text=True, check=True,
                              timeout=600).stdout
        for name, ops, divisions, loop in mix(sass):
            total = sum(ops.values())
            row = {"library": stem, "kernel": build.kernel_name(name),
                   "instructions": total}
            for cls, names in CLASSES.items():
                row[cls] = sum(ops[o] for o in names)
            row["integer_move_other"] = total - sum(row[c]
                                                    for c in CLASSES)
            row["division_sites"] = divisions
            row["per_division_site"] = (total / divisions if divisions
                                        else None)
            row["main_loop_instructions"] = loop
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
