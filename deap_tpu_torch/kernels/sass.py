"""Count a kernel's inner-loop instructions from its compiled SASS.

    python -m deap_tpu_torch.kernels.sass [--out DIR]

Builds the kernel library (:mod:`deap_tpu_torch.kernels.build`), runs
``cuobjdump -sass`` on it and, for every entry of :data:`KERNELS`, takes
the function whose mangled name holds the entry's name and finds its
inner loop by the entry's marker opcode:

* K4 at m = 3: the backward branch with the shortest address range
  holding ``FSETP``; it tests ``FSETP / 2m`` pairs per iteration (a
  dominance test needs ``2m`` compares);
* K5 in float32 and float64: among the innermost loops (backward
  branches whose range holds no other backward branch) holding the
  fused multiply-add of a pair step (``FFMA`` / ``DFMA``), the one
  holding the most — the unrolled sweep over a tile, not its remainder
  loop; one FMA is one pair step of one prefix.

And, for P5's token loop (not unrolled) in each mode, how its switch
compiled (:data:`DISPATCH`): the whole function's branches (``BRA``,
``BRX``), selects (``FSEL``, ``SEL``) and ``FFMA`` with the distinct
float immediates they multiply by — nine scales mean nine case bodies.

Prints one JSON object per kernel, each on a line: the loop's opcodes
with their counts, the pairs per iteration and each opcode's count per
pair.  With ``--out`` each function's whole SASS, predicate guards
included, is written there too.  Needs the CUDA toolkit (``nvcc`` and
``cuobjdump``), so it runs on the machine with the card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from collections import Counter
from pathlib import Path

from .build import KernelBuildError, build, nvcc_path

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                    r"([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")
#: label -> (mangled-name part, marker opcode, markers per pair, rule)
KERNELS = {
    "K4": ("rows_dominate_counts_kernelILi3E", "FSETP", 6, "shortest"),
    "K5_f32": ("hv3d_sweep_kernelIfE", "FFMA", 1, "most"),
    "K5_f64": ("hv3d_sweep_kernelIdE", "DFMA", 1, "most"),
}
#: label -> mangled-name part of P5's token loop, not unrolled
DISPATCH = {
    "P5_noswitch": "probe_gp_kernelILi0ELb0E",
    "P5_dispatch": "probe_gp_kernelILi1ELb0E",
    "P5_stackrw": "probe_gp_kernelILi2ELb0E",
}
_FLOAT_IMM = re.compile(r"\b(0x3f8[0-9a-f]{5}|1\.0000\d*)\b", re.I)


def functions(sass: str) -> dict:
    """``{mangled name: [(address, opcode, operands, guard), ...]}``;
    ``guard`` is the predicate (``@P0``, ``@!P1``) or ``""``."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
        elif name is not None:
            m = _INSTR.search(line)
            if m:
                out[name].append((int(m.group(1), 16), m.group(3),
                                  m.group(4).strip(),
                                  (m.group(2) or "").strip()))
    return out


def _loops(instrs, marker: str):
    """``(markers, innermost, body)`` of every backward-branch range
    holding an instruction whose opcode starts with ``marker``;
    ``innermost`` says that the range holds no other backward branch."""
    spans = []
    for addr, op, args, _ in instrs:
        t = _TARGET.search(args)
        lo = int(t.group(1), 16) if t is not None else addr + 1
        if op.startswith("BRA") and lo <= addr:
            spans.append((lo, addr))
    out = []
    for lo, hi in spans:
        body = [i for i in instrs if lo <= i[0] <= hi]
        hits = sum(i[1].startswith(marker) for i in body)
        inner = not any(lo <= b <= hi for a, b in spans if (a, b) != (lo, hi))
        if hits:
            out.append((hits, inner, body))
    return out


def inner_loop(instrs, marker: str = "FSETP", rule: str = "shortest"):
    """The instructions of the inner loop holding ``marker``, or
    ``None``: the shortest such backward-branch range, or
    (``rule="most"``) the innermost one with the most markers."""
    loops = _loops(instrs, marker)
    if not loops:
        return None
    if rule == "most":
        loops = [l for l in loops if l[1]] or loops
        top = max(l[0] for l in loops)
        loops = [l for l in loops if l[0] == top]
    return min((l[2] for l in loops), key=len)


def _function(kernel: str, sass_funcs: dict, out_dir=None):
    """``(name, instructions)`` of the one function whose mangled name
    holds ``kernel``; its SASS is written to ``out_dir`` when given."""
    funcs = {k: v for k, v in sass_funcs.items() if kernel in k}
    if len(funcs) != 1:
        raise SystemExit(f"{len(funcs)} functions match {kernel!r}: "
                         f"{sorted(funcs)}")
    (name, instrs), = funcs.items()
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"sass_{kernel}.txt").write_text("\n".join(
            f"{a:06x}  {g:>5} {o} {r}" for a, o, r, g in instrs) + "\n")
    return name, instrs


def report(label: str, sass_funcs: dict, out_dir=None) -> dict:
    """The inner-loop instruction counts of one entry of
    :data:`KERNELS`."""
    kernel, marker, per_pair, rule = KERNELS[label]
    name, instrs = _function(kernel, sass_funcs, out_dir)
    loop = inner_loop(instrs, marker, rule)
    if loop is None:
        raise SystemExit(f"no loop with {marker} in {name}")
    ops = Counter(i[1] for i in loop)
    pairs = sum(c for o, c in ops.items() if o.startswith(marker)) / per_pair
    return {
        "kernel": label, "function": name, "instructions": len(instrs),
        "loop": [hex(loop[0][0]), hex(loop[-1][0])],
        "loop_instructions": len(loop), "opcodes": dict(ops.most_common()),
        "pairs_per_iteration": pairs,
        "per_pair": {o: c / pairs for o, c in ops.most_common()},
        "per_pair_total": len(loop) / pairs}


def dispatch_report(label: str, sass_funcs: dict, out_dir=None) -> dict:
    """How one entry of :data:`DISPATCH` compiled its switch: branches,
    selects and the ``FFMA`` scales of the whole function."""
    name, instrs = _function(DISPATCH[label], sass_funcs, out_dir)
    ops = Counter(o.split(".")[0] for _, o, _, _ in instrs)
    scales = sorted({m.group(1).lower() for _, o, r, _ in instrs
                     if o.startswith("FFMA") for m in _FLOAT_IMM.finditer(r)})
    return {"kernel": label, "function": name, "instructions": len(instrs),
            "branches": ops["BRA"] + ops["BRX"], "indexed_branches": ops["BRX"],
            "selects": ops["FSEL"] + ops["SEL"], "ffma": ops["FFMA"],
            "ffma_scales": scales, "opcodes": dict(ops.most_common())}


def disassemble() -> dict:
    """Build the library and return :func:`functions` of its SASS."""
    lib = build()
    tool = Path(nvcc_path()).with_name("cuobjdump")
    proc = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise KernelBuildError(f"cuobjdump failed: {proc.stderr}")
    return functions(proc.stdout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    funcs = disassemble()
    for label in KERNELS:
        print(json.dumps(report(label, funcs, args.out)))
    for label in DISPATCH:
        print(json.dumps(dispatch_report(label, funcs, args.out)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
