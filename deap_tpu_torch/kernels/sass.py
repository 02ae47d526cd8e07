"""Count a kernel's inner-loop instructions from its compiled SASS.

    python -m deap_tpu_torch.kernels.sass [--out DIR]

Builds the kernel library (:mod:`deap_tpu_torch.kernels.build`), runs
``cuobjdump -sass`` on it, takes K4 at m = 3 (the function whose mangled
name holds :data:`KERNEL`), and finds its innermost loop that compares
floats: the backward branch with the shortest address range holding
``FSETP`` instructions.  Prints one JSON object: the loop's opcodes
with their counts, the pairs it tests per iteration (its ``FSETP``
count over the ``2m`` compares a dominance test needs) and each
opcode's count per pair.  With ``--out`` the function's whole SASS,
predicate guards included, is written there too.  Needs the CUDA
toolkit (``nvcc`` and ``cuobjdump``), so it runs on the machine with
the card.
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
KERNEL, NOBJ = "rows_dominate_counts_kernelILi3E", 3


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


def innermost_compare_loop(instrs):
    """The instructions of the shortest backward-branch range that holds
    an ``FSETP``, or ``None``."""
    best = None
    for addr, op, args, _ in instrs:
        t = _TARGET.search(args)
        lo = int(t.group(1), 16) if t is not None else addr + 1
        if not op.startswith("BRA") or lo > addr:
            continue
        body = [i for i in instrs if lo <= i[0] <= addr]
        if any(i[1].startswith("FSETP") for i in body) and (
                best is None or len(body) < len(best)):
            best = body
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    lib = build()
    tool = Path(nvcc_path()).with_name("cuobjdump")
    proc = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise KernelBuildError(f"cuobjdump failed: {proc.stderr}")
    funcs = {k: v for k, v in functions(proc.stdout).items()
             if KERNEL in k}
    if len(funcs) != 1:
        raise SystemExit(f"{len(funcs)} functions match {KERNEL!r}: "
                         f"{sorted(funcs)}")
    (name, instrs), = funcs.items()
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / f"sass_{KERNEL}.txt").write_text("\n".join(
            f"{a:06x}  {g:>5} {o} {r}" for a, o, r, g in instrs) + "\n")
    loop = innermost_compare_loop(instrs)
    if loop is None:
        raise SystemExit(f"no loop with FSETP in {name}")
    ops = Counter(i[1] for i in loop)
    fsetp = sum(c for o, c in ops.items() if o.startswith("FSETP"))
    pairs = fsetp / (2 * NOBJ)
    print(json.dumps({
        "function": name, "instructions": len(instrs),
        "loop": [hex(loop[0][0]), hex(loop[-1][0])],
        "loop_instructions": len(loop), "opcodes": dict(ops.most_common()),
        "pairs_per_iteration": pairs,
        "per_pair": {o: c / pairs for o, c in ops.most_common()},
        "per_pair_total": len(loop) / pairs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
