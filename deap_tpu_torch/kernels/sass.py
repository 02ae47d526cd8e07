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

And, for P5's token loop in each mode, not unrolled and unrolled
(:data:`DISPATCH`), how its switch compiled: the whole function's
instructions, branches (``BRA``, ``BRX``), selects (``FSEL``, ``SEL``)
and ``FFMA`` with the distinct branch scales they multiply by, and its
case bodies (a basic block holding an ``FFMA`` by a branch scale)
counted by their ``FFMA``, ``FADD``, ``LDS`` and ``STS``: eight float
operations a body, one for each of a lane's eight points, show that no
tree is computed once and broadcast, and a shared access in every
``stackrw`` body, a load in the even (read) ones and a store in the odd
(write) ones, that its stack row stays a memory access.

And, for P2 and P1's reduce (:data:`NORMALS`), their loop's
instructions an element (four a 16-byte store: P2's to global memory,
the reduce's terms to shared memory): float64 operations,
conversions, selects and branches, calls included.  The reduce's loop
is the fast path's: a warp holding an input outside the branch-free
cosine's range calls the general one, out of the loop.

And, for P3 (:data:`LOOKUP`), its loop's loads and stores and the
loads in flight a thread: those issued before any instruction reads a
register one of them loads.

Prints one JSON object per kernel, each on a line, with its registers a
thread (``cuobjdump --dump-resource-usage``): the loop's opcodes
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
#: label -> mangled-name part of P5's token loop, not unrolled and
#: unrolled over 63 tokens
DISPATCH = {
    "P5_noswitch": "probe_gp_kernelILi0ELb0E",
    "P5_dispatch": "probe_gp_kernelILi1ELb0E",
    "P5_stackrw": "probe_gp_kernelILi2ELb0E",
    "P5_noswitch_unroll63": "probe_gp_kernelILi0ELb1E",
    "P5_dispatch_unroll63": "probe_gp_kernelILi1ELb1E",
    "P5_stackrw_unroll63": "probe_gp_kernelILi2ELb1E",
}
#: a branch scale as an FFMA's multiplier: 1 (branch 0) or just above it
_SCALE = re.compile(r"1(\.0000\d*)?|0x3f8[0-9a-f]{5}", re.I)
#: label -> (mangled-name part, the 16-byte store, four elements each)
NORMALS = {"P2": ("hash_normal_kernel", "STG"),
           "P1_reduce": ("rast_kernel", "STS")}
#: label -> mangled-name part of P3's kernel
LOOKUP = {"P3": "lookup_kernel"}
_REG = re.compile(r"\bR(\d+)\b")
#: opcodes that end a basic block
_CONTROL = {"BRA", "BRX", "JMP", "JMX", "EXIT", "RET", "CALL", "BREAK",
            "BSYNC"}
_CONVERSIONS = ("F2F", "F2I", "I2F", "F2FP", "I2FP")


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


def dispatch_report(label: str, sass_funcs: dict, out_dir=None,
                    regs=None) -> dict:
    """How one entry of :data:`DISPATCH` compiled its switch: branches,
    selects and the ``FFMA`` scales of the whole function, and its case
    bodies (:func:`case_bodies`) counted by their shape: how many bodies
    hold so many ``FFMA``, ``FADD``, ``LDS`` and ``STS``."""
    name, instrs = _function(DISPATCH[label], sass_funcs, out_dir)
    ops = Counter(o.split(".")[0] for _, o, _, _ in instrs)
    scales = sorted({_scale(o, r) for _, o, r, _ in instrs} - {None})
    bodies = case_bodies(instrs)
    shapes = Counter((b["ffma"], b["fadd"], b["lds"], b["sts"])
                     for b in bodies)
    return {"kernel": label, "function": name,
            "registers": (regs or {}).get(name), "instructions": len(instrs),
            "branches": ops["BRA"] + ops["BRX"], "indexed_branches": ops["BRX"],
            "selects": ops["FSEL"] + ops["SEL"], "ffma": ops["FFMA"],
            "ffma_scales": scales, "case_bodies": len(bodies),
            "body_shapes": [{"ffma": f, "fadd": a, "lds": l, "sts": st,
                             "bodies": n}
                            for (f, a, l, st), n in sorted(shapes.items())],
            "opcodes": dict(ops.most_common())}


def basic_blocks(instrs):
    """``instrs`` cut into basic blocks: after every control instruction
    and before every address a branch names (an indexed branch's targets
    follow the bodies' closing branches)."""
    targets = {int(t.group(1), 16) for _, o, r, _ in instrs
               if o.split(".")[0] in {"BRA", "JMP", "CALL", "BSSY"}
               for t in [_TARGET.search(r)] if t is not None}
    out, cur = [], []
    for ins in instrs:
        if cur and ins[0] in targets:
            out.append(cur)
            cur = []
        cur.append(ins)
        if ins[1].split(".")[0] in _CONTROL:
            out.append(cur)
            cur = []
    return out + ([cur] if cur else [])


def _scale(op: str, args: str):
    """The multiplier of an ``FFMA`` when it is a branch scale, else
    ``None``."""
    parts = [a.strip() for a in args.split(",")]
    if op.startswith("FFMA") and len(parts) == 4 and _SCALE.fullmatch(
            parts[2]):
        return parts[2].lower()
    return None


def case_bodies(instrs) -> list:
    """Each basic block holding an ``FFMA`` by a branch scale: its scales
    and its ``FFMA``, ``FADD``, ``LDS`` and ``STS`` counts."""
    out = []
    for block in basic_blocks(instrs):
        scales = sorted({_scale(o, r) for _, o, r, _ in block} - {None})
        if scales:
            ops = Counter(o.split(".")[0] for _, o, _, _ in block)
            out.append({"scales": scales, **{k.lower(): ops[k] for k in (
                "FFMA", "FADD", "LDS", "STS")}})
    return out


def normals_report(label: str, sass_funcs: dict, out_dir=None,
                   regs=None) -> dict:
    """A loop of :data:`NORMALS` (the innermost backward branch holding
    its 16-byte stores, four elements each: P2's to global memory, the
    reduce's terms to shared memory) counted an element; a kernel without
    one (the reduce, a block a tile), its body up to the first EXIT past
    which an out-of-line callee lies."""
    kernel, store = NORMALS[label]
    name, instrs = _function(kernel, sass_funcs, out_dir)
    loops = [l for l in _loops(instrs, store) if l[1]]
    if loops:
        body = max((l[2] for l in loops), key=len)
    else:       # a block a tile: the body up to its first unguarded EXIT
        body = instrs[:next(i for i, (_, o, _, g) in enumerate(instrs)
                            if o == "EXIT" and not g) + 1]
    ops = Counter(o.split(".")[0] for _, o, _, _ in body)
    elems = 4 * sum(1 for _, o, _, _ in body if o.startswith(store)
                    and ".128" in o)
    per = {
        "float64": sum(c for o, c in ops.items() if o in ("DADD", "DMUL",
                                                          "DFMA")),
        "conversions": sum(c for o, c in ops.items()
                           if o.startswith(_CONVERSIONS)),
        "selects": ops["SEL"] + ops["FSEL"],
        "branches": ops["BRA"] + ops["BRX"] + ops["CALL"],
        "calls": ops["CALL"], "all": len(body)}
    return {"kernel": label, "function": name,
            "registers": (regs or {}).get(name),
            "elements_per_iteration": elems,
            "per_element": {k: v / elems for k, v in per.items()},
            "opcodes": dict(ops.most_common())}


def _width(op: str) -> int:
    """Registers a load of ``op`` writes: 4 bytes each."""
    return 4 if ".128" in op else 2 if ".64" in op else 1


def lookup_report(label: str, sass_funcs: dict, out_dir=None,
                  regs=None) -> dict:
    """P3's loop (the backward branch holding its store): its loads by
    width, its stores, and the loads issued before any instruction reads
    a register that one of them loads (the loads a thread has in flight
    together: the queries' positions, then the table reads they lead
    to)."""
    name, instrs = _function(LOOKUP[label], sass_funcs, out_dir)
    loops = [l for l in _loops(instrs, "STG") if l[1]]
    if not loops:
        raise SystemExit(f"no loop with a store in {name}")
    body = max((l[2] for l in loops), key=len)
    loads = [(o, r) for _, o, r, _ in body if o.startswith("LDG")]
    in_flight, loaded = 0, set()
    for _, op, args, _ in body:
        regs_in = [int(m) for m in _REG.findall(args)]
        if loaded & set(regs_in if op.startswith("ST") else regs_in[1:]):
            break
        if op.startswith("LDG"):
            in_flight += 1
            loaded.update(range(regs_in[0], regs_in[0] + _width(op)))
    return {"kernel": label, "function": name,
            "registers": (regs or {}).get(name),
            "loads_by_bytes": dict(Counter(_width(o) * 4 for o, _ in loads)),
            "stores": sum(o.startswith("STG") for _, o, _, _ in body),
            "loads_in_flight": in_flight,
            "loop_instructions": len(body)}


def resource_usage(lib) -> dict:
    """``{mangled name: registers a thread}`` of the library's kernels."""
    tool = Path(nvcc_path()).with_name("cuobjdump")
    proc = subprocess.run([str(tool), "--dump-resource-usage", str(lib)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(f"cuobjdump failed: {proc.stderr}")
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"Function (\S+):\s*REG:(\d+)", proc.stdout)}


def disassemble() -> tuple:
    """Build the library; :func:`functions` of its SASS and
    :func:`resource_usage`."""
    lib = build()
    tool = Path(nvcc_path()).with_name("cuobjdump")
    proc = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise KernelBuildError(f"cuobjdump failed: {proc.stderr}")
    return functions(proc.stdout), resource_usage(lib)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    funcs, regs = disassemble()
    for label in KERNELS:
        print(json.dumps(report(label, funcs, args.out)))
    for label in DISPATCH:
        print(json.dumps(dispatch_report(label, funcs, args.out, regs)))
    for label in NORMALS:
        print(json.dumps(normals_report(label, funcs, args.out, regs)))
    for label in LOOKUP:
        print(json.dumps(lookup_report(label, funcs, args.out, regs)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
