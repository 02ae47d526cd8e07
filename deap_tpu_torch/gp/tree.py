"""Host-side GP tree utilities — the PyTorch port's copy of
``deap_tpu/gp/tree.py``'s string round trip (reference
``PrimitiveTree.__str__`` and ``from_string``).

Device code never needs these; they serve logging, debugging and tests
of ``(codes, consts, length)`` prefix arrays (tensors or numpy arrays).
``graph`` is not ported yet.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .pset import Ephemeral, Primitive, Terminal, freeze_pset

__all__ = ["to_string", "from_string"]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def to_string(tree, pset) -> str:
    """Prefix array -> readable expression (same stack algorithm as the
    reference)."""
    f = freeze_pset(pset)
    codes, consts, length = tree
    codes, consts = _host(codes), _host(consts)
    length = int(_host(length))
    string = ""
    stack = []
    for i in range(length):
        c = int(codes[i])
        stack.append((c, i, []))
        while len(stack[-1][2]) == int(f.arity[stack[-1][0]]):
            c2, pos, args = stack.pop()
            n2 = f.pset.nodes[c2]
            if isinstance(n2, Primitive):
                string = n2.format(*args)
            elif isinstance(n2, Ephemeral):
                string = repr(float(consts[pos]))
            elif isinstance(n2, Terminal):
                string = n2.format()
            else:
                string = n2.name
            if len(stack) == 0:
                break
            stack[-1][2].append(string)
    return string


def from_string(string: str, pset, cap: int = 64):
    """Expression string -> ``(codes int32 (cap,), consts float32 (cap,),
    length)`` numpy arrays.  Accepts primitive, terminal and argument
    names and numeric literals (constants on the first ephemeral code)."""
    f = freeze_pset(pset)
    tokens = re.split(r"[ \t\n\r\f\v(),]", string)
    codes, consts = [], []
    name_to_code = {n: i for i, n in enumerate(f.names)}
    eph_codes = [i for i in range(f.n_nodes) if f.is_ephemeral[i]]
    for tok in tokens:
        if tok == "":
            continue
        if tok in name_to_code:
            c = name_to_code[tok]
            codes.append(c)
            consts.append(float(f.const_value[c]))
        else:
            try:
                val = float(tok)
            except ValueError:
                raise TypeError(
                    f"Unable to find symbol {tok!r} in {f.pset.name}.")
            if not eph_codes:
                raise TypeError(
                    f"Numeric literal {tok} requires an ephemeral constant "
                    "in the primitive set.")
            codes.append(eph_codes[0])
            consts.append(val)
    length = len(codes)
    if length > cap:
        raise ValueError(f"expression has {length} nodes > capacity {cap}")
    codes_arr = np.zeros(cap, np.int32)
    consts_arr = np.zeros(cap, np.float32)
    codes_arr[:length] = codes
    consts_arr[:length] = consts
    return codes_arr, consts_arr, np.int32(length)
