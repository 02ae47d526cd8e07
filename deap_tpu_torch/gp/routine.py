"""Control-flow GP: routines over an explicit world state — the PyTorch
counterpart of ``deap_tpu/gp/routine.py`` (the reference's artificial
ant, whose primitives are closures mutating a simulator and whose ``run``
re-executes the routine until the move budget is spent).

A routine is the usual prefix array; the interpreter walks it with an
explicit stack of node indices:

* **action terminals** apply ``state -> state`` transformers;
* **sequence primitives** (``prog2``/``prog3``) push their children;
* **conditional primitives** evaluate a ``state -> bool`` predicate and
  push one child;
* when the stack empties the routine restarts from the root, until
  ``continue_fn`` says stop or ``max_steps`` steps have run.

The JAX package ``jax.vmap``s a ``lax.while_loop`` over the routines: a
lane whose condition turned false keeps its state while the others go
on.  Here one loop steps every routine of the batch at once and masks
the finished ones the same way; whether any is still running is read on
the host once every ``CHECK_EVERY`` steps (the steps in between change
nothing on finished lanes).  The state is a dict (or a tensor) whose
tensors carry the batch axis first, and the actions, predicates and
``continue_fn`` work on that batch: a predicate returns ``(n,)`` bools.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from ..base import _leaves, _map
from .pset import Primitive, freeze_pset
from .variation import _all_subtree_ends

__all__ = ["make_routine_interpreter"]

_SEQ, _COND, _ACT = 0, 1, 2
#: steps between the host's reads of whether any routine still runs (on
#: the card: the steps of one captured CUDA graph)
CHECK_EVERY = 32


def _apply_action(mask, acted, state, new):
    """``acted`` (an action applied to ``state``) on the rows of ``mask``,
    ``new`` elsewhere, leaf by leaf.  The actions' codes are disjoint, so
    on those rows ``new`` still holds ``state``: a leaf the action left
    as it was (the same tensor) keeps ``new``'s.  On the CPU a leaf with
    more than a value a row (the ant's food grid) takes an indexed copy
    of the masked rows, ~8x cheaper there than a broadcast ``where``;
    the values are the same."""
    rows = []

    def w(a, s, b):
        if a is s:
            return b
        if a.device.type == "cpu" and a.ndim > 1:
            if not rows:
                rows.append(mask.nonzero()[:, 0])
            return b.index_copy(0, rows[0], a[rows[0]])
        return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)),
                           a, b)
    return _map(w, acted, state, new)


def make_routine_interpreter(pset, cap: int, actions: Mapping[str, Callable],
                             conds: Mapping[str, Callable],
                             continue_fn: Callable,
                             max_steps: int | None = None) -> Callable:
    """Build ``run(trees, state) -> state`` over a batch of routines
    (``(codes (n, cap), consts, lengths (n,))``; one tree ``(cap,)`` and
    an unbatched state are run as a batch of one).

    :param actions: terminal name -> ``state -> state``.
    :param conds: conditional-primitive name -> ``state -> (n,) bool``
        (arity 2: the true and the false subtree).  Every other primitive
        is a sequencer running its children left to right.
    :param continue_fn: ``state -> (n,) bool``: a routine steps while it
        is true.
    :param max_steps: the most steps a routine takes (``64 * cap`` by
        default), so an action-free routine cannot spin forever.

    On the card ``CHECK_EVERY`` steps run as one captured CUDA graph (a
    step is ~100 small launches), so the actions, predicates and
    ``continue_fn`` must neither read the host nor copy from it.
    """
    f = freeze_pset(pset)
    max_steps = max_steps or 64 * cap
    kinds, act_fns, cond_fns = [], {}, {}
    for i, node in enumerate(f.pset.nodes):
        name = getattr(node, "name", None)
        if name in conds:
            if not (isinstance(node, Primitive) and node.arity == 2):
                raise ValueError(
                    f"conditional {name!r} must be a binary primitive")
            kinds.append(_COND)
            cond_fns[i] = conds[name]
        elif name in actions:
            kinds.append(_ACT)
            act_fns[i] = actions[name]
        elif isinstance(node, Primitive):
            kinds.append(_SEQ)
        else:
            raise ValueError(
                f"terminal {name!r} has no action; every routine terminal "
                "needs an entry in `actions`")
    max_arity = max(f.max_arity, 1)

    def run(trees, state):
        codes, consts, lengths = trees
        if codes.ndim == 1:
            one = _map(lambda x: x[None], state)
            out = run((codes[None], consts[None],
                       torch.as_tensor(lengths, device=codes.device)
                       .reshape(1)), one)
            return _map(lambda x: x[0], out)
        dev = codes.device
        n = codes.shape[0]
        node = _node_table(codes, lengths)
        ar = torch.arange(n, device=dev)
        spare = cap + max_arity - 1
        on_cpu = dev.type == "cpu"

        def live_of(carry):
            return continue_fn(carry[0]) & (carry[3] < max_steps)

        def step(carry):
            """One step of every routine (the stack updated in place); a
            finished one keeps its carry."""
            state, stack, sp, steps = carry
            live = live_of(carry)
            # pop; an empty stack restarts the routine from the root
            restart = sp == 0
            top = stack.gather(1, (sp - 1).clamp(min=0)[:, None])[:, 0]
            i = torch.where(restart, 0, top)
            s = torch.where(restart, 0, sp - 1)
            info = node[ar, i]                       # (n, 3 + max_arity)
            c, kind, a = info[:, 0], info[:, 1], info[:, 2]
            starts = info[:, 3:]
            new = state
            for code, fn in act_fns.items():
                mask = (c == code) & live
                # a host read is free on the CPU: skip an action no row
                # takes (on the card the step runs inside a CUDA graph)
                if on_cpu and not bool(mask.any()):
                    continue
                new = _apply_action(mask, fn(state), state, new)
            pred = torch.zeros((n,), dtype=torch.bool, device=dev)
            for code, fn in cond_fns.items():
                if on_cpu and not bool((c == code).any()):
                    continue
                pred = torch.where(c == code, fn(new), pred)
            # a conditional pushes the chosen child; a sequencer its
            # children right to left (row s + j gets starts[a - 1 - j]),
            # so the leftmost pops first
            is_cond, is_seq = kind == _COND, kind == _SEQ
            chosen = torch.where(pred, starts[:, 0],
                                 starts[:, min(1, max_arity - 1)])
            for j in range(max_arity):
                rev = starts.gather(1, (a - 1 - j).clamp(
                    0, max_arity - 1)[:, None])[:, 0]
                write = live & ((is_cond & (j == 0)) | (is_seq & (j < a)))
                pos = torch.where(write, (s + j).clamp(max=spare), spare)
                stack.scatter_(1, pos[:, None], torch.where(
                    is_cond, chosen, rev)[:, None])
            # the spare columns take the pushes past ``cap``: a read
            # there is 0
            stack[:, cap:] = 0
            grow = torch.where(is_cond, 1, torch.where(is_seq, a, 0))
            return (new, stack, torch.where(live, s + grow, sp),
                    torch.where(live, steps + 1, steps))

        carry = (state,
                 torch.zeros((n, cap + max_arity), dtype=torch.int64,
                             device=dev),
                 torch.zeros((n,), dtype=torch.int64, device=dev),
                 torch.zeros((n,), dtype=torch.int64, device=dev))
        if dev.type == "cuda":
            return _run_graphed(step, live_of, carry)
        for k in range(max_steps):
            if k % CHECK_EVERY == 0 and not bool(live_of(carry).any()):
                break
            carry = step(carry)
        return carry[0]

    def _run_graphed(step, live_of, carry):
        """The loop on the card: ``CHECK_EVERY`` steps captured once in a
        CUDA graph that writes the carry back into its own input
        buffers, then replayed until no routine is live (one host read a
        replay).  Steps past a routine's end change nothing, so this
        equals the loop above."""
        leaves = _leaves(carry)
        if not bool(live_of(carry).any()):
            return carry[0]
        static = _rebuild(carry, [x.clone() for x in leaves])

        def chunk(c):
            for _ in range(CHECK_EVERY):
                c = step(c)
            return c

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):            # warm-up, on a copy
            chunk(_rebuild(carry, [x.clone() for x in leaves]))
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                out = chunk(static)
                for dst, src in zip(_leaves(static), _leaves(out)):
                    dst.copy_(src)
                any_live = live_of(static).any()
        except RuntimeError as e:
            raise RuntimeError(
                "the routine's actions, predicates or continue_fn cannot "
                "be captured in a CUDA graph: they may neither read the "
                "host nor copy from it") from e
        for _ in range(-(-max_steps // CHECK_EVERY)):
            graph.replay()
            if not bool(any_live):
                break
        return static[0]

    def _node_table(codes, lengths):
        """Per tree and position ``i`` in ``[0, cap]``: the code, kind and
        arity of node ``i`` and its children's starts (``i + 1``, then
        each previous one's end); a position past the tree reads code 0,
        as the JAX package's one-hot take does."""
        dev = codes.device
        t = f.tables(dev)
        n = codes.shape[0]
        ends = _all_subtree_ends(codes, lengths, t["arity"])
        i = torch.arange(cap + 1, device=dev).expand(n, cap + 1)
        c = torch.cat([codes.long(), torch.zeros((n, 1), dtype=torch.int64,
                                                 device=dev)], dim=1)
        kind = torch.as_tensor(kinds, dtype=torch.int64, device=dev)[c]
        starts = [i + 1]
        for _ in range(max_arity - 1):
            prev = starts[-1].clamp(0, cap - 1)
            starts.append(ends.gather(1, prev))
        return torch.stack([c, kind, t["arity"][c], *starts], dim=2)

    return run


def _rebuild(carry, flat):
    """``carry``'s structure (state, stack, sp, steps) over the tensors
    ``flat``, in :func:`~deap_tpu_torch.base._leaves` order."""
    it = iter(flat)
    return tuple(_map(lambda _: next(it), part) for part in carry)
