"""Artificial ant on the Santa Fe trail — the port's counterpart of
``examples/gp/ant.py`` (reference ``examples/gp/ant.py``): control-flow
GP, ``if_food_ahead``/``prog2``/``prog3`` over
``move_forward``/``turn_left``/``turn_right``, a 600-move budget, the
fitness the food eaten (89 pieces on the trail).

The world is an explicit state, a dict of tensors with the population
axis first, and the routines run through
:func:`deap_tpu_torch.gp.make_routine_interpreter`, one loop stepping
every ant at once; the actions and the sensor below work on that batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import gp, random
from ...algorithms import ea_simple
from ...ops._dispatch import batched_op
from ...utils.support import HallOfFame
from .symbreg import initial, toolbox

# Koza's Santa Fe trail (32x32, 89 food pieces), as the JAX example holds it
TRAIL = """\
S###............................
...#............................
...#.....................###....
...#....................#....#..
...#....................#....#..
...####.#####........##.........
............#................#..
............#.......#...........
............#.......#........#..
............#.......#...........
....................#...........
............#................#..
............#...................
............#.......#.....###...
............#.......#..#........
.................#..............
................................
............#...........#.......
............#...#..........#....
............#...#...............
............#...#...............
............#...#.........#.....
............#..........#........
............#...................
...##. .#####....#...............
.#..............#...............
.#..............#...............
.#......#######.................
.#.....#........................
.......#........................
..####..........................
................................"""

MAX_MOVES = 600
CAP, POP, NGEN = 128, 300, 40
# direction: 0 = N (-row), 1 = E (+col), 2 = S (+row), 3 = W (-col)
DIR_ROW = (-1, 0, 1, 0)
DIR_COL = (0, 1, 0, -1)


def parse_trail():
    """``(grid (32, 32) bool numpy, start)``; the trail's one stray space
    (row 24) is dropped, as the reference's parser skips it."""
    rows = [line.replace(" ", "") for line in TRAIL.splitlines()]
    assert len(set(map(len, rows))) == 1
    grid = np.zeros((len(rows), len(rows[0])), bool)
    start = (0, 0)
    for i, line in enumerate(rows):
        for j, ch in enumerate(line):
            if ch == "#":
                grid[i, j] = True
            elif ch == "S":
                start = (i, j)
    return grid, start


GRID, START = parse_trail()
H, W = GRID.shape


def init_state(n: int, device=None) -> dict:
    """``n`` ants at the start, facing east, on fresh trails."""
    def full(v):
        return torch.full((n,), v, dtype=torch.int64, device=device)
    return dict(row=full(START[0]), col=full(START[1]), dir=full(1),
                moves=full(0), eaten=full(0),
                food=torch.from_numpy(GRID).to(device).expand(n, H, W)
                .clone())


def _ahead(s):
    """The cell ahead.  ``DIR_ROW[d]`` / ``DIR_COL[d]`` as arithmetic on
    the direction (no table copied to the card: the routine's CUDA graph
    may not read the host)."""
    d = s["dir"]
    dr = (d == 2).to(d.dtype) - (d == 0).to(d.dtype)
    dc = (d == 1).to(d.dtype) - (d == 3).to(d.dtype)
    return (s["row"] + dr) % H, (s["col"] + dc) % W


def move_forward(s):
    r, c = _ahead(s)
    ants = torch.arange(r.shape[0], device=r.device)
    ate = s["food"][ants, r, c]
    food = s["food"].index_put((ants, r, c), torch.zeros_like(ate))
    return dict(row=r, col=c, dir=s["dir"], moves=s["moves"] + 1,
                eaten=s["eaten"] + ate.to(torch.int64), food=food)


def turn_left(s):
    return {**s, "dir": (s["dir"] - 1) % 4, "moves": s["moves"] + 1}


def turn_right(s):
    return {**s, "dir": (s["dir"] + 1) % 4, "moves": s["moves"] + 1}


def sense_food(s):
    r, c = _ahead(s)
    return s["food"][torch.arange(r.shape[0], device=r.device), r, c]


def build_pset():
    """An arity-0 set whose terminals are actions (reference
    ant.py:148-156)."""
    ps = gp.PrimitiveSet("ANT", 0)
    ps.add_primitive(None, 2, name="if_food_ahead")
    ps.add_primitive(None, 2, name="prog2")
    ps.add_primitive(None, 3, name="prog3")
    ps.add_terminal(0.0, name="move_forward")
    ps.add_terminal(0.0, name="turn_left")
    ps.add_terminal(0.0, name="turn_right")
    return ps


def make_evaluate(ps):
    """``evaluate(trees) -> (eaten,)``: every routine of the batch run on
    its own trail until its 600 moves are spent."""
    interp = gp.make_routine_interpreter(
        ps, CAP,
        actions={"move_forward": move_forward, "turn_left": turn_left,
                 "turn_right": turn_right},
        conds={"if_food_ahead": sense_food},
        continue_fn=lambda s: s["moves"] < MAX_MOVES)

    def evaluate(tree):
        codes = tree[0]
        n = codes.shape[0] if codes.ndim == 2 else None
        state = init_state(n or 1, codes.device)
        if n is None:
            state = {k: v[0] for k, v in state.items()}
        final = interp(tree, state)
        return (final["eaten"].to(torch.float32),)

    return batched_op(evaluate, evaluate)


def run(seed=29, ngen=NGEN, device=None):
    """The JAX example's run from ``PRNGKey(seed)`` on ``device``
    (default the card): ``(final population, the most food a routine
    ate)``, the latter from the hall of fame."""
    ps = build_pset()
    key = random.PRNGKey(seed, device=device)
    tb = toolbox(ps, make_evaluate(ps), tournsize=7, cap=CAP)
    key, pop = initial(ps, key, POP, 1, 2, (1.0,), cap=CAP)
    hof = HallOfFame(1)
    pop, _ = ea_simple(key, pop, tb, cxpb=0.5, mutpb=0.2, ngen=ngen,
                       halloffame=hof)
    return pop, float(hof.state.values.max())


def main(seed=29, ngen=NGEN, verbose=True, device=None):
    """:func:`run`'s most food a routine ate."""
    best = run(seed, ngen, device)[1]
    if verbose:
        print(f"best ant ate {best:.0f}/89 food pieces in {MAX_MOVES} moves")
    return best


if __name__ == "__main__":
    main()
