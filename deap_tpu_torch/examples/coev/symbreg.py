"""Competitive co-evolution on symbolic regression — the port's
counterpart of ``examples/coev/symbreg.py`` (reference
``examples/coev/symbreg.py``): a GA population evolves evaluation
points (10 floats in [-1, 1]) that maximise the champion program's
error, while a GP population evolves programs that minimise the error
on the GA champion's points.

Both populations advance together a generation at a time: the plain
GP interpreter runs the whole program population on the champion
points, and the champion program on every GA individual's points at
once (one batch of ``POP * N_POINTS`` points).  The errors are the
float32 forms XLA compiles inside the JAX example's scan: each square
fused into the running sum as a multiply-add
(:func:`~deap_tpu_torch._xla_math.row_dot`), times the float32
reciprocal of ``N_POINTS``, and the target values with ``x**4`` fused
into ``+ x**3`` (:func:`target_fused`), so the run equals the JAX
example's bit for bit."""

from __future__ import annotations

import numpy as np
import torch

from ... import gp, random
from ..._xla_math import fma, row_dot
from ...algorithms import vary_genome
from ...base import Toolbox
from ...ops import crossover, mutation, selection
from ..gp.symbreg import CAP, build_pset, toolbox as gp_toolbox

N_POINTS = 10
POP, NGEN = 200, 50
CXPB, MUTPB = 0.5, 0.2


_INV_POINTS = float(np.float32(1.0) / np.float32(N_POINTS))


def target_fused(x):
    """``x**4 + x**3 + x**2 + x`` with ``x**4 + x**3`` one multiply-add."""
    x2 = x * x
    return (fma(x2, x2, x * x2) + x2) + x


def _mse(out, target):
    """Mean squared error over the last axis, 1e6 where not finite."""
    d = out - target
    err = row_dot(d, d, fused=True) * _INV_POINTS
    return torch.where(torch.isfinite(err), err, 1e6)


def make_errors(ps):
    """``(program_errors, champion_error)``: every program's error on
    one point set ``(N_POINTS,)``, and one program's error on every
    point set of ``(n, N_POINTS)``."""
    ev = gp.make_evaluator(ps, CAP)

    def program_errors(trees, points):
        out = ev(trees[0], trees[1], trees[2], points[None, :])
        return _mse(out, target_fused(points))

    def champion_error(tree, points_batch):
        out = ev(tree[0], tree[1], tree[2], points_batch.reshape(1, -1))
        return _mse(out.reshape(points_batch.shape),
                    target_fused(points_batch))

    return program_errors, champion_error


def toolboxes(ps):
    """``(GA toolbox, GP toolbox)``."""
    tb_ga = Toolbox()
    tb_ga.register("mate", crossover.cx_two_point)
    tb_ga.register("mutate", mutation.mut_gaussian, mu=0.0, sigma=0.01,
                   indpb=0.05)
    return tb_ga, gp_toolbox(ps, mut_kind="full")


def initial(ps, seed, device=None):
    """The first carry ``(ga_pop, gp_pop, best_ga, best_gp)`` and the
    key of the generations."""
    key = random.PRNGKey(seed, device=device)
    key, k_ga, k_gp = random.split(key, 3)
    ga_pop = random.uniform(k_ga, (POP, N_POINTS), minval=-1.0, maxval=1.0)
    gen_init = gp.make_generator(ps, CAP, "half_and_half")
    gp_pop = gen_init(random.split(k_gp, POP), 1, 3)
    return (ga_pop, gp_pop, ga_pop[0], tuple(x[0] for x in gp_pop)), key


def gen_step(errors, tbs, carry, k):
    """One generation pair: both populations scored against the other
    side's champion, the champions elected from those scores, then a
    tournament and ``var_and`` on each side.  Returns the next carry and
    ``(max GA error, min GP error)``."""
    program_errors, champion_error = errors
    tb_ga, tb_gp = tbs
    ga_pop, gp_pop, best_ga, best_gp = carry
    k_sga, k_sgp, k_vga, k_vgp = random.split(k, 4)
    ga_fit = champion_error(best_gp, ga_pop)
    gp_fit = program_errors(gp_pop, best_ga)
    best_ga = ga_pop[torch.argmax(ga_fit)]
    i_gp = torch.argmin(gp_fit)
    best_gp = tuple(x[i_gp] for x in gp_pop)
    idx_ga = selection.sel_tournament(k_sga, ga_fit[:, None], POP, 3).long()
    idx_gp = selection.sel_tournament(k_sgp, -gp_fit[:, None], POP, 3).long()
    ga_new, _ = vary_genome(k_vga, ga_pop[idx_ga], tb_ga, CXPB, MUTPB)
    gp_new, _ = vary_genome(k_vgp, tuple(x[idx_gp] for x in gp_pop), tb_gp,
                            CXPB, MUTPB)
    return (ga_new, gp_new, best_ga, best_gp), (ga_fit.max(), gp_fit.min())


def run(seed=5, ngen=NGEN, device=None):
    """``(final carry, max GA errors, min GP errors)``, the curves a
    tensor each."""
    ps = build_pset()
    errors, tbs = make_errors(ps), toolboxes(ps)
    carry, key = initial(ps, seed, device)
    curves = []
    for k in random.split(key, ngen):
        carry, out = gen_step(errors, tbs, carry, k)
        curves.append(out)
    ga_curve, gp_curve = (torch.stack(c) for c in zip(*curves))
    return carry, ga_curve, gp_curve


def main(seed=5, ngen=NGEN, verbose=True, device=None):
    """Returns the champion program's error in the last generation."""
    (_, _, best_ga, best_gp), _, gp_curve = run(seed, ngen, device)
    final_gp_err = float(gp_curve[-1])
    if verbose:
        ps = build_pset()
        tree = tuple(t.cpu().numpy() for t in best_gp)
        print("Best GA points:", np.round(best_ga.cpu().numpy(), 3))
        print("Best GP:", gp.to_string(tree, ps))
        print(f"champion error on adversarial points: {final_gp_err:.5f}")
    return final_gp_err


if __name__ == "__main__":
    main()
