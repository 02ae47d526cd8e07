"""Hillis-style competitive co-evolution — the port's counterpart of
``examples/coev/hillis.py``: sorting networks against adversarial test
cases.  Hosts are comparator networks (``N_COMPARATORS`` index pairs),
parasites sets of 0/1 inputs; the encounter counts the parasite's
inputs the host fails to sort — hosts minimize it, parasites maximize
it.  The network runs over the whole population at once, one
comparator a step."""

from __future__ import annotations

import itertools

import torch

from ... import base, random
from ...coev import ea_host_parasite
from ...ops import crossover, mutation, selection
from ...ops._dispatch import batched_op

N_WIRES = 6
N_COMPARATORS = 16          # network capacity
N_TESTS = 10                # inputs per parasite
POP, NGEN = 100, 40


def apply_network(net, inputs):
    """Run comparator networks over batches of 0/1 inputs: ``net`` ``(n,
    n_comp, 2)`` wire indices (as numbers), ``inputs`` ``(n, n_tests,
    n_wires)``."""
    vals = inputs.clone()
    rows = torch.arange(vals.shape[0], device=vals.device)[:, None]
    tests = torch.arange(vals.shape[1], device=vals.device)[None, :]
    for c in range(net.shape[1]):
        i = net[:, c, 0].long()[:, None]
        j = net[:, c, 1].long()[:, None]
        a, b = vals[rows, tests, i], vals[rows, tests, j]
        vals[rows, tests, i] = torch.minimum(a, b)
        vals[rows, tests, j] = torch.maximum(a, b)
    return vals


def unsorted_count(out):
    """Per row of ``out`` ``(n, n_tests, n_wires)``: the inputs left
    unsorted, as float32."""
    ok = (out[..., :-1] <= out[..., 1:]).all(-1)
    return (~ok).sum(-1).to(torch.float32)


def encounter_rows(hosts, parasites):
    """The encounter of host ``i`` with parasite ``i``, every row."""
    n = hosts.shape[0]
    out = apply_network(hosts.reshape(n, N_COMPARATORS, 2),
                        parasites.reshape(n, N_TESTS, N_WIRES))
    return unsorted_count(out)


def encounter(host, parasite):
    """One host against one parasite."""
    return encounter_rows(host[None], parasite[None])[0]


batched_op(encounter, encounter_rows)


def toolboxes():
    htb = base.Toolbox()
    htb.register("mate", crossover.cx_two_point)
    htb.register("mutate", mutation.mut_uniform_int, low=0,
                 up=N_WIRES - 1, indpb=0.05)
    htb.register("select", selection.sel_tournament, tournsize=3)
    ptb = base.Toolbox()
    ptb.register("mate", crossover.cx_two_point)
    ptb.register("mutate", mutation.mut_flip_bit, indpb=0.05)
    ptb.register("select", selection.sel_tournament, tournsize=3)
    return htb, ptb


def initial(seed, device=None):
    """``(key, hosts, parasites)``."""
    key = random.PRNGKey(seed, device=device)
    ks = random.split(key, 3)
    k_h, k_p, key = ks[0], ks[1], ks[2]
    dev = key.device
    hosts = base.Population(
        random.randint(k_h, (POP, N_COMPARATORS * 2), 0, N_WIRES),
        base.Fitness.empty(POP, (-1.0,), device=dev))
    parasites = base.Population(
        random.bernoulli(k_p, 0.5, (POP, N_TESTS * N_WIRES)).to(
            torch.float32),
        base.Fitness.empty(POP, (1.0,), device=dev))
    return key, hosts, parasites


def run(seed=21, ngen=NGEN, device=None):
    """``(hosts, parasites)`` after ``ngen`` generations."""
    key, hosts, parasites = initial(seed, device)
    htb, ptb = toolboxes()
    hosts, parasites, _ = ea_host_parasite(
        key, hosts, parasites, htb, ptb, encounter, cxpb=0.6, mutpb=0.3,
        ngen=ngen)
    return hosts, parasites


def exhaustive_failures(net):
    """The 0/1 inputs (all ``2**N_WIRES``) that network ``net`` fails to
    sort (the zero-one principle)."""
    grid = torch.tensor(list(itertools.product((0.0, 1.0), repeat=N_WIRES)),
                        device=net.device)
    out = apply_network(net.reshape(1, N_COMPARATORS, 2), grid[None])
    return int(unsorted_count(out)[0])


def best_host_failures(hosts):
    """The exhaustive failures of the host with the fewest encounter
    failures (the first on a tie)."""
    best = int(torch.argmin(hosts.fitness.values[:, 0]))
    return exhaustive_failures(hosts.genome[best])


def main(seed=21, verbose=True, ngen=NGEN, device=None):
    """Returns the best host's failures over every 0/1 input."""
    failures = best_host_failures(run(seed, ngen, device)[0])
    if verbose:
        print(f"best host fails {failures}/{2 ** N_WIRES} exhaustive inputs")
    return failures


if __name__ == "__main__":
    main()
