#!/usr/bin/env python3
"""Drive deap_tpu_torch on one NVIDIA card and check it, phase by phase.

    python3 chip_smoke.py

1. build   — compile the port's CUDA kernels from the checkout's source
             and bind them (phase 54, which needs no kernel, runs
             beside the compilers);
2. K1      — ``megakernel_vary`` against its plain PyTorch version on the
             card, pop 1e6 x dim 100, float32 / bfloat16 / int8 storage;
3. K2      — ``megakernel_gather_vary`` (one warp a mating pair) against
             ``index_select`` plus the plain variation, same sizes, bit
             for bit, its time beside its byte bound;
4. reference — one whole fused generation on a small input: the card's
             output against the CPU path's, bit for bit; then, bit for
             bit card against CPU, an ``ea_step(reevaluate_all=True)``
             generation on the xla engine (pop 1024 x 100) and
             ``mut_gaussian`` on a float32 genome (4096 x 100: ``mu`` 0
             and 0.5 as Python numbers, ``mu`` and ``sigma`` as tensors)
             and on a bfloat16 one;
5. main path — ``ea_simple`` with the megakernel engine on rastrigin, pop
             1e6 x dim 100 float32, NGEN and 2*NGEN generations, three
             pairs (median marginal time per generation), best fitness
             must fall; then
             the serving step (``ea_step`` with a live mask) for a few
             generations.  Launch counts are zeroed before each of the two
             and read after: each kernel must have run on its path.
6. K3      — ``megakernel_var_or`` against ``index_select`` plus the
             plain OR-choice variation: lambda 1e6 x dim 100 in float32 /
             bfloat16 / int8, and the NSGA-II slice's 1e5 x 12 (device
             time with the launches queued beside the host-paced one);
             then dims 1, 3, 12, 100 and 1000 with lambda != mu;
7. K4      — ``rows_dominate_counts`` against the plain counts, C = 1024
             and C = n rows against n = 2e5 DTLZ2 points of a real pool
             (with -inf sentinel rows and duplicated points), then
             SPEA2's strength form ``(-w, -w)`` at C = n = 2e5 on ZDT1
             (m = 2) and DTLZ2 values (+inf rows, duplicates): equal
             counts;
8. reference — one NSGA-II generation at mu = lambda = 1024: the card's
             ``var_or`` offspring against the CPU's bit for bit, then
             ``sel_nsga2`` on the card, given the CPU pool's values,
             against the CPU's indices, and the ``ea_step`` head's
             offspring bit for bit;
9. main path — NSGA-II ``ea_mu_plus_lambda`` (DTLZ2, 3 objectives, 12
             variables, mu = lambda = 1e5, ``sel_nsga2(nd="peel",
             front_chunk=1024)``, megakernel engine): N and 2N
             generations, one pair (marginal time per generation), K3
             once and K4 at least once per generation,
             and DTLZ2's distance to the front (mean of |f| - 1) must
             fall; an untimed replay of the N-generation run counts the
             fronts peeled per generation;
10. the NSGA-II ``ea_step`` head (``sel_nsga2`` then K1): K1 against its
             plain version on one generation's parents (1e5 x 12, the
             head's knobs, float32 / bfloat16 / int8; its device time
             with the launches queued beside the host-paced one), then a
             few generations at full width with K1's launches counted;
11. reference — one GP bench generation (``bench_gp.py``: symbolic
             regression, pop 256 here) on the card against the CPU path:
             selection indices equal, trees bitwise after ``var_and``,
             MSE within rtol 1e-5; then a generation of its first 64
             rows on the card with the operators registered per tree, as
             the reference examples register them (``lambda k, t:
             gp.mut_uniform(k, t, expr, pset)``), against the CPU's;
12. main path — ``bench_gp.py``'s generation at full width (pop 4096,
             tree capacity 64, 1024 points): N = 10 and 2N generations,
             one pair (marginal time per generation), K6 once
             per generation, the best MSE must fall, mean tree length at
             the start and the end; then ``ea_simple`` on the same
             toolbox for a few generations with K6's launches counted;
13. K6        — ``gp_interp`` against the plain interpreter, bitwise, on
             the initial population, the population after 2N generations,
             the same with every other row skipped, and a set with every
             opcode of the table (4096 x 64 x 1024, 2 arguments); then
             comb trees of exactly 64 tokens at the deepest stack (``if``
             at depth) at 1024, 1, 1000 and 4097 points, the evolved
             population at 4097 points, a single tree, every row
             skipped, and comb trees of 256 tokens at cap 256 at 1024
             and 4097 points (device time with the launches queued
             beside each);
14. reference — one generation of ``bench_nsga2.py`` as published (SBX,
             polynomial mutation, ``sel_nsga2(nd="auto")``) at POP 1024 on
             the card against the CPU path, for DTLZ2 (A) and ZDT1 (B):
             offspring bitwise, selection indices equal on the CPU pool's
             values, grid / staircase ranks equal to the count peel's;
15. main path A — ``bench_nsga2.py`` with ``BENCH_PROBLEM=dtlz2`` at POP
             1e5 (pool 2e5, 3 objectives, 12 variables, grid ranks): N = 3
             and 2N generations, one pair (marginal time per
             generation), then ``toolbox.hypervolume`` of the final
             population at ref (1.1, 1.1, 1.1): K5 once, in float64, and
             K4 in the grid peel's thin fronts; the value against the
             plain float64 sweep and, on a 512-point subsample, against
             the host tier to 1e-12; the distance to the front must fall
             and the hypervolume rise;
16. K5      — ``hv3d_sweep`` against the plain sweep on 8192 uniform
             points (ref (1, 1, 1)) and on path A's final 1e5 x 3
             population, float32 and float64: total and slab partials,
             two launches bitwise equal, time (CUDA events, and the
             device time alone from ``torch.profiler``) against its
             bound;
17. main path B — the default ``BENCH_PROBLEM=zdt1`` at POP 1e5 (2
             objectives, 30 variables, staircase ranks): a few
             generations, fronts per generation, the 2-D hypervolume at
             ref (11, 11) must rise (no kernel of the port runs on it);
18. P1-P4   — the probe kernels of ``kernels/probes.cu`` against their
             plain versions at the GA probe tool's shape, 2^20 x 128
             float32: the copy (rows 512 / 2048 / 8192 a block), the
             24-step FMA chain, the rastrigin row reduce (dim 100), the
             counter-hash normals, the table lookup and the row gather;
             times beside the bound and the library call (``copy_``,
             ``order[pos]``, ``index_select``); the reduce (three), the
             lookup and ``order[pos]`` (five each) as the median of
             readings host-paced and with the launches queued (device
             time); the reduce also at 1, 2047, 2048, 2049 and 2^16 + 96
             rows by dims 0, 1, 31, 32, 33, 37, 96, 100, 127 and 128 on
             rows that put warps on the branch-free cosine, the general
             one and both (NaN and +-inf lanes too); the branch-free
             cosine against ``xla_sincos`` on every 7th float32 of |y| <
             120; the normals also at 1, 2047 and 2049 rows under this
             run's seed and a second one; the lookup also at 1, 3, 4, 5,
             1023, 2^20 and 2^20 + 3 queries into a table of another
             size, ``pos`` 0-3 words into its allocation;
19. probe tool — ``python -m deap_tpu_torch.probes.ga`` in process at
             2^20 x 100, every probe, ``--recommend``, ``--json
             chip_smoke_out/probe_ga.json``: P1-P4 launched on it, every
             record a finite time above zero, ``varveval`` under both key
             implementations (``torch_varveval_rbg`` too) and no error;
             the linearity witnesses and the recommended gather;
20. P5      — ``probe_gp`` against its plain version on the GP tool's
             4096 full binary trees (capacity 64) at 1024 points: every
             mode, tb 8 and 32, unroll 1 and 63; then in every form on
             ``probes.gp.probe_edges``: 4097 trees (a group with
             missing trees), 1000 points and 1 point, cap 256 with trees
             shorter than 63 tokens and up to 256, codes outside the
             branches;
21. probe tool — ``python -m deap_tpu_torch.probes.gp`` in process: the
             nine probes and ``fraction_of_floor``, P5 and K6 (``real63``)
             launched on it;
22. OneMax — BASELINE config 1 (``bench_onemax.py``: pop 300 x 100
             bits, ``cx_two_point``, ``mut_flip_bit(0.05)``,
             ``sel_tournament(3)``, cxpb 0.5, mutpb 0.2) through
             ``ea_simple`` with ``HallOfFame(1)`` and max / avg
             statistics, 40 generations on the card and on the CPU from
             ``PRNGKey(0)``: population, logbook and archive bit for bit
             equal; the generation where the maximum reaches 100; the
             marginal ms a generation (10 / 20, one pair);
23. CMA-ES  — BASELINE config 3 (``bench_cma.py``: N = 100, lambda =
             4096, centroid 5, sigma 5) on ``sphere`` and ``ackley``
             through ``ea_generate_update``: five generations, then one
             step teacher-forced, the same state, key and population on
             the card and on the CPU (genomes and ``centroid``,
             ``sigma``, ``ps``, ``pc``, ``C``, ``diagD`` within
             ``CMA_RTOL`` of each field's largest value; ``B`` up to the
             sign of its columns within ``CMA_B_ATOL``; ``pc`` and ``C``
             only where ``hsig``'s margin exceeds ``CMA_HSIG_MARGIN``);
             TF32 must be off; ``eigh`` must run on the card (device
             kernels under the profiler), its ms and share of a
             generation; the marginal ms a generation (5 / 10, one
             pair) and one profiled window;
24. anchors — verify flow 2 (sphere, N = 5, lambda = 20, 100
             generations, ``PRNGKey(0)``): best < 1e-8; (1+lambda)
             (N = 5, lambda = 8, 300 generations, ``PRNGKey(10)``): best
             < 1e-3;
25. MO-CMA-ES — ZDT1 as ``tests/test_algorithms.py:178`` runs it (MU =
             LAMBDA = 10, 500 generations, ``RandomState(128)``) with
             the strategy on the card: hypervolume at (11, 11) > 116
             and the device and host selection routes choosing the same
             individuals on every generation's candidates.  No kernel
             of the port runs on phases 22-25 (their launch counts are
             printed, zero);
26. rbg     — the ``rbg`` key implementation (``PRNGKey(0,
             impl="rbg")``, the default of ``bench.py``, ``bench_onemax.py``,
             ``bench_cma.py`` and ``bench_evopole.py``): ``bits`` of three
             raw keys equal to the words jax gives; ``split``,
             ``fold_in``, ``bits``, ``uniform``, ``normal`` (float32 and
             bfloat16), ``bernoulli`` and ``randint`` at 2^20 draws, from
             one key and from a (4096, 4) key batch, card equal to CPU bit
             for bit; the ms of 1e6 uniforms under rbg and threefry;
27. flagship under rbg — phase 5's ``ea_simple`` (megakernel engine,
             rastrigin, 1e6 x 100 float32) from an rbg key: N = 10 and 2N
             generations, one pair, K2 once a generation, the best
             fitness must fall; three generations at 10240 x 100
             teacher-forced card against CPU (offspring bitwise, fitness
             within rtol 1e-5); the live-mask ``ea_step`` with K1's
             launches counted;
28. OneMax and CMA-ES under rbg — phases 22 and 23 (sphere) from
             ``PRNGKey(0, impl="rbg")``;
29. evopole — BASELINE config 5 at ``bench_evopole.py``'s defaults
             (pop 256, 4 episodes of at most 500 CartPole steps, an MLP
             policy 4 -> tanh 16 -> 2 as a dict genome, blend crossover
             and Gaussian weight mutation, ``sel_tournament(3)``, cxpb 0.5,
             mutpb 0.8, rbg keys) through ``ea_simple`` with
             ``HallOfFame(1)``: one generation on the card and on the
             CPU, genomes, fitness, logbook and archive bit for bit; the
             marginal ms a generation (1 / 2, one pair); one
             generation with the masked rollout (same fitness); 50 rollout
             steps under the profiler (kernel launches a step, device idle
             share); the maximum fitness must rise over the pair's 2
             generations (from this key it starts at its ceiling, 500:
             then it must stay there and the average rise); no kernel of
             the port runs (launch counts printed, zero);
30. permutation — ``random.permutation`` at 2^20 (two shuffle rounds)
             and 1000 (one) under both key implementations, card equal
             to CPU bit for bit; later, after phase 31's DTLZ2 run,
             ``sel_tournament_dcd`` on that 1e5-point population card
             against CPU, bitwise;
31. NSGA-III — ``bench_nsga2.py`` with ``BENCH_SELECT=nsga3``
             (``uniform_reference_points`` with 99 divisions at two
             objectives, 12 at three) on ZDT1 and DTLZ2: one generation
             at POP 4096 card against CPU (offspring, objective values
             and selected indices bitwise), then POP 1e5 (pool 2e5):
             N = 2 and 2N generations, one pair (marginal ms),
             launches counted (K4 in the grid peel's thin fronts at
             three objectives), DTLZ2's mean ``|sum f^2 - 1|`` must fall
             and ZDT1's hypervolume at (11, 11) rise;
32. SPEA2  — ``BENCH_SELECT=spea2`` (chunk 500 at POP 1e5) likewise on
             both problems (N = 1, one pair; K4 a generation, the
             strength with the roles swapped) and ``BENCH_STAGED=1`` on
             DTLZ2 (N = 1, one pair), the POP 4096 generation card
             against CPU for each; the single program against the two
             stage calls on the card; the truncation branch card against
             CPU (2048 DTLZ2 points on the true front, k = 1024);
33. examples — ``examples/ga/nsga2.py`` (ZDT1, mu 64, 100
             generations; hypervolume > 116) and ``examples/ga/nsga3.py``
             (DTLZ2, 92, 20 of its 100 generations; its front error),
             card and CPU populations bitwise;
34. GP operators — on a POP 4096 x CAP 64 population three bench
             generations old (the semantic operators on the bench set
             with ``lf``): ``mut_node_replacement``, ``mut_ephemeral``
             (one and all), ``mut_insert``, ``mut_shrink``,
             ``mut_semantic``, ``cx_semantic`` and ``static_limit``
             (height 17) around ``cx_one_point`` and ``mut_uniform``, the
             card's children against the CPU's from the same keys
             bitwise, then K6 on the children against the plain
             interpreter bitwise (time, bound);
35. HARM-GP — two generations at POP 512 (2000 natural children) on the
             bench toolbox, each from the CPU's population before it, card
             against CPU (trees bitwise, fitness within rtol 1e-5), then
             POP 4096 with symbreg_harm.py's parameters: N = 2 and 2N,
             one pair (marginal ms), K6 once a generation and
             once before, the mean size;
36. the bench generation with each new mutation in place of
             ``mut_uniform`` and with ``static_limit`` on both operators
             (N = 2 and 2N, one pair, K6 once a generation);
37. lexicase — ``sel_lexicase``, ``sel_epsilon_lexicase``,
             ``sel_automatic_epsilon_lexicase`` and
             ``sel_double_tournament`` (both orders) card against CPU on
             512 trees' errors at 128 points, bitwise; then automatic
             epsilon-lexicase alone over the bench population's 4096 x
             1024 case errors (three calls, median) and two bench
             generations that select with it (K6 counted);
38. GP examples — the eight of ``deap_tpu_torch/examples/gp/`` at
             ``tests/test_examples.py``'s depths (symbreg 10 and its
             epsilon-lexicase form 5, unchecked) on the card, each against
             that file's check, and card = CPU bitwise on the final
             population (trees and every individual's fitness);
39. reference — the rest of the operators on the card against the CPU
             from the same keys, bit for bit: one point, uniform and SBX
             (eta 20) crossovers on 4096 x 100 float32 genomes, the ES
             blend and two point crossovers and the log-normal mutation
             on (x, strategy) pairs, PMX, UPMX, OX and the index shuffle
             on permutations of 4096 x 100 and 4096 x 25 (every child a
             permutation), the messy one-point crossover on pairs of
             mixed lengths, the uniform integer mutation on int8, int16
             and int32 genomes, and the worst, roulette and SUS
             selections over 1e5 fitnesses with ties and invalid rows;
             then every benchmark function, ``binary.py``, the moving
             peaks (three scenarios and the fluctuating mode, 20 changes)
             and the five decorators on 4096 rows (``rotate`` within
             ``ROTATE_RTOL``: the matrix product);
40. flagship width — ``bench.py``'s megakernel body (``ea_step``, K2)
             with ``evaluate`` in turn each function of any width (plane,
             cigar, rosenbrock, griewank, the scaled and skewed
             rastrigins, schaffer, schwefel, bohachevsky) and its xla
             body (tournament, row gather, ``vary_genome(pairing=
             "halves")``) with ``mate`` in turn the one point, uniform
             (0.1) and SBX (eta 20) crossovers, 1e6 x 100 float32, rbg
             keys, N = 1 and 2 generations: K2 once a generation, the best
             fitness must fall; card = CPU on the evaluation of every
             1000th row of the last generation, and on one whole
             generation at 2048 x 100 (rastrigin's fitness within
             ``FLAG_RTOL``);
41. the suites — ``bench_nsga2.py``'s generation (bounded SBX,
             polynomial mutation, ``sel_nsga2`` at its default) at POP
             1e5 on ZDT2, ZDT3 (30 variables), ZDT4 (10: x1 in [0, 1], the
             rest in [-5, 5], per-gene bounds), ZDT6 (10), DTLZ1 (k 5),
             DTLZ3-6 (k 10, DTLZ4 at alpha 100) and DTLZ7 (k 20) at three
             objectives: one generation at pool 1024 card against CPU
             (offspring and values bitwise, selection equal, ranks equal
             to the count peel's), then N = 1 and 2 generations, the
             hypervolume at ``HV_REF`` (points inside it,
             it must not fall; K5 once at three objectives, held against
             the plain float64 sweep and the host tier), K4's launches by
             problem, and K4 (C = 1024) and K5 against their plain
             versions on each DTLZ population;
42. examples — ``deap_tpu_torch/examples/``'s tsp (24 of its 80
             generations), nqueens (25 of 150), knn, evoknn (5 of 40),
             evoknn_jmlr (10 of 50), kursawefct (3 of 50), es/fctmin (40
             of 120) and bbob (10 of 60) on the card, each with its check
             (tours stay permutations, the Kursawe front in bounds, the
             sphere below 1, accuracy above 0.5, bbob's table finite),
             card = CPU on the final population of the same run (knn on
             every 16th feature mask; bbob's CMA-ES on its first
             generation, as ``eigh`` rounds differently on the two
             devices);
43. creator and checkpoint — ``creator.IndividualSpec.init_population``
             at 1e6 x 100 (``ops.init.uniform``) in float32, bfloat16 and
             int8 storage, card = CPU on every 1000th row; then the
             flagship generation (``ea_simple``'s ``ea_step``, megakernel
             engine, K2) from it: 2 generations, ``save_checkpoint`` of
             (key, population), 2 more, ``load_checkpoint`` onto the card
             and 2 generations from it, which must equal the undisturbed
             4 bit for bit; again with ``async_save_checkpoint``
             overlapping the next generation; save, load and host-copy
             seconds and MB/s, K2 once a generation;
44. DE       — ``de_step`` rand/1/bin at POP 8192 x 100 on rastrigin (in
             fixed float32 forms, the same bits on both devices): ms a
             generation (median of 3) and the donor shuffle's share
             (one (n, n - 1) permutation, two sort rounds); one
             generation at 2048 x 100 card = CPU bit for bit;
45. PSO      — ``pso_step`` at 1e6 x 100 on that rastrigin, the
             canonical rule with speed limits and the constriction rule
             (ms a generation, median of 3; two steps at 2048 rows card =
             CPU bit for bit), and the multiswarm at
             ``examples/pso/multiswarm.py``'s defaults (ms a generation);
46. EDA      — EMNA at BASELINE config 3's width (N = 100, lambda =
             4096, mu = 2048) on the sphere and PBIL (100 bits, lambda =
             4096) on OneMax through ``ea_generate_update``: ms a
             generation; one generation from the same state and key card
             = CPU bit for bit;
47. migration — ``mig_ring_stacked`` over 8 islands of 131072 x 100, the
             best 1024 of each island replacing the worst 1024 of the
             next, on the default ring (a roll) and a non-cyclic
             ``migarray`` (a gather): card = CPU bit for bit, ms a call;
48. library examples — the ten of ``deap_tpu_torch/examples/``
             (``ga/onemax_multidemic``, ``de/basic``, ``de/sphere`` at 30
             of its 150 generations, ``de/dynamic``, ``pso/basic``,
             ``pso/multiswarm`` at 20 generations, ``eda/emna``,
             ``eda/pbil``, ``coev/coop_evol``, ``coev/hillis``) at
             ``tests/test_examples.py``'s arguments otherwise, on the
             card, each with that table's check, card = CPU bit for bit
             on the final population or state of the same run; then
             each of phases 43-48's seconds.  No kernel of the port runs
             on phases 44-48 (their launch counts are printed, zero);
49. the last examples — the seventeen of ``deap_tpu_torch/examples/``
             ported last, each at its published width and a cut depth
             (``REST_EXAMPLE_ARGS``, ``REST_CMA_ARGS``): onemax,
             onemax_short, knapsack, xkcd, evosn (with
             ``sortingnetwork``'s model on 64 random networks), mo_rhv,
             onefifth, cma_mo, speciation, coop_gen, coop_niche,
             coop_adapt (``coop_base``'s rounds) and coev/symbreg on the
             card and on the CPU from the same seed, bit for bit on the
             final state and result; cma_minfct, cma_one_plus_lambda,
             cma_plotting and cma_bipop (its first regime's first 20
             generations and its stopping test on both devices) on the
             card, then one generation from the card's state on both
             devices within ``CMA_RTOL`` (``sqrt_C``: ``B diag(diagD)
             Bᵀ``), and the CPU's run for its time; card and CPU
             seconds and the launches of each; K4
             must launch on evosn's 3-objective ``sel_nsga2`` (the count
             peel).  Their ``tests/test_examples.py`` checks run in
             tier-1 (``tests/test_torch_examples_rest_smoke.py``);
50. streaming — ``ea_simple`` on OneMax (300 x 100, 7 generations) with
             ``stream_every=3`` in both modes on the card: its lines and
             logbook equal to the CPU run's, its population and logbook
             to the card's run without streaming; then phases 49-50's
             seconds;
51. distribution, R = 1 over NCCL in this process — single-device
             references first: the flagship ``ea_simple`` (megakernel, 1e6
             x 100, DIST_GENS generations) and a live-mask step after it,
             ``sel_nsga2(nd="peel")`` on a DTLZ2 pool of 2e5 points and
             ``hypervolume_device`` in float64 on it; K2 and K1 at
             ``row_base0 = 5e5`` against their plain versions and a launch
             from row 0, bit for bit; K5 over prefixes (3000, 7000] of
             8192 uniform points against the plain slabs (HV_RTOL); then on
             a one-rank NCCL mesh: ``ea_simple`` on the
             ``megakernel_sharded`` engine (K2), its live-mask step (K1),
             ``sel_nsga2_sharded`` (``peel`` with both exchanges and
             ``grid``: K4), ``hypervolume_sharded`` (K5), each equal to its
             reference (the hypervolume within 1e-11), and the sharded
             checkpoint of the flagship saved and loaded bit for bit;
52. distribution, R = 2 on the one card over gloo (CUDA tensors staged
             through host memory) — one pair of rank processes runs every
             check of phase 51 on its half (rank 1's K2 and K1 at
             ``row_base0 = 5e5``), compared by digests of each rank's
             rows with the references; its checkpoint loaded at R = 1 bit
             for bit; ``onemax_sharded`` at its published width and
             ``onemax_multihost``'s run at R = 2, both at DIST_EX_GEN (20
             of 40) generations, card = CPU (a second pair on the CPU,
             beside the card pair), ``onemax_island`` as published card =
             CPU; ``ea_simple_islands`` with ``mesh=`` on 4 islands (2 a
             rank, the ring's cross-rank leg a staged ``batch_isend_irecv``)
             equal to its ``mesh=None`` run; each rank's launch counts,
             each sharded path's kernel launched at every R;
53. distribution, R = min(4, cards) over NCCL — where the host has two
             cards or more; on one card the phase says that it did not run
             and why (NCCL refuses two ranks on one card);
54. out-of-core — first, beside the build — the streamed engine
             (``deap_tpu_torch.bigpop``) at
             ``tools/bench_ooc.py``'s flagship (rastrigin, two-point,
             Gaussian mutation, rank tournaments): (a) one generation at
             2,097,152 x 100 float32 in slices of 8192 from a
             ``HostPopulation``, bit for bit against the resident
             ``ea_step`` from the same key, its peak device bytes under
             ``ooc_peak_bound`` (the plan's O(pop) tensors and a few
             slices: under half the 839 MB genome), each leg's seconds and
             the host split (gather, copies waited on, dispatch, store);
             (b) at 262,144 x 100 int8 (``cx_uniform`` +
             ``mut_flip_bit``) and bfloat16 (``cx_one_point`` +
             ``mut_gaussian``) storage, an odd population (a 1-row tail
             slice), a 2-row tail slice and a live-mask ask / tell
             generation, each bit for bit against the resident step; (c)
             ``ea_simple`` on the streamed engine for 2 generations
             against the xla engine's: population, logbook and hall of
             fame; (d) ``run_streamed_resumable`` preempted at the first
             slice boundary of generation 2 and resumed, against (c);
             (e) the streamed step at 4096 x 100 on the card against the
             CPU (the fitness the largest gene: exact on both).  No
             kernel of the port runs on it (its launch counts are
             printed, zero);
55. serving (``deap_tpu_torch.serve``) on the card: (a) one megakernel
             session at the flagship's 10^6 x 100 float32 (bucket
             1,048,576 rows) through ``EvolutionService``: 3 steps and one
             ask / tell, bit for bit against ``ea_step`` / ``ea_ask`` /
             ``ea_tell`` called on the same padded state, K1's launches
             counted (3, then 1 for the ask), K1 held to its plain
             version on the parents ``fused_generation(live_n=...)``
             gathers at the bucket's 1,048,576 rows, seconds per step
             served and direct with the service's execute wall beside
             them, the ask's offspring copy timed alone, the p50 latency
             gauges; (b) the same session over
             the wire (``NetServer`` + ``RemoteService`` on loopback, the
             400 MB frames uncompressed): 3 steps and ``population()``,
             bit for bit against (a), MB/s each way; (c) four sessions of
             40,000-65,536 x 100 in one bucket at ``max_batch=4``,
             stepped together twice, each bit for bit against itself
             served alone, one step program, K1 held to its plain version
             at the bucket's 65,536 rows; (d) the CLI's demo toolbox
             (``Quarantine("penalize")``) with a NaN-emitting rastrigin,
             a mixed fleet over the wire, card = CPU bit for bit, the
             sentinel on quarantined rows, cache hits and no non-finite
             cache entry; (e) a streamed session at 262,144 x 100 against
             a resident one, both checkpointed
             (``save_session_states``), restored into a new service and
             stepped twice against the undisturbed run, and
             ``run_resumable(loop=streamed_ea_simple)`` preempted at
             generation 2 and resumed against its undisturbed run;
56. the serving fleet (``deap_tpu_torch.serve.router``) on the card:
             three ``EvolutionService(max_batch=4)`` instances behind
             port ``NetServer``s with the flagship's megakernel toolbox,
             a ``FleetRouter`` (tenant ``capped`` held to one session)
             behind a ``RouterServer``, a ``RemoteService`` on the
             router: (c)'s four sessions of 40,000-65,536 x 100 (one
             65,536-row bucket) opened as one tenant and co-located by
             affinity, stepped twice, failed over by hand (``POST
             /v1/admin/fleet/failover``), stepped twice more through the
             same client, each bit for bit against the same keys and
             populations stepped 4 times in one undisturbed service; K1
             launched 16 times on the fleet path; a direct client of
             the drained instance follows its redirect; the capped
             tenant's second session is a typed ``TenantQuotaExceeded``;
             the router's counters (1 failover, 4 sessions moved, 1
             quota rejection); one scrape of ``/v1/admin/fleet?format=
             prometheus`` labels every live instance; ``serve.top
             --once --json``'s fleet counters are its instances' sums;
             seconds a step routed and alone, the failover's seconds and
             the bytes the router relayed;
57. the ``kernels`` line, the card's name and power limit, and the result
   line.

``python3 chip_smoke.py --profile`` adds, after phases 5, 9, 12, 15, 35
and 37, a per-stage and ``torch.profiler`` breakdown of a main-path
generation of each path.

Phases 30, 32, 33, 38, 42 and 48 run their CPU side in a second
interpreter (:class:`CpuSide`, no card in sight, lower priority) beside
the card's runs, and compare once both are done (phase 30's DCD check
after phase 32's).  The card seconds of phases 31 and 32 (beside phase
30's CPU side), 33, 38, 42 and 48 are measured with a CPU side running,
and cannot be set beside those of the runs before it had one.  Phase
20's edge plains are computed on one thread in a CPU side started
after the build; no other CPU side starts early: one that ran beside
phases 4-12 slowed the in-line CPU references several times over.
Phase 29 (evopole, launch-bound) runs its CPU reference in this process
after its card runs.

Tolerance: K1-K4, K6 and P1-P5 must equal their plain versions bit for
bit (the stated ulp bound is 0; K6's NaNs compare equal whatever their
payload; P3's lookup is exact).
K5's running heights are exact and its sums are taken in another order
than the plain version's (with fused multiply-adds): relative 1e-4 in float32 and 1e-11 in float64,
on the total and on every slab partial (relative to the total).  A
mismatch prints the measured bound and fails.
CMA-ES (phase 23): the card's and the CPU's matrix products and
``eigh`` (cuSOLVER's Jacobi solver on the card, LAPACK on the host)
round differently, so each state field must agree within relative
1e-4, and ``|B_cardᵀ B_cpu|`` with I within 1e-2.
Phases 43-48: the resumed flagship run equal to the undisturbed one, and
init_population (every 1000th row), the DE / PSO / EDA / migration steps
and the library examples card = CPU, all bit for bit.
Phases 49-50: the thirteen examples above card = CPU bit for bit, the
streamed lines byte for byte; the four CMA-ES examples a generation
within ``CMA_RTOL``.
Phases 51-53: every sharded genome, index and launch path bit for bit
against the single-device run at every rank count; the sharded float64
hypervolume within DIST_HV_RTOL (1e-11, relative) of
``hypervolume_device`` (the per-rank partials add in another order).
Phases 39-42 (no kernel of their own): every new operator, selection,
benchmark function and example card = CPU bit for bit, except
``rotate``'s matrix product (``ROTATE_RTOL``, 1e-5) and rastrigin's
fitness in the xla body (``FLAG_RTOL``, 1e-5: ``torch.cos`` and the sum
in each device's order); bbob's CMA-ES on its first generation only.
Phase 54: every leg bit for bit (tolerance 0) against the resident step
on the card, or (e) the CPU.
Phase 55: every leg bit for bit (tolerance 0): against the port's own
calls on the card, the session served alone, the CPU (the demo's
rastrigin in XLA's float32 form), or the undisturbed run.
Any failed phase exits non-zero without the result line.  No JAX, and
nothing of the JAX package, is imported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

POP, DIM = 1_000_000, 100
NGEN = 30
TIMING_PAIRS = 3
LIVE_GENS = 3
# the NSGA-II slice: bench_nsga2.py's DTLZ2 sub-config at BENCH_POP
MO_POP, MO_NOBJ, MO_DIM = 100_000, 3, 12
MO_NGEN = 3
MO_PAIRS = 1
MO_HEAD_GENS = 3
MO_CXPB, MO_MUTPB, MO_SIGMA, MO_INDPB = 0.6, 0.3, 0.1, 1.0 / 12
FRONT_CHUNK = 1024
ULP_BOUND = 0                      # kernels equal their plain versions
# bench_nsga2.py as published: SBX and polynomial mutation (eta 20), cxpb
# 0.9, mutpb 1.0, sel_nsga2(nd="auto", front_chunk=1024), POP 1e5
BN_POP, BN_NGEN, BN_PAIRS = 100_000, 3, 1
BN_CXPB, BN_MUTPB, BN_ETA = 0.9, 1.0, 20.0
BN_PROBLEMS = {"dtlz2": (3, 12), "zdt1": (2, 30)}     # nobj, variables
BN_REF_POP = 1024
BN_B_GENS = 3
HV_REF = {"dtlz2": (1.1, 1.1, 1.1), "zdt1": (11.0, 11.0)}
HV_UNIFORM_N = 8192                # bench_weakscaling.py's hv layout, 1 chip
HV_SUBSAMPLE = 512                 # what the host tier takes in a moment
HV_RTOL = {"float32": 1e-4, "float64": 1e-11}
CXPB, MUTPB, MU, SIGMA, INDPB = 0.9, 0.5, 0.0, 0.3, 0.05
# K3 beyond the two main-path shapes: (parents, children, genes)
K3_EDGES = ((100_000, 123_457, 1), (100_000, 65_537, 3),
            (100_000, 77_777, 12), (100_000, 54_321, 100),
            (20_000, 30_011, 1000))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(n_bytes: float, ints: float = 0, flts: float = 0,
             dbls: float = 0):
    """The least time of a kernel's work at the H100's data-sheet peaks
    (:func:`deap_tpu_torch.kernels.peaks.bound_ms`)."""
    from deap_tpu_torch.kernels.peaks import bound_ms as least
    return least(n_bytes, ints, flts, dbls)


_START = time.perf_counter()


def phase(name: str, card_line: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script began."""
    print(json.dumps({"phase": name, "card": card_line, **fields,
                      "elapsed_s": time.perf_counter() - _START}),
          flush=True)


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: seconds a CPU side may take (it runs beside its phase's card side)
CPU_SIDE_TIMEOUT = 900.0
_CPU_SIDES: list = []


class CpuSide:
    """``chip_smoke.<name>(**kwargs)`` (CPU tensors and plain values) in a
    fresh interpreter that sees no card
    (``CUDA_VISIBLE_DEVICES`` empty), at a lower scheduling priority,
    started now; :meth:`result` waits for it.  The card = CPU phases of
    the examples start their CPU side so and run their card side
    meanwhile: the two share nothing, and a CPU result does not depend on
    the process that computes it.  Every side still running when the
    script exits is killed."""

    def __init__(self, name: str, **kwargs):
        import torch
        self.name = name
        self.dir = os.path.join(ROOT, "chip_smoke_out", "cpu_side", name)
        os.makedirs(self.dir, exist_ok=True)
        self.out = os.path.join(self.dir, "out.pt")
        self.log_path = os.path.join(self.dir, "log")
        self.log = open(self.log_path, "w")
        torch.save({"name": name, "out": self.out, "kwargs": kwargs},
                   os.path.join(self.dir, "spec.pt"))
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-side",
             os.path.join(self.dir, "spec.pt")], cwd=ROOT,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
            stdout=self.log, stderr=subprocess.STDOUT,
            preexec_fn=lambda: os.nice(10))
        _CPU_SIDES.append(self.proc)

    def result(self):
        import torch
        try:
            rc = self.proc.wait(CPU_SIDE_TIMEOUT)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = "killed at its time limit"
        self.log.close()
        if rc != 0:
            with open(self.log_path) as f:
                tail = f.read()[-3000:]
            fail(f"CPU side {self.name}: exit {rc}\n{tail}")
        return torch.load(self.out, weights_only=False)


def _kill_cpu_sides() -> None:
    for proc in _CPU_SIDES:
        if proc.poll() is None:
            proc.kill()


def _cpu_side_main(spec_path: str) -> int:
    """The ``--cpu-side`` entry: run the named function, save its result."""
    import torch
    spec = torch.load(spec_path, weights_only=False)
    result = globals()[spec["name"]](**spec["kwargs"])
    tmp = spec["out"] + ".tmp"
    torch.save(result, tmp)
    os.replace(tmp, spec["out"])
    return 0


def ulp_gap(a, b) -> int:
    """Largest distance in units in the last place between two float32 (or
    narrower, widened) tensors; 0 means bitwise-equal."""
    import torch
    a, b = a.float().contiguous(), b.float().contiguous()
    ia = a.view(torch.int32).to(torch.int64)
    ib = b.view(torch.int32).to(torch.int64)
    # map the sign-magnitude bit patterns onto one ordered integer line
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max().item()) if a.numel() else 0


def tile_counts(seed, knobs, n: int, dim: int) -> dict:
    """The data-dependent work of the tile function under this run's
    draws: pairs that mate, rows whose mutation gate opens, genes that
    mutate."""
    import torch
    from deap_tpu_torch.ops.generation import M32, _uniform_at
    useed = seed.reshape(()).to(torch.int64) & M32
    rows = torch.arange(n, dtype=torch.int64, device=seed.device)
    lanes = torch.arange(dim, dtype=torch.int64, device=seed.device)
    a_rows = rows[(rows & 16) == 0]
    mating = int((_uniform_at(useed, 1, a_rows, 0) < knobs[0]).sum().item())
    gated = rows[_uniform_at(useed, 2, rows, 0) < knobs[1]]
    mutated = 0
    for lo in range(0, gated.numel(), 1 << 17):   # bounded temporaries
        u = _uniform_at(useed, 3, gated[lo:lo + (1 << 17), None],
                        lanes[None, :])
        mutated += int((u < knobs[4]).sum().item())
    return {"pairs": n // 2, "mating_pairs": mating,
            "gated_rows": int(gated.numel()), "mutated_genes": mutated}


# Instructions the tile function needs (an FMA is one), counted from
# megakernel.cu and charged where the function needs them, not where the
# kernel's one-thread-per-gene layout repeats them:
#   one uniform (counter hash): 14 integer (counter 3, seed xor 1, mix32 8,
#     shift 1, conversion 1) and 1 float (the 2^-24 scale);
#   per pair: draw 1 at three lanes and the cxpb compare; per mating pair
#     the cut points, 10 integer and 4 float;
#   per row: the gate (draw 2) and its compare;
#   per gene of a mating row: swap test and select, 3 integer;
#   per gene of a gated row: draw 3 and the indpb compare;
#   per mutated gene: XLA's erf_inv over log1p and the update, 5 integer
#     and 70 float, plus widening and narrowing in a narrow storage.
# A gene that is only copied or only swapped moves its stored bits as
# they are.
_HASH = (14, 1)
_MUTATE = (5, 70)
_WIDEN_NARROW = {"float32": (0, 0), "bfloat16": (2, 0), "int8": (2, 4)}


def tile_ops(c: dict, n: int, dim: int, dtype: str):
    """``(integer, float)`` instructions of the tile over ``n`` rows."""
    hi, hf = _HASH
    ints = (3 * c["pairs"] * hi + 10 * c["mating_pairs"] + n * hi
            + 3 * 2 * c["mating_pairs"] * dim + c["gated_rows"] * dim * hi
            + c["mutated_genes"] * (_MUTATE[0] + _WIDEN_NARROW[dtype][0]))
    flts = (c["pairs"] * (3 * hf + 1) + 4 * c["mating_pairs"]
            + n * (hf + 1) + c["gated_rows"] * dim * (hf + 1)
            + c["mutated_genes"] * (_MUTATE[1] + _WIDEN_NARROW[dtype][1]))
    return ints, flts


def vary_check(kernels, G, parents, seed, knobs, dim: int, st):
    """K1 on stored ``parents`` against its plain version (widen, tile,
    narrow) on the same inputs: ``(ulp_gap, max_abs_err, ms, plain_ms,
    device_ms)``, ``device_ms`` with the launches queued
    (:func:`deap_tpu_torch.kernels.kernel_times.queued_ms`)."""
    import torch
    from deap_tpu_torch.kernels.kernel_times import queued_ms

    def plain_vary():
        return G._narrow(G._vary_tile_plain(
            G._widen(parents, st.dtype, st.scale), seed, knobs, dim),
            st.dtype, st.scale)

    k1 = kernels.launch_vary(parents, seed, knobs, dim=dim, dtype=st.dtype,
                             scale=st.scale)
    p1 = plain_vary()
    torch.cuda.synchronize()
    gap = ulp_gap(k1, p1)
    err = float((k1.float() - p1.float()).abs().max().item())

    def launch():
        kernels.launch_vary(parents, seed, knobs, dim=dim, dtype=st.dtype,
                            scale=st.scale)
    ms = cuda_ms(launch)
    plain = cuda_ms(plain_vary, reps=3, warm=1)
    return gap, err, ms, plain, queued_ms(launch)


def _wall_ms(fn, reps: int = 5) -> float:
    """Host-clock ms per call of ``fn`` over synchronized repeats: the
    larger of its launch cost and its device time."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def _profile_window(run, gens: int) -> dict:
    """``torch.profiler`` over ``run()`` (``gens`` generations): wall ms,
    device busy ms, idle share and kernel launches per generation, and
    the kernels that took most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))

    kernels_ = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in kernels_)
    top = sorted(kernels_, key=dev_us, reverse=True)[:12]
    return dict(
        gens=gens, wall_ms=wall / gens * 1e3,
        device_busy_ms=busy_us / gens / 1e3 if busy_us else "not measured",
        device_idle_share=(1.0 - busy_us / 1e6 / wall if busy_us
                           else "not measured"),
        kernel_launches=sum(e.count for e in kernels_) / gens,
        top_kernels=[{"kernel": e.key[:60], "ms": dev_us(e) / gens / 1e3,
                      "calls": e.count / gens} for e in top])


def profile_main_path(ea_step, key, pop, tb, card_line, gens=5) -> None:
    """``--profile``: where a main-path generation's time goes — the wall
    cost of each stage called alone, then ``torch.profiler`` over
    ``gens`` generations: device busy time and kernel launches against
    the wall clock, and device time by operator."""
    import torch

    from deap_tpu_torch import random
    from deap_tpu_torch.algorithms import evaluate_population
    from deap_tpu_torch.base import lex_sort_indices
    from deap_tpu_torch.ops import generation as G
    from deap_tpu_torch.ops.selection import tournament_positions

    n, dim = pop.genome.shape
    k_sel, k_var = random.split(key)
    w = pop.fitness.masked_wvalues()
    order = lex_sort_indices(w).to(torch.int32)
    pos = tournament_positions(k_sel, n, n, 3)
    seed = G._seed_from_key(k_var)
    knobs = G._knobs((CXPB, MUTPB, MU, SIGMA, INDPB), pop.genome.device)
    stages = {
        "split key (3)": lambda: random.split(key, 3),
        "fitness sort": lambda: lex_sort_indices(w),
        "tournament_positions": lambda: tournament_positions(k_sel, n, n, 3),
        "seed word": lambda: G._seed_from_key(k_var),
        "K2 gather+vary": lambda: G.megakernel_gather_vary(
            order, pos, pop.genome, seed, knobs, dim=dim,
            storage=G.GenomeStorage()),
        "evaluate (vmap rastrigin)": lambda: evaluate_population(tb, pop),
        "whole ea_step": lambda: ea_step(key, pop, tb, CXPB, MUTPB),
    }
    phase("profile: stage wall ms (synchronized, alone)", card_line,
          stages={k: _wall_ms(f) for k, f in stages.items()})

    for _ in range(2):
        key, pop, _ = ea_step(key, pop, tb, CXPB, MUTPB)

    def run():
        k, p = key, pop
        for _ in range(gens):
            k, p, _ = ea_step(k, p, tb, CXPB, MUTPB)

    phase("profile: ea_step megakernel, per generation", card_line,
          **_profile_window(run, gens))


# ---------------------------------------------------------------------------
# the NSGA-II slice: K3, K4 and the (mu + lambda) loop
# ---------------------------------------------------------------------------


def var_or_counts(ia, i2, code, seed, knobs, dim: int) -> dict:
    """The data-dependent work of K3 under this run's draws: crossover and
    mutation rows, partner genes taken, genes mutated."""
    import torch
    from deap_tpu_torch.ops.generation import (M32, _cut_points,
                                               _uniform_at)
    useed = seed.reshape(()).to(torch.int64) & M32
    rows = torch.arange(code.numel(), dtype=torch.int64, device=code.device)
    cx = rows[code == 0]
    u0 = _uniform_at(useed, 4, cx, 0)
    u1 = _uniform_at(useed, 4, cx, 1)
    lo, hi = _cut_points(u0, u1, dim)
    mut = rows[code == 1]
    lanes = torch.arange(dim, dtype=torch.int64, device=code.device)
    mutated = 0
    for s in range(0, mut.numel(), 1 << 17):     # bounded temporaries
        u = _uniform_at(useed, 5, mut[s:s + (1 << 17), None], lanes[None, :])
        mutated += int((u < knobs[2]).sum().item())
    return {"rows": int(code.numel()), "cx_rows": int(cx.numel()),
            "mut_rows": int(mut.numel()),
            "partner_genes": int((hi - lo).sum().item()),
            "mutated_genes": mutated}


def var_or_bound(c: dict, dim: int, elt: int, dtype: str):
    """K3's least time: parent rows read and children written once, the
    partner genes it takes, the three index/code words per row; the cut
    pair (two draws and the cut law) per crossover row, the swap test per
    gene of a crossover row, the gene draw per gene of a mutation row,
    ``erf_inv`` and the conversions per mutated gene."""
    hi, hf = _HASH
    n = c["rows"]
    n_bytes = 2 * n * dim * elt + c["partner_genes"] * elt + 12 * n + 16
    ints = (n + c["cx_rows"] * (2 * hi + 10) + 3 * c["cx_rows"] * dim
            + c["mut_rows"] * dim * hi
            + c["mutated_genes"] * (_MUTATE[0] + _WIDEN_NARROW[dtype][0]))
    flts = (c["cx_rows"] * (2 * hf + 4) + c["mut_rows"] * dim * (hf + 1)
            + c["mutated_genes"] * (_MUTATE[1] + _WIDEN_NARROW[dtype][1]))
    return bound_ms(n_bytes, ints, flts)


def counts_bound(C: int, n: int, m: int):
    """K4's least time: every (row, column) pair is 2m float compares
    (``>=`` and ``>`` per objective, each chain folded through the
    compare's predicate input) and at least one instruction to count it,
    all at the compare/integer rate; the rows, the points and the counts
    move once.  ``python -m deap_tpu_torch.kernels.sass`` counts what
    the compiled loop spends per pair (it also joins the two chains,
    counts in two instructions, and loads and loops)."""
    return bound_ms(4 * (C * m + n * m + n), C * n * (2 * m + 1))


def dtlz2_values(genome):
    import torch
    from deap_tpu_torch import benchmarks
    return torch.stack(benchmarks.dtlz2(genome, MO_NOBJ), 1)


def front_distance(values) -> float:
    """DTLZ2's distance to its front: the mean of ``|f|_2 - 1``."""
    return float((values.double().norm(dim=1) - 1.0).mean().item())


def nsga2_toolbox():
    from deap_tpu_torch import base, benchmarks
    from deap_tpu_torch.ops import crossover, emo, mutation
    tb = base.Toolbox()
    tb.register("evaluate", benchmarks.dtlz2, obj=MO_NOBJ)
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_gaussian, mu=0.0, sigma=MO_SIGMA,
                indpb=MO_INDPB)
    tb.register("select", emo.sel_nsga2, nd="peel", front_chunk=FRONT_CHUNK)
    tb.generation_engine = "megakernel"
    return tb


def k3_phase(kernels, G, genome, key, card_line, n: int, dim: int,
             knobs_vals, storages, lam: int | None = None) -> dict:
    """K3 against its plain version: ``lam`` (default ``n``) children of
    ``n`` parents of ``dim`` genes; returns per dtype ``(max_abs_err, ms,
    plain_ms, bound_ms, bound_by, device_ms)``, ``device_ms`` with the
    launches queued (:func:`deap_tpu_torch.kernels.kernel_times.queued_ms`)."""
    import torch
    from deap_tpu_torch.kernels.kernel_times import queued_ms
    lam = n if lam is None else lam
    ia, i2, code, seed = G._var_or_draws(key, n, lam, MO_CXPB, MO_MUTPB)
    knobs = torch.tensor(knobs_vals, dtype=torch.float32,
                         device=genome.device)
    counts = var_or_counts(ia, i2, code, seed, knobs, dim)
    out = {}
    for st in storages:
        gs = st.to_storage(genome)
        before = kernels.LAUNCHES["megakernel_var_or"]
        k3 = kernels.launch_var_or(gs, ia, i2, code, seed, knobs, dim=dim,
                                   dtype=st.dtype, scale=st.scale)
        p3 = G._var_or_plain(gs, ia, i2, code, seed, knobs, dim, st)
        torch.cuda.synchronize()
        gap = ulp_gap(k3, p3)
        err = float((k3.float() - p3.float()).abs().max().item())
        launches = kernels.LAUNCHES["megakernel_var_or"] - before

        def launch():
            kernels.launch_var_or(gs, ia, i2, code, seed, knobs, dim=dim,
                                  dtype=st.dtype, scale=st.scale)
        ms = cuda_ms(launch)
        dev_ms = queued_ms(launch)
        plain = cuda_ms(lambda: G._var_or_plain(gs, ia, i2, code, seed,
                                                knobs, dim, st),
                        reps=3, warm=1)
        b, by = var_or_bound(counts, dim, gs.element_size(), st.dtype)
        phase("K3 megakernel_var_or vs plain", card_line, storage=st.dtype,
              shape=[n, dim], lam=lam, ulp_gap=gap, ulp_bound=ULP_BOUND,
              max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain,
              bound_ms=b, bound_by=by, work=counts, launches=launches)
        if gap > ULP_BOUND:
            fail(f"K3 {st.dtype} at {lam} x {dim} from {n} parents: {gap} "
                 f"ulp from its plain version (bound {ULP_BOUND})")
        out[st.dtype] = (err, ms, plain, b, by, dev_ms)
        del gs, k3, p3
        torch.cuda.empty_cache()
    return out


def k4_phase(kernels, D, key, card_line) -> dict:
    """K4 against its plain counts on the DTLZ2 values of a real pool:
    a front chunk of C = 1024 rows and the initial counts' C = n, with
    -inf sentinel rows and duplicated points; then SPEA2's strength form
    at C = n on ZDT1 and DTLZ2 values, with +inf rows and duplicates."""
    import torch
    from deap_tpu_torch import benchmarks, random
    n = 2 * MO_POP
    genome = random.uniform(key, (n, MO_DIM))
    w = -dtlz2_values(genome)
    w[:256] = w[256:512]                               # duplicated points
    active = torch.ones(n, dtype=torch.bool, device=w.device)
    active[::9] = False                                # -inf rows below
    out = {}
    for C in (FRONT_CHUNK, n):
        if C == n:
            rows = torch.where(active[:, None], w, float("-inf"))
        else:
            rows = w[torch.arange(0, n, n // C, device=w.device)[:C]].clone()
            rows[-24:] = float("-inf")                 # a padded chunk
        rows = rows.contiguous()
        before = kernels.LAUNCHES["rows_dominate_counts"]
        k4 = kernels.launch_rows_dominate_counts(rows, w)
        p4 = D._rows_dominate_counts_plain(rows, w)
        torch.cuda.synchronize()
        equal = torch.equal(k4, p4)
        err = float((k4 - p4).abs().max().item())
        ms = cuda_ms(lambda: kernels.launch_rows_dominate_counts(rows, w),
                     reps=10 if C < n else 3, warm=1)
        plain = cuda_ms(lambda: D._rows_dominate_counts_plain(rows, w),
                        reps=3 if C < n else 1, warm=1 if C < n else 0)
        b, by = counts_bound(C, n, MO_NOBJ)
        phase("K4 rows_dominate_counts vs plain", card_line, rows=C,
              points=n, nobj=MO_NOBJ, counts_equal=equal, max_abs_err=err,
              ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
              count_sum=int(k4.sum().item()),
              launches=kernels.LAUNCHES["rows_dominate_counts"] - before)
        if not equal:
            fail(f"K4 at C={C}: counts differ from the plain version")
        out[C] = (err, ms, plain, b, by)
    # SPEA2's strength: the roles swapped, rows_dominate_counts(-w, -w) at
    # C = n, its masked -inf rows now +inf, for ZDT1 (m = 2) and DTLZ2
    k_z = random.fold_in(key, 2)
    w_zdt1 = -torch.stack(benchmarks.zdt1(random.uniform(k_z, (n, 30))), 1)
    for m, vals in ((2, w_zdt1), (MO_NOBJ, w)):
        v = vals.clone()
        v[:256] = v[256:512]                           # duplicated points
        v[::9] = float("-inf")                         # masked rows
        nw = (-v).contiguous()                         # they read +inf
        before = kernels.LAUNCHES["rows_dominate_counts"]
        k4 = kernels.launch_rows_dominate_counts(nw, nw)
        p4 = D._rows_dominate_counts_plain(nw, nw)
        torch.cuda.synchronize()
        equal = torch.equal(k4, p4)
        err = float((k4 - p4).abs().max().item())
        ms = cuda_ms(lambda: kernels.launch_rows_dominate_counts(nw, nw),
                     reps=3, warm=1)
        plain = cuda_ms(lambda: D._rows_dominate_counts_plain(nw, nw),
                        reps=1, warm=0)
        b, by = counts_bound(n, n, m)
        phase("K4 SPEA2 strength rows_dominate_counts(-w, -w) vs plain",
              card_line, rows=n, points=n, nobj=m, inf_rows=len(v[::9]),
              counts_equal=equal, max_abs_err=err, ms=ms, plain_ms=plain,
              bound_ms=b, bound_by=by, count_sum=int(k4.sum().item()),
              launches=kernels.LAUNCHES["rows_dominate_counts"] - before)
        if not equal:
            fail(f"K4 strength at m={m}: counts differ from the plain "
                 "version")
        out[("strength", m)] = (err, ms, plain, b, by)
    return out


def nsga2_reference_phase(card_line, key) -> None:
    """One NSGA-II generation at mu = lambda = 1024, card against CPU:
    the offspring bitwise, then the card's selection on the CPU pool's
    values against the CPU's indices, then the ``ea_step`` head's
    offspring (``sel_nsga2`` and K1) bitwise."""
    import torch
    from deap_tpu_torch import base, random
    from deap_tpu_torch.algorithms import ea_ask, evaluate_population, var_or
    n = 1024
    tb = nsga2_toolbox()
    k_g, k_var, k_sel = random.split(key.cpu(), 3)
    genome = random.uniform(k_g, (n, MO_DIM))
    pop = evaluate_population(tb, base.Population(
        genome, base.Fitness.empty(n, (-1.0,) * MO_NOBJ, device="cpu")))[0]
    dev = torch.device("cuda")
    pop_dev = base.Population(genome.to(dev), base.Fitness(
        pop.fitness.values.to(dev), pop.fitness.valid.to(dev),
        pop.fitness.weights))
    off_cpu = var_or(k_var, pop, tb, n, MO_CXPB, MO_MUTPB)
    off_dev = var_or(k_var.to(dev), pop_dev, tb, n, MO_CXPB, MO_MUTPB)
    same_off = torch.equal(off_cpu.genome.view(torch.int32),
                           off_dev.genome.cpu().view(torch.int32))
    pool = pop.concat(evaluate_population(tb, off_cpu)[0])
    idx_cpu = tb.select(k_sel, pool.fitness, n)
    idx_dev = tb.select(k_sel.to(dev), base.Fitness(
        pool.fitness.values.to(dev), pool.fitness.valid.to(dev),
        pool.fitness.weights), n)
    same_idx = torch.equal(idx_cpu, idx_dev.cpu())
    # the ea_step head (sel_nsga2, then K1) on the same parents
    head_cpu = ea_ask(k_var, pop, tb, MO_CXPB, MO_MUTPB)[1].genome
    head_dev = ea_ask(k_var.to(dev), pop_dev, tb, MO_CXPB, MO_MUTPB)[1].genome
    same_head = torch.equal(head_cpu.view(torch.int32),
                            head_dev.cpu().view(torch.int32))
    phase("reference: NSGA-II generation card vs CPU", card_line, mu=n,
          lam=n, dim=MO_DIM, offspring_bitwise=same_off,
          selection_equal=same_idx, head_offspring_bitwise=same_head)
    if not (same_off and same_idx and same_head):
        fail("NSGA-II generation on the card differs from the CPU path: "
             f"offspring equal {same_off}, selection equal {same_idx}, "
             f"ea_step head offspring equal {same_head}")


def fronts_per_generation(key, pop0, ngen: int):
    """Replay the first ``ngen`` generations of an ``ea_mu_plus_lambda``
    run, untimed, with a ``select`` that also ranks each pool by
    ``nondominated_ranks`` and keeps its number of fronts.  Returns the
    fronts per generation and the final population."""
    from deap_tpu_torch.algorithms import ea_mu_plus_lambda
    from deap_tpu_torch.ops import emo
    tb = nsga2_toolbox()
    fronts = []

    def select(k_sel, fitness, k):
        fronts.append(emo.nondominated_ranks(
            fitness.masked_wvalues(), method="peel",
            front_chunk=FRONT_CHUNK, stop_at_k=k)[1])
        return emo.sel_nsga2(k_sel, fitness, k, nd="peel",
                             front_chunk=FRONT_CHUNK)

    tb.register("select", select)
    pop, _ = ea_mu_plus_lambda(key, pop0, tb, MO_POP, MO_POP, MO_CXPB,
                               MO_MUTPB, ngen)
    return fronts, pop


def nsga2_main_path(kernels, card_line, key):
    """The NSGA-II ``ea_mu_plus_lambda`` at full width; returns the launch
    counts of its first timed run."""
    import torch
    from deap_tpu_torch import base, random
    from deap_tpu_torch.algorithms import ea_mu_plus_lambda
    from deap_tpu_torch.utils.support import Statistics
    tb = nsga2_toolbox()
    stats = Statistics(lambda p: p.fitness.values)
    stats.register("dist", lambda v: (v.double().norm(dim=1) - 1.0).mean())
    k_init, k_run = random.split(key)
    genome = random.uniform(k_init, (MO_POP, MO_DIM))

    def fresh():
        return base.Population(genome.clone(), base.Fitness.empty(
            MO_POP, (-1.0,) * MO_NOBJ, device=genome.device))

    def run(ngen):
        pop0 = fresh()
        torch.cuda.synchronize()
        t = time.perf_counter()
        pop, log = ea_mu_plus_lambda(k_run, pop0, tb, MO_POP, MO_POP,
                                     MO_CXPB, MO_MUTPB, ngen, stats=stats)
        torch.cuda.synchronize()
        return time.perf_counter() - t, pop, log

    run(1)                                     # warm the allocator
    kernels.reset_launches()
    t1, pop1, _ = run(MO_NGEN)
    launches = dict(kernels.LAUNCHES)
    fronts, replay = fronts_per_generation(k_run, fresh(), MO_NGEN)
    if not torch.equal(replay.genome, pop1.genome):
        fail("the untimed replay that counts fronts left another "
             "population than the timed run")
    del pop1, replay
    t2, pop2, log2 = run(2 * MO_NGEN)
    pairs = [(t1, t2)]
    for i in range(MO_PAIRS - 1):
        if i % 2:
            a, b = run(MO_NGEN)[0], run(2 * MO_NGEN)[0]
        else:
            b, a = run(2 * MO_NGEN)[0], run(MO_NGEN)[0]
        pairs.append((a, b))
    marginals = sorted((b - a) / MO_NGEN for a, b in pairs)
    per_gen = marginals[len(marginals) // 2]
    dist = log2.select("dist")
    final = pop2.fitness.values
    ok_shape = (tuple(pop2.genome.shape) == (MO_POP, MO_DIM)
                and tuple(final.shape) == (MO_POP, MO_NOBJ)
                and bool(torch.isfinite(pop2.genome).all())
                and bool(torch.isfinite(final).all())
                and bool(pop2.fitness.valid.all()))
    phase("main path: NSGA-II ea_mu_plus_lambda dtlz2", card_line,
          mu=MO_POP, lam=MO_POP, dim=MO_DIM, nobj=MO_NOBJ,
          ngen=[MO_NGEN, 2 * MO_NGEN], seconds=[list(p) for p in pairs],
          marginal_ms_per_gen=per_gen * 1e3,
          marginal_ms_range=[marginals[0] * 1e3, marginals[-1] * 1e3],
          linearity=[b / a for a, b in pairs],
          launches=launches,
          launches_per_gen={k: v / MO_NGEN for k, v in launches.items()},
          fronts_per_gen=fronts, distance_start=dist[0],
          distance_end=dist[-1], finite_and_shaped=ok_shape)
    if launches["megakernel_var_or"] != MO_NGEN:
        fail(f"K3 ran {launches['megakernel_var_or']} times in {MO_NGEN} "
             "NSGA-II generations (once per generation expected)")
    if launches["rows_dominate_counts"] < MO_NGEN:
        fail(f"K4 ran {launches['rows_dominate_counts']} times in "
             f"{MO_NGEN} NSGA-II generations (at least once each expected)")
    if not dist[-1] < dist[0]:
        fail(f"DTLZ2 distance did not fall: {dist[0]} -> {dist[-1]}")
    if not ok_shape:
        fail("final NSGA-II population is not finite, valid and shaped")
    return launches, pop2, tb


def nsga2_head_phase(kernels, G, card_line, key, pop, tb) -> tuple:
    """The NSGA-II head of ``ea_step`` (``sel_nsga2`` of ``pop`` parents,
    then K1).  First K1 on one generation's parents and knobs against
    its plain version in the three storage dtypes; then a few generations
    at full width with the launches counted.  Returns the launches and
    the per-dtype ``(max_abs_err, ms, plain_ms, device_ms, bound_ms,
    bound_by)`` of K1 at this shape."""
    import torch
    from deap_tpu_torch import random
    from deap_tpu_torch.algorithms import ea_step
    k_sel, k_var = random.split(key, 3)[1:]
    idx = tb.select(k_sel, pop.fitness, MO_POP)
    params = G.megakernel_variation_params(tb)
    seed = G._seed_from_key(k_var)
    knobs = G._knobs((MO_CXPB, MO_MUTPB, params["mut_mu"],
                      params["mut_sigma"], params["indpb"]), pop.genome.device)
    counts = tile_counts(seed, knobs, MO_POP, MO_DIM)
    checks = {}
    for st in (G.GenomeStorage("float32"), G.GenomeStorage("bfloat16"),
               G.GenomeStorage("int8", 1.0)):       # DTLZ2 genes: [0, 1]
        parents = st.to_storage(pop.genome[idx.long()]).contiguous()
        gap, err, ms, plain, dev_ms = vary_check(kernels, G, parents, seed,
                                                 knobs, MO_DIM, st)
        b, by = bound_ms(2 * MO_POP * MO_DIM * parents.element_size() + 24,
                         *tile_ops(counts, MO_POP, MO_DIM, st.dtype))
        phase("K1 megakernel_vary vs plain, NSGA-II head inputs", card_line,
              storage=st.dtype, shape=[MO_POP, MO_DIM], ulp_gap=gap,
              ulp_bound=ULP_BOUND, max_abs_err=err, ms=ms,
              device_ms=dev_ms, plain_ms=plain, bound_ms=b, bound_by=by,
              work=counts)
        if gap > ULP_BOUND:
            fail(f"K1 {st.dtype} on the NSGA-II head's parents: {gap} ulp "
                 f"from its plain version (bound {ULP_BOUND})")
        checks[st.dtype] = (err, ms, plain, dev_ms, b, by)

    d0 = front_distance(pop.fitness.values)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(MO_HEAD_GENS):
        key, pop, _ = ea_step(key, pop, tb, MO_CXPB, MO_MUTPB)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    ok = bool(torch.isfinite(pop.fitness.values).all()
              and pop.fitness.valid.all())
    phase("NSGA-II ea_step head (sel_nsga2 + K1)", card_line, pop=MO_POP,
          dim=MO_DIM, gens=MO_HEAD_GENS,
          ms_per_gen=secs / MO_HEAD_GENS * 1e3, launches=launches,
          distance_start=d0, distance_end=front_distance(pop.fitness.values),
          finite_and_valid=ok)
    if launches["megakernel_vary"] != MO_HEAD_GENS:
        fail(f"K1 ran {launches['megakernel_vary']} times in "
             f"{MO_HEAD_GENS} NSGA-II head generations")
    if launches["rows_dominate_counts"] < MO_HEAD_GENS or not ok:
        fail("the NSGA-II head did not count dominance through K4 or left "
             "an invalid population")
    return launches, checks


def profile_nsga2(key, pop, tb, card_line, gens=2) -> None:
    """``--profile`` for the NSGA-II path: the wall cost of each stage of
    a generation called alone, then ``torch.profiler`` over ``gens``
    generations of the loop."""
    import torch

    from deap_tpu_torch import random
    from deap_tpu_torch.algorithms import (ea_mu_plus_lambda,
                                           evaluate_population, var_or)
    from deap_tpu_torch.base import lexsort
    from deap_tpu_torch.ops import emo

    k_var, k_sel = random.split(key)
    off = evaluate_population(tb, var_or(k_var, pop, tb, MO_POP, MO_CXPB,
                                         MO_MUTPB))[0]
    pool = pop.concat(off)
    w, values = emo._wv_values(pool.fitness)
    n = w.shape[0]
    ones = torch.ones(n, dtype=torch.bool, device=w.device)
    counts = emo._dominator_counts(w, ones)
    ranks, _ = emo._peel_from_counts(w, counts, MO_POP, FRONT_CHUNK)
    dist = emo.assign_crowding_dist(values, ranks)
    stages = {
        "split key (3)": lambda: random.split(key, 3),
        "var_or (draws + K3)": lambda: var_or(k_var, pop, tb, MO_POP,
                                              MO_CXPB, MO_MUTPB),
        "evaluate (dtlz2, batched form)": lambda: evaluate_population(tb, off),
        "concat": lambda: pop.concat(off),
        "initial counts (K4, C = n)": lambda: emo._dominator_counts(w, ones),
        "peel (host-read rounds, K4 chunks)": lambda: emo._peel_from_counts(
            w, counts, MO_POP, FRONT_CHUNK),
        "crowding distance": lambda: emo.assign_crowding_dist(values, ranks),
        "final sort": lambda: lexsort([-dist, ranks]),
        "whole sel_nsga2": lambda: tb.select(k_sel, pool.fitness, MO_POP),
    }
    phase("profile: NSGA-II stage wall ms (synchronized, alone)", card_line,
          stages={k: _wall_ms(f, reps=3) for k, f in stages.items()})
    phase("profile: NSGA-II ea_mu_plus_lambda, per generation", card_line,
          **_profile_window(lambda: ea_mu_plus_lambda(
              key, pop, tb, MO_POP, MO_POP, MO_CXPB, MO_MUTPB, gens), gens))


# ---------------------------------------------------------------------------
# the GP slice: K6 and bench_gp.py's symbolic regression
# ---------------------------------------------------------------------------

# bench_gp.py's configuration at full width
GP_POP, GP_CAP, GP_NPOINTS = 4096, 64, 1024
GP_CXPB, GP_MUTPB = 0.5, 0.1
GP_NGEN, GP_PAIRS = 10, 1
GP_EA_GENS = 3
GP_REF_POP = 256
GP_TREE_ROWS = 64          # the per-tree registration's rows (a call a row)
GP_FITNESS_RTOL = 1e-5     # the user's MSE mean reduces in another order
# Instructions each executed token needs per point, as (integer and
# compare, float32, float64), counted from gp_interp.cu's algorithm and
# charged at the cheapest path: a push moves a value and needs none;
# the protected division a compare and a correctly rounded division
# (reciprocal, two Newton steps, residual and correction: 8); sin and
# cos the |y| < 0.75 path (3 integer for the path test, the double
# polynomial 9 / 11 and the two conversions); log, sqrt and logistic
# XLA's float32 forms; the boolean ops compares and a select.
GP_OP_COST = {
    "arg": (0, 0, 0), "const": (0, 0, 0), "add": (0, 1, 0),
    "sub": (0, 1, 0), "mul": (0, 1, 0), "div": (1, 8, 0), "neg": (0, 1, 0),
    "sin": (3, 0, 11), "cos": (3, 0, 13), "log": (6, 18, 0),
    "sqrt": (1, 5, 0), "lf": (4, 23, 0), "and": (4, 0, 0), "or": (4, 0, 0),
    "xor": (4, 0, 0), "not": (2, 0, 0), "if": (2, 0, 0)}


def gp_toolbox(dev, pset_kind: str = "bench", per_tree: bool = False,
               **options):
    """bench_gp.py's primitive set, data and toolbox on ``dev``
    (``deap_tpu_torch.probes.gp.bench_toolbox``, with its operator and
    selection ``options``); ``"all"`` is a second set with every opcode
    of K6's table, ``"semantic"`` the bench set with ``lf``."""
    from deap_tpu_torch.probes.gp import bench_toolbox
    return bench_toolbox(dev, pset_kind, per_tree, GP_CAP, GP_NPOINTS,
                         **options)


def gp_initial(tb, gen_init, key, n: int, nobj: int = 1):
    """``n`` half-and-half trees of depth 1-3, evaluated (``nobj``
    objectives)."""
    from deap_tpu_torch.probes.gp import bench_initial
    return bench_initial(tb, gen_init, key, n, nobj)


def gp_generation(tb, key, pop):
    """bench_gp.py's generation (``probes.gp.bench_generation``).
    Returns ``(key, offspring, idx)``."""
    from deap_tpu_torch.probes.gp import bench_generation
    return bench_generation(tb, key, pop, GP_CXPB, GP_MUTPB)


def gp_token_work(frozen, codes, lengths, n_points: int):
    """The tokens K6 executes on this input: per opcode, the tokens of
    the rows it runs (``length > 0``) times ``n_points``; and the bytes
    it must move (those tokens' codes and constants, the lengths, ``X``
    and the output)."""
    import torch
    from deap_tpu_torch.gp.interp_cuda import OPCODES
    t = frozen.tables(codes.device)
    p = torch.arange(codes.shape[1], device=codes.device)
    live = p[None, :] < lengths[:, None]
    ops = t["op_kind"][codes.long()][live].long()
    hist = torch.bincount(ops, minlength=len(OPCODES)).tolist()
    names = {v: k for k, v in OPCODES.items()}
    tokens = {names[i]: int(c) for i, c in enumerate(hist) if c}
    n_tok = sum(tokens.values())
    pop = codes.shape[0]
    n_bytes = (8 * n_tok + 4 * pop
               + 4 * n_points * len(frozen.pset.arguments)
               + 4 * pop * n_points)
    return tokens, n_bytes


def gp_bound(tokens: dict, n_bytes: int, n_points: int):
    """K6's least time: the larger of its bytes over the memory rate and
    its tokens' instructions over the integer, float32 and float64
    rates and the issue slots."""
    ints = sum(GP_OP_COST[k][0] * v for k, v in tokens.items()) * n_points
    flts = sum(GP_OP_COST[k][1] * v for k, v in tokens.items()) * n_points
    dbls = sum(GP_OP_COST[k][2] * v for k, v in tokens.items()) * n_points
    return bound_ms(n_bytes, ints, flts, dbls)


def nan_gap(a, b):
    """``(bitwise equal with NaN == NaN, max |a - b| elsewhere)``."""
    import torch
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan()
                                                           & b.isnan())
    diff = torch.where(same, 0.0, (a - b).abs().nan_to_num(float("inf")))
    return bool(same.all()), float(diff.max().item()) if diff.numel() else 0.0


def k6_check(kernels, card_line, label: str, frozen, genome, X) -> dict:
    """K6 against the plain interpreter on one input: bitwise, times and
    bound; fails on a mismatch."""
    import torch
    from deap_tpu_torch import gp
    from deap_tpu_torch.kernels.kernel_times import queued_ms
    codes, consts, lengths = (g.contiguous() for g in genome)
    t = frozen.tables(X.device)

    def kernel():
        return kernels.launch_gp_interp(codes, consts, lengths, X,
                                        t["op_kind"], t["arg_index"])

    def plain():
        return gp.run_stack_machine(codes, consts, lengths, X, frozen,
                                    codes.shape[1])

    k6, p6 = kernel(), plain()
    torch.cuda.synchronize()
    equal, err = nan_gap(k6, p6)
    ms = cuda_ms(kernel, reps=20, warm=2)
    dev_ms = queued_ms(kernel)
    plain_ms = cuda_ms(plain, reps=1, warm=0)
    tokens, n_bytes = gp_token_work(frozen, codes, lengths, X.shape[1])
    b, by = gp_bound(tokens, n_bytes, X.shape[1])
    run = lengths > 0
    phase(f"K6 gp_interp vs plain: {label}", card_line,
          shape=[*codes.shape, X.shape[1]], n_args=X.shape[0],
          bitwise_equal=equal, ulp_bound=ULP_BOUND, max_abs_err=err, ms=ms,
          device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
          rows_run=int(run.sum().item()),
          mean_length_run=float(lengths[run].float().mean().item())
          if bool(run.any()) else 0.0,
          tokens=tokens, nan_share=float(k6.isnan().float().mean().item()))
    if not equal:
        fail(f"K6 on {label}: differs from the plain interpreter "
             f"(max abs err {err})")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": b, "bound_by": by}


def gp_reference_phase(card_line, key, dev) -> None:
    """One bench generation at pop 256, card against CPU: the trees after
    ``var_and`` bitwise, the selection indices equal (the card is given
    the CPU's fitness), the fitness within ``GP_FITNESS_RTOL``."""
    import torch
    from deap_tpu_torch import base, random
    from deap_tpu_torch.algorithms import var_and
    cpu = torch.device("cpu")
    _, tb_cpu, ev_cpu, gen_cpu, _ = gp_toolbox(cpu)
    _, tb_dev, ev_dev, _, _ = gp_toolbox(dev)
    k_init, k_gen = random.split(key.cpu())
    pop = gp_initial(tb_cpu, gen_cpu, k_init, GP_REF_POP)
    for _ in range(3):          # a few generations: longer, varied trees
        k_gen, pop, _ = gp_generation(tb_cpu, k_gen, pop)
    pop_dev = base.Population(tuple(g.to(dev) for g in pop.genome),
                              base.Fitness(pop.fitness.values.to(dev),
                                           pop.fitness.valid.to(dev),
                                           pop.fitness.weights))
    _, off_cpu, idx_cpu = gp_generation(tb_cpu, k_gen, pop)
    _, off_dev, idx_dev = gp_generation(tb_dev, k_gen.to(dev), pop_dev)
    same_idx = torch.equal(idx_cpu, idx_dev.cpu())
    # var_and alone on the same parents
    k_var = random.split(k_gen, 3)[2]
    v_cpu = var_and(k_var, pop.take(idx_cpu), tb_cpu, GP_CXPB, GP_MUTPB,
                    pairing="halves")
    v_dev = var_and(k_var.to(dev), pop_dev.take(idx_cpu.to(dev)), tb_dev,
                    GP_CXPB, GP_MUTPB, pairing="halves")
    same_trees = all(torch.equal(a, b.cpu())
                     for a, b in zip(v_cpu.genome, v_dev.genome))
    same_off = all(torch.equal(a, b.cpu())
                   for a, b in zip(off_cpu.genome, off_dev.genome))
    fc, fd = off_cpu.fitness.values, off_dev.fitness.values.cpu()
    rel = float(((fc - fd).abs() / fc.abs().clamp(min=1e-30)).max().item())
    ok_fit = bool(torch.allclose(fd, fc, rtol=GP_FITNESS_RTOL, atol=0.0))
    phase("reference: GP bench generation card vs CPU", card_line,
          pop=GP_REF_POP, cap=GP_CAP, points=GP_NPOINTS,
          selection_equal=same_idx, var_and_trees_bitwise=same_trees,
          offspring_trees_bitwise=same_off, fitness_max_rel_err=rel,
          fitness_rtol=GP_FITNESS_RTOL, backends=[ev_cpu.last_backend,
                                                  ev_dev.last_backend])
    if not (same_idx and same_trees and same_off and ok_fit):
        fail("the GP generation on the card differs from the CPU path: "
             f"selection {same_idx}, trees {same_trees}/{same_off}, "
             f"fitness rel err {rel}")
    if ev_dev.last_backend != ev_dev.resolve(pop_dev.genome[1]):
        fail("the card's evaluator did not take its device's route")
    # the reference examples' per-tree registration on the card: one
    # operator call a row (launch-bound: on GP_TREE_ROWS of the rows),
    # the same generation as the CPU's on those rows
    rows = torch.arange(GP_TREE_ROWS)
    _, off_cpu, idx_cpu = gp_generation(tb_cpu, k_gen, pop.take(rows))
    _, tb_tree, ev_tree, _, _ = gp_toolbox(dev, per_tree=True)
    _, off_tree, idx_tree = gp_generation(tb_tree, k_gen.to(dev),
                                          pop_dev.take(rows.to(dev)))
    same_idx = torch.equal(idx_cpu, idx_tree.cpu())
    same_off = all(torch.equal(a, b.cpu())
                   for a, b in zip(off_cpu.genome, off_tree.genome))
    fc = off_cpu.fitness.values
    fd = off_tree.fitness.values.cpu()
    rel = float(((fc - fd).abs() / fc.abs().clamp(min=1e-30)).max().item())
    ok_fit = bool(torch.allclose(fd, fc, rtol=GP_FITNESS_RTOL, atol=0.0))
    phase("reference: GP generation, per-tree registration, card vs CPU",
          card_line, pop=GP_TREE_ROWS, selection_equal=same_idx,
          offspring_trees_bitwise=same_off, fitness_max_rel_err=rel,
          fitness_rtol=GP_FITNESS_RTOL, backend=ev_tree.last_backend)
    if not (same_idx and same_off and ok_fit):
        fail("the per-tree-registered GP generation on the card differs "
             f"from the CPU's: selection {same_idx}, trees {same_off}, "
             f"fitness rel err {rel}")


def fault_reference_phase(card_line, key, dev) -> None:
    """Card against CPU, bit for bit: an ``ea_step(reevaluate_all=True)``
    generation on the xla engine (pop 1024 x 100, the flagship's
    operators, the fitness the largest gene: exact on both devices), and
    ``mut_gaussian`` on a float32 genome (4096 x 100; ``mu`` 0 and 0.5 as
    Python numbers, ``mu`` and ``sigma`` as tensors: the three forms of
    the jitted program) and on a bfloat16 one."""
    import torch
    from deap_tpu_torch import base, random
    from deap_tpu_torch.algorithms import ea_step, evaluate_population
    from deap_tpu_torch.ops import crossover, mutation, selection
    cpu = torch.device("cpu")
    k_g, k_step, k_bf, k_f32 = random.split(key.cpu(), 4)
    genome = random.uniform(k_g, (1024, DIM), minval=-5.12, maxval=5.12)
    outs = []
    for d in (dev, cpu):
        tb = base.Toolbox()
        tb.register("evaluate", lambda g: (torch.max(g),))
        tb.register("mate", crossover.cx_two_point)
        tb.register("mutate", mutation.mut_gaussian, mu=MU, sigma=SIGMA,
                    indpb=INDPB)
        tb.register("select", selection.sel_tournament, tournsize=3)
        pop = base.Population(genome.to(d), base.Fitness.empty(
            1024, (1.0,), device=d))
        pop, _ = evaluate_population(tb, pop)
        _, off, nevals = ea_step(k_step.to(d), pop, tb, CXPB, MUTPB,
                                 reevaluate_all=True)
        outs.append((off.genome.cpu(), off.fitness.values.cpu(),
                     int(nevals)))
    same = (torch.equal(outs[0][0].view(torch.int32),
                        outs[1][0].view(torch.int32))
            and torch.equal(outs[0][1].view(torch.int32),
                            outs[1][1].view(torch.int32))
            and outs[0][2] == outs[1][2])
    phase("reference: ea_step reevaluate_all (xla engine) card vs CPU",
          card_line, pop=1024, dim=DIM, nevals=outs[1][2],
          bitwise_equal=same)
    if not same:
        fail("ea_step(reevaluate_all=True) on the card differs from the CPU")
    g32 = genome.repeat(4, 1)
    forms = {"mu 0": (0.0, SIGMA), "mu 0.5": (0.5, SIGMA),
             "tensor mu and sigma": (torch.tensor(0.5), torch.tensor(SIGMA))}
    equal = {}
    for form, (mu, sigma) in forms.items():
        m = [mutation.mut_gaussian(
                 k_f32.to(d), g32.to(d),
                 *(v.to(d) if torch.is_tensor(v) else v for v in (mu, sigma)),
                 0.2).cpu() for d in (dev, cpu)]
        equal[form] = torch.equal(m[0].view(torch.int32),
                                  m[1].view(torch.int32))
    phase("reference: float32 mut_gaussian card vs CPU", card_line,
          shape=list(g32.shape), mutated_share=float(
              (m[1] != g32).float().mean().item()), bitwise_equal=equal)
    if not all(equal.values()):
        fail(f"float32 mut_gaussian on the card differs from the CPU: "
             f"{equal}")
    g16 = genome.repeat(4, 1).to(torch.bfloat16)
    m = [mutation.mut_gaussian(k_bf.to(d), g16.to(d), 0.5, SIGMA, 0.2).cpu()
         for d in (dev, cpu)]
    same = (m[0].dtype == torch.bfloat16
            and torch.equal(m[0].view(torch.int16), m[1].view(torch.int16)))
    phase("reference: bfloat16 mut_gaussian card vs CPU", card_line,
          shape=list(g16.shape), mutated_share=float(
              (m[1] != g16).float().mean().item()), bitwise_equal=same)
    if not same:
        fail("bfloat16 mut_gaussian on the card differs from the CPU")


def gp_main_path(kernels, card_line, key, dev):
    """bench_gp.py's generation at full width, N and 2N generations in
    GP_PAIRS pairs; then ``ea_simple`` on the same toolbox.  Returns the
    launches of the first timed run, the population after 2N
    generations, the initial one and the toolbox."""
    import torch
    from deap_tpu_torch import random
    from deap_tpu_torch.algorithms import ea_simple
    from deap_tpu_torch.utils.support import Statistics
    ps, tb, pop_ev, gen_init, X = gp_toolbox(dev)
    k_init, k_run, k_ea = random.split(key, 3)
    pop0 = gp_initial(tb, gen_init, k_init, GP_POP)

    def run(ngen):
        torch.cuda.synchronize()
        t = time.perf_counter()
        k, pop, bests = k_run, pop0, []
        for _ in range(ngen):
            k, pop, _ = gp_generation(tb, k, pop)
            bests.append(pop.fitness.values.min())
        torch.cuda.synchronize()
        return time.perf_counter() - t, pop, torch.stack(bests).tolist()

    run(1)                                     # warm the allocator
    kernels.reset_launches()
    t1, _, _ = run(GP_NGEN)
    launches = dict(kernels.LAUNCHES)
    t2, pop2, best2 = run(2 * GP_NGEN)
    pairs = [(t1, t2)]
    for i in range(GP_PAIRS - 1):
        if i % 2:
            a, b = run(GP_NGEN)[0], run(2 * GP_NGEN)[0]
        else:
            b, a = run(2 * GP_NGEN)[0], run(GP_NGEN)[0]
        pairs.append((a, b))
    marginals = sorted((b - a) / GP_NGEN for a, b in pairs)
    per_gen = marginals[len(marginals) // 2]
    best0 = float(pop0.fitness.values.min().item())
    len0 = float(pop0.genome[2].float().mean().item())
    len2 = float(pop2.genome[2].float().mean().item())
    ok = (tuple(pop2.genome[0].shape) == (GP_POP, GP_CAP)
          and bool(pop2.fitness.valid.all())
          and bool(torch.isfinite(pop2.fitness.values).all()))
    phase("main path: GP bench generation (bench_gp.py)", card_line,
          pop=GP_POP, cap=GP_CAP, points=GP_NPOINTS,
          ngen=[GP_NGEN, 2 * GP_NGEN], seconds=[list(p) for p in pairs],
          marginal_ms_per_gen=per_gen * 1e3,
          marginal_ms_range=[marginals[0] * 1e3, marginals[-1] * 1e3],
          linearity=[b / a for a, b in pairs], launches=launches,
          launches_per_gen={k: v / GP_NGEN for k, v in launches.items()},
          best_mse_start=best0, best_mse_end=best2[-1],
          best_mse_per_gen=best2, mean_length_start=len0,
          mean_length_end=len2, evaluator_backend=pop_ev.last_backend,
          finite_and_shaped=ok)
    if launches["gp_interp"] != GP_NGEN:
        fail(f"K6 ran {launches['gp_interp']} times in {GP_NGEN} GP "
             "generations (once per generation expected)")
    if not best2[-1] < best0:
        fail(f"best MSE did not fall: {best0} -> {best2[-1]}")
    if not ok:
        fail("final GP population is not finite, valid and shaped")

    # the library's loop on the same toolbox
    stats = Statistics(lambda p: p.fitness.values[:, 0])
    stats.register("min", torch.min)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    final, log = ea_simple(k_ea, pop0, tb, GP_CXPB, GP_MUTPB, GP_EA_GENS,
                           stats=stats)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    ea_launches = dict(kernels.LAUNCHES)
    mins = log.select("min")
    phase("main path: GP ea_simple", card_line, pop=GP_POP,
          gens=GP_EA_GENS, ms_per_gen=secs / GP_EA_GENS * 1e3,
          launches=ea_launches, best_mse=[float(m) for m in mins],
          valid=bool(final.fitness.valid.all()))
    # one evaluation before the loop (every row valid: all skipped), then
    # one per generation
    if ea_launches["gp_interp"] != GP_EA_GENS + 1:
        fail(f"K6 ran {ea_launches['gp_interp']} times in ea_simple's "
             f"{GP_EA_GENS} generations (expected {GP_EA_GENS + 1})")
    if not bool(final.fitness.valid.all()):
        fail("ea_simple left invalid GP fitness")
    return launches, ea_launches, pop2, pop0, tb


def gp_k6_phase(kernels, card_line, key, pop0, pop2, dev) -> dict:
    """K6 against the plain interpreter at the bench's shapes: the
    initial population, the population after 2N generations, the same
    with every other row skipped, and the every-opcode set; then the
    design's edges: comb trees of exactly ``cap`` tokens at the deepest
    stack (``if`` at depth) at 1024, 1, 1000 and 4097 points (there ``X``
    is too large to stage and goes through L1), the evolved population
    at 4097 points, a single tree, every row skipped, and comb trees of
    256 tokens at cap 256 (a block holds 6 warps, not 8) at 1024 and 4097
    points."""
    import numpy as np
    import torch
    from deap_tpu_torch import random
    from deap_tpu_torch.probes.gp import comb_trees
    ps, _, _, _, X = gp_toolbox(dev)
    frozen = ps.freeze()
    out = {"initial": k6_check(kernels, card_line, "initial population",
                               frozen, pop0.genome, X),
           "evolved": k6_check(kernels, card_line,
                               f"population after {2 * GP_NGEN} generations",
                               frozen, pop2.genome, X)}
    codes, consts, lengths = pop2.genome
    half = torch.where(torch.arange(GP_POP, device=dev) % 2 == 0, 0, lengths)
    out["skipped"] = k6_check(kernels, card_line,
                              "evolved, every other row skipped", frozen,
                              (codes, consts, half), X)
    ps_all, _, _, gen_all, _ = gp_toolbox(dev, "all")
    frozen_all = ps_all.freeze()

    def two_args(n):
        return torch.stack([torch.linspace(-1, 1, n, device=dev),
                            torch.linspace(3, -2, n, device=dev)])
    trees = gen_all(random.split(key, GP_POP), 2, 6)
    out["all_ops"] = k6_check(kernels, card_line,
                              "every opcode (safe_ops + bool_ops, 2 args)",
                              frozen_all, trees, two_args(GP_NPOINTS))
    comb = comb_trees(ps_all, np.random.default_rng(8), GP_POP, GP_CAP, dev)
    for n in (GP_NPOINTS, 1, 1000, 4097):
        out[f"comb {n}"] = k6_check(
            kernels, card_line, f"comb trees of {GP_CAP} tokens, the deepest "
            f"stack, if at depth, {n} points", frozen_all, comb, two_args(n))
    out["evolved 4097"] = k6_check(
        kernels, card_line, "evolved at 4097 points", frozen, pop2.genome,
        torch.linspace(-1, 1, 4097, device=dev)[None, :])
    out["single"] = k6_check(kernels, card_line, "a single evolved tree",
                             frozen, tuple(g[:1] for g in pop2.genome), X)
    out["all skipped"] = k6_check(kernels, card_line, "every row skipped",
                                  frozen, (codes, consts,
                                           torch.zeros_like(lengths)), X)
    comb256 = comb_trees(ps_all, np.random.default_rng(9), GP_POP, 256, dev)
    for n in (GP_NPOINTS, 4097):
        out[f"comb cap 256 {n}"] = k6_check(
            kernels, card_line, f"comb trees of 256 tokens at cap 256, {n} "
            "points", frozen_all, comb256, two_args(n))
    return out


def profile_gp(key, pop, tb, card_line, gens=3) -> None:
    """``--profile`` for the GP path: the wall cost of each stage of a
    bench generation called alone, then ``torch.profiler`` over
    ``gens`` generations."""
    import torch

    from deap_tpu_torch import random
    from deap_tpu_torch.algorithms import _apply_op, evaluate_population

    n = pop.size
    k_sel, k_var = random.split(key, 3)[1:]
    idx = tb.select(k_sel, pop.fitness, n)
    parents = pop.take(idx)
    n2 = n // 2
    ga = tuple(g[:n2] for g in parents.genome)
    gb = tuple(g[n2:2 * n2] for g in parents.genome)
    stages = {
        "split key (3)": lambda: random.split(key, 3),
        "sel_tournament(3, random ties)": lambda: tb.select(
            k_sel, pop.fitness, n),
        "cx_one_point (n/2 pairs)": lambda: _apply_op(tb.mate, k_var, n2,
                                                      ga, gb),
        "mut_uniform (n rows, full 0-2 generator)": lambda: _apply_op(
            tb.mutate, k_var, n, parents.genome),
        "evaluate (K6, all rows)": lambda: evaluate_population(
            tb, parents.with_genome(parents.genome,
                                    torch.ones(n, dtype=torch.bool,
                                               device=idx.device))),
        "whole generation": lambda: gp_generation(tb, key, pop),
    }
    phase("profile: GP stage wall ms (synchronized, alone)", card_line,
          stages={k: _wall_ms(f, reps=3) for k, f in stages.items()})

    def run():
        k, p = key, pop
        for _ in range(gens):
            k, p, _ = gp_generation(tb, k, p)

    phase("profile: GP bench generation, per generation", card_line,
          **_profile_window(run, gens))


# ---------------------------------------------------------------------------
# bench_nsga2.py as published (SBX, polynomial mutation, nd="auto") and K5
# ---------------------------------------------------------------------------


def bench_nsga2_toolbox(problem: str):
    """bench_nsga2.py's toolbox for ``BENCH_PROBLEM=problem``."""
    from deap_tpu_torch import base, benchmarks
    from deap_tpu_torch.ops import crossover, mutation
    nobj, ndim = BN_PROBLEMS[problem]
    tb = base.Toolbox()
    if problem == "zdt1":
        tb.register("evaluate", benchmarks.zdt1)
    else:
        tb.register("evaluate", benchmarks.dtlz2, obj=nobj)
    tb.register("mate", crossover.cx_simulated_binary_bounded,
                low=0.0, up=1.0, eta=BN_ETA)
    tb.register("mutate", mutation.mut_polynomial_bounded,
                low=0.0, up=1.0, eta=BN_ETA, indpb=1.0 / ndim)
    return tb


def bench_nsga2_generation(tb, key, pop, select=None):
    """bench_nsga2.py's generation: SBX and polynomial mutation by
    ``vary_genome(pairing="halves")`` on the xla engine, evaluation, the
    (mu + lambda) pool and its environmental selection:
    ``select(k_sel, fitness, n)`` (:func:`bench_select` for
    ``BENCH_SELECT=nsga3 | spea2`` and ``BENCH_STAGED=1``), by default
    ``sel_nsga2(nd="auto", front_chunk=1024)``."""
    from deap_tpu_torch import base, random
    from deap_tpu_torch.algorithms import evaluate_population, vary_genome
    from deap_tpu_torch.ops import emo
    n = pop.size
    key, k_var, k_sel = random.split(key, 3)
    genome, _ = vary_genome(k_var, pop.genome, tb, BN_CXPB, BN_MUTPB,
                            pairing="halves")
    off = base.Population(genome, base.Fitness.empty(
        n, pop.fitness.weights, device=genome.device))
    off, _ = evaluate_population(tb, off)
    pool = pop.concat(off)
    if select is None:
        sel = emo.sel_nsga2(k_sel, pool.fitness, n, nd="auto",
                            front_chunk=FRONT_CHUNK)
    else:
        sel = select(k_sel, pool.fitness, n)
    return key, pool.take(sel)


def bench_nsga2_initial(tb, key, problem: str, n: int):
    from deap_tpu_torch import base, random
    from deap_tpu_torch.algorithms import evaluate_population
    nobj, ndim = BN_PROBLEMS[problem]
    genome = random.uniform(key, (n, ndim))
    pop = base.Population(genome, base.Fitness.empty(
        n, (-1.0,) * nobj, device=key.device))
    return evaluate_population(tb, pop)[0]


def bench_nsga2_reference_phase(card_line, key, problem: str) -> None:
    """One published generation at POP 1024, card against CPU: the
    offspring of ``vary_genome`` bitwise, ``sel_nsga2(nd="auto")`` on the
    CPU pool's values equal, and the grid's (3 objectives) or the
    staircase's (2) ranks equal to the count peel's on the card."""
    import torch
    from deap_tpu_torch import base, random
    from deap_tpu_torch.algorithms import evaluate_population, vary_genome
    from deap_tpu_torch.ops import emo
    dev = torch.device("cuda")
    tb = bench_nsga2_toolbox(problem)
    n = BN_REF_POP
    k_init, k_var, k_sel = random.split(key.cpu(), 3)
    pop = bench_nsga2_initial(tb, k_init, problem, n)
    g_cpu, _ = vary_genome(k_var, pop.genome, tb, BN_CXPB, BN_MUTPB,
                           pairing="halves")
    g_dev, _ = vary_genome(k_var.to(dev), pop.genome.to(dev), tb, BN_CXPB,
                           BN_MUTPB, pairing="halves")
    same_off = torch.equal(g_cpu.view(torch.int32),
                           g_dev.cpu().view(torch.int32))
    off = evaluate_population(tb, base.Population(g_cpu, base.Fitness.empty(
        n, pop.fitness.weights, device="cpu")))[0]
    pool = pop.concat(off)
    pool_dev = base.Fitness(pool.fitness.values.to(dev),
                            pool.fitness.valid.to(dev), pool.fitness.weights)
    idx_cpu = emo.sel_nsga2(k_sel, pool.fitness, n, nd="auto",
                            front_chunk=FRONT_CHUNK)
    idx_dev = emo.sel_nsga2(k_sel.to(dev), pool_dev, n, nd="auto",
                            front_chunk=FRONT_CHUNK)
    same_idx = torch.equal(idx_cpu, idx_dev.cpu())
    w = pool_dev.masked_wvalues()
    method = "grid" if w.shape[1] >= 3 else "staircase"
    same_ranks = True
    for stop in (None, n):
        a = emo.nondominated_ranks(w, method=method, front_chunk=FRONT_CHUNK,
                                   stop_at_k=stop)
        b = emo.nondominated_ranks(w, method="peel", front_chunk=FRONT_CHUNK,
                                   stop_at_k=stop)
        same_ranks &= torch.equal(a[0], b[0]) and int(a[1]) == int(b[1])
    phase(f"reference: bench_nsga2 {problem} generation card vs CPU",
          card_line, pop=n, dim=pop.genome.shape[1], nobj=w.shape[1],
          changed_genes=int((g_cpu != pop.genome).sum().item()),
          offspring_bitwise=same_off, selection_equal=same_idx,
          method=method, ranks_equal_peel=same_ranks)
    if not (same_off and same_idx and same_ranks):
        fail(f"bench_nsga2 {problem} generation on the card differs: "
             f"offspring {same_off}, selection {same_idx}, {method} ranks "
             f"against the peel {same_ranks}")


def _timed_pairs(run, n: int, pairs: int):
    """``pairs`` (N, 2N) timings of ``run(ngen) -> seconds`` in
    alternating order: the median marginal seconds per generation, the
    sorted marginals and the pairs."""
    out = []
    for i in range(pairs):
        if i % 2:
            b, a = run(2 * n), run(n)
        else:
            a, b = run(n), run(2 * n)
        out.append((a, b))
    marginals = sorted((b - a) / n for a, b in out)
    return marginals[len(marginals) // 2], marginals, out


def _counted_pairs(kernels, run, n: int, pairs: int):
    """:func:`_timed_pairs` and the port's launch counts of its last
    2N-generation run (the counters are zeroed outside the timed span)."""
    counts = {}

    def counted(ngen):
        if ngen == 2 * n:
            kernels.reset_launches()
        t = run(ngen)
        if ngen == 2 * n:
            counts.update(kernels.LAUNCHES)
        return t

    return (*_timed_pairs(counted, n, pairs), counts)


def front_widths(fitness, n_select: int):
    """Widths of the fronts that ``sel_nsga2(nd="auto")`` peels to rank
    ``n_select`` points."""
    import torch
    from deap_tpu_torch.ops import emo
    ranks, nf = emo.nondominated_ranks(
        fitness.masked_wvalues(), method="auto", front_chunk=FRONT_CHUNK,
        stop_at_k=n_select)
    return torch.bincount(ranks.long(), minlength=int(nf))[:int(nf)].tolist()


def bench_nsga2_main_path_a(kernels, card_line, key):
    """Configuration A at full width: the published generation N and 2N
    times in BN_PAIRS pairs, then ``toolbox.hypervolume`` of the final
    population.  Returns the launches of the counted run (2N generations
    and the hypervolume), the final population and the toolbox."""
    import torch
    from deap_tpu_torch import random
    from deap_tpu_torch.ops import hv as host_hv, hypervolume as H
    dev = torch.device("cuda")
    tb = bench_nsga2_toolbox("dtlz2")
    ref = HV_REF["dtlz2"]
    k_init, k_run = random.split(key)
    pop0 = bench_nsga2_initial(tb, k_init, "dtlz2", BN_POP)
    hv0 = tb.hypervolume(-pop0.fitness.wvalues, ref)
    d0 = front_distance(pop0.fitness.values)
    state = {}

    def run(ngen):
        torch.cuda.synchronize()
        t = time.perf_counter()
        k, pop = k_run, pop0
        for _ in range(ngen):
            k, pop = bench_nsga2_generation(tb, k, pop)
        torch.cuda.synchronize()
        state[ngen] = pop
        return time.perf_counter() - t

    run(1)                                     # warm the allocator
    # the counted run: 2N generations, then the hypervolume of what they
    # leave, through the toolbox's default slot
    kernels.reset_launches()
    t2n = run(2 * BN_NGEN)
    pop2 = state[2 * BN_NGEN]
    t = time.perf_counter()
    hv2 = tb.hypervolume(-pop2.fitness.wvalues, ref)
    hv_ms = (time.perf_counter() - t) * 1e3
    launches = dict(kernels.LAUNCHES)
    per_gen, marginals, pairs = _timed_pairs(run, BN_NGEN, BN_PAIRS)
    # untimed replay: the widths of the fronts each generation peels
    widths, k, pop = [], k_run, pop0

    def select(k_sel, fitness, n):
        from deap_tpu_torch.ops import emo
        widths.append(front_widths(fitness, n))
        return emo.sel_nsga2(k_sel, fitness, n, nd="auto",
                             front_chunk=FRONT_CHUNK)

    for _ in range(2 * BN_NGEN):
        k, pop = bench_nsga2_generation(tb, k, pop, select=select)
    if not torch.equal(pop.genome, pop2.genome):
        fail("the untimed replay of path A left another population than "
             "the timed run")
    fat = [sum(w >= 4 * FRONT_CHUNK for w in ws) for ws in widths]
    # the value: against the plain float64 sweep on the card, and on a
    # subsample against the host tier
    pts = (-pop2.fitness.wvalues).double()
    plain = float(H.hypervolume_3d(pts, ref))
    sub = pts[::BN_POP // HV_SUBSAMPLE][:HV_SUBSAMPLE]
    sub_card = tb.hypervolume(sub, ref)
    sub_host = host_hv.hypervolume(sub, ref)
    d2 = front_distance(pop2.fitness.values)
    final = pop2.fitness.values
    ok_shape = (tuple(pop2.genome.shape) == (BN_POP, 12)
                and tuple(final.shape) == (BN_POP, 3)
                and bool(torch.isfinite(pop2.genome).all())
                and bool(torch.isfinite(final).all())
                and bool(pop2.fitness.valid.all())
                and bool(((pop2.genome >= 0) & (pop2.genome <= 1)).all()))
    rel_plain = abs(hv2 - plain) / abs(plain)
    phase("main path A: bench_nsga2 dtlz2 (SBX, polynomial, grid ranks)",
          card_line, pop=BN_POP, dim=12, nobj=3,
          ngen=[BN_NGEN, 2 * BN_NGEN], seconds=[list(p) for p in pairs],
          counted_run_seconds=t2n, marginal_ms_per_gen=per_gen * 1e3,
          marginal_ms_range=[marginals[0] * 1e3, marginals[-1] * 1e3],
          linearity=[b / a for a, b in pairs], launches=launches,
          launches_per_gen={k: v / (2 * BN_NGEN) for k, v in launches.items()
                            if k != "hv3d_sweep"},
          fronts_per_gen=[len(ws) for ws in widths], fat_fronts_per_gen=fat,
          widest_front_per_gen=[max(ws) for ws in widths],
          distance_start=d0, distance_end=d2, hv_ref=list(ref),
          hypervolume_start=hv0, hypervolume_end=hv2,
          hypervolume_wall_ms=hv_ms, hypervolume_plain_float64=plain,
          hypervolume_rel_gap_to_plain=rel_plain,
          subsample=HV_SUBSAMPLE, subsample_card=sub_card,
          subsample_host=sub_host, host_tier=host_hv.host_tier(),
          subsample_abs_gap=abs(sub_card - sub_host),
          finite_and_shaped=ok_shape)
    if launches["hv3d_sweep"] != 1:
        fail(f"K5 ran {launches['hv3d_sweep']} times for one "
             "toolbox.hypervolume of path A's population")
    if launches["rows_dominate_counts"] < 1:
        fail("K4 never ran in path A's grid peel")
    if rel_plain > HV_RTOL["float64"]:
        fail(f"path A's hypervolume {hv2} is {rel_plain} (relative) from "
             f"the plain float64 sweep's {plain}")
    if abs(sub_card - sub_host) > 1e-12 * max(1.0, abs(sub_host)):
        fail(f"hypervolume of the {HV_SUBSAMPLE}-point subsample: card "
             f"{sub_card}, host tier ({host_hv.host_tier()}) {sub_host}")
    if not d2 < d0:
        fail(f"DTLZ2 distance did not fall on path A: {d0} -> {d2}")
    if not hv2 > hv0:
        fail(f"the hypervolume did not rise on path A: {hv0} -> {hv2}")
    if not ok_shape:
        fail("path A's final population is not finite, valid, in bounds "
             "and shaped")
    return launches, pop2, tb


def k5_bound(n: int, dtype: str):
    """K5's least time: the four arrays read and one partial per 128
    prefixes written once; n * n pair steps of an integer compare (is the
    slot in the prefix), a maximum of the running height predicated on
    it, and a multiply-add into the area.  The JAX form's running minimum
    needs a subtract and a clamp more a pair step; the running maximum of
    the heights ref_y - y, subtracted once a slot, is the same value
    exactly (kernels/hypervolume.cu), so they are not charged.  In
    float32 the compare and the maximum run at the compare rate and the
    multiply-add at the float32 rate; in float64 the compare at the
    integer rate, the maximum and the multiply-add at the float64 rate."""
    elt = 4 if dtype == "float32" else 8
    n_bytes = (3 * elt + 4) * n + elt * -(-n // 128)
    pairs = float(n) * n
    if dtype == "float32":
        return bound_ms(n_bytes, 2 * pairs, pairs)
    return bound_ms(n_bytes, pairs, 0, 2 * pairs)


def k5_check(kernels, card_line, label: str, points, ref) -> dict:
    """K5 against the plain sweep on one point set, in float32 and
    float64: the total and the slab partials (blocks of 128 prefixes)
    within HV_RTOL of the plain version of the same dtype, two launches
    bitwise equal, and both held against the plain float64 value as the
    truth; kernel, entry (sorts included) and plain times."""
    import torch
    from deap_tpu_torch.ops import hypervolume as H
    n = points.shape[0]
    out = {}
    truth = None
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[1]
        pts = points.to(dtype)
        before = kernels.LAUNCHES["hv3d_sweep"]
        clipped, r = H._as_points(pts, ref)
        ref_y = float(torch.tensor(ref, dtype=dtype)[1])
        part_k = H._hv3d_cuda_partials(clipped, r, ref_y, 128)
        part_k2 = H._hv3d_cuda_partials(clipped, r, ref_y, 128)
        part_p = H._slab_volumes(pts, ref, 128)
        total_k = float(H.hypervolume_3d_cuda(pts, ref))
        total_p = float(H.hypervolume_3d(pts, ref))
        torch.cuda.synchronize()
        if truth is None:
            truth = total_p                     # the float64 plain value
        repeat = torch.equal(part_k.view(torch.uint8).reshape(-1),
                             part_k2.view(torch.uint8).reshape(-1))
        scale = max(abs(total_p), 1e-300)
        rel = abs(total_k - total_p) / scale
        rel_parts = float((part_k.double() - part_p.double()).abs().max()
                          .item()) / scale
        _, ys, zr, dz, width = H._hv3d_prep(clipped, r)
        ys, zr, width, dz = (t.contiguous() for t in (ys, zr, width, dz))
        ms = cuda_ms(lambda: kernels.launch_hv3d_sweep(
            ys, zr, width, dz, ref_y, threads=128), reps=5, warm=1)
        # the device time alone: at small n the host's launch work (four
        # kernels, one scratch allocation) can exceed it
        device_ms = _profile_window(lambda: [kernels.launch_hv3d_sweep(
            ys, zr, width, dz, ref_y, threads=128) for _ in range(5)],
            5)["device_busy_ms"]
        entry_ms = cuda_ms(lambda: H.hypervolume_3d_cuda(pts, ref), reps=3,
                           warm=1)
        plain_ms = cuda_ms(lambda: H.hypervolume_3d(pts, ref), reps=1,
                           warm=0)
        b, by = k5_bound(n, name)
        phase(f"K5 hv3d_sweep vs plain: {label}", card_line, n=n,
              dtype=name, ref=list(ref), kernel=total_k, plain=total_p,
              rel_gap=rel, rel_gap_slab_partials=rel_parts,
              rtol=HV_RTOL[name], bitwise_repeatable=repeat,
              rel_gap_kernel_to_float64_plain=abs(total_k - truth)
              / max(abs(truth), 1e-300),
              rel_gap_plain_to_float64_plain=abs(total_p - truth)
              / max(abs(truth), 1e-300),
              max_abs_err=abs(total_k - total_p), ms=ms,
              device_ms=device_ms, entry_ms=entry_ms, plain_ms=plain_ms,
              bound_ms=b, bound_by=by,
              launches=kernels.LAUNCHES["hv3d_sweep"] - before)
        if not repeat:
            fail(f"K5 {name} on {label}: two launches differ")
        if max(rel, rel_parts) > HV_RTOL[name]:
            fail(f"K5 {name} on {label}: total {rel}, slab partials "
                 f"{rel_parts} (relative to the total) from the plain "
                 f"version, bound {HV_RTOL[name]}")
        out[name] = {"max_abs_err": abs(total_k - total_p), "ms": ms,
                     "device_ms": device_ms, "entry_ms": entry_ms,
                     "plain_ms": plain_ms, "bound_ms": b, "bound_by": by}
    return out


def bench_nsga2_main_path_b(kernels, card_line, key) -> dict:
    """Configuration B at full width: ZDT1, two objectives, staircase
    ranks, the 2-D hypervolume at ref (11, 11) before and after."""
    import torch
    from deap_tpu_torch import random
    tb = bench_nsga2_toolbox("zdt1")
    ref = HV_REF["zdt1"]
    k_init, k_run = random.split(key)
    pop0 = bench_nsga2_initial(tb, k_init, "zdt1", BN_POP)
    hv0 = tb.hypervolume(-pop0.fitness.wvalues, ref)

    def run(ngen, select=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        k, pop = k_run, pop0
        for _ in range(ngen):
            k, pop = bench_nsga2_generation(tb, k, pop, select=select)
        torch.cuda.synchronize()
        return time.perf_counter() - t, pop

    run(1)                                     # warm the allocator
    kernels.reset_launches()
    secs, pop = run(BN_B_GENS)
    hv1 = tb.hypervolume(-pop.fitness.wvalues, ref)
    launches = dict(kernels.LAUNCHES)
    widths = []

    def select(k_sel, fitness, n):
        from deap_tpu_torch.ops import emo
        widths.append(front_widths(fitness, n))
        return emo.sel_nsga2(k_sel, fitness, n, nd="auto",
                             front_chunk=FRONT_CHUNK)

    _, replay = run(BN_B_GENS, select=select)
    ok = (torch.equal(replay.genome, pop.genome)
          and tuple(pop.genome.shape) == (BN_POP, 30)
          and bool(torch.isfinite(pop.fitness.values).all())
          and bool(pop.fitness.valid.all())
          and bool(((pop.genome >= 0) & (pop.genome <= 1)).all()))
    phase("main path B: bench_nsga2 zdt1 (SBX, polynomial, staircase ranks)",
          card_line, pop=BN_POP, dim=30, nobj=2, gens=BN_B_GENS,
          ms_per_gen=secs / BN_B_GENS * 1e3, launches=launches,
          fronts_per_gen=[len(ws) for ws in widths],
          widest_front_per_gen=[max(ws) for ws in widths],
          best_f1=float(pop.fitness.values[:, 0].min().item()),
          hv_ref=list(ref), hypervolume_start=hv0, hypervolume_end=hv1,
          replay_equal_finite_valid_in_bounds=ok)
    if not hv1 > hv0:
        fail(f"the 2-D hypervolume did not rise on path B: {hv0} -> {hv1}")
    if not ok:
        fail("path B's population is not repeatable, finite, valid and in "
             "bounds")
    return launches


def profile_bench_nsga2(key, pop, tb, card_line, gens=2) -> None:
    """``--profile`` for path A: the wall cost of each stage of a
    published generation called alone (variation with its seven powers
    a gene, evaluation, the grid's views and initial counts, the hybrid
    peel with its rounds by branch, crowding, K5), then
    ``torch.profiler`` over ``gens`` generations."""
    import torch
    from deap_tpu_torch import base, random
    from deap_tpu_torch.algorithms import evaluate_population, vary_genome
    from deap_tpu_torch.base import lexsort
    from deap_tpu_torch.ops import emo, hypervolume as H
    n = pop.size
    k_var, k_sel = random.split(key, 3)[1:]
    genome, _ = vary_genome(k_var, pop.genome, tb, BN_CXPB, BN_MUTPB,
                            pairing="halves")
    off = base.Population(genome, base.Fitness.empty(
        n, pop.fitness.weights, device=genome.device))
    pool = pop.concat(evaluate_population(tb, off)[0])
    w, values = emo._wv_values(pool.fitness)
    ones = torch.ones(2 * n, dtype=torch.bool, device=w.device)
    views = emo._grid_views(w)
    ranks, nf = emo._grid_recount_ranks(w, n, FRONT_CHUNK)
    widths = torch.bincount(ranks.long(), minlength=int(nf))[:int(nf)]
    fat = int((widths >= 4 * FRONT_CHUNK).sum().item())
    dist = emo.assign_crowding_dist(values, ranks)
    pts = -pop.fitness.wvalues
    ga, gb = pop.genome[:n // 2], pop.genome[n // 2:]
    stages = {
        "split key (3)": lambda: random.split(key, 3),
        "vary_genome (SBX + polynomial, 7 pows a gene)": lambda: vary_genome(
            k_var, pop.genome, tb, BN_CXPB, BN_MUTPB, pairing="halves"),
        "  SBX alone (n/2 pairs, 3 pows a gene)": lambda: tb.mate(
            k_var, ga, gb),
        "  polynomial mutation alone (n rows, 4 pows)": lambda: tb.mutate(
            k_var, pop.genome),
        "evaluate (dtlz2, batched form)": lambda: evaluate_population(tb, off),
        "grid views (lexsorts, buckets, slab views)":
            lambda: emo._grid_views(w),
        "initial grid counts (histogram, bands, duplicates)":
            lambda: emo._grid_counts_from_views(views, ones),
        "whole grid ranks (views, counts, hybrid peel)":
            lambda: emo._grid_recount_ranks(w, n, FRONT_CHUNK),
        "crowding distance": lambda: emo.assign_crowding_dist(values, ranks),
        "final sort": lambda: lexsort([-dist, ranks]),
        "whole sel_nsga2(nd=auto)": lambda: emo.sel_nsga2(
            k_sel, pool.fitness, n, nd="auto", front_chunk=FRONT_CHUNK),
        "toolbox.hypervolume (sorts + K5, float64)": lambda: tb.hypervolume(
            pts, HV_REF["dtlz2"]),
        "  hypervolume_3d_cuda float32": lambda: H.hypervolume_3d_cuda(
            pts, HV_REF["dtlz2"]),
    }
    phase("profile: bench_nsga2 A stage wall ms (synchronized, alone)",
          card_line, stages={k: _wall_ms(f, reps=3) for k, f in stages.items()},
          peel_rounds=int(nf), fat_rounds=fat, thin_rounds=int(nf) - fat,
          thin_k4_chunks=int(((widths[widths < 4 * FRONT_CHUNK]
                               + FRONT_CHUNK - 1) // FRONT_CHUNK).sum()))

    def run():
        k, p = key, pop
        for _ in range(gens):
            k, p = bench_nsga2_generation(tb, k, p)

    phase("profile: bench_nsga2 A, per generation", card_line,
          **_profile_window(run, gens))


# ---------------------------------------------------------------------------
# the probe tools: P1-P5 (kernels/probes.cu) and the tools' own paths
# ---------------------------------------------------------------------------

PROBE_POP, PROBE_DIM = 1 << 20, 100           # tools/pallas_probe_ga.py's
PROBE_GP_SETTINGS = ("PROBE_POP", "PROBE_CAP", "PROBE_POINTS", "PROBE_ITERS")
PROBE_RAST_ROWS = (1, 2047, 2048, 2049, (1 << 16) + 96)
PROBE_RAST_DIMS = (0, 1, 31, 32, 33, 37, 96, 100, 127, 128)
PROBE_LOOKUP_NS = (1, 3, 4, 5, 1023, 1 << 20, (1 << 20) + 3)
COS_SWEEP_STRIDE = 7
PROBE_GP_TB = (8, 32)
PROBE_GP_UNROLL = (0, 63)


def probe_check(label: str, card_line, kernel, plain, library, bound,
                exact: bool = False, readings: int = 1, **fields) -> dict:
    """One probe kernel against its plain version on the same inputs:
    bitwise (``exact``: equal integers), times beside the bound and the
    library call's time; fails on a mismatch.  ``readings`` > 1: the
    kernel and the library call are timed that many times in turns, host
    paced and with the launches queued (device time), and the medians
    are kept."""
    import statistics

    import torch
    from deap_tpu_torch.kernels.kernel_times import queued_ms
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if exact:
        gap = 0 if torch.equal(got, want) else 1
        err = float((got.long() - want.long()).abs().max().item())
    else:
        gap = ulp_gap(got, want)
        err = nan_gap(got, want)[1]         # overflowed stacks hold inf
    extra = {}
    if readings > 1:
        calls = {"": kernel, "library_": library} if library else {
            "": kernel}
        times = {f"{k}{t}": [] for k in calls for t in ("ms", "device_ms")}
        for _ in range(readings):
            for k, fn in calls.items():
                times[f"{k}ms"].append(cuda_ms(fn, reps=20, warm=2))
                times[f"{k}device_ms"].append(queued_ms(fn))
        extra = {k: statistics.median(v) for k, v in times.items()}
        ms, library_ms = extra.pop("ms"), extra.pop("library_ms", None)
        extra["readings"] = times
    else:
        ms = cuda_ms(kernel, reps=20, warm=2)
        library_ms = cuda_ms(library, reps=20, warm=2) if library else None
    plain_ms = cuda_ms(plain, reps=1, warm=0)
    b, by = bound
    phase(f"{label} vs plain", card_line, ulp_gap=gap, ulp_bound=ULP_BOUND,
          max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
          bound_ms=b, bound_by=by, **extra, **fields)
    if gap > ULP_BOUND:
        fail(f"{label}: {gap} ulp from its plain version (bound {ULP_BOUND})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b, "bound_by": by,
            **{k: v for k, v in extra.items() if k != "readings"}}


def probe_kernels_phase(card_line, key) -> dict:
    """P1-P4 against their plain versions at the GA tool's shape, 2^20 x
    128 float32 (the reduce masked at dim 100); P3 on the GA tool's
    ``lookup`` table (``permutation(PRNGKey(0), 2^20)``)."""
    import torch
    from deap_tpu_torch import kernels, random
    from deap_tpu_torch.probes import ga as PGA
    pop, dev = PROBE_POP, key.device
    k_x, k_p, k_s = random.split(key, 3)
    x = random.uniform(k_x, (pop, PGA.LANE))
    order = PGA.lookup_table(pop, dev)
    pos = random.randint(k_p, (pop,), 0, pop)
    seed = random.randint(k_s, (1,), -(1 << 31), (1 << 31) - 1)
    copy_out = torch.empty_like(x)
    shape = [pop, PGA.LANE]
    res = {}
    for rows in (512, 2048, 8192):
        res[f"stream_rows{rows}"] = probe_check(
            f"P1 probe_stream_copy rows {rows}", card_line,
            lambda rows=rows: PGA.stream(x, rows), lambda: x.clone(),
            lambda: copy_out.copy_(x), PGA.kernel_bound("stream", pop),
            shape=shape, rows=rows)
        res[f"stream_rows{rows}"]["tb_per_s"] = (
            2 * x.numel() * 4 / res[f"stream_rows{rows}"]["ms"] / 1e9)
    res["chain"] = probe_check(
        "P1 probe_chain24", card_line, lambda: PGA.chain24(x),
        lambda: PGA._chain24_plain(x), None, PGA.kernel_bound("chain", pop),
        shape=shape)
    res["rast"] = probe_check(
        "P1 probe_rast_reduce", card_line,
        lambda: PGA.rast_reduce(x, PROBE_DIM),
        lambda: PGA._rast_reduce_plain(x, PROBE_DIM), None,
        PGA.kernel_bound("rast", pop, PROBE_DIM), readings=3, shape=shape,
        dim=PROBE_DIM)
    rast_edges_phase(card_line, dev)
    cos_sweep_phase(kernels, card_line, dev)
    res["rng"] = probe_check(
        "P2 probe_hash_normal", card_line,
        lambda: PGA.hash_normal(seed, pop),
        lambda: PGA._hash_normal_plain(seed, pop), None,
        PGA.kernel_bound("rng", pop), shape=shape, seed=int(seed.item()))
    # P2's edges: a row, a block's worth of rows less one and more one,
    # under this run's seed and a second one
    gaps = {}
    for s in (seed, torch.tensor([12345], dtype=torch.int32, device=dev)):
        for rows in (1, 2047, 2049):
            gaps[f"seed {int(s.item())}, {rows} rows"] = ulp_gap(
                PGA.hash_normal(s, rows), PGA._hash_normal_plain(s, rows))
    phase("P2 probe_hash_normal edges vs plain", card_line, ulp_gap=gaps,
          ulp_bound=ULP_BOUND)
    if max(gaps.values()) > ULP_BOUND:
        fail(f"P2 probe_hash_normal: edges {gaps} (bound {ULP_BOUND})")
    res["lookup"] = probe_check(
        "P3 probe_lookup", card_line, lambda: PGA.lookup(order, pos),
        lambda: order[pos.long()], lambda: order[pos],
        PGA.kernel_bound("lookup", pop), exact=True, readings=5,
        queries=pop)
    lookup_edges_phase(card_line, dev)
    res["dmagather"] = probe_check(
        "P4 probe_row_gather", card_line,
        lambda: PGA.row_gather(x, pos), lambda: x[pos.long()],
        lambda: torch.index_select(x, 0, pos),
        PGA.kernel_bound("dmagather", pop), shape=shape)
    del x, order, pos, copy_out
    torch.cuda.empty_cache()
    return res


def rast_edges_phase(card_line, dev) -> None:
    """P1's reduce bitwise to its plain version at ragged row counts and
    every kind of mask (dims up to 96 leave the fourth window empty), on
    rows that put warps on the branch-free cosine, on the general one and
    on both (``probes.ga.rast_inputs``: one lane outside the range, rows
    wholly outside it, NaN and +-inf)."""
    import torch
    from deap_tpu_torch.probes import ga as PGA
    gaps, nan_rows = {}, 0
    for n_rows in PROBE_RAST_ROWS:
        x = PGA.rast_inputs(n_rows, dev)
        for dim in PROBE_RAST_DIMS:
            got = PGA.rast_reduce(x, dim)
            want = PGA._rast_reduce_plain(x, dim)
            gaps[f"{n_rows} x {dim}"] = ulp_gap(got, want)
            nan_rows += int(torch.isnan(want).sum().item())
    phase("P1 probe_rast_reduce edges vs plain", card_line,
          rows=list(PROBE_RAST_ROWS), dims=list(PROBE_RAST_DIMS),
          worst_ulp_gap=max(gaps.values()), nan_rows=nan_rows,
          ulp_bound=ULP_BOUND)
    if max(gaps.values()) > ULP_BOUND:
        fail(f"P1 probe_rast_reduce edges: "
             f"{ {k: v for k, v in gaps.items() if v} } (bound {ULP_BOUND})")


def cos_sweep_phase(kernels, card_line, dev) -> None:
    """The branch-free cosine of P1 and P2 (``cos_reduced``) against
    ``xla_sincos(y, true)`` on every COS_SWEEP_STRIDE-th float32 of its
    range, |y| < 120 of either sign (the card test sweeps every one);
    any mismatch fails the run."""
    found = {}
    t0 = time.perf_counter()
    for sign, lo in (("positive", 0), ("negative", 0x80000000)):
        found[sign] = kernels._cos_reduced_mismatches(
            lo, lo + 0x42F00000, COS_SWEEP_STRIDE, dev)
    phase("P1/P2 cos_reduced vs xla_sincos, strided sweep", card_line,
          stride=COS_SWEEP_STRIDE, mismatches=found,
          seconds=time.perf_counter() - t0)
    if any(count for count, _ in found.values()):
        fail(f"cos_reduced differs from xla_sincos: {found}")


def lookup_edges_phase(card_line, dev) -> None:
    """P3 exactly ``order[pos]`` at ragged query counts, a table of another
    size, positions 0 and m - 1, and ``pos`` 0-3 words into its
    allocation (``probes.ga.lookup_inputs``)."""
    import torch
    from deap_tpu_torch.probes import ga as PGA
    bad = []
    for n in PROBE_LOOKUP_NS:
        for offset in range(4):
            order, pos = PGA.lookup_inputs(n, offset, dev)
            if not torch.equal(PGA.lookup(order, pos), order[pos.long()]):
                bad.append((n, offset))
    phase("P3 probe_lookup edges vs plain", card_line,
          queries=list(PROBE_LOOKUP_NS), offsets=[0, 1, 2, 3], mismatched=bad)
    if bad:
        fail(f"P3 probe_lookup differs from order[pos] at {bad}")


def probe_ga_tool_phase(kernels, card_line) -> dict:
    """The GA probe tool's own path at 2^20 x 100: every probe,
    ``--recommend``, ``--json chip_smoke_out/probe_ga.json``; P1-P4 must run
    on it, every record must carry a finite time above zero, ``varveval``
    must record both key implementations and nothing may err."""
    import math
    from deap_tpu_torch.probes import ga as PGA
    out_dir = os.path.join(ROOT, "chip_smoke_out")
    os.makedirs(out_dir, exist_ok=True)
    kernels.reset_launches()
    doc = PGA.main(["--pop", str(PROBE_POP), "--dim", str(PROBE_DIM),
                    "--recommend", "--json",
                    os.path.join(out_dir, "probe_ga.json")])
    launches = dict(kernels.LAUNCHES)
    res = doc["result"]
    bad = [r["probe"] for r in res["probes"]
           if not (isinstance(r["ms"], float) and math.isfinite(r["ms"])
                   and r["ms"] > 0)]
    errors = res["errors"]
    recorded = [r["probe"] for r in res["probes"]]
    phase("probe tool: deap_tpu_torch.probes.ga", card_line,
          pop=res["pop"], dim=res["dim"], k_iters=res["k_iters"],
          ms={r["probe"]: r["ms"] for r in res["probes"]},
          linearity={r["probe"]: r["linearity_t2k_over_tk"]
                     for r in res["probes"]},
          errors=errors, recommend=res["recommend"],
          launches={k: v for k, v in launches.items() if v})
    if bad:
        fail(f"probe records without a finite positive time: {bad}")
    if errors:
        fail(f"the GA probe tool reported errors: {errors}")
    for name in ("torch_varveval_threefry2x32", "torch_varveval_rbg"):
        if name not in recorded:
            fail(f"the GA probe tool did not record {name}")
    for name in ("probe_stream_copy", "probe_chain24", "probe_rast_reduce",
                 "probe_hash_normal", "probe_lookup", "probe_row_gather"):
        if not launches[name]:
            fail(f"{name} did not run on the GA probe tool's path")
    return launches


def _edge_plain_forms():
    """``(mode, tb, unroll)`` of the plain P5 forms an edge needs: the
    plain noswitch and dispatch forms never touch the stack, so their
    value does not depend on tb and is computed once, at the first tb."""
    return [(mode, tb, unroll) for mode in ("noswitch", "dispatch", "stackrw")
            for tb in (PROBE_GP_TB if mode == "stackrw" else PROBE_GP_TB[:1])
            for unroll in PROBE_GP_UNROLL]


def cpu_probe_gp_edges() -> dict:
    """The CPU side of :func:`probe_gp_phase`'s edges: every plain form
    of every edge (``probes.gp.probe_edges`` on the CPU, the same inputs
    from the same numpy seeds).  The plain loop is a few float32 and exact
    float64 operations a token and tree, the same bits on either device,
    and on the card its many small launches took most of a minute.  A
    tree's plain value is the same at every point: one column is kept.
    Its operations are elementwise on a few hundred blocks: one thread,
    so that it takes no core from the card's process."""
    import torch
    from deap_tpu_torch.probes import gp as PGP
    torch.set_num_threads(1)
    out = {}
    for name, (c, k, ln, n_points, nb) in PGP.probe_edges("cpu").items():
        out[name] = {}
        for f in _edge_plain_forms():
            v = PGP._probe_gp_plain(c, k, ln, n_points, f[0], f[1],
                                    bool(f[2]), nb)
            if not torch.equal(v, v[:, :1].expand_as(v)):
                raise AssertionError(f"plain P5 {name} {f}: not one value "
                                     "a tree")
            out[name][f] = v[:, 0].clone()
    return out


def probe_gp_phase(card_line, key, edges_cpu) -> dict:
    """P5 against its plain version, bitwise, on the GP tool's 4096 x 64
    full binary trees at 1024 points: every mode, tb 8 and 32, unroll 1
    and 63; then on its edges, every form, against the plain forms that
    ``edges_cpu`` (a :class:`CpuSide` of :func:`cpu_probe_gp_edges`)
    computed.  Returns the forms' results and the edges' largest error."""
    import numpy as np
    import torch
    from deap_tpu_torch.probes import gp as PGP
    pop, cap, npts = GP_POP, GP_CAP, GP_NPOINTS
    codes, consts, lengths = PGP.full_binary_trees(
        PGP.bench_pset(), np.random.default_rng(0), pop, cap, key.device)
    x = torch.zeros((1, 1), device=key.device)
    res = {}
    for mode in ("noswitch", "dispatch", "stackrw"):
        for tb in PROBE_GP_TB:
            for unroll in PROBE_GP_UNROLL:
                run = PGP.make_probe_kernel(mode, 9, tb, unroll,
                                            n_points=npts)
                res[(mode, tb, unroll)] = probe_check(
                    f"P5 probe_gp {mode} tb {tb} unroll {unroll or 1}",
                    card_line, lambda run=run: run(codes, consts, lengths, x),
                    lambda mode=mode, tb=tb, unroll=unroll:
                    PGP._probe_gp_plain(codes, consts, lengths, npts, mode,
                                        tb, bool(unroll), 9),
                    None, PGP.probe_bound(mode, codes, npts),
                    shape=[pop, cap, npts])
    # P5's edges (probes.gp.probe_edges): groups with missing trees, ragged
    # and single points, cap 256, codes outside the branches; every form
    edge_err = 0.0
    plains = edges_cpu.result()
    for name, (c, k, ln, n_points, nb) in PGP.probe_edges(key.device).items():
        gaps, plain = {}, plains[name]
        for mode in ("noswitch", "dispatch", "stackrw"):
            for tb in PROBE_GP_TB:
                for unroll in PROBE_GP_UNROLL:
                    got = PGP.make_probe_kernel(mode, nb, tb, unroll,
                                                n_points=n_points)(c, k, ln, x)
                    at = tb if mode == "stackrw" else PROBE_GP_TB[0]
                    got = got.cpu()
                    want = plain[(mode, at, unroll)][:, None].expand_as(got)
                    gaps[f"{mode} tb {tb} unroll {unroll or 1}"] = ulp_gap(
                        got, want)
                    edge_err = max(edge_err, nan_gap(got, want)[1])
        phase(f"P5 probe_gp edge vs plain: {name}", card_line,
              shape=[*c.shape, n_points], n_branches=nb, ulp_gap=gaps,
              ulp_bound=ULP_BOUND, plain_on="cpu")
        if max(gaps.values()) > ULP_BOUND:
            fail(f"P5 probe_gp, {name}: {gaps} (bound {ULP_BOUND})")
    return res, edge_err


def probe_gp_tool_phase(kernels, card_line) -> tuple:
    """The GP probe tool's nine probes at its defaults (4096 x 64 x 1024);
    P5 and K6 (``real63``) must run on it."""
    import math
    from deap_tpu_torch.probes import gp as PGP
    for name in PROBE_GP_SETTINGS:
        os.environ.pop(name, None)
    kernels.reset_launches()
    out = PGP.main([])
    launches = dict(kernels.LAUNCHES)
    pr = out["probes"]
    phase("probe tool: deap_tpu_torch.probes.gp", card_line,
          shape=out["shape"],
          ns_per_token={k: v["ns_per_token"] for k, v in pr.items()},
          eval_ms={k: v["eval_ms"] for k, v in pr.items()},
          linearity={k: v["linearity"] for k, v in pr.items()},
          fraction_of_floor=out.get("fraction_of_floor"),
          launches={k: v for k, v in launches.items() if v})
    bad = [k for k, v in pr.items()
           if not (math.isfinite(v["eval_ms"]) and v["eval_ms"] > 0)]
    if bad or sorted(pr) != sorted(PGP.PROBES):
        fail(f"GP probe records missing or without a finite positive "
             f"time: {bad or sorted(set(PGP.PROBES) - set(pr))}")
    if not math.isfinite(out.get("fraction_of_floor", float("nan"))):
        fail("the GP probe tool gave no finite fraction_of_floor")
    for name in ("probe_gp", "gp_interp"):
        if not launches[name]:
            fail(f"{name} did not run on the GP probe tool's path")
    return launches, out


# ---- 22.-25. the OneMax and CMA-ES slices (BASELINE configs 1 and 3) --------

# BASELINE config 1 (bench_onemax.py): pop 300 x 100 bits, cx_two_point,
# mut_flip_bit(0.05), sel_tournament(3), cxpb 0.5, mutpb 0.2
OM_POP, OM_BITS, OM_NGEN, OM_CXPB, OM_MUTPB = 300, 100, 40, 0.5, 0.2
OM_TIMING_NGEN, OM_PAIRS = 10, 1
# BASELINE config 3 (bench_cma.py): N = 100, lambda = 4096, centroid 5, sigma 5
CMA_DIM, CMA_LAMBDA, CMA_WARM, CMA_TIMING_NGEN, CMA_PAIRS = 100, 4096, 5, 5, 1
CMA_RTOL = 1e-4          # card vs CPU, relative to a field's largest value
CMA_B_ATOL = 1e-2        # |B_cardᵀ B_cpu| = I up to column signs
CMA_HSIG_MARGIN = 1e-4   # pc and C are compared only beyond this margin
MO_HV_THRESHOLD = 116.0  # tests/test_algorithms.py:15


def onemax_toolbox():
    from deap_tpu_torch import base
    from deap_tpu_torch.ops import crossover, mutation, selection
    import torch
    tb = base.Toolbox()
    tb.register("evaluate", lambda g: (torch.sum(g),))
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_flip_bit, indpb=0.05)
    tb.register("select", selection.sel_tournament, tournsize=3)
    return tb


def onemax_run(dev, ngen: int, impl: str = "threefry2x32"):
    """``ea_simple`` at BASELINE config 1 with ``HallOfFame(1)`` and
    max / avg statistics from ``PRNGKey(0)`` of ``impl`` on ``dev``."""
    import torch
    from deap_tpu_torch import base, random
    from deap_tpu_torch._xla_math import row_mean
    from deap_tpu_torch.algorithms import ea_simple
    from deap_tpu_torch.utils.support import HallOfFame, Statistics
    key = random.PRNGKey(0, impl=impl, device=dev)
    genome = random.bernoulli(key, 0.5, (OM_POP, OM_BITS)).float()
    stats = Statistics(lambda p: p.fitness.values[:, 0])
    stats.register("max", torch.max)
    stats.register("avg", row_mean)
    hof = HallOfFame(1)
    pop = base.Population(genome, base.Fitness.empty(OM_POP, (1.0,),
                                                     device=dev))
    pop, log = ea_simple(key, pop, onemax_toolbox(), OM_CXPB, OM_MUTPB, ngen,
                         stats=stats, halloffame=hof)
    return pop, log, hof


def onemax_phase(card_line, impl: str = "threefry2x32") -> None:
    import torch
    from deap_tpu_torch import kernels
    dev = torch.device("cuda")
    kernels.reset_launches()
    pop, log, hof = onemax_run(dev, OM_NGEN, impl)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    cpop, clog, chof = onemax_run(torch.device("cpu"), OM_NGEN, impl)
    same = {
        "genome": torch.equal(pop.genome.cpu(), cpop.genome),
        "values": torch.equal(pop.fitness.values.cpu(), cpop.fitness.values),
        "logbook": all(log.select(c) == clog.select(c)
                       for c in ("gen", "nevals", "max", "avg")),
        "archive": (torch.equal(hof.state.genome.cpu(), chof.state.genome)
                    and torch.equal(hof.state.values.cpu(),
                                    chof.state.values)
                    and torch.equal(hof.state.filled.cpu(),
                                    chof.state.filled))}
    best = log.select("max")
    reached = next((g for g, m in zip(log.select("gen"), best)
                    if m == OM_BITS), None)

    def run(ngen):
        torch.cuda.synchronize()
        t = time.perf_counter()
        onemax_run(dev, ngen, impl)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    run(2)
    per_gen, marginals, pairs = _timed_pairs(run, OM_TIMING_NGEN, OM_PAIRS)
    phase(f"OneMax ea_simple + HallOfFame(1) (BASELINE config 1), {impl}",
          card_line, key_impl=impl,
          pop=OM_POP, bits=OM_BITS, ngen=OM_NGEN, card_equals_cpu=same,
          max_start=best[0], max_end=best[-1], gen_max_reaches_100=reached,
          hof_best=float(hof.state.values[0, 0]),
          timing_ngen=[OM_TIMING_NGEN, 2 * OM_TIMING_NGEN],
          seconds=[list(p) for p in pairs],
          marginal_ms_per_gen=per_gen * 1e3,
          marginal_ms_range=[marginals[0] * 1e3, marginals[-1] * 1e3],
          launches=launches)
    if not all(same.values()):
        fail(f"OneMax card vs CPU differ: {same}")
    if not best[-1] > best[0] or hof.state.values[0, 0] != max(best):
        fail(f"OneMax did not improve or the archive missed the best: "
             f"{best[0]} -> {best[-1]}, hof {hof.state.values[0, 0]}")


def cma_toolbox(strategy, fn: str):
    from deap_tpu_torch import base, benchmarks
    tb = base.Toolbox()
    tb.register("evaluate", getattr(benchmarks, fn))
    tb.register("generate", strategy.generate)
    tb.register("update", strategy.update)
    return tb


def _rel(a, b) -> float:
    import torch
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _hsig_margin(strategy, state) -> float:
    import math
    lhs = (float(state.ps.double().norm())
           / math.sqrt(1 - (1 - strategy.cs) ** (2 * int(state.update_count)))
           / strategy.chiN)
    return abs(lhs - (1.4 + 2.0 / (strategy.dim + 1.0)))


def _state_to(state, dev):
    import dataclasses
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).to(dev)
        for f in dataclasses.fields(state)})


def eigh_on_card(C) -> dict:
    """``torch.linalg.eigh`` of ``C`` under the profiler (the device
    kernels it ran, their time a call over five calls) and its
    host-clock ms a call, the host synchronisation on its ``info``
    included.  A window in which the profiler recorded no device
    activity at all is taken again, up to three times (a short window
    has come back empty on the card)."""
    import torch
    w, B = torch.linalg.eigh(C)
    for _ in range(3):
        prof = _profile_window(
            lambda: [torch.linalg.eigh(C) for _ in range(5)], gens=5)
        if prof["kernel_launches"]:
            break
    return {"on_card": bool(w.is_cuda and B.is_cuda),
            "device_ms": prof["device_busy_ms"],
            "kernel_launches": prof["kernel_launches"],
            "kernels": [k["kernel"] for k in prof["top_kernels"]],
            "wall_ms": _wall_ms(lambda: torch.linalg.eigh(C), reps=20)}


def cma_phase(card_line, fn: str, impl: str = "threefry2x32") -> None:
    """BASELINE config 3 on ``fn`` from ``PRNGKey(0)`` of ``impl``: a
    teacher-forced step card vs CPU, the marginal ms of
    ``ea_generate_update`` and ``eigh``'s share."""
    import torch
    from deap_tpu_torch import base, cma, kernels, random
    from deap_tpu_torch.algorithms import ea_generate_update, \
        evaluate_population
    from deap_tpu_torch.utils.support import Statistics
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        fail("TF32 is on: the CMA-ES products must run in full float32")
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    s = cma.Strategy(centroid=[5.0] * CMA_DIM, sigma=5.0, lambda_=CMA_LAMBDA,
                     device=dev)
    sc = cma.Strategy(centroid=[5.0] * CMA_DIM, sigma=5.0,
                      lambda_=CMA_LAMBDA, device=cpu)
    tb = cma_toolbox(s, fn)
    key = random.PRNGKey(0, impl=impl, device=dev)
    stats = Statistics(lambda p: p.fitness.values[:, 0])
    stats.register("min", torch.min)
    kernels.reset_launches()
    pop, state, log = ea_generate_update(key, tb, s.init(), CMA_WARM,
                                         weights=(-1.0,), stats=stats)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)

    # one step teacher-forced: the same state, key and population
    k = random.fold_in(key, 99)
    g_card = s.generate(state, k)
    g_cpu = sc.generate(_state_to(state, cpu), k.cpu())
    pop = base.Population(g_card, base.Fitness.empty(CMA_LAMBDA, (-1.0,),
                                                     device=dev))
    pop, _ = evaluate_population(tb, pop)
    nxt = s.update(state, pop)
    nxt_cpu = sc.update(_state_to(state, cpu), base.Population(
        pop.genome.cpu(), base.Fitness(pop.fitness.values.cpu(),
                                       pop.fitness.valid.cpu(), (-1.0,))))
    margin = _hsig_margin(sc, nxt_cpu)
    fields = ["centroid", "sigma", "ps", "diagD"] + (
        ["pc", "C"] if margin > CMA_HSIG_MARGIN else [])
    errs = {"genome": _rel(g_card, g_cpu)}
    errs.update({f: _rel(getattr(nxt, f), getattr(nxt_cpu, f))
                 for f in fields})
    cross = (nxt.B.cpu().T @ nxt_cpu.B).abs()
    errs["B_up_to_sign"] = float((cross - torch.eye(CMA_DIM)).abs().max())
    flipped = int((torch.diagonal(nxt.B.cpu().T @ nxt_cpu.B) < 0).sum())

    eig = eigh_on_card(nxt.C)

    def run(ngen):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ea_generate_update(key, tb, s.init(), ngen, weights=(-1.0,))
        torch.cuda.synchronize()
        return time.perf_counter() - t

    run(2)
    per_gen, marginals, pairs = _timed_pairs(run, CMA_TIMING_NGEN, CMA_PAIRS)
    prof = _profile_window(lambda: run(CMA_TIMING_NGEN), CMA_TIMING_NGEN)
    best = log.select("min")
    fit = pop.fitness.values
    phase(f"CMA-ES ea_generate_update {fn} (BASELINE config 3), {impl}",
          card_line, key_impl=impl, dim=CMA_DIM, lambda_=CMA_LAMBDA, warm_gens=CMA_WARM,
          teacher_forced_rel_err=errs, rtol=CMA_RTOL, b_atol=CMA_B_ATOL,
          hsig_margin=margin, b_columns_flipped=flipped,
          eigh=eig, tf32=torch.backends.cuda.matmul.allow_tf32,
          matmul_precision=torch.get_float32_matmul_precision(),
          timing_ngen=[CMA_TIMING_NGEN, 2 * CMA_TIMING_NGEN],
          seconds=[list(p) for p in pairs],
          marginal_ms_per_gen=per_gen * 1e3,
          marginal_ms_range=[marginals[0] * 1e3, marginals[-1] * 1e3],
          eigh_share_of_gen=eig["wall_ms"] / (per_gen * 1e3),
          profile_one_gen=prof, best_start=best[0], best_end=best[-1],
          sigma=float(nxt.sigma), launches=launches)
    bad = {f: e for f, e in errs.items()
           if e > (CMA_B_ATOL if f == "B_up_to_sign" else CMA_RTOL)}
    if bad:
        fail(f"CMA-ES {fn} card vs CPU beyond tolerance: {bad}")
    if not eig["on_card"] or not eig["kernel_launches"]:
        fail(f"eigh did not run on the card: {eig}")
    if not bool(torch.isfinite(fit).all()) or \
            tuple(pop.genome.shape) != (CMA_LAMBDA, CMA_DIM):
        fail(f"CMA-ES {fn}: population not finite or misshaped")


def cma_anchor_phase(card_line) -> None:
    """Verify flow 2 (sphere, N = 5, lambda 20, 100 generations) and the
    (1+lambda) anchor (N = 5, lambda 8, 300 generations) on the card."""
    import torch
    from deap_tpu_torch import cma, kernels, random
    from deap_tpu_torch.algorithms import ea_generate_update
    dev = torch.device("cuda")
    kernels.reset_launches()
    s = cma.Strategy(centroid=[5.0] * 5, sigma=5.0, lambda_=20, device=dev)
    t = time.perf_counter()
    pop, state, log = ea_generate_update(
        random.PRNGKey(0, device=dev), cma_toolbox(s, "sphere"), s.init(),
        ngen=100, weights=(-1.0,))
    best = float(pop.fitness.values.min())
    t_flow2 = time.perf_counter() - t
    s1 = cma.StrategyOnePlusLambda(parent=[3.0] * 5, sigma=1.0,
                                   weights=(-1.0,), lambda_=8, device=dev)
    t = time.perf_counter()
    _, st1, _ = ea_generate_update(
        random.PRNGKey(10, device=dev), cma_toolbox(s1, "sphere"), s1.init(),
        ngen=300, weights=(-1.0,))
    best1 = -float(st1.parent_wvalues[0])
    t_opl = time.perf_counter() - t
    phase("CMA-ES anchors: verify flow 2 and (1+lambda)", card_line,
          flow2_best=best, flow2_seconds=t_flow2, flow2_gens=len(log),
          one_plus_lambda_best=best1, one_plus_lambda_seconds=t_opl,
          one_plus_lambda_A_on_card=bool(st1.A.is_cuda),
          launches=dict(kernels.LAUNCHES))
    if not best < 1e-8:
        fail(f"CMA-ES flow 2 best {best} is not below 1e-8")
    if not best1 < 1e-3:
        fail(f"(1+lambda) best {best1} is not below 1e-3")


def mo_cma_phase(card_line) -> None:
    """MO-CMA-ES on ZDT1 as tests/test_algorithms.py:178 runs it (MU =
    LAMBDA = 10, 500 generations, RandomState(128)) on the card; the
    device and host selection routes on every generation's candidates."""
    import numpy as np
    import torch
    from deap_tpu_torch import benchmarks, cma, kernels, random
    from deap_tpu_torch.ops.hv import hypervolume
    dev = torch.device("cuda")

    def evaluate(genomes):
        g = np.asarray(genomes, np.float64)
        f = np.clip(g, 0.0, 1.0)
        vals = torch.stack(benchmarks.zdt1(
            torch.as_tensor(f, dtype=torch.float32, device=dev)), 1)
        pen = 1e7 * np.sum((f - g) ** 2, axis=1)
        return vals.double().cpu().numpy() + pen[:, None]

    kernels.reset_launches()
    pop = np.random.RandomState(128).rand(10, 5)
    s = cma.StrategyMultiObjective(pop, (-1.0, -1.0), sigma=1.0,
                                   values=evaluate(pop), mu=10, lambda_=10,
                                   device=dev)
    key = random.PRNGKey(128, device=dev)
    disagree, t_dev, t_host = 0, 0.0, 0.0
    t0 = time.perf_counter()
    for _ in range(500):
        key, k = random.split(key)
        off = s.generate(k)
        vals = evaluate(off)
        genomes = np.concatenate([off, s.parents])
        values = np.concatenate([vals, s.parent_values])
        t = time.perf_counter()
        dev_pick = s._select(genomes, values, None)
        t_dev += time.perf_counter() - t
        s.select_backend = "host"
        t = time.perf_counter()
        host_pick = s._select(genomes, values, None)
        t_host += time.perf_counter() - t
        s.select_backend = "auto"
        if dev_pick[0] != host_pick[0] or \
                set(dev_pick[1]) != set(host_pick[1]):
            disagree += 1
        s.update(off, vals)
    seconds = time.perf_counter() - t0
    hv = hypervolume(s.parent_values, [11.0, 11.0])
    feasible = bool(np.all(s.parents >= -1e-5) and np.all(s.parents
                                                          <= 1 + 1e-5))
    phase("MO-CMA-ES ZDT1 (tests/test_algorithms.py:178)", card_line,
          mu=10, lambda_=10, ngen=500, hypervolume=hv,
          threshold=MO_HV_THRESHOLD, feasible=feasible,
          select_routes_disagree=disagree, seconds=seconds,
          device_select_ms=t_dev / 500 * 1e3,
          host_select_ms=t_host / 500 * 1e3,
          launches=dict(kernels.LAUNCHES))
    if disagree:
        fail(f"device and host MO-CMA selection differ on {disagree} "
             "generations")
    if not hv > MO_HV_THRESHOLD or not feasible:
        fail(f"MO-CMA-ES hypervolume {hv} <= {MO_HV_THRESHOLD} or "
             "parents outside [0, 1]")


# ---------------------------------------------------------------------------
# the rbg key implementation, and the paths that default to it
# ---------------------------------------------------------------------------

RBG_DRAWS = 1 << 20
RBG_BATCH = 4096                   # keys of an (n, 4) batch
RBG_TIME_DRAWS = 10 ** 6
# jax.random.bits(key, (n,)) of raw rbg keys on jax 0.9.0's CPU backend
RBG_GOLDEN = (
    ((0, 0, 0, 0), (1713891541, 3781805453, 3159862348, 2600524760)),
    ((1, 2, 3, 4), (512747620, 1298009047, 1267190206)),
    ((0xDEADBEEF, 0x12345678, 0xFFFFFFFF, 0xFFFFFFFE),
     (65559129, 1930409553, 648285888)))
RBG_NGEN, RBG_PAIRS = 10, 1
RBG_REF_POP, RBG_REF_GENS = 10_240, 3      # a multiple of the rows a tile
# evopole: bench_evopole.py's defaults (examples/ga/evopole.py's constants)
EVO_REF_GENS = 1
EVO_TIMING_NGEN, EVO_PAIRS = 1, 1       # the rise is read on the 2N run
EVO_PROFILE_STEPS = 50


def _bits_of(t):
    """A tensor's bit pattern on the host, for bitwise comparisons."""
    import torch
    t = t.detach().cpu()
    if t.dtype in (torch.float32, torch.int32):
        return t.view(torch.int32)
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16)
    if t.dtype == torch.float64:
        return t.contiguous().view(torch.int64)
    return t


def _same_bits(a, b) -> bool:
    import torch
    a, b = _bits_of(a), _bits_of(b)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def rbg_phase(card_line) -> dict:
    """The rbg key implementation on the card: the golden words, and every
    key function and sampler at 2^20 draws, from one key and from an
    ``(n, 4)`` batch, against the CPU's bit for bit; the ms of 1e6
    uniforms under rbg and threefry."""
    import torch
    from deap_tpu_torch import random
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    golden = {str(list(w)): random.bits(torch.tensor(w, dtype=torch.int64,
                                                     device=dev),
                                        (len(want),)).tolist() == list(want)
              for w, want in RBG_GOLDEN}
    key = random.PRNGKey(0, impl="rbg", device=dev)
    batch = random.split(random.fold_in(key, 1), RBG_BATCH)
    per_key = RBG_DRAWS // RBG_BATCH
    funcs = {
        "split": lambda k, n: random.split(k, 3),
        "fold_in": lambda k, n: random.fold_in(k, 7),
        "bits": lambda k, n: random.bits(k, (n,)),
        "uniform": lambda k, n: random.uniform(k, (n,), minval=-5.12,
                                               maxval=5.12),
        "normal": lambda k, n: random.normal(k, (n,)),
        "normal_bfloat16": lambda k, n: random.normal(k, (n,),
                                                      torch.bfloat16),
        "bernoulli": lambda k, n: random.bernoulli(k, 0.3, (n,)),
        "randint": lambda k, n: random.randint(k, (n,), -50, 1_000_003),
    }
    equal = {}
    for name, f in funcs.items():
        for label, k, n in (("key", key, RBG_DRAWS),
                            ("batch", batch, per_key)):
            equal[f"{name} {label}"] = _same_bits(f(k, n), f(k.to(cpu), n))
    ms = {impl: cuda_ms(lambda impl=impl: random.uniform(
              random.PRNGKey(3, impl=impl, device=dev), (RBG_TIME_DRAWS,)))
          for impl in ("rbg", "threefry2x32")}
    phase("rbg: keys and samplers card vs CPU, golden words", card_line,
          draws=RBG_DRAWS, batch=[RBG_BATCH, 4], golden=golden,
          card_equals_cpu=equal,
          uniform_ms_1e6={"rbg": ms["rbg"], "threefry2x32":
                          ms["threefry2x32"]})
    if not all(golden.values()):
        fail(f"rbg bits differ from jax's golden words: {golden}")
    bad = [k for k, v in equal.items() if not v]
    if bad:
        fail(f"rbg on the card differs from the CPU: {bad}")
    return ms


def flagship_rbg_phase(kernels, card_line) -> dict:
    """The flagship under rbg keys (``bench.py``'s default): ``ea_simple``
    with the megakernel engine on rastrigin at 1e6 x 100 float32 from
    ``PRNGKey(0, impl="rbg")``, N and 2N generations, one pair; K2
    once a generation; the best fitness must fall.  Then three
    generations at 10240 x 100, teacher-forced card against CPU (offspring
    bitwise, fitness within rtol 1e-5: rastrigin's sum runs in each
    device's order), and the live-mask ``ea_step`` with K1 counted."""
    import torch
    from deap_tpu_torch import base, benchmarks, random
    from deap_tpu_torch.algorithms import ea_simple, ea_step
    from deap_tpu_torch.ops import crossover, mutation, selection
    from deap_tpu_torch.utils.support import Statistics
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    tb = base.Toolbox()
    tb.register("evaluate", benchmarks.rastrigin)
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_gaussian, mu=MU, sigma=SIGMA,
                indpb=INDPB)
    tb.register("select", selection.sel_tournament, tournsize=3,
                tie_break="rank")
    tb.generation_engine = "megakernel"
    stats = Statistics(lambda p: p.fitness.values[:, 0])
    stats.register("min", torch.min)
    key = random.PRNGKey(0, impl="rbg", device=dev)
    k_init, k_run, k_ref, k_live = random.split(key, 4)
    genome = random.uniform(k_init, (POP, DIM), minval=-5.12, maxval=5.12)

    def run(ngen):
        pop0 = base.Population(genome.clone(), base.Fitness.empty(
            POP, (-1.0,), device=dev))
        torch.cuda.synchronize()
        t = time.perf_counter()
        pop, log = ea_simple(k_run, pop0, tb, CXPB, MUTPB, ngen, stats=stats)
        torch.cuda.synchronize()
        return time.perf_counter() - t, pop, log

    run(2)
    kernels.reset_launches()
    _, pop, log = run(RBG_NGEN)
    launches = dict(kernels.LAUNCHES)
    per_gen, marginals, pairs = _timed_pairs(lambda n: run(n)[0], RBG_NGEN,
                                             RBG_PAIRS)
    best = log.select("min")

    # teacher-forced generations at 1e4 x 100, card against CPU
    small = base.Population(genome[:RBG_REF_POP].clone(), base.Fitness.empty(
        RBG_REF_POP, (-1.0,), device=dev))
    from deap_tpu_torch.algorithms import evaluate_population
    small, _ = evaluate_population(tb, small)
    k, ref = k_ref, []
    for _ in range(RBG_REF_GENS):
        host = base.Population(small.genome.cpu(), base.Fitness(
            small.fitness.values.cpu(), small.fitness.valid.cpu(), (-1.0,)))
        k_next, nxt, _ = ea_step(k, small, tb, CXPB, MUTPB)
        _, nxt_cpu, _ = ea_step(k.cpu(), host, tb, CXPB, MUTPB)
        ref.append({"genome": _same_bits(nxt.genome, nxt_cpu.genome),
                    "fitness_rel_err": _rel(nxt.fitness.values,
                                            nxt_cpu.fitness.values)})
        k, small = k_next, nxt

    live = torch.arange(POP, device=dev) < POP - 4096
    kernels.reset_launches()
    skey, spop = k_live, pop
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(LIVE_GENS):
        skey, spop, _ = ea_step(skey, spop, tb, CXPB, MUTPB, live=live)
    torch.cuda.synchronize()
    t_live = time.perf_counter() - t
    launches_live = dict(kernels.LAUNCHES)
    frozen = torch.equal(spop.genome[~live], pop.genome[~live])
    phase("flagship under rbg: ea_simple megakernel rastrigin", card_line,
          key_impl="rbg", pop=POP, dim=DIM, ngen=[RBG_NGEN, 2 * RBG_NGEN],
          seconds=[list(p) for p in pairs],
          marginal_ms_per_gen=per_gen * 1e3,
          marginal_ms_range=[marginals[0] * 1e3, marginals[-1] * 1e3],
          best_start=best[0], best_end=best[-1], launches=launches,
          teacher_forced_card_vs_cpu=ref, reference_pop=RBG_REF_POP,
          live_gens=LIVE_GENS, live_ms_per_gen=t_live / LIVE_GENS * 1e3,
          launches_live=launches_live, pad_rows_frozen=frozen)
    if launches["megakernel_gather_vary"] != RBG_NGEN:
        fail(f"K2 ran {launches['megakernel_gather_vary']} times in "
             f"{RBG_NGEN} generations under rbg keys")
    if not best[-1] < best[0]:
        fail(f"rbg flagship: best fitness did not fall: {best}")
    if not all(r["genome"] and r["fitness_rel_err"] <= 1e-5 for r in ref):
        fail(f"rbg flagship: card and CPU generations differ: {ref}")
    if launches_live["megakernel_vary"] != LIVE_GENS or not frozen:
        fail(f"rbg live-mask step: K1 ran "
             f"{launches_live['megakernel_vary']} times, pads frozen "
             f"{frozen}")
    return {"K2": launches["megakernel_gather_vary"],
            "K1": launches_live["megakernel_vary"]}


def evopole_setup(dev, masked: bool = False):
    """``bench_evopole.py``'s set-up on ``dev``: ``PRNGKey(0)`` under rbg
    split into the loop key, the initial population's and the episodes';
    blend crossover, Gaussian weight mutation, ``sel_tournament(3)``."""
    from deap_tpu_torch import base, random
    from deap_tpu_torch.examples.ga import evopole as EV
    from deap_tpu_torch.ops import selection
    key = random.PRNGKey(0, impl="rbg", device=dev)
    key, k_init, k_eps = random.split(key, 3)
    tb = base.Toolbox()
    tb.register("evaluate", EV.make_evaluate(
        random.split(k_eps, EV.N_EPISODES), masked=masked))
    tb.register("mate", EV.mate_blend)
    tb.register("mutate", EV.mut_gaussian_tree)
    tb.register("select", selection.sel_tournament, tournsize=3)
    pop = base.Population(EV.init_population(k_init, EV.POP),
                          base.Fitness.empty(EV.POP, (1.0,), device=dev))
    return key, pop, tb


def evopole_run(dev, ngen: int):
    """``ea_simple`` at BASELINE config 5 with max / avg statistics and
    ``HallOfFame(1)``, as the example's ``main`` runs it."""
    import torch
    from deap_tpu_torch._xla_math import row_mean
    from deap_tpu_torch.algorithms import ea_simple
    from deap_tpu_torch.examples.ga import evopole as EV
    from deap_tpu_torch.utils.support import HallOfFame, Statistics
    key, pop, tb = evopole_setup(dev)
    stats = Statistics(lambda p: p.fitness.values[:, 0])
    stats.register("max", torch.max)
    stats.register("avg", row_mean)
    hof = HallOfFame(1)
    pop, log = ea_simple(key, pop, tb, EV.CXPB, EV.MUTPB, ngen, stats=stats,
                         halloffame=hof)
    return pop, log, hof


def cpu_evopole() -> dict:
    """The CPU run of :func:`evopole_phase`'s card = CPU check."""
    import torch
    t = time.perf_counter()
    pop, log, hof = evopole_run(torch.device("cpu"), EVO_REF_GENS)
    return {"genome": pop.genome, "values": pop.fitness.values,
            "log": {c: log.select(c) for c in ("gen", "nevals", "max",
                                               "avg")},
            "hof_genome": hof.state.genome, "hof_values": hof.state.values,
            "seconds": time.perf_counter() - t}


def evopole_phase(kernels, card_line) -> dict:
    """BASELINE config 5 at ``bench_evopole.py``'s defaults (pop 256, 4
    episodes of at most 500 steps, hidden 16, rbg keys): one
    generation card against CPU, bitwise; the marginal ms a generation
    (N and 2N, one pair); one generation of the masked rollout; the
    device's share of a window of rollout steps under the profiler; the
    maximum fitness must rise over the 2N generations of the timed pair
    (or, where it starts at its ceiling of 500, stay there while the
    average rises).  No kernel of the port is on this path: its launch
    counts must stay zero.  The CPU run of the card = CPU check runs in
    this process after the card's runs: nothing runs beside the timed
    ones, and as a second interpreter beside the card's runs (or beside
    the phases before this one) it took two to ten times as long as in
    this process."""
    import torch
    from deap_tpu_torch.algorithms import ea_step, evaluate_population
    from deap_tpu_torch.examples.ga import evopole as EV
    dev = torch.device("cuda")
    kernels.reset_launches()
    pop, log, hof = evopole_run(dev, EVO_REF_GENS)
    torch.cuda.synchronize()

    logs = {}

    def run(ngen):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logs[ngen] = evopole_run(dev, ngen)[1]
        torch.cuda.synchronize()
        return time.perf_counter() - t

    per_gen, marginals, pairs = _timed_pairs(run, EVO_TIMING_NGEN, EVO_PAIRS)
    rlog = logs[2 * EVO_TIMING_NGEN]

    # one generation with the masked rollout, from the same state as the
    # fixed-length one: the same fitness, in fewer steps
    key, pop0, tb = evopole_setup(dev)
    pop0, _ = evaluate_population(tb, pop0)
    _, _, tbm = evopole_setup(dev, masked=True)

    def one_gen(toolbox):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = ea_step(key, pop0, toolbox, EV.CXPB, EV.MUTPB)[1]
        torch.cuda.synchronize()
        return time.perf_counter() - t, out

    ms_fixed, out_fixed = one_gen(tb)
    ms_masked, out_masked = one_gen(tbm)
    masked_same = _same_bits(out_fixed.fitness.values,
                             out_masked.fitness.values)

    # the rollout's body, as ``rollout_population`` runs it (deferred
    # rounding, the small-argument sine and cosine), under the profiler:
    # kernel launches a step and the device's busy share of the wall clock
    from deap_tpu_torch._xla_math import deferred_rounding, sincos_small
    state = torch.zeros((EV.POP, EV.N_EPISODES, 4), device=dev)
    g = {k: v.unsqueeze(1).double() if k[0] == "w" else v.unsqueeze(1)
         for k, v in pop0.genome.items()}

    def steps():
        s = state
        with deferred_rounding() as rounding:
            for _ in range(EVO_PROFILE_STEPS):
                s = EV._env_step(s, EV.policy_action(g, s), sincos_small)
                rounding.check()

    steps()
    prof = _profile_window(steps, EVO_PROFILE_STEPS)

    launches = dict(kernels.LAUNCHES)
    host = cpu_evopole()
    cpu_s = host["seconds"]
    names = sorted(pop.genome)
    same = {
        "genome": all(_same_bits(pop.genome[k], host["genome"][k])
                      for k in names),
        "values": _same_bits(pop.fitness.values, host["values"]),
        "logbook": all(log.select(c) == v for c, v in host["log"].items()),
        "archive": (all(_same_bits(hof.state.genome[k],
                                   host["hof_genome"][k]) for k in names)
                    and _same_bits(hof.state.values, host["hof_values"]))}
    best, avg = rlog.select("max"), rlog.select("avg")
    phase("evopole ea_simple + HallOfFame(1) (BASELINE config 5), rbg",
          card_line, key_impl="rbg", pop=EV.POP, episodes=EV.N_EPISODES,
          max_steps=EV.MAX_STEPS, hidden=EV.HIDDEN,
          ref_gens=EVO_REF_GENS, card_equals_cpu=same,
          cpu_seconds_ref_gens=cpu_s,
          timing_ngen=[EVO_TIMING_NGEN, 2 * EVO_TIMING_NGEN],
          seconds=[list(p) for p in pairs],
          marginal_ms_per_gen=per_gen * 1e3,
          marginal_ms_range=[marginals[0] * 1e3, marginals[-1] * 1e3],
          env_steps_per_s=EV.POP * EV.N_EPISODES * EV.MAX_STEPS / per_gen,
          masked_generation_ms=ms_masked * 1e3,
          fixed_generation_ms=ms_fixed * 1e3,
          masked_equals_fixed=masked_same,
          rollout_step_profile=prof,
          kernel_launches_per_gen_rollout=(
              prof["kernel_launches"] * EV.MAX_STEPS),
          max_by_gen=best, avg_by_gen=avg, port_kernel_launches=launches)
    if not all(same.values()):
        fail(f"evopole card vs CPU differ: {same}")
    if not masked_same:
        fail("evopole: the masked rollout's fitness differs")
    # from bench_evopole.py's key the initial population already holds a
    # policy that balances all four episodes: a maximum at its ceiling
    # cannot rise, and then the average must
    if not (best[-1] > best[0] or (best[0] == EV.MAX_STEPS
                                   and min(best) == EV.MAX_STEPS
                                   and avg[-1] > avg[0])):
        fail(f"evopole: the maximum fitness did not rise (max {best}, "
             f"avg {avg})")
    if any(launches.values()):
        fail(f"a port kernel ran on the evopole path: {launches}")
    return {"marginal_ms_per_gen": per_gen * 1e3}


# ---------------------------------------------------------------------------
# the rest of multi-objective: random.permutation, sel_tournament_dcd,
# bench_nsga2.py's BENCH_SELECT=nsga3 | spea2 and BENCH_STAGED=1, the
# NSGA-II and NSGA-III examples
# ---------------------------------------------------------------------------

# bench_nsga2.py's reference points ({2: 99, 3: 12} divisions) and SPEA2
# chunk (max(64, min(1024, 1e8 // (2 POP))): 500 at POP 1e5)
BN_P = {2: 99, 3: 12}
MO_REF_POP = 4096
# (N, pairs) of the (N, 2N) timing at POP 1e5, and the problems run there
MO_SEL_PATHS = {"nsga3": ((2, 1), ("zdt1", "dtlz2")),
                "spea2": ((1, 1), ("zdt1", "dtlz2")),
                "spea2-staged": ((1, 1), ("dtlz2",))}
TRUNC_N, TRUNC_K = 2048, 1024
PERM_SIZES = (1000, 1 << 20)


def bench_chunk(n: int) -> int:
    return max(64, min(1024, 10 ** 8 // (2 * n)))


def bench_select(name: str, nobj: int, n: int):
    """The environmental selection of bench_nsga2.py's ``BENCH_SELECT``
    (``nsga3``, ``spea2``) or of ``BENCH_STAGED=1`` (``spea2-staged``,
    the script's two stage calls), as ``select(k_sel, fitness, n)``."""
    from deap_tpu_torch.ops import emo
    chunk = bench_chunk(n)
    if name == "nsga3":
        rp = emo.uniform_reference_points(nobj, BN_P[nobj])
        return lambda k, f, m: emo.sel_nsga3(k, f, m, rp)
    if name == "spea2":
        return lambda k, f, m: emo.sel_spea2(k, f, m, chunk=chunk)
    return lambda k, f, m: emo.sel_spea2_staged(k, f, m, chunk=chunk)


def mo_quality(problem: str, fitness) -> float:
    """DTLZ2's mean ``|sum f^2 - 1|`` (must fall) or ZDT1's hypervolume
    at (11, 11) (must rise)."""
    from deap_tpu_torch.ops import hv as host_hv
    v = fitness.values
    if problem == "dtlz2":
        return float(((v.double() ** 2).sum(1) - 1.0).abs().mean().item())
    return host_hv.hypervolume(v.double().cpu().numpy(), HV_REF["zdt1"])


def permutation_phase(card_line) -> None:
    """``random.permutation`` at 2**20 (two rounds) and 1000 (one) under
    both key implementations: card equal to CPU bit for bit, and the
    card's ms (CUDA events)."""
    import torch
    from deap_tpu_torch import random
    dev = torch.device("cuda")
    same, ms = {}, {}
    for impl in ("threefry2x32", "rbg"):
        for n in PERM_SIZES:
            key = random.PRNGKey(n, impl=impl, device="cpu")
            kd = key.to(dev)
            tag = f"{impl} n={n}"
            same[tag] = torch.equal(random.permutation(kd, n).cpu(),
                                    random.permutation(key, n))
            ms[tag] = cuda_ms(lambda: random.permutation(kd, n), reps=5,
                              warm=1)
    phase("random.permutation card vs CPU", card_line, bitwise=same,
          ms=ms, rounds={n: random._shuffle_rounds(n) for n in PERM_SIZES})
    if not all(same.values()):
        fail(f"random.permutation on the card differs from the CPU: {same}")


def cpu_dcd(key, values, valid, weights) -> tuple:
    """The CPU side of :func:`dcd_phase`: the winners and seconds."""
    from deap_tpu_torch import base
    from deap_tpu_torch.ops import emo
    t = time.perf_counter()
    b = emo.sel_tournament_dcd(key, base.Fitness(values, valid, weights),
                               values.shape[0])
    return b, time.perf_counter() - t


def dcd_phase(card_line, key, pop):
    """``sel_tournament_dcd`` on a 1e5-point DTLZ2 population (NSGA-III's
    at full width): card equal to CPU bit for bit.  The CPU side runs
    beside the phases that follow; the returned function waits for it
    and checks."""
    import torch
    from deap_tpu_torch.ops import emo
    n = pop.size
    fc = pop.fitness
    cpu_side = CpuSide("cpu_dcd", key=key.cpu(), values=fc.values.cpu(),
                       valid=fc.valid.cpu(), weights=fc.weights)
    torch.cuda.synchronize()
    t = time.perf_counter()
    a = emo.sel_tournament_dcd(key, fc, n).cpu()
    card_s = time.perf_counter() - t

    def finish() -> None:
        b, cpu_s = cpu_side.result()
        same = torch.equal(a, b)
        phase("sel_tournament_dcd card vs CPU, DTLZ2 population", card_line,
              pop=n, k=n, bitwise=same, card_seconds=card_s,
              cpu_seconds=cpu_s, distinct_winners=int(torch.unique(a)
                                                      .numel()))
        if not same:
            fail("sel_tournament_dcd on the card differs from the CPU")
    return finish


def mo_select_reference(card_line, key, problem: str, name: str) -> None:
    """One published generation at POP 4096 with ``BENCH_SELECT`` (or
    the staged SPEA2), card against CPU: offspring, objective values
    and selected indices bitwise."""
    import torch
    from deap_tpu_torch import random
    dev = torch.device("cuda")
    nobj, _ = BN_PROBLEMS[problem]
    tb = bench_nsga2_toolbox(problem)
    k_init, k_gen = random.split(key.cpu())
    pop = bench_nsga2_initial(tb, k_init, problem, MO_REF_POP)
    select = bench_select(name, nobj, MO_REF_POP)
    outs = []
    for d in (torch.device("cpu"), dev):
        p = type(pop)(pop.genome.to(d), type(pop.fitness)(
            pop.fitness.values.to(d), pop.fitness.valid.to(d),
            pop.fitness.weights))
        t = time.perf_counter()
        _, new = bench_nsga2_generation(tb, k_gen.to(d), p, select=select)
        if d.type == "cuda":
            torch.cuda.synchronize()
        outs.append((new, time.perf_counter() - t))
    (c, cpu_s), (g, card_s) = outs
    same = {"genome": torch.equal(c.genome.view(torch.int32),
                                  g.genome.cpu().view(torch.int32)),
            "values": torch.equal(c.fitness.values.view(torch.int32),
                                  g.fitness.values.cpu().view(torch.int32))}
    phase(f"reference: bench_nsga2 {name} {problem} generation card vs CPU",
          card_line, pop=MO_REF_POP, nobj=nobj, bitwise=same,
          cpu_seconds=cpu_s, card_seconds=card_s)
    if not all(same.values()):
        fail(f"bench_nsga2 {name} {problem} at POP {MO_REF_POP}: card and "
             f"CPU differ: {same}")


def mo_select_main_path(kernels, card_line, key, problem: str, name: str):
    """``bench_nsga2.py`` with ``BENCH_SELECT=name`` at POP 1e5 (depth
    cut): N and 2N generations in pairs (median marginal ms), launches
    counted on the last 2N-generation run, the quality metric
    from generation 0 to the end.  Returns (launches, marginal ms, final
    population)."""
    import torch
    from deap_tpu_torch import random
    nobj, ndim = BN_PROBLEMS[problem]
    tb = bench_nsga2_toolbox(problem)
    k_init, k_run = random.split(key)
    pop0 = bench_nsga2_initial(tb, k_init, problem, BN_POP)
    select = bench_select(name, nobj, BN_POP)
    ngen, pairs_n = MO_SEL_PATHS[name][0]
    q0 = mo_quality(problem, pop0.fitness)
    state = {}

    def run(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        k, pop = k_run, pop0
        for _ in range(n):
            k, pop = bench_nsga2_generation(tb, k, pop, select=select)
        torch.cuda.synchronize()
        state[n] = pop
        return time.perf_counter() - t

    run(1)                                     # warm the allocator
    per_gen, marginals, pairs, launches = _counted_pairs(kernels, run, ngen,
                                                         pairs_n)
    pop = state[2 * ngen]
    q1 = mo_quality(problem, pop.fitness)
    ok = (tuple(pop.genome.shape) == (BN_POP, ndim)
          and bool(torch.isfinite(pop.fitness.values).all())
          and bool(pop.fitness.valid.all())
          and bool(((pop.genome >= 0) & (pop.genome <= 1)).all()))
    metric = "front_error" if problem == "dtlz2" else "hypervolume_11_11"
    phase(f"main path: bench_nsga2 {name} {problem}", card_line, pop=BN_POP,
          dim=ndim, nobj=nobj, chunk=bench_chunk(BN_POP),
          divisions=BN_P[nobj] if name == "nsga3" else None,
          ngen=[ngen, 2 * ngen], seconds=[list(p) for p in pairs],
          marginal_ms_per_gen=per_gen * 1e3,
          marginal_ms_range=[marginals[0] * 1e3, marginals[-1] * 1e3],
          linearity=[b / a for a, b in pairs], launches=launches,
          launches_per_gen={k: v / (2 * ngen) for k, v in launches.items()},
          **{f"{metric}_start": q0, f"{metric}_end": q1},
          finite_valid_in_bounds=ok)
    if not ok:
        fail(f"bench_nsga2 {name} {problem}: the population is not finite, "
             "valid, in bounds and shaped")
    better = q1 < q0 if problem == "dtlz2" else q1 > q0
    if not better:
        fail(f"bench_nsga2 {name} {problem}: {metric} {q0} -> {q1}")
    uses_k4 = name.startswith("spea2") or nobj >= 3
    if uses_k4 and launches["rows_dominate_counts"] < 1:
        fail(f"K4 never ran on bench_nsga2 {name} {problem}")
    return launches, per_gen * 1e3, pop


def cpu_spea2_trunc(values, valid, weights) -> tuple:
    """The CPU side of :func:`spea2_checks_phase`'s truncation case."""
    from deap_tpu_torch import base
    from deap_tpu_torch.ops import emo
    t = time.perf_counter()
    b = emo.sel_spea2(None, base.Fitness(values, valid, weights), TRUNC_K,
                      chunk=500)
    return b, time.perf_counter() - t


def spea2_checks_phase(card_line, key) -> dict:
    """SPEA2 beyond the generation: the single program against the two
    stage calls on the card (POP 4096 pool, both problems), and the
    truncation branch card against CPU: 2048 DTLZ2 points on the true
    front (distance genes 0.5), k = 1024."""
    import torch
    from deap_tpu_torch import base, random
    from deap_tpu_torch.ops import emo
    dev = torch.device("cuda")
    k_pool, k_trunc = random.split(key)
    g = random.uniform(k_trunc, (TRUNC_N, 12))
    g[:, 2:] = 0.5
    fit = base.Fitness.empty(TRUNC_N, (-1.0,) * 3, device=dev).with_values(
        dtlz2_values(g))
    cpu_side = CpuSide("cpu_spea2_trunc", values=fit.values.cpu(),
                       valid=fit.valid.cpu(), weights=fit.weights)
    staged_same = {}
    for problem in BN_PROBLEMS:
        nobj, ndim = BN_PROBLEMS[problem]
        tb = bench_nsga2_toolbox(problem)
        pool = bench_nsga2_initial(tb, random.fold_in(k_pool, nobj), problem,
                                   2 * MO_REF_POP)
        chunk = bench_chunk(MO_REF_POP)
        a = emo.sel_spea2(None, pool.fitness, MO_REF_POP, chunk=chunk)
        b = emo.sel_spea2_staged(None, pool.fitness, MO_REF_POP, chunk=chunk)
        staged_same[problem] = torch.equal(a, b)
    n_nondom = int((emo.nondominated_ranks(fit.masked_wvalues())[0] == 0)
                   .sum().item())
    torch.cuda.synchronize()
    t = time.perf_counter()
    a = emo.sel_spea2(None, fit, TRUNC_K, chunk=500)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    b, cpu_s = cpu_side.result()
    trunc_same = torch.equal(a.cpu(), b)
    phase("SPEA2: staged = single on the card; truncation card vs CPU",
          card_line, staged_equals_single=staged_same, pool=2 * MO_REF_POP,
          trunc_points=TRUNC_N, trunc_k=TRUNC_K, nondominated=n_nondom,
          trunc_bitwise=trunc_same, trunc_card_seconds=card_s,
          trunc_cpu_seconds=cpu_s)
    if not all(staged_same.values()):
        fail(f"SPEA2: the staged calls differ from sel_spea2: {staged_same}")
    if n_nondom <= TRUNC_K:
        fail(f"SPEA2 truncation case: only {n_nondom} nondominated points")
    if not trunc_same:
        fail("SPEA2 truncation: card and CPU differ")
    return {"truncation_card_seconds": card_s}


# nsga2.py at tests/test_examples.py's depth (its check needs it); nsga3.py,
# whose front error is only reported, cut
MO_EXAMPLE_ARGS = {"nsga2": {"ngen": 100}, "nsga3": {"ngen": 20}}


def cpu_mo_examples() -> dict:
    """The CPU side of :func:`examples_phase`: each example's final
    population and seconds."""
    import torch
    from deap_tpu_torch.examples.ga import nsga2, nsga3
    out = {}
    for name, mod in (("nsga2", nsga2), ("nsga3", nsga3)):
        t = time.perf_counter()
        pc, qc = mod.main(seed=1, verbose=False, device=torch.device("cpu"),
                          **MO_EXAMPLE_ARGS[name])
        out[name] = (pc.genome, pc.fitness.values, qc,
                     time.perf_counter() - t)
    return out


def examples_phase(kernels, card_line) -> dict:
    """``examples/ga/nsga2.py`` (ZDT1, mu 64, 100 generations) and
    ``examples/ga/nsga3.py`` (DTLZ2, 92, 20 of its 100) at
    ``MO_EXAMPLE_ARGS`` on the card and on the CPU (beside the card,
    :class:`CpuSide`): populations bitwise, the NSGA-II hypervolume at
    (11, 11) > 116, NSGA-III's front error reported."""
    import torch
    from deap_tpu_torch.examples.ga import nsga2, nsga3
    dev = torch.device("cuda")
    cpu_side = CpuSide("cpu_mo_examples")
    out, launches, cards = {}, {}, {}
    for name, mod in (("nsga2", nsga2), ("nsga3", nsga3)):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        cards[name] = mod.main(seed=1, verbose=False, device=dev,
                               **MO_EXAMPLE_ARGS[name])
        torch.cuda.synchronize()
        cards[name] += (time.perf_counter() - t,)
        launches[name] = dict(kernels.LAUNCHES)
    host = cpu_side.result()
    for name in ("nsga2", "nsga3"):
        pg, qg, card_s = cards[name]
        pc_genome, pc_values, qc, cpu_s = host[name]
        same = (torch.equal(pg.genome.cpu().view(torch.int32),
                            pc_genome.view(torch.int32))
                and torch.equal(pg.fitness.values.cpu().view(torch.int32),
                                pc_values.view(torch.int32)))
        out[name] = dict(bitwise=same, card_seconds=card_s,
                         cpu_seconds=cpu_s, card=qg, cpu=qc,
                         launches=launches[name])
    phase("examples: nsga2.py and nsga3.py at cut depths", card_line,
          nsga2_hypervolume=out["nsga2"]["card"],
          nsga3_front_error=out["nsga3"]["card"], runs=out)
    for name, r in out.items():
        if not r["bitwise"]:
            fail(f"examples/ga/{name}.py: card and CPU populations differ")
    if not out["nsga2"]["card"] > 116.0:
        fail(f"examples/ga/nsga2.py: hypervolume {out['nsga2']['card']} "
             "<= 116")
    return launches


# ---------------------------------------------------------------------------
# the rest of GP: the remaining tree operators, static_limit, HARM-GP, the
# lexicase and double-tournament selections, and the eight GP examples
# (ADFs, routines) — K6 evaluates every bench-width generation
# ---------------------------------------------------------------------------

# the operators of phase 34, in order: (name, mutation or crossover, the
# pset it needs)
GP_NEW_OPS = (("mut_node_replacement", "bench"), ("mut_ephemeral one",
                                                  "bench"),
              ("mut_ephemeral all", "bench"), ("mut_insert", "bench"),
              ("mut_shrink", "bench"), ("mut_semantic", "semantic"),
              ("cx_semantic", "semantic"),
              ("static_limit(cx_one_point)", "bench"),
              ("static_limit(mut_uniform)", "bench"))
GP_OPS_WARM_GENS = 3               # bench generations before the operators
# symbreg_harm.py's HARM parameters
HARM_KW = dict(alpha=0.05, beta=10.0, gamma=0.25, rho=0.9, mincutoff=10)
HARM_REF_POP, HARM_REF_GENS = 512, 2
HARM_NGEN, HARM_PAIRS = 2, 1
# the bench generation with each new mutation and with static_limit
GP_VARIANT_NGEN, GP_VARIANT_PAIRS = 2, 1
LEX_REF_N, LEX_REF_CASES = 512, 128
LEX_EPS = 0.1
LEX_REPS = 3
# the examples: default generations on the card; on the CPU at the
# defaults where that takes seconds, else at tests/test_examples.py's depth
GP_EXAMPLES = ("symbreg", "symbreg_epsilon_lexicase", "symbreg_harm",
               "adf_symbreg", "multiplexer", "parity", "spambase", "ant")
# tests/test_examples.py's depths, on the card and the CPU alike, but the
# two symbreg examples that no check reads, cut further
GP_EXAMPLE_DEPTH = {"symbreg": 10, "symbreg_epsilon_lexicase": 5,
                    "symbreg_harm": 3, "adf_symbreg": 5, "multiplexer": 25,
                    "parity": 10, "spambase": 8, "ant": 3}
GP_EXAMPLE_CHECKS = {"multiplexer": 56, "parity": 8, "spambase": 0.6,
                     "ant": 20}


def _same_tensors(a, b) -> bool:
    """Two outputs (tensors, Python numbers, nested tuples, lists or
    dicts) bit for bit."""
    import torch
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tensors(a[k], b[k])
                                            for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same_tensors(x, y)
                                        for x, y in zip(a, b))
    if not torch.is_tensor(a):
        return a == b
    return _same_bits(a, b)


def gp_operator(name, ps, gen_mut):
    """``(op(keys, *trees), arity)`` for a phase-34 operator name."""
    from deap_tpu_torch import gp
    from deap_tpu_torch.probes.gp import HEIGHT_LIMIT
    frozen = ps.freeze()

    def height(t):
        return gp.tree_height(t[0], t[2], frozen.tables(t[0].device)["arity"])
    expr = lambda kk: gen_mut(kk, 0, 2)                     # noqa: E731
    ops = {
        "mut_node_replacement": (lambda k, t: gp.mut_node_replacement(
            k, t, ps), 1),
        "mut_ephemeral one": (lambda k, t: gp.mut_ephemeral(
            k, t, ps, mode="one"), 1),
        "mut_ephemeral all": (lambda k, t: gp.mut_ephemeral(
            k, t, ps, mode="all"), 1),
        "mut_insert": (lambda k, t: gp.mut_insert(k, t, ps), 1),
        "mut_shrink": (lambda k, t: gp.mut_shrink(k, t, ps), 1),
        "mut_semantic": (lambda k, t: gp.mut_semantic(k, t, ps), 1),
        "cx_semantic": (lambda k, a, b: gp.cx_semantic(k, a, b, ps), 2),
        "static_limit(cx_one_point)": (lambda k, a, b: gp.static_limit(
            height, HEIGHT_LIMIT)(gp.cx_one_point)(k, a, b, ps), 2),
        "static_limit(mut_uniform)": (lambda k, t: gp.static_limit(
            height, HEIGHT_LIMIT)(gp.mut_uniform)(k, t, expr, ps), 1)}
    return ops[name]


def gp_operators_phase(kernels, card_line, key, dev) -> dict:
    """Phase 34: each new operator and ``static_limit`` (height <= 17)
    on a POP 4096 x CAP 64 population a few bench generations old (the
    semantic ones on the bench set with ``lf``): the card's children
    against the CPU's from the same keys, bitwise; then K6 on the
    children against the plain interpreter, bitwise (``k6_check``)."""
    import torch
    from deap_tpu_torch import random
    cpu = torch.device("cpu")
    out, k6 = {}, {}
    pops = {}
    for kind in ("bench", "semantic"):
        ps, tb, _, gen_init, X = gp_toolbox(dev, kind)
        k_init, k_run = random.split(random.fold_in(key, len(pops)))
        pop = gp_initial(tb, gen_init, k_init, GP_POP)
        for _ in range(GP_OPS_WARM_GENS):
            k_run, pop, _ = gp_generation(tb, k_run, pop)
        pops[kind] = (ps, pop.genome, X)
    for i, (name, kind) in enumerate(GP_NEW_OPS):
        ps, genome, X = pops[kind]
        from deap_tpu_torch import gp
        gen_mut = gp.make_generator(ps, GP_CAP, "full")
        op, arity = gp_operator(name, ps, gen_mut)
        k_op = random.fold_in(key, 100 + i)
        n = GP_POP // arity
        keys = random.split(k_op, n)
        if arity == 1:
            args = (genome,)
        else:
            args = (tuple(g[:n] for g in genome),
                    tuple(g[n:2 * n] for g in genome))
        torch.cuda.synchronize()
        t = time.perf_counter()
        card = op(keys, *args)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        host = op(keys.to(cpu), *(tuple(g.to(cpu) for g in a) for a in args))
        cpu_s = time.perf_counter() - t
        same = _same_tensors(card, host)
        kids = card if arity == 1 else tuple(torch.cat([a, b])
                                             for a, b in zip(*card))
        parents = genome if arity == 1 else tuple(
            torch.cat([a, b]) for a, b in zip(*args))
        changed = ((kids[2] != parents[2]) | (kids[0] != parents[0]).any(1)
                   | (kids[1] != parents[1]).any(1))
        full = kids[2] == GP_CAP
        lf = ps.freeze().names.index("lf") if kind == "semantic" else -1
        out[name] = dict(card_cpu_bitwise=same, card_s=card_s, cpu_s=cpu_s,
                         rows_changed=int(changed.sum()),
                         rows_at_capacity=int(full.sum()),
                         mean_length=float(kids[2].float().mean()),
                         rows_with_lf=int((kids[0] == lf).any(1).sum())
                         if lf >= 0 else None)
        if not same:
            fail(f"{name} on the card differs from the CPU at {GP_POP} x "
                 f"{GP_CAP}")
        k6[name] = k6_check(kernels, card_line, f"children of {name}",
                            ps.freeze(), kids, X)
    phase("GP operators card vs CPU at bench width, K6 on the children",
          card_line, pop=GP_POP, cap=GP_CAP, warm_generations=GP_OPS_WARM_GENS,
          operators=out)
    return k6


def harm_reference_chain(key):
    """The CPU's side of phase 35: the initial POP 512 population from
    ``key``, then ``HARM_REF_GENS`` generations each from the one before."""
    import torch
    from deap_tpu_torch import gp, random
    _, tb, _, gen, _ = gp_toolbox(torch.device("cpu"))
    chain = [gp_initial(tb, gen, key, HARM_REF_POP)]
    k = random.fold_in(key, 1)
    for _ in range(HARM_REF_GENS):
        chain.append(gp.harm(k, chain[-1], tb, GP_CXPB, GP_MUTPB, 1,
                             **HARM_KW)[0])
        k = random.split(k, 4)[0]
    return chain


def harm_phase(kernels, card_line, key, dev) -> tuple:
    """Phase 35: HARM-GP.  Two generations at POP 512 (2000 natural
    children) on the bench toolbox, each from the CPU's population and
    key before it, card against CPU: trees bitwise, fitness within
    ``GP_FITNESS_RTOL`` (the MSE's mean reduces in another order on the
    card).  Then POP 4096 with symbreg_harm.py's parameters: N and 2N
    generations in pairs (median marginal ms), K6 counted, the mean size
    and best MSE."""
    import torch
    from deap_tpu_torch import base, gp, random
    k_ref, k_init, k_run = random.split(key, 3)
    _, tb_d, ev_d, _, _ = gp_toolbox(dev)
    t = time.perf_counter()
    chain = harm_reference_chain(k_ref.cpu())
    cpu_s = time.perf_counter() - t
    k = random.fold_in(k_ref, 1)
    ref = []
    for pop_h, pop_h1 in zip(chain, chain[1:]):
        pop_d = base.Population(tuple(g.to(dev) for g in pop_h.genome),
                                base.Fitness(pop_h.fitness.values.to(dev),
                                             pop_h.fitness.valid.to(dev),
                                             (-1.0,)))
        out_d, _ = gp.harm(k, pop_d, tb_d, GP_CXPB, GP_MUTPB, 1, **HARM_KW)
        trees = _same_tensors(out_d.genome, pop_h1.genome)
        v1, fd = pop_h1.fitness.values, out_d.fitness.values.cpu()
        rel = float(((v1 - fd).abs() / v1.abs().clamp(min=1e-30)).max())
        ref.append(dict(trees_bitwise=trees, fitness_max_rel_err=rel))
        if not (trees and rel <= GP_FITNESS_RTOL):
            fail(f"HARM generation on the card differs from the CPU: trees "
                 f"{trees}, fitness rel err {rel}")
        k = random.split(k, 4)[0]
    # full width
    ps, tb, pop_ev, gen_init, X = gp_toolbox(dev)
    pop0 = gp_initial(tb, gen_init, k_init, GP_POP)
    state = {}

    def run(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pop, log = gp.harm(k_run, pop0, tb, GP_CXPB, GP_MUTPB, n, **HARM_KW)
        torch.cuda.synchronize()
        state[n] = pop
        return time.perf_counter() - t

    run(1)
    per_gen, marginals, pairs, launches = _counted_pairs(
        kernels, run, HARM_NGEN, HARM_PAIRS)
    pop = state[2 * HARM_NGEN]
    size0 = float(pop0.genome[2].float().mean())
    size1 = float(pop.genome[2].float().mean())
    best0 = float(pop0.fitness.values.min())
    best1 = float(pop.fitness.values.min())
    ok = bool(pop.fitness.valid.all()) and bool(
        torch.isfinite(pop.fitness.values).all())
    phase("HARM-GP at bench width (symbreg_harm.py's parameters)", card_line,
          reference=dict(pop=HARM_REF_POP, natural=max(2000, HARM_REF_POP),
                         generations=ref, fitness_rtol=GP_FITNESS_RTOL,
                         cpu_chain_s=cpu_s),
          pop=GP_POP, cap=GP_CAP, points=GP_NPOINTS,
          natural=max(2000, GP_POP), ngen=[HARM_NGEN, 2 * HARM_NGEN],
          seconds=[list(p) for p in pairs],
          marginal_ms_per_gen=per_gen * 1e3,
          marginal_ms_range=[marginals[0] * 1e3, marginals[-1] * 1e3],
          launches=launches, mean_size_start=size0, mean_size_end=size1,
          best_mse_start=best0, best_mse_end=best1, valid_finite=ok,
          evaluator_backend=pop_ev.last_backend)
    if launches["gp_interp"] != 2 * HARM_NGEN + 1:
        fail(f"K6 ran {launches['gp_interp']} times in {2 * HARM_NGEN} HARM "
             f"generations (expected {2 * HARM_NGEN + 1})")
    if not ok:
        fail("HARM left an invalid or non-finite population")
    return launches, pop, tb


def profile_harm(key, pop, tb, card_line) -> None:
    """``--profile`` for HARM: each stage of a generation alone."""
    import torch
    from deap_tpu_torch import gp, random
    from deap_tpu_torch.algorithms import evaluate_population, var_or
    from deap_tpu_torch.gp.harm import _KDE, acceptance, size_histogram
    n, m = pop.size, max(2000, pop.size)
    k_sel, k_nat, k_acc = random.split(key, 4)[1:]
    idx = tb.select(k_sel, pop.fitness, m)
    parents = pop.take(idx)
    natural = var_or(k_nat, parents, tb, m, GP_CXPB, GP_MUTPB)

    def accept():
        return acceptance(k_acc, natural.genome[2],
                          natural.fitness.masked_wvalues(), n,
                          HARM_KW["alpha"], HARM_KW["beta"],
                          HARM_KW["gamma"], HARM_KW["rho"],
                          HARM_KW["mincutoff"], GP_CAP + 3)[0]
    chosen = accept()
    nbins = GP_CAP + 3
    sizes = natural.genome[2].to(torch.int64)

    def hist_on_card():
        # the same hits by index_add_ on the card: its float32 adds run in
        # no fixed order, so its last bits are not XLA's (timed, not used)
        hist = torch.zeros(nbins, device=sizes.device)
        for off, w in _KDE:
            b = sizes + off
            ok = (b >= 0) & (b < nbins)
            hist.index_add_(0, torch.where(ok, b, nbins - 1),
                            torch.where(ok, w, 0.0))
        return hist
    stages = {
        "select m parents (sel_tournament)": lambda: tb.select(
            k_sel, pop.fitness, m),
        "var_or m natural children": lambda: var_or(
            k_nat, parents, tb, m, GP_CXPB, GP_MUTPB),
        "acceptance (histogram on the host, cutoff, target)": accept,
        "size histogram on the host (read + numpy.add.at)":
            lambda: size_histogram(sizes, nbins),
        "size histogram by index_add_ on the card (unordered)": hist_on_card,
        "evaluate n offspring (K6)": lambda: evaluate_population(
            tb, natural.take(chosen)),
        "whole generation": lambda: gp.harm(key, pop, tb, GP_CXPB,
                                            GP_MUTPB, 1, **HARM_KW)}
    phase("profile: HARM stage wall ms (synchronized, alone)", card_line,
          stages={k: _wall_ms(f, reps=3) for k, f in stages.items()})


def gp_variants_phase(kernels, card_line, key, dev) -> dict:
    """Phase 36: bench_gp.py's generation with each new mutation in place
    of ``mut_uniform`` (``mut_semantic`` on the set with ``lf``) and with
    ``static_limit`` on both operators: N and 2N generations in pairs,
    K6 once a generation."""
    import torch
    from deap_tpu_torch import random
    from deap_tpu_torch.probes.gp import HEIGHT_LIMIT, MUTATIONS
    variants = [(m, dict(mutate=m)) for m in MUTATIONS[1:]]
    variants.append(("static_limit both", dict(limit=HEIGHT_LIMIT)))
    out, launches_all = {}, {}
    for i, (name, kw) in enumerate(variants):
        kind = "semantic" if name == "semantic" else "bench"
        ps, tb, pop_ev, gen_init, X = gp_toolbox(dev, kind, **kw)
        k_init, k_run = random.split(random.fold_in(key, i))
        pop0 = gp_initial(tb, gen_init, k_init, GP_POP)
        state = {}

        def run(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            k, pop = k_run, pop0
            for _ in range(n):
                k, pop, _ = gp_generation(tb, k, pop)
            torch.cuda.synchronize()
            state[n] = pop
            return time.perf_counter() - t

        run(1)
        per_gen, marginals, pairs, launches = _counted_pairs(
            kernels, run, GP_VARIANT_NGEN, GP_VARIANT_PAIRS)
        pop = state[2 * GP_VARIANT_NGEN]
        out[name] = dict(marginal_ms_per_gen=per_gen * 1e3,
                         marginal_ms_range=[marginals[0] * 1e3,
                                            marginals[-1] * 1e3],
                         launches=launches,
                         mean_length_start=float(pop0.genome[2].float()
                                                 .mean()),
                         mean_length_end=float(pop.genome[2].float().mean()),
                         best_mse_start=float(pop0.fitness.values.min()),
                         best_mse_end=float(pop.fitness.values.min()))
        launches_all[name] = launches["gp_interp"]
        if launches["gp_interp"] != 2 * GP_VARIANT_NGEN:
            fail(f"K6 ran {launches['gp_interp']} times in "
                 f"{2 * GP_VARIANT_NGEN} bench generations with {name}")
        if not bool(torch.isfinite(pop.fitness.values).all()):
            fail(f"bench generation with {name}: non-finite fitness")
    phase("GP bench generation with each new mutation and static_limit",
          card_line, pop=GP_POP, cap=GP_CAP, points=GP_NPOINTS,
          ngen=[GP_VARIANT_NGEN, 2 * GP_VARIANT_NGEN],
          pairs=GP_VARIANT_PAIRS, height_limit=HEIGHT_LIMIT, variants=out)
    return launches_all


def lexicase_phase(kernels, card_line, key, dev) -> tuple:
    """Phase 37: the lexicase forms and ``sel_double_tournament`` card
    against CPU on 512 trees' absolute errors at 128 points (bitwise
    indices); then ``sel_automatic_epsilon_lexicase`` alone on the card
    over the bench population's 4096 x 1024 case errors, and bench
    generations that select with it (K6 counted)."""
    import torch
    from deap_tpu_torch import random
    from deap_tpu_torch.ops import selection as S
    cpu = torch.device("cpu")
    k_ref, k_sel, k_init, k_run = random.split(key, 4)
    k_ref = k_ref.cpu()
    from deap_tpu_torch.probes.gp import bench_toolbox
    _, tb_r, _, gen_r, _ = bench_toolbox(cpu, "bench", False, GP_CAP,
                                         LEX_REF_CASES, select="lexicase")
    pop_r = gp_initial(tb_r, gen_r, k_ref, LEX_REF_N, LEX_REF_CASES)
    cases = pop_r.fitness.masked_wvalues()
    sizes = pop_r.genome[2]
    mse = pop_r.fitness.values.mean(dim=1, keepdim=True)
    forms = {
        "sel_lexicase": lambda k, c, d: S.sel_lexicase(k, c, LEX_REF_N),
        "sel_epsilon_lexicase": lambda k, c, d: S.sel_epsilon_lexicase(
            k, c, LEX_REF_N, LEX_EPS),
        "sel_automatic_epsilon_lexicase":
            lambda k, c, d: S.sel_automatic_epsilon_lexicase(k, c, LEX_REF_N),
        "sel_double_tournament fitness_first":
            lambda k, c, d: S.sel_double_tournament(
                k, -mse.to(d), sizes.to(d), LEX_REF_N, 3, 1.4, True),
        "sel_double_tournament size_first":
            lambda k, c, d: S.sel_double_tournament(
                k, -mse.to(d), sizes.to(d), LEX_REF_N, 3, 1.4, False)}
    ref = {}
    for name, f in forms.items():
        a = f(k_sel, cases.to(dev), dev)
        b = f(k_sel.cpu(), cases, cpu)
        ref[name] = dict(bitwise=bool(torch.equal(a.cpu(), b)),
                         distinct=int(torch.unique(b).numel()))
        if not ref[name]["bitwise"]:
            fail(f"{name} on the card differs from the CPU")
    # full width: 4096 x 1024 case errors of a bench population
    ps, tb, pop_ev, gen_init, X = gp_toolbox(dev, "bench",
                                                  select="lexicase")
    pop0 = gp_initial(tb, gen_init, k_init, GP_POP, GP_NPOINTS)
    cases = pop0.fitness.masked_wvalues()
    secs = []
    for _ in range(LEX_REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        idx = S.sel_automatic_epsilon_lexicase(k_sel, cases, GP_POP)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    secs.sort()
    state = {}

    def run(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        k, pop = k_run, pop0
        for _ in range(n):
            k, pop, _ = gp_generation(tb, k, pop)
        torch.cuda.synchronize()
        state[n] = pop
        return time.perf_counter() - t

    kernels.reset_launches()
    t1 = run(1)
    launches = dict(kernels.LAUNCHES)
    t2 = run(2)
    pop = state[2]
    phase("lexicase and double tournament: card vs CPU, full width",
          card_line, reference=dict(rows=LEX_REF_N, cases=LEX_REF_CASES,
                                    epsilon=LEX_EPS, forms=ref),
          pop=GP_POP, cases=GP_NPOINTS,
          automatic_epsilon_lexicase_s=secs[len(secs) // 2],
          automatic_epsilon_lexicase_s_all=secs,
          distinct_selected=int(torch.unique(idx).numel()),
          generation_s=[t1, t2], marginal_ms_per_gen=(t2 - t1) * 1e3,
          launches=launches,
          mean_abs_err_start=float(pop0.fitness.values.mean()),
          mean_abs_err_end=float(pop.fitness.values.mean()))
    if launches["gp_interp"] != 1:
        fail(f"K6 ran {launches['gp_interp']} times in one lexicase bench "
             "generation")
    return launches, cases, k_sel


def profile_lexicase(key, cases, card_line) -> None:
    """``--profile`` for lexicase: one case step's stages at full width
    (the gather of the case column, the best, the MAD epsilon's two
    medians, the mask update) and the whole selection under
    ``torch.profiler``."""
    import torch
    from deap_tpu_torch import random
    from deap_tpu_torch.ops import selection as S
    k, n = cases.shape[0], cases.shape[0]
    order = random.permutation(random.split(key, k), cases.shape[1]).long()
    by_case = cases.t().contiguous()
    mask = torch.rand(k, n, device=cases.device) < 0.5
    col = by_case[order[:, 0]]
    stages = {
        "permutation of the cases (k keys)": lambda: random.permutation(
            random.split(key, k), cases.shape[1]),
        "case column gather (k, n)": lambda: by_case[order[:, 0]],
        "best of the candidates": lambda: torch.where(
            mask, col, float("-inf")).amax(dim=1),
        "MAD epsilon (two nanmedians)": lambda: S._mad_eps(col, mask),
        "whole selection": lambda: S.sel_automatic_epsilon_lexicase(
            key, cases, k)}
    phase("profile: lexicase stage wall ms (synchronized, alone)", card_line,
          stages={name: _wall_ms(f, reps=3) for name, f in stages.items()})
    phase("profile: automatic epsilon-lexicase, one selection", card_line,
          **_profile_window(lambda: S.sel_automatic_epsilon_lexicase(
              key, cases, k), 1))


def gp_example_run(mod, dev, ngen=None):
    """``(population, quality)`` of one example's run on ``dev``: the
    final population and the best value the example reports (for the
    four that report one, from their ``run``)."""
    kw = {} if ngen is None else {"ngen": ngen}
    if hasattr(mod, "run"):
        return mod.run(device=dev, **kw)
    pop = mod.main(verbose=False, device=dev, **kw)
    v = pop.fitness.values
    return pop, float(v.sum(dim=1).min() if v.shape[1] > 1 else v.min())


def cpu_gp_examples() -> dict:
    """The CPU side of :func:`gp_examples_phase`: each example's final
    trees and fitness at ``GP_EXAMPLE_DEPTH`` and seconds."""
    import importlib
    import torch
    out = {}
    for name in GP_EXAMPLES:
        mod = importlib.import_module(f"deap_tpu_torch.examples.gp.{name}")
        t = time.perf_counter()
        host = gp_example_run(mod, torch.device("cpu"),
                              GP_EXAMPLE_DEPTH[name])[0]
        out[name] = (host.genome, host.fitness.values, host.size,
                     time.perf_counter() - t)
    return out


def gp_examples_phase(kernels, card_line) -> dict:
    """Phase 38: the eight GP examples at ``GP_EXAMPLE_DEPTH`` (that of
    tests/test_examples.py where a check reads the result) on the card,
    each against that file's check, and card = CPU bitwise on the final
    population, trees and every individual's fitness.  The CPU runs
    beside the card's (:class:`CpuSide`)."""
    import importlib
    import torch
    dev = torch.device("cuda")
    cpu_side = CpuSide("cpu_gp_examples")
    out, launches, cards = {}, {}, {}
    for name in GP_EXAMPLES:
        mod = importlib.import_module(f"deap_tpu_torch.examples.gp.{name}")
        kernels.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        card, quality = gp_example_run(mod, dev, GP_EXAMPLE_DEPTH[name])
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        launches[name] = dict(kernels.LAUNCHES)
        cards[name] = (mod, card, quality, card_s)
    host = cpu_side.result()
    for name in GP_EXAMPLES:
        mod, card, quality, card_s = cards[name]
        h_genome, h_values, h_size, cpu_s = host[name]
        same = (_same_tensors(card.genome, h_genome)
                and _same_tensors(card.fitness.values, h_values))
        ok = bool(card.fitness.valid.all()) and bool(
            torch.isfinite(card.fitness.values).all())
        if name in GP_EXAMPLE_CHECKS:
            ok = ok and quality >= GP_EXAMPLE_CHECKS[name]
        extra = {}
        if name == "symbreg_harm":
            size = float(card.genome[2].float().mean())
            extra = {"mean_size": size}
            ok = ok and size < mod.CAP * 0.8
        out[name] = dict(card_cpu_bitwise=same,
                         generations=GP_EXAMPLE_DEPTH[name],
                         rows_compared=h_size,
                         card_seconds=card_s, cpu_seconds=cpu_s,
                         quality=quality, check=ok, **extra)
        if not same:
            fail(f"examples/gp/{name}.py: card and CPU differ")
        if not ok:
            fail(f"examples/gp/{name}.py: {quality} fails its check")
    phase("GP examples at cut depths", card_line, runs=out,
          cpu_threads=torch.get_num_threads())
    return launches


def gp_rest_phases(kernels, card_line, key, dev) -> dict:
    """Phases 34-38; returns K6's launches and times on their paths."""
    import torch
    from deap_tpu_torch import random
    torch.cuda.empty_cache()
    k_ops, k_harm, k_var, k_lex = random.split(random.fold_in(key, 8), 4)
    out = {"k6_children": gp_operators_phase(kernels, card_line, k_ops, dev)}
    launches_harm, harm_pop, harm_tb = harm_phase(kernels, card_line,
                                                  k_harm, dev)
    if "--profile" in sys.argv[1:]:
        profile_harm(k_harm, harm_pop, harm_tb, card_line)
    del harm_pop
    out["harm"] = launches_harm["gp_interp"]
    out["variants"] = gp_variants_phase(kernels, card_line, k_var, dev)
    launches_lex, lex_cases, k_lsel = lexicase_phase(kernels, card_line,
                                                     k_lex, dev)
    if "--profile" in sys.argv[1:]:
        profile_lexicase(k_lsel, lex_cases, card_line)
    del lex_cases
    out["lexicase"] = launches_lex["gp_interp"]
    out["examples"] = gp_examples_phase(kernels, card_line)
    return out



# ---- 39.-42. the rest of the operators and benchmarks ----------------------

OPS_ROWS = 4096
SEL_N = 100_000
# every function of deap_tpu_torch.benchmarks that takes one individual,
# with its keywords and its 4096-row input's width and range
BENCH_FUNCS = (
    ("plane", {}, 100, -5.0, 5.0), ("cigar", {}, 100, -5.0, 5.0),
    ("rosenbrock", {}, 100, -5.0, 5.0), ("h1", {}, 2, -5.0, 10.0),
    ("ackley", {}, 100, -5.0, 5.0), ("bohachevsky", {}, 100, -5.0, 5.0),
    ("griewank", {}, 100, -5.0, 5.0), ("rastrigin_scaled", {}, 100, -5.0,
                                       5.0),
    ("rastrigin_skew", {}, 100, -5.0, 5.0), ("schaffer", {}, 100, -5.0, 5.0),
    ("schwefel", {}, 100, -500.0, 500.0), ("himmelblau", {}, 2, -5.0, 5.0),
    ("kursawe", {}, 3, -5.0, 5.0), ("schaffer_mo", {}, 1, -5.0, 5.0),
    ("zdt1", {}, 30, 0.0, 1.0), ("zdt2", {}, 30, 0.0, 1.0),
    ("zdt3", {}, 30, 0.0, 1.0), ("zdt4", {}, 10, 0.0, 1.0),
    ("zdt6", {}, 10, 0.0, 1.0), ("dtlz1", {"obj": 3}, 7, 0.0, 1.0),
    ("dtlz2", {"obj": 3}, 12, 0.0, 1.0), ("dtlz3", {"obj": 3}, 12, 0.0, 1.0),
    ("dtlz4", {"obj": 3, "alpha": 100.0}, 12, 0.0, 1.0),
    ("dtlz5", {"n_objs": 3}, 12, 0.0, 1.0),
    ("dtlz6", {"n_objs": 3}, 12, 0.0, 1.0),
    ("dtlz7", {"n_objs": 3}, 22, 0.0, 1.0), ("fonseca", {}, 3, -4.0, 4.0),
    ("poloni", {}, 2, -3.14, 3.14), ("dent", {}, 2, -1.5, 1.5))
BINARY_FUNCS = (("trap", {}, 5), ("inv_trap", {}, 5), ("chuang_f1", {}, 41),
                ("chuang_f2", {}, 42), ("chuang_f3", {}, 41),
                ("royal_road1", {"order": 8}, 64),
                ("royal_road2", {"order": 4}, 64))
PEAKS_CHANGES = 20
ROTATE_RTOL = 1e-5     # the inverse: cuSOLVER on the card, LAPACK on the CPU
# phase 40: bench.py's two bodies at the flagship's width, rbg keys
FLAG_FUNCS = ("plane", "cigar", "rosenbrock", "griewank", "rastrigin_scaled",
              "rastrigin_skew", "schaffer", "schwefel", "bohachevsky")
FLAG_MATES = (("cx_one_point", {}), ("cx_uniform", {"indpb": 0.1}),
              ("cx_simulated_binary", {"eta": 20.0}))
FLAG_NGEN = 1
FLAG_REF_POP = 2048
FLAG_STRIDE = 1000     # card = CPU on every 1000th row's evaluation
FLAG_RTOL = 1e-5       # rastrigin (the xla body's) sums in each device's order
# phase 41: the ZDT and DTLZ suites at bench_nsga2.py's width (published
# variable counts; ZDT4's x1 in [0, 1], the rest in [-5, 5])
SUITE_POP, SUITE_NGEN, SUITE_REF_POP = 100_000, 1, 1024
ZDT4_LOW, ZDT4_UP = [0.0] + [-5.0] * 9, [1.0] + [5.0] * 9
SUITE = {
    "zdt2": ({}, 2, 30, 0.0, 1.0), "zdt3": ({}, 2, 30, 0.0, 1.0),
    "zdt4": ({}, 2, 10, ZDT4_LOW, ZDT4_UP), "zdt6": ({}, 2, 10, 0.0, 1.0),
    "dtlz1": ({"obj": 3}, 3, 7, 0.0, 1.0),
    "dtlz3": ({"obj": 3}, 3, 12, 0.0, 1.0),
    "dtlz4": ({"obj": 3, "alpha": 100.0}, 3, 12, 0.0, 1.0),
    "dtlz5": ({"n_objs": 3}, 3, 12, 0.0, 1.0),
    "dtlz6": ({"n_objs": 3}, 3, 12, 0.0, 1.0),
    "dtlz7": ({"n_objs": 3}, 3, 22, 0.0, 1.0)}
# each problem's reference point: the componentwise maximum of its
# initial population's objectives (suite_initial, this script's keys)
# plus 10%, fixed once
HV_REF.update({
    "zdt2": (1.09999, 8.21289), "zdt3": (1.09997, 7.62431),
    "zdt4": (1.09999, 317.453), "zdt6": (1.1, 10.5751),
    "dtlz1": (508.138, 491.99, 543.367),
    "dtlz3": (2055.15, 1954.37, 2054.25),
    "dtlz4": (3.12809, 2.74437, 2.7294),
    "dtlz5": (0.548323, 2.70296, 3.14839),
    "dtlz6": (4.67293, 11.6464, 11.7705),
    "dtlz7": (1.09999, 1.1, 28.4718),
})
# phase 42: the examples, each at one depth on the card and the CPU:
# generations cut to keep the script inside its time limit (defaults:
# tsp 80, nqueens 150, evoknn 40, evoknn_jmlr 50, kursawefct 50, fctmin
# 120, bbob 60); knn (no loop) on every 16th of the 8192 feature masks
GA_EXAMPLES = ("ga.tsp", "ga.nqueens", "ga.knn", "ga.evoknn",
               "ga.evoknn_jmlr", "ga.kursawefct", "es.fctmin", "bbob")
GA_EXAMPLE_DEPTH = {"ga.tsp": 24, "ga.nqueens": 25, "ga.evoknn": 5,
                    "ga.evoknn_jmlr": 10, "ga.kursawefct": 3,
                    "es.fctmin": 40, "bbob": 10}
KNN_MASK_STRIDE = 16


def _is_perm(t) -> bool:
    import torch
    s = t.sort(-1).values
    return bool(torch.equal(s, torch.arange(t.shape[-1], dtype=s.dtype,
                                            device=s.device).expand_as(s)))


def ops_reference_phase(card_line, key) -> None:
    """Phase 39's operators: each new crossover, mutation and selection on
    the card against the CPU from the same keys, bit for bit."""
    import torch
    from deap_tpu_torch import base, random
    from deap_tpu_torch.ops import crossover as cx, mutation as mut
    from deap_tpu_torch.ops import selection as sel
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    ks = random.split(key, 12)
    n = OPS_ROWS
    a = random.uniform(ks[0], (n, DIM), minval=-5.12, maxval=5.12)
    b = random.uniform(ks[1], (n, DIM), minval=-5.12, maxval=5.12)
    s1 = random.uniform(ks[2], (n, DIM), minval=0.5, maxval=3.0)
    s2 = random.uniform(ks[3], (n, DIM), minval=0.5, maxval=3.0)
    cases = {
        "cx_one_point": lambda k, d: cx.cx_one_point.batched(
            k, a.to(d), b.to(d)),
        "cx_uniform": lambda k, d: cx.cx_uniform.batched(
            k, a.to(d), b.to(d), 0.1),
        "cx_simulated_binary": lambda k, d: cx.cx_simulated_binary.batched(
            k, a.to(d), b.to(d), 20.0),
        "cx_es_blend": lambda k, d: cx.cx_es_blend.batched(
            k, (a.to(d), s1.to(d)), (b.to(d), s2.to(d)), 0.1),
        "cx_es_two_point": lambda k, d: cx.cx_es_two_point.batched(
            k, (a.to(d), s1.to(d)), (b.to(d), s2.to(d))),
        "mut_es_log_normal": lambda k, d: mut.mut_es_log_normal.batched(
            k, (a.to(d), s1.to(d)), 1.0, 0.3)}
    perms = {}
    for size in (DIM, 25):
        keys = random.split(ks[4], 2 * n)
        p1 = random.permutation(keys[:n], size)
        p2 = random.permutation(keys[n:], size)
        perms[size] = (p1, p2)
        for name, kw in (("cx_partialy_matched", {}),
                         ("cx_uniform_partialy_matched", {"indpb": 0.3}),
                         ("cx_ordered", {})):
            op = getattr(cx, name)
            cases[f"{name} {n} x {size}"] = (
                lambda k, d, op=op, kw=kw, p1=p1, p2=p2: op(
                    random.split(k, n), p1.to(d), p2.to(d), **kw))
        cases[f"mut_shuffle_indexes {n} x {size}"] = (
            lambda k, d, p1=p1: mut.mut_shuffle_indexes(
                random.split(k, n), p1.to(d), 0.2))
    lengths = random.randint(ks[5], (2, n), 0, DIM + 1)
    p1, p2 = perms[DIM]
    cases["cx_messy_one_point"] = lambda k, d: cx.cx_messy_one_point(
        random.split(k, n), (p1.to(d), lengths[0].to(d)),
        (p2.to(d), lengths[1].to(d)))
    for dtype, low, up in ((torch.int8, -5, 20), (torch.int16, -300, 3000),
                           (torch.int32, 0, 1 << 20)):
        g = random.randint(ks[6], (n, DIM), -5, 5).to(dtype)
        cases[f"mut_uniform_int {dtype}"] = (
            lambda k, d, g=g, lo=low, hi=up: mut.mut_uniform_int(
                k, g.to(d), lo, hi, 0.5))
    vals = random.uniform(ks[7], (SEL_N, 2), minval=0.0, maxval=5.0)
    vals[::7] = vals[3]                              # ties
    valid = random.bernoulli(ks[8], 0.9, (SEL_N,))   # invalid rows read 0
    for name in ("sel_worst", "sel_roulette",
                 "sel_stochastic_universal_sampling"):
        cases[f"{name} {SEL_N}"] = (
            lambda k, d, name=name: getattr(sel, name)(
                k, base.Fitness(vals.to(d), valid.to(d), (1.0, -1.0)),
                SEL_N))
    out, t = {}, time.perf_counter()
    for i, (name, fn) in enumerate(cases.items()):
        k = random.fold_in(ks[9], i)
        card = fn(k, dev)
        host = fn(k.cpu(), cpu)
        same = _same_tensors(card, host)
        if name.startswith(("cx_partialy", "cx_uniform_partialy",
                            "cx_ordered", "mut_shuffle")):
            kids = card if isinstance(card, tuple) else (card,)
            same = same and all(_is_perm(c) for c in kids)
        out[name] = same
    phase("reference: the rest of the operators card vs CPU", card_line,
          rows=n, genes=DIM, selection_n=SEL_N, bitwise=out,
          seconds=time.perf_counter() - t)
    bad = [k for k, v in out.items() if not v]
    if bad:
        fail(f"operators differ between card and CPU (or a child is not a "
             f"permutation): {bad}")


def benchmarks_reference_phase(card_line, key) -> None:
    """Phase 39's benchmarks: every function, ``binary.py``, the moving
    peaks (three scenarios and the fluctuating mode, 20 changes) and the
    five decorators on 4096 rows, card against CPU."""
    import torch
    from deap_tpu_torch import benchmarks, random
    from deap_tpu_torch.benchmarks import binary, movingpeaks as mp
    from deap_tpu_torch.benchmarks import tools as bt
    dev = torch.device("cuda")
    t = time.perf_counter()
    n = OPS_ROWS
    out = {}
    for i, (name, kw, width, lo, hi) in enumerate(BENCH_FUNCS):
        x = random.uniform(random.fold_in(key, i), (n, width), minval=lo,
                           maxval=hi)
        fn = getattr(benchmarks, name)
        out[name] = _same_tensors(fn(x, **kw), fn(x.cpu(), **kw))
    x = random.uniform(random.fold_in(key, 100), (n, 4), minval=0.0,
                       maxval=10.0)
    peaks = torch.linspace(0.0, 10.0, 40, device=dev).reshape(10, 4)
    widths = torch.linspace(0.1, 1.0, 10, device=dev)
    out["shekel"] = _same_tensors(benchmarks.shekel(x, peaks, widths),
                                benchmarks.shekel(x.cpu(), peaks.cpu(),
                                                  widths.cpu()))
    kr = random.PRNGKey(3, device=dev)
    out["rand"] = _same_tensors(benchmarks.rand(x[0], kr),
                              benchmarks.rand(x[0].cpu(), kr.cpu()))
    for i, (name, kw, width) in enumerate(BINARY_FUNCS):
        bits = random.bernoulli(random.fold_in(key, 200 + i), 0.8,
                                (n, width)).to(torch.int32)
        fn = getattr(binary, name)
        out[f"binary.{name}"] = _same_tensors(fn(bits, **kw),
                                            fn(bits.cpu(), **kw))
    bits = random.bernoulli(random.fold_in(key, 300), 0.5, (n, 90))
    dec = binary.bin2float(-5.12, 5.12, 30)(lambda v: v)
    out["binary.bin2float"] = _same_tensors(dec(bits), dec(bits.cpu()))
    xp = random.uniform(random.fold_in(key, 400), (n, 5), minval=0.0,
                        maxval=100.0)
    for label, sc, extra in (("1", mp.SCENARIO_1, {}),
                             ("2", mp.SCENARIO_2, {}),
                             ("3", mp.SCENARIO_3, {}),
                             ("fluctuating", mp.SCENARIO_2,
                              {"npeaks": [3, 10, 20],
                               "number_severity": 0.4})):
        kp = random.fold_in(key, 500)
        card = mp.MovingPeaks(5, kp, **{**sc, **extra})
        host = mp.MovingPeaks(5, kp.cpu(), **{**sc, **extra})
        same = True
        for _ in range(PEAKS_CHANGES):
            same &= _same_tensors(card.evaluate(xp), host.evaluate(xp.cpu()))
            card.changePeaks()
            host.changePeaks()
            same &= all(_same_tensors(getattr(card.state, f),
                                    getattr(host.state, f))
                        for f in ("position", "height", "width",
                                  "last_change", "active"))
        same &= card(xp[0]) == host(xp[0].cpu())
        out[f"movingpeaks {label}"] = same
    xd = random.uniform(random.fold_in(key, 600), (n, 4), minval=-20.0,
                        maxval=20.0)
    vec = [0.5, -1.0, 2.0, 3.0]
    mat = torch.linalg.qr(torch.randn(4, 4, generator=torch.Generator()
                                      .manual_seed(0)))[0]
    bounds = ([-5.0, -1.0, 0.0, 2.0], [5.0, 1.0, 3.0, 2.5])
    decs = {"translate": bt.translate(vec), "scale": bt.scale([2.0] * 4),
            "rotate": bt.rotate(mat.numpy()),
            "noise": bt.noise(lambda k: random.uniform(k, ())),
            **{f"bound {m}": bt.bound(bounds, m)
               for m in ("clip", "wrap", "mirror")}}
    rot_gap = None
    for name, d in decs.items():
        if name.startswith("bound"):
            f = d(lambda v: (v, -v))
            out[name] = _same_tensors(f(xd), f(xd.cpu()))
            continue
        f = d(benchmarks.cigar)
        kw = {"key": kr} if name == "noise" else {}
        card = f(xd[0], **kw) if name == "noise" else f(xd)
        host = (f(xd[0].cpu(), key=kr.cpu()) if name == "noise"
                else f(xd.cpu()))
        if name == "rotate":
            rot_gap = _rel(card[0].cpu(), host[0])
            out[name] = rot_gap <= ROTATE_RTOL
        else:
            out[name] = _same_tensors(card, host)
    phase("reference: benchmarks, binary, moving peaks, decorators card vs "
          "CPU", card_line, rows=n, bitwise=out, rotate_rel_gap=rot_gap,
          rotate_rtol=ROTATE_RTOL, peaks_changes=PEAKS_CHANGES,
          seconds=time.perf_counter() - t)
    bad = [k for k, v in out.items() if not v]
    if bad:
        fail(f"benchmarks differ between card and CPU: {bad}")


def _flag_toolbox(evaluate="rastrigin", mate=("cx_two_point", {}),
                  engine="megakernel"):
    import torch
    from deap_tpu_torch import base, benchmarks
    from deap_tpu_torch.ops import crossover, mutation, selection
    tb = base.Toolbox()
    tb.register("evaluate", getattr(benchmarks, evaluate))
    tb.register("mate", getattr(crossover, mate[0]), **mate[1])
    tb.register("mutate", mutation.mut_gaussian, mu=MU, sigma=SIGMA,
                indpb=INDPB)
    tb.register("select", selection.sel_tournament, tournsize=3,
                tie_break="rank")
    if engine == "megakernel":
        tb.generation_engine = "megakernel"
    return tb


def _flag_xla_generation(tb, key, pop):
    """``bench.py``'s xla body: tournament, the row gather,
    ``vary_genome(pairing="halves")``, evaluation."""
    from deap_tpu_torch import base, random
    from deap_tpu_torch.algorithms import evaluate_population, vary_genome
    n = pop.size
    key, k_sel, k_var = random.split(key, 3)
    idx = tb.select(k_sel, pop.fitness, n)
    genome, _ = vary_genome(k_var, pop.genome[idx.long()], tb, CXPB, MUTPB,
                            pairing="halves")
    off = base.Population(genome, base.Fitness.empty(
        n, (-1.0,), device=genome.device))
    return key, evaluate_population(tb, off)[0]


def flagship_rest_phase(kernels, card_line) -> dict:
    """Phase 40: ``bench.py``'s megakernel body with each new objective
    and its xla body with each new crossover, 1e6 x 100 float32, rbg
    keys, N and 2N generations.  Returns K2's launches by objective."""
    import torch
    from deap_tpu_torch import base, benchmarks, random
    from deap_tpu_torch.algorithms import ea_step, evaluate_population
    dev = torch.device("cuda")
    key = random.PRNGKey(0, impl="rbg", device=dev)
    k_init, k_run, k_ref = random.split(random.fold_in(key, 40), 3)
    genome = random.uniform(k_init, (POP, DIM), minval=-5.12, maxval=5.12)
    launches_k2 = {}
    for body, variants in (("megakernel", FLAG_FUNCS), ("xla", FLAG_MATES)):
        for v in variants:
            if body == "megakernel":
                tb, label = _flag_toolbox(evaluate=v), v
            else:
                tb = _flag_toolbox(mate=v, engine="xla")
                label = v[0]
            pop0 = evaluate_population(tb, base.Population(
                genome, base.Fitness.empty(POP, (-1.0,), device=dev)))[0]
            state = {}

            def run(ngen):
                torch.cuda.synchronize()
                t = time.perf_counter()
                k, pop = k_run, pop0
                for _ in range(ngen):
                    if body == "megakernel":
                        k, pop, _ = ea_step(k, pop, tb, CXPB, MUTPB)
                    else:
                        k, pop = _flag_xla_generation(tb, k, pop)
                torch.cuda.synchronize()
                state[ngen] = pop
                return time.perf_counter() - t

            kernels.reset_launches()
            t2 = run(2 * FLAG_NGEN)
            launches = dict(kernels.LAUNCHES)
            t1 = run(FLAG_NGEN)
            best0 = float(pop0.fitness.values.min())
            best = [float(state[g].fitness.values.min())
                    for g in (FLAG_NGEN, 2 * FLAG_NGEN)]
            last = state[2 * FLAG_NGEN]
            # card = CPU: the evaluation of every 100th row of the last
            # generation's children, and one whole generation at 10240 x
            # 100 from the same keys
            rows = last.genome[::FLAG_STRIDE]
            ev = evaluate_population(tb, base.Population(
                rows.cpu(), base.Fitness.empty(rows.shape[0], (-1.0,),
                                               device="cpu")))[0]
            if body == "megakernel":
                eval_same = _same_tensors(last.fitness.values[::FLAG_STRIDE],
                                        ev.fitness.values)
            else:
                eval_same = _rel(last.fitness.values[::FLAG_STRIDE],
                                 ev.fitness.values) <= FLAG_RTOL
            small = pop0.take(torch.arange(FLAG_REF_POP, device=dev))
            host = base.Population(small.genome.cpu(), base.Fitness(
                small.fitness.values.cpu(), small.fitness.valid.cpu(),
                (-1.0,)))
            if body == "megakernel":
                _, g_card, _ = ea_step(k_ref, small, tb, CXPB, MUTPB)
                _, g_cpu, _ = ea_step(k_ref.cpu(), host, tb, CXPB, MUTPB)
            else:
                _, g_card = _flag_xla_generation(tb, k_ref, small)
                _, g_cpu = _flag_xla_generation(tb, k_ref.cpu(), host)
            gen_same = _same_tensors(g_card.genome, g_cpu.genome)
            if body == "megakernel":      # the new objectives: bitwise
                gen_same &= _same_tensors(g_card.fitness.values,
                                        g_cpu.fitness.values)
            else:                         # rastrigin: within FLAG_RTOL
                gen_same &= _rel(g_card.fitness.values,
                                 g_cpu.fitness.values) <= FLAG_RTOL
            k2 = launches.get("megakernel_gather_vary", 0)
            phase(f"flagship width: bench.py {body} body, {label}",
                  card_line, key_impl="rbg", pop=POP, dim=DIM,
                  ngen=[FLAG_NGEN, 2 * FLAG_NGEN], seconds=[t1, t2],
                  marginal_ms_per_gen=(t2 - t1) / FLAG_NGEN * 1e3,
                  best_start=best0, best=best, launches=launches,
                  eval_card_eq_cpu_rows=rows.shape[0],
                  eval_card_eq_cpu=eval_same,
                  generation_card_eq_cpu_pop=FLAG_REF_POP,
                  generation_card_eq_cpu=gen_same)
            if body == "megakernel":
                launches_k2[label] = k2
                if k2 != 2 * FLAG_NGEN:
                    fail(f"K2 ran {k2} times in {2 * FLAG_NGEN} generations "
                         f"of the megakernel body on {label}")
            if not best[-1] < best0:
                fail(f"{body} body, {label}: best fitness did not fall: "
                     f"{best0} -> {best}")
            if not (eval_same and gen_same):
                fail(f"{body} body, {label}: card and CPU differ "
                     f"(evaluation {eval_same}, generation {gen_same})")
            del pop0, state, last
            torch.cuda.empty_cache()
    return launches_k2


def suite_toolbox(problem: str):
    from deap_tpu_torch import base, benchmarks
    from deap_tpu_torch.ops import crossover, mutation
    kw, _, ndim, low, up = SUITE[problem]
    tb = base.Toolbox()
    tb.register("evaluate", getattr(benchmarks, problem), **kw)
    tb.register("mate", crossover.cx_simulated_binary_bounded, low=low,
                up=up, eta=BN_ETA)
    tb.register("mutate", mutation.mut_polynomial_bounded, low=low, up=up,
                eta=BN_ETA, indpb=1.0 / ndim)
    return tb


def suite_select(k_sel, fitness, n):
    """``sel_nsga2`` at its defaults (``nd="standard"``: the staircase at
    two objectives, the grid at three with n >= 16384, else the peel)."""
    from deap_tpu_torch.ops import emo
    return emo.sel_nsga2(k_sel, fitness, n)


def suite_initial(tb, key, problem: str, n: int):
    """``n`` genomes uniform within the problem's bounds, evaluated."""
    import torch
    from deap_tpu_torch import base, random
    from deap_tpu_torch.algorithms import evaluate_population
    _, nobj, ndim, low, up = SUITE[problem]
    lo = torch.tensor(low, dtype=torch.float32, device=key.device)
    span = torch.tensor(up, dtype=torch.float32, device=key.device) - lo
    genome = lo + span * random.uniform(key, (n, ndim))
    pop = base.Population(genome, base.Fitness.empty(
        n, (-1.0,) * nobj, device=key.device))
    return evaluate_population(tb, pop)[0]


def suite_keys(key, i: int):
    from deap_tpu_torch import random
    return random.split(random.fold_in(key, 41 + i), 3)


def suite_reference(card_line, key, problem: str) -> None:
    """One generation at pool 1024 card against CPU: offspring and
    values bitwise, the selection equal on the CPU pool's values, and
    the default method's ranks equal to the count peel's."""
    import torch
    from deap_tpu_torch import base, random
    from deap_tpu_torch.algorithms import evaluate_population, vary_genome
    from deap_tpu_torch.ops import emo
    dev = torch.device("cuda")
    tb = suite_toolbox(problem)
    n = SUITE_REF_POP // 2
    k_init, k_var, k_sel = random.split(key.cpu(), 3)
    pop = suite_initial(tb, k_init, problem, n)
    g_cpu, _ = vary_genome(k_var, pop.genome, tb, BN_CXPB, BN_MUTPB,
                           pairing="halves")
    g_dev, _ = vary_genome(k_var.to(dev), pop.genome.to(dev), tb, BN_CXPB,
                           BN_MUTPB, pairing="halves")
    same_off = _same_tensors(g_dev, g_cpu)
    weights = pop.fitness.weights
    off = evaluate_population(tb, base.Population(g_cpu, base.Fitness.empty(
        n, weights, device="cpu")))[0]
    off_dev = evaluate_population(tb, base.Population(
        g_cpu.to(dev), base.Fitness.empty(n, weights, device=dev)))[0]
    same_vals = _same_tensors(off_dev.fitness.values, off.fitness.values)
    pool = pop.concat(off)
    pool_dev = base.Fitness(pool.fitness.values.to(dev),
                            pool.fitness.valid.to(dev), weights)
    idx_cpu = suite_select(k_sel, pool.fitness, n)
    idx_dev = suite_select(k_sel.to(dev), pool_dev, n)
    same_idx = torch.equal(idx_cpu, idx_dev.cpu())
    w = pool_dev.masked_wvalues()
    method = "staircase" if w.shape[1] == 2 else "grid"
    a = emo.nondominated_ranks(w, method=method, stop_at_k=n)
    b = emo.nondominated_ranks(w, method="peel", stop_at_k=n)
    same_ranks = torch.equal(a[0], b[0]) and int(a[1]) == int(b[1])
    phase(f"reference: suite {problem} generation card vs CPU", card_line,
          pool=2 * n, offspring_bitwise=same_off, values_bitwise=same_vals,
          selection_equal=same_idx, method=method,
          ranks_equal_peel=same_ranks, fronts=int(b[1]))
    if not (same_off and same_vals and same_idx and same_ranks):
        fail(f"suite {problem} at pool {2 * n}: offspring {same_off}, values "
             f"{same_vals}, selection {same_idx}, {method} ranks {same_ranks}")


def suite_phase(kernels, card_line, key) -> tuple:
    """Phase 41: each problem at POP 1e5 through bench_nsga2.py's
    generation, N and 2N generations, then the final population's
    hypervolume.  Returns ``(launches by problem, K4 and K5 times by
    problem)``."""
    import torch
    from deap_tpu_torch import random
    from deap_tpu_torch.ops import dominance as D, hv as host_hv
    from deap_tpu_torch.ops import hypervolume as H
    launches_by, k4_by, k5_by = {}, {}, {}
    for i, problem in enumerate(SUITE):
        _, nobj, ndim, _, _ = SUITE[problem]
        ngen = SUITE_NGEN
        k_init, k_run, k_ref = suite_keys(key, i)
        suite_reference(card_line, k_ref, problem)
        tb = suite_toolbox(problem)
        ref = HV_REF[problem]
        pop0 = suite_initial(tb, k_init, problem, SUITE_POP)
        hv0 = tb.hypervolume(-pop0.fitness.wvalues, ref)
        state = {}

        def run(ngen):
            torch.cuda.synchronize()
            t = time.perf_counter()
            k, pop = k_run, pop0
            for _ in range(ngen):
                k, pop = bench_nsga2_generation(tb, k, pop,
                                                select=suite_select)
            torch.cuda.synchronize()
            state[ngen] = (pop, k)
            return time.perf_counter() - t

        kernels.reset_launches()
        t2 = run(2 * ngen)
        pop2 = state[2 * ngen][0]
        t = time.perf_counter()
        hv2 = tb.hypervolume(-pop2.fitness.wvalues, ref)
        hv_ms = (time.perf_counter() - t) * 1e3
        launches = dict(kernels.LAUNCHES)
        t1 = run(ngen)
        pts = -pop2.fitness.wvalues
        inside = int((pts < torch.tensor(ref, device=pts.device)).all(1)
                     .sum().item())
        extra = {}
        if nobj == 3:
            plain = float(H.hypervolume_3d(pts.double(), ref))
            sub = pts.double()[::SUITE_POP // HV_SUBSAMPLE][:HV_SUBSAMPLE]
            sub_card = tb.hypervolume(sub, ref)
            sub_host = host_hv.hypervolume(sub, ref)
            extra = {"hypervolume_plain_float64": plain,
                     "rel_gap_to_plain": abs(hv2 - plain) / abs(plain),
                     "subsample_card": sub_card, "subsample_host": sub_host}
        widths = front_widths(pop2.fitness, SUITE_POP)
        ok = (bool(torch.isfinite(pop2.fitness.values).all())
              and bool(pop2.fitness.valid.all())
              and tuple(pop2.genome.shape) == (SUITE_POP, ndim))
        phase(f"suite at bench_nsga2 width: {problem}", card_line,
              pop=SUITE_POP, dim=ndim, nobj=nobj,
              ngen=[ngen, 2 * ngen], seconds=[t1, t2],
              marginal_ms_per_gen=(t2 - t1) / ngen * 1e3,
              launches=launches, hv_ref=list(ref), hypervolume_start=hv0,
              hypervolume_end=hv2, hypervolume_wall_ms=hv_ms,
              points_inside_ref=inside, fronts_final=len(widths),
              widest_front_final=max(widths), finite_valid_shaped=ok,
              **extra)
        if not ok:
            fail(f"suite {problem}: the final population is not finite, "
                 "valid and shaped")
        if inside == 0:
            fail(f"suite {problem}: no final point inside HV_REF {ref}")
        if not hv2 >= hv0:
            fail(f"suite {problem}: the hypervolume fell {hv0} -> {hv2}")
        if nobj == 3:
            if launches["rows_dominate_counts"] < 1:
                fail(f"K4 never ran in {problem}'s grid peel")
            if launches["hv3d_sweep"] != 1:
                fail(f"K5 ran {launches['hv3d_sweep']} times for {problem}'s "
                     "hypervolume")
            if extra["rel_gap_to_plain"] > HV_RTOL["float64"]:
                fail(f"{problem}: hypervolume {hv2} against the plain sweep's "
                     f"{extra['hypervolume_plain_float64']}")
            if abs(sub_card - sub_host) > 1e-12 * max(1.0, abs(sub_host)):
                fail(f"{problem}: subsample hypervolume card {sub_card}, "
                     f"host {sub_host}")
            # K4 at the grid peel's chunk shape on this problem's last pool
            w = pop2.fitness.masked_wvalues().contiguous()
            rows = w[:FRONT_CHUNK].contiguous()
            k4 = kernels.launch_rows_dominate_counts(rows, w)
            p4 = D._rows_dominate_counts_plain(rows, w)
            if not torch.equal(k4, p4):
                fail(f"K4 on {problem}'s population differs from its plain "
                     "version")
            ms = cuda_ms(lambda: kernels.launch_rows_dominate_counts(rows, w),
                         reps=10, warm=1)
            plain_ms = cuda_ms(lambda: D._rows_dominate_counts_plain(rows, w),
                               reps=3, warm=1)
            b, by = counts_bound(FRONT_CHUNK, w.shape[0], nobj)
            k4_by[problem] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b,
                              "bound_by": by, "max_abs_err": 0}
            k5_by[problem] = k5_check(kernels, card_line,
                                      f"{problem}'s final population", pts,
                                      ref)
        launches_by[problem] = launches
        del pop0, pop2, state
        torch.cuda.empty_cache()
    return launches_by, k4_by, k5_by


def ga_example_run(mod, dev, depth=None):
    """One example at ``depth`` generations: its final population (bbob:
    the table)."""
    if mod.__name__.endswith(".bbob"):
        return mod.main(verbose=False, device=dev, ngen=depth)
    if mod.__name__.endswith(".knn"):
        X, y = mod.make_dataset(device=dev)
        import torch
        masks = (torch.arange(0, 2 ** mod.N_FEATURES, KNN_MASK_STRIDE,
                              device=dev)[:, None]
                 >> torch.arange(mod.N_FEATURES, device=dev)) & 1
        n = mod.N_TRAIN
        return mod.knn_accuracy(masks.float(), X[:n], y[:n], X[n:], y[n:])
    kw = {} if depth is None else {"ngen": depth}
    out = mod.main(verbose=False, device=dev, **kw)
    return out[0] if isinstance(out, tuple) else out


def cpu_ga_examples() -> dict:
    """The CPU side of :func:`ga_examples_phase`: each example's final
    population (bbob: its first generation's value of every problem) and
    seconds."""
    import importlib
    import torch
    from deap_tpu_torch import benchmarks
    cpu = torch.device("cpu")
    out = {}
    for name in GA_EXAMPLES:
        mod = importlib.import_module(f"deap_tpu_torch.examples.{name}")
        t = time.perf_counter()
        if name == "bbob":
            host = {(f, d): mod.run_problem(getattr(benchmarks, f), d, 31,
                                            cpu, 1)[1]
                    for f in mod.SUITE for d in mod.DIMS}
        else:
            host = ga_example_run(mod, cpu, GA_EXAMPLE_DEPTH.get(name))
        out[name] = (host, time.perf_counter() - t)
    return out


def ga_examples_phase(kernels, card_line) -> dict:
    """Phase 42: the eight GA / ES examples at ``GA_EXAMPLE_DEPTH`` on
    the card, each example's own check, card = CPU on the final
    population of the same run (bbob: its first generation, and the table
    finite); the CPU runs beside the card's (:class:`CpuSide`)."""
    import importlib
    import math
    import torch
    from deap_tpu_torch import benchmarks
    dev = torch.device("cuda")
    cpu_side = CpuSide("cpu_ga_examples")
    out, cards = {}, {}
    for name in GA_EXAMPLES:
        mod = importlib.import_module(f"deap_tpu_torch.examples.{name}")
        kernels.reset_launches()
        t = time.perf_counter()
        depth = GA_EXAMPLE_DEPTH.get(name)
        card = ga_example_run(mod, dev, depth)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = dict(kernels.LAUNCHES)
        first = None
        if name == "bbob":
            first = {(f, d): mod.run_problem(getattr(benchmarks, f), d, 31,
                                             dev, 1)[1]
                     for f in mod.SUITE for d in mod.DIMS}
        cards[name] = (mod, card, secs, launches, first, depth)
    hosts = cpu_side.result()
    for name in GA_EXAMPLES:
        mod, card, secs, launches, first, depth = cards[name]
        host, cpu_secs = hosts[name]
        if name == "bbob":
            same = all(first[k] == host[k] for k in first)
            check = all(math.isfinite(v) for v in card.values())
            detail = {f"{f} d{d}": v for (f, d), v in card.items()}
        elif name == "ga.knn":
            same = _same_tensors(card, host)
            check = float(card.max()) > 0.5
            detail = {"best_accuracy": float(card.max())}
        else:
            same = (_same_tensors(card.genome, host.genome)
                    and _same_tensors(card.fitness.values,
                                      host.fitness.values))
            vals = card.fitness.values
            detail = {"best": float(vals[:, 0].min()), "size": card.size}
            if name in ("ga.tsp", "ga.nqueens"):
                check = _is_perm(card.genome)
            elif name == "ga.kursawefct":
                check = bool((card.genome.abs() <= mod.BOUND).all())
            elif name == "es.fctmin":
                check = detail["best"] < 1.0
            else:
                detail = {"best_accuracy": float(vals[:, 0].max())}
                check = detail["best_accuracy"] > 0.5
        phase(f"example: {name}", card_line, card_seconds=secs,
              generations=depth, cpu_seconds=cpu_secs, card_eq_cpu=same,
              quality_check=check,
              launches=launches, **detail)
        if not (same and check):
            fail(f"example {name}: card = CPU {same}, its check {check}")
        out[name] = launches
    return out


def rest_of_ops_phases(kernels, card_line, key) -> dict:
    """Phases 39-42; returns the launch counts of their paths and K4's
    and K5's times on the suite's fronts."""
    import torch
    from deap_tpu_torch import random
    torch.cuda.empty_cache()
    k_ops, k_bench, k_suite = random.split(random.fold_in(key, 9), 3)
    ops_reference_phase(card_line, k_ops)
    benchmarks_reference_phase(card_line, k_bench)
    k2 = flagship_rest_phase(kernels, card_line)
    suite_launches, k4_by, k5_by = suite_phase(kernels, card_line, k_suite)
    examples = ga_examples_phase(kernels, card_line)
    return {"k2": k2, "suite": suite_launches, "k4": k4_by, "k5": k5_by,
            "examples": examples}


# ---------------------------------------------------------------------------
# the rest of the library: creator, checkpoint / resume (K2), DE, PSO,
# EDA, migration and their ten examples
# ---------------------------------------------------------------------------

CK_STORAGES = (("float32", 0.0), ("bfloat16", 0.0), ("int8", 5.12))
CK_GENS = 2                        # generations before and after the save
CK_STRIDE = 1000                   # init_population card = CPU rows
DE_POP, DE_REF_POP, DE_GENS = 8192, 2048, 3
PSO_GENS, PSO_REF_POP = 3, 2048
EDA_DIM, EDA_LAMBDA, EDA_MU, EDA_GENS = 100, 4096, 2048, 10
MIG_ISLANDS, MIG_POP, MIG_K = 8, 131072, 1024
MIG_NONCYCLIC = (2, 0, 1, 4, 3, 6, 7, 5)
LIB_EXAMPLES = ("ga.onemax_multidemic", "de.basic", "de.sphere",
                "de.dynamic", "pso.basic", "pso.multiswarm", "eda.emna",
                "eda.pbil", "coev.coop_evol", "coev.hillis")
# tests/test_examples.py's SMOKE arguments and checks (None: it runs)
LIB_EXAMPLE_ARGS = {"pso.multiswarm": {"ngen": 20},
                    "de.sphere": {"ngen": 30}}
LIB_EXAMPLE_CHECKS = {
    "ga.onemax_multidemic": lambda r: float(r.fitness.values.max()) >= 85,
    "de.basic": lambda r: r < 1e-1, "pso.basic": lambda r: r < 1.0,
    "eda.emna": lambda r: r < 1e-2, "eda.pbil": lambda r: r >= 45,
    "coev.coop_evol": lambda r: r >= 85, "coev.hillis": lambda r: r <= 20}


def rastrigin_exact(x):
    """Rastrigin over a leading row axis in fixed float32 forms (XLA's
    cosine through float64, the sum in index order, XLA's windows past
    32): the same bits on the card and the CPU, which
    ``benchmarks.rastrigin``'s ``torch.cos`` and ``torch.sum`` are not."""
    import math
    from deap_tpu_torch._xla_math import cos, row_sum
    n = x.shape[-1]
    return 10.0 * n + row_sum(x * x - 10.0 * cos((2.0 * math.pi) * x)),


def _exact_rastrigin():
    from deap_tpu_torch.ops._dispatch import batched_op
    if getattr(rastrigin_exact, "batched", None) is None:
        batched_op(rastrigin_exact, rastrigin_exact)
    return rastrigin_exact


def _host_ms(fn, reps: int = 3) -> float:
    """Median host-clock ms of ``fn`` between synchronizations."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return sorted(times)[len(times) // 2]


def _tree_bytes(state) -> int:
    import dataclasses
    import torch
    if torch.is_tensor(state):
        return state.numel() * state.element_size()
    if isinstance(state, dict):
        return sum(_tree_bytes(v) for v in state.values())
    if isinstance(state, (tuple, list)):
        return sum(_tree_bytes(v) for v in state)
    if dataclasses.is_dataclass(state):
        return sum(_tree_bytes(getattr(state, f.name))
                   for f in dataclasses.fields(state))
    return 0


def creator_checkpoint_phase(kernels, card_line) -> dict:
    """Phase 43: ``creator.IndividualSpec.init_population`` at 1e6 x 100
    in float32, bfloat16 and int8 storage (card = CPU on every 1000th
    row), then the flagship generation (``ea_simple``'s ``ea_step`` on the
    megakernel engine, K2) with a checkpoint after 2 generations: 2 more
    generations, the checkpoint loaded onto the card and 2 generations
    from it equal the undisturbed 4 bit for bit; again with the
    asynchronous save overlapping the next generation.  Returns K2's
    launches on the path."""
    import torch
    from deap_tpu_torch import creator, random
    from deap_tpu_torch.algorithms import ea_step, evaluate_population
    from deap_tpu_torch.ops import init
    from deap_tpu_torch.ops.generation import GenomeStorage
    from deap_tpu_torch.utils import checkpoint
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    t0 = time.perf_counter()
    spec = creator.IndividualSpec(creator.FitnessSpec((-1.0,)))
    attr = init.uniform(-5.12, 5.12, (DIM,))
    key = random.fold_in(random.PRNGKey(0, device=dev), 43)
    k_init, k_run = random.split(key)
    init_rows = {}
    for st, bound in CK_STORAGES:
        pop = spec.init_population(k_init, POP, attr, storage_dtype=st,
                                   storage_bound=bound)
        keys = random.split(k_init.cpu(), POP)[::CK_STRIDE]
        rows = attr(keys)
        if st != "float32":
            rows = GenomeStorage(st, bound).to_storage(rows)
        same = _same_bits(pop.genome[::CK_STRIDE], rows)
        init_rows[st] = same
        if not (same and pop.genome.shape == (POP, DIM)
                and pop.genome.device.type == "cuda"):
            fail(f"init_population {st}: card != CPU on every "
                 f"{CK_STRIDE}th row, or shape {tuple(pop.genome.shape)}")
        if st == "float32":
            pop0 = pop
        del pop
    tb = _flag_toolbox()
    pop0 = evaluate_population(tb, pop0)[0]
    out_dir = os.path.join(ROOT, "chip_smoke_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "flagship.ckpt")

    def gens(k, pop, n):
        for _ in range(n):
            k, pop, _ = ea_step(k, pop, tb, CXPB, MUTPB)
        return k, pop

    kernels.reset_launches()
    k_ref, ref = gens(k_run, pop0, 2 * CK_GENS)
    torch.cuda.synchronize()
    runs, ngen = {}, 2 * CK_GENS
    for mode in ("sync", "async"):
        k, pop = gens(k_run, pop0, CK_GENS)
        state = {"key": k, "population": pop, "generation": CK_GENS}
        torch.cuda.synchronize()
        t = time.perf_counter()
        if mode == "sync":
            checkpoint.save_checkpoint(path, state)
            save_s = time.perf_counter() - t
            k, pop = gens(k, pop, CK_GENS)
            torch.cuda.synchronize()
        else:
            handle = checkpoint.async_save_checkpoint(path, state)
            save_s = time.perf_counter() - t           # the host copy
            k, pop = gens(k, pop, 1)                    # overlaps the write
            torch.cuda.synchronize()
            handle.result()
            write_s = time.perf_counter() - t
            k, pop = gens(k, pop, CK_GENS - 1)
        ngen += 2 * CK_GENS
        continued = _same_tensors(pop.genome, ref.genome)
        t = time.perf_counter()
        back = checkpoint.load_checkpoint(path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        k2, pop2 = gens(back["key"], back["population"], CK_GENS)
        ngen += CK_GENS
        resumed = (_same_tensors(pop2.genome, ref.genome)
                   and _same_tensors(pop2.fitness.values, ref.fitness.values)
                   and torch.equal(pop2.fitness.valid, ref.fitness.valid)
                   and torch.equal(k2, k_ref))
        size = os.path.getsize(path)
        mb = _tree_bytes(state) / 1e6
        runs[mode] = {"resumed_bitwise": resumed, "continued_bitwise":
                      continued, "file_mb": size / 1e6, "state_mb": mb,
                      "save_s": save_s, "load_s": load_s,
                      "save_mb_per_s": mb / save_s,
                      "load_mb_per_s": mb / load_s}
        if mode == "async":
            runs[mode]["host_copy_s"] = save_s
            runs[mode]["write_done_s"] = write_s
            runs[mode].pop("save_mb_per_s")
            runs[mode]["host_copy_mb_per_s"] = mb / save_s
        if not (resumed and continued):
            fail(f"checkpoint ({mode}): the resumed run differs from the "
                 f"undisturbed one (resumed {resumed}, continued {continued})")
        del back, pop, pop2, state
    os.remove(path)
    k2_launches = kernels.LAUNCHES["megakernel_gather_vary"]
    phase("creator and checkpoint: flagship init_population and resume",
          card_line, pop=POP, dim=DIM, init_card_eq_cpu_every=CK_STRIDE,
          init_card_eq_cpu=init_rows, runs=runs, generations=ngen,
          launches=dict(kernels.LAUNCHES),
          seconds=time.perf_counter() - t0)
    if k2_launches != ngen:
        fail(f"K2 ran {k2_launches} times in {ngen} generations of the "
             "checkpoint phase")
    del pop0, ref
    torch.cuda.empty_cache()
    return {"checkpoint": k2_launches, "generations": ngen}


def de_phase(kernels, card_line) -> None:
    """Phase 44: DE rand/1/bin at POP 8192 x 100 on rastrigin: ms a
    generation (median of DE_GENS) and the donor shuffle's share
    (``_distinct_indices`` alone: one (n, n - 1) permutation a
    generation, two sort rounds); one generation at 2048 x 100 card =
    CPU bit for bit."""
    import torch
    from deap_tpu_torch import base, de, random
    from deap_tpu_torch.algorithms import evaluate_rows
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    fn = _exact_rastrigin()
    key = random.fold_in(random.PRNGKey(0, device=dev), 44)
    k_init, k_run, k_ref = random.split(key, 3)
    genome = random.uniform(k_init, (DE_POP, DIM), minval=-5.12,
                            maxval=5.12)
    pop = base.Population(genome, base.Fitness.empty(DE_POP, (-1.0,),
                                                     device=dev))
    pop = pop.evaluated(evaluate_rows(fn, genome))
    best0 = float(pop.fitness.values.min())
    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = {"pop": pop, "key": k_run}

    def one_gen():
        k, kk = random.split(state["key"])
        state["key"] = k
        state["pop"] = de.de_step(kk, state["pop"], fn, cr=0.25, f=1.0)

    one_gen()                                          # warm
    times = [_host_ms(one_gen, reps=1) for _ in range(DE_GENS)]
    gen_ms = sorted(times)[len(times) // 2]
    shuffle_ms = _host_ms(lambda: de._distinct_indices(k_run, DE_POP, 3))
    peak = torch.cuda.max_memory_allocated() / 1e9
    best = float(state["pop"].fitness.values.min())
    small = pop.take(torch.arange(DE_REF_POP, device=dev))
    card = de.de_step(k_ref, small, fn)
    host = de.de_step(k_ref.cpu(), base.Population(
        small.genome.cpu(), base.Fitness(small.fitness.values.cpu(),
                                         small.fitness.valid.cpu(),
                                         (-1.0,))), fn)
    same = (_same_tensors(card.genome, host.genome)
            and _same_tensors(card.fitness.values, host.fitness.values))
    phase("DE: rand/1/bin at 8192 x 100 rastrigin", card_line, pop=DE_POP,
          dim=DIM, ms_per_gen=gen_ms, ms_per_gen_readings=times,
          donor_shuffle_ms=shuffle_ms, shuffle_share=shuffle_ms / gen_ms,
          best_start=best0, best_end=best, peak_gb=peak,
          card_eq_cpu_pop=DE_REF_POP, card_eq_cpu=same,
          launches=dict(kernels.LAUNCHES),
          seconds=time.perf_counter() - t0)
    if not same:
        fail("DE: a generation at 2048 x 100 differs card vs CPU")
    if not best <= best0:
        fail(f"DE: the best fitness rose: {best0} -> {best}")
    del pop, state, genome
    torch.cuda.empty_cache()


def pso_phase(kernels, card_line) -> None:
    """Phase 45: gbest PSO at 1e6 x 100 rastrigin (speed limits 1) and
    constriction PSO (ms a generation, median of PSO_GENS); the
    multiswarm at ``examples/pso/multiswarm.py``'s defaults (ms a
    generation); two steps at 2048 rows card = CPU bit for bit."""
    import torch
    from deap_tpu_torch import random
    from deap_tpu_torch import pso
    from deap_tpu_torch.examples.pso import multiswarm
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    t0 = time.perf_counter()
    fn = _exact_rastrigin()
    key = random.fold_in(random.PRNGKey(0, device=dev), 45)
    k_init, k_run = random.split(key)
    rules = {"canonical": dict(phi1=2.0, phi2=2.0, smin=-1.0, smax=1.0),
             "constriction": dict(constriction=True)}
    out = {}
    kernels.reset_launches()
    for rule, kw in rules.items():
        st0 = pso.pso_init(k_init, POP, DIM, -5.12, 5.12, -1.0, 1.0)
        box = {"st": st0, "key": k_run}

        def one_gen():
            k, kk = random.split(box["key"])
            box["key"] = k
            box["st"] = pso.pso_step(kk, box["st"], fn, (-1.0,), **kw)[0]

        one_gen()
        times = [_host_ms(one_gen, reps=1) for _ in range(PSO_GENS)]
        fields = ("position", "speed", "pbest", "pbest_w", "gbest",
                  "gbest_w")
        card = pso.PSOState(**{f: getattr(st0, f)[:PSO_REF_POP]
                               if f in fields[:4] else getattr(st0, f)
                               for f in fields})
        host = pso.PSOState(**{f: getattr(card, f).cpu() for f in fields})
        k = k_run
        for _ in range(2):
            k, kk = random.split(k)
            card = pso.pso_step(kk, card, fn, (-1.0,), **kw)[0]
            host = pso.pso_step(kk.cpu(), host, fn, (-1.0,), **kw)[0]
        same = _same_tensors(_flat_state(card), _flat_state(host))
        out[rule] = {"ms_per_gen": sorted(times)[len(times) // 2],
                     "ms_per_gen_readings": times,
                     "gbest_raw": -float(box["st"].gbest_w),
                     "card_eq_cpu": same}
        if not same:
            fail(f"PSO {rule}: two steps at {PSO_REF_POP} rows differ card "
                 "vs CPU")
        del box, st0
        torch.cuda.empty_cache()
    launches = dict(kernels.LAUNCHES)
    n_ms = multiswarm.NGEN
    torch.cuda.synchronize()
    t = time.perf_counter()
    ms_state, errors = multiswarm.run(ngen=n_ms, device=dev)
    torch.cuda.synchronize()
    ms_ms = (time.perf_counter() - t) / n_ms * 1e3
    phase("PSO: pso at 1e6 x 100 rastrigin, the multiswarm at its "
          "defaults", card_line, pop=POP, dim=DIM, rules=out,
          card_eq_cpu_pop=PSO_REF_POP, multiswarm_ms_per_gen=ms_ms,
          multiswarm_generations=n_ms, multiswarm_final_error=errors[-1],
          launches=launches, seconds=time.perf_counter() - t0)
    del ms_state


def eda_phase(kernels, card_line) -> None:
    """Phase 46: EMNA at BASELINE config 3's width (N = 100, lambda =
    4096, mu = 2048) on the sphere and PBIL (100 bits, lambda = 4096) on
    OneMax through ``ea_generate_update``: ms a generation; one
    generation from the same state and key card = CPU bit for bit."""
    import dataclasses
    import torch
    from deap_tpu_torch import base, eda, random
    from deap_tpu_torch.algorithms import ea_generate_update
    from deap_tpu_torch.examples.de.basic import sphere
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    t0 = time.perf_counter()
    key = random.fold_in(random.PRNGKey(0, device=dev), 46)
    out = {}
    kernels.reset_launches()
    for name in ("EMNA", "PBIL"):
        def make(d):
            if name == "EMNA":
                return eda.EMNA([5.0] * EDA_DIM, 5.0, EDA_MU, EDA_LAMBDA,
                                device=d), (-1.0,), sphere
            return eda.PBIL(EDA_DIM, 0.3, 0.1, 0.05, EDA_LAMBDA,
                            device=d), (1.0,), lambda g: (g.sum(),)

        def toolbox(s, evaluate):
            tb = base.Toolbox()
            tb.register("evaluate", evaluate)
            tb.register("generate", s.generate)
            tb.register("update", s.update)
            return tb

        s, w, evaluate = make(dev)
        tb = toolbox(s, evaluate)
        state0 = s.init()
        ea_generate_update(key, tb, state0, ngen=1, weights=w)    # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        pop, state, log = ea_generate_update(key, tb, state0,
                                             ngen=EDA_GENS, weights=w)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) / EDA_GENS * 1e3
        sc, _, _ = make(cpu)
        host_state = type(state)(**{f.name: getattr(state, f.name).cpu()
                                    for f in dataclasses.fields(state)})
        k = random.fold_in(key, 1)
        pc, nc, _ = ea_generate_update(k, tb, state, ngen=1, weights=w)
        ph, nh, _ = ea_generate_update(k.cpu(), toolbox(sc, evaluate),
                                       host_state, ngen=1, weights=w)
        same = (_same_tensors(_flat_state(pc), _flat_state(ph))
                and _same_tensors(_flat_state(nc), _flat_state(nh)))
        vals = pop.fitness.values[:, 0]
        out[name] = {"ms_per_gen": ms, "card_eq_cpu": same,
                     "best": float(vals.min() if name == "EMNA"
                                   else vals.max())}
        if not same:
            fail(f"{name}: one generation differs card vs CPU")
    phase("EDA: EMNA and PBIL at lambda 4096 x 100", card_line,
          dim=EDA_DIM, lambda_=EDA_LAMBDA, mu=EDA_MU, generations=EDA_GENS,
          runs=out, launches=dict(kernels.LAUNCHES),
          seconds=time.perf_counter() - t0)


def migration_phase(kernels, card_line) -> None:
    """Phase 47: ``mig_ring_stacked`` over 8 islands of 131072 x 100
    (the best 1024 of each island replace the worst 1024 of the next),
    the default ring (a roll) and a non-cyclic ``migarray`` (a gather):
    card = CPU bit for bit, ms a call."""
    import torch
    from deap_tpu_torch import random
    from deap_tpu_torch.ops import migration, selection
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    key = random.fold_in(random.PRNGKey(0, device=dev), 47)
    k_g, k_w, k_m = random.split(key, 3)
    genome = random.uniform(k_g, (MIG_ISLANDS, MIG_POP, DIM))
    w = torch.floor(random.uniform(k_w, (MIG_ISLANDS, MIG_POP, 1))
                    * 1000.0)                         # ties
    g_cpu, w_cpu = genome.cpu(), w.cpu()
    out = {}
    kernels.reset_launches()
    for label, migarray in (("ring", None), ("non-cyclic", MIG_NONCYCLIC)):
        def call(g=genome, ww=w, k=k_m):
            return migration.mig_ring_stacked(
                k, g, ww, MIG_K, selection.sel_best, selection.sel_worst,
                migarray)
        card, slots = call()
        ms = _host_ms(call)
        host, hslots = call(g_cpu, w_cpu, k_m.cpu())
        same = (_same_tensors(card, host)
                and torch.equal(slots.cpu(), hslots))
        moved = int((card != genome).any(-1).sum())
        out[label] = {"ms": ms, "card_eq_cpu": same, "rows_changed": moved}
        if not same or moved == 0:
            fail(f"migration ({label}): card vs CPU {same}, rows changed "
                 f"{moved}")
        del card, host
    phase("migration: mig_ring_stacked, 8 islands of 131072 x 100",
          card_line, islands=MIG_ISLANDS, pop=MIG_POP, dim=DIM, k=MIG_K,
          runs=out, launches=dict(kernels.LAUNCHES),
          seconds=time.perf_counter() - t0)
    del genome, g_cpu
    torch.cuda.empty_cache()


def _lib_example_run(mod, name, dev):
    """``(result, final state)`` of one run of an example at its SMOKE
    arguments: ``result`` is what its ``main`` returns."""
    kw = LIB_EXAMPLE_ARGS.get(name, {})
    if name == "ga.onemax_multidemic":
        pops = mod.main(verbose=False, device=dev)
        return pops, pops
    if name == "de.sphere":
        pops = {v: mod.run(variant=v, device=dev, **kw)
                for v in mod.VARIANTS}
        return {v: float(p.fitness.values.min())
                for v, p in pops.items()}, pops
    state = mod.run(device=dev, **kw)
    if name == "de.basic":
        return float(state.fitness.values.min()), state
    if name in ("de.dynamic", "pso.multiswarm"):
        return state[1], state
    if name == "pso.basic":
        return -float(state.gbest_w), state
    if name == "eda.emna":
        return float(state[0].fitness.values.min()), state
    if name == "eda.pbil":
        return float(state[0].fitness.values.max()), state
    if name == "coev.coop_evol":
        return float(state[1].sum()), state
    return mod.best_host_failures(state[0]), state          # coev.hillis


def cpu_lib_examples() -> dict:
    """The CPU side of :func:`lib_examples_phase`: each example's result,
    final state and seconds."""
    import importlib
    import torch
    out = {}
    for name in LIB_EXAMPLES:
        mod = importlib.import_module(f"deap_tpu_torch.examples.{name}")
        t = time.perf_counter()
        result, state = _lib_example_run(mod, name, torch.device("cpu"))
        out[name] = (_flat_state(result), _flat_state(state),
                     time.perf_counter() - t)
    return out


def lib_examples_phase(kernels, card_line) -> dict:
    """Phase 48: the ten library examples at ``tests/test_examples.py``'s
    arguments on the card, each with that table's check, and card = CPU
    bit for bit on the final population or state of the same run (the
    CPU runs beside the card's, :class:`CpuSide`)."""
    import importlib
    import torch
    dev = torch.device("cuda")
    cpu_side = CpuSide("cpu_lib_examples")
    out, cards = {}, {}
    for name in LIB_EXAMPLES:
        mod = importlib.import_module(f"deap_tpu_torch.examples.{name}")
        kernels.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        result, card = _lib_example_run(mod, name, dev)
        torch.cuda.synchronize()
        cards[name] = (result, card, time.perf_counter() - t,
                       dict(kernels.LAUNCHES))
    hosts = cpu_side.result()
    for name in LIB_EXAMPLES:
        result, card, secs, launches = cards[name]
        host_result, host, cpu_secs = hosts[name]
        same = (_same_tensors(_flat_state(card), host)
                and _same_tensors(_flat_state(result), host_result))
        check = LIB_EXAMPLE_CHECKS.get(name, lambda r: True)(result)
        phase(f"library example: {name}", card_line, card_seconds=secs,
              cpu_seconds=cpu_secs, card_eq_cpu=same, smoke_check=check,
              result=_jsonable(result), launches=launches)
        if not (same and check):
            fail(f"example {name}: card = CPU {same}, its check {check}")
        out[name] = launches
    return out


def _flat_state(x):
    """A run's final state as nested lists of tensors, for
    ``_same_tensors``."""
    import dataclasses
    from deap_tpu_torch import base
    if isinstance(x, base.Population):
        return [x.genome, x.fitness.values, x.fitness.valid]
    if dataclasses.is_dataclass(x):
        return [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, dict):
        return {k: _flat_state(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [_flat_state(v) for v in x]
    return x


def _jsonable(r):
    if isinstance(r, dict):
        return {k: _jsonable(v) for k, v in r.items()}
    if isinstance(r, (int, float)):
        return r
    if isinstance(r, list):
        return {"last": r[-1], "count": len(r)}
    return {"best": float(r.fitness.values.max())}


def library_rest_phases(kernels, card_line) -> dict:
    """Phases 43-48 with each one's seconds; returns K2's launches on
    the checkpoint path and the examples' launch counts."""
    import torch
    torch.cuda.empty_cache()
    seconds = {}
    out = {}
    for label, fn in (("creator_checkpoint", creator_checkpoint_phase),
                      ("de", de_phase), ("pso", pso_phase),
                      ("eda", eda_phase), ("migration", migration_phase),
                      ("examples", lib_examples_phase)):
        t = time.perf_counter()
        out[label] = fn(kernels, card_line)
        seconds[label] = time.perf_counter() - t
    phase("the rest of the library: phase seconds", card_line,
          seconds=seconds, total_s=sum(seconds.values()))
    return out


# ---------------------------------------------------------------------------
# Phases 49-50: the last single-process examples and the streaming knobs
# ---------------------------------------------------------------------------

# the examples of phase 49 that equal the CPU bit for bit, each at its
# published width and a cut depth on both devices (coop_adapt adds its
# second species after 20 species-steps instead of 100, so that the cut
# run adds one); every example's tests/test_examples.py check runs in
# tier-1 (tests/test_torch_examples_rest_smoke.py)
REST_EXAMPLE_ARGS = {
    "ga.onemax": {"ngen": 10}, "ga.onemax_short": {"ngen": 10},
    "ga.knapsack": {"ngen": 10}, "ga.xkcd": {"ngen": 10},
    "ga.evosn": {"ngen": 5}, "ga.mo_rhv": {"ngen": 10},
    "es.onefifth": {"ngen": 50}, "es.cma_mo": {"ngen": 30},
    "pso.speciation": {"ngen": 20}, "coev.coop_gen": {"ngen": 20},
    "coev.coop_niche": {"ngen": 20},
    "coev.coop_adapt": {"ngen": 40, "adapt_length": 20},
    "coev.symbreg": {"ngen": 5}}
# the CMA-ES examples (eigh or a Cholesky factor a generation): the card's
# run at a cut depth (cma_bipop: its first regime's first 20 generations),
# one generation from its state on both devices within CMA_RTOL, and the
# CPU's own run for its time
REST_CMA_ARGS = {"es.cma_minfct": {"ngen": 20},
                 "es.cma_one_plus_lambda": {"ngen": 20},
                 "es.cma_plotting": {"ngen": 10}, "es.cma_bipop": {}}
REST_BIPOP_GENS = 20
SN_NETWORKS = 64
STREAM_NGEN, STREAM_EVERY = 7, 3


def _tensors(x):
    """Numpy arrays in a nested result as tensors, for
    ``_same_tensors``."""
    import numpy as np
    import torch
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    if isinstance(x, dict):
        return {k: _tensors(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [_tensors(v) for v in x]
    return x


def _plain(x):
    """A result as JSON values."""
    if hasattr(x, "tolist"):
        return x.tolist()
    if isinstance(x, (tuple, list)):
        return [_plain(v) for v in x]
    return x


def _rest_example_run(mod, name, dev):
    """``(result, final state)`` of one run of a phase-49 example at its
    ``REST_EXAMPLE_ARGS``."""
    kw = REST_EXAMPLE_ARGS[name]
    if name == "ga.onemax":
        pop, log, hof = mod.main(verbose=False, device=dev, **kw)
        return log.select("max"), [pop, hof.state.genome, hof.state.values]
    if name in ("ga.onemax_short", "ga.knapsack", "ga.xkcd"):
        pop = mod.main(verbose=False, device=dev, **kw)
        return float(pop.fitness.values[:, -1].max()), pop
    if name in ("ga.evosn", "ga.mo_rhv"):
        pop, result = mod.main(verbose=False, device=dev, **kw)
        return result, pop
    if name == "es.onefifth":
        state = mod.run(device=dev, **kw)
        return float(state[2]), state
    if name == "es.cma_mo":
        s = mod.run(device=dev, **kw)
        return mod.hypervolume_of(s), [s.parents, s.parent_values,
                                       s.sigmas, s.A, s.pc, s.psucc]
    if name == "pso.speciation":
        pos, spd, counts = mod.run(device=dev, **kw)
        return mod.minima_found(pos), [pos, spd, counts]
    if name == "coev.coop_niche":
        species, reps = mod.run(device=dev, **kw)
        return mod.coverage(reps), [species, reps]
    if name in ("coev.coop_gen", "coev.coop_adapt"):
        species, reps, targets = mod.run(device=dev, **kw)
        return float(mod.cb.match_set_strength(reps, targets)[0]), \
            [species, reps]
    carry, ga_curve, gp_curve = mod.run(device=dev, **kw)     # coev.symbreg
    return float(gp_curve[-1]), [carry, ga_curve, gp_curve]


def sortingnetwork_same(dev) -> bool:
    """``sortingnetwork``'s level assignment, network run and assessment
    on ``SN_NETWORKS`` random 6-wire networks of random lengths, card =
    CPU."""
    import torch
    from deap_tpu_torch import random
    from deap_tpu_torch.examples.ga import evosn, sortingnetwork as sn
    k_w, k_l = random.split(random.PRNGKey(17, device=dev))
    wires = random.randint(k_w, (SN_NETWORKS, evosn.CAP, 2), 0,
                           evosn.INPUTS)
    length = random.randint(k_l, (SN_NETWORKS,), 0, evosn.CAP + 1)
    cases = sn.all_binary_cases(evosn.INPUTS, dev)

    def model(w, n, c):
        levels, depth = sn.assign_levels(w, n, evosn.CAP, evosn.INPUTS)
        return [levels, depth, sn.assess(w, n, c, levels)]

    cpu = torch.device("cpu")
    return _same_tensors(model(wires, length, cases),
                         model(wires.to(cpu), length.to(cpu),
                               cases.to(cpu)))


def _root(state):
    """``B diag(diagD) Bᵀ``: the square root of C, unique whatever the
    eigenvectors' signs and rotations within an eigenspace."""
    return (state.B.double() * state.diagD.double()) @ state.B.double().T


def _cma_step_errs(strategy, state, nxt, nxt_cpu, genomes):
    """Each field of one CMA-ES generation card vs CPU (relative to its
    largest value); ``pc`` and ``C`` beyond ``hsig``'s margin."""
    errs = {"genome": _rel(*genomes)}
    fields = ["centroid", "sigma", "ps", "diagD"]
    if _hsig_margin(strategy, nxt_cpu) > CMA_HSIG_MARGIN:
        fields += ["pc", "C"]
    errs.update({f: _rel(getattr(nxt, f), getattr(nxt_cpu, f))
                 for f in fields})
    errs["sqrt_C"] = _rel(_root(nxt), _root(nxt_cpu))
    return errs


def _cma_teacher_forced(name, mod, s_card, s_cpu, tb_card, tb_cpu, state,
                        key):
    """One generation of a CMA-ES example's strategy from the card's
    ``state`` and ``key`` on both devices: the card's samples against
    the CPU's, then each device's update of the card's evaluated
    population."""
    import torch
    from deap_tpu_torch import base
    from deap_tpu_torch.algorithms import evaluate_population
    cpu = torch.device("cpu")
    g_card = s_card.generate(state, key)
    g_cpu = s_cpu.generate(_state_to(state, cpu), key.cpu())
    pop = base.Population(g_card, base.Fitness.empty(
        g_card.shape[0], (-1.0,), device=g_card.device))
    pop, _ = evaluate_population(tb_card, pop)
    nxt = s_card.update(state, pop)
    nxt_cpu = s_cpu.update(_state_to(state, cpu), base.Population(
        pop.genome.cpu(), base.Fitness(pop.fitness.values.cpu(),
                                       pop.fitness.valid.cpu(), (-1.0,))))
    if name == "es.cma_one_plus_lambda":
        errs = {"genome": _rel(g_card, g_cpu)}
        errs.update({f: _rel(getattr(nxt, f), getattr(nxt_cpu, f))
                     for f in ("parent", "sigma", "psucc", "pc", "C", "A")})
        return errs
    return _cma_step_errs(s_cpu, state, nxt, nxt_cpu, (g_card, g_cpu))


def _rest_cma_run(mod, name, dev):
    """The card's run of a CMA-ES example: ``(result, strategy on the
    card, on the CPU, their toolboxes, final state, a key)``."""
    import numpy as np
    import torch
    from deap_tpu_torch import base, benchmarks, random
    cpu = torch.device("cpu")
    kw = REST_CMA_ARGS[name]
    key = random.fold_in(random.PRNGKey(99, device=dev), 1)
    if name == "es.cma_minfct":
        pop, state = mod.run(device=dev, **kw)
        s, sc = mod.strategy_of(dev), mod.strategy_of(cpu)
        return (float(pop.fitness.values.min()), s, sc, mod.toolbox(s),
                mod.toolbox(sc), state, key)
    if name == "es.cma_one_plus_lambda":
        pop, state = mod.run(device=dev, **kw)
        s, sc = mod.strategy_of(device=dev), mod.strategy_of(device=cpu)
        return (float(pop.fitness.values.min()), s, sc, mod.toolbox(s),
                mod.toolbox(sc), state, key)
    if name == "es.cma_plotting":
        (state, fbest, _), tr = mod.run(device=dev, **kw)
        if not all(np.isfinite(v).all() for v in tr.values()):
            fail("cma_plotting: a trace is not finite")
        (s, tb), (sc, tbc) = mod.setup(dev), mod.setup(cpu)
        return float(fbest), s, sc, tb, tbc, state, key
    # es.cma_bipop: the first regime's first generations (its restarts
    # run thousands of generations)
    import math
    lam = 4 + int(3 * math.log(mod.N))
    rng = np.random.RandomState(12)
    k_run = random.split(random.PRNGKey(12, device=dev))[1]
    _, _, sigma, _ = mod.schedule(0, 0, [], [], rng, lam)
    centroid = rng.uniform(-4, 4, mod.N)
    s = mod.cma.Strategy(centroid=centroid, sigma=sigma, lambda_=lam,
                         device=dev)
    sc = mod.cma.Strategy(centroid=centroid, sigma=sigma, lambda_=lam,
                          device=cpu)
    tb, tbc = base.Toolbox(), base.Toolbox()
    tb.register("evaluate", benchmarks.rastrigin)
    tbc.register("evaluate", benchmarks.rastrigin)
    _, state, bests = mod.chunk(s, tb, k_run, s.init(), REST_BIPOP_GENS)
    tolx, cond = mod.stop_statistics(state)
    tolx_c, cond_c = mod.stop_statistics(_state_to(state, cpu))
    hist = bests.cpu().tolist()
    same_stop = (tolx == tolx_c and abs(cond - cond_c) <= CMA_RTOL * cond_c
                 and mod.regime_stops(hist, lam, tolx, cond)
                 == mod.regime_stops(hist, lam, tolx_c, cond_c))
    if not same_stop:
        fail(f"cma_bipop: the stopping test differs on the card: "
             f"{(tolx, cond)} vs {(tolx_c, cond_c)}")
    return float(bests.min()), s, sc, tb, tbc, state, key


def rest_examples_phase(kernels, card_line) -> dict:
    """Phase 49: the seventeen examples of this slice on the card and on
    the CPU; returns their launch counts."""
    import importlib
    import math
    import torch
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    out = {}
    for name in REST_EXAMPLE_ARGS:
        mod = importlib.import_module(f"deap_tpu_torch.examples.{name}")
        kernels.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        result, card = _rest_example_run(mod, name, dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = dict(kernels.LAUNCHES)
        t = time.perf_counter()
        host_result, host = _rest_example_run(mod, name, cpu)
        cpu_secs = time.perf_counter() - t
        same = (_same_tensors(_tensors(_flat_state(card)),
                              _tensors(_flat_state(host)))
                and _same_tensors(_tensors(result), _tensors(host_result)))
        extra = {}
        if name == "ga.evosn":
            extra["sortingnetwork_card_eq_cpu"] = sortingnetwork_same(dev)
            same = same and extra["sortingnetwork_card_eq_cpu"]
            if not launches["rows_dominate_counts"]:
                fail("evosn: rows_dominate_counts did not launch on its "
                     "3-objective sel_nsga2")
        phase(f"slice example: {name}", card_line, card_seconds=secs,
              cpu_seconds=cpu_secs, args=REST_EXAMPLE_ARGS[name],
              card_eq_cpu=same, result=_plain(result), launches=launches,
              **extra)
        if not same:
            fail(f"example {name}: the card's run differs from the CPU's")
        out[name] = launches
    for name in REST_CMA_ARGS:
        mod = importlib.import_module(f"deap_tpu_torch.examples.{name}")
        kernels.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        result, s, sc, tb, tbc, state, key = _rest_cma_run(mod, name, dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = dict(kernels.LAUNCHES)
        t = time.perf_counter()
        errs = _cma_teacher_forced(name, mod, s, sc, tb, tbc, state, key)
        step_secs = time.perf_counter() - t
        t = time.perf_counter()
        host_result = _rest_cma_run(mod, name, cpu)[0]
        cpu_secs = time.perf_counter() - t
        bad = {f: e for f, e in errs.items() if not e <= CMA_RTOL}
        phase(f"slice example: {name}", card_line, card_seconds=secs,
              cpu_seconds=cpu_secs, teacher_forced_seconds=step_secs,
              args=REST_CMA_ARGS[name] or {"ngen": REST_BIPOP_GENS},
              teacher_forced_rel_err=errs, rtol=CMA_RTOL, result=result,
              cpu_result=host_result, launches=launches)
        if bad or not math.isfinite(result):
            fail(f"example {name}: card vs CPU beyond tolerance {bad}, "
                 f"result {result}")
        out[name] = launches
    return out


def streaming_phase(card_line) -> None:
    """Phase 50: ``ea_simple`` on the card with ``stream_every`` in both
    modes on OneMax (examples/ga/onemax.py's toolbox and statistics):
    the lines and logbook equal the CPU run's, the trajectory and logbook
    equal the card's run without streaming."""
    import contextlib
    import io
    import torch
    from deap_tpu_torch.algorithms import ea_simple
    from deap_tpu_torch.examples.ga import onemax
    dev, cpu = torch.device("cuda"), torch.device("cpu")

    def run(d, **kw):
        key, pop = onemax.initial(42, device=d)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            pop, log = ea_simple(key, pop, onemax.toolbox(), 0.5, 0.2,
                                 STREAM_NGEN, stats=onemax.statistics(),
                                 **kw)
        return pop, list(log), buf.getvalue().splitlines()

    t0 = time.perf_counter()
    plain = run(dev)
    report = {}
    for mode in ("callback", "segmented"):
        card = run(dev, stream_every=STREAM_EVERY, stream_mode=mode)
        host = run(cpu, stream_every=STREAM_EVERY, stream_mode=mode)
        gens = [3, 6] + ([7] if mode == "segmented" else [])
        ok = (card[2] == host[2] and card[1] == host[1]
              and [ln.split("\t")[0] for ln in card[2]]
              == [f"gen={g}" for g in gens]
              and card[1] == plain[1] and not plain[2]
              and _same_tensors(_flat_state(card[0]), _flat_state(plain[0])))
        report[mode] = {"lines": card[2], "ok": ok}
        if not ok:
            fail(f"stream_mode={mode}: card {card[2]} vs CPU {host[2]}, "
                 "or the trajectory moved")
    phase("streaming: ea_simple stream_every=3, OneMax 300 x 100, 7 "
          "generations", card_line, modes=report,
          seconds=time.perf_counter() - t0)


def slice_rest_phases(kernels, card_line) -> dict:
    """Phases 49-50 with each one's seconds; returns the examples'
    launch counts."""
    import torch
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out = rest_examples_phase(kernels, card_line)
    seconds = {"examples": time.perf_counter() - t}
    t = time.perf_counter()
    streaming_phase(card_line)
    seconds["streaming"] = time.perf_counter() - t
    phase("the last examples and streaming: phase seconds", card_line,
          seconds=seconds, total_s=sum(seconds.values()))
    return out


# ---------------------------------------------------------------------------
# distribution (phases 51-53)
# ---------------------------------------------------------------------------

DIST_GENS = 2                     # the sharded flagship's generations
DIST_POOL = 2 * BN_POP            # bench_nsga2.py's pool at POP 1e5
DIST_K = BN_POP                   # the selection keeps POP of the pool
DIST_CHUNK = 256                  # sel_nsga2_sharded's default front_chunk
DIST_HV_RTOL = 1e-11              # K5's float64 bound (HV_RTOL)
DIST_SPLIT = POP // 2             # rank 1's row_base0 at R = 2
DIST_LIVE = POP - 4096            # the live prefix of the sharded K1 step
DIST_K5_RANGE = (3000, 4000)      # K5's prefix range (not 256-aligned)
#: onemax_sharded's width as published (4096 x 100), its generations and
#: onemax_multihost's cut from 40 to keep phases 51-53 within 90 s
DIST_EX_POP, DIST_EX_GEN = 4096, 20
#: ``ea_simple_islands`` with ``mesh=`` at R = 2: islands of
#: onemax_island's width (60 x 100, migration every 5 generations), two
#: migrations
DIST_ISL, DIST_ISL_GEN = 4, 10
DIST_TIMEOUT = 120.0              # every process group's collectives
#: the kernels on the sharded paths: K1, K2, K4, K5
DIST_KERNELS = ("megakernel_vary", "megakernel_gather_vary",
                "rows_dominate_counts", "hv3d_sweep")
DIST_DEADLINE = 300.0             # a rank launch, start to end


def _digest(t) -> str:
    """sha256 (16 hex digits) of a tensor's bytes: ranks compare shards by
    digest, not by moving the genome between processes."""
    import hashlib
    import torch
    t = t.detach().contiguous()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return hashlib.sha256(t.cpu().reshape(-1).view(torch.uint8).numpy()
                          .tobytes()).hexdigest()[:16]


def dist_flagship_toolbox():
    """The main path's toolbox (rastrigin, cx_two_point, mut_gaussian,
    rank-law tournament) on the megakernel engine."""
    from deap_tpu_torch import base, benchmarks
    from deap_tpu_torch.ops import crossover, mutation, selection
    tb = base.Toolbox()
    tb.register("evaluate", benchmarks.rastrigin)
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_gaussian, mu=MU, sigma=SIGMA,
                indpb=INDPB)
    tb.register("select", selection.sel_tournament, tournsize=3,
                tie_break="rank")
    tb.generation_engine = "megakernel"
    return tb


def _dist_rows(key, n: int, width: int, start: int, stop: int,
               lo: float = 0.0, hi: float = 1.0):
    """Rows ``[start, stop)`` of ``uniform(key, (n, width))``, drawn
    without the rest (``random.row_range``)."""
    from deap_tpu_torch import random
    with random.row_range((n, start, stop)):
        return random.uniform(key, (stop - start, width), minval=lo,
                              maxval=hi)


def dist_checks(mesh, ckpt_dir=None) -> dict:
    """The sharded checks every rank count runs, on this rank's block:
    the flagship ``ea_simple`` on the ``megakernel_sharded`` engine (1e6 x
    100, DIST_GENS generations: K2 at ``row_base0 = rank * n_loc``), one
    live-mask step (K1 at that ``row_base0``), the sharded checkpoint of
    the flagship (``ckpt_dir``), ``sel_nsga2_sharded`` on a DTLZ2 pool of
    2e5 points (``peel`` with both exchanges and ``grid``: K4) and
    ``hypervolume_sharded`` in float64 on it (K5 over this rank's
    slabs).  Returns digests, indices, the value, seconds and each
    part's launch counts."""
    import torch
    from deap_tpu_torch import base, kernels, random
    from deap_tpu_torch.algorithms import ea_simple, evaluate_population
    from deap_tpu_torch.ops import generation_sharded as GS
    from deap_tpu_torch.ops import hypervolume as H
    from deap_tpu_torch.parallel import ShardedPopulation, population_sharding
    from deap_tpu_torch.parallel import emo_sharded as E
    from deap_tpu_torch.utils import checkpoint as ck
    dev = mesh.device
    out = {"rank": mesh.rank, "size": mesh.size, "transport": mesh.transport,
           "seconds": {}, "launches": {}}

    def part(name, t):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["seconds"][name] = time.perf_counter() - t
        out["launches"][name] = {k: kernels.LAUNCHES[k]
                                 for k in DIST_KERNELS}

    t = time.perf_counter()
    sh = population_sharding(mesh, POP, 32)
    g = _dist_rows(random.PRNGKey(51, device=dev), POP, DIM, sh.start,
                   sh.stop, -5.12, 5.12)
    pop = ShardedPopulation(g, base.Fitness.empty(sh.rows, (-1.0,),
                                                  device=dev), mesh, POP, 32)
    tb = dist_flagship_toolbox()
    tb.generation_mesh = mesh
    kernels.reset_launches()
    final, _ = ea_simple(random.PRNGKey(52, device=dev), pop, tb, CXPB,
                         MUTPB, DIST_GENS)
    part("ea_simple megakernel_sharded", t)
    out["rows"] = (sh.start, sh.stop)
    out["flagship"] = (_digest(final.genome), _digest(final.fitness.values))
    out["flagship_finite"] = bool(torch.isfinite(final.genome).all()
                                  and torch.isfinite(final.fitness.values)
                                  .all())
    t = time.perf_counter()
    live = torch.arange(sh.start, sh.stop, device=dev) < DIST_LIVE
    kernels.reset_launches()
    _, stepped = GS.fused_ea_step_sharded(random.PRNGKey(53, device=dev),
                                          final, tb, CXPB, MUTPB, live=live)
    part("live-mask step", t)
    out["live"] = _digest(stepped.genome)
    del stepped, pop, g
    if ckpt_dir is not None:
        t = time.perf_counter()
        ck.save_sharded_checkpoint(ckpt_dir, {
            "key": random.PRNGKey(52, device=dev), "population": final})
        out["seconds"]["checkpoint save"] = time.perf_counter() - t
    del final
    torch.cuda.empty_cache()

    psh = population_sharding(mesh, DIST_POOL)
    tbm = bench_nsga2_toolbox("dtlz2")
    genome = _dist_rows(random.PRNGKey(54, device=dev), DIST_POOL,
                        BN_PROBLEMS["dtlz2"][1], psh.start, psh.stop)
    local = evaluate_population(tbm, base.Population(genome, base.Fitness.empty(
        psh.rows, (-1.0,) * 3, device=dev)))[0]
    out["sel"] = {}
    for ranks, ex in (("peel", "indices"), ("peel", "rows"),
                      ("grid", "indices")):
        t = time.perf_counter()
        kernels.reset_launches()
        idx = E.sel_nsga2_sharded(None, local.fitness, DIST_K, mesh,
                                  front_chunk=DIST_CHUNK, exchange=ex,
                                  ranks=ranks, n=DIST_POOL)
        part(f"sel_nsga2_sharded {ranks} {ex}", t)
        out["sel"][f"{ranks} {ex}"] = idx.to(torch.int64).cpu()
    t = time.perf_counter()
    kernels.reset_launches()
    hv = H.hypervolume_sharded(local.fitness.values.to(torch.float64),
                               HV_REF["dtlz2"], mesh, n=DIST_POOL)
    part("hypervolume_sharded float64", t)
    out["hv"] = float(hv)
    return out


def dist_examples(mesh) -> dict:
    """``onemax_sharded`` at its published width and ``onemax_multihost``'s
    run on this mesh, DIST_EX_GEN generations each: digests of the
    gathered final populations."""
    from deap_tpu_torch.examples.ga import onemax_multihost, onemax_sharded
    from deap_tpu_torch.parallel import fetch_global
    t = time.perf_counter()
    pop = fetch_global(onemax_sharded.main(
        seed=0, pop_size=DIST_EX_POP, ngen=DIST_EX_GEN, mesh=mesh,
        verbose=False))
    t1 = time.perf_counter()
    mh, log = onemax_multihost.run(ngen=DIST_EX_GEN,
                                   device=str(mesh.device))
    return {"onemax_sharded": (_digest(pop.genome),
                               _digest(pop.fitness.values)),
            "onemax_multihost": (_digest(mh.genome),
                                 _digest(mh.fitness.values),
                                 float(mh.fitness.values.max())),
            "seconds": {"onemax_sharded": t1 - t,
                        "onemax_multihost": time.perf_counter() - t1}}


def dist_islands(mesh) -> dict:
    """``ea_simple_islands`` on DIST_ISL islands of ``onemax_island``'s
    width and toolbox, DIST_ISL_GEN generations: with ``mesh=`` (this rank
    holds DIST_ISL / R islands; the ring's cross-rank leg is
    ``batch_isend_irecv``) and on this rank's device alone (``mesh=None``).
    Digests of the gathered islands and of the per-island evaluation
    counts of each run, and its seconds."""
    import torch
    from deap_tpu_torch import base, random
    from deap_tpu_torch.examples.ga import onemax_island as OI
    from deap_tpu_torch.parallel import collectives, ea_simple_islands
    dev = mesh.device
    key, k_init = random.split(random.PRNGKey(57, device=dev))
    g = random.bernoulli(k_init, 0.5, (DIST_ISL, OI.POP, OI.N_BITS)).to(
        torch.float32)
    pops = base.Population(g, base.Fitness(
        torch.zeros((DIST_ISL, OI.POP, 1), device=dev),
        torch.zeros((DIST_ISL, OI.POP), dtype=torch.bool, device=dev),
        (1.0,)))
    out = {"seconds": {}}
    for name, m in (("mesh", mesh), ("one device", None)):
        t = time.perf_counter()
        res, recs = ea_simple_islands(key, pops, OI.toolbox(), 0.5, 0.2,
                                      DIST_ISL_GEN, mig_freq=OI.MIG_FREQ,
                                      mig_k=5, mesh=m)
        genome, values = res.genome, res.fitness.values
        if m is not None:
            genome = collectives.all_gather(genome.contiguous(), mesh)
            values = collectives.all_gather(values.contiguous(), mesh)
        out[name] = (_digest(genome), _digest(values),
                     _digest(torch.as_tensor(recs["nevals"])))
        out["seconds"][name] = time.perf_counter() - t
    out["best"] = float(values.max())
    return out


def dist_rank_main(mesh, ckpt_dir=None, examples: bool = True) -> dict:
    """What one rank of a launched pair (or quartet) runs: the checks, the
    examples and the mesh form of ``ea_simple_islands``, and the rank's
    device."""
    import torch
    out = dist_checks(mesh, ckpt_dir)
    if examples:
        out["examples"] = dist_examples(mesh)
        out["islands"] = dist_islands(mesh)
    out["device"] = str(mesh.device)
    out["device_name"] = torch.cuda.get_device_name(mesh.device)
    return out


def _dist_reference(kernels, card_line) -> dict:
    """The single-device runs the sharded ones must equal: the flagship
    on the megakernel engine, its live-mask step, ``sel_nsga2`` on the
    pool and ``hypervolume_device`` on it; then K2 and K1 at
    ``row_base0 = DIST_SPLIT`` and K5 over ``DIST_K5_RANGE`` against their
    plain versions."""
    import torch
    from deap_tpu_torch import base, random
    from deap_tpu_torch.algorithms import ea_simple, evaluate_population
    from deap_tpu_torch.ops import emo
    from deap_tpu_torch.ops import generation as G
    from deap_tpu_torch.ops import hypervolume as H
    from deap_tpu_torch.ops import selection
    dev = torch.device("cuda")
    ref = {}
    g = random.uniform(random.PRNGKey(51, device=dev), (POP, DIM),
                       minval=-5.12, maxval=5.12)
    tb = dist_flagship_toolbox()
    final, _ = ea_simple(random.PRNGKey(52, device=dev), base.Population(
        g, base.Fitness.empty(POP, (-1.0,), device=dev)), tb, CXPB, MUTPB,
        DIST_GENS)
    live = torch.arange(POP, device=dev) < DIST_LIVE
    _, stepped = G.fused_ea_step(random.PRNGKey(53, device=dev), final, tb,
                                 CXPB, MUTPB, live=live)
    ref["genome"], ref["values"] = final.genome, final.fitness.values
    ref["live"] = stepped.genome

    # K2 / K1 at row_base0 = DIST_SPLIT against their plain versions and
    # against the same rows of a launch from row 0
    order = base.lex_sort_indices(final.fitness.masked_wvalues()).to(
        torch.int32)
    k_sel, k_var = random.split(random.PRNGKey(55, device=dev))
    pos = selection.tournament_positions(k_sel, POP, POP, 3)
    seed = G._seed_from_key(k_var)
    knobs = torch.tensor([CXPB, MUTPB, MU, SIGMA, INDPB], device=dev)
    st = G.GenomeStorage("float32")
    lo = DIST_SPLIT
    whole, widx = kernels.launch_gather_vary(
        order, pos, final.genome, seed, knobs, dim=DIM, dtype="float32",
        scale=1.0)
    k2, w2 = kernels.launch_gather_vary(
        order, pos[lo:].contiguous(), final.genome, seed, knobs, dim=DIM,
        dtype="float32", scale=1.0, row_base0=lo)
    p2, pw = G._gather_vary_plain(order, pos[lo:], final.genome, seed,
                                  knobs, DIM, st, row_base0=lo)
    parents = final.genome.index_select(0, widx[lo:].long()).contiguous()
    k1 = kernels.launch_vary(parents, seed, knobs, dim=DIM, dtype="float32",
                             scale=1.0, row_base0=lo)
    p1 = G._vary_tile_plain(parents, seed, knobs, DIM, lo)
    torch.cuda.synchronize()
    k2_ok = (torch.equal(k2.view(torch.int32), p2.view(torch.int32))
             and torch.equal(w2, pw.to(w2.dtype))
             and torch.equal(k2.view(torch.int32),
                             whole[lo:].view(torch.int32)))
    k1_ok = (torch.equal(k1.view(torch.int32), p1.view(torch.int32))
             and torch.equal(k1.view(torch.int32),
                             whole[lo:].view(torch.int32)))
    ms2 = cuda_ms(lambda: kernels.launch_gather_vary(
        order, pos[lo:].contiguous(), final.genome, seed, knobs, dim=DIM,
        dtype="float32", scale=1.0, row_base0=lo), reps=5)
    ms1 = cuda_ms(lambda: kernels.launch_vary(
        parents, seed, knobs, dim=DIM, dtype="float32", scale=1.0,
        row_base0=lo), reps=5)
    phase("K2 / K1 at row_base0 != 0 vs plain", card_line,
          row_base0=lo, rows=POP - lo, dim=DIM, k2_bitwise=k2_ok,
          k1_bitwise=k1_ok, k2_ms=ms2, k1_ms=ms1)
    if not (k2_ok and k1_ok):
        fail(f"K2 / K1 at row_base0 {lo} differ from their plain versions "
             f"or from a launch at row 0 (K2 {k2_ok}, K1 {k1_ok})")
    ref["k12"] = {"row_base0": lo, "k2_ms": ms2, "k1_ms": ms1}
    del whole, k2, p2, k1, p1, parents, pos, order, g, stepped
    torch.cuda.empty_cache()

    # K5 over a prefix range that starts inside a group of 256
    k_begin, count = DIST_K5_RANGE
    pts = random.uniform(random.PRNGKey(56, device=dev), (HV_UNIFORM_N, 3))
    k5 = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[1]
        p = pts.to(dtype)
        clipped, r = H._as_points(p, (1.0, 1.0, 1.0))
        part_k = H._hv3d_cuda_partials(clipped, r, 1.0, 128, k_begin, count)
        part_p = H._slab_volumes(p, (1.0, 1.0, 1.0), 128, k_begin, count)
        whole_k = H._hv3d_cuda_partials(clipped, r, 1.0, 128)
        torch.cuda.synchronize()
        scale = float(part_p.double().sum().abs())
        rel = float((part_k.double() - part_p.double()).abs().max()) / scale
        # the range's partials are the whole launch's when it starts on a
        # partial's boundary: compare the sums of the overlap instead
        rel_sum = abs(float(part_k.double().sum())
                      - float(part_p.double().sum())) / scale
        bound = HV_RTOL[name]
        k5[name] = {"rel_parts": rel, "rel_sum": rel_sum, "bound": bound,
                    "whole_partials": int(whole_k.numel())}
        if not (rel <= bound and rel_sum <= bound):
            fail(f"K5 {name} over prefixes ({k_begin}, {k_begin + count}]: "
                 f"{rel:.3g} / {rel_sum:.3g} from the plain slabs "
                 f"(bound {bound})")
    phase("K5 hv3d_sweep at k_begin != 0 vs plain", card_line,
          n=HV_UNIFORM_N, k_begin=k_begin, count=count, **k5)

    # the pool: single-device selection and hypervolume
    tbm = bench_nsga2_toolbox("dtlz2")
    genome = random.uniform(random.PRNGKey(54, device=dev),
                            (DIST_POOL, BN_PROBLEMS["dtlz2"][1]))
    pool = evaluate_population(tbm, base.Population(genome, base.Fitness.empty(
        DIST_POOL, (-1.0,) * 3, device=dev)))[0]
    ref["sel"] = emo.sel_nsga2(None, pool.fitness, DIST_K, nd="peel",
                               front_chunk=FRONT_CHUNK).to(torch.int64).cpu()
    ref["hv"] = float(H.hypervolume_device(
        pool.fitness.values.to(torch.float64), HV_REF["dtlz2"]))
    return ref


def _check_dist(label: str, res: dict, ref: dict) -> dict:
    """One rank's results against the single-device references."""
    import torch
    lo, hi = res["rows"]
    want = (_digest(ref["genome"][lo:hi]), _digest(ref["values"][lo:hi]))
    checks = {
        "flagship bitwise": res["flagship"] == want,
        "flagship finite": res["flagship_finite"],
        "live step bitwise": res["live"] == _digest(ref["live"][lo:hi]),
        **{f"sel {k} = sel_nsga2": torch.equal(v, ref["sel"])
           for k, v in res["sel"].items()},
        "hv float64 within 1e-11 of hypervolume_device":
            abs(res["hv"] - ref["hv"]) <= DIST_HV_RTOL * abs(ref["hv"])}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"{label}, rank {res['rank']}: {bad}")
    return checks


def _require_dist_launches(label: str, res: dict) -> None:
    """Each sharded path of one rank's run launched its kernel: K2 on the
    flagship, K1 on the live-mask step, K4 on every sharded selection
    (both peel exchanges and the grid), K5 on the sharded hypervolume."""
    need = [("megakernel_gather_vary", "ea_simple megakernel_sharded"),
            ("megakernel_vary", "live-mask step"),
            ("hv3d_sweep", "hypervolume_sharded float64")]
    need += [("rows_dominate_counts", path) for path in res["launches"]
             if path.startswith("sel_nsga2_sharded")]
    if len(need) != 6:
        fail(f"{label}: paths {sorted(res['launches'])}")
    missing = [f"{kern} on {path}" for kern, path in need
               if not res["launches"][path][kern]]
    if missing:
        fail(f"{label}, rank {res['rank']}: no launch of {missing}")


def _launches_of(res: dict, kernel: str) -> dict:
    return {k: v[kernel] for k, v in res["launches"].items() if v[kernel]}


def distribution_phases(kernels, card_line) -> dict:
    """Phases 51-53: the sharded paths at R = 1 over NCCL in this process,
    R = 2 on the one card over gloo (a pair of rank processes, CUDA
    tensors staged through host memory), and R = min(4, cards) over NCCL
    where there are two cards or more.  Returns each run's launch counts
    by path for the kernels line."""
    import shutil
    import socket
    import torch
    import torch.distributed as dist
    from deap_tpu_torch.examples.ga import onemax_island
    from deap_tpu_torch.parallel import (default_mesh, initialize_cluster,
                                         launch)
    from deap_tpu_torch.utils import checkpoint as ck
    t_all = time.perf_counter()
    out_dir = os.path.join(ROOT, "chip_smoke_out", "dist")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir, exist_ok=True)

    # ---- 51. R = 1 over NCCL ------------------------------------------------
    t = time.perf_counter()
    torch.cuda.empty_cache()
    ref = _dist_reference(kernels, card_line)
    t_ref = time.perf_counter() - t
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t = time.perf_counter()
    initialize_cluster(backend="nccl", init_method=f"tcp://127.0.0.1:{port}",
                       num_processes=1, process_id=0, timeout=DIST_TIMEOUT)
    mesh = default_mesh(device="cuda", timeout=DIST_TIMEOUT)
    t_init = time.perf_counter() - t
    r1_ckpt = os.path.join(out_dir, "ckpt_r1")
    r1 = dist_checks(mesh, r1_ckpt)
    checks1 = _check_dist("R = 1", r1, ref)
    # the checkpoint saved at R = 1, loaded at R = 1
    t = time.perf_counter()
    like = {"key": torch.zeros(2, dtype=torch.int64, device="cuda"),
            "population": _dist_like(mesh)}
    back = ck.load_sharded_checkpoint(r1_ckpt, like)
    ck1 = (_digest(back["population"].genome) == _digest(ref["genome"])
           and _digest(back["population"].fitness.values)
           == _digest(ref["values"]))
    t_ck = time.perf_counter() - t
    del back
    if not ck1:
        fail("the sharded checkpoint saved and loaded at R = 1 is not the "
             "flagship population bit for bit")
    phase("distribution R = 1", card_line, backend="nccl", R=1,
          transport=r1["transport"], checks=checks1, checkpoint_bitwise=ck1,
          seconds={**r1["seconds"], "references": t_ref,
                   "process group": t_init, "checkpoint load": t_ck},
          launches=r1["launches"], hv=r1["hv"], hv_device=ref["hv"])
    _require_dist_launches("R = 1", r1)

    # ---- 52. R = 2 on one card over gloo ----------------------------------
    # the card pair, and the CPU side of the examples (a CPU pair, then
    # onemax_island on the CPU), run in threads while this thread runs
    # onemax_island on the card: the threads wait on processes
    import threading
    side: dict = {}

    def card_pair():
        t0 = time.perf_counter()
        side["r2"] = launch.run_ranks(
            "chip_smoke:dist_rank_main", 2, backend="gloo", device="cuda",
            kwargs={"ckpt_dir": os.path.join(out_dir, "ckpt_r2")},
            timeout=DIST_TIMEOUT, deadline=DIST_DEADLINE,
            workdir=os.path.join(out_dir, "r2"))
        side["r2_s"] = time.perf_counter() - t0

    def cpu_side():
        t0 = time.perf_counter()
        side["cpu2"] = launch.run_ranks(
            "chip_smoke:dist_examples", 2, backend="gloo", device="cpu",
            timeout=DIST_TIMEOUT, deadline=DIST_DEADLINE, threads=2,
            workdir=os.path.join(out_dir, "cpu2"))
        side["cpu2_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        side["island_cpu"] = onemax_island.main(seed=0, device="cpu",
                                                verbose=False)
        side["island_cpu_s"] = time.perf_counter() - t0

    def guarded(fn, name):
        def run():
            try:
                fn()
            except BaseException as e:      # noqa: BLE001 — re-raised below
                side[f"error {name}"] = e
        return threading.Thread(target=run, daemon=True)

    workers = [guarded(card_pair, "card pair"), guarded(cpu_side, "cpu side")]
    for w in workers:
        w.start()
    t = time.perf_counter()
    try:
        isl_card = onemax_island.main(seed=0, device="cuda", verbose=False)
        t_isl = time.perf_counter() - t
    finally:                    # the threads' rank processes end first
        for w in workers:
            w.join(DIST_DEADLINE)
    errors = {k: v for k, v in side.items() if k.startswith("error")}
    if errors or any(w.is_alive() for w in workers):
        fail(f"the R = 2 runs: {errors or 'still running'}")
    r2, t_r2 = side["r2"], side["r2_s"]
    r2_ckpt = os.path.join(out_dir, "ckpt_r2")
    checks2 = [_check_dist("R = 2", r, ref) for r in r2]
    if r2[1]["rows"][0] != DIST_SPLIT:
        fail(f"R = 2: rank 1 starts at row {r2[1]['rows'][0]}, not "
             f"{DIST_SPLIT}")
    for r in r2:
        _require_dist_launches("R = 2", r)
    # the checkpoint saved at R = 2, loaded at R = 1
    back = ck.load_sharded_checkpoint(r2_ckpt, like)
    ck2 = _digest(back["population"].genome) == _digest(ref["genome"])
    del back
    if not ck2:
        fail("the checkpoint saved at R = 2 does not load at R = 1 as the "
             "flagship population bit for bit")
    # the examples: card R = 2 against the CPU at R = 2, and onemax_island
    # as published card against CPU
    cpu2 = side["cpu2"]
    isl = [isl_card, side["island_cpu"]]
    ex = {name: all(r["examples"][name][:2] == c[name][:2]
                    for r in r2 for c in cpu2)
          for name in ("onemax_sharded", "onemax_multihost")}
    ex["onemax_island"] = (torch.equal(isl[0].genome.cpu(), isl[1].genome)
                           and torch.equal(isl[0].fitness.values.cpu(),
                                           isl[1].fitness.values))
    # ea_simple_islands with mesh= at R = 2 against mesh=None, on each rank
    islands_mesh = all(r["islands"]["mesh"] == r["islands"]["one device"]
                       == r2[0]["islands"]["one device"] for r in r2)
    best = {"onemax_multihost": r2[0]["examples"]["onemax_multihost"][2],
            "onemax_island": float(isl[1].fitness.values.max())}
    phase("distribution R = 2 on one card", card_line, backend="gloo", R=2,
          transport=r2[0]["transport"],
          note="gloo's staged times say nothing of NCCL's",
          devices=[r["device"] for r in r2], checks=checks2,
          checkpoint_r2_to_r1_bitwise=ck2, examples_card_eq_cpu=ex,
          islands_mesh_eq_one_device=islands_mesh,
          islands={"islands": DIST_ISL, "generations": DIST_ISL_GEN,
                   "best": r2[0]["islands"]["best"]},
          best=best, rank_rows=[r["rows"] for r in r2],
          seconds={"launch and run": t_r2,
                   **{f"rank {r['rank']}": r["seconds"] for r in r2},
                   "examples, rank 0": r2[0]["examples"]["seconds"],
                   "ea_simple_islands, rank 0": r2[0]["islands"]["seconds"],
                   "cpu pair (beside the card pair)": side["cpu2_s"],
                   "onemax_island cpu (after the cpu pair)":
                       side["island_cpu_s"],
                   "onemax_island card (beside both)": t_isl},
          launches={f"rank {r['rank']}": r["launches"] for r in r2})
    if not all(ex.values()):
        fail(f"distributed examples: card != CPU: {ex}")
    if not islands_mesh:
        fail("ea_simple_islands with mesh= at R = 2 differs from mesh=None: "
             f"{[r['islands'] for r in r2]}")

    # ---- 53. R = min(4, cards) over NCCL -------------------------------------
    cards = torch.cuda.device_count()
    r4 = []
    if cards >= 2:
        R = min(4, cards)
        t = time.perf_counter()
        r4 = launch.run_ranks("chip_smoke:dist_rank_main", R,
                              backend="nccl", device="cuda",
                              kwargs={"examples": False},
                              timeout=DIST_TIMEOUT, deadline=DIST_DEADLINE,
                              workdir=os.path.join(out_dir, f"r{R}"))
        checks4 = [_check_dist(f"R = {R}", r, ref) for r in r4]
        for r in r4:
            _require_dist_launches(f"R = {R}", r)
        phase(f"distribution R = {R} over NCCL", card_line, backend="nccl",
              R=R, transport="nccl", checks=checks4,
              devices=[r["device"] for r in r4],
              seconds={"launch and run": time.perf_counter() - t},
              launches={f"rank {r['rank']}": r["launches"] for r in r4})
    else:
        phase("distribution R = min(4, cards) over NCCL: not run",
              card_line, cards=cards,
              reason="this host has one card; NCCL refuses two ranks on one "
                     "card (Duplicate GPU detected), so R = 2 ran over gloo "
                     "above")

    dist.destroy_process_group()
    shutil.rmtree(out_dir, ignore_errors=True)
    phase("distribution: phase seconds", card_line,
          total_s=time.perf_counter() - t_all)
    return {"r1": r1, "r2": r2, "r4": r4}


def dist_launches_by_path(dist_runs: dict, kernel: str) -> dict:
    """``kernel``'s launches on each sharded path of phases 51-53, by
    rank count, transport and rank."""
    out = {}
    runs = [("R = 1, nccl", [dist_runs["r1"]])]
    runs.append(("R = 2, gloo staged", dist_runs["r2"]))
    if dist_runs["r4"]:
        runs.append((f"R = {len(dist_runs['r4'])}, nccl", dist_runs["r4"]))
    for label, ranks in runs:
        for r in ranks:
            for path, n in _launches_of(r, kernel).items():
                out[f"{path}, {label}, rank {r['rank']}"] = n
    return out


def _dist_like(mesh):
    """A ShardedPopulation of the flagship's layout on ``mesh``, the
    target of a sharded checkpoint load (its values are not read)."""
    import torch
    from deap_tpu_torch import base
    from deap_tpu_torch.parallel import ShardedPopulation, population_sharding
    sh = population_sharding(mesh, POP, 32)
    return ShardedPopulation(
        torch.empty((sh.rows, DIM), device=mesh.device),
        base.Fitness.empty(sh.rows, (-1.0,), device=mesh.device), mesh, POP,
        32)


# ---------------------------------------------------------------------------
# 54. out-of-core: the streamed engine (deap_tpu_torch.bigpop)
# ---------------------------------------------------------------------------

# tools/bench_ooc.py's largest population and its slice, and the largest
# population it compares with the resident step
OOC_POP, OOC_SLICE = 2_097_152, 8192
OOC_MID = 262_144
OOC_NGEN = 2
OOC_CPU_POP, OOC_CPU_SLICE = 4096, 1024
#: device bytes a population row and a gene of one slice program may
#: hold at once: 16 int64 words each (ooc_peak_bound)
OOC_ROW_BYTES = OOC_GENE_BYTES = 16 * 8


def ooc_toolbox(mate: str = "two_point", mutate: str = "gauss",
                storage=None, evaluate=None):
    """``tools/bench_ooc.py``'s flagship toolbox (rastrigin,
    ``cx_two_point``, ``mut_gaussian(0, 0.3, 0.05)``, rank tournaments of
    3), or its operators swapped for the storage legs."""
    from deap_tpu_torch import base, benchmarks
    from deap_tpu_torch.ops import crossover, mutation, selection
    tb = base.Toolbox()
    tb.register("evaluate", evaluate or benchmarks.rastrigin)
    if mate == "two_point":
        tb.register("mate", crossover.cx_two_point)
    elif mate == "one_point":
        tb.register("mate", crossover.cx_one_point)
    else:
        tb.register("mate", crossover.cx_uniform, indpb=0.4)
    if mutate == "gauss":
        tb.register("mutate", mutation.mut_gaussian, mu=0.0, sigma=0.3,
                    indpb=0.05)
    else:
        tb.register("mutate", mutation.mut_flip_bit, indpb=0.05)
    tb.register("select", selection.sel_tournament, tournsize=3,
                tie_break="rank")
    if storage is not None:
        tb.genome_storage = storage
    return tb


def ooc_population(key, n: int, tb, dev):
    """An evaluated population of ``n`` rows in the toolbox's storage,
    genes uniform in [-5.12, 5.12)."""
    from deap_tpu_torch import base, random
    from deap_tpu_torch.algorithms import evaluate_population
    from deap_tpu_torch.ops.generation import storage_of
    g = random.uniform(key.to(dev), (n, DIM), minval=-5.12, maxval=5.12)
    st = storage_of(tb)
    if st is not None:
        g = st.to_storage(g)
    pop, _ = evaluate_population(tb, base.Population(
        g, base.Fitness.empty(n, (-1.0,), device=dev)))
    return pop


def same_population(a, b) -> bool:
    """Genome, values and validity equal bit for bit (on the host)."""
    import torch
    a_g, b_g = a.genome.cpu(), b.genome.cpu()
    return (a_g.dtype == b_g.dtype and a_g.shape == b_g.shape
            and torch.equal(a_g.view(torch.uint8), b_g.view(torch.uint8))
            and torch.equal(a.fitness.values.cpu().view(torch.int32),
                            b.fitness.values.cpu().view(torch.int32))
            and torch.equal(a.fitness.valid.cpu(), b.fitness.valid.cpu()))


def ooc_peak_bound(n: int, dim: int, slice_rows: int, elt: int,
                   nobj: int = 1) -> int:
    """The most device bytes a streamed generation may hold, from its
    shapes alone: the plan's O(pop) tensors at 16 int64 words a row (the
    fitness table, the winners, the threefry words and temporaries of a
    population-wide draw, the sort's keys, indices and buffers, the row
    masks), one slice program's temporaries at 16 int64 words a gene (a
    sliced draw's counters, words and temporaries, the float64 FMA), and
    the staging ring: three parent slices on the way up, three child
    slices and their values on the way down."""
    return (OOC_ROW_BYTES * n + OOC_GENE_BYTES * slice_rows * dim
            + 6 * slice_rows * dim * elt + 3 * slice_rows * nobj * 4)


def _ooc_step_pair(tb, pop, key, live=None):
    """One generation resident and streamed from the same population and
    key: ``(equal, nevals, resident s, streamed s)``."""
    import torch
    from deap_tpu_torch.algorithms import ea_step
    from deap_tpu_torch.bigpop import streamed_ea_step
    torch.cuda.synchronize()
    t = time.perf_counter()
    kr, ref, nr = ea_step(key, pop, tb, CXPB, MUTPB, live=live)
    torch.cuda.synchronize()
    t_res = time.perf_counter() - t
    t = time.perf_counter()
    ks, got, ns = streamed_ea_step(key, pop, tb, CXPB, MUTPB, live=live,
                                   slice_rows=OOC_SLICE)
    torch.cuda.synchronize()
    t_str = time.perf_counter() - t
    same = (same_population(ref, got) and torch.equal(kr, ks)
            and int(nr) == ns)
    return same, ns, t_res, t_str


def out_of_core_phases(kernels, card_line, dev) -> dict:
    """Phase 54: the streamed engine at bench_ooc.py's widths on ``dev``
    (the card), each leg bit for bit against the resident step (module
    docstring).  Returns its seconds by leg."""
    import torch
    from deap_tpu_torch import base, random
    from deap_tpu_torch.algorithms import ea_simple, ea_step
    from deap_tpu_torch.bigpop import (HostPopulation, StreamedEngine,
                                       run_streamed_resumable,
                                       streamed_ea_step)
    from deap_tpu_torch.ops.generation import GenomeStorage
    from deap_tpu_torch.resilience import FaultInjector, FaultPlan, Preempted
    from deap_tpu_torch.utils.support import HallOfFame, Statistics
    t_all = time.perf_counter()
    seconds = {}
    keys = random.split(random.fold_in(random.PRNGKey(0, device=dev), 54), 8)
    kernels.reset_launches()

    # ---- (a) 2,097,152 x 100 float32, slices of 8192 ------------------------
    t_leg = t = time.perf_counter()
    tb = ooc_toolbox()
    pop = ooc_population(keys[0], OOC_POP, tb, dev)
    host = HostPopulation.from_population(pop, tb)
    t_setup = time.perf_counter() - t
    torch.cuda.synchronize()
    t = time.perf_counter()
    k_ref, ref, n_ref = ea_step(keys[1], pop, tb, CXPB, MUTPB)
    torch.cuda.synchronize()
    t_res = time.perf_counter() - t
    ref = (k_ref.cpu(), ref.genome.cpu(), ref.fitness.values.cpu(),
           ref.fitness.valid.cpu(), int(n_ref))
    del pop, k_ref, n_ref
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = StreamedEngine(tb, host, slice_rows=OOC_SLICE, device=dev)
    t = time.perf_counter()
    k_got, n_got = eng.step(keys[1], CXPB, MUTPB)
    torch.cuda.synchronize()
    t_str = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() - base_bytes
    got = host.to_population("cpu")
    same = (torch.equal(k_got.cpu(), ref[0])
            and torch.equal(got.genome.view(torch.int32),
                            ref[1].view(torch.int32))
            and torch.equal(got.fitness.values.view(torch.int32),
                            ref[2].view(torch.int32))
            and torch.equal(got.fitness.valid, ref[3]) and n_got == ref[4])
    bound = ooc_peak_bound(OOC_POP, DIM, OOC_SLICE, 4)
    genome_bytes = host.genome_nbytes
    phase("out-of-core (a): one generation streamed vs resident", card_line,
          pop=OOC_POP, dim=DIM, slice_rows=OOC_SLICE, slices=eng.n_slices,
          nevals=n_got, bitwise_equal=same, resident_s=t_res,
          streamed_s=t_str, setup_s=t_setup,
          split_s={k: v for k, v in eng.timings.items()
                   if k != "compute_span_ms"},
          compute_span_ms=eng.timings["compute_span_ms"],
          peak_device_bytes=peak, peak_bound_bytes=bound,
          genome_bytes=genome_bytes, peak_share_of_genome=peak / genome_bytes,
          bound_by="16 int64 words a row (plan) + 16 a gene of one slice "
                   "+ 6 staged slices")
    if not same:
        fail("out-of-core (a): the streamed generation differs from the "
             "resident one")
    if not peak <= bound < genome_bytes:
        fail(f"out-of-core (a): peak device bytes {peak} over the bound "
             f"{bound} (genome {genome_bytes})")
    seconds["a"] = time.perf_counter() - t_leg
    del host, eng, got, ref
    torch.cuda.empty_cache()

    # ---- (b) storage dtypes, live mask, tails at 262,144 x 100 --------------
    t = time.perf_counter()
    legs = {
        "int8 cx_uniform + mut_flip_bit": ooc_toolbox(
            "uniform", "flip", GenomeStorage("int8", 1.0)),
        "bfloat16 cx_one_point + mut_gaussian": ooc_toolbox(
            "one_point", "gauss", GenomeStorage("bfloat16")),
        "odd pop, a 1-row tail slice": ooc_toolbox(),
        "a 2-row tail slice": ooc_toolbox(),
    }
    sizes = {"odd pop, a 1-row tail slice": OOC_MID + 1,
             "a 2-row tail slice": OOC_MID + 2}
    results = {}
    for i, (name, tbl) in enumerate(legs.items()):
        n = sizes.get(name, OOC_MID)
        pop = ooc_population(keys[2], n, tbl, dev)
        same, nev, t_r, t_s = _ooc_step_pair(tbl, pop, random.fold_in(
            keys[3], i))
        results[name] = same
        phase("out-of-core (b): one generation streamed vs resident",
              card_line, leg=name, pop=n, dim=DIM, slice_rows=OOC_SLICE,
              tail_rows=n % OOC_SLICE, nevals=nev, bitwise_equal=same,
              resident_s=t_r, streamed_s=t_s)
        del pop
    # the live mask through the engine's ask and tell halves
    tbl = ooc_toolbox()
    pop = ooc_population(keys[2], OOC_MID, tbl, dev)
    live_n = OOC_MID - 1000
    live = torch.arange(OOC_MID, device=dev) < live_n
    k_r, ref, n_r = ea_step(keys[4], pop, tbl, CXPB, MUTPB, live=live)
    host = HostPopulation.from_population(pop, tbl)
    eng = StreamedEngine(tbl, host, slice_rows=OOC_SLICE, device=dev)
    k_s, pending = eng.ask(keys[4], CXPB, MUTPB, live_n=live_n)
    n_s = eng.tell(pending)
    same = (same_population(ref, host.to_population(dev))
            and torch.equal(k_r, k_s) and int(n_r) == n_s)
    results["live mask, ask + tell"] = same
    phase("out-of-core (b): live-mask ask / tell vs resident ea_step",
          card_line, pop=OOC_MID, live=live_n, nevals=n_s,
          bitwise_equal=same)
    del pop, ref, host, eng, pending
    seconds["b"] = time.perf_counter() - t
    if not all(results.values()):
        fail(f"out-of-core (b): streamed differs from resident: {results}")

    # ---- (c) ea_simple on the streamed engine, OOC_NGEN generations ---------
    t = time.perf_counter()
    runs = {}
    for engine in ("xla", "streamed"):
        tbl = ooc_toolbox()
        tbl.generation_engine = engine
        stats = Statistics(lambda p: p.fitness.values[:, 0])
        stats.register("min", torch.min)
        stats.register("max", torch.max)
        hof = HallOfFame(3)
        pop = ooc_population(keys[5], OOC_MID, tbl, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, log = ea_simple(keys[6], pop, tbl, CXPB, MUTPB, OOC_NGEN,
                             stats=stats, halloffame=hof)
        torch.cuda.synchronize()
        runs[engine] = (out, log, hof, time.perf_counter() - t1)
    (r_pop, r_log, r_hof, r_s), (s_pop, s_log, s_hof, s_s) = runs.values()
    same_c = (same_population(r_pop, s_pop)
              and all(r_log.select(c) == s_log.select(c)
                      for c in ("gen", "nevals", "min", "max"))
              and torch.equal(r_hof.state.genome, s_hof.state.genome)
              and torch.equal(r_hof.state.values, s_hof.state.values))
    phase("out-of-core (c): ea_simple streamed vs xla engine", card_line,
          pop=OOC_MID, ngen=OOC_NGEN, bitwise_equal=same_c,
          resident_s=r_s, streamed_s=s_s, min=s_log.select("min"))
    seconds["c"] = time.perf_counter() - t
    if not same_c:
        fail("out-of-core (c): streamed ea_simple differs from the xla "
             "engine's (population, logbook or hall of fame)")

    # ---- (d) preempted between slices of generation 2, resumed --------------
    t = time.perf_counter()
    tbl = ooc_toolbox()
    pop = ooc_population(keys[5], OOC_MID, tbl, dev)
    os.makedirs(os.path.join(ROOT, "chip_smoke_out"), exist_ok=True)
    ck = os.path.join(ROOT, "chip_smoke_out", "ooc.ckpt")
    if os.path.exists(ck):
        os.remove(ck)
    inj = FaultInjector(FaultPlan(preempt_at_gen=2))
    kw = dict(ckpt_path=ck, cxpb=CXPB, mutpb=MUTPB, checkpoint_every=OOC_NGEN,
              slice_rows=OOC_SLICE)
    try:
        run_streamed_resumable(keys[6], pop, tbl, OOC_NGEN, faults=inj, **kw)
        preempted_at = None
    except Preempted as e:
        preempted_at = e.gen
    host, log = run_streamed_resumable(keys[6], pop, tbl, OOC_NGEN, **kw)
    same_d = (inj.preempts_delivered == 1 and preempted_at == 1
              and same_population(host.to_population(dev), r_pop)
              and log.select("nevals") == r_log.select("nevals"))
    os.remove(ck)
    phase("out-of-core (d): preempted in generation 2, resumed, vs "
          "undisturbed", card_line, pop=OOC_MID, ngen=OOC_NGEN,
          preempted_after_gen=preempted_at, bitwise_equal=same_d,
          seconds=time.perf_counter() - t)
    seconds["d"] = time.perf_counter() - t
    if not same_d:
        fail("out-of-core (d): the preempted and resumed run differs from "
             "the undisturbed one")
    del pop, host, r_pop, s_pop, runs

    # ---- (e) card against CPU ----------------------------------------------
    t = time.perf_counter()
    tbl = ooc_toolbox(evaluate=lambda g: (torch.max(g),))   # exact on both
    pop = ooc_population(keys[7].cpu(), OOC_CPU_POP, tbl,
                         torch.device("cpu"))
    outs = []
    for d in (dev, torch.device("cpu")):
        moved = base.Population(pop.genome.to(d), base.Fitness(
            pop.fitness.values.to(d), pop.fitness.valid.to(d),
            pop.fitness.weights))
        k_o, out, nev = streamed_ea_step(keys[7].to(d), moved, tbl, CXPB,
                                         MUTPB, slice_rows=OOC_CPU_SLICE)
        outs.append((k_o.cpu(), out, nev))
    same_e = (torch.equal(outs[0][0], outs[1][0])
              and same_population(outs[0][1], outs[1][1])
              and outs[0][2] == outs[1][2])
    phase("out-of-core (e): streamed step card vs CPU", card_line,
          pop=OOC_CPU_POP, dim=DIM, slice_rows=OOC_CPU_SLICE,
          bitwise_equal=same_e)
    seconds["e"] = time.perf_counter() - t
    if not same_e:
        fail("out-of-core (e): the streamed step on the card differs from "
             "the CPU's")
    launches = dict(kernels.LAUNCHES)
    seconds["total"] = time.perf_counter() - t_all
    phase("out-of-core: seconds", card_line, seconds=seconds,
          launches=launches)
    return seconds


# the serving slice (phase 55): the flagship's width through the service
SERVE_STEPS = 3                    # (a) / (b): steps before the ask / tell
SERVE_PACK_POPS = (40_000, 50_000, 60_000, 65_536)   # (c): one bucket
SERVE_PACK_STEPS = 2
SERVE_DEMO = dict(sessions=6, pops=(100, 180), dims=(16, 32), ngen=4)
SERVE_OOC_POP = 262_144            # (e): the streamed session


def serve_flagship_toolbox():
    """``bench.py``'s megakernel toolbox (the flagship tournament
    select): rastrigin, ``cx_two_point``, ``mut_gaussian(MU, SIGMA,
    INDPB)``, rank tournaments of 3, ``generation_engine =
    "megakernel"``."""
    from deap_tpu_torch import base, benchmarks
    from deap_tpu_torch.ops import crossover, mutation, selection
    tb = base.Toolbox()
    tb.register("evaluate", benchmarks.rastrigin)
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_gaussian, mu=MU, sigma=SIGMA,
                indpb=INDPB)
    tb.register("select", selection.sel_tournament, tournsize=3,
                tie_break="rank")
    tb.generation_engine = "megakernel"
    return tb


def _unpad(pop, n: int):
    from deap_tpu_torch import base
    return base.Population(pop.genome[:n], base.Fitness(
        values=pop.fitness.values[:n], valid=pop.fitness.valid[:n],
        weights=pop.fitness.weights))


def _padded_population(genome, rows: int):
    """The service's padded state as a population: genome rows appended
    as zeros, all fitness invalid (zero values)."""
    import torch
    from deap_tpu_torch import base
    n = genome.shape[0]
    g = torch.zeros((rows,) + tuple(genome.shape[1:]), dtype=genome.dtype,
                    device=genome.device)
    g[:n] = genome
    return base.Population(g, base.Fitness.empty(rows, (-1.0,),
                                                 device=genome.device))


def served_vary_check(kernels, state, key, tb, cx, mut, live_n: int, st):
    """K1 against its plain version on the parents a served megakernel
    step gives it: ``fused_generation(live_n=...)``'s winners over the
    padded ``state`` (the bucket's rows), remapped into the live prefix,
    gathered as the step gathers them.  Returns :func:`vary_check`'s
    tuple and the bound (ms, by)."""
    import torch
    from deap_tpu_torch import random
    from deap_tpu_torch.base import lex_sort_indices
    from deap_tpu_torch.ops import generation as G
    from deap_tpu_torch.ops.selection import tournament_positions
    params = G.megakernel_params(tb)
    rows, dim = state.genome.shape
    _, k_sel, k_var = random.split(key, 3)
    order = lex_sort_indices(state.fitness.masked_wvalues().to(
        torch.float32), descending=True).to(torch.int32)
    pos = tournament_positions(k_sel, rows, rows, params["tournsize"])
    widx = order[pos.long()]
    widx = torch.where(widx < live_n, widx, widx % live_n)
    parents = state.genome[widx.long()].contiguous()
    seed = G._seed_from_key(k_var)
    knobs = G._knobs((cx, mut, params["mut_mu"], params["mut_sigma"],
                      params["indpb"]), state.genome.device)
    got = vary_check(kernels, G, parents, seed, knobs, dim, st)
    counts = tile_counts(seed, knobs, rows, dim)
    bound = bound_ms(2 * rows * dim * parents.element_size() + 4 + 20,
                     *tile_ops(counts, rows, dim, st.dtype))
    return got, bound


def _demo_nan_evaluate():
    """The demo's rastrigin (``serve.cli.demo_rastrigin``: XLA's float32
    form, the same bits on the card and the CPU), NaN on every row whose
    first gene is above 4: what the demo's ``Quarantine("penalize")`` is
    for."""
    import torch
    from deap_tpu_torch.ops._dispatch import batched_op
    from deap_tpu_torch.serve.cli import demo_rastrigin

    def nan_rastrigin(x):
        (v,) = demo_rastrigin(x)
        return torch.where(x[:, 0] > 4.0, torch.full_like(v, float("nan")),
                           v),
    batched_op(nan_rastrigin, nan_rastrigin)
    return nan_rastrigin


def serving_demo_run(device: str) -> dict:
    """Leg (d): the CLI's demo toolbox (``Quarantine("penalize")``) with
    the NaN evaluator, a mixed-shape fleet over the wire on ``device``,
    then an ``evaluate`` probe twice (the second from the fitness
    cache).  Returns the populations (host) and the counters."""
    import torch
    from deap_tpu_torch.serve import EvolutionService
    from deap_tpu_torch.serve.cli import _build_toolbox, demo_population
    from deap_tpu_torch.serve.net import NetServer, RemoteService
    cfg = SERVE_DEMO
    tb = _build_toolbox()
    tb.register("evaluate", _demo_nan_evaluate())
    out = {"pops": [], "probe": []}
    with EvolutionService(max_batch=4, device=device) as svc, \
            NetServer(svc, {"demo": tb}) as srv, \
            RemoteService(srv.url, timeout=600) as cli:
        fleet = []
        for i in range(cfg["sessions"]):
            n = cfg["pops"][i % len(cfg["pops"])]
            d = cfg["dims"][i % len(cfg["dims"])]
            key, pop = demo_population(i, n, d)
            fleet.append(cli.open_session(key, pop, "demo", cxpb=0.7,
                                          mutpb=0.3, name=f"demo-{i}"))
        # after the initial evaluation: the NaN rows carry the sentinel
        out["initial"] = [s.population() for s in fleet]
        futs = [s.step(cfg["ngen"]) for s in fleet]
        for fs in futs:
            for f in fs:
                f.result(timeout=600)
        for s in fleet:
            out["pops"].append(s.population())
        probe = out["pops"][0].genome[:32].clone()
        probe[0, 0] = 5.0                       # one NaN row in the probe
        for _ in range(2):
            out["probe"].append(fleet[0].evaluate(probe).result(600))
        rec = cli.stats()
        with svc.cache._lock:
            cached = list(svc.cache._entries.values())
        out["cache_all_finite"] = all(bool(torch.isfinite(
            torch.as_tensor(v)).all()) for v in cached)
        out["cache_entries"] = len(cached)
        out["counters"] = {k: rec.counters[k] for k in (
            "cache_hits", "cache_misses", "cache_nan_skipped", "compiles",
            "compiles_step", "steps", "failed")}
    return out


def serving_phases(kernels, card_line, dev) -> dict:
    """Phase 55: the serving layer on ``dev`` (the card; module
    docstring, legs (a)-(e)); returns K1's launches by serving path."""
    import numpy as np
    import torch
    from deap_tpu_torch import base, random
    from deap_tpu_torch.algorithms import ea_ask, ea_step, ea_tell
    from deap_tpu_torch.algorithms import evaluate_rows
    from deap_tpu_torch.ops import generation as G
    from deap_tpu_torch.serve import EvolutionService
    from deap_tpu_torch.serve.net import NetServer, RemoteService
    t_phase = time.perf_counter()
    tb = serve_flagship_toolbox()
    key = random.fold_in(random.PRNGKey(55, device=dev), 0)
    k_init, k_sess, k_pack, k_ooc = random.split(key, 4)
    genome = random.uniform(k_init, (POP, DIM), minval=-5.12, maxval=5.12)
    rows = 1 << (POP - 1).bit_length()
    cx = float(np.float32(CXPB))
    mut = float(np.float32(MUTPB))
    launches = {}
    live = torch.arange(rows, device=dev) < POP
    # one untimed step first: the allocator's first 10^6-row blocks and
    # the first launches are not charged to either timed side
    p = _padded_population(genome, rows)
    p, _ = ea_tell(tb, p, live=live)
    ea_step(k_sess, p, tb, cx, mut, live=live)
    del p
    torch.cuda.synchronize()

    # (a) the flagship's width, in process, against the direct calls
    with EvolutionService(max_batch=4, device=dev) as svc:
        t = time.perf_counter()
        s = svc.open_session(k_sess, base.Population(
            genome, base.Fitness.empty(POP, (-1.0,), device=dev)), tb,
            cxpb=CXPB, mutpb=MUTPB, name="flagship")
        open_s = time.perf_counter() - t
        if s.bucket.rows != rows:
            fail(f"serving: the flagship session's bucket is "
                 f"{s.bucket.rows} rows, not {rows}")
        kernels.reset_launches()
        t = time.perf_counter()
        for f in s.step(SERVE_STEPS):
            f.result(timeout=600)
        step_s = (time.perf_counter() - t) / SERVE_STEPS
        launches["step"] = kernels.LAUNCHES["megakernel_vary"]
        after_steps = s.population()
        kernels.reset_launches()
        t = time.perf_counter()
        off = s.ask().result(timeout=600)
        ask_s = time.perf_counter() - t
        launches["ask"] = kernels.LAUNCHES["megakernel_vary"]
        values = evaluate_rows(tb.evaluate, off.to(dev))
        t = time.perf_counter()
        s.tell(values).result(timeout=600)
        tell_s = time.perf_counter() - t
        served = s.population()
        gauges = svc.stats().gauges
        # the worker's execute wall (program, per-slot reads, sync; for
        # the ask the offspring's copy to the host too), the profiler's
        execute = {}
        for prof in svc.profiler.profiles().values():
            if prof["kind"] in ("step", "ask"):
                execute[prof["kind"]] = (prof["device_total_s"]
                                         / prof["calls"])
    # the same padded state through the port's own calls, on the card
    p = _padded_population(genome, rows)
    p, _ = ea_tell(tb, p, live=live)
    state0 = p
    k = k_sess
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(SERVE_STEPS):
        k, p, _ = ea_step(k, p, tb, cx, mut, live=live)
    torch.cuda.synchronize()
    direct_step_s = (time.perf_counter() - t) / SERVE_STEPS
    same_steps = same_population(_unpad(p, POP), after_steps)
    k, off_d = ea_ask(k, p, tb, cx, mut, live=live)
    torch.cuda.synchronize()
    t = time.perf_counter()
    off_host = off_d.genome[:POP].cpu()
    copy_s = time.perf_counter() - t
    same_ask = torch.equal(off_host.view(torch.int32), off.view(torch.int32))
    del off_host
    vals = torch.zeros((rows, 1), dtype=torch.float32, device=dev)
    vals[:POP] = values
    p, _ = ea_tell(tb, off_d, vals, live=live)
    same_tell = same_population(_unpad(p, POP), served)
    # K1 at the shape the served step gives it: the bucket's rows
    st = G.GenomeStorage("float32")
    k1_check = {}
    (gap, err, ms, plain, dev_ms), (b, by) = served_vary_check(
        kernels, state0, k_sess, tb, cx, mut, POP, st)
    k1_check[f"{rows} x {DIM} float32 (served bucket, live {POP})"] = (
        gap, err, ms, plain, dev_ms, b, by)
    phase("serving (a): megakernel session at the flagship's width",
          card_line, pop=POP, dim=DIM, bucket_rows=rows, steps=SERVE_STEPS,
          open_s=open_s, s_per_step_served=step_s,
          s_per_step_direct=direct_step_s,
          s_per_step_execute=execute.get("step"), ask_s=ask_s,
          ask_execute_s=execute.get("ask"), ask_copy_s_direct=copy_s,
          tell_s=tell_s,
          execute_is=("the worker's wall from the slot program's start "
                      "to its sync (the profiler's device_total_s / "
                      "calls)"),
          latency_p50_ms={k_: gauges.get(f"latency_{k_}_p50_ms")
                          for k_ in ("init", "step", "ask", "tell")},
          k1_launches=launches, bitwise_steps=same_steps,
          bitwise_ask=same_ask, bitwise_tell=same_tell,
          k1_bucket_ulp_gap=gap, k1_bucket_ulp_bound=ULP_BOUND,
          k1_bucket_max_abs_err=err, k1_bucket_ms=ms,
          k1_bucket_device_ms=dev_ms, k1_bucket_plain_ms=plain,
          k1_bucket_bound_ms=b, k1_bucket_bound_by=by,
          k1_bucket_shape=[rows, DIM])
    if gap > ULP_BOUND:
        fail(f"serving: K1 at the served bucket's {rows} rows is {gap} ulp "
             f"from its plain version (bound {ULP_BOUND})")
    if launches["step"] != SERVE_STEPS or launches["ask"] != 1:
        fail(f"serving: K1 ran {launches} times (expected {SERVE_STEPS} "
             "for the steps and 1 for the ask)")
    if not (same_steps and same_ask and same_tell):
        fail("serving: the served flagship session differs from ea_step / "
             "ea_ask / ea_tell called on the same padded state")
    del p, off_d, vals, off, values, served, state0
    torch.cuda.empty_cache()

    # (b) over the wire, at the flagship's width, no compression
    host_genome = genome.cpu()
    nbytes = host_genome.numel() * host_genome.element_size()
    with EvolutionService(max_batch=4, device=dev) as svc, \
            NetServer(svc, {"flagship": tb},
                      compress_min_bytes=1 << 40) as srv, \
            RemoteService(srv.url, timeout=900) as cli:
        kernels.reset_launches()
        t = time.perf_counter()
        rs = cli.open_session(k_sess, base.Population(
            host_genome, base.Fitness.empty(POP, (-1.0,), device="cpu")),
            "flagship", cxpb=CXPB, mutpb=MUTPB, name="wire")
        up_s = time.perf_counter() - t
        t = time.perf_counter()
        for f in rs.step(SERVE_STEPS):
            f.result(timeout=900)
        wire_step_s = (time.perf_counter() - t) / SERVE_STEPS
        t = time.perf_counter()
        wired = rs.population()
        down_s = time.perf_counter() - t
        launches["wire step"] = kernels.LAUNCHES["megakernel_vary"]
        counters = svc.stats().counters
    same_wire = same_population(wired, after_steps)
    phase("serving (b): the same session over the wire (loopback)",
          card_line, frame_mb=nbytes / 1e6, open_s=up_s,
          upload_mb_per_s=nbytes / 1e6 / up_s,
          upload_includes="admission and the initial evaluation",
          s_per_step=wire_step_s, population_read_s=down_s,
          download_mb_per_s=nbytes / 1e6 / down_s,
          net_bytes_in=counters.get("net_bytes_in"),
          net_bytes_out=counters.get("net_bytes_out"),
          frames_compressed=counters.get("net_frames_compressed"),
          k1_launches=launches["wire step"], bitwise_to_a=same_wire)
    if not same_wire:
        fail("serving: the session stepped over the wire differs from (a)")
    if launches["wire step"] != SERVE_STEPS:
        fail(f"serving: K1 ran {launches['wire step']} times over the wire")
    del wired, host_genome, after_steps, genome
    torch.cuda.empty_cache()

    # (c) slot packing: four sessions of one bucket, stepped together
    def pack_pop(i, n):
        g = random.uniform(random.fold_in(k_pack, i), (n, DIM),
                           minval=-5.12, maxval=5.12)
        return (random.fold_in(k_pack, 100 + i),
                base.Population(g, base.Fitness.empty(n, (-1.0,),
                                                      device=dev)))
    inputs = [pack_pop(i, n) for i, n in enumerate(SERVE_PACK_POPS)]
    with EvolutionService(max_batch=4, device=dev) as svc:
        sess = [svc.open_session(k_, p_, tb, cxpb=CXPB, mutpb=MUTPB)
                for k_, p_ in inputs]
        kernels.reset_launches()
        t = time.perf_counter()
        with svc.quiesce():
            futs = [x.step(SERVE_PACK_STEPS) for x in sess]
        for fs in futs:
            for f in fs:
                f.result(timeout=600)
        pack_s = time.perf_counter() - t
        launches["packed steps"] = kernels.LAUNCHES["megakernel_vary"]
        packed = [x.population() for x in sess]
        rec = svc.stats()
        buckets = {x.bucket for x in sess}
    alone = []
    for k_, p_ in inputs:
        with EvolutionService(max_batch=4, device=dev) as svc1:
            x = svc1.open_session(k_, p_, tb, cxpb=CXPB, mutpb=MUTPB)
            for f in x.step(SERVE_PACK_STEPS):
                f.result(timeout=600)
            alone.append(x.population())
    same_pack = [same_population(a, b) for a, b in zip(packed, alone)]
    # K1 at the packed bucket's rows, on the sparsest session's padded
    # state (the most winners remapped into the live prefix)
    b_rows = max(x.rows for x in buckets)
    k_, p_ = inputs[0]
    n_live = p_.size
    state = _padded_population(p_.genome, b_rows)
    state, _ = ea_tell(tb, state, live=torch.arange(b_rows, device=dev)
                       < n_live)
    (gap, err, ms, plain, dev_ms), (b, by) = served_vary_check(
        kernels, state, k_, tb, cx, mut, n_live, st)
    k1_check[f"{b_rows} x {DIM} float32 (packed bucket, live {n_live})"] = (
        gap, err, ms, plain, dev_ms, b, by)
    del state
    phase("serving (c): slot packing, four sessions in one bucket",
          card_line, pops=list(SERVE_PACK_POPS), dim=DIM,
          buckets=len(buckets), bucket_rows=b_rows, steps=SERVE_PACK_STEPS,
          compiles_step=rec.counters["compiles_step"],
          batches=rec.counters["batches"],
          slot_occupancy=rec.gauges.get("slot_occupancy"),
          seconds=pack_s, k1_launches=launches["packed steps"],
          bitwise_to_alone=same_pack, k1_bucket_ulp_gap=gap,
          k1_bucket_ulp_bound=ULP_BOUND, k1_bucket_max_abs_err=err,
          k1_bucket_ms=ms, k1_bucket_device_ms=dev_ms,
          k1_bucket_plain_ms=plain, k1_bucket_bound_ms=b,
          k1_bucket_bound_by=by, k1_bucket_shape=[b_rows, DIM])
    if gap > ULP_BOUND:
        fail(f"serving: K1 at the packed bucket's {b_rows} rows is {gap} "
             f"ulp from its plain version (bound {ULP_BOUND})")
    if not all(same_pack):
        fail("serving: a slot-packed session differs from itself alone")
    if rec.counters["compiles_step"] != len(buckets):
        fail(f"serving: {rec.counters['compiles_step']} step programs for "
             f"{len(buckets)} bucket(s)")
    if launches["packed steps"] != len(sess) * SERVE_PACK_STEPS:
        fail(f"serving: K1 ran {launches['packed steps']} times for "
             f"{len(sess)} x {SERVE_PACK_STEPS} packed steps")
    del inputs, packed, alone
    torch.cuda.empty_cache()

    # (d) the demo as --smoke runs it, card and CPU, NaN rows quarantined
    t = time.perf_counter()
    card = serving_demo_run(str(dev))
    card_s = time.perf_counter() - t
    cpu = serving_demo_run("cpu")
    same_demo = (all(same_population(a, b) for a, b in zip(
                     card["initial"] + card["pops"],
                     cpu["initial"] + cpu["pops"]))
                 and all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                         for a, b in zip(card["probe"], cpu["probe"])))
    sentinel = float(np.float32(np.finfo(np.float32).max) / np.float32(16))
    quarantined = sum(int((pp.fitness.values == sentinel).sum())
                      for pp in card["initial"])
    nan_rows = sum(int((pp.genome[:, 0] > 4.0).sum())
                   for pp in card["initial"])
    probe_nan = bool(torch.isnan(card["probe"][0][0]).all())
    phase("serving (d): the demo fleet over the wire, quarantine",
          card_line, **{k_: v for k_, v in SERVE_DEMO.items()},
          card_s=card_s, counters_card=card["counters"],
          counters_cpu=cpu["counters"], nan_rows_initial=nan_rows,
          quarantined_rows_initial=quarantined,
          cache_entries=card["cache_entries"],
          cache_all_finite=card["cache_all_finite"],
          probe_nan_row=probe_nan, card_equals_cpu=same_demo)
    if not same_demo:
        fail("serving: the demo fleet differs card vs CPU")
    if quarantined == 0 or quarantined != nan_rows:
        fail(f"serving: {quarantined} rows carry the sentinel for "
             f"{nan_rows} NaN rows of the initial evaluation")
    if card["counters"]["cache_hits"] == 0 or not card["cache_all_finite"] \
            or card["counters"]["cache_nan_skipped"] == 0 or not probe_nan:
        fail(f"serving: fitness cache {card['counters']}, all finite "
             f"{card['cache_all_finite']}, NaN probe row {probe_nan}")

    # (e) streamed and checkpointed sessions, run_resumable streamed
    ooc = serving_streamed_phase(card_line, k_ooc, dev)
    phase("serving: total", card_line,
          seconds=time.perf_counter() - t_phase, k1_launches=launches)
    return {"launches": launches, "ooc": ooc, "k1_check": k1_check}


def _records(logbook) -> list:
    return [{k: float(v) for k, v in r.items()} for r in logbook]


def serving_streamed_phase(card_line, key, dev) -> dict:
    """Leg (e): a streamed session against a resident one, their
    checkpoint restored into a new service, and ``run_resumable`` over
    ``streamed_ea_simple`` preempted and resumed."""
    import tempfile
    import torch
    from deap_tpu_torch import random
    from deap_tpu_torch.bigpop import streamed_ea_simple
    from deap_tpu_torch.resilience import (FaultInjector, FaultPlan,
                                           Preempted, run_resumable)
    from deap_tpu_torch.serve import EvolutionService
    n = SERVE_OOC_POP
    tb_r = ooc_toolbox()
    tb_s = ooc_toolbox()
    tb_s.generation_engine = "streamed"
    k_pop, k_s, k_run = random.split(key, 3)
    g = random.uniform(k_pop, (n, DIM), minval=-5.12, maxval=5.12)
    from deap_tpu_torch import base
    pop0 = base.Population(g, base.Fitness.empty(n, (-1.0,), device=dev))
    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        ck = os.path.join(tmp, "sessions.pkl")
        with EvolutionService(max_batch=4, device=dev) as svc:
            ss = svc.open_session(k_s, pop0, tb_s, cxpb=CXPB, mutpb=MUTPB,
                                  name="streamed")
            sr = svc.open_session(k_s, pop0, tb_r, cxpb=CXPB, mutpb=MUTPB,
                                  name="resident")
            t = time.perf_counter()
            ss.step(1)[0].result(timeout=600)
            out["streamed_step_s"] = time.perf_counter() - t
            t = time.perf_counter()
            sr.step(1)[0].result(timeout=600)
            out["resident_step_s"] = time.perf_counter() - t
            same_streamed = same_population(ss.population(), sr.population())
            steps_streamed = svc.stats().counters["steps_streamed"]
            svc.checkpoint(ck)
            for x in (ss, sr):
                for f in x.step(2):
                    f.result(timeout=600)
            undisturbed = {x.name: x.population() for x in (ss, sr)}
        with EvolutionService(max_batch=4, device=dev) as svc2:
            restored = svc2.restore_sessions(
                ck, {"streamed": tb_s, "resident": tb_r})
            for x in restored.values():
                for f in x.step(2):
                    f.result(timeout=600)
            same_restore = all(same_population(x.population(),
                                               undisturbed[name])
                               for name, x in restored.items())
        kw = dict(checkpoint_every=1, loop=streamed_ea_simple,
                  loop_kwargs=dict(cxpb=CXPB, mutpb=MUTPB))
        t = time.perf_counter()
        ref, log_ref = run_resumable(k_run, pop0, tb_s, 3,
                                     ckpt_path=os.path.join(tmp, "u.pkl"),
                                     **kw)
        out["run_resumable_s"] = time.perf_counter() - t
        preempted_at = None
        try:
            run_resumable(k_run, pop0, tb_s, 3,
                          ckpt_path=os.path.join(tmp, "p.pkl"),
                          faults=FaultInjector(FaultPlan(preempt_at_gen=2)),
                          **kw)
        except Preempted as e:
            preempted_at = e.gen
        got, log_got = run_resumable(k_run, pop0, tb_s, 3,
                                     ckpt_path=os.path.join(tmp, "p.pkl"),
                                     **kw)
    same_resume = (preempted_at == 2 and same_population(ref, got)
                   and _records(log_ref) == _records(log_got))
    phase("serving (e): streamed session, checkpoint, run_resumable",
          card_line, pop=n, dim=DIM, steps_streamed=steps_streamed,
          streamed_equals_resident=same_streamed,
          restored_equals_undisturbed=same_restore,
          preempted_at=preempted_at, resumed_equals_undisturbed=same_resume,
          **out)
    if not same_streamed:
        fail("serving: the streamed session differs from the resident one")
    if steps_streamed != 1:
        fail(f"serving: steps_streamed = {steps_streamed}, expected 1")
    if not same_restore:
        fail("serving: sessions restored from their checkpoint diverge")
    if not same_resume:
        fail("serving: run_resumable(loop=streamed_ea_simple) resumed "
             "differs from the undisturbed run")
    return out


# the serving fleet (phase 56): phase 55 (c)'s sessions behind the router
FLEET_STEPS = 2                    # before the failover, and after it


def _http(address, method: str, path: str, body: bytes = b""):
    """One plain HTTP request; ``(status, body bytes)``."""
    import http.client
    conn = http.client.HTTPConnection(*address, timeout=600)
    try:
        conn.request(method, path, body=body or None,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def fleet_phase(kernels, card_line, dev, pops=SERVE_PACK_POPS,
                dim: int = DIM) -> dict:
    """Phase 56: three card instances behind the port's router (module
    docstring); returns K1's launches on the fleet path."""
    import contextlib
    import io
    from deap_tpu_torch import base, random
    from deap_tpu_torch.serve import EvolutionService, top
    from deap_tpu_torch.serve.net import NetServer, RemoteService
    from deap_tpu_torch.serve.router import (Backend, FleetRouter,
                                             RouterServer, TenantQuota,
                                             TenantQuotaExceeded)
    t_phase = time.perf_counter()
    tb = serve_flagship_toolbox()
    key = random.fold_in(random.PRNGKey(56, device=dev), 0)
    inputs = []
    for i, n in enumerate(pops):
        g = random.uniform(random.fold_in(key, i), (n, dim), minval=-5.12,
                           maxval=5.12)
        inputs.append((random.fold_in(key, 100 + i), g.cpu()))

    def host_pop(g):
        return base.Population(g, base.Fitness.empty(
            g.shape[0], (-1.0,), device="cpu"))

    def step_all(sessions, n):
        t = time.perf_counter()
        futs = [s.step(n) for s in sessions]
        for fs in futs:
            for f in fs:
                f.result(timeout=600)
        return (time.perf_counter() - t) / (len(sessions) * n)

    # one untimed step first: the process's first steps at this bucket
    # (the allocator's blocks, the first launches) are charged to neither
    # side; each side's first steps then pay only a fresh service's
    with EvolutionService(max_batch=4, device=dev) as svc:
        k, g = inputs[-1]
        svc.open_session(k, host_pop(g), tb, cxpb=CXPB,
                         mutpb=MUTPB).step(1)[0].result(timeout=600)
    # the reference: one undisturbed service on the card, the same keys
    # and populations, 2 x FLEET_STEPS steps each
    with EvolutionService(max_batch=4, device=dev) as svc:
        ref = [svc.open_session(k, host_pop(g), tb, cxpb=CXPB, mutpb=MUTPB,
                                name=f"fleet-{i}")
               for i, (k, g) in enumerate(inputs)]
        alone_s = [step_all(ref, FLEET_STEPS) for _ in range(2)]
        want = [s.population() for s in ref]

    svcs = [EvolutionService(max_batch=4, device=dev) for _ in range(3)]
    srvs = [NetServer(s, {"flagship": tb}).start() for s in svcs]
    router = FleetRouter([Backend(f"b{i}", s.url)
                          for i, s in enumerate(srvs)],
                         quotas={"capped": TenantQuota(max_sessions=1)})
    front = RouterServer(router).start()
    cli = RemoteService(front.url, timeout=900)
    try:
        kernels.reset_launches()
        sess = [cli.open_session(k, host_pop(g), "flagship", cxpb=CXPB,
                                 mutpb=MUTPB, name=f"fleet-{i}",
                                 tenant="acme")
                for i, (k, g) in enumerate(inputs)]
        homes = {router.route_of(s.name).name for s in sess}
        routed_s = [step_all(sess, FLEET_STEPS)]
        home = min(homes) if len(homes) == 1 else None
        t = time.perf_counter()
        status, body = _http(front.address, "POST",
                             "/v1/admin/fleet/failover",
                             json.dumps({"backend": home}).encode())
        failover_s = time.perf_counter() - t
        new_homes = {router.route_of(s.name).name for s in sess}
        routed_s.append(step_all(sess, FLEET_STEPS))
        launches = kernels.LAUNCHES["megakernel_vary"]
        got = [s.population() for s in sess]
        victim = srvs[int(home[1:])] if home else srvs[0]
        new_home = router.route_of(sess[0].name)
        with RemoteService(victim.url, timeout=900) as stale:
            stale_gen = stale.attach(sess[0].name).gen
            followed = (stale.host, stale.port) == (new_home.host,
                                                    new_home.port)
        k_cap, g_cap = inputs[0][0], inputs[0][1][:1024]
        cli.open_session(k_cap, host_pop(g_cap), "flagship", name="cap-0",
                         tenant="capped", evaluate_initial=False)
        try:
            cli.open_session(k_cap, host_pop(g_cap), "flagship",
                             name="cap-1", tenant="capped",
                             evaluate_initial=False)
            quota = "admitted"
        except TenantQuotaExceeded:
            quota = "TenantQuotaExceeded"
        rec = router.stats()
        _, prom = _http(front.address, "GET",
                        "/v1/admin/fleet?format=prometheus")
        prom = prom.decode()
        live = [b for b in router.backends if not router.health.is_sick(b)]
        labelled = {b: f'deap_tpu_serve_steps_total{{instance="{b}"}}' in prom
                    for b in ["router"] + live}
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            top_rc = top.main(["--router", front.url, "--once", "--json"])
        doc = json.loads(buf.getvalue())
        per = [r["counters"] for r in doc["instances"].values()
               if r["error"] is None]
        top_sums = all(v == sum(c.get(k, 0) for c in per)
                       for k, v in doc["fleet"]["counters"].items())
    finally:
        cli.close()
        front.close()
        for s in srvs:
            s.close()
        for s in svcs:
            s.close()
    same = [same_population(a, b) for a, b in zip(got, want)]
    counters = {k: rec.counters[k] for k in (
        "router_failovers", "router_failover_sessions",
        "router_quota_rejections", "router_sessions_placed",
        "router_placements_warm", "router_sessions_lost")}
    phase("serving fleet: three card instances behind the router",
          card_line, pops=list(pops), dim=dim, steps=2 * FLEET_STEPS,
          homes=sorted(homes), after_failover=sorted(new_homes),
          s_per_step_routed=routed_s, s_per_step_alone=alone_s,
          s_per_step_are=("a session's step, steps 1-2 and 3-4 (routed: "
                          "before and after the failover; alone: the "
                          "sessions' futures queued together)"),
          failover_http_status=status, failover_s=failover_s,
          router_failover_recovery_s=rec.gauges[
              "router_failover_recovery_s"],
          router_bytes_in=rec.counters["net_bytes_in"],
          router_bytes_out=rec.counters["net_bytes_out"],
          router_counters=counters, k1_launches=launches,
          bitwise_to_alone=same, stale_client_gen=stale_gen,
          stale_client_followed=followed, capped_second_session=quota,
          prometheus_instance_labels=labelled, top_rc=top_rc,
          top_fleet_is_instance_sum=top_sums,
          top_fleet_steps=doc["fleet"]["counters"].get("steps"),
          seconds=time.perf_counter() - t_phase)
    if len(homes) != 1:
        fail(f"fleet: affinity placed one bucket's sessions on {homes}")
    if status != 200 or home in new_homes or len(new_homes) != 1:
        fail(f"fleet: failover of {home} answered {status} {body[:200]!r} "
             f"and left the sessions on {new_homes}")
    if not all(same):
        fail("fleet: sessions behind the router differ from the same "
             "sessions stepped in one undisturbed service")
    if launches != len(pops) * 2 * FLEET_STEPS:
        fail(f"fleet: K1 ran {launches} times for {len(pops)} x "
             f"{2 * FLEET_STEPS} routed steps")
    if stale_gen != 2 * FLEET_STEPS or not followed:
        fail(f"fleet: a direct client of the drained {home} read gen "
             f"{stale_gen} (redirect followed: {followed})")
    if quota != "TenantQuotaExceeded":
        fail(f"fleet: the capped tenant's second session was {quota}")
    if (counters["router_failovers"], counters["router_failover_sessions"],
            counters["router_quota_rejections"]) != (1, len(pops), 1):
        fail(f"fleet: router counters {counters}")
    if not all(labelled.values()):
        fail(f"fleet: one scrape's instance labels {labelled}")
    if top_rc != 0 or not top_sums or \
            doc["fleet"]["counters"].get("steps") != \
            len(pops) * 2 * FLEET_STEPS:
        fail(f"fleet: top --once --json rc {top_rc}, fleet counters the "
             f"instance sum: {top_sums}, steps "
             f"{doc['fleet']['counters'].get('steps')}")
    return {"launches": launches}


def main() -> int:
    if sys.argv[1:2] == ["--cpu-side"]:
        return _cpu_side_main(sys.argv[2])
    import atexit
    atexit.register(_kill_cpu_sides)
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: chip_smoke.py needs a card")
    from deap_tpu_torch.probes import card_line as read_card_line
    try:
        card_line = read_card_line()
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi: {e}")
    kind = torch.cuda.get_device_name(0)
    print(f"# python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} on {card_line}", flush=True)

    # ---- 1. build, and beside it 54. out-of-core (no kernel on its path) --
    t0 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor
    from deap_tpu_torch import kernels
    from deap_tpu_torch.kernels.build import build

    def timed_build():
        t = time.perf_counter()
        return build(), time.perf_counter() - t

    with ThreadPoolExecutor(1) as pool:
        building = pool.submit(timed_build)
        out_of_core_phases(kernels, card_line, torch.device("cuda"))
        lib, build_s = building.result()
    torch.cuda.empty_cache()
    # the P5 edges' plain forms (phase 20) need nothing of this run: a
    # second interpreter on one thread computes them from here on
    p5_edges_cpu = CpuSide("cpu_probe_gp_edges")
    kernels.load()
    phase("build", card_line, seconds=build_s,
          library=os.path.relpath(lib, ROOT),
          beside="phase 54, out-of-core")

    from deap_tpu_torch import base, benchmarks, random
    from deap_tpu_torch.algorithms import ea_simple, ea_step
    from deap_tpu_torch.ops import crossover, mutation, selection
    from deap_tpu_torch.ops import generation as G
    from deap_tpu_torch.utils.support import Statistics

    dev = torch.device("cuda")
    key = random.PRNGKey(0, device=dev)
    k_init, k_sel, k_var, k_run = random.split(key, 4)
    genome = random.uniform(k_init, (POP, DIM), minval=-5.12, maxval=5.12)
    values = torch.func.vmap(lambda g: benchmarks.rastrigin(g)[0])(genome)
    order = base.lex_sort_indices(-values[:, None]).to(torch.int32)
    pos = selection.tournament_positions(k_sel, POP, POP, 3)
    widx = order[pos.long()]
    seed = G._seed_from_key(k_var)
    knobs = torch.tensor([CXPB, MUTPB, MU, SIGMA, INDPB], device=dev)
    counts = tile_counts(seed, knobs, POP, DIM)
    phase("tile work of this run's draws", card_line, **counts)
    report = {}

    # ---- 2./3. K1 and K2 against their plain versions ---------------------
    storages = [G.GenomeStorage("float32"), G.GenomeStorage("bfloat16"),
                G.GenomeStorage("int8", 5.12)]
    for st in storages:
        gs = st.to_storage(genome)
        elt = gs.element_size()
        parents = gs[widx.long()].contiguous()
        gap1, err1, ms1, plain1, dev1 = vary_check(kernels, G, parents,
                                                   seed, knobs, DIM, st)
        ops = tile_ops(counts, POP, DIM, st.dtype)
        b1, by1 = bound_ms(2 * POP * DIM * elt + 4 + 20, *ops)
        phase("K1 megakernel_vary vs plain", card_line, storage=st.dtype,
              ulp_gap=gap1, ulp_bound=ULP_BOUND, max_abs_err=err1,
              ms=ms1, device_ms=dev1, plain_ms=plain1, bound_ms=b1,
              bound_by=by1, shape=[POP, DIM])
        if gap1 > ULP_BOUND:
            fail(f"K1 {st.dtype}: {gap1} ulp from its plain version "
                 f"(bound {ULP_BOUND})")

        k2, w2 = kernels.launch_gather_vary(order, pos, gs, seed, knobs,
                                            dim=DIM, dtype=st.dtype,
                                            scale=st.scale)
        p2, pw = G._gather_vary_plain(order, pos, gs, seed, knobs, DIM, st)
        torch.cuda.synchronize()
        gap2 = ulp_gap(k2, p2)
        err2 = float((k2.float() - p2.float()).abs().max().item())
        if not torch.equal(w2, pw):
            fail(f"K2 {st.dtype}: winner indices differ from order[pos]")
        ms2 = cuda_ms(lambda: kernels.launch_gather_vary(
            order, pos, gs, seed, knobs, dim=DIM, dtype=st.dtype,
            scale=st.scale))
        plain2 = cuda_ms(lambda: G._gather_vary_plain(
            order, pos, gs, seed, knobs, DIM, st), reps=3, warm=1)
        b2, by2 = bound_ms(2 * POP * DIM * elt + 3 * 4 * POP + 4 + 20,
                           *ops)
        phase("K2 megakernel_gather_vary vs index_select+plain", card_line,
              storage=st.dtype, ulp_gap=gap2, ulp_bound=ULP_BOUND,
              max_abs_err=err2, widx_equal=True, ms=ms2, plain_ms=plain2,
              bound_ms=b2, bound_by=by2, shape=[POP, DIM])
        if gap2 > ULP_BOUND:
            fail(f"K2 {st.dtype}: {gap2} ulp from its plain version "
                 f"(bound {ULP_BOUND})")
        report[st.dtype] = {"K1": (err1, ms1, plain1, b1, by1, dev1),
                            "K2": (err2, ms2, plain2, b2, by2)}
        del gs, parents, k2, p2
        torch.cuda.empty_cache()

    # ---- 4. a whole generation on a small input, card against CPU --------
    n_small = 1024
    g_small = genome[:n_small]
    w_small = -values[:n_small, None]
    for gather in ("dma", "host"):
        outs = []
        for d in (dev, torch.device("cpu")):
            out, idx = G.fused_generation(
                k_sel.to(d), k_var.to(d), g_small.to(d), w_small.to(d),
                dim=DIM, cxpb=CXPB, mutpb=MUTPB, mut_mu=MU,
                mut_sigma=SIGMA, indpb=INDPB, gather=gather)
            outs.append((out.cpu(), idx.cpu()))
        same = (torch.equal(outs[0][0].view(torch.int32),
                            outs[1][0].view(torch.int32))
                and torch.equal(outs[0][1].to(torch.int64),
                                outs[1][1].to(torch.int64)))
        phase("reference: fused_generation card vs CPU", card_line,
              gather=gather, pop=n_small, dim=DIM, bitwise_equal=same)
        if not same:
            fail(f"fused_generation(gather={gather!r}) on the card differs "
                 "from the CPU path on a small input")

    fault_reference_phase(card_line, random.fold_in(key, 6), dev)

    # ---- 5. the main path ---------------------------------------------------
    tb = base.Toolbox()
    tb.register("evaluate", benchmarks.rastrigin)
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_gaussian, mu=MU, sigma=SIGMA,
                indpb=INDPB)
    tb.register("select", selection.sel_tournament, tournsize=3,
                tie_break="rank")
    tb.generation_engine = "megakernel"
    stats = Statistics(lambda p: p.fitness.values[:, 0])
    stats.register("min", torch.min)

    def fresh():
        return base.Population(genome.clone(),
                               base.Fitness.empty(POP, (-1.0,), device=dev))

    def run(ngen):
        pop0 = fresh()
        torch.cuda.synchronize()
        t = time.perf_counter()
        pop, log = ea_simple(k_run, pop0, tb, CXPB, MUTPB, ngen,
                             stats=stats)
        torch.cuda.synchronize()
        return time.perf_counter() - t, pop, log

    run(2)                                     # warm the allocator
    kernels.reset_launches()
    t1, pop1, log1 = run(NGEN)
    launches_main = dict(kernels.LAUNCHES)
    t2, pop2, log2 = run(2 * NGEN)
    # the loop is host-bound on a shared host: repeat the (N, 2N) pair in
    # alternating order and report the median marginal cost
    pairs = [(t1, t2)]
    for i in range(TIMING_PAIRS - 1):
        if i % 2:
            a = run(NGEN)[0]
            b = run(2 * NGEN)[0]
        else:
            b = run(2 * NGEN)[0]
            a = run(NGEN)[0]
        pairs.append((a, b))
    marginals = sorted((b - a) / NGEN for a, b in pairs)
    per_gen = marginals[len(marginals) // 2]
    best = log2.select("min")
    final = pop2.fitness.values
    ok_shape = (tuple(pop2.genome.shape) == (POP, DIM)
                and bool(torch.isfinite(pop2.genome).all())
                and bool(torch.isfinite(final).all()))
    phase("main path: ea_simple megakernel rastrigin", card_line,
          pop=POP, dim=DIM, ngen=[NGEN, 2 * NGEN],
          seconds=[list(p) for p in pairs],
          marginal_ms_per_gen=per_gen * 1e3,
          marginal_ms_range=[marginals[0] * 1e3, marginals[-1] * 1e3],
          gens_per_s=1.0 / per_gen if per_gen > 0 else None,
          linearity=[b / a for a, b in pairs],
          best_start=best[0], best_end=best[-1],
          launches=launches_main,
          launches_per_gen={k: v / NGEN for k, v in launches_main.items()},
          finite_and_shaped=ok_shape)
    if launches_main["megakernel_gather_vary"] != NGEN:
        fail(f"K2 ran {launches_main['megakernel_gather_vary']} times in "
             f"{NGEN} generations of the main path")
    if not best[-1] < best[0]:
        fail(f"best fitness did not fall: {best[0]} -> {best[-1]}")
    if not ok_shape:
        fail("final population is not finite with shape (pop, dim)")

    # the serving step: a live prefix mask routes the generation through K1
    live = torch.arange(POP, device=dev) < POP - 4096
    pop = pop1
    kernels.reset_launches()
    skey = k_run
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(LIVE_GENS):
        skey, pop, _ = ea_step(skey, pop, tb, CXPB, MUTPB, live=live)
    torch.cuda.synchronize()
    t_live = time.perf_counter() - t
    launches_live = dict(kernels.LAUNCHES)
    frozen = torch.equal(pop.genome[~live], pop1.genome[~live])
    phase("main path: ea_step live-mask (serving)", card_line, pop=POP,
          dim=DIM, gens=LIVE_GENS, ms_per_gen=t_live / LIVE_GENS * 1e3,
          launches=launches_live, pad_rows_frozen=frozen)
    if launches_live["megakernel_vary"] != LIVE_GENS:
        fail(f"K1 ran {launches_live['megakernel_vary']} times in "
             f"{LIVE_GENS} live-mask generations")
    if not frozen:
        fail("live-mask step changed pad rows")

    if "--profile" in sys.argv[1:]:
        profile_main_path(ea_step, k_run, pop1, tb, card_line)
    del pop1, pop2, pop, genome, values
    torch.cuda.empty_cache()

    # ---- 6./7. K3 and K4 against their plain versions ---------------------
    from deap_tpu_torch.ops import dominance as D
    k_k3, k_k3s, k_k4, k_ref, k_mo, k_head = random.split(
        random.fold_in(key, 2), 6)
    g_big = random.uniform(k_k3, (POP, DIM), minval=-5.12, maxval=5.12)
    k3_big = k3_phase(kernels, G, g_big, k_k3, card_line, POP, DIM,
                      (MU, SIGMA, INDPB), storages)
    del g_big
    g_mo = random.uniform(k_k3s, (MO_POP, MO_DIM))
    k3_mo = k3_phase(kernels, G, g_mo, k_k3s, card_line, MO_POP, MO_DIM,
                     (0.0, MO_SIGMA, MO_INDPB), storages)
    del g_mo
    # the vector walk's edges: rows of one vector, of a few, of many;
    # lambda != mu and not a multiple of a block's 256 rows
    k3_edges = {}
    for n, lam, dim in K3_EDGES:
        k_e = random.fold_in(k_k3s, dim)
        g_e = random.uniform(k_e, (n, dim), minval=-5.12, maxval=5.12)
        k3_edges[dim] = k3_phase(kernels, G, g_e, k_e, card_line, n, dim,
                                 (MU, SIGMA, INDPB), storages, lam=lam)
        del g_e
    k4 = k4_phase(kernels, D, k_k4, card_line)

    # ---- 8. an NSGA-II generation on a small input, card against CPU ------
    nsga2_reference_phase(card_line, k_ref)

    # ---- 9./10. the NSGA-II main path and the ea_step head ----------------
    launches_mo, mo_pop, mo_tb = nsga2_main_path(kernels, card_line, k_mo)
    launches_head, k1_head = nsga2_head_phase(kernels, G, card_line, k_head,
                                              mo_pop, mo_tb)
    if "--profile" in sys.argv[1:]:
        profile_nsga2(k_head, mo_pop, mo_tb, card_line)

    # ---- 11.-13. the GP slice: reference, main path, K6 -------------------
    del mo_pop
    torch.cuda.empty_cache()
    k_gp_ref, k_gp, k_gp_k6 = random.split(random.fold_in(key, 3), 3)
    gp_reference_phase(card_line, k_gp_ref, dev)
    launches_gp, launches_gp_ea, gp_pop2, gp_pop0, gp_tb = gp_main_path(
        kernels, card_line, k_gp, dev)
    if "--profile" in sys.argv[1:]:
        profile_gp(k_gp, gp_pop2, gp_tb, card_line)
    k6 = gp_k6_phase(kernels, card_line, k_gp_k6, gp_pop0, gp_pop2, dev)

    # ---- 14.-17. bench_nsga2.py as published, and K5 ----------------------
    del gp_pop0, gp_pop2
    torch.cuda.empty_cache()
    k_bn_ra, k_bn_rb, k_bn_a, k_bn_b, k_hv = random.split(
        random.fold_in(key, 4), 5)
    bench_nsga2_reference_phase(card_line, k_bn_ra, "dtlz2")
    bench_nsga2_reference_phase(card_line, k_bn_rb, "zdt1")
    launches_bn_a, bn_pop, bn_tb = bench_nsga2_main_path_a(kernels, card_line,
                                                           k_bn_a)
    if "--profile" in sys.argv[1:]:
        profile_bench_nsga2(k_bn_a, bn_pop, bn_tb, card_line)
    k5 = {"uniform": k5_check(
              kernels, card_line, f"{HV_UNIFORM_N} uniform points",
              random.uniform(k_hv, (HV_UNIFORM_N, 3)), (1.0, 1.0, 1.0)),
          "path A": k5_check(
              kernels, card_line, "path A's final population",
              -bn_pop.fitness.wvalues, HV_REF["dtlz2"])}
    del bn_pop
    torch.cuda.empty_cache()
    launches_bn_b = bench_nsga2_main_path_b(kernels, card_line, k_bn_b)

    # ---- 18.-21. the probe tools and P1-P5 --------------------------------
    k_pr, k_pr5 = random.split(random.fold_in(key, 5))
    p14 = probe_kernels_phase(card_line, k_pr)
    launches_pga = probe_ga_tool_phase(kernels, card_line)
    torch.cuda.empty_cache()
    p5, p5_edge_err = probe_gp_phase(card_line, k_pr5, p5_edges_cpu)
    launches_pgp, gp_probes = probe_gp_tool_phase(kernels, card_line)

    # ---- 22.-25. OneMax and CMA-ES: no kernel on their paths ---------------
    onemax_phase(card_line)
    cma_phase(card_line, "sphere")
    cma_phase(card_line, "ackley")
    cma_anchor_phase(card_line)
    mo_cma_phase(card_line)

    # ---- 26.-29. rbg keys: the samplers, the flagship, evopole ------------
    rbg_phase(card_line)
    launches_rbg = flagship_rbg_phase(kernels, card_line)
    onemax_phase(card_line, "rbg")
    cma_phase(card_line, "sphere", "rbg")
    evopole_phase(kernels, card_line)

    # ---- 30.-33. the rest of multi-objective --------------------------------
    torch.cuda.empty_cache()
    k_mo_ref, k_mo, k_dcd, k_spea = random.split(random.fold_in(key, 7), 4)
    permutation_phase(card_line)
    for i, problem in enumerate(BN_PROBLEMS):
        for j, name in enumerate(MO_SEL_PATHS):
            mo_select_reference(card_line, random.fold_in(k_mo_ref, 3 * i + j),
                                problem, name)
    mo_runs = {}
    for name, (_, problems) in MO_SEL_PATHS.items():
        for problem in problems:
            launches_p, ms_p, mo_pop = mo_select_main_path(
                kernels, card_line, random.fold_in(k_mo, len(mo_runs)),
                problem, name)
            mo_runs[f"{name} {problem}"] = launches_p
            if (name, problem) == ("nsga3", "dtlz2"):
                dcd_finish = dcd_phase(card_line, k_dcd, mo_pop)
            del mo_pop
            torch.cuda.empty_cache()
    spea2_checks_phase(card_line, k_spea)
    dcd_finish()
    launches_ex = examples_phase(kernels, card_line)

    # ---- 34.-38. the rest of GP ---------------------------------------------
    gp_rest = gp_rest_phases(kernels, card_line, key, dev)

    # ---- 39.-42. the rest of the operators and benchmarks -------------------
    rest = rest_of_ops_phases(kernels, card_line, key)

    # ---- 43.-48. the rest of the library ------------------------------------
    lib = library_rest_phases(kernels, card_line)

    # ---- 49.-50. the last examples and the streaming knobs -------------------
    rest_ex = slice_rest_phases(kernels, card_line)

    # ---- 51.-53. distribution: R = 1 (nccl), R = 2 (gloo), R = 4 (nccl) -----
    dist_runs = distribution_phases(kernels, card_line)

    # ---- 55. serving: the service, the wire, quarantine, checkpoints -------
    serving = serving_phases(kernels, card_line, dev)

    # ---- 56. the serving fleet: the router, failover, quotas, top ----------
    fleet = fleet_phase(kernels, card_line, dev)

    # ---- 57. the kernels line and the result -------------------------------
    # K1 and K2 at the GA flagship's shape (1e6 x 100 float32); K1's
    # launches are the live-mask path's, and per path beside them
    src = "deap_tpu_torch/kernels/megakernel.cu"
    rows = []
    for name, tag, replaces, launches in (
            ("megakernel_vary", "K1",
             "deap_tpu/ops/generation_pallas.py:519",
             launches_live["megakernel_vary"]),
            ("megakernel_gather_vary", "K2",
             "deap_tpu/ops/generation_pallas.py:441",
             launches_main["megakernel_gather_vary"])):
        err, ms, plain, b, by = report["float32"][tag][:5]
        errs = [report[d][tag][0] for d in report]
        if tag == "K1":
            errs += [v[0] for v in k1_head.values()]
            errs += [v[1] for v in serving["k1_check"].values()]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(errs),
            "ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": by,
            "library_ms": None})
    rows[0]["launches_by_path"] = {
        "ea_step live-mask": launches_live["megakernel_vary"],
        "NSGA-II ea_step head": launches_head["megakernel_vary"],
        "ea_step live-mask, rbg keys": launches_rbg["K1"]}
    rows[1]["launches_by_path"] = {
        f"ea_simple, {NGEN} generations": launches_main[
            "megakernel_gather_vary"],
        f"ea_simple, rbg keys, {RBG_NGEN} generations": launches_rbg["K2"],
        **{f"bench.py megakernel body, {fn}, {2 * FLAG_NGEN} generations": n
           for fn, n in rest["k2"].items()},
        f"creator + checkpoint / resume, "
        f"{lib['creator_checkpoint']['generations']} generations":
            lib["creator_checkpoint"]["checkpoint"],
        **dist_launches_by_path(dist_runs, "megakernel_gather_vary")}
    rows[0]["launches_by_path"].update(
        dist_launches_by_path(dist_runs, "megakernel_vary"))
    gaps = {v[0] for v in serving["k1_check"].values()}
    rows[0]["launches_by_path"].update({
        f"served megakernel session, {SERVE_STEPS} steps (bucket "
        f"{1 << (POP - 1).bit_length()} rows; K1 there and at the packed "
        f"bucket {max(gaps)} ulp from its plain version)": serving[
            "launches"]["step"],
        "served megakernel session, ask": serving["launches"]["ask"],
        f"served over the wire, {SERVE_STEPS} steps": serving[
            "launches"]["wire step"],
        f"slot-packed sessions, {len(SERVE_PACK_POPS)} x "
        f"{SERVE_PACK_STEPS} steps": serving["launches"]["packed steps"],
        "fleet steps": fleet["launches"]})
    # K1 at the NSGA-II head's shape beside the flagship's: host-paced
    # ms, device ms with the launches queued, and the bound
    rows[0]["ms_by_shape"] = {
        **{f"{POP} x {DIM} {d}": report[d]["K1"][1] for d in report},
        **{f"{MO_POP} x {MO_DIM} {d} (NSGA-II head)": v[1]
           for d, v in k1_head.items()},
        **{shape: v[2] for shape, v in serving["k1_check"].items()}}
    rows[0]["device_ms_by_shape"] = {
        **{f"{POP} x {DIM} {d}": report[d]["K1"][5] for d in report},
        **{f"{MO_POP} x {MO_DIM} {d} (NSGA-II head)": v[3]
           for d, v in k1_head.items()},
        **{shape: v[4] for shape, v in serving["k1_check"].items()}}
    rows[0]["bound_ms_by_shape"] = {
        **{f"{POP} x {DIM} {d}": report[d]["K1"][3] for d in report},
        **{f"{MO_POP} x {MO_DIM} {d} (NSGA-II head)": v[4]
           for d, v in k1_head.items()},
        **{shape: v[5] for shape, v in serving["k1_check"].items()}}
    rows[0]["plain_ms_by_shape"] = {
        shape: v[3] for shape, v in serving["k1_check"].items()}
    # K3 at the NSGA-II path's shape (1e5 x 12 float32), and both shapes
    # by type
    err, ms, plain, b, by, dev_ms = k3_mo["float32"]
    k3_main = (((POP, DIM), k3_big), ((MO_POP, MO_DIM), k3_mo))
    rows.append({
        "name": "megakernel_var_or", "route": "cuda", "source": src,
        "replaces": "deap_tpu/ops/generation_pallas.py:566",
        "launches": launches_mo["megakernel_var_or"],
        "max_abs_err": max(v[0] for d in (k3_big, k3_mo, *k3_edges.values())
                           for v in d.values()),
        "ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": by,
        "library_ms": None, "device_ms": dev_ms,
        "ms_by_shape": {f"{n} x {dm} {d}": v[1] for (n, dm), k3 in k3_main
                        for d, v in k3.items()},
        "device_ms_by_shape": {f"{n} x {dm} {d}": v[5]
                               for (n, dm), k3 in k3_main
                               for d, v in k3.items()}})
    # K4 at its C = n call
    err, ms, plain, b, by = k4[2 * MO_POP]
    rows.append({
        "name": "rows_dominate_counts", "route": "cuda",
        "source": "deap_tpu_torch/kernels/dominance.cu",
        "replaces": "deap_tpu/ops/dominance_pallas.py:77",
        "launches": launches_mo["rows_dominate_counts"],
        "max_abs_err": max(v[0] for v in k4.values()),
        "ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": by,
        "library_ms": None,
        "launches_by_path": {
            "NSGA-II ea_mu_plus_lambda": launches_mo["rows_dominate_counts"],
            "NSGA-II ea_step head": launches_head["rows_dominate_counts"],
            "bench_nsga2 A (grid peel)":
                launches_bn_a["rows_dominate_counts"],
            "bench_nsga2 B": launches_bn_b["rows_dominate_counts"],
            **{f"bench_nsga2 {path}": v["rows_dominate_counts"]
               for path, v in mo_runs.items()},
            **{f"examples/ga/{ex}.py": v["rows_dominate_counts"]
               for ex, v in launches_ex.items()},
            **{f"suite {p}, {2 * SUITE_NGEN} generations": v["rows_dominate_counts"]
               for p, v in rest["suite"].items()},
            **{f"examples/{ex.replace('.', '/')}.py":
               v["rows_dominate_counts"]
               for ex, v in rest["examples"].items()},
            **{f"examples/{ex.replace('.', '/')}.py (phase 49)":
               v["rows_dominate_counts"]
               for ex, v in rest_ex.items() if v["rows_dominate_counts"]},
            **dist_launches_by_path(dist_runs, "rows_dominate_counts")},
        "ms_by_input": {f"C = {FRONT_CHUNK} rows of the {p} pool": v["ms"]
                        for p, v in rest["k4"].items()},
        "plain_ms_by_input": {f"C = {FRONT_CHUNK} rows of the {p} pool":
                              v["plain_ms"] for p, v in rest["k4"].items()},
        "bound_ms_by_input": {f"C = {FRONT_CHUNK} rows of the {p} pool":
                              v["bound_ms"] for p, v in rest["k4"].items()}})
    # K5 in float64 (the toolbox slot's route) on path A's final
    # population; its other inputs and float32 are in the K5 phases above
    a64 = k5["path A"]["float64"]
    rows.append({
        "name": "hv3d_sweep", "route": "cuda",
        "source": "deap_tpu_torch/kernels/hypervolume.cu",
        "replaces": "deap_tpu/ops/hypervolume.py:161",
        "launches": launches_bn_a["hv3d_sweep"],
        "max_abs_err": max(v["max_abs_err"] for c in (
            *k5.values(), *rest["k5"].values()) for v in c.values()),
        "ms": a64["ms"], "plain_ms": a64["plain_ms"],
        "bound_ms": a64["bound_ms"], "bound_by": a64["bound_by"],
        "library_ms": None,
        "launches_by_path": {
            "bench_nsga2 A": launches_bn_a["hv3d_sweep"],
            **{f"suite {p}": v["hv3d_sweep"]
               for p, v in rest["suite"].items() if v["hv3d_sweep"]},
            **dist_launches_by_path(dist_runs, "hv3d_sweep")},
        "ms_by_input": {f"{c} {d}": v["ms"] for c, cs in (
            *k5.items(), *rest["k5"].items()) for d, v in cs.items()},
        "device_ms_by_input": {f"{c} {d}": v["device_ms"] for c, cs in (
            *k5.items(), *rest["k5"].items()) for d, v in cs.items()},
        "bound_ms_by_input": {f"{c} {d}": v["bound_ms"] for c, cs in (
            *k5.items(), *rest["k5"].items()) for d, v in cs.items()}})
    # K6 on the population after 2N generations of the main path (its
    # other inputs are in the K6 phases above)
    ev = k6["evolved"]
    rows.append({
        "name": "gp_interp", "route": "cuda",
        "source": "deap_tpu_torch/kernels/gp_interp.cu",
        "replaces": "deap_tpu/gp/interp_pallas.py:201",
        "launches": launches_gp["gp_interp"],
        "max_abs_err": max(v["max_abs_err"] for v in (
            *k6.values(), *gp_rest["k6_children"].values())),
        "ms": ev["ms"], "plain_ms": ev["plain_ms"], "bound_ms": ev["bound_ms"],
        "bound_by": ev["bound_by"], "library_ms": None,
        "launches_by_path": {
            "bench generation": launches_gp["gp_interp"],
            "ea_simple": launches_gp_ea["gp_interp"],
            f"HARM, {2 * HARM_NGEN} generations": gp_rest["harm"],
            **{f"bench generation, {v}, {2 * GP_VARIANT_NGEN} generations":
               n for v, n in gp_rest["variants"].items()},
            "bench generation, automatic epsilon-lexicase": gp_rest[
                "lexicase"],
            **{f"examples/gp/{ex}.py": v["gp_interp"]
               for ex, v in gp_rest["examples"].items()}},
        "ms_by_input": {**{k: v["ms"] for k, v in k6.items()},
                        **{f"children of {k}": v["ms"]
                           for k, v in gp_rest["k6_children"].items()}},
        "device_ms_by_input": {
            **{k: v["device_ms"] for k, v in k6.items()},
            **{f"children of {k}": v["device_ms"]
               for k, v in gp_rest["k6_children"].items()}},
        "bound_ms_by_input": {
            **{k: v["bound_ms"] for k, v in k6.items()},
            **{f"children of {k}": v["bound_ms"]
               for k, v in gp_rest["k6_children"].items()}}})
    rows[-1]["launches_by_path"]["probes.gp real63"] = launches_pgp[
        "gp_interp"]
    # P1-P4 at the GA tool's shape (stream and the row tiles at 2048
    # rows), launches on the GA tool's path; P5 at the GP tool's shape,
    # dispatch at tb 8, unroll 1 (its other forms are in phase 20),
    # launches on the GP tool's path
    ga_src = "tools/pallas_probe_ga.py"
    for name, tag, line in (
            ("probe_stream_copy", "stream_rows2048", 280),
            ("probe_chain24", "chain", 280),
            ("probe_rast_reduce", "rast", 280),
            ("probe_hash_normal", "rng", 354),
            ("probe_lookup", "lookup", 421),
            ("probe_row_gather", "dmagather", 479)):
        r = p14[tag]
        rows.append({
            "name": name, "route": "cuda",
            "source": "deap_tpu_torch/kernels/probes.cu",
            "replaces": f"{ga_src}:{line}", "launches": launches_pga[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    rows[-6]["ms_by_rows"] = {k: v["ms"] for k, v in p14.items()
                              if k.startswith("stream_")}
    rows[-6]["library_ms_by_rows"] = {k: v["library_ms"]
                                      for k, v in p14.items()
                                      if k.startswith("stream_")}
    rows[-6]["tb_per_s_by_rows"] = {k: v["tb_per_s"] for k, v in p14.items()
                                    if k.startswith("stream_")}
    rows[-4]["device_ms"] = p14["rast"]["device_ms"]
    rows[-2]["device_ms"] = p14["lookup"]["device_ms"]
    rows[-2]["library_device_ms"] = p14["lookup"]["library_device_ms"]
    r5 = p5[("dispatch", 8, 0)]
    rows.append({
        "name": "probe_gp", "route": "cuda",
        "source": "deap_tpu_torch/kernels/probes.cu",
        "replaces": "tools/pallas_probe_gp.py:184",
        "launches": launches_pgp["probe_gp"],
        "max_abs_err": max(p5_edge_err,
                           *(v["max_abs_err"] for v in p5.values())),
        "ms": r5["ms"], "plain_ms": r5["plain_ms"], "bound_ms": r5["bound_ms"],
        "bound_by": r5["bound_by"], "library_ms": None,
        "ms_by_form": {f"{m} tb{tb} unroll{u or 1}": v["ms"]
                       for (m, tb, u), v in p5.items()},
        "fraction_of_floor": gp_probes.get("fraction_of_floor")})

    phase("total", card_line, seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
