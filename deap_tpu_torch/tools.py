"""``deap_tpu_torch.tools`` — the flat namespace of ``deap_tpu/tools.py``
(and of the reference's ``deap.tools``): initializers, operators,
multi-objective selection, migration, constraints, indicators and the
support classes from one place.  snake_case is canonical; the
reference's camelCase names are aliases, so DEAP user code maps one to
one."""

from .ops.init import *               # noqa: F401,F403
from .ops.crossover import *          # noqa: F401,F403
from .ops.mutation import *           # noqa: F401,F403
from .ops.selection import *          # noqa: F401,F403
from .ops.emo import *                # noqa: F401,F403
from .ops.migration import *          # noqa: F401,F403
from .ops.constraint import *         # noqa: F401,F403
from .ops.indicator import *          # noqa: F401,F403
from .ops import (init, crossover, mutation, selection, emo,  # noqa: F401
                  migration, constraint, indicator, hv)
from .utils.support import (Statistics, MultiStatistics, Logbook,  # noqa: F401
                            HallOfFame, ParetoFront, History)

# -- camelCase aliases (reference API names) --------------------------------
initRepeat = init.init_repeat
initIterate = init.init_iterate
initCycle = init.init_cycle

cxOnePoint = crossover.cx_one_point
cxTwoPoint = crossover.cx_two_point
cxTwoPoints = crossover.cx_two_point          # deprecated alias
cxUniform = crossover.cx_uniform
cxPartialyMatched = crossover.cx_partialy_matched
cxUniformPartialyMatched = crossover.cx_uniform_partialy_matched
cxOrdered = crossover.cx_ordered
cxBlend = crossover.cx_blend
cxSimulatedBinary = crossover.cx_simulated_binary
cxSimulatedBinaryBounded = crossover.cx_simulated_binary_bounded
cxMessyOnePoint = crossover.cx_messy_one_point
cxESBlend = crossover.cx_es_blend
cxESTwoPoint = crossover.cx_es_two_point
cxESTwoPoints = crossover.cx_es_two_point     # deprecated alias

mutGaussian = mutation.mut_gaussian
mutPolynomialBounded = mutation.mut_polynomial_bounded
mutShuffleIndexes = mutation.mut_shuffle_indexes
mutFlipBit = mutation.mut_flip_bit
mutUniformInt = mutation.mut_uniform_int
mutESLogNormal = mutation.mut_es_log_normal

selRandom = selection.sel_random
selBest = selection.sel_best
selWorst = selection.sel_worst
selTournament = selection.sel_tournament
selRoulette = selection.sel_roulette
selDoubleTournament = selection.sel_double_tournament
selStochasticUniversalSampling = selection.sel_stochastic_universal_sampling
selLexicase = selection.sel_lexicase
selEpsilonLexicase = selection.sel_epsilon_lexicase
selAutomaticEpsilonLexicase = selection.sel_automatic_epsilon_lexicase

selNSGA2 = emo.sel_nsga2
selTournamentDCD = emo.sel_tournament_dcd
sortNondominated = emo.sort_nondominated
sortLogNondominated = emo.sort_log_nondominated
assignCrowdingDist = emo.assign_crowding_dist
selNSGA3 = emo.sel_nsga3
selNSGA3WithMemory = emo.SelNSGA3WithMemory
uniformReferencePoints = emo.uniform_reference_points
selSPEA2 = emo.sel_spea2

migRing = migration.mig_ring

DeltaPenalty = constraint.DeltaPenalty
DeltaPenality = constraint.DeltaPenalty
ClosestValidPenalty = constraint.ClosestValidPenalty
ClosestValidPenality = constraint.ClosestValidPenalty
