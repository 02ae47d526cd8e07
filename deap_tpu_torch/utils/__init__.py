"""Support utilities of the port: statistics, logbooks, archives and
genealogy (``support``), checkpoint / resume (``checkpoint``) and the
kernel build cache (``compilecache``)."""

from .support import (Statistics, MultiStatistics, Logbook, HallOfFame,
                      ParetoFront, History, hof_init, hof_update,
                      pareto_init, pareto_update)  # noqa: F401
from .checkpoint import save_checkpoint, load_checkpoint  # noqa: F401
