"""Share of the triangular solves' levels that the level-step kernel's
dataflow chains walk in the traced slice: the program's
``trsv.dataflow_levels`` over its ``trsv.levels`` (both counted at each
solve, those inside replayed graphs included)."""

from portbench.ratios import ratio

read = ratio("trsv.dataflow_levels", "trsv.levels")
