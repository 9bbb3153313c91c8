"""Triangular-solve levels a launch of the level-step kernel in the traced
slice: the program's ``trsv.levels`` over its ``trsv.launches`` (counted at
each solve, those inside replayed graphs included), levels."""

from portbench.ratios import ratio

read = ratio("trsv.levels", "trsv.launches")
