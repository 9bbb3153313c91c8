"""The program's IC(0) set-up lap ``pcg.schedules`` (both triangular-solve
schedules, with the factor's transpose), s."""

from portbench.program import lap

read = lap("pcg.schedules")
