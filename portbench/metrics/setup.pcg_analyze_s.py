"""The program's IC(0) set-up lap ``pcg.analyze`` (the symbolic analysis of
``PCGSetup.build``), s."""

from portbench.program import lap

read = lap("pcg.analyze")
