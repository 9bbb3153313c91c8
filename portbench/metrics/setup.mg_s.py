"""The program's multigrid set-up laps, summed over those present
(``mg.hierarchy``: every level's triangles and maps; ``mg.schedules``: two
triangular-solve schedules a level; ``mg.ell``), s."""

from portbench.program import laps_of

read = laps_of("mg")
