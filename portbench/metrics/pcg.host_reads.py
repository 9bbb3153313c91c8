"""Host reads of device values a PCG set in the traced slice (the
program's ``pcg.host_reads``: a flag a chunk, the iteration count and the
residual), reads."""

from portbench.program import counter

read = counter("pcg.host_reads")
