"""Self time of the program's ``bsm.spmm.dispatch`` span a product in the
traced slice (the density test, ``bsr_profitable``, ``ell_overhead``), ms."""

from portbench.program import self_ms

read = self_ms("bsm.spmm.dispatch")
