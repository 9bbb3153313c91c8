"""The program's SpMM format laps at set-up, summed over those present
(``spmm.bsr_fill``, ``spmm.bsr_convert``, ``spmm.ell_convert``,
``spmm.stream_plan``, ``spmm.dense_convert``), s."""

from portbench.program import laps_of

read = laps_of("spmm")
