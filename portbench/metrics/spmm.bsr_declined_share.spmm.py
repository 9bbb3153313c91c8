"""Share of the traced slice's card kernel choices that declined K1 where
``bsr_profitable`` held: the program's ``spmm.card.bsr_declined`` over its
``spmm.card.decisions`` (the N = 256 products' choice of K1, K2 or K8)."""

from portbench.ratios import ratio

read = ratio("spmm.card.bsr_declined", "spmm.card.decisions")
