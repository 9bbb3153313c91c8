"""Share of the traced slice's ELL products that ran on K8: the program's
``ell.launches`` over its ``ell.products`` (the PCG's SpMVs and the
V-cycle's, both counted at each replay of their graphs)."""

from portbench.ratios import ratio

read = ratio("ell.launches", "ell.products")
