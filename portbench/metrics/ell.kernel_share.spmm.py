"""Share of the traced slice's ELL products that ran on K8: the program's
``ell.launches`` over its ``ell.products`` (the N = 32 products' ELL
rung)."""

from portbench.ratios import ratio

read = ratio("ell.launches", "ell.products")
