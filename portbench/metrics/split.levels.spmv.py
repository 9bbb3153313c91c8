"""K8 passes a product of the split rung runs after the pieces' pass (the
combine passes and the output pass) in the traced slice: the program's
``split.levels`` a request, passes."""

from portbench.program import counter

read = counter("split.levels")
