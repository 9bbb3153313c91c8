"""Slots the split rung's K8 passes read per stored entry in the traced
slice: the program's ``split.slots`` over its ``split.entries`` (the
pieces' padding, the combine passes and the output pass), slots/entry."""

from portbench.ratios import ratio

read = ratio("split.slots", "split.entries")
