"""Graph nodes the program replays a solve in the traced slice (its
``graphs.nodes`` counter: each replayed graph's node count, read at its
capture), nodes."""

from portbench.program import counter

read = counter("graphs.nodes")
