"""Graph nodes the program replays a 50-iteration set in the traced slice (its
``graphs.nodes`` counter: each replayed graph's node count, read at its
capture), nodes."""

from portbench.program import counter

read = counter("graphs.nodes")
