"""Device time of the traced slice's graph replays (the program's CUDA
event pairs around each replay) over the nodes replayed, us a node."""

from portbench.program import node_us as read  # noqa: F401
