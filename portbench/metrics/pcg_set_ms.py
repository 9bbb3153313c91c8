"""The window's seconds over the PCG sets it completed, ms a set."""


def read(r):
    return r.window_s / len(r.latency_s) * 1e3
