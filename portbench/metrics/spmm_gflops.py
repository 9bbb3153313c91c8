"""Products' operations (2·nnz·N each) over the window's seconds, GFLOP/s."""


def read(r):
    if not r.cost:
        return None
    return r.cost["flops"] * len(r.latency_s) / r.window_s / 1e9
