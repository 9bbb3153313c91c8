"""Host time of a product call from send to its return, before the
synchronise (entry, dispatch and launch), mean over the window, ms."""


def read(r):
    return sum(r.host_s) / len(r.host_s) * 1e3
