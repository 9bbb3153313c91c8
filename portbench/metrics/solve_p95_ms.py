"""95th percentile (nearest rank) of every solve's time from send to
synchronised result over the window, ms."""

from portbench import stats


def read(r):
    return stats.percentile(r.latency_s, 95) * 1e3
