"""The product's share of its roofline: the least time its work could take
on the card (portbench.costs, from the data) over the device time a product
took in the traced slice, %."""

from portbench import costs, readers


def read(r):
    peak = costs.peaks(r.device_kind)
    dev = readers.device_s(r)
    if not r.cost or peak is None or dev is None:
        return None
    return 100.0 * costs.bound_s(r.cost, peak) / dev
