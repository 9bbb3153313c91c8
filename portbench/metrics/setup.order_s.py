"""The direct solver's ordering lap (its ``timings["order"]``), s."""


def read(r):
    return r.program.get("timings.order")
