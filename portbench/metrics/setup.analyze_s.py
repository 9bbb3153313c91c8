"""The direct solver's symbolic-analysis lap (its ``timings["analyze"]``),
s."""


def read(r):
    return r.program.get("timings.analyze")
