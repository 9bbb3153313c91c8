"""Host clock around ``PCGSetup.build`` (IC(0) analysis, factor, solve
schedules, ELL view) to the device's synchronise, s."""


def read(r):
    return r.spans.get("pcg_build")
