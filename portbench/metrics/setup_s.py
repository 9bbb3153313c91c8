"""Process start to the first timed request, s: building the operator,
the program's set-up, compiling and warming up."""


def read(r):
    return r.setup_s
