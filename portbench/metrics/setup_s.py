"""setup_s: seconds from the process's start to the first timed call:
imports, the card's context, data, input chunks, builds of the
program's kernels and host engine where absent, and the warm-up."""


def read(run):
    return run.setup_s
