"""setup_s: seconds from the process's start to the window's start (build, weights, inputs, warm-up, capture)."""


def read(run):
    return run.setup_s
