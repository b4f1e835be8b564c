"""setup_s: seconds from the process's start to the window's first call:
imports, the kernels' build on a checkout's first run, the inputs,
staging and the warm-up round trips."""


def read(run):
    if run.trace is not None:
        return None
    return run.setup_s
