"""setup_s: from the start of the run's process to the window's start:
imports, the program's builds (first run in a checkout), the database,
samples and file made from the seed, and the warm-up calls."""


def read(run):
    return run.setup_s
