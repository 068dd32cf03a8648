"""setup_s: seconds from the process's start to the first timed request
(imports, kernel loads or builds, inputs made from the seed, warm-up)."""


def read(run):
    return run.setup_s
