"""Process start to the first timed request: CUDA context, kernel load or
build, the corpus drawn and inserted, the pools, the warm-up."""


def read(run):
    return run.setup_s
