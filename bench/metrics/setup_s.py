"""Process start to the first request due in the window: imports, kernel
builds, weights, the engine, its first steps and the traffic's warm-up."""


def read(run):
    return run.served.setup_s
