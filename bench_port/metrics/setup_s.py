"""setup_s: seconds from the run's start to the window's: importing,
building the configuration on the card from the seed, the reference audio,
the kernels' first build or load, and warming one request of each size."""


def read(run):
    return run.setup_s
