"""Process start to the window's start: imports, CUDA start-up, kernel and
runtime build or load, rendering the session, vocabulary and warm-up."""


def read(run):
    return run.setup_s
