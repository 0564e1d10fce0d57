"""Frames whose pose was published in the window, over the window's
seconds, session resets included."""


def read(run):
    return len(run.latencies_s) / run.seconds if run.latencies_s else None
