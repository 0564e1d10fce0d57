"""Kernel events in the traced stretch over the frames published in it."""


def read(run):
    if run.trace is None or not run.trace_frames:
        return None
    return run.trace["kernels"] / run.trace_frames
