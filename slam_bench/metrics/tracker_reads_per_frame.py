"""Device-to-host reads counted under the tracker's role (`sync.BY_ROLE`)
in the window, over the frames submitted."""


def read(run):
    n = run.counters_end["reads"].get("tracker", 0) - run.counters_start["reads"].get("tracker", 0)
    return n / run.attempted if run.attempted else None
