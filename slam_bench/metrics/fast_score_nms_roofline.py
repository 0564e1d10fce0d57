"""fast_score_nms's share of its roofline in the traced stretch: the least
time of its launches (the larger of the operation and byte bounds at the
cell's pyramid, `peaks.fast_cells_work`) over their device time by name."""

from slam_bench import peaks

KERNEL = "fast_kernel<true>"  # the cell form's kernel in csrc/fast_score_nms.cu


def read(run):
    if run.trace is None:
        return None
    hits = [v for name, v in run.trace["by_name"].items() if KERNEL in name]
    n, sec = sum(v[0] for v in hits), sum(v[1] for v in hits)
    if n == 0 or sec <= 0:
        return None
    c = run.slam_cfg
    ops, n_bytes = peaks.fast_cells_work(c["height"], c["width"], c["n_levels"], c["scale_factor"])
    return 100.0 * n * peaks.least_seconds(ops, n_bytes) / sec
