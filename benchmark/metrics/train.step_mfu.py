"""The training step's model operations per second over the bf16 peak, in
%: 6 per matmul parameter per token plus attention's 12 per visible pair
per head dimension (remat's recompute not counted), over the mean time of
the window's steps that were not profiled."""

from benchmark.roofline import counts


def read(run):
    if run["kind"] != "train":
        return None
    times = run["step_times"][run["traced_steps"]:]
    if not times:
        return None
    mix = run["mix"]
    flops = counts.train_step_flops(run["dims"], mix["batch"], mix["seq"])
    peak = counts.peaks(run["device_name"])["bf16_flops_per_s"]
    return 100.0 * flops / (sum(times) / len(times)) / peak
