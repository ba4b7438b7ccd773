"""A-K1-3's share of their roofline over the profiled training steps, in
%: the operations the flash forward and backward need for every layer's
causal attention (4 + 10 per visible pair per head dimension) at the bf16
peak, against the device time of the three kernels."""

from benchmark.roofline import counts

KERNELS = ("flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc")


def read(run):
    trace = run.get("trace")
    if run["kind"] != "train" or trace is None or not run["traced_steps"]:
        return None
    seconds = sum(trace.op_seconds(k)[0] for k in KERNELS)
    if seconds <= 0:
        return None
    mix = run["mix"]
    cost = counts.flash_train_cost(run["dims"], mix["batch"], mix["seq"])
    least = counts.least_time(cost["flops"] * run["traced_steps"],
                              cost["bytes"] * run["traced_steps"],
                              counts.peaks(run["device_name"]))
    return 100.0 * least / seconds
