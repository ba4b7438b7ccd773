"""Tokens of every step in the window over the window's seconds; each step
ends in a synchronize."""


def read(run):
    if run["kind"] != "train" or run["traced_steps"]:
        return None
    return run["tokens_per_step"] * len(run["step_times"]) / run["window_s"]
