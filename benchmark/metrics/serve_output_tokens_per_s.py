"""Tokens streamed inside the window, over the window's seconds."""


def read(run):
    if run["kind"] != "serve":
        return None
    return run["tokens_in_window"] / run["window_s"]
