"""Share (%) of the traced control steps' wall time in which no kernel,
copy or memset ran on the card."""


def read(run):
    t = run.traced
    if t is None or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
