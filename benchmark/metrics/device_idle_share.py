"""Share (%) of the traced window in which no operation ran on the card
(``torch.profiler``: kernels, copies and fills)."""


def read(run):
    if run.busy_s is None or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
