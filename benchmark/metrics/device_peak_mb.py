"""Peak of the card's allocated memory over the window, in MB (1e6
bytes): ``torch.cuda.max_memory_allocated`` after a reset at the window's
start."""


def read(run):
    if run.memory_window_peak is None:
        return None
    return run.memory_window_peak / 1e6
