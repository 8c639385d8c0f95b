"""Share (%) of the count's roofline that the kernels of the window's
queries reach: the least time of each query's count (``roofline``: both
tables' bounds and keys read once, from their row counts) summed over
the queries, over the device time of every kernel the profiler saw in
the window.  It reads the work from the inputs, not from the program's
padding or layout, so it is the same yardstick whatever the program
runs."""

from benchmark import roofline, tracing


def read(run):
    if not run.device_events:
        return None
    kernel_s = sum(e - s for n, s, e in run.device_events if tracing.is_kernel(n)) / 1e9
    if kernel_s <= 0:
        return None
    tables = run.traffic["join"]
    least = sum(roofline.count_bound_s(*(run.inputs.tables[t].rows for t in tables))
                for q in run.queries if "answer" in q)
    return 100.0 * least / kernel_s
