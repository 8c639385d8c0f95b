"""Mean launches per query of the port's hand CUDA kernels: the sum of
the program's ``launch.<kernel>`` counters (``pack_view``,
``merge_path``, ``unpermute_counts``, ``unpermute_ranks``,
``pair_merge``), each added at its launch."""

from benchmark import program


def read(run):
    return program.count_per_query(run, lambda name: name.startswith("launch."))
