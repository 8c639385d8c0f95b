"""The benchmark of ``sequila_tpu_torch`` on NVIDIA cards: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout.  It fails before it makes any input
where ``torch.cuda`` sees fewer cards than the cell asks for.  It prints,
as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which also end standard error.  It fails, and prints no result, if the
process has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    from benchmark import harness

    cells = {w["name"]: w for w in harness.manifest()["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); torch.cuda sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3

    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded modules it may not load: {', '.join(bad)}", file=sys.stderr)
        return 4
    print("timing " + " ".join(f"{k} {v:.3f}" for k, v in out["timing"].items()),
          file=sys.stderr)
    lat = [round(q["latency_s"] * 1e3, 1) for q in out["run"].queries]
    print(f"latency_ms of {len(lat)} queries, the first 40: {lat[:40]}", file=sys.stderr)
    for name, (value, limit) in out["checks"].items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    # the checkout's root, not this folder, heads the import path
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
