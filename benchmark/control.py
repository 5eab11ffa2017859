#!/usr/bin/env python3
"""The control of a cell's comparison: the float64 reference computed
instead in the nearest precision below the configuration's (float32 for
float64; TF32, float32's range with a 10-bit mantissa, for float32): every
stage's result rounded to it.  It is put in the program's place and read
by the cell's own comparison; a sound limit lies below every reading this
prints.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...] [--calls <n>]

``--calls``: the calls a window makes, for a cell of single calls (the
compared calls are drawn among them).  Needs no card; the benchmark's
runs never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run  # noqa: E402
from yardstick import reference  # noqa: E402
from yardstick.probe import Probe  # noqa: E402


def readings(workload, seed, calls=750, overrides=None, root=run.ROOT):
    spec = run.resolve(workload, root, overrides)
    drv = run.load_module(spec.driver).Driver(spec.config, spec.traffic, seed, "cpu", Probe(lambda: None))
    drv.control(reference.LOWER[spec.config["dtype"]], calls)
    return drv.readings()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--calls", type=int, default=750)
    args = p.parse_args(argv)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(args.workload, seed, args.calls)
        print(json.dumps({"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t0,
                          "checks": r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
