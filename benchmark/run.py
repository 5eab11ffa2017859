#!/usr/bin/env python3
"""Run one cell of the benchmark of ``pythonic_disort_torch`` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is found by name in
``BENCHMARK.json``: its configuration file, its traffic file
(``benchmark/traffic/<traffic>.json``), the traffic's driver
(``benchmark/drivers/<driver>.py``), and one reader a metric
(``benchmark/end_to_end/<name>.py``, ``benchmark/metrics/<name>.py``).

Set-up builds the driver (its inputs from the seed) and runs one step of
the cell's traffic, which builds or loads the port's kernels; then the
window runs steps for ``--seconds``.  With ``--trace 1`` a few more steps
run under ``torch.profiler`` and the per-layer metrics are read from them.
Last, the outputs the window produced are compared with the float64
reference, and one JSON line is printed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))
if str(ROOT) not in sys.path:
    sys.path.insert(1, str(ROOT))

from yardstick import compare  # noqa: E402
from yardstick.probe import Probe  # noqa: E402

# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "pythonic_disort_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_module(path):
    """Import the file ``path`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(f"bench_{path.parent.name}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"BENCHMARK.json has no {what} named {name!r}")


def resolve(workload, root=ROOT, overrides=None):
    """Everything the cell named ``workload`` needs, found by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = by_name(bench["workloads"], workload, "workload")
    entry = by_name(bench["configs"], cell["config"], "configuration")
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    for name, values in (overrides or {}).items():
        {"config": config, "traffic": traffic}[name].update(values)
    end_to_end = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return types.SimpleNamespace(cell=cell, config=config, traffic=traffic, end_to_end=end_to_end,
                                 per_layer=per_layer, driver=HERE / "drivers" / f"{traffic['driver']}.py")


def stage_kernels():
    """{stage: kernel names}: one file a kernel under ``benchmark/stages/<stage>/``."""
    return {d.name: {f.read_text().strip() for f in d.glob("*.txt")}
            for d in sorted((HERE / "stages").iterdir()) if d.is_dir()}


def forbidden_modules(names=None):
    """The forbidden top-level names among ``names`` (default: the modules
    loaded), compared whole: ``pythonic_disort_torch`` is not
    ``pythonic_disort_tpu``."""
    return sorted({name.split(".")[0] for name in (sys.modules if names is None else names)} & set(FORBIDDEN))


def read_metrics(entries, folder, ctx):
    """{name: {"value", "unit"}} of every metric whose reader finds
    something to read."""
    out = {}
    for m in entries:
        value = load_module(HERE / folder / f"{m['name']}.py").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def power_limit():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=20)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else None
    except (OSError, subprocess.SubprocessError):
        return None


def traced(drv, probe, steps, first, torch, cuda):
    """``steps`` more steps under ``torch.profiler``, inside a
    ``bench.window`` span; returns the reduced trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from yardstick.trace import Trace

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    probe.tracing = True
    with profile(activities=activities) as prof:
        with record_function("bench.window"):
            for i in range(first, first + steps):
                drv.step(i)
            if cuda:
                torch.cuda.synchronize()
    probe.tracing = False
    return Trace(prof.events())


def run_cell(workload, seed, seconds, trace, device="cuda", overrides=None, root=ROOT, t0=None, patch=None):
    """Run the cell once; returns the result line's object.  ``device``
    "cpu" and ``patch`` (a function of the driver, called before set-up's
    step) serve the tests of the harness."""
    t0 = T0 if t0 is None else t0
    spec = resolve(workload, root, overrides)
    import torch

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    probe = Probe(sync)
    drv = load_module(spec.driver).Driver(spec.config, spec.traffic, seed, device, probe)
    if patch is not None:
        patch(drv)
    drv.warm()
    sync()
    probe.clocks.clear()
    setup_s = time.perf_counter() - t0

    steps, failed, i = [], 0, 0
    start = time.perf_counter()
    while True:
        a = time.perf_counter()
        try:
            done = drv.step(i)
        except Exception:           # a failed step is counted and the window goes on
            if not failed:
                traceback.print_exc()
            failed, done = failed + 1, 0
        b = time.perf_counter()
        steps.append((a, b, done))
        i += 1
        if b - start >= seconds:
            break
    window_s = steps[-1][1] - start
    memory = torch.cuda.max_memory_allocated() if cuda else 0

    tr = traced(drv, probe, spec.traffic["trace_steps"], i, torch, cuda) if trace else None
    ctx = types.SimpleNamespace(
        config=spec.config, traffic=spec.traffic, steps=steps, window_s=window_s, setup_s=setup_s,
        clocks=probe.clocks, trace=tr, trace_steps=spec.traffic["trace_steps"], shapes=drv.shapes(),
        dtype=spec.config["dtype"], stage_kernels=stage_kernels())
    metrics = read_metrics(spec.per_layer, "metrics", ctx) if trace else read_metrics(spec.end_to_end,
                                                                                      "end_to_end", ctx)
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": spec.cell["chips"],
           "memory_peak_bytes": int(memory)}
    if cuda:
        dev["power_limit"] = power_limit()
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)

    drv.release()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = drv.readings()
    log(f"reference and comparison: {time.perf_counter() - t_ref:.1f} s; window {window_s:.3f} s, "
        f"{len(steps)} steps, set-up {setup_s:.3f} s")
    result = {"correct": failed == 0 and compare.passed(checks), "attempted": len(steps), "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_by_host()}
    result["checks"] = checks
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    chips = resolve(args.workload).cell["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"the cell needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(args.workload, args.seed % 2**63, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"the run imported {', '.join(found)}: the benchmark measures pythonic_disort_torch alone")
        return 3
    emit(result)
    return 0


def emit(result):
    """Each compared number beside its limit as the last lines of standard
    error, then the result as the last line of standard output."""
    for name, r in result["checks"].items():
        log(f"check {name}: {r['value']!r} (limit {r['limit']!r})")
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
