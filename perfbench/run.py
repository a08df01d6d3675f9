"""Run one cell of the benchmark of ``anytime3d_tpu_torch`` once, on the card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Finds the cell and its files by name
(``BENCHMARK.json``; ``harness.py``), sets the program up from the seed,
counts that as ``setup_s``, drives the window for ``--seconds`` and checks
the program against the plain reference once the window has closed: a
serve cell's answers served in the window; a train cell's first steps,
which set-up drove through the same trainer object and the same step call
that the window then drives on (``judge.py``). The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device`` (with ``--trace 1``
also ``busy_s`` and ``window_s`` of the traced part of the window), with
``--trace 1`` ``breakdown``, and last ``checks``: each compared number beside
its limit, as the last lines of standard error say too.

Exits without a result: 2 where the cell or its files are missing, 3 without
a CUDA card (or with fewer than the cell asks for), 4 where the port cannot
be imported, 5 where JAX, flax or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def say(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    from perfbench import harness, judge

    os.environ.update(harness.cache_env())
    try:
        cell = harness.find_cell(harness.load_benchmark(), args.workload)
    except (OSError, KeyError, ValueError, StopIteration) as e:
        say(f"cannot find the cell: {e!r}")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        say(f"needs {cell.chips} CUDA card(s); torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    try:
        import anytime3d_tpu_torch  # noqa: F401
    except ImportError as e:
        say(f"cannot import the port: {e!r}")
        return 4
    driver_class = harness.driver_class(cell.traffic["kind"])
    t_import = time.perf_counter()
    torch.cuda.set_device(0)
    torch.empty(1, device="cuda")
    t_cuda = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):  # the program's own progress lines
        drv = driver_class(cell, args.seed, "cuda")
        drv.setup(trace=bool(args.trace))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - T_START
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gc.collect()
        gc.freeze()  # set-up's objects stay out of the collections the window would pay for
        drv.window(args.seconds, tempfile.gettempdir() if args.trace else None)
        window_peak = torch.cuda.max_memory_allocated()
        e2e = drv.end_to_end()
        attempted, failed = drv.attempted_failed()
        readings = drv.readings() if args.trace else None
        drv.release()
        numbers, _ = drv.check()
    found = harness.forbidden_modules()
    if found:
        say(f"loaded modules of JAX or the JAX package: {found}")
        return 5

    correct, checks = judge.verdict(numbers, cell.limits)
    correct = correct and failed == 0
    device = dict(harness.card(torch), memory_peak_bytes=int(max(setup_peak, window_peak)))
    breakdown = None
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = harness.metric_reader(m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        trace = readings.trace
        if trace is None or not trace.device:
            say("the profiler traced no device operation")
            return 6
        device.update(busy_s=trace.busy_us() / 1e6, window_s=trace.window_us / 1e6)
        breakdown = {"device_ops": trace.device_ops(10), "idle_gaps": trace.idle_gaps(10)}
    else:
        e2e.update(setup_s=setup_s, peak_mem_gib=window_peak / 2**30)
        units = harness.units(cell.end_to_end)
        metrics = {name: {"value": float(e2e[name]), "unit": units[name]} for name in units}
    marks = [("imports", t_import), ("cuda", t_cuda)] + drv.marks
    phases = ", ".join(f"{name} {t - T_START:.2f}" for name, t in marks)
    say(f"card: {harness.power_limit()}; setup_s {setup_s} (seconds from the start: {phases}); "
        f"attempted {attempted}, failed {failed}")
    for name, value, limit in checks:
        say(f"check {name} {value!r} limit {limit!r}")
    say(f"correct {correct}")
    print(harness.result_line(correct, attempted, failed, metrics, device, breakdown, checks), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
