"""Run one cell of the benchmark and print its result line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Reads ``BENCHMARK.json`` at the root of the checkout, finds the cell's
configuration, traffic mix, loop, limits and metric readers by name, runs
the cell on CUDA card 0, and prints as the last line of standard output one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit; the same numbers are the
last lines of standard error.  It exits with a nonzero code and prints no
result when there is no card, when the program is not in the checkout, or
when JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.core import env  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(message: str, code: int = 2) -> int:
    print(f"portbench: {message}", file=sys.stderr, flush=True)
    return code


def per_layer(manifest, workload: str, record) -> dict:
    """Each per-layer metric of the cell whose reader finds something."""
    out = {}
    for m in manifest.per_layer(workload):
        value = manifest.metric_reader(m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(outcome, metrics: dict, device: dict, breakdown=None) -> dict:
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    env.pin_caches()
    if not os.path.isdir(os.path.join(env.ROOT, env.PORT_PACKAGE)):
        return fail(f"the program ({env.PORT_PACKAGE}) is not in this checkout")
    from portbench.core.manifest import Manifest

    manifest = Manifest(env.ROOT)
    try:
        cell = manifest.workload(args.workload)
    except KeyError as err:
        return fail(str(err))
    try:
        env.require_cards(cell["chips"])
    except env.NoCard as err:
        return fail(str(err), 3)

    import torch

    from portbench.core.cell import Context
    from portbench.core.record import Record

    config = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    record = Record(args.workload, config, traffic) if args.trace else None
    ctx = Context(workload=args.workload, seed=args.seed, seconds=args.seconds, config=config,
                  traffic=traffic, limits=manifest.limits(args.workload),
                  device=torch.device("cuda", 0), t_start=T_START, record=record)
    torch.cuda.set_device(0)
    outcome = manifest.loop(traffic["loop"]).run(ctx)
    loaded = env.forbidden_loaded()
    if loaded:
        return fail(f"modules that must not load in a run are loaded: {loaded}", 4)
    device = env.device_info(cell["chips"], outcome.memory_peak_bytes)
    breakdown = None
    if args.trace:
        metrics = per_layer(manifest, args.workload, record)
        if record.profile is not None:
            device.update(busy_s=record.profile.busy_s, window_s=record.profile.window_s)
            breakdown = record.profile.breakdown()
    else:
        units = {m["name"]: m["unit"] for m in manifest.end_to_end(args.workload)}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in outcome.end_to_end.items() if k in units}
    line = result_line(outcome, metrics, device, breakdown)
    line_text = json.dumps(line)
    print(f"failed {outcome.failed} of {outcome.attempted}", file=sys.stderr)
    for c in outcome.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(line_text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
