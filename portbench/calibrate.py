"""Readings for setting a cell's correctness limits, in one process.

    python3 portbench/calibrate.py --workload NAME --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 3] [--out FILE]

For each of ``--seeds`` it runs the cell as ``run.py`` does, with a short
window, and prints the program's readings of every compared number; for each
of ``--control-seeds`` it prints the readings of the stand-ins that the
comparison has to reject, put in the program's place at the cell's sizes:
for extraction the reference in float8 (``fp8``); for a sweep the reference
with TF32 on (``tf32``) and with half of each batch left out
(``half_batch``).  Each line is one JSON object; ``--out`` also writes them
to a file.  Limits go into ``limits/<workload>.json`` by hand, from these
readings, with the reasons in ``PERF.md``.
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


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    env.pin_caches()
    import torch

    from portbench.core.cell import Context
    from portbench.core.manifest import Manifest

    manifest = Manifest(env.ROOT)
    cell = manifest.workload(args.workload)
    env.require_cards(cell["chips"])
    config, traffic = manifest.config(cell["config"]), manifest.traffic(cell["traffic"])
    loop = manifest.loop(traffic["loop"])
    dev = torch.device("cuda", 0)
    lines = []

    def emit(obj):
        obj = {"workload": args.workload, "power": env.power_limit(), **obj}
        lines.append(json.dumps(obj))
        print(lines[-1], flush=True)

    def context(seed):
        return Context(workload=args.workload, seed=seed, seconds=args.seconds, config=config,
                       traffic=traffic, limits={}, device=dev, t_start=time.perf_counter())

    for seed in _seeds(args.seeds):
        out = loop.run(context(seed))
        emit({"side": "program", "seed": seed, "readings": out.notes["readings"],
              "check_s": out.notes["check_s"], "end_to_end": out.end_to_end,
              **({"worst_leaves": out.notes["worst_leaves"]} if "worst_leaves" in out.notes
                 else {})})
        del out
        torch.cuda.empty_cache()
    for seed in _seeds(args.control_seeds):
        emit({"seed": seed, **stand_ins(traffic["loop"], loop, context(seed), dev)})
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


def stand_ins(kind: str, loop, ctx, dev) -> dict:
    """The readings of the stand-ins for one seed."""
    if kind == "extract":
        from portbench.checks import extract as checks
        from portbench.core.inputs import image_pool, prompt_tokens

        tr, cfg = ctx.traffic, ctx.config
        pool = image_pool(ctx.seed, tr["pool_batches"], tr["batch"], tr["height"], tr["width"], dev)
        tokens = prompt_tokens(ctx.seed, tr["prompts"], cfg["context_length"], cfg["vocab_size"],
                               device=dev)
        return {"side": "fp8", "readings": checks.control_readings(cfg, ctx.seed,
                                                                    tr["check_images"], pool,
                                                                    tokens, dev)}
    from portbench.checks import sweep as checks

    out = loop.run(ctx)  # the program's sweep gives phase 2 its starting state
    n = out.notes
    found = {}
    for variant in ("tf32", "half_batch"):
        side = checks.reference_steps(ctx.traffic, n["data"], n["inits"], sorted(n["recordings"]),
                                      dev, variant=variant, program=n["recordings"])
        found[variant] = checks.readings(side, n["reference"])
    return {"side": "stand_ins", "readings": found, "program": n["readings"]}


if __name__ == "__main__":
    sys.exit(main())
