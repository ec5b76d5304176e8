"""The control and the planted faults at a cell's own size, on the card.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 [--variants program control hold_state ...]

For each seed it makes the cell's clip and runs one round trip of each
variant, judged by ``reference.py`` as a benchmark run judges its
window: ``program`` is the cell as configured; ``control`` is the
program's own lower-precision path, the near-lossless ``exact=False``
mode, which breaks the configuration's lossless guarantee; the others
are the faults of ``faults.py`` planted in the program.  One JSON line a
seed and variant: the numbers compared and whether the run passed (a
run that raises does not pass).  The benchmark's own runs never run this.
"""

import argparse
import contextlib
import json
import os
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import faults, reference, run  # noqa: E402

VARIANTS = ("program", "control") + faults.FAULTS


def variant_config(config: dict, variant: str) -> dict:
    if variant != "control":
        return config
    return dict(config, compressor=dict(config["compressor"], exact=False))


def read(cell_config, traffic, seed, variant, device, clip=None):
    """One line: the numbers compared and whether the run passed.  A run
    that raises ends with no result, as in ``run.py``, and does not pass:
    its line gives the error in place of the numbers."""
    config = variant_config(cell_config, variant)
    fault = (faults.planted(variant) if variant in faults.FAULTS
             else contextlib.nullcontext())
    t = time.perf_counter()
    try:
        with fault:
            out = run.run_cell(config, traffic, seed, 0, device=device,
                               t0=t, log=lambda msg: None, clip=clip)
    except Exception as exc:
        traceback.print_exc(file=sys.stderr)
        return {"seed": seed, "variant": variant,
                "errors": ["".join(traceback.format_exception_only(exc))
                           .strip()],
                "passed": False, "seconds": time.perf_counter() - t}
    return {"seed": seed, "variant": variant, **out["numbers"],
            "errors": [r["error"] for r in out["runs"] if r["error"]],
            "passed": out["failed"] == 0
            and reference.within_limits(out["numbers"]),
            "seconds": time.perf_counter() - t}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=VARIANTS)
    args = ap.parse_args(argv)
    _, config, traffic = run.resolve(run.load_spec(), args.workload)
    for seed in args.seeds:
        clip = run.make_clip(config, traffic, seed)
        for variant in args.variants:
            line = read(config, traffic, seed, variant, "cuda:0", clip)
            print(json.dumps({"workload": args.workload, **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
