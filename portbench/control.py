"""The readings that the check's limits are set from, at a cell's own size.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \
        --seconds 4 [--out readings.jsonl]

For each seed: a run of the cell as ``portbench.run`` makes it (set-up,
warm-up, a short window with its kept step, the program freed), then the
check twice on the same kept step: the program's numbers (the lower
readings), and the control's, the reference at the precision one step
below the program's in the program's place (the upper readings).  One
JSON line per seed.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    from portbench import run

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = run.load_json(Path.cwd() / "BENCHMARK.json")
    _, cfg, traffic, limits = run.cell_files(bench, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        _, step = run.run_cell(cfg, traffic, seed, args.seconds, False,
                               "cuda:0", t0)
        line = {"workload": args.workload, "seed": seed,
                "program": run.judge(step, cfg, traffic, limits, seed),
                "control": run.judge(step, cfg, traffic, limits, seed,
                                     lower=True),
                "seconds": time.perf_counter() - t0}
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        del step
    return 0


if __name__ == "__main__":
    sys.exit(main())
