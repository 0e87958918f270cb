"""Readings of a cell's control on the card: the program told the
configuration's `control` settings (one broken guarantee; the frames and
the reference keep the published ones), at the cell's own size, one run
per seed in one process. Prints one JSON line per seed with the numbers
`correct` compares. The benchmark's own runs never run it.

    python3 perf_bench/control.py --workload <cell> --seconds <s> --seeds 1,2,3
"""

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)  # one process, few threads: the host path is the program's

    from perf_bench import harness
    from perf_bench.manifest import Manifest

    if not torch.cuda.is_available():
        sys.exit("perf_bench.control: no CUDA device")
    manifest = Manifest(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        head = {"workload": args.workload, "seed": seed}
        try:
            res = harness.run_cell(manifest, args.workload, seed, args.seconds, False,
                                   t_start=time.perf_counter(), control=True)
        except Exception as e:  # a run that crashes gives no number; the next seed runs
            traceback.print_exc()
            print(json.dumps({**head, "crashed": f"{type(e).__name__}: {e}"}), flush=True)
            continue
        print(json.dumps({**head, "frames": res["frames"], "numbers": res["numbers"]},
                         default=float), flush=True)


if __name__ == "__main__":
    main()
