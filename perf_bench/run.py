"""Run one cell of the benchmark of `sdslam_tpu_torch` once:

    python3 perf_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds (first run of a checkout) or loads the port's kernels, renders the
cell's frames from the seed on the card, warms up, offers frames to the
SLAM facade in a closed loop for `--seconds`, checks what the timed path
produced against the truth and the plain ORB reference, and prints one
JSON line last on standard output: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device`, with `--trace 1` `breakdown`, and last
`checks` (each compared number with its limit, also printed last on
standard error). Exits nonzero without a printed result when no CUDA card
is present, when a cell needs more cards than there are, or when JAX or
the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# a library that can load JAX by itself must not (transformers reads this)
os.environ.setdefault("USE_FLAX", "0")
# kernel caches at fixed paths inside the checkout (the port's nvcc builds
# go to sdslam_tpu_torch/_build/ by its own rule)
CACHE = ROOT / "perf_bench" / "_cache"
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))


def plain(x):
    """JSON-safe: a number that is not finite (an answer that never came)
    becomes null."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def fail(msg: str, code: int = 2):
    print(f"perf_bench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)  # one process, few threads: the host path is the program's

    from perf_bench import check, harness
    from perf_bench.manifest import Manifest

    manifest = Manifest(ROOT)
    cell = manifest.workload(args.workload)
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < int(cell["chips"]):
        fail(f"the cell needs {cell['chips']} cards, {torch.cuda.device_count()} present")
    res = harness.run_cell(manifest, args.workload, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_start=T_START)
    limits = manifest.limits(args.workload)
    ok, checks = check.judge(res["numbers"], limits)
    if args.trace:
        metrics = {}
        for m in manifest.metrics_for("per_layer", args.workload):
            v = manifest.layer_reader(m["name"])(res["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": res["e2e"][m["name"]], "unit": m["unit"]}
                   for m in manifest.metrics_for("end_to_end", args.workload)}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": int(res["memory_peak_bytes"]),
              "power_limit": power_limit()}
    line = {"correct": ok, "attempted": res["frames"], "failed": res["numbers"]["failed"],
            "metrics": metrics, "device": device}
    if args.trace:
        t = res["ctx"]["trace"]
        device["busy_s"], device["window_s"] = t["busy_s"], t["window_s"]
        line["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    line["checks"] = checks
    info = {k: v for k, v in res["numbers"].items() if k not in checks}
    info.update(res["diag"])
    print(f"perf_bench: {args.workload} seed {args.seed}: {json.dumps(plain(info))}",
          file=sys.stderr)
    loaded = harness.no_jax_loaded(sys.modules)
    if loaded:
        fail(f"JAX or the JAX package was loaded: {loaded}", 3)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(plain(line)), flush=True)


if __name__ == "__main__":
    main()
