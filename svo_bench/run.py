"""The benchmark's one command: one run of one cell.

    python3 svo_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  Prints the run's log and, as its last
lines, each number the check compared beside its limit on standard
error, and the result as one JSON object on the last line of standard
output.  Exits with 2, printing no result, where the card or cards the
cell asks for are missing, and with 3 where a module of JAX or of the
JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="judge the reference on bfloat16 inputs in the "
                         "program's place (the low-precision control; "
                         "not part of a benchmark run)")
    args = ap.parse_args(argv)

    # one host thread: the intra-op pool's spinning threads would share
    # the host's cores with the thread that feeds the card
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    # every build and kernel cache inside the checkout, at fixed paths
    cache = REPO / "build" / "svo_bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(REPO))

    import torch
    torch.set_num_threads(1)
    with open(REPO / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    chips = cells.get(args.workload, {}).get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"svo_bench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2

    from svo_bench import harness
    out, info = harness.run(args.workload, args.seed, args.seconds,
                            bool(args.trace), bench, torch.device("cuda", 0),
                            T_START, control=args.control)
    harness.log(f"log {json.dumps(info, default=float)}")
    if info["forbidden"]:
        print(f"svo_bench: loaded after the window: {info['forbidden']}",
              file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
