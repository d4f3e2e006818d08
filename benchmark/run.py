"""Run one benchmark cell once on this machine's card and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics (``frames_per_s`` and ``setup_s``);
``--trace 1`` the per-layer metrics of ``benchmark/metrics/``, read from a
window run under ``torch.profiler`` and the program's ``AG_TIMELINE``
spans. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` when
traced, and last ``checks``: each number compared with its limit); the
last lines of standard error are the same checks. The run exits 2, and
prints no result, without a CUDA card or with fewer cards than the cell
takes, and 3 if the process holds the JAX package or JAX after the window.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), so that set-up counts
    the interpreter's own start."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def main(argv=None) -> int:
    started = time.time() - process_age_s()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    # kernel caches of the libraries the program may use stay in the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    import torch

    from benchmark import harness, traffic

    chips = int(traffic.load_json("workloads", args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"no result: the cell takes {chips} CUDA card(s); "
                    f"available: {torch.cuda.is_available()}, "
                    f"count: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           device="cuda", started=started)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"no result: the process holds {', '.join(found)}")
        return 3
    dev = out["device"]
    harness.log(f"card: {dev['kind']} ({torch.cuda.device_count()} visible), power limit "
                f"{dev.pop('power_limit')}, "
                f"setup_s {out.pop('setup_s')}")
    checks = out.pop("checks")
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
              "metrics": out["metrics"], "device": dev}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result.update(workload=args.workload, seed=args.seed, checks=checks)
    for name, c in checks.items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
