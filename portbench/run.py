#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the cell's checks on standard error, each number beside its
limit, and the result as one JSON line, last on standard output. Exits
non-zero and prints no result when the card or the program is missing,
or when JAX or the JAX package has been imported.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    bench_file = ROOT / "BENCHMARK.json"
    if not bench_file.exists() or not (ROOT / "src" / "repro_torch").is_dir():
        print("portbench: BENCHMARK.json or src/repro_torch is missing",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import harness
    spec = harness.Spec(json.loads(bench_file.read_text()), args.workload)
    if not harness.has_chips(spec.chips):
        print(f"portbench: {args.workload} needs {spec.chips} CUDA device(s)",
              file=sys.stderr)
        return 3
    result = harness.run(spec, args.seed, args.seconds, bool(args.trace),
                         t_start=T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules imported: {bad}", file=sys.stderr)
        return 4
    print(f"notes {json.dumps(result['notes'])}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
