#!/usr/bin/env python3
"""Readings of a cell's compared numbers on many seeds in one process:
the program's (the lower readings) and the control's (the upper ones).

    python3 portbench/control.py --workload <name> --seeds 1 2 3 ... [--seconds 3]

The control is the plain reference computed in the precision below the
configuration's: every weight product's operands rounded to per-tensor
scaled float8 (e4m3) where the configuration states bf16 weights, and
the f32 LoRA adapters rounded to bf16; it stands in the program's place
and is judged by the same numbers. Prints one JSON line a seed, with
the harness's verdict on each side under the cell's limits
(``limits/<cell>.json``, set from these readings).
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_readings(drv) -> list:
    from portbench.reference.model import bf16, fp8
    kind = drv.spec.traffic["driver"]
    if kind == "prefill":
        gaps = drv.reference_gaps(drv.sample(), lowp=fp8)
        return [("served_logit_gap", max(gaps))]
    if kind == "fl_lora":
        ref = drv.follow(drv.reference())
        ctl = drv.follow(drv.reference(lowp=fp8, adapter_lowp=bf16))
        return drv.readings(ref, prog=[(l, q, a) for l, q, a in ctl])
    if kind == "fedsgd":
        return drv.readings(drv.follow(drv.reference()),
                            prog=drv.follow(drv.reference(lowp=fp8)))
    raise ValueError(kind)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--detail", action="store_true",
                    help="print where the fl_lora readings come from")
    ap.add_argument("--no-control", action="store_true",
                    help="the program's readings only")
    ap.add_argument("--faults", action="store_true",
                    help="also plant each of the cell's faults and read it")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from portbench import harness
    from portbench.yardstick.spans import Spans
    spec = harness.Spec(json.loads((ROOT / "BENCHMARK.json").read_text()),
                        args.workload)
    dev = torch.device("cuda")
    for seed in args.seeds:
        t = time.perf_counter()
        drv = harness.driver_class(spec)(spec, seed, dev, Spans(), args.seconds)
        drv.setup()
        win = drv.window(args.seconds)
        drv.release()
        prog = drv.check()
        t_ref = time.perf_counter()
        ctl = [] if args.no_control else control_readings(drv)
        if args.detail:
            from portbench.reference.model import bf16, fp8
            ref = drv.follow(drv.reference())
            print(json.dumps({"seed": seed, "program": drv.detail(ref),
                              "control": drv.detail(ref, drv.follow(
                                  drv.reference(lowp=fp8, adapter_lowp=bf16)))}),
                  flush=True)
        out = {"seed": seed, "program": dict(prog), "control": dict(ctl),
               "program_correct": harness.judge(prog, spec.limits)[0],
               "control_correct": harness.judge(ctl, spec.limits)[0]
               if ctl else None,
               "notes": win.get("notes", {}),
               "run_s": t_ref - t, "control_s": time.perf_counter() - t_ref}
        del drv
        torch.cuda.empty_cache()
        if args.faults:
            from portbench.faults import FAULTS, plant
            kind = spec.traffic["driver"]
            for fault in FAULTS[kind]:
                with plant(kind, fault):
                    drv = harness.driver_class(spec)(spec, seed, dev, Spans(),
                                                     args.seconds)
                    drv.setup()
                    drv.window(args.seconds)
                drv.release()
                got = drv.check()
                out["fault:" + fault] = dict(got)
                out["fault:" + fault + ":correct"] = harness.judge(
                    got, spec.limits)[0]
                del drv
                torch.cuda.empty_cache()
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
