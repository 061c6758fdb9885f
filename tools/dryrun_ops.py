"""Which local ops carry a dry-run trace's flops, and what it ran by hand.

    PYTHONPATH=src python3 tools/dryrun_ops.py --arch smollm-360m --shape train_4k [--mesh 16,16] [--multi-pod] [--opt N] [--top 20]

Traces one (arch, shape) as ``python -m repro_torch.launch.dryrun``
does (``run_one``) and prints its summary line, the ops of
``dryrun._HANDLERS`` it ran by hand, and the ``--top`` local ops by
flops with their local input shapes and their share of the device's
flops. The shapes show how DTensor split each product: a batch dim
that the data axes alone split against one the model axis splits too.
Needs no card.
"""
from __future__ import annotations

import argparse
import collections
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> None:
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.inputs import SHAPES

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--shape", choices=list(SHAPES), required=True)
    ap.add_argument("--mesh", default=None, help="per-pod shape d,m")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--opt", type=int, default=0)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)

    by_op = collections.Counter()

    class ByOp(D.LocalCost):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = self.flops
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if self.flops != before and not any(
                    issubclass(t, DTensor) for t in types):
                shapes = tuple(tuple(t.shape)
                               for t in D._tensors((args, kwargs or {})))
                by_op[str(func), shapes] += self.flops - before
            return out

    D.LocalCost = ByOp
    mesh = tuple(int(x) for x in args.mesh.split(",")) if args.mesh \
        else None
    rec = D.run_one(args.arch, args.shape, multi_pod=args.multi_pod,
                    opt_level=args.opt, mesh_shape=mesh)
    if not rec["ok"]:
        print(rec["traceback"])
        raise SystemExit(1)
    print(f"mesh dims {rec['mesh_dims']}; run by hand "
          f"{rec['handled_ops']}")
    total = sum(by_op.values())
    for (op, shapes), flops in by_op.most_common(args.top):
        print(f"{flops / total:7.4f} {flops:.4e} {op} {shapes}")


if __name__ == "__main__":
    main()
