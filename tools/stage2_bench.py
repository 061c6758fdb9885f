"""Time stage 2's MKP greedy and the int8 aggregate, for a before and after
comparison on one card.

    python3 tools/stage2_bench.py [--root DIR] [--reps N]

Loads ``chip_smoke.py`` from ``DIR`` (default: this checkout), with
``DIR/src`` first on the path, so the kernels and the paths are that
tree's own: unpack another commit into a git-ignored directory
(``git archive``) and run this script once for each tree, in turns
(parent, change, change, parent), within one call on the card. It builds
the tree's kernels, then prints:

- ``fedavg_agg_quality_i8`` at the compressed plane's shape (13 x
  1,070,794 int8, chunk 256): the median of 20 replays of a CUDA graph of
  10 calls, the device time of one call split by kernel name
  (``launch_split`` of this checkout's ``chip_smoke.py``) and a hash of
  its four outputs, so the trees' outputs can be compared;
- stage 2 over task 0's pool of the fleet (the flat greedy's picks at
  the first fleet budget over 1,000,000 clients, about 3,846 clients):
  ``generate_subsets(n=10, delta=3, backend="device")``, the median host
  wall of ``--reps`` schedules after one warm-up, the MKP solves that
  reach the device backend, each kernel's launches a schedule, and a
  hash of the schedule;
- one device solve of the pool's first MKP (13 picks): its host wall
  through ``engine.solve_mkp_greedy_device`` (median of 50), and its
  device route in a CUDA graph (the median of 20 replays of 10 solves):
  ``ops.mkp_greedy`` where the tree has it, else this checkout's
  ``per_pick_loop`` over the tree's ``ops.mkp_utility``;

and, last, one JSON object with these numbers and the card's name and
power limit. Needs one CUDA card; exits non-zero without it.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np


def load_smoke(root: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)      # puts root/src first on sys.path
    return mod


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    root = args.root.resolve()
    here = Path(__file__).resolve().parents[1]
    mine = load_smoke(here, "chip_smoke_here")
    split = mine.launch_split
    cs = load_smoke(root, "chip_smoke")   # its src now comes first
    import torch
    cs.card()
    cs.build()
    from repro_torch.core import engine, scheduling
    from repro_torch.core.pool import ClientPoolState
    from repro_torch.kernels import ops
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    out = {"root": str(root), "card": smi}

    # the int8 aggregate at the compressed plane's shape
    g = torch.Generator(device="cuda").manual_seed(2)
    u = torch.randn(cs.MAIN_K, cs.MAIN_P, generator=g, device="cuda")
    w = torch.softmax(torch.randn(cs.MAIN_K, generator=g, device="cuda"), 0)
    vals, sc = ops.quantize_i8(u, cs.CHUNK)
    fn = lambda: ops.fedavg_agg_quality_i8(vals, sc, w, cs.CHUNK)
    res = [t.cpu().numpy() for t in fn()]
    i8 = {"ms": cs.time_ms(fn), "split": split(fn),
          "agg_hash": digest(res[0]), "quality_hash": digest(*res[1:])}
    out["fedavg_agg_quality_i8"] = i8
    print(f"fedavg_agg_quality_i8 ({cs.MAIN_K}, {cs.MAIN_P}) chunk "
          f"{cs.CHUNK}: {i8['ms']:.4f} ms; one call: "
          + cs.split_text(i8["split"]) + f"; agg {i8['agg_hash']}, dots/sq/"
          f"asq {i8['quality_hash']}", flush=True)

    # stage 2 over task 0's pool
    pool = ClientPoolState.random(cs.FLEET_N, cs.CLASSES,
                                  np.random.default_rng(0))
    rows = np.sort(engine._flat_pool_greedy(pool, cs.FLEET_BUDGETS[0],
                                            cs.FLEET_TH)[0])
    arrays = (pool.client_ids[rows], pool.histograms[rows])
    solve, solves = engine.solve_mkp_greedy_device, []

    def counted(*a, **kw):
        solves.append(1)
        return solve(*a, **kw)

    def schedule():
        return scheduling.generate_subsets(arrays, cs.SUBSET_N,
                                           cs.SUBSET_DELTA, backend="device")

    schedule()                            # warm-up
    engine.solve_mkp_greedy_device = counted
    try:
        before = dict(ops.LAUNCHES)
        walls = []
        for _ in range(args.reps):
            t = time.perf_counter()
            res = schedule()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
    finally:
        engine.solve_mkp_greedy_device = solve
    launches = {k: (ops.LAUNCHES[k] - before[k]) // args.reps
                for k in ("mkp_utility", "mkp_greedy") if k in ops.LAUNCHES}
    st = {"clients": int(rows.size), "subsets": len(res.subsets),
          "wall_s": statistics.median(walls), "walls_s": walls,
          "solves": len(solves) // args.reps, "launches": launches,
          "schedule_hash": digest(np.concatenate(
              [np.asarray(s, np.int64) for s in res.subsets]),
              np.asarray(sorted(res.counts.items()), np.int64))}
    out["stage2"] = st
    print(f"stage 2 over task 0's {st['clients']} clients: {st['subsets']} "
          f"subsets, median wall {st['wall_s']:.4f} s of {args.reps} "
          f"({', '.join(f'{x:.4f}' for x in walls)}); {st['solves']} device "
          f"solves, launches a schedule {launches}; schedule "
          f"{st['schedule_hash']}", flush=True)

    # one device solve of the pool's first MKP
    H = arrays[1].astype(np.float32)
    caps = scheduling.default_capacities_arrays(H, cs.SUBSET_N)
    picks = cs.SUBSET_N + cs.SUBSET_DELTA
    v, wt, cap = (torch.as_tensor(np.asarray(a, np.float32)).cuda()
                  for a in (H.sum(1), H, caps))
    host = []
    for _ in range(51):
        t = time.perf_counter()
        mask, used = engine.solve_mkp_greedy_device(H.sum(1), H, caps, picks)
        host.append(time.perf_counter() - t)
    if hasattr(ops, "mkp_greedy"):
        route, dev = "mkp_greedy", lambda: ops.mkp_greedy(v, wt, cap, picks)
    else:
        route = "per-pick loop over mkp_utility"
        dev = lambda: mine.per_pick_loop(ops, v, wt, cap, picks)
    one = {"route": route, "host_ms": statistics.median(host[1:]) * 1e3,
           "graph_ms": cs.time_ms(dev), "picks": int(mask.sum()),
           "solve_hash": digest(mask, used)}
    out["solve"] = one
    print(f"one solve, n={H.shape[0]} m={H.shape[1]} {picks} picks "
          f"({one['picks']} made): engine.solve_mkp_greedy_device "
          f"{one['host_ms']:.3f} ms host wall (median of 50); {route} in a "
          f"graph {one['graph_ms']:.4f} ms; solve {one['solve_hash']}",
          flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
