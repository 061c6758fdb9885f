"""Time the two top-k kernels and the paths they serve, for a before and
after comparison on one card.

    python3 tools/topk_bench.py [--root DIR]

Loads ``chip_smoke.py`` from ``DIR`` (default: this checkout), with
``DIR/src`` first on the path, so the kernels, the paths and the phase
functions are that tree's own: unpack another commit into a git-ignored
directory (``git archive``) and run this script once for each tree, in
turns, within one call on the card. It builds the tree's kernels, then
prints:

- phase 4 (a round chunk, kernels against plain; it warms up cuDNN) and
  phase 5 (the uncompressed device-plane loop, ms/round);
- ``segmented_topk`` at the fleet's masked ratio (8 x 131,072, k =
  4,096) and ``topk_sparsify`` at the compressed plane's deltas
  (13 x 1,070,794, k = 53,540): the median of 20 replays of a CUDA graph
  of 10 calls, beside ``torch.topk`` on the same input, and the device
  time of one call split by kernel name (``launch_split`` of this
  checkout's ``chip_smoke.py``: ``torch.profiler``, CUDA activity, 10
  calls);
- phase 8 (stage 1 at 1M clients through the frontier) and phase 12
  (the ``int8`` and ``topk:0.05+int8`` loops, ms/round);

and, last, one JSON object with the kernel times and splits, and
whether each kernel's output equals its plain version's. Needs one
CUDA card; exits non-zero without it.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path


def load_smoke(root: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)      # puts root/src first on sys.path
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    args = ap.parse_args()
    root = args.root.resolve()
    here = Path(__file__).resolve().parents[1]
    split = load_smoke(here, "chip_smoke_here").launch_split
    cs = load_smoke(root, "chip_smoke")   # its src now comes first
    import torch
    cs.card()
    cs.build()
    from repro_torch.kernels import ops, ref
    cs.chunk_kernel_vs_plain()            # warms up cuDNN before phase 5
    _, base_ms = cs.slice_run()
    fleet = cs.fleet_pool()
    g = torch.Generator(device="cuda").manual_seed(2)
    u = torch.randn(cs.MAIN_K, cs.MAIN_P, generator=g, device="cuda")
    cases = {"segmented_topk": (fleet["ratio"], cs.FLEET_K,
                                ops.segmented_topk, ref.segmented_topk_ref,
                                lambda x, k: torch.topk(x, k, dim=1)),
             "topk_sparsify": (u, cs.MAIN_TOPK, ops.topk_sparsify,
                               ref.topk_sparsify_ref,
                               lambda x, k: torch.topk(x.abs(), k, dim=1))}
    kernels = {}
    for name, (x, k, kern, plain, lib) in cases.items():
        got, exp = kern(x, k), plain(x, k)
        t = {"shape": list(x.shape), "k": k,
             "equal_to_plain": bool(torch.equal(got[0], exp[0])
                                    and torch.equal(got[1], exp[1])),
             "ms": cs.time_ms(lambda: kern(x, k)),
             "torch_topk_ms": cs.time_ms(lambda: lib(x, k)),
             "split": split(lambda: kern(x, k))}
        kernels[name] = t
        print(f"{name} {tuple(x.shape)} k={k}: kernel {t['ms']:.4f} ms, "
              f"torch.topk {t['torch_topk_ms']:.4f} ms; one call by kernel: "
              + ", ".join(f"{n} x{s['launches']:g} {s['ms']:.4f} ms"
                          for n, s in t["split"].items()), flush=True)
    cs.fleet_intake(fleet)
    cs.compressed_loop(base_ms)
    print(json.dumps({"root": str(root), "device":
                      torch.cuda.get_device_name(0), "kernels": kernels,
                      "uncompressed_ms_per_round": base_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
