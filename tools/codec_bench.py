"""Time the int8 codec kernels, for a before and after comparison on one
card.

    python3 tools/codec_bench.py [--root DIR]

Loads ``chip_smoke.py`` from ``DIR`` (default: this checkout), with
``DIR/src`` first on the path, so the kernels are that tree's own:
unpack another commit into a git-ignored directory (``git archive``) and
run this script once for each tree, in turns (parent, change, change,
parent), within one call on the card. It builds the tree's kernels,
then times, with this checkout's ``time_ms`` (the median of 20 replays
of a CUDA graph of 10 calls), at the compressed plane's shapes (unit
normals, chunks of 256):

- ``quantize_i8`` of the deltas (13 x 1,070,794) and of their top-k
  values (13 x 53,540);
- ``quantize_i8`` of the deltas as a view 4 bytes into a buffer, so no
  row starts 8-byte aligned (the narrowest access a row can take; its
  outputs hash as the aligned call's);
- ``quantize_i8`` of four times the deltas' rows (52 x 1,070,794, 222
  MB, which no L2 holds across calls): a quarter of its time is the
  streaming cost of one call at the deltas' shape, with the fixed cost
  of a launch spread over four times the bytes;
- ``dequantize_i8`` of the top-k values' payload (13 x 53,540);

and prints a hash of each kernel's outputs on those finite inputs (the
trees' outputs can be compared), whether ``quantize_i8`` equals the
tree's plain version on a row set whose chunks hold NaN and +-inf (NaN
compared as NaN), and, last, one JSON object with these numbers and the
card's name and power limit. Needs one CUDA card; exits non-zero
without it.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
from pathlib import Path

import numpy as np


def load_smoke(root: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)      # puts root/src first on sys.path
    return mod


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(np.ascontiguousarray(t.cpu().numpy()).tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    args = ap.parse_args()
    root = args.root.resolve()
    here = Path(__file__).resolve().parents[1]
    time_ms = load_smoke(here, "chip_smoke_here").time_ms
    cs = load_smoke(root, "chip_smoke")   # its src now comes first
    import torch
    cs.card()
    cs.build()
    from repro_torch.kernels import ops, ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    K, P, k, chunk = 13, 1_070_794, 53_540, 256
    g = torch.Generator(device="cuda").manual_seed(26)
    u = torch.randn(K, P, generator=g, device="cuda")
    vals = torch.randn(K, k, generator=g, device="cuda")
    vk, sk = ops.quantize_i8(vals, chunk)
    buf = torch.empty(1 + K * P, device="cuda")
    u_off = buf[1:].view(K, P)        # data_ptr 4 bytes off the buffer's
    u_off.copy_(u)
    u4 = torch.randn(4 * K, P, generator=g, device="cuda")
    cases = {"quantize_i8 (13, 1070794)": lambda: ops.quantize_i8(u, chunk),
             "quantize_i8 (13, 1070794), x 4 bytes off":
                 lambda: ops.quantize_i8(u_off, chunk),
             "quantize_i8 (52, 1070794)": lambda: ops.quantize_i8(u4, chunk),
             "quantize_i8 (13, 53540)": lambda: ops.quantize_i8(vals, chunk),
             "dequantize_i8 (13, 53540)":
                 lambda: ops.dequantize_i8(vk, sk, chunk)}
    out = {"root": str(root), "card": smi}
    for name, fn in cases.items():
        out[name] = {"ms": time_ms(fn), "hash": digest(*(
            (fn(),) if name.startswith("de") else fn()))}
        print(f"{name}: {out[name]['ms']:.4f} ms, outputs {out[name]['hash']}",
              flush=True)
    bad = torch.randn(K, 100_003, generator=g, device="cuda")
    bad[:, 5::768] = float("nan")
    bad[:, 300::768] = float("inf")
    bad[:, 600::768] = float("-inf")
    v, s = ops.quantize_i8(bad, chunk)
    ev, es = ref.quantize_i8_ref(bad, chunk)
    same = bool(torch.equal(v, ev) and torch.equal(s.isnan(), es.isnan())
                and torch.equal(torch.where(s.isnan(), 0, s),
                                torch.where(es.isnan(), 0, es)))
    out["non_finite_equals_plain"] = same
    print(f"quantize_i8 on NaN / +-inf chunks equals the plain version: "
          f"{same}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
