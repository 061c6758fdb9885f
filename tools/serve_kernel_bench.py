"""Time the serve path's ``flash_attention``, ``rmsnorm``, ``swiglu`` and
``mlstm_scan`` kernels, for a before and after comparison on one card.

    python3 tools/serve_kernel_bench.py [--root DIR] [--outputs DIR] [--sweep]
                                        [--layouts]
    python3 tools/serve_kernel_bench.py [--root DIR] --scan-accuracy

Puts ``DIR/src`` (default: this checkout's) first on the path, so the
kernels are that tree's own, and runs this checkout's ``chip_smoke.py``
phase-6 timing of the serve kernels (``serve_timing``) on them: unpack
another commit into a git-ignored directory (``git archive``) and run
this script once for each tree, in turns (parent, change, change,
parent), within one call on the card. Both trees are so timed on the same
inputs beside the same library calls and bounds. It builds the tree's
kernels, then prints the routes the tree's wrappers take, phase 6's serve
lines (``flash_attention`` at SmolLM-360M's and Hymba-1.5B's prefill,
``rmsnorm`` at prefill and at a decode step, ``swiglu`` at both models'
prefill and decode step, ``mlstm_scan`` at xLSTM-125M's and Hymba-1.5B's
prefill in bf16 with the route it takes, through ``scan_timing``),
``rmsnorm`` at ``FAMILY_NORM``'s and Hymba-1.5B's prefill and decode
shapes (phase 14's ``family_norm_timing`` and ``norm_timing``, beside
``F.rms_norm``, with the layout each call takes), and the device time of one call of each shape split by kernel
name (``torch.profiler``, CUDA activity, 10 calls). With ``--outputs
DIR`` it saves this tree's outputs of the four kernels on seeded inputs
there (``rmsnorm`` at SmolLM-360M's, Hymba-1.5B's and ``FAMILY_NORM``'s
prefill and decode shapes; ``mlstm_scan`` in f32, its one-block kernel,
and in bf16, output and final state, at the serve shapes with one
sequence) and says, kernel by kernel and for ``rmsnorm`` shape by shape,
whether they are ``torch.equal`` to those every other tree saved in
``DIR`` (keep DIR on the card's machine, under ``build/``: the outputs
take about 300 MB a tree). ``--sweep`` times every ``swiglu`` kernel that
takes the operands at both models' D and F over M from 1 to 128 (this
tree only; it picks the rows where the decode route ends). ``--layouts``
times ``rmsnorm`` at ``FAMILY_NORM``'s and at SmolLM-360M's and
Hymba-1.5B's shapes (and InternVL2-26B's D at 4 x its prefill rows) in
every layout the split route takes near its plan (G warps a row, R
vectors a lane, rows a block), forced through the wrapper's ``layout``,
twice each (this tree only; it set ``rmsnorm.plan``).
``--scan-accuracy`` does none of that: it holds the tree's
``mlstm_scan`` to its plain version over phase 21's cases
(``chip_smoke.scan_comparisons``, with the inputs that need all three
bf16 terms of an f32 operand) and prints each case's route and largest
err / limit, failing none, so a variant source can be read against the
tolerances. The last line is one JSON object with all of it. Needs one
CUDA card; exits non-zero without it.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# (B, S, H, G, hd, window): the two serve paths' prefill attention
ATTN = {"smollm-360m": (8, 1024, 15, 5, 64, 0),
        "hymba-1.5b": (4, 2048, 25, 5, 64, 1024)}
# rmsnorm's (rows, D) at SmolLM-360M's and Hymba-1.5B's prefill and decode
NORM = {"smollm-360m prefill": (8 * 1024, 960),
        "smollm-360m decode": (8, 960),
        "hymba-1.5b prefill": (4 * 2048, 1600),
        "hymba-1.5b decode": (4, 1600)}
SWEEP_M = (1, 2, 4, 8, 12, 16, 24, 32, 64, 128)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--outputs", type=Path, default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--layouts", action="store_true")
    ap.add_argument("--scan-accuracy", action="store_true")
    args = ap.parse_args()
    root = args.root.resolve()
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)        # puts HERE/src on the path
    sys.path.insert(0, str(root / "src"))
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    import torch
    cs.card()
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import swiglu as kswiglu
    check = Path(build.__file__).resolve()
    if not check.is_relative_to(root):
        raise SystemExit(f"imported {check}, not the tree under {root}")
    build.library()
    bf = torch.bfloat16
    route = (kflash.route(bf, 64) if hasattr(kflash, "route")
             else "mma" if kflash.uses_mma(bf, 64) else "simple")
    mlp_routes = {name: (kswiglu.route(bf, *shape, True)
                         if hasattr(kswiglu, "route") else "mma")
                  for name, shape in cs.SWIGLU_SHAPES.items()}
    print(f"[bench] tree {root}; bf16 hd 64 route {route}; swiglu routes "
          f"{mlp_routes}; ptxas: "
          + "; ".join(e for e in cs.ptxas_entries(build.build_log())
                      if any(n in e for n in ("fa_", "rmsnorm", "swiglu",
                                              "mlstm_scan"))),
          flush=True)
    if args.scan_accuracy:
        g = torch.Generator(device="cuda").manual_seed(22)
        ratios = {}
        for case, _, got, route, want in cs.scan_comparisons(g):
            ratios[str(case)] = r = cs.scan_ratio(case, got, want)
            print(f"[bench] mlstm_scan {case}, route {route}: err / limit "
                  f"{r:.4f}", flush=True)
        print(json.dumps({"root": str(root), "scan_err_over_limit": ratios}))
        return 0
    timed = {}
    for line in cs.serve_timing(timed) + cs.scan_timing(timed):
        print(f"[bench] {line}", flush=True)
    timed["rmsnorm_families"] = fam = cs.family_norm_timing()
    gh = torch.Generator(device="cuda").manual_seed(31)
    (m, D), (mb, _) = NORM["hymba-1.5b prefill"], NORM["hymba-1.5b decode"]
    hx = lambda *shape: torch.randn(*shape, generator=gh,
                                    device="cuda").to(torch.bfloat16)
    scale = hx(D)
    timed["rmsnorm_hymba"] = {**cs.norm_timing(hx(m, D), scale),
                              "at_decode": cs.norm_timing(hx(mb, D), scale)}
    for arch, t0 in {**fam, "hymba-1.5b": timed["rmsnorm_hymba"]}.items():
        for t in (t0, t0["at_decode"]):
            print(f"[bench] rmsnorm at {arch}'s {t['shape']} bf16, layout "
                  f"{t['layout']}: kernel {t['ms']:.4f} ms, plain "
                  f"{t['plain_ms']:.4f} ms, F.rms_norm {t['library_ms']:.4f} "
                  f"ms; bound {t['bound_ms']:.4f} ms ({t['bound_by']})",
                  flush=True)
    out = {"root": str(root), "device": torch.cuda.get_device_name(0),
           "route": route, "swiglu_routes": mlp_routes, **timed}

    g = torch.Generator(device="cuda").manual_seed(21)
    rn = lambda *shape, s=1.0: (torch.randn(*shape, generator=g,
                                            device="cuda") * s).to(bf)
    splits, saved = {}, {}
    for arch, (B, S, H, G, hd, window) in ATTN.items():
        q, k, v = rn(B, S, H, hd), rn(B, S, G, hd), rn(B, S, G, hd)
        splits[f"flash_attention {arch}"] = cs.launch_split(
            lambda: ops.flash_attention_bshd(q, k, v, window=window))
        saved[f"flash_attention {arch}"] = ops.flash_attention_bshd(
            q, k, v, window=window).cpu()
    norms = {**NORM, **{f"{arch} {kind}": (m, D)
                        for arch, (B, S, D) in cs.FAMILY_NORM.items()
                        for kind, m in (("prefill", B * S), ("decode", B))}}
    for name, (M, D) in norms.items():
        x, scale = rn(M, D) * 3, rn(D)
        splits[f"rmsnorm {name}"] = cs.launch_split(
            lambda: ops.rmsnorm(x, scale))
        saved[f"rmsnorm {name}"] = ops.rmsnorm(x, scale).cpu()
    for name, (M, D, F) in cs.SWIGLU_SHAPES.items():
        x, wg, wu = rn(M, D), rn(D, F, s=D ** -0.5), rn(D, F, s=D ** -0.5)
        splits[f"swiglu {name}"] = cs.launch_split(
            lambda: ops.swiglu(x, wg, wu))
        saved[f"swiglu {name}"] = ops.swiglu(x, wg, wu).cpu()
    for arch, (_, H, S, dk, dv, nz) in cs.SCAN_SHAPES.items():
        for dtype in (torch.float32, bf):
            q, k, v, f, i, _ = cs.scan_inputs(1, H, S, dk, dv, nz, dtype, g)
            y, state = ops.mlstm_scan(q, k, v, f, i, chunk=cs.SCAN_CHUNK,
                                      normalize=nz)
            for part, t in (("out", y), *state.items()):
                saved[f"mlstm_scan {str(dtype)[6:]} {arch} {part}"] = t.cpu()
    for name, split in splits.items():
        print(f"[bench] {name}, one call: {cs.split_text(split)}", flush=True)
    out["split"] = splits
    if args.outputs is not None:
        args.outputs.mkdir(parents=True, exist_ok=True)
        tag = str(root).strip("/").replace("/", "_")
        equal = {}
        for other in sorted(args.outputs.glob("*.pt")):
            if other.stem != tag:
                theirs = torch.load(other)
                equal[other.stem] = {
                    kernel: all(torch.equal(saved[n], theirs[n])
                                for n in saved if n.startswith(kernel))
                    for kernel in ("flash_attention", "swiglu",
                                   "mlstm_scan float32",
                                   "mlstm_scan bfloat16",
                                   *(f"rmsnorm {n}" for n in norms))}
        torch.save(saved, args.outputs / f"{tag}.pt")
        out["outputs_equal_to"] = equal
        print(f"[bench] outputs torch.equal to the saved trees': {equal}",
              flush=True)
    if args.sweep:
        sweep = {}
        for D, F in {s[1:] for s in cs.SWIGLU_SHAPES.values()}:
            wg, wu = rn(D, F, s=D ** -0.5), rn(D, F, s=D ** -0.5)
            for M in SWEEP_M:
                x = rn(M, D)
                row = {kind: cs.time_ms(lambda: kswiglu.swiglu(
                           x, wg, wu, kernel=kind))
                       for kind in kswiglu._routes(bf, M, D, F, True)}
                sweep[f"M={M} D={D} F={F}"] = row
                print(f"[bench] swiglu sweep M={M} D={D} F={F}: "
                      + ", ".join(f"{k} {t:.4f} ms" for k, t in row.items()),
                      flush=True)
        out["swiglu_sweep"] = sweep
    if args.layouts:
        out["rmsnorm_layouts"] = norm_layouts(cs, rn)
    print(json.dumps(out))
    return 0


def norm_layouts(cs, rn) -> dict:
    """``rmsnorm`` in bf16 at each FAMILY_NORM shape, at SmolLM-360M's and
    Hymba-1.5B's, and at InternVL2-26B's D with 4 x its prefill rows (100
    MB, which no L2 holds across the graph's calls), in its plan's layout
    and in the split route's others near it: for each R (1, 2, 3, 4, and 8
    at one warp a row where that holds the row) the fewest warps a row,
    each at 1, 2, 4 and 8 rows a block (at most 32 warps). Each timed
    twice by ``time_ms``, in two passes over the layouts, beside
    ``F.rms_norm``; returns the pair for each."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as krms
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [(arch, kind, m, D) for arch, (B, S, D) in cs.FAMILY_NORM.items()
              for kind, m in (("prefill", B * S), ("decode", B))]
    shapes += [(*name.split(), m, D) for name, (m, D) in NORM.items()]
    B, S, D = cs.FAMILY_NORM["internvl2-26b"]
    shapes.append(("internvl2-26b", "prefill-x4", 4 * B * S, D))
    found = {}
    for arch, kind, m, D in shapes:
        V, scale, x = D // 8, rn(D), rn(m, D)
        plan = krms.plan(m, D, 2, True, sms)
        layouts = [plan]
        for R in (1, 2, 3, 4, 8):
            G = -(-V // (32 * R))
            for rows in (1, 2, 4, 8):
                p = krms.Plan("split", G, R, rows)
                if (G * rows <= krms.MAX_WARPS and (R < 8 or G == 1)
                        and (G * 32 * (R - 1) < V or G == 1 and V <= 256)
                        and p not in layouts):
                    layouts.append(p)
        row = {"library_ms": [], **{" ".join(map(str, p)): []
                                    for p in layouts}}
        for _ in range(2):
            row["library_ms"].append(cs.time_ms(
                lambda: F.rms_norm(x, (D,), scale, 1e-6)))
            for p in layouts:
                row[" ".join(map(str, p))].append(cs.time_ms(
                    lambda: krms.rmsnorm(x, scale, layout=p)))
        found[f"{arch} {kind} ({m}, {D})"] = row
        print(f"[bench] rmsnorm layouts at {arch}'s {kind} ({m}, {D}), plan "
              f"{' '.join(map(str, plan))}: "
              + ", ".join(f"{k} {t[0]:.4f}/{t[1]:.4f} ms"
                          for k, t in row.items()),
              flush=True)
        del x
    return found


if __name__ == "__main__":
    sys.exit(main())
