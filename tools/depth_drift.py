"""How far the kernel path's logits drift from the plain versions' with
depth, beside how far the plain bf16 path drifts from f32, for the
full-width serves of ``chip_smoke.py`` phases 29-31.

    python3 tools/depth_drift.py [--arch ARCH ...] [--depths 1,2,4,8]

For each architecture (default: Qwen1.5-MoE-A2.7B at depths 1-24,
Llama-4-Scout's first 8 layers at 1-8, InternVL2-26B at 1-48) it draws
the bf16 weights from seed 0 once, as ``chip_smoke.full_width_serve``
does, and for each depth D runs a view of the first D layers: the
prefill of 4 x 1,024 tokens (InternVL2: 2 x 256 patch embeddings + 768
tokens) and 8 decode steps fed seeded tokens, through the kernels,
through ``kernels=ops.PLAIN`` and through the plain versions in f32 (each
layer cast as the stack takes it, ``chip_smoke.f32_view``). On an MoE
model the plain and f32 passes take the kernel pass's expert choices
(``chip_smoke.moe_routes``), and it also prints the first layer's route
agreement of each pass on its own routes. A line a depth; the last line
is one JSON object with all of it. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

RUNS = {"qwen2-moe-a2.7b": (4, 1024, None, (1, 2, 4, 8, 16, 24)),
        "llama4-scout-17b-a16e": (4, 1024, 8, (1, 2, 4, 8)),
        "internvl2-26b": (2, 768, None, (1, 8, 24, 48))}
STEPS = 8


def drift(arch: str, B: int, prompt: int, layers, depths) -> list[dict]:
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    over = {"use_kernels": True, **({"num_layers": layers} if layers else {})}
    cfg = dataclasses.replace(get_config(arch), **over)
    params = T.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    on_card = lambda a, dtype: torch.as_tensor(a, dtype=dtype, device="cuda")
    prompts = on_card(rng.integers(0, cfg.vocab_size, (B, prompt)),
                      torch.int32)
    feed = on_card(rng.integers(0, cfg.vocab_size, (B, STEPS)), torch.int32)
    extras = {}
    if cfg.family == "vlm" and cfg.frontend_seq:
        extras["patch_embeds"] = on_card(rng.normal(size=(
            B, cfg.frontend_seq, cfg.frontend_dim)), torch.float32)
    start = prompt + (cfg.frontend_seq if cfg.family == "vlm" else 0)

    def teacher(kernels, c, p):
        logits, cache, memory = T.prefill(c, p, prompts, extras,
                                          kernels=kernels)
        cache = T.grow_cache(c, cache, STEPS)
        outs = [logits.float()]
        for s in range(STEPS):
            logits, cache = T.decode_step(c, p, feed[:, s:s + 1], cache,
                                          start + s, memory=memory,
                                          kernels=kernels)
            outs.append(logits.float())
        return torch.cat(outs, 1)

    out = []
    for D in depths:
        c = dataclasses.replace(cfg, num_layers=D)
        p = {**params, "layers": T.tree_map(lambda a: a[:D],
                                            params["layers"])}
        c32 = dataclasses.replace(c, dtype="float32")
        p32 = cs.f32_view(p, T.tree_map)
        with cs.moe_routes() as r_kern:
            kern = teacher(None, c, p)
        routes = r_kern if cfg.is_moe else None
        with cs.moe_routes(routes):
            plain = teacher(ops.PLAIN, c, p)
        with cs.moe_routes(routes):
            f32 = teacher(ops.PLAIN, c32, p32)
        row = {"depth": D, "top": float(plain.abs().max()),
               "kernel_vs_plain": float((kern - plain).abs().max()),
               "plain_vs_f32": float((plain - f32).abs().max())}
        if cfg.is_moe:
            with cs.moe_routes() as r_plain:
                teacher(ops.PLAIN, c, p)
            with cs.moe_routes() as r_f32:
                teacher(ops.PLAIN, c32, p32)
            row["layer1_routes_kernel_vs_plain"] = cs.route_agreement(
                r_kern[0], r_plain[0])
            row["layer1_routes_plain_vs_f32"] = cs.route_agreement(
                r_plain[0], r_f32[0])
        print(f"{arch} depth {D}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items() if k != "depth"),
            flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="*", default=list(RUNS),
                    choices=list(RUNS))
    ap.add_argument("--depths", default=None,
                    help="comma-separated depths (default: the arch's)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    cs.card()
    cs.build()
    result = {}
    for arch in args.arch:
        B, prompt, layers, depths = RUNS[arch]
        if args.depths:
            depths = tuple(int(d) for d in args.depths.split(","))
        result[arch] = drift(arch, B, prompt, layers, depths)
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
