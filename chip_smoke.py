"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``repro_torch`` (never JAX, never the JAX package) through its
paths on the card and holds every CUDA kernel of those paths against its
plain PyTorch version. Phases, one line each:

1. the card: fail without CUDA; print ``nvidia-smi`` name and power limit;
2. build the kernels from the sources in this checkout (one ``nvcc`` a
   source, all started together, and one link into ``build/``), with the
   build time and ptxas registers and spills of every kernel entry;
3. ``fedavg_agg_quality`` against its plain version on the card, at the
   service loop's shape and at ragged shapes, in f32 and bf16;
4. one round chunk (S=4, CIFAR_CNN) from the same parameters through
   the kernels and through their plain versions (both full f32: matmuls
   by PyTorch's default, convolutions by the library's cuDNN pin);
5. the service loop: ``run_fl_experiment(..., data_plane="device")`` on
   the card with launch counts set to 0 just before and read just after;
6. each kernel, its plain version and its library yardstick timed with
   CUDA events (median of 20 replays of a CUDA graph of 10 back-to-back
   calls) at the shapes its path gives it, beside the kernel's bound
   (``mlstm_scan`` and ``flash_attention`` at xLSTM-125M's or SmolLM-360M's
   and at Hymba-1.5B's prefill shapes, ``rmsnorm`` at prefill and at a
   decode step, ``swiglu`` at SmolLM-360M's and Hymba-1.5B's prefill and
   decode step beside ``x @ w_gate`` and both products in one call, with
   the route each shape takes, ``fedavg_agg`` over one host round's 8
   leaves in one launch beside one launch a leaf and 8 ``torch.mv``,
   ``mkp_greedy`` on stage 2's first MKP beside the per-pick
   loop over ``mkp_utility`` in a graph, one launch a solve), and the two
   top-k kernels' and the int8 aggregate's device time split by launch
   group (``torch.profiler``; the int8 aggregate one launch a call);
7. ``segmented_topk``, ``mkp_utility`` and ``mkp_greedy`` against their
   plain versions on the card (ties, -inf padding, all-equal rows, NaN
   and +-inf, k up to C, one row over many blocks, ragged n and m; the
   greedy over one block, clusters and rows past the cluster's shared
   memory): exact;
8. the fleet intake: four tasks through
   ``FLServiceProvider.select_pools_batch`` over 1,000,000 clients in 8
   shards, routed through the per-shard frontier; picks equal the flat
   host greedy before and after 5,000 churn events, each timed beside
   the frontier route;
9. stage 2 on the card: ``generate_subsets(backend="device")`` over task
   0's pool equals the same call on the CPU (the plain version), one
   ``mkp_greedy`` launch a device MKP solve and no ``mkp_utility``, its
   wall per schedule;
10. the intake below the fleet route: the batched stage-1 greedy over
    8 tasks and 100,000 clients, numpy (the default) against the device
    backend, timed, masks compared;
11. the codec kernels against their plain versions: ``topk_sparsify``,
    ``quantize_i8`` and ``dequantize_i8`` exact, ``fedavg_agg_quality_i8``
    within f32 tolerance, at the compressed loop's shapes and ragged
    ones (chunks 100-512, zero chunks, saturation, ties, k from 1 to P;
    for the top-k also all-equal magnitudes, NaN and +-inf, one row over
    many blocks, odd P), and ``quantize_i8`` / ``dequantize_i8`` on views
    whose data starts 0-12 / 0-15 bytes off, at P of each alignment
    class and chunks 1-512;
12. the compressed update plane: the service loop at CIFAR_CNN width
    with ``compression="int8"``, then ``"topk:0.05+int8"`` with the
    FedAdam server, 16 rounds each; every codec kernel launches once a
    round where its codec uses it and never elsewhere, and each round's
    ``bytes`` is arrived clients x the codec's wire size;
13. ``compression="none"`` gives the uncompressed chunk bit for bit;
14. the serve path's kernels against their plain versions on the card,
    f32 and bf16: ``rmsnorm``, ``swiglu`` and ``flash_attention`` at the
    serve shapes (SmolLM-360M's, and Hymba-1.5B's windowed attention and
    D of 1,600, its MLP at prefill and decode) and the reference's test
    sweeps (MHA, GQA, MQA, windows 8 and 16, Sq=1 against Sk, non-causal,
    ragged S; ragged M, D, F) and at the shapes phases 29-32 give them
    (attention at hd 128 with H = G = 16, H 40 / G 8 and H 48 / G 8 over
    1,024 positions, and at hd 64 with H = G = 20; rmsnorm rows of 2,048,
    5,120 and 6,144; swiglu at D 6,144, F 16,384, M 2,048 and 2), where
    each is also timed beside its plain version, its bound and the
    library's call; ``swiglu`` takes its expected route at
    each serve shape and at D % 8 != 0, every other kernel that takes
    the operands is held too below prefill size, and every call repeats
    bit for bit;
15. the serve path at full width: SmolLM-360M, bf16, random weights from
    a seed, 8 prompts of 1,024 tokens and 32 new tokens through
    ``models.transformer`` ``prefill`` / ``grow_cache`` / ``decode_step``
    with ``use_kernels=True``: launches exactly 32 / 1,024 / 2,080 of
    flash_attention / swiglu / rmsnorm; prefill and 8 teacher-forced
    decode steps against the same weights through ``kernels=ops.PLAIN``,
    held to the bf16 path's own distance from f32;
16. the entry point ``repro_torch.launch.serve.serve("smollm-360m")`` at
    its default (reduced) size;
17. ``fedavg_agg`` against its plain version on the card, f32 and bf16,
    K from 1 to 100 (past row 1's 64), P from 1 to 1,070,794; one launch
    over many leaves bit-equal to one launch a leaf;
18. the host-loop plane: ``run_fl_experiment`` at its default
    (``data_plane="host"``) at CIFAR_CNN width, then 8 rounds each of
    ``make_fl_round(use_agg_kernel=True)`` (through
    ``FLClassificationSim``'s batch assembly) and of the two-pass
    ``make_fl_rounds_scan(use_agg_kernel=True)`` at K = 13: launches
    exactly one a round, bit-equal to the same rounds with one launch a
    leaf and held against them through ``kernels=ops.PLAIN``;
19. the fault plane on both planes: the reference's ``bench_faults``
    plan with over-scheduling, a quorum and a deadline, 16 rounds each;
    every committed round met its quorum, and a client that missed the
    close has b_t = 0 and q = 0 as the trainer returns them;
20. what a library caller gets, with no flag set by the caller: each
    plane run twice and with an inactive ``FaultPlan()`` from one seed,
    params and history bit-equal; a device-plane chunk timed with the
    library's cuDNN pin and with PyTorch's defaults in its place;
21. ``mlstm_scan`` against its plain version on the card, output and
    final state, normalized (mLSTM) and SSD, f32 and bf16, each case
    with the route it takes (the serve shapes in bf16 take the
    chunk-parallel ``wgmma`` route, f32 the one-block kernel): at the two
    full-width serve shapes, the reference's sweep, ragged S and S
    under one chunk, chunks of 64 to 256, dk and dv at one tile and
    several, odd and largest widths, from an initial state, and through
    strided (B, S, H, d) views;
22. the SSM serve path at full width: xLSTM-125M (12 layers, sLSTM at 3
    and 7), bf16, random weights from a seed, 4 prompts of 2,048 tokens
    and 32 new tokens, as phase 15: launches exactly 10 ``mlstm_scan``
    and 32 ``rmsnorm``, logits against ``kernels=ops.PLAIN`` held to the
    bf16 path's own distance from f32;
23. the same for Hymba-1.5B (32 layers, windowed attention beside the
    mamba heads): 32 / 32 / 1,024 / 2,080 launches of mlstm_scan /
    flash_attention / swiglu / rmsnorm;
24. the entry points ``serve("xlstm-125m")`` and ``serve("hymba-1.5b")``
    at their default (reduced) sizes;
25. the int8 codec kernels on non-finite input: ``quantize_i8``,
    ``dequantize_i8`` and ``fedavg_agg_quality_i8`` against their plain
    versions with a NaN in some chunks and +-inf in others, at the
    compressed loop's shape and a ragged one, chunks 100-512: values and
    scales equal (NaN compared as NaN), a NaN chunk with scale NaN and
    values 0, a +-inf chunk with scale inf and values 0; and phase 11's
    misaligned views with NaN or +-inf chunks;
26. period-checkpoint resume on the compressed plane: the CIFAR_CNN
    device plane with ``"topk:0.05+int8"`` and FedAdam at phase 12's
    size, 16 rounds uninterrupted, and the same run saved after round 8
    (``save_state(..., trainer=)``), loaded into a fresh provider and
    trainer (``load_state`` + ``restore_trainer_state``) and run to round
    16: events, reputation and final params bit for bit;
27. the federated LoRA LM task at SmolLM-360M's full width and depth
    (bf16 backbone, f32 adapters of rank 4 on wq, wv and w_up: 860,160
    parameters), 40 clients, subsets of 10, sequences of 128, batch 4, 2
    local steps: 4 rounds in one chunk, then the same task saved after
    round 2 and resumed, bit for bit; wall per round, the card's peak
    memory, ``fedavg_agg_quality`` launches one a round, and the device
    time of one more round split by kernel (``torch.profiler``);
28. the four examples (``examples/*_torch.py``, ``serve_decode_torch.py``
    among them) on the card, each as a subprocess that must exit 0;
29. the MoE serve path at full width and depth: Qwen1.5-MoE-A2.7B (24
    layers, 60 experts top-4 + 4 shared), bf16, random weights from a
    seed, 4 prompts of 1,024 tokens and 32 new tokens, as phase 15:
    launches exactly 24 ``flash_attention`` and 49 x 32 ``rmsnorm`` (no
    ``swiglu``: the MoE layer is plain, as in the reference); logits
    against ``kernels=ops.PLAIN`` and f32 (each layer cast as the stack
    takes it), the plain and f32 passes on the kernel pass's expert
    choices, and the first layer's routing flips held to the bf16 path's
    own against f32; the init peak beside the model and one layer;
30. the same for Llama-4-Scout (16 experts top-1 + 1 shared) at full
    width, cut to its first 8 of 48 layers (all 48 are about 216 GB in
    bf16): 8 / 17 x 32 launches;
31. the same for InternVL2-26B at full width and depth (48 layers, d
    6,144): 2 prompts of 256 f32 patch embeddings through the projector
    and 768 tokens, decode positions counting the prefix: 48 / 48 x 32 /
    97 x 32 launches of flash_attention / swiglu / rmsnorm;
32. the same for Whisper-large-v3 at full width and depth (32 encoder
    and 32 decoder layers): 4 x 1,500 f32 frames through the encoder
    (plain, in f32 as the reference promotes it) and 64 tokens, every
    decode step cross-attending to the encoder's memory; 32
    ``flash_attention`` launches;
33. the entry point ``serve()`` at its default (reduced) size for those
    four architectures;
34. the mesh-sharded device plane at CIFAR_CNN width (phase 5's task,
    dropout 0): unsharded, on ``make_host_mesh()`` and on 2 shards of
    cuda:0, each through the lifecycle, wall per round; then every round
    of the unsharded run again from the parameters that entered it
    through both sharded chunk functions: masks bit-equal, q, losses and
    parameters within rtol 1e-3 / atol 1e-4 (a run of 24 rounds cannot
    be held so: the CNN at local_lr 0.1 amplifies any f32 rounding
    round after round); the sharded runs launch no kernel;
35. placement on the card: ``ServiceScheduler(n_devices=1)`` with two
    real ``DeviceFLSim`` tenants (``place_on(0)``), bit-equal to the same
    tasks run alone; ``place_on(1)`` refused on one card (on two or more,
    tenants on cuda:0 and cuda:1, bit-equal too);
36. FedSGD at SmolLM-360M's full width and depth in bf16 through
    ``repro_torch.launch.train.train`` (24 clients, its batch
    composition, 8 steps): finite losses, no kernel launched, wall per
    step, tokens/s, peak memory; 8 steps on one fixed 8 x 1,024 batch
    lower its loss; 4 microbatches against one: loss within 1e-2
    relative, gradients within 2^-4 by leaf (L2); a step's device busy
    share from ``torch.profiler``;
37. the entry point ``python -m repro_torch.launch.train --steps 20``:
    exit 0, final loss below the first.

Phases 5, 8, 9, 12, 15, 16, 18, 22, 23, 24, 26, 27, 29-34 and 36 set
their kernels' launch counts to 0 just before and read them just
after. Each phase line carries the
seconds since the script started. Any failure raises and exits non-zero. The
last two lines are the kernel records and ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import re
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet: HBM rate, f32 rate outside the tensor cores and
# the dense bf16 tensor-core rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
MAIN_K, MAIN_P = 13, 1_070_794      # subset_size + delta; CIFAR_CNN params
# The fleet: the reference's 1M-client selection record
# (BENCH_selection.json "fleet"[0]): 8 shards of 131,072, thresholds
# 0.05, a budget that picks about 3,846 clients; tasks at x0.5, x2, x4.
FLEET_N, SHARD_CAP, FLEET_K = 1_000_000, 131_072, 4096
FLEET_TH = np.full(9, 0.05)
FLEET_BUDGETS = [78_889.4 * f for f in (1.0, 0.5, 2.0, 4.0)]
CHURN_EVENTS = 5_000
# The intake below HIERARCHICAL_MIN_N: the reference's batch record
# (BENCH_selection.json "batch": 100,000 clients, 8 tasks); budgets are
# the fleet's scaled to the pool, at two threshold levels.
INTAKE_N = 100_000
INTAKE_BUDGETS = np.array([7_888.94 * f for f in (0.5, 1.0, 2.0, 4.0)] * 2)
INTAKE_TH = [np.full(9, 0.05)] * 4 + [np.full(9, 0.2)] * 4
SUBSET_N, SUBSET_DELTA, CLASSES = 10, 3, 10
# The compressed update plane at the main path's shape: k = ceil(0.05 P)
# for topk:0.05, 256-lane int8 chunks; wire bytes per client (the
# reference's fl.compression.bytes_per_client) raw, int8, topk:0.05+int8.
TOPK_FRAC, CHUNK = 0.05, 256
MAIN_TOPK = 53_540
WIRE = {None: 4_283_176, "int8": 1_087_526, "topk:0.05+int8": 268_540}
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-5)}
# The fault plane: the reference's bench_faults plan and mitigations.
FAULT_PLAN = dict(seed=7, straggler_frac=0.2, straggler_slowdown=8.0,
                  crash_prob=0.05, permanent_frac=0.2, outage_prob=0.1,
                  outage_len=5)
FAULT_TASK = dict(overschedule_factor=2.0, quorum_frac=0.5,
                  collect_deadline=2.0)
# The serve path at full width: SmolLM-360M (its published shape, bf16),
# 8 prompts of 1,024 tokens, 32 new tokens; 8 teacher-forced decode steps
# held against the plain versions.
SERVE_ARCH, SERVE_B, SERVE_PROMPT, SERVE_NEW, SERVE_TF = (
    "smollm-360m", 8, 1024, 32, 8)
SERVE_D, SERVE_F, SERVE_H, SERVE_G, SERVE_HD = 960, 2560, 15, 5, 64
# The SSM serve path at full width: xLSTM-125M and Hymba-1.5B, bf16,
# 4 prompts of 2,048 tokens (8,192, phase 15's count), SERVE_NEW new
# tokens; Hymba's 1,024-token window bites in prefill and in the ring
# cache. The scan at their shapes: (B, H, S, dk, dv, normalize).
SSM_B, SSM_PROMPT, SCAN_CHUNK = 4, 2048, 256
# Hymba-1.5B's MLP in prefill: (M, D, F); and swiglu's four serve shapes
HYMBA_MLP = (SSM_B * SSM_PROMPT, 1600, 5504)
SWIGLU_SHAPES = {
    "SmolLM-360M prefill": (SERVE_B * SERVE_PROMPT, SERVE_D, SERVE_F),
    "SmolLM-360M decode": (SERVE_B, SERVE_D, SERVE_F),
    "Hymba-1.5B prefill": HYMBA_MLP,
    "Hymba-1.5B decode": (SSM_B,) + HYMBA_MLP[1:]}
# Phase 14's swiglu cases: the serve shapes, the reference's sweep, and
# ragged ones: M off 128, D off 64, F off 128, two rows passes at decode,
# the split-K route's largest D, and D % 8 != 0 (the mma.sync kernel)
SWIGLU_CASES = [*SWIGLU_SHAPES.values(), (16, 32, 48), (7, 64, 24),
                (64, 128, 256), (5, 50, 37), (130, 200, 70), (1000, 200, 72),
                (300, 1608, 136), (12, 1000, 520), (3, 2048, 64),
                (200, 962, 2560), (8, 964, 2560)]
SCAN_SHAPES = {"xlstm-125m": (4, 4, 2048, 384, 384, True),
               "hymba-1.5b": (4, 25, 2048, 16, 64, False)}
# The MoE, vision-prefix and encoder-decoder serves at full width
# (phases 29-32), bf16: 4 prompts of 1,024 tokens (InternVL2: 2 x 256
# patch embeddings + 768 tokens; Whisper: 4 x 1,500 frames + 64 tokens),
# SERVE_NEW new tokens. Llama-4-Scout runs its first 8 of 48 layers.
FAMILY_SERVES = {
    "qwen2-moe-a2.7b": dict(phase=29, B=4, prompt=1024),
    "llama4-scout-17b-a16e": dict(phase=30, B=4, prompt=1024, layers=8),
    "internvl2-26b": dict(phase=31, B=2, prompt=768),
    "whisper-large-v3": dict(phase=32, B=4, prompt=64)}
# Rows 9-11 at the shapes those serves give them: attention (B, H, G, S,
# hd), causal; rmsnorm (B, S, D) at prefill (B*S rows) and decode (B
# rows); swiglu (B, S, D, F) likewise
FAMILY_ATTN = {"qwen2-moe-a2.7b": (4, 16, 16, 1024, 128),
               "llama4-scout-17b-a16e": (4, 40, 8, 1024, 128),
               "internvl2-26b": (2, 48, 8, 1024, 128),
               "whisper-large-v3": (4, 20, 20, 64, 64)}
FAMILY_NORM = {"qwen2-moe-a2.7b": (4, 1024, 2048),
               "llama4-scout-17b-a16e": (4, 1024, 5120),
               "internvl2-26b": (2, 1024, 6144)}
FAMILY_MLP = {"internvl2-26b": (2, 1024, 6144, 16_384)}
# Kernel against plain version, by dtype: (rtol, atol) with the reasons
# in tests/test_torch_cuda.py.
SERVE_TOL = {
    "rmsnorm": {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2.0 ** -6, 1e-6)},
    "swiglu": {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-4)},
    "flash_attention": {torch.float32: (2e-5, 2e-5),
                        torch.bfloat16: (2e-2, 2e-2)}}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


T0 = time.perf_counter()


def phase(n: int, msg: str) -> None:
    """One phase's line, with the seconds since the script started."""
    print(f"[phase {n}] ({time.perf_counter() - T0:.1f} s) {msg}", flush=True)


def card() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: chip_smoke.py needs an "
                         "NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    phase(1, f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
             f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
             f"defaults: matmul allow_tf32 "
             f"{torch.backends.cuda.matmul.allow_tf32}, float32 matmul "
             f"precision {torch.get_float32_matmul_precision()!r}, cudnn "
             f"allow_tf32 {torch.backends.cudnn.allow_tf32}, deterministic "
             f"{torch.backends.cudnn.deterministic}, benchmark "
             f"{torch.backends.cudnn.benchmark}")


def build() -> None:
    from repro_torch.kernels import build as kbuild
    t0 = time.perf_counter()
    kbuild.library()
    dt = time.perf_counter() - t0
    phase(2, f"built {', '.join(p.name for p in kbuild.sources())}, one "
             f"nvcc a source in parallel and a link, {dt:.2f} s; ptxas per "
             f"entry: "
             + "; ".join(ptxas_entries(kbuild.build_log())))


def ptxas_entries(log: str) -> list[str]:
    """One ``name<template arguments>: registers, spills`` item per kernel
    entry of an ``nvcc -Xptxas -v`` log, the names demangled by the
    toolkit's ``cu++filt`` (beside ``nvcc``)."""
    from repro_torch.kernels import build as kbuild
    entries, mangled, name, spill = [], [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), ""
        elif "spill stores" in line:
            spill = line.strip()
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            mangled.append(name)
            entries.append(f"{m.group(1)} registers, {spill}")
            name = None
    check(bool(entries), "ptxas report lists the kernel entries")
    filt = Path(kbuild._nvcc()).with_name("cu++filt")
    names = subprocess.run([str(filt)], input="\n".join(mangled),
                           capture_output=True, text=True, timeout=60,
                           check=True).stdout.split("\n")
    out = []
    for full, rest in zip(names, entries):
        short = full.replace("(anonymous namespace)::", "").replace(
            "<unnamed>::", "").replace("(int)", "").replace(
            "(bool)0", "false").replace("(bool)1", "true").split("(")[0]
        out.append(f"{short.removeprefix('void ').strip()}: {rest}")
    return out


def kernel_vs_plain() -> float:
    """Every shape and dtype; returns max |err| at the main path's shape."""
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(0)
    main_err = None
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for K in (1, 3, MAIN_K, 64):
            for P in (1, 255, 4097, MAIN_P):
                u = torch.randn(K, P, generator=g, device="cuda").to(dtype)
                w = torch.rand(K, generator=g, device="cuda")
                w = w / w.sum()
                got = ops.fedavg_agg_quality(u, w)
                exp = ref.fedavg_agg_quality_ref(u, w)
                torch.cuda.synchronize()
                rtol, atol = TOL[dtype]
                torch.testing.assert_close(got[0].float(), exp[0].float(),
                                           rtol=rtol, atol=atol)
                for a, b in zip(got[1:], exp[1:]):
                    torch.testing.assert_close(a, b, rtol=1e-5,
                                               atol=1e-6 * P ** 0.5)
                if dtype == torch.float32 and (K, P) == (MAIN_K, MAIN_P):
                    main_err = max(float((a.float() - b.float()).abs().max())
                                   for a, b in zip(got, exp))
                    again = ops.fedavg_agg_quality(u, w)
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          "kernel repeats bit for bit")
                n += 1
    phase(3, f"fedavg_agg_quality vs plain: {n} cases (K in 1,3,13,64; "
             f"P in 1,255,4097,{MAIN_P}; f32+bf16) within f32 rtol 1e-5 / "
             f"bf16 agg rtol 2^-7; max |err| at K={MAIN_K} P={MAIN_P} f32: "
             f"{main_err:.3e}; repeat bit-identical")
    return main_err


def cifar_chunk():
    """A CIFAR_CNN round chunk's inputs on the card (S=4, K=13): loss,
    staged data, schedule, parameters, key and the round options."""
    from repro_torch import random as trandom
    from repro_torch.data.synthetic import make_classification_data
    from repro_torch.fl import device_data
    from repro_torch.fl.partition import partition_labels
    from repro_torch.models import cnn
    cfg = cnn.CIFAR_CNN
    data = make_classification_data("cifar", 4000, seed=1)
    parts = partition_labels(data.labels, 40, "type2", 10, seed=1)
    dd = device_data.DeviceDataset.stage(data, parts, "cuda")
    S, K = 4, MAIN_K
    rng = np.random.default_rng(1)
    rows = np.stack([rng.choice(40, K, replace=False) for _ in range(S)])
    w = rng.random((S, K)).astype(np.float32)
    sched = {"rows": torch.as_tensor(rows, device="cuda"),
             "weights": torch.as_tensor(w / w.sum(1, keepdims=True),
                                        device="cuda"),
             "active": torch.ones(S, K, device="cuda"),
             "round_ids": torch.arange(S, device="cuda")}
    params = cnn.init_params(cfg, torch.Generator().manual_seed(1), "cuda")
    key = trandom.prng_key(1, "cuda")
    kw = dict(local_lr=0.1, local_steps=2, batch_size=16, dropout_rate=0.05)
    return (lambda p, b: cnn.loss_fn(cfg, p, b)), dd, sched, params, key, kw


def chunk_kernel_vs_plain() -> None:
    from repro_torch.fl.round import make_fl_rounds_scan
    from repro_torch.kernels import ops
    loss, dd, sched, params, key, kw = cifar_chunk()
    S, K = sched["rows"].shape
    p_k, i_k = make_fl_rounds_scan(loss, **kw)(params, dd, sched, key)
    p_p, i_p = make_fl_rounds_scan(loss, kernels=ops.PLAIN, **kw)(
        params, dd, sched, key)
    torch.cuda.synchronize()
    dp = max(float((p_k[n] - p_p[n]).abs().max()) for n in p_k)
    dq = float((i_k["q_values"] - i_p["q_values"]).abs().max())
    check(torch.equal(i_k["masks"], i_p["masks"]), "chunk masks equal")
    check(all(bool(torch.isfinite(v).all()) for v in p_k.values()),
          "chunk params finite")
    check(dp <= 1e-4, f"chunk params kernel vs plain {dp} <= 1e-4")
    check(dq <= 1e-3, f"chunk q kernel vs plain {dq} <= 1e-3")
    phase(4, f"round chunk S={S} K={K} CIFAR_CNN (full f32: matmul default, "
             f"cuDNN pinned by the library): kernel vs plain aggregate max "
             f"|dparams| {dp:.3e} "
             f"(tol 1e-4), max |dq| {dq:.3e} (tol 1e-3), masks equal")


@contextlib.contextmanager
def recording():
    """Record every round as a trainer hands it to the lifecycle, on
    both planes: a list of ``(arrival or None, returned, q)``, before the
    lifecycle's own host-side masking."""
    from repro_torch.fl.simulation import DeviceFLSim, FLClassificationSim
    rounds, pending = [], []
    dispatch, collect = DeviceFLSim.dispatch_rounds, DeviceFLSim.collect
    call = FLClassificationSim.__call__

    def rec_dispatch(self, start, subsets, weights, arrivals=None):
        pending.extend([None] * len(subsets) if arrivals is None
                       else list(arrivals))
        return dispatch(self, start, subsets, weights, arrivals)

    def rec_collect(self, handles):
        out = collect(self, handles)
        for returned, q, _ in out:
            rounds.append((pending.pop(0), returned, q))
        return out

    def rec_call(self, rnd, subset, weights, arrival=None):
        out = call(self, rnd, subset, weights, arrival=arrival)
        rounds.append((arrival, out[0], out[1]))
        return out

    DeviceFLSim.dispatch_rounds, DeviceFLSim.collect = rec_dispatch, rec_collect
    FLClassificationSim.__call__ = rec_call
    try:
        yield rounds
    finally:
        DeviceFLSim.dispatch_rounds, DeviceFLSim.collect = dispatch, collect
        FLClassificationSim.__call__ = call


def service_loop(**kwargs):
    """``run_fl_experiment("cifar", "type2", ...)`` with 100 clients and
    subsets of 10 +- 3 on the card, every launch count set to 0 just
    before and read just after; ``kwargs`` go to the call (the plane is
    its default, the host loop, unless they name one). Returns the
    result, the wall time, the service loop's own time
    (``lifecycle.drain``: stage 2, training, reputation, without the data
    generation and staging around it), the launch counts, each round's
    returned-client count as the trainer reported it, the trainer, and
    the recorded rounds of :func:`recording`."""
    from repro_torch.core import lifecycle
    from repro_torch.fl.simulation import run_fl_experiment
    from repro_torch.kernels import ops
    drain = lifecycle.drain
    loop_s, trainers = [], []

    def timed_drain(provider, state, trainer, **kw):
        t = time.perf_counter()
        result = drain(provider, state, trainer, **kw)
        torch.cuda.synchronize()
        loop_s.append(time.perf_counter() - t)
        trainers.append(trainer)
        return result

    lifecycle.drain = timed_drain
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with recording() as rounds:
            out = run_fl_experiment("cifar", "type2", n_clients=100,
                                    subset_size=SUBSET_N,
                                    subset_delta=SUBSET_DELTA, **kwargs)
        torch.cuda.synchronize()
    finally:
        lifecycle.drain = drain
    wall = time.perf_counter() - t0
    check(len(loop_s) == 1, "one service loop per run")
    arrived = [int(np.sum(returned)) for _, returned, _ in rounds]
    return (out, wall, loop_s[0], dict(ops.LAUNCHES), arrived, trainers[0],
            rounds)


def slice_run() -> tuple[int, float]:
    """Phase 5; returns the kernel's launches and ms per round."""
    from repro_torch.core import fairness
    rounds = 24
    out, wall, loop_s, counts, *_ = service_loop(
        rounds=rounds, n_train=50_000, n_test=10_000, data_plane="device",
        round_chunk=8)
    launches = counts["fedavg_agg_quality"]
    hist, state = out["history"], out["state"]
    trained = len(hist)
    losses = [h["loss"] for h in hist]
    check(trained == rounds, f"{trained} rounds trained, asked {rounds}")
    check(launches == trained,
          f"kernel launches {launches} == rounds trained {trained}")
    check(all(np.isfinite(losses)), "finite losses")
    check(0.0 <= out["final_accuracy"] <= 1.0, "accuracy in [0, 1]")
    rep = fairness.fairness_report(state.schedules[0],
                                   sorted(state.pool), x_star=3)
    check(rep["coverage"] and rep["bounded"],
          "first period's schedule covers the pool within x*")
    ms = loop_s / trained * 1e3
    phase(5, f"slice: pool {len(state.pool)} clients, {trained} rounds, "
             f"loss first {losses[0]:.4f} last {losses[-1]:.4f}, final "
             f"accuracy {out['final_accuracy']:.4f}; wall {wall:.2f} s, of "
             f"which the service loop {loop_s:.2f} s = {ms:.1f} ms/round "
             f"(rest: data set-up and final eval); fedavg_agg_quality "
             f"launches {launches}")
    return launches, ms


def time_ms(fn, samples: int = 20, calls: int = 10) -> float:
    """Median over ``samples`` of the device time of one replay of a
    CUDA graph that holds ``calls`` back-to-back calls, per call: the
    host's launch overhead stays out of the number, even for a kernel
    shorter than its launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def kernel_times(fn) -> tuple:
    """Run ``fn`` under ``torch.profiler``, recording CUDA activity only:
    the host's ops would multiply the profiler's cost on xLSTM's
    prefill, whose sLSTM steps launch about 90,000 small kernels.
    Returns its result and ``{kernel name: (device ms, launches)}``,
    the most device time first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
    times = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and dev(e) > 0:
            name = re.sub(r"\(.*", "", e.key.replace(
                "(anonymous namespace)::", "").replace("<unnamed>::", "")
                .removeprefix("void ")).strip()
            ms, n = times.get(name, (0.0, 0))
            times[name] = (ms + dev(e) / 1e3, n + e.count)
    return out, dict(sorted(times.items(), key=lambda kv: -kv[1][0]))


def launch_split(fn, calls: int = 10) -> dict:
    """Device ms and launches of one call of ``fn`` by kernel name, over
    ``calls`` calls after a warm-up: where a kernel of several launches
    spends its time."""
    fn()
    torch.cuda.synchronize()
    _, times = kernel_times(lambda: [fn() for _ in range(calls)])
    return {name: {"ms": ms / calls, "launches": n / calls}
            for name, (ms, n) in times.items()}


def one_launch(fn, what: str) -> dict:
    """``launch_split`` of ``fn``, checked to name one kernel at no more
    than one launch a call (a memset beside it is no kernel launch).
    CUPTI can drop kernel records from a window (seen: 9 of 10 recorded,
    and once none), so a split without a kernel is taken again, up to
    three times."""
    is_kernel = lambda name: not name.startswith(("Memset", "Memcpy"))
    for _ in range(3):
        split = launch_split(fn)
        kernels = {k: s for k, s in split.items() if is_kernel(k)}
        if kernels:
            break
    check(len(kernels) == 1 and all(s["launches"] <= 1
                                    for s in kernels.values()),
          f"{what} is one launch a call: {split_text(split)}")
    return split


def split_text(split: dict) -> str:
    return ", ".join(f"{name} x{s['launches']:g} {s['ms']:.4f} ms"
                     for name, s in split.items())


def timing(fleet) -> dict:
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import swiglu as kswiglu
    g = torch.Generator(device="cuda").manual_seed(2)
    u = torch.randn(MAIN_K, MAIN_P, generator=g, device="cuda")
    w = torch.softmax(torch.randn(MAIN_K, generator=g, device="cuda"), 0)
    ms = time_ms(lambda: ops.fedavg_agg_quality(u, w))
    plain_ms = time_ms(lambda: ref.fedavg_agg_quality_ref(u, w))
    mv_ms = time_ms(lambda: torch.mv(u.T, w))
    nbytes = 4 * (MAIN_K * MAIN_P + MAIN_K + MAIN_P + 2 * MAIN_K + 1)
    flops = 6 * MAIN_K * MAIN_P + 2 * MAIN_P
    out = {"fedavg_agg_quality": {
        "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        "agg_only_mv_ms": mv_ms, **bound(nbytes, flops)}}
    lines = [f"fedavg_agg_quality K={MAIN_K} P={MAIN_P} f32: kernel "
             f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.mv(U.T, w) (agg "
             f"only) {mv_ms:.4f} ms; bound {out['fedavg_agg_quality']['bound_ms']:.4f} ms "
             f"({nbytes} B, {flops} flop)"]
    lines += agg_timing(u, w, mv_ms, out, g)

    # segmented_topk on the fleet's masked ratio (8 x 131,072, k = 4,096)
    x, k = fleet["ratio"], FLEET_K
    S, C = x.shape
    ms = time_ms(lambda: ops.segmented_topk(x, k))
    plain_ms = time_ms(lambda: ref.segmented_topk_ref(x, k))
    lib_ms = time_ms(lambda: torch.topk(x, k, dim=1))
    split = launch_split(lambda: ops.segmented_topk(x, k))
    nbytes = S * C * 4 + S * k * 8
    out["segmented_topk"] = {"ms": ms, "plain_ms": plain_ms,
                             "library_ms": lib_ms, **bound(nbytes, S * C),
                             "split": split}
    lines.append(f"segmented_topk S={S} C={C} k={k}: kernel {ms:.4f} ms, "
                 f"plain {plain_ms:.4f} ms, torch.topk {lib_ms:.4f} ms; "
                 f"bound {out['segmented_topk']['bound_ms']:.4f} ms "
                 f"({nbytes} B); one call by launch group: "
                 + split_text(split))

    # mkp_utility on stage 2's first MKP over task 0's pool
    v, wt, r, sel = fleet["mkp_args"]
    n, m = wt.shape
    ms = time_ms(lambda: ops.mkp_utility(v, wt, r, sel))
    plain_ms = time_ms(lambda: ref.mkp_utility_ref(v, wt, r, sel))
    s_ = 1.0 / r.clamp_min(1e-12)
    mv_ms = time_ms(lambda: torch.mv(wt, s_))
    nbytes = 4 * (n * (m + 2) + m) + n
    out["mkp_utility"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                          "penalty_only_mv_ms": mv_ms,
                          **bound(nbytes, 2 * n * m + m + n)}
    lines.append(f"mkp_utility n={n} m={m}: kernel {ms:.4f} ms, plain "
                 f"{plain_ms:.4f} ms, torch.mv(w, s) (penalty only) "
                 f"{mv_ms:.4f} ms; bound {out['mkp_utility']['bound_ms']:.6f} ms "
                 f"({nbytes} B)")
    lines += greedy_timing(fleet, out)
    lines += compression_timing(u, w, out)
    lines += serve_timing(out)
    lines.append("swiglu routes: " + ", ".join(
        f"{name} {kswiglu.route(torch.bfloat16, *shape, True)}"
        for name, shape in SWIGLU_SHAPES.items()))
    lines += scan_timing(out)
    phase(6, "median of 20 replays of a graph of 10 calls; bounds at "
             "3.35 TB/s and 67 TFLOP/s f32 (989 TFLOP/s bf16 for the "
             "products of swiglu and flash_attention and for mlstm_scan's "
             "bf16 products over the causal pairs of each chunk, those "
             "with an f32 operand counted three times, the split that "
             "keeps f32 accuracy): "
             + " | ".join(lines))
    return out


def greedy_timing(fleet, out) -> list[str]:
    """``mkp_greedy``, one launch a solve, on stage 2's first MKP over task
    0's pool (n about 3,846, m = 10, 13 picks), beside its plain version
    and the route it replaced: :func:`per_pick_loop` over ``mkp_utility``
    (about 9 launches a pick), each in a CUDA graph, so the loop's
    launches cost no host time: the launch-free yardstick. No one PyTorch call computes
    the greedy (library null). The bound counts this solve's picks (each
    a pass over the pool) and its bytes (v, w and cap read once, the mask
    and used written once). Fills ``out`` and returns the phase-6
    line."""
    from repro_torch.kernels import ops, ref
    v, wt, cap, _ = fleet["mkp_args"]
    n, m = wt.shape
    picks = SUBSET_N + SUBSET_DELTA
    sel, _ = ops.mkp_greedy(v, wt, cap, picks)
    made = int(sel.sum())
    scored = min(picks, made + 1)           # a pick that is not finite ends it
    ms = time_ms(lambda: ops.mkp_greedy(v, wt, cap, picks))
    plain_ms = time_ms(lambda: ref.mkp_greedy_ref(v, wt, cap, picks))
    loop_ms = time_ms(lambda: per_pick_loop(ops, v, wt, cap, picks))
    one_launch(lambda: ops.mkp_greedy(v, wt, cap, picks), "mkp_greedy")
    nbytes = 4 * (n + n * m + m) + n + 4 * m
    t = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
         "per_pick_loop_ms": loop_ms, "picks": made, "ms_a_pick": ms / scored,
         **bound(nbytes, scored * (2 * n * m + n + 4 * m))}
    out["mkp_greedy"] = t
    return [f"mkp_greedy n={n} m={m} max {picks} picks ({made} made): kernel "
            f"{ms:.4f} ms ({t['ms_a_pick'] * 1e3:.2f} us a pick, one launch), "
            f"plain {plain_ms:.4f} ms, the per-pick loop over mkp_utility in "
            f"a graph {loop_ms:.4f} ms; bound {t['bound_ms']:.6f} ms "
            f"({nbytes} B, {t['bound_by']})"]


def per_pick_loop(ops, v, w, cap, picks):
    """Stage 2's greedy as the engine ran it before ``mkp_greedy``: a
    launch of ``ops.mkp_utility`` and a few small PyTorch ops a pick, no
    host sync (so a CUDA graph captures it). ``ops`` is a tree's
    ``repro_torch.kernels.ops``: ``tools/stage2_bench.py`` runs it on a
    parent tree too."""
    n, m = w.shape
    used = torch.zeros(m, dtype=torch.float32, device=w.device)
    in_sel = torch.zeros(n, dtype=torch.bool, device=w.device)
    zero = torch.zeros(m, dtype=torch.float32, device=w.device)
    for _ in range(picks):
        util = ops.mkp_utility(v, w, cap - used, ~in_sel)
        j = torch.argmax(util).view(1)          # first maximum
        ok = torch.isfinite(util[j])
        in_sel[j] = in_sel[j] | ok
        used = used + torch.where(ok, w[j][0], zero)
    return in_sel, used


def agg_timing(u, w, mv_ms, out, g) -> list[str]:
    """``fedavg_agg`` at the fused kernel's shape and over the 8 CIFAR_CNN
    leaves at K = 13 (what one host-loop round launches: one launch over
    all leaves), beside the same leaves one launch each (the single-matrix
    entry), the byte bound and ``torch.mv(U.T, w)``, the one PyTorch call
    that computes the same sum. Fills ``out`` and returns the phase-6
    lines."""
    from repro_torch.kernels import fedavg_agg as kagg
    from repro_torch.kernels import ops, ref
    from repro_torch.models import cnn
    K, P = MAIN_K, MAIN_P
    t = {"ms": time_ms(lambda: ops.fedavg_agg(u, w)),
         "plain_ms": time_ms(lambda: ref.fedavg_agg_ref(u, w)),
         "library_ms": mv_ms, **bound(4 * (K * P + K + P), 2 * K * P)}
    leaves = {n: torch.randn((K,) + shape, generator=g, device="cuda")
              for n, shape in cnn.param_shapes(cnn.CIFAR_CNN).items()}
    sizes = [v[0].numel() for v in leaves.values()]
    flat = [v.reshape(K, -1) for v in leaves.values()]
    per_leaf = functools.partial(kagg.fedavg_agg_tree, agg=ops.fedavg_agg)
    t["per_round_8_leaves"] = {
        "ms": time_ms(lambda: ops.fedavg_agg_tree(leaves, w)),
        "per_leaf_launches_ms": time_ms(lambda: per_leaf(leaves, w)),
        "plain_ms": time_ms(lambda: ops.PLAIN.fedavg_agg_tree(leaves, w)),
        "library_ms": time_ms(lambda: [torch.mv(f.T, w) for f in flat]),
        **bound(sum(4 * (K * n + K + n) for n in sizes),
                sum(2 * K * n for n in sizes))}
    out["fedavg_agg"] = t
    r = t["per_round_8_leaves"]
    return [f"fedavg_agg K={K} P={P} f32: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, torch.mv(U.T, w) {mv_ms:.4f} ms; bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']})",
            f"fedavg_agg over the 8 CIFAR_CNN leaves at K={K} (P {sizes}): "
            f"kernel, one launch {r['ms']:.4f} ms (one launch a leaf "
            f"{r['per_leaf_launches_ms']:.4f} ms), plain {r['plain_ms']:.4f} "
            f"ms, 8 torch.mv {r['library_ms']:.4f} ms; bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})"]


def compression_timing(u, w, out) -> list[str]:
    """The codec kernels at the compressed loop's shapes: the deltas U
    (13, 1,070,794) and, for topk:0.05+int8, their k = 53,540 kept values
    a row. Fills ``out`` and returns the phase-6 lines."""
    from repro_torch.kernels import ops, ref
    K, P, k = MAIN_K, MAIN_P, MAIN_TOPK
    nc, nck = -(-P // CHUNK), -(-k // CHUNK)
    vals, _ = ops.topk_sparsify(u, k)
    v, sc = ops.quantize_i8(u, CHUNK)
    vk, sk = ops.quantize_i8(vals, CHUNK)
    cases = {   # name: kernel, plain, library call or None, bytes, flops
        "topk_sparsify": (lambda: ops.topk_sparsify(u, k),
                          lambda: ref.topk_sparsify_ref(u, k),
                          lambda: torch.topk(u.abs(), k, dim=1),
                          4 * K * P + 8 * K * k, K * P),
        "quantize_i8": (lambda: ops.quantize_i8(u, CHUNK),
                        lambda: ref.quantize_i8_ref(u, CHUNK), None,
                        5 * K * P + 4 * K * nc, 3 * K * P),
        "quantize_i8 (top-k values)": (
            lambda: ops.quantize_i8(vals, CHUNK),
            lambda: ref.quantize_i8_ref(vals, CHUNK), None,
            5 * K * k + 4 * K * nck, 3 * K * k),
        "dequantize_i8": (lambda: ops.dequantize_i8(vk, sk, CHUNK),
                          lambda: ref.dequantize_i8_ref(vk, sk, CHUNK), None,
                          5 * K * k + 4 * K * nck, K * k),
        "fedavg_agg_quality_i8": (
            lambda: ops.fedavg_agg_quality_i8(v, sc, w, CHUNK),
            lambda: ref.fedavg_agg_quality_i8_ref(v, sc, w, CHUNK), None,
            K * P + 4 * (K * nc + K + P + 2 * K + 1), 7 * K * P + 2 * P)}
    lines = []
    for name, (fn, plain, lib, nbytes, flops) in cases.items():
        t = {"ms": time_ms(fn), "plain_ms": time_ms(plain),
             "library_ms": None if lib is None else time_ms(lib),
             **bound(nbytes, flops)}
        lib_s = "" if lib is None else \
            f", torch.topk(|U|) {t['library_ms']:.4f} ms"
        shape = f"({K}, {k})" if "top-k" in name or name == "dequantize_i8" \
            else f"({K}, {P})"
        if name == "topk_sparsify":
            t["split"] = launch_split(fn)
            lib_s += "; one call by launch group: " + split_text(t["split"])
        if name == "fedavg_agg_quality_i8":
            t["split"] = one_launch(fn, name)
            lib_s += "; one call: " + split_text(t["split"])
        lines.append(f"{name} {shape}: kernel {t['ms']:.4f} ms, plain "
                     f"{t['plain_ms']:.4f} ms{lib_s}; bound "
                     f"{t['bound_ms']:.4f} ms ({nbytes} B)")
        out[name] = t
    out["quantize_i8"]["at_topk_values"] = out.pop(
        "quantize_i8 (top-k values)")
    return lines


def serve_timing(out) -> list[str]:
    """The serve path's kernels at the shapes the full-width serves give
    them (bf16): SmolLM-360M's prefill (8 x 1,024 tokens) and, for rmsnorm
    and swiglu, a decode step (8 tokens); flash_attention and swiglu also
    at Hymba-1.5B's prefill (4 x 2,048 tokens) and swiglu at its decode
    step (4 tokens). Fills ``out`` and returns the phase-6 lines. Library
    yardsticks the port never calls: ``F.rms_norm``,
    ``F.scaled_dot_product_attention`` (causal, GQA; at Hymba's shape with
    the window as a boolean mask); no one call computes SwiGLU, so beside
    it stand ``x @ w_gate`` alone and both products in one call, ``x @
    w_gu`` with ``w_gu = cat([w_gate, w_up], 1)`` built outside the
    timing."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(6)
    bf = torch.bfloat16
    rn = lambda *shape, s=1.0: (torch.randn(
        *shape, generator=g, device="cuda") * s).to(bf)
    M, D, Fd = SERVE_B * SERVE_PROMPT, SERVE_D, SERVE_F
    B, S, H, G, hd = SERVE_B, SERVE_PROMPT, SERVE_H, SERVE_G, SERVE_HD
    scale = rn(D)
    lines = []

    def mlp_timed(m, d, f, wg, wu):
        x, w_gu = rn(m, d), torch.cat([wg, wu], 1)
        return {"ms": time_ms(lambda: ops.swiglu(x, wg, wu)),
                "plain_ms": time_ms(lambda: ref.swiglu_ref(x, wg, wu)),
                "library_ms": None,
                "gate_product_ms": time_ms(lambda: x @ wg),
                "both_products_ms": time_ms(lambda: x @ w_gu),
                **bound(2 * (m * d + 2 * d * f + m * f), 4 * m * d * f,
                        PEAK_BF16_FLOPS)}

    norm = norm_timing(rn(M, D), scale)
    norm["at_decode"] = norm_timing(rn(SERVE_B, D), scale)
    wg, wu = rn(D, Fd, s=D ** -0.5), rn(D, Fd, s=D ** -0.5)
    mlp = mlp_timed(M, D, Fd, wg, wu)
    mlp["at_decode"] = mlp_timed(SERVE_B, D, Fd, wg, wu)
    hm, hd_, hf = HYMBA_MLP
    hwg, hwu = rn(hd_, hf, s=hd_ ** -0.5), rn(hd_, hf, s=hd_ ** -0.5)
    mlp["at_hymba"] = mlp_timed(hm, hd_, hf, hwg, hwu)
    mlp["at_hymba_decode"] = mlp_timed(SSM_B, hd_, hf, hwg, hwu)
    del hwg, hwu

    def attn_timed(B, S, H, G, window, lib):
        """Causal attention over (B, S, H, hd) views; the bound counts the
        (q, k) pairs the mask keeps."""
        q, k, v = rn(B, S, H, hd), rn(B, S, G, hd), rn(B, S, G, hd)
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        pairs = sum(min(i + 1, window) if window else i + 1 for i in range(S))
        return {"ms": time_ms(lambda: ops.flash_attention_bshd(
                    q, k, v, window=window)),
                "plain_ms": time_ms(lambda: ref.flash_attention_ref(
                    qt, kt, vt, window=window)),
                "library_ms": time_ms(lambda: lib(qt, kt, vt)),
                **bound(2 * (2 * B * H * S * hd + 2 * B * G * S * hd),
                        4 * B * H * hd * pairs, PEAK_BF16_FLOPS)}

    attn = attn_timed(B, S, H, G, 0, lambda qt, kt, vt: (
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)))
    # Hymba-1.5B's prefill: 25 / 5 heads, a 1,024-token window; SDPA takes
    # the window as a boolean mask, off its flash path
    hb, hs, hh, hg, hw = SSM_B, SSM_PROMPT, 25, 5, 1024
    pos = torch.arange(hs, device="cuda")
    win = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - hw)
    attn["at_hymba"] = attn_timed(hb, hs, hh, hg, hw, lambda qt, kt, vt: (
        F.scaled_dot_product_attention(qt, kt, vt, attn_mask=win,
                                       enable_gqa=True)))
    out.update(rmsnorm=norm, swiglu=mlp, flash_attention=attn)
    for name, t, shape, lib in (
            ("rmsnorm", norm, f"({M}, {D})", "F.rms_norm"),
            ("rmsnorm decode", norm["at_decode"], f"({SERVE_B}, {D})",
             "F.rms_norm"),
            ("flash_attention", attn, f"q ({B}, {H}, {S}, {hd}) causal GQA "
             f"G={G}, (B, S, H, hd) views", "SDPA causal GQA"),
            ("flash_attention at Hymba-1.5B's prefill", attn["at_hymba"],
             f"q ({hb}, {hh}, {hs}, {hd}) G={hg} causal, window {hw}",
             "SDPA with the window as a mask")):
        lines.append(f"{name} {shape} bf16: kernel {t['ms']:.4f} ms, plain "
                     f"{t['plain_ms']:.4f} ms, {lib} {t['library_ms']:.4f} "
                     f"ms; bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    for name, t, (m, d, f) in (
            ("swiglu", mlp, (M, D, Fd)),
            ("swiglu decode", mlp["at_decode"], (SERVE_B, D, Fd)),
            ("swiglu at Hymba-1.5B's prefill", mlp["at_hymba"], HYMBA_MLP),
            ("swiglu at Hymba-1.5B's decode", mlp["at_hymba_decode"],
             (SSM_B, hd_, hf))):
        lines.append(f"{name} M={m} D={d} F={f} bf16: kernel {t['ms']:.4f} "
                     f"ms, plain {t['plain_ms']:.4f} ms, x @ w_gate alone "
                     f"{t['gate_product_ms']:.4f} ms, both products in one "
                     f"call (x @ w_gu) {t['both_products_ms']:.4f} ms; bound "
                     f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    return lines


def scan_inputs(B, H, S, dk, dv, normalize, dtype, g, init=False):
    """q, k, v (k scaled by dk**-0.5), log f = log_sigmoid(N + 2), log i
    = 0.5 N (None for SSD) and, with ``init``, an initial state."""
    rn = lambda *shape: torch.randn(*shape, generator=g, device="cuda")
    q, k = rn(B, H, S, dk).to(dtype), (rn(B, H, S, dk) * dk ** -0.5).to(dtype)
    v = rn(B, H, S, dv).to(dtype)
    f = torch.nn.functional.logsigmoid(rn(B, H, S) + 2)
    i = rn(B, H, S) * 0.5 if normalize else None
    state = None
    if init:
        state = {"S": rn(B, H, dk, dv) * 0.5, "n": rn(B, H, dk) * 0.5,
                 "m": rn(B, H) * 0.2 if normalize else torch.zeros(
                     B, H, device="cuda")}
    return q, k, v, f, i, state


def scan_bound(B, H, S, dk, dv, normalize, itemsize=2) -> dict:
    """The scan's least time. Products within each chunk over the causal
    pairs c' <= c alone (the function needs no others): Q K^T and P V;
    then q.S (and q.n with normalization) and the state update. On bf16
    inputs Q K^T is exact on the tensor cores: one product at the bf16
    rate. The others take an f32 operand (P, S, w o K), which the
    tensor cores multiply to f32 accuracy as three bf16 products (the
    operand split into hi + mid + lo, each exact times the bf16 one), so
    they count three times at the bf16 rate (a third of 989 TFLOP/s is
    about five times the f32 rate of 67: counted at the f32 rate, the
    bound would lie above the time a kernel that splits can reach). In f32 every product is at
    the f32 rate (the oracle's arithmetic). q, k, v and the gates read
    once, the output and the f32 state written once."""
    qk = flops = 0
    for start in range(0, S, SCAN_CHUNK):
        c = min(SCAN_CHUNK, S - start)
        pairs = c * (c + 1) // 2
        qk += 2 * pairs * dk
        flops += 2 * pairs * dv + 4 * c * dk * dv
        if normalize:
            flops += 4 * c * dk
    nbytes = (B * H * S * (2 * dk + 2 * dv) * itemsize
              + 4 * B * H * S * (2 if normalize else 1)
              + 4 * B * H * (dk * dv + dk + 1))
    if itemsize != 2:
        return bound(nbytes, B * H * (flops + qk))
    return bound(nbytes, 0, bf16_flops=B * H * (qk + 3 * flops))


def scan_routed(call):
    """Call ``call`` (one ``mlstm_scan`` launch) and return its result
    and the route the wrapper took, read from ``kernels.mlstm_scan``'s
    launch counts by route ("simple" for a tree whose binding keeps
    none: one kernel for all)."""
    from repro_torch.kernels import mlstm_scan as kscan
    counts = getattr(kscan, "ROUTES", None)
    if counts is None:
        return call(), "simple"
    before = dict(counts)
    out = call()
    taken = [r for r in counts if counts[r] != before[r]]
    check(len(taken) == 1 and counts[taken[0]] == before[taken[0]] + 1,
          f"mlstm_scan: one launch on one route, got {taken}")
    return out, taken[0]


def scan_cancel_inputs(part, g):
    """bf16 inputs on which the chunked route's output needs every one of
    the three bf16 terms of an f32 operand (S within one or two chunks of
    256, so the part under test makes the output): ``"P"``, normalized,
    one chunk from zeros, the keys in pairs with equal k, opposite v and
    weights 2**-6 apart, so P V is a difference of near-equal terms; one
    bf16 term of P (2**-9 of it) then misses by about 2**-3 of the output.
    ``"S"``, SSD from an initial state whose rows come in pairs, S_2d+1 =
    -(1 + 2**-6) S_2d, met by q equal in each pair, and v 2**-20 small,
    so q . S_prev is such a difference. Returns (q, k, v, log f, log i,
    state, chunk, normalize)."""
    rn = lambda *shape: torch.randn(*shape, generator=g, device="cuda")
    bf, d = torch.bfloat16, 2.0 ** -6
    if part == "P":
        B, H, S, dk, dv = 1, 4, 256, 64, 128
        q = rn(B, H, S, dk).to(bf)
        k = (rn(B, H, S // 2, dk) * dk ** -0.5).to(bf).repeat_interleave(2, 2)
        v = rn(B, H, S // 2, dv).to(bf).repeat_interleave(2, 2)
        v[:, :, 1::2] = -v[:, :, 1::2]
        f = torch.nn.functional.logsigmoid(rn(B, H, S) + 4)
        i = (rn(B, H, S // 2) * 0.5).repeat_interleave(2, 2)
        i[..., 1::2] += f[..., 1::2] + d     # p_2t+1 = e^d p_2t
        return q, k, v, f, i, None, 256, True
    B, H, S, dk, dv = 1, 4, 300, 128, 128
    q = rn(B, H, S, dk // 2).to(bf).repeat_interleave(2, 3)
    k = (rn(B, H, S, dk) * dk ** -0.5).to(bf)
    v = (rn(B, H, S, dv) * 2.0 ** -20).to(bf)
    f = torch.nn.functional.logsigmoid(rn(B, H, S) + 4)
    S0 = rn(B, H, dk // 2, dv).repeat_interleave(2, 2)
    S0[:, :, 1::2] *= -(1 + d)
    state = {"S": S0, "n": torch.zeros(B, H, dk, device="cuda"),
             "m": torch.zeros(B, H, device="cuda")}
    return q, k, v, f, None, state, 256, False


def scan_ratio(case, got, want) -> float:
    """The largest |got - want| / (atol + rtol |want|) over the output and
    the final S, n, m (held when at most 1): rtol 2**-7 (one bf16 ulp)
    for a bf16 output, 1e-4 for f32, atol 2e-5 x max(1, max |want|); the
    reasons are in tests/test_torch_cuda.py."""
    worst = 0.0
    for a, b in zip((got[0], *got[1].values()), (want[0], *want[1].values())):
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"mlstm_scan {case}: dtype and shape")
        rtol = 2.0 ** -7 if b.dtype == torch.bfloat16 else 1e-4
        a, b = a.float(), b.float()
        lim = 2e-5 * max(1.0, float(b.abs().max())) + rtol * b.abs()
        r = ((a - b).abs() / lim).nan_to_num(nan=float("inf"))
        worst = max(worst, float(r.max()))
    return worst


def scan_timing(out) -> list[str]:
    """``mlstm_scan`` at the two serve shapes in bf16, with the route it
    takes and one call's device time by kernel name, beside its plain
    version and its bound; no PyTorch call computes gated linear
    attention (library null). Fills ``out`` and returns the phase-6
    lines."""
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(21)
    lines, t = [], {}
    for arch, (B, H, S, dk, dv, nz) in SCAN_SHAPES.items():
        q, k, v, f, i, _ = scan_inputs(B, H, S, dk, dv, nz, torch.bfloat16, g)
        call = lambda: ops.mlstm_scan(q, k, v, f, i, chunk=SCAN_CHUNK,
                                      normalize=nz)
        t[arch] = {"ms": time_ms(call),
                   "plain_ms": time_ms(lambda: ref.mlstm_scan_state_ref(
                       q, k, v, f, i, chunk=SCAN_CHUNK, normalize=nz)),
                   "library_ms": None, "route": scan_routed(call)[1],
                   "split": launch_split(call),
                   **scan_bound(B, H, S, dk, dv, nz)}
        r = t[arch]
        lines.append(f"mlstm_scan {arch} ({B}, {H}, {S}, {dk} / {dv}) bf16 "
                     f"{'normalized' if nz else 'SSD'}, chunk {SCAN_CHUNK}, "
                     f"route {r['route']}: kernel {r['ms']:.4f} ms (one "
                     f"call: {split_text(r['split'])}), plain "
                     f"{r['plain_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
                     f"({r['bound_by']})")
    out["mlstm_scan"] = {**t["xlstm-125m"], "at_hymba": t["hymba-1.5b"]}
    return lines


def scan_comparisons(g):
    """Phase 21's cases, one at a time: ``(case, the route it must take
    or None, the kernel's (out, state), the route it took, the plain
    version's)``. (B, H, S, dk, dv, chunk, normalize, init): the serve
    shapes (bf16: the chunk-parallel ``wgmma`` route); the reference's
    sweep and odd widths (the one-block kernel in bf16 too: chunks under
    64, dk 20, dv 65); for the chunked route dk and dv at one tile and
    several, off the tile (72, 320), S under one chunk and ragged, chunks
    of 64, 128 and 256, and dk 512; f32 always the one-block kernel.
    Then Hymba's sliced (B, S, H, d) views through the bshd adapter, and
    the two inputs of :func:`scan_cancel_inputs`."""
    from repro_torch.kernels import ops, ref
    cases = [(*SCAN_SHAPES[a][:5], SCAN_CHUNK, SCAN_SHAPES[a][5], False)
             for a in SCAN_SHAPES]
    for nz in (True, False):
        cases += [(2, 3, 32, 16, 8, 8, nz, False), (2, 3, 40, 16, 8, 16, nz, False),
                  (2, 3, 16, 16, 8, 16, nz, False),
                  (1, 2, 300, 20, 70, 64, nz, False),
                  (1, 2, 300, 20, 70, 64, nz, True),
                  (2, 5, 700, 16, 64, 256, nz, True),
                  (1, 2, 1000, 384, 384, 256, nz, True),
                  (1, 2, 129, 512, 65, 128, nz, False),
                  (2, 2, 40, 64, 64, 256, nz, False),
                  (1, 3, 200, 64, 64, 64, nz, True),
                  (1, 2, 300, 128, 192, 128, nz, False),
                  (1, 2, 130, 72, 320, 64, nz, True),
                  (1, 2, 129, 512, 64, 128, nz, True)]
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, S, dk, dv, C, nz, init in cases:
            q, k, v, f, i, st = scan_inputs(B, H, S, dk, dv, nz, dtype, g,
                                            init)
            serve = (B, H, S, dk, dv, nz) in SCAN_SHAPES.values()
            case = ((B, H, S, dk, dv), C, "mlstm" if nz else "ssd",
                    "init" if init else "zero", str(dtype)[6:],
                    "serve" if serve else "")
            expect = "simple" if dtype == torch.float32 else \
                "wgmma" if serve else None
            got, route = scan_routed(lambda: ops.mlstm_scan(
                q, k, v, f, i, chunk=C, normalize=nz, initial_state=st))
            yield case, expect, got, route, ref.mlstm_scan_state_ref(
                q, k, v, f, i, chunk=C, normalize=nz, initial_state=st)
        # Hymba's layout: C and B sliced from one (B, S, 2, H, N)
        # projection, the gates (B, S, H), through the bshd adapter; k
        # scaled (a copy) and k the model's own strided slice
        B, S, H, N, dh = 2, 600, 25, 16, 64
        bc = torch.randn(B, S, 2, H, N, generator=g, device="cuda").to(dtype)
        v = torch.randn(B, S, H, dh, generator=g, device="cuda").to(dtype)
        f = -torch.rand(B, S, H, generator=g, device="cuda")
        for kk in (bc[:, :, 0] * 0.25, bc[:, :, 0]):
            got, route = scan_routed(lambda: ops.mlstm_scan_bshd(
                bc[:, :, 1], kk, v, f, None, chunk=SCAN_CHUNK,
                normalize=False))
            check(got[0].is_contiguous(),
                  "bshd output (B, S, H, dv) contiguous")
            yield (("bshd views", "k copy" if kk.is_contiguous() else
                    "k strided", str(dtype)[6:]),
                   "wgmma" if dtype == torch.bfloat16 else "simple", got,
                   route, ops.PLAIN.mlstm_scan_bshd(
                       bc[:, :, 1], kk, v, f, None, chunk=SCAN_CHUNK,
                       normalize=False))
    for part in ("P", "S"):
        q, k, v, f, i, st, C, nz = scan_cancel_inputs(part, g)
        got, route = scan_routed(lambda: ops.mlstm_scan(
            q, k, v, f, i, chunk=C, normalize=nz, initial_state=st))
        yield ("cancel", part), "wgmma", got, route, \
            ref.mlstm_scan_state_ref(q, k, v, f, i, chunk=C, normalize=nz,
                                     initial_state=st)


# S long against one call's memory: the chunked route's scratch is one
# f32 state a chunk, about 305 MB at this shape (NC = 128)
SCAN_LONG = (1, 4, 32768, 384, 384)


def scan_long() -> dict:
    """``mlstm_scan`` at ``SCAN_LONG`` in bf16, normalized: held to the
    plain version, and the memory the call takes above its inputs (the
    allocator's peak) at most its output, its final state and the
    workspace :func:`kernels.mlstm_scan.workspace` states, plus 2 MB of
    the allocator's rounding."""
    from repro_torch.kernels import mlstm_scan as kscan
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(23)
    B, H, S, dk, dv = SCAN_LONG
    q, k, v, f, i, _ = scan_inputs(B, H, S, dk, dv, True, torch.bfloat16, g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got, route = scan_routed(lambda: ops.mlstm_scan(
        q, k, v, f, i, chunk=SCAN_CHUNK, normalize=True))
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    ws = 4 * kscan.workspace(B, H, S, dk, dv, SCAN_CHUNK)
    allowed = (got[0].nbytes + sum(t.nbytes for t in got[1].values()) + ws
               + 2 ** 21)
    check(route == "wgmma", f"mlstm_scan {SCAN_LONG}: route {route}")
    check(extra <= allowed, f"mlstm_scan {SCAN_LONG}: {extra} bytes above "
                            f"the inputs, more than {allowed}")
    ratio = scan_ratio(SCAN_LONG, got, ref.mlstm_scan_state_ref(
        q, k, v, f, i, chunk=SCAN_CHUNK, normalize=True))
    check(ratio <= 1.0, f"mlstm_scan {SCAN_LONG}: err / limit {ratio:.3g}")
    return {"extra_mb": extra / 2 ** 20, "workspace_mb": ws / 2 ** 20,
            "ratio": ratio}


def scan_kernel_vs_plain() -> float:
    """Phase 21: ``mlstm_scan`` against its plain version, output and
    final state, over :func:`scan_comparisons`, each case on the route
    the wrapper reports it took (the serve shapes and the views in bf16
    on the chunk-parallel ``wgmma`` route, f32 on the one-block kernel),
    and :func:`scan_long`. Returns max |err| of the output at the two
    serve shapes in bf16."""
    g = torch.Generator(device="cuda").manual_seed(22)
    n, main, worst, routes, cancel = 0, 0.0, 0.0, {}, {}
    for case, expect, got, route, want in scan_comparisons(g):
        check(expect is None or route == expect,
              f"mlstm_scan {case}: route {route}, not {expect}")
        ratio = scan_ratio(case, got, want)
        check(ratio <= 1.0, f"mlstm_scan {case}: err / limit {ratio:.3g}")
        err = float((got[0].float() - want[0].float()).abs().max())
        worst = max(worst, err)
        if "serve" in case and "bfloat16" in case:
            main = max(main, err)
        if case[0] == "cancel":
            cancel[case[1]] = ratio
        n += 1
        routes[route] = routes.get(route, 0) + 1
    long = scan_long()
    torch.cuda.synchronize()
    phase(21, f"mlstm_scan vs plain on the card: {n} cases, by the route "
              f"each took {routes} (the serve shapes {list(SCAN_SHAPES.values())} in "
              f"bf16 on the wgmma route; (B, H, S, dk, dv) from "
              f"(2, 3, 16, 16, 8) to (1, 2, 1000, 384, 384) and dk 512, "
              f"chunks 8-256, S under one chunk and ragged, dk and dv at "
              f"one 64-wide tile and several and off the tile, from zeros "
              f"and from an initial state; Hymba's sliced (B, S, H, d) "
              f"views, k a copy and k strided too), normalized and SSD, f32 and "
              f"bf16: output and final S, n, m within the stated "
              f"tolerances; max |err| of the output at the serve shapes in "
              f"bf16 {main:.3e}, largest over all cases {worst:.3e}; "
              f"inputs that need all three bf16 terms, err / limit "
              f"{cancel.get('P', 0):.4f} (P V) and {cancel.get('S', 0):.4f} "
              f"(q . S_prev); {SCAN_LONG} bf16: err / limit "
              f"{long['ratio']:.4f}, {long['extra_mb']:.1f} MB above the "
              f"inputs, the workspace {long['workspace_mb']:.1f} MB of it")
    return main


def bound(nbytes: int, flops: int, peak_flops: float = PEAK_F32_FLOPS,
          bf16_flops: int = 0) -> dict:
    """The least time for the work: bytes over the memory rate or
    operations over the rate for their type (``flops`` at ``peak_flops``,
    f32 outside the tensor cores unless given, plus ``bf16_flops`` at the
    bf16 tensor-core rate), whichever is larger."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = (flops / peak_flops + bf16_flops / PEAK_BF16_FLOPS) * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


TOPK_KINDS = ("normal", "ties", "padded", "equal", "nan")


def topk_case(S, C, kind, g):
    if kind == "ties":            # few distinct values: ties at every boundary
        return torch.randint(0, 5, (S, C), generator=g,
                             device="cuda").float() / 4
    if kind == "equal":           # one value: the equals straddle chunks
        return torch.full((S, C), 0.25, device="cuda")
    x = torch.randn(S, C, generator=g, device="cuda")
    if kind == "nan":             # NaN above +inf above the rest, and -inf
        x[:, ::7] = float("nan")
        x[:, 3::11] = float("inf")
        x[:, 5::13] = float("-inf")
    if kind == "padded":          # -inf padding, fewer finite entries than k
        x[:, C // 3:] = float("-inf")
        x[-1] = float("-inf")
        x[0, 1], x[0, 2] = -0.0, 0.0
    return x


def topk_equal(got, exp) -> bool:
    """Values bit for bit (NaN included) and lanes wherever the value is
    not a -inf padding slot."""
    kept = exp[0] != float("-inf")
    return (torch.equal(got[0].view(torch.int32), exp[0].view(torch.int32))
            and torch.equal(got[1][kept], exp[1][kept]))


def new_kernels_vs_plain() -> dict:
    """Both selection-plane kernels against their plain versions: exact.
    Returns max |err| at the fleet shapes (0.0 when exact)."""
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(3)
    n_topk = 0
    err = {}
    for S, C, ks, kinds in (
            # k = 2049: a short row merged from tiles, some all padding
            (8, SHARD_CAP, (1, 32, 2049, FLEET_K, SHARD_CAP), TOPK_KINDS),
            (3, 1000, (7,), TOPK_KINDS),
            # one row over many blocks, k in the first chunk and mid-row
            (1, 2**20 + 3, (FLEET_K, 2**19 + 1), ("normal", "equal", "nan"))):
        for kind in kinds:
            x = topk_case(S, C, kind, g)
            for k in ks:
                got = ops.segmented_topk(x, k)
                exp = ref.segmented_topk_ref(x, k)
                torch.cuda.synchronize()
                check(topk_equal(got, exp),
                      f"segmented_topk S={S} C={C} k={k} {kind}: values and "
                      f"lanes (but at -inf slots) equal the plain version")
                if (S, C, k, kind) == (8, SHARD_CAP, FLEET_K, "normal"):
                    err["segmented_topk"] = float(
                        (got[0] - exp[0]).abs().max())
                    again = ops.segmented_topk(x, k)
                    check(torch.equal(got[0], again[0])
                          and torch.equal(got[1], again[1]),
                          "segmented_topk repeats bit for bit")
                n_topk += 1
    n_mkp = 0
    for n in (1, 19, 3846, 100_003):
        for m in (1, CLASSES, 64):
            v = torch.rand(n, generator=g, device="cuda") * 9 + 1
            w = torch.randint(0, 30, (n, m), generator=g, device="cuda").float()
            r = 0.3 * w.sum(0) + torch.rand(m, generator=g, device="cuda")
            r[0] = 0.0
            sel = torch.rand(n, generator=g, device="cuda") < 0.7
            got = ops.mkp_utility(v, w, r, sel)
            exp = ref.mkp_utility_ref(v, w, r, sel)
            torch.cuda.synchronize()
            check(torch.equal(got, exp),
                  f"mkp_utility n={n} m={m} bit-equal to the plain version")
            if (n, m) == (3846, CLASSES):
                fin = torch.isfinite(exp)
                err["mkp_utility"] = float((got[fin] - exp[fin]).abs().max())
            n_mkp += 1
    n_greedy, clusters = greedy_vs_plain(g, err)
    phase(7, f"segmented_topk vs plain: {n_topk} cases (S x C in 8x131072 "
             f"with k in 1,32,2049,4096,131072 and 3x1000 with k=7; normal, "
             f"heavy ties, -inf padded with fewer finite than k, all equal, "
             f"NaN and +-inf; one row of 2^20+3 over many blocks with k in "
             f"4096,2^19+1, normal, all equal, NaN) equal in values and "
             f"lanes but at -inf slots, repeat bit-identical; mkp_utility "
             f"vs plain: {n_mkp} cases (n in 1,19,3846,100003; m in "
             f"1,10,64) bit-equal; mkp_greedy vs plain: {n_greedy} cases "
             f"(n from 1 to 100003 on the clusters greedy_blocks takes, "
             f"blocks {clusters}, rows past 8 blocks' shared memory from "
             f"50000 x 10; m in 1,5,7,10,17,64,300,2500; ties, all fit, none "
             f"fit, NaN and +inf utilities) bit-equal in mask and used, "
             f"repeat bit-identical")
    return err


# (n, m, picks, kind): clusters of 1, 2, 3, 5 and 8 blocks, as
# ``greedy_blocks`` picks them from n (a block per 512 items), stage 2's
# shape (8 blocks), m past the register columns (17), rows past 8 blocks'
# shared memory (50,000 x 10 and up: read from device memory each pick)
# and knapsack terms past shared memory (m = 2,500, 3 blocks)
GREEDY_CASES = [(1, 1, None, "random"), (1, 5, 3, "nofit"),
                (19, 10, None, "all"), (19, 10, None, "ties"),
                (200, 7, 30, "nan"), (200, 7, 30, "inf"),
                (200, 10, 250, "all"), (700, 10, 13, "random"),
                (1100, 10, 13, "ties"), (2500, 10, 13, "random"),
                (3846, 10, 13, "random"), (3846, 10, 13, "ties"),
                (3846, 17, 13, "random"), (15_000, 10, 13, "random"),
                (50_000, 10, 13, "random"), (100_003, 64, 13, "random"),
                (5000, 300, 13, "random"), (50, 2500, 5, "all")]
GREEDY_CLUSTERS = {1, 2, 3, 5, 8}


def greedy_instance(n, m, kind, g):
    """An MKP instance on the card: integer weights, capacities at 0.4 of
    the column sums; ``ties``: values the weights' sums and capacity 64
    for every knapsack (the first utilities tie exactly); ``all``: every
    item fits; ``nofit``: none does; ``nan`` / ``inf``: one fitting
    item's value is NaN / +inf."""
    w = torch.randint(0, 30, (n, m), generator=g, device="cuda").float()
    v = w.sum(1) + 5 * torch.rand(n, generator=g, device="cuda")
    cap = 0.4 * w.sum(0) + 1
    j = n // 3
    if kind == "ties":
        v, cap = w.sum(1), torch.full((m,), 64.0, device="cuda")
    elif kind == "all":
        cap = w.sum(0) + 1
    elif kind == "nofit":
        w += 1
        cap = torch.full((m,), 0.5, device="cuda")
    elif kind in ("nan", "inf"):
        w[j] = 1
        v[j] = float(kind)
    return v, w, cap


def greedy_vs_plain(g, err) -> tuple[int, list]:
    """``mkp_greedy`` against its plain version: mask and used bit-equal.
    Fills ``err["mkp_greedy"]`` at stage 2's shape and returns the count
    and the cluster each case took."""
    from repro_torch.kernels import mkp_utility as kmkp
    from repro_torch.kernels import ref
    clusters = []
    for n, m, picks, kind in GREEDY_CASES:
        v, w, cap = greedy_instance(n, m, kind, g)
        got = kmkp.mkp_greedy(v, w, cap, picks)
        exp = ref.mkp_greedy_ref(v, w, cap, picks)
        torch.cuda.synchronize()
        clusters.append(kmkp.greedy_blocks(n, m))
        what = (f"mkp_greedy n={n} m={m} picks={picks} {kind} "
                f"({clusters[-1]} blocks)")
        check(torch.equal(got[0], exp[0]) and torch.equal(
            got[1].view(torch.int32), exp[1].view(torch.int32)),
            f"{what}: mask and used bit-equal to the plain version")
        if kind in ("nan", "inf", "nofit"):
            check(not bool(got[0].any()), f"{what}: stops at the first pick")
        if (n, m, kind) == (3846, CLASSES, "random"):
            err["mkp_greedy"] = float((got[1] - exp[1]).abs().max())
            again = kmkp.mkp_greedy(v, w, cap, picks)
            check(torch.equal(got[0], again[0]) and torch.equal(
                got[1], again[1]), "mkp_greedy repeats bit for bit")
    check(GREEDY_CLUSTERS <= set(clusters),
          f"the cases reach clusters of {sorted(GREEDY_CLUSTERS)} blocks: "
          f"{sorted(set(clusters))}")
    return len(GREEDY_CASES), clusters


def fleet_pool():
    """The 1M-client pool of phase 8, with the inputs phase 6 times the
    new kernels on: its masked ratio over 8 shards, and the first MKP
    of stage 2 over task 0's flat picks (values, weights, capacities)."""
    from repro_torch.core import DevicePoolState, engine, scheduling
    from repro_torch.core.pool import ClientPoolState
    t0 = time.perf_counter()
    pool = ClientPoolState.random(FLEET_N, CLASSES, np.random.default_rng(0))
    build_s = time.perf_counter() - t0
    m = DevicePoolState.from_host(pool, shard_cap=SHARD_CAP)
    ratio = m.masked_ratio(m.valid_mask(FLEET_TH))
    rows = np.sort(engine._flat_pool_greedy(pool, FLEET_BUDGETS[0],
                                            FLEET_TH)[0])
    H = pool.histograms[rows]
    caps = scheduling.default_capacities_arrays(H, SUBSET_N)
    mkp_args = (torch.tensor(H.sum(1), dtype=torch.float32, device="cuda"),
                torch.tensor(H, dtype=torch.float32, device="cuda"),
                torch.tensor(caps, dtype=torch.float32, device="cuda"),
                torch.ones(rows.size, dtype=torch.bool, device="cuda"))
    return {"pool": pool, "build_s": build_s, "ratio": ratio,
            "mkp_args": mkp_args}


def churn(pool, seed: int) -> None:
    """CHURN_EVENTS dirty rows: half the clients leave (spread over the
    pool), half as many new ones join, as the reference's fleet record."""
    from repro_torch.core.criteria import NUM_CRITERIA, random_histograms
    half = CHURN_EVENTS // 2
    alive = pool.client_ids[pool.registered]
    pool.deregister(alive[:: max(1, alive.size // half)][:half])
    r = np.random.default_rng(seed)
    base = int(pool.client_ids.max()) + 1
    pool.register_arrays(np.arange(base, base + half),
                         r.random((half, NUM_CRITERIA)),
                         random_histograms(half, CLASSES, r),
                         r.uniform(1.0, 5.0, half))


def fleet_intake(fleet) -> tuple[int, tuple]:
    from repro_torch.core import FLServiceProvider, TaskRequest, engine
    from repro_torch.kernels import ops
    pool = fleet["pool"]
    sp = FLServiceProvider(pool)
    tasks = [TaskRequest(budget=b, n_star=SUBSET_N, thresholds=FLEET_TH,
                         subset_size=SUBSET_N, subset_delta=SUBSET_DELTA,
                         seed=i) for i, b in enumerate(FLEET_BUDGETS)]
    t0 = time.perf_counter()
    mirror = pool.device_mirror(shard_cap=SHARD_CAP)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    check(mirror.num_shards == 8 and mirror.device.type == "cuda",
          "mirror: 8 shards on the card")
    runs, hier = [], engine.hierarchical_greedy_knapsack
    parts = {"mask": 0.0, "frontier": 0.0}

    def timed(name, fn):
        """Time a mirror query; each ends in a copy to the host, so it
        also waits for the device work queued before it."""
        def wrapper(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            parts[name] += time.perf_counter() - t
            return out
        return wrapper

    def spy(*args, **kwargs):
        """Each task's stage 1: route, frontier, time, raw result."""
        st = {}
        t = time.perf_counter()
        out = hier(*args, stats=st, **kwargs)
        runs.append((time.perf_counter() - t, st, out))
        return out

    def sweep(label):
        runs.clear()
        parts.update(mask=0.0, frontier=0.0)
        res = sp.select_pools_batch(tasks)
        total = sum(dt for dt, _, _ in runs)
        split[label] = (f"{total * 1e3:.1f} ms = mask and shard counts "
                        f"{parts['mask'] * 1e3:.1f} + ratio, segmented_topk "
                        f"and frontier copy {parts['frontier'] * 1e3:.1f} + "
                        f"host merge {(total - sum(parts.values())) * 1e3:.1f}")
        check(len(runs) == len(tasks), f"{label}: one frontier greedy a task")
        flat[label] = []
        for task, r, (_, st, (rows, ts, tc, nv)) in zip(tasks, res, runs):
            t = time.perf_counter()
            frows, fts, ftc, fnv = engine._flat_pool_greedy(
                pool, task.budget, FLEET_TH)
            flat[label].append(time.perf_counter() - t)
            check(st["path"] == "frontier", f"{label}: routed through the "
                  f"frontier (path {st['path']})")
            check(np.array_equal(rows, frows) and (ts, tc, nv)
                  == (fts, ftc, fnv), f"{label}: budget {task.budget}: "
                  "rows and totals equal the flat host greedy")
            check(r.feasible and r.selected
                  == pool.client_ids[np.sort(frows)].tolist(),
                  f"{label}: select_pools_batch ids equal the flat picks")
        return res, [(dt, dict(st), out[0].size) for dt, st, out in runs]

    split, flat = {}, {}
    engine.hierarchical_greedy_knapsack = spy
    mirror.shard_stats = timed("mask", mirror.shard_stats)
    mirror.frontier = timed("frontier", mirror.frontier)
    ops.LAUNCHES["segmented_topk"] = 0
    torch.cuda.synchronize()
    try:
        res, before = sweep("before churn")
        ids0 = np.asarray(res[0].selected)          # task 0's pool, stage 2
        task0 = (ids0, pool.histograms[pool.positions(ids0)])
        churn(pool, seed=1)
        t0 = time.perf_counter()
        pool.device_mirror()
        torch.cuda.synchronize()
        sync_s = time.perf_counter() - t0
        check(mirror.syncs == 1 and mirror.restages == 1,
              "churn absorbed by one incremental sync")
        _, after = sweep("after churn")
        torch.cuda.synchronize()
    finally:
        engine.hierarchical_greedy_knapsack = hier
        del mirror.shard_stats, mirror.frontier
    launches = ops.LAUNCHES["segmented_topk"]
    frontiers = sum(st["escalations"] + 1 for _, st, _ in before + after)
    check(launches == frontiers > 0,
          f"segmented_topk launches {launches} == frontiers {frontiers}")
    per_task = "; ".join(
        f"B={t.budget:.1f}: {b[2]} picks, {b[0] * 1e3:.1f} ms (flat {fb * 1e3:.1f}"
        f"), F={b[1]['frontier']}, esc {b[1]['escalations']} / after churn "
        f"{a[0] * 1e3:.1f} ms (flat {fa * 1e3:.1f}), F={a[1]['frontier']}, "
        f"esc {a[1]['escalations']}"
        for t, b, a, fb, fa in zip(tasks, before, after, flat["before churn"],
                                   flat["after churn"]))
    phase(8, f"fleet intake: {FLEET_N} clients (pool built on the host in "
             f"{fleet['build_s']:.2f} s), {mirror.num_shards} shards of "
             f"{SHARD_CAP}; mirror staged in {stage_s * 1e3:.1f} ms; 4 tasks "
             f"through select_pools_batch, path frontier, picks equal the "
             f"flat greedy before and after {CHURN_EVENTS} churn events "
             f"(sync {sync_s * 1e3:.1f} ms); stage 1 per task, beside the "
             f"flat host greedy (threshold mask + greedy over the whole "
             f"pool) on the same task: {per_task}; "
             f"4 tasks before churn {split['before churn']}, after churn "
             f"{split['after churn']}; the flat host greedy for the 4 tasks "
             f"{sum(flat['before churn']) * 1e3:.1f} ms before churn, "
             f"{sum(flat['after churn']) * 1e3:.1f} ms after; "
             f"segmented_topk launches {launches}")
    return launches, task0


def stage2_on_card(arrays) -> dict:
    """``arrays``: task 0's pool as (ids, histograms). Stage 2 through
    ``generate_subsets(backend="device")``: one ``mkp_greedy`` launch for
    each MKP solve that reaches the device backend (above the exact
    solver's threshold), none of ``mkp_utility``. Returns both kernels'
    launches in that run and its walls."""
    from repro_torch.core import engine, fairness, scheduling
    from repro_torch.kernels import ops
    solve, solves = engine.solve_mkp_greedy_device, []

    def counted(*args, **kwargs):
        solves.append(kwargs.get("device"))
        return solve(*args, **kwargs)

    engine.solve_mkp_greedy_device = counted
    try:
        ops.LAUNCHES["mkp_greedy"] = ops.LAUNCHES["mkp_utility"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev = scheduling.generate_subsets(arrays, SUBSET_N, SUBSET_DELTA,
                                          backend="device")
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        greedy, util = ops.LAUNCHES["mkp_greedy"], ops.LAUNCHES["mkp_utility"]
        n_dev = len(solves)
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            scheduling.generate_subsets(arrays, SUBSET_N, SUBSET_DELTA,
                                        backend="device")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        engine.solve_mkp_greedy_device = solve
    t0 = time.perf_counter()
    cpu = scheduling.generate_subsets(arrays, SUBSET_N, SUBSET_DELTA,
                                      backend="device", device="cpu")
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scheduling.generate_subsets(arrays, SUBSET_N, SUBSET_DELTA)
    numpy_s = time.perf_counter() - t0
    check(dev.subsets == cpu.subsets and dev.counts == cpu.counts
          and np.array_equal(dev.nids, cpu.nids),
          "device schedule equals the CPU plain schedule")
    check(greedy == n_dev > 0, f"stage 2 launched mkp_greedy once a device "
          f"solve: {greedy} launches, {n_dev} solves")
    check(util == 0, f"stage 2 launched no mkp_utility ({util})")
    rep = fairness.fairness_report(dev, sorted(arrays[0].tolist()), x_star=3)
    check(rep["coverage"] and rep["bounded"],
          "the schedule covers the pool within x*")
    phase(9, f"stage 2 on the card: generate_subsets(n={SUBSET_N}, "
             f"delta={SUBSET_DELTA}, backend='device') over task 0's "
             f"{arrays[0].size} clients: {len(dev.subsets)} subsets in "
             f"{dev_s:.3f} s wall, then {walls[0]:.3f} and {walls[1]:.3f} s "
             f"(CPU plain version {cpu_s:.2f} s; the default numpy greedy + "
             f"local search {numpy_s:.2f} s), equal to the CPU schedule, "
             f"coverage and x* bound hold; {n_dev} MKP solves on the device "
             f"backend, mkp_greedy launches {greedy} (one a solve, "
             f"{dev_s / greedy * 1e6:.0f} us of wall a solve), mkp_utility "
             f"launches {util}")
    return {"mkp_greedy": greedy, "mkp_utility": util,
            "stage2_wall_s": [dev_s, *walls]}


def median_wall_ms(fn, reps: int = 7) -> float:
    """Median host wall time of ``fn`` after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return statistics.median(times) * 1e3


def intake_batch() -> None:
    """The batched stage-1 greedy at the intake's shape: the numpy
    backend (what ``"auto"``, and so ``select_pools_batch`` below
    ``HIERARCHICAL_MIN_N``, runs) against the f32 device backend, each
    timed end to end (host arrays in, masks out), on the pool's integer
    costs and on real-valued costs."""
    from repro_torch.core import engine
    from repro_torch.core.pool import ClientPoolState
    T, lines = INTAKE_BUDGETS.size, []
    for integer in (True, False):
        pool = ClientPoolState.random(INTAKE_N, CLASSES,
                                      np.random.default_rng(5),
                                      integer_cost=integer)
        valid = np.stack([pool.threshold_mask(th) for th in INTAKE_TH])
        args = (pool.overall, pool.costs, INTAKE_BUDGETS, valid)
        numpy_ms = median_wall_ms(
            lambda: engine.greedy_knapsack_batch(*args, backend="numpy"))
        device_ms = median_wall_ms(
            lambda: engine.greedy_knapsack_batch(*args, backend="device"))
        exp = engine.greedy_knapsack_batch(*args, backend="numpy")
        got = engine.greedy_knapsack_batch(*args, backend="device")
        auto = engine.greedy_knapsack_batch(*args)
        check(all(np.array_equal(a, b) for a, b in zip(auto, exp)),
              "auto runs the numpy batch on the card")
        picks = exp[0].sum(1)
        diff = (got[0] ^ exp[0]).sum(1)
        same = int((diff == 0).sum())
        kind = "integer" if integer else "real-valued"
        lines.append(
            f"{kind} costs: numpy {numpy_ms:.2f} ms, device {device_ms:.2f} "
            f"ms; picks {picks.min()}-{picks.max()} a task; device masks "
            f"equal numpy's in {same}/{T} tasks (clients in one mask only: "
            f"{diff.tolist()}; total score gap "
            f"{float(np.abs(got[1] - exp[1]).max()):.3g})")
        # Exact by construction on integer costs (f32 prefix sums are
        # exact); on real-valued costs f32 rounding could move a stop by
        # a client, and this seeded pool shows whether it does.
        check(same == T, f"on {kind} costs the device batch equals the "
              "numpy batch")
    phase(10, f"intake batch, {T} tasks over {INTAKE_N} clients (below "
              f"HIERARCHICAL_MIN_N), median wall of 7: " + " | ".join(lines))


def codec_case(K, P, kind, g):
    """Phase 11 inputs: unit normals; ``ties``: halves in -1.5..1.5, so
    many equal |x| of both signs and signed zeros; ``zeros``: the first
    half of every row zero (all-zero chunks, and all-zero rows where
    P is small) and row 0's last two values at +-amax (they saturate at
    +-127)."""
    if kind == "ties":
        x = torch.randint(-3, 4, (K, P), generator=g, device="cuda") / 2.0
        x[0, : min(P, 2)] = torch.tensor([-0.0, 0.0], device="cuda")[:P]
        return x
    if kind == "equal":           # one magnitude, both signs
        return (torch.randint(0, 2, (K, P), generator=g, device="cuda")
                - 0.5).float()
    x = torch.randn(K, P, generator=g, device="cuda")
    if kind == "nan":             # |NaN| above +-inf above the rest
        x[:, ::7] = float("nan")
        x[:, 3::11] = float("inf")
        x[:, 5::13] = float("-inf")
    if kind == "zeros":
        x[:, : max(1, P // 2)] = 0.0
        if P >= 4:
            amax = x[0].abs().max()
            x[0, -2], x[0, -1] = amax, -amax
    return x


# P of each alignment class of a row (P = 0, 2 and 1 or 3 mod 4, and
# P below every chunk), with the main path's two shapes
ALIGN_SHAPES = ((5, 7), (5, 100), (5, 4096), (5, 4098), (5, 4097),
                (MAIN_K, MAIN_TOPK), (MAIN_K, MAIN_P))
ALIGN_CHUNKS = (1, 100, 128, 256, 512)


def offset_view(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of t that starts ``offset`` elements into a fresh
    buffer, so its ``data_ptr`` is off the allocator's alignment."""
    buf = torch.empty(offset + t.numel(), dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def codec_at_offsets(x, chunk, what, same) -> int:
    """``quantize_i8`` of x at storage offsets of 0-3 f32 elements and
    ``dequantize_i8`` of its values at offsets of 0-15 bytes, each held to
    the plain version by ``same``. Returns the number of calls checked."""
    from repro_torch.kernels import ops, ref
    ev, es = ref.quantize_i8_ref(x, chunk)
    ed = ref.dequantize_i8_ref(ev, es, chunk)
    for off in range(4):
        v, s = ops.quantize_i8(offset_view(x, off), chunk)
        torch.cuda.synchronize()
        check(torch.equal(v, ev) and same(s, es),
              f"quantize_i8 {what}, x {4 * off} bytes off: values and "
              f"scales equal the plain version")
    for off in range(16):
        d = ops.dequantize_i8(offset_view(ev, off), es, chunk)
        torch.cuda.synchronize()
        check(same(d, ed), f"dequantize_i8 {what}, values {off} bytes "
                           f"off: equal to the plain version")
    return 20


def codec_kernels_vs_plain() -> dict:
    """The four codec kernels against their plain versions on the card:
    top-k, quantize and dequantize exact; the int8 aggregate within the
    f32 tolerance of phase 3. Returns max |err| at the main path's
    shapes."""
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(11)
    err, n = {}, {"topk": 0, "quant": 0}
    for K, P, ks in ((MAIN_K, MAIN_P, (1, MAIN_TOPK)),
                     (MAIN_K, MAIN_TOPK, (2677, MAIN_TOPK)),
                     (1, 7, (1, 3, 7)), (MAIN_K, 4097, (1, 4097)),
                     (3, 100_003, (777,))):
        for kind in ("normal", "ties", "zeros"):
            x = codec_case(K, P, kind, g)
            for k in ks:
                got, exp = ops.topk_sparsify(x, k), ref.topk_sparsify_ref(x, k)
                torch.cuda.synchronize()
                check(torch.equal(got[0], exp[0])
                      and torch.equal(got[1], exp[1]),
                      f"topk_sparsify K={K} P={P} k={k} {kind}: values and "
                      f"indices equal the plain version")
                n["topk"] += 1
            for chunk in (100, 128, 256, 512):
                v, s = ops.quantize_i8(x, chunk)
                ev, es = ref.quantize_i8_ref(x, chunk)
                d, ed = ops.dequantize_i8(v, s, chunk), \
                    ref.dequantize_i8_ref(ev, es, chunk)
                wt = torch.rand(K, generator=g, device="cuda")
                wt = wt / wt.sum()
                agg = ops.fedavg_agg_quality_i8(v, s, wt, chunk)
                eagg = ref.fedavg_agg_quality_i8_ref(ev, es, wt, chunk)
                torch.cuda.synchronize()
                what = f"K={K} P={P} chunk={chunk} {kind}"
                check(torch.equal(v, ev) and torch.equal(s, es),
                      f"quantize_i8 {what}: values and scales bit-equal")
                check(torch.equal(d, ed), f"dequantize_i8 {what}: bit-equal")
                torch.testing.assert_close(agg[0], eagg[0], rtol=1e-5,
                                           atol=1e-5)
                for a, b in zip(agg[1:], eagg[1:]):
                    torch.testing.assert_close(a, b, rtol=1e-5,
                                               atol=1e-6 * P ** 0.5)
                if kind == "zeros" and P >= 1024:
                    check(bool((s[:, 0] == 0).all()) and int(v[0, -2]) == 127
                          and int(v[0, -1]) == -127,
                          f"{what}: zero chunks keep scale 0, +-amax saturate")
                if (K, P, chunk, kind) == (MAIN_K, MAIN_P, CHUNK, "normal"):
                    err["fedavg_agg_quality_i8"] = max(
                        float((a - b).abs().max()) for a, b in zip(agg, eagg))
                    err["quantize_i8"] = float(
                        (s - es).abs().max()
                        + (v.int() - ev.int()).abs().max())
                if (K, P, chunk, kind) == (MAIN_K, MAIN_TOPK, CHUNK, "normal"):
                    err["dequantize_i8"] = float((d - ed).abs().max())
                n["quant"] += 1
    # top-k only: one row over many blocks, k = P at the main width, odd P
    # (rows off every vector boundary), a short row merged from tiles;
    # all-equal magnitudes and NaN
    for K, P, k in ((1, 2**20 + 3, 52_429), (MAIN_K, MAIN_P, MAIN_P),
                    (MAIN_K, 100_001, 5003), (1, 100_003, 3000)):
        for kind in ("normal", "ties", "equal", "nan"):
            x = codec_case(K, P, kind, g)
            got, exp = ops.topk_sparsify(x, k), ref.topk_sparsify_ref(x, k)
            torch.cuda.synchronize()
            check(torch.equal(got[0].view(torch.int32),
                              exp[0].view(torch.int32))
                  and torch.equal(got[1], exp[1]),
                  f"topk_sparsify K={K} P={P} k={k} {kind}: values (bit for "
                  f"bit) and indices equal the plain version")
            n["topk"] += 1
    n["aligned"] = 0
    for K, P in ALIGN_SHAPES:
        x = codec_case(K, P, "normal", g)
        for chunk in ALIGN_CHUNKS:
            n["aligned"] += codec_at_offsets(x, chunk, f"K={K} P={P} "
                                             f"chunk={chunk}", torch.equal)
    x = codec_case(MAIN_K, MAIN_P, "ties", g)
    first = ops.topk_sparsify(x, MAIN_TOPK)
    again = ops.topk_sparsify(x, MAIN_TOPK)
    check(torch.equal(first[0], again[0]) and torch.equal(first[1], again[1]),
          "topk_sparsify repeats bit for bit at the main shape, heavy ties")
    err["topk_sparsify"] = 0.0    # every case above was equal
    phase(11, f"codec kernels vs plain on the card: topk_sparsify {n['topk']} "
              f"cases (K x P in 13x{MAIN_P}, 13x{MAIN_TOPK}, 1x7, 13x4097, "
              f"3x100003; k from 1 to P; normal, heavy ties of both signs, "
              f"zero halves; and one row of 2^20+3 over many blocks, k = P "
              f"at 13x{MAIN_P}, 13x100001, 1x100003 with k=3000, each "
              f"normal, ties, all-equal "
              f"magnitudes and NaN and +-inf) equal in values and indices, "
              f"repeat bit-identical; quantize_i8 and "
              f"dequantize_i8 bit-equal, fedavg_agg_quality_i8 within rtol "
              f"1e-5, in {n['quant']} cases (chunks 100, 128, 256, 512; zero "
              f"chunks keep scale 0, +-amax saturate at +-127), and "
              f"bit-equal in {n['aligned']} calls on misaligned views (x "
              f"0-12 bytes and the int8 values 0-15 bytes off; K x P in "
              f"{', '.join(f'{k}x{p}' for k, p in ALIGN_SHAPES)}; chunks "
              f"{', '.join(map(str, ALIGN_CHUNKS))}); max |err| "
              f"of fedavg_agg_quality_i8 at 13x{MAIN_P}: "
              f"{err['fedavg_agg_quality_i8']:.3e}")
    return err


CODEC_KERNELS = ("topk_sparsify", "quantize_i8", "dequantize_i8",
                 "fedavg_agg_quality_i8", "fedavg_agg_quality")
CODEC_RUNS = (("int8", None, {"quantize_i8": 1, "fedavg_agg_quality_i8": 1}),
              ("topk:0.05+int8", "fedadam",
               {"topk_sparsify": 1, "quantize_i8": 1, "dequantize_i8": 1,
                "fedavg_agg_quality": 1}))


def compressed_loop(base_ms: float) -> dict:
    """Phase 12: the service loop through each codec at full CIFAR_CNN
    width, 16 rounds in chunks of 8 on 10,000 training samples. Returns
    the launches of each codec kernel, summed over the two runs."""
    from repro_torch.fl.simulation import SimConfig
    rounds, launches, lines = 16, dict.fromkeys(CODEC_KERNELS, 0), []
    for comp, opt, per_round in CODEC_RUNS:
        # FedAdam's step is about lr per coordinate: lr 0.01 (Reddi et al.)
        sim = SimConfig(server_lr=0.01) if opt else SimConfig()
        out, wall, loop_s, counts, arrived, *_ = service_loop(
            rounds=rounds, n_train=10_000, n_test=2_000, sim=sim,
            compression=comp, server_opt=opt, data_plane="device",
            round_chunk=8)
        hist = out["history"]
        trained = len(hist)
        losses = [h["loss"] for h in hist]
        check(trained == rounds == len(arrived),
              f"{comp}: {trained} rounds trained, asked {rounds}")
        for name in CODEC_KERNELS:
            want = per_round.get(name, 0) * trained
            check(counts[name] == want,
                  f"{comp}: {name} launches {counts[name]} == {want}")
            launches[name] += counts[name]
        wire = [h["bytes"] for h in hist]
        check(wire == [a * WIRE[comp] for a in arrived],
              f"{comp}: bytes per round == arrived x {WIRE[comp]}")
        check(all(np.isfinite(losses)), f"{comp}: finite losses")
        lines.append(
            f"{comp}{' + ' + opt if opt else ''}: {trained} rounds, loss "
            f"first {losses[0]:.4f} last {losses[-1]:.4f}, final accuracy "
            f"{out['final_accuracy']:.4f}; wall {wall:.2f} s, service loop "
            f"{loop_s:.2f} s = {loop_s / trained * 1e3:.1f} ms/round; "
            f"{sum(wire) / 1e6:.3f} MB up in {sum(arrived)} uploads of "
            f"{WIRE[comp]} B ({WIRE[None] / WIRE[comp]:.2f}x fewer than raw); "
            f"launches " + ", ".join(f"{k} {v}" for k, v in counts.items()
                                     if k in CODEC_KERNELS and v))
    phase(12, "compressed service loop, CIFAR_CNN (P = 1,070,794), 100 "
              "clients, subsets of 10 +- 3, n_train 10,000: "
              + " | ".join(lines)
              + f" | uncompressed (phase 5): {base_ms:.1f} ms/round")
    return launches


def none_is_uncompressed() -> None:
    """Phase 13: ``compression="none"`` gives the uncompressed chunk's
    params bit for bit (the uncompressed chunk run twice to show the card
    repeats, under the library's own cuDNN pin)."""
    from repro_torch.fl.round import make_fl_rounds_scan
    loss, dd, sched, params, key, kw = cifar_chunk()
    runs = [make_fl_rounds_scan(loss, compression=c, **kw)(
        params, dd, sched, key) for c in (None, None, "none")]
    torch.cuda.synchronize()
    (p0, i0), (p1, _), (p2, i2) = runs
    check(all(torch.equal(p0[n], p1[n]) for n in p0),
          "the uncompressed chunk repeats bit for bit")
    check(all(torch.equal(p0[n], p2[n]) for n in p0)
          and sorted(i0) == sorted(i2)
          and all(torch.equal(i0[k], i2[k]) for k in i0),
          'compression="none" equals compression=None bit for bit')
    S = sched["rows"].shape[0]
    phase(13, f'compression="none" vs None: one chunk (S={S}, '
              f"K={MAIN_K}, CIFAR_CNN) from the same params: params and "
              f"round metrics bit-identical, no bytes column")


def serve_kernels_vs_plain() -> tuple[dict, dict]:
    """Phase 14: the serve path's three kernels against their plain
    versions on the card, f32 and bf16, also at the shapes phases 29-32
    give them, where they are timed too (:func:`family_kernel_timing`).
    Returns max |err| at the serve shapes in bf16 (prefill's for rmsnorm
    and swiglu), and by kernel, by arch, the bf16 errors and times at
    the families' shapes."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import swiglu as kswiglu
    g = torch.Generator(device="cuda").manual_seed(14)
    rn = lambda shape, dtype, s=1.0: (torch.randn(
        shape, generator=g, device="cuda") * s).to(dtype)
    err, n = {}, dict.fromkeys(SERVE_TOL, 0)
    routes, held_routes = {}, {}

    def held(name, case, got, exp):
        rtol, atol = SERVE_TOL[name][exp.dtype]
        check(got.dtype == exp.dtype and got.shape == exp.shape,
              f"{name} {case}: dtype and shape")
        torch.testing.assert_close(got.float(), exp.float(), rtol=rtol,
                                   atol=atol, msg=lambda m: f"{name} {case}: {m}")
        err[name, case] = float((got.float() - exp.float()).abs().max())
        n[name] += 1

    M, D, Fd = SERVE_B * SERVE_PROMPT, SERVE_D, SERVE_F
    serve_attn = (SERVE_B, SERVE_H, SERVE_G, SERVE_PROMPT, SERVE_PROMPT,
                  SERVE_HD, True, 0)
    # Hymba-1.5B's prefill: 25 / 5 heads, a 1,024-token window, and its
    # D of 1,600 at prefill and at a decode step
    hymba_attn = (SSM_B, 25, 5, SSM_PROMPT, SSM_PROMPT, 64, True, 1024)
    hymba_norm = ((SSM_B * SSM_PROMPT, 1600), (SSM_B, 1, 1600))
    attn_cases = [serve_attn, hymba_attn, (1, 2, 2, 32, 32, 16, True, 0),
                  (2, 4, 2, 64, 64, 32, True, 0),
                  (1, 8, 1, 48, 48, 64, True, 0),
                  (1, 2, 1, 64, 64, 16, True, 8),
                  (1, 2, 1, 64, 64, 16, True, 16),
                  (2, 4, 2, 1, 128, 32, True, 0),
                  (1, 2, 2, 32, 32, 16, False, 0),
                  (1, 2, 2, 40, 40, 16, True, 0),
                  (1, 15, 5, 200, 333, 64, True, 100),
                  (1, 2, 1, 50, 50, 48, True, 0),
                  (1, 2, 2, 33, 65, 256, True, 0)]
    fam_attn = {a: (B, H, G, S, S, hd, True, 0)
                for a, (B, H, G, S, hd) in FAMILY_ATTN.items()}
    fam_norm = {a: ((B * S, D), (B, 1, D))
                for a, (B, S, D) in FAMILY_NORM.items()}
    fam_mlp = {a: ((B * S, D, F_), (B, D, F_))
               for a, (B, S, D, F_) in FAMILY_MLP.items()}
    attn_cases += list(fam_attn.values())
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((M, D), (SERVE_B, 1, D), *hymba_norm, (4, 50),
                      (3, 5, 128), (1, 1),
                      *(c for pair in fam_norm.values() for c in pair)):
            x, s = rn(shape, dtype, 3.0), rn(shape[-1:], dtype)
            got = ops.rmsnorm(x, s)
            held("rmsnorm", (shape, dtype), got, ref.rmsnorm_ref(x, s))
            check(torch.equal(got, ops.rmsnorm(x, s)),
                  f"rmsnorm {shape} {dtype}: a repeat is bit-equal")
        for m, d, f in SWIGLU_CASES + [c for pair in fam_mlp.values()
                                       for c in pair]:
            x = rn((m, d), dtype)
            wg, wu = rn((d, f), dtype, d ** -0.5), rn((d, f), dtype, d ** -0.5)
            exp = ref.swiglu_ref(x, wg, wu)
            got = ops.swiglu(x, wg, wu)
            held("swiglu", ((m, d, f), dtype), got, exp)
            check(torch.equal(got, ops.swiglu(x, wg, wu)),
                  f"swiglu {(m, d, f)} {dtype}: a repeat is bit-equal")
            kinds = kswiglu._routes(dtype, m, d, f, True)
            if dtype == torch.bfloat16:
                routes[m, d, f] = kinds[0]
            # every other kernel that takes the operands, below prefill size
            for kind in kinds[1:] if m <= 1024 else ():
                other = kswiglu.swiglu(x, wg, wu, kernel=kind)
                held("swiglu", ((m, d, f), dtype, kind), other, exp)
                check(torch.equal(other, kswiglu.swiglu(x, wg, wu, kernel=kind)),
                      f"swiglu {kind} {(m, d, f)}: a repeat is bit-equal")
                held_routes[kind] = held_routes.get(kind, 0) + 1
        for case in attn_cases:
            B, H, G, Sq, Sk, hd, causal, window = case
            q, k, v = (rn((B, S, h, hd), dtype) for S, h in
                       ((Sq, H), (Sk, G), (Sk, G)))
            held("flash_attention", (case, dtype),
                 ops.flash_attention_bshd(q, k, v, causal=causal,
                                          window=window),
                 ops.PLAIN.flash_attention_bshd(q, k, v, causal=causal,
                                                window=window))
    torch.cuda.synchronize()
    bf = torch.bfloat16
    want = {**{shape: "splitk" if name.endswith("decode") else "wgmma"
               for name, shape in SWIGLU_SHAPES.items()},
            (200, 962, 2560): "mma", (8, 964, 2560): "mma",
            # D past MAX_SPLITS * MAX_KC: decode takes wgmma too
            **{c: "wgmma" for pair in fam_mlp.values() for c in pair}}
    check(all(routes[shape] == kind for shape, kind in want.items()),
          f"swiglu routes {routes} take {want}")
    main = {"rmsnorm": err["rmsnorm", ((M, D), bf)],
            "swiglu": err["swiglu", ((M, D, Fd), bf)],
            "flash_attention": err["flash_attention", (serve_attn, bf)]}
    at_hymba = {"rmsnorm prefill": err["rmsnorm", (hymba_norm[0], bf)],
                "rmsnorm decode": err["rmsnorm", (hymba_norm[1], bf)],
                "flash_attention": err["flash_attention", (hymba_attn, bf)],
                "swiglu prefill": err["swiglu", (HYMBA_MLP, bf)],
                "swiglu decode": err["swiglu", (SWIGLU_SHAPES[
                    "Hymba-1.5B decode"], bf)]}
    decode_err = err["swiglu", ((SERVE_B, D, Fd), bf)]
    worst = {name: max(e for (k, _), e in err.items() if k == name)
             for name in SERVE_TOL}
    fam = family_kernel_timing()
    for arch, case in fam_attn.items():
        fam["flash_attention"][arch]["max_abs_err"] = \
            err["flash_attention", (case, bf)]
    for arch, (pre, dec) in fam_norm.items():
        fam["rmsnorm"][arch]["max_abs_err"] = err["rmsnorm", (pre, bf)]
        fam["rmsnorm"][arch]["at_decode"]["max_abs_err"] = \
            err["rmsnorm", (dec, bf)]
    for arch, (pre, dec) in fam_mlp.items():
        fam["swiglu"][arch]["max_abs_err"] = err["swiglu", (pre, bf)]
        fam["swiglu"][arch]["at_decode"]["max_abs_err"] = \
            err["swiglu", (dec, bf)]
    fam_text = "; ".join(
        f"{name} at {arch}'s {t['shape']}: |err| {t['max_abs_err']:.3e}, "
        f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
        + (f"{t['library']} {t['library_ms']:.4f} ms, "
           if t["library_ms"] is not None else "")
        + f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})"
        for name, by_arch in fam.items() for arch, t0 in by_arch.items()
        for t in (t0, *([t0["at_decode"]] if "at_decode" in t0 else [])))
    plans = "; ".join(
        f"{arch} {kind} ({m}, {D}) {norm_layout(m, D)}"
        for arch, (B, S, D) in FAMILY_NORM.items()
        for kind, m in (("prefill", B * S), ("decode", B)))
    phase(14, f"serve kernels vs plain on the card, f32 and bf16: rmsnorm "
              f"{n['rmsnorm']} cases (rows x D in {M}x{D}, {SERVE_B}x{D}, "
              f"{SSM_B * SSM_PROMPT}x1600, {SSM_B}x1600, 4x50, 15x128, 1x1 "
              f"and FAMILY_NORM's, every repeat bit-equal; layouts in bf16: "
              f"{plans}), "
              f"swiglu {n['swiglu']} (M, D, F in "
              f"{', '.join(map(str, SWIGLU_SHAPES.values()))} and ragged: "
              f"M off 128, D off 64, F off 128, D % 8 != 0; routes "
              + ", ".join(f"{s_} {k}" for s_, k in routes.items())
              + f"; below prefill size also every other kernel that takes "
              f"the operands: " + ", ".join(f"{k} {c}" for k, c in
                                          held_routes.items())
              + "; every call's repeat bit-equal), "
              f"flash_attention {n['flash_attention']} ((B, H, G, Sq, Sk, hd) "
              f"= {serve_attn[:6]} causal, Hymba-1.5B's {hymba_attn[:6]} "
              f"with window {hymba_attn[7]}, and the reference's sweep: MHA, GQA, "
              f"MQA, windows 8/16/100, Sq=1, non-causal, ragged S, hd 48 and "
              f"256), all within the stated tolerances; max |err| at the "
              f"serve shapes in bf16: "
              + ", ".join(f"{k} {v:.3e}" for k, v in main.items())
              + f" (swiglu at decode {decode_err:.3e}); at Hymba-1.5B's: "
              + ", ".join(f"{k} {v:.3e}" for k, v in at_hymba.items())
              + "; largest over all cases: "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
              + "; at the shapes phases 29-32 give them, bf16, timed as "
              "phase 6 times: " + fam_text)
    return main, fam


def family_kernel_timing() -> dict:
    """Rows 9-11 in bf16 at the shapes the MoE, vision-prefix and
    encoder-decoder serves give them (FAMILY_ATTN, FAMILY_NORM,
    FAMILY_MLP), timed as phase 6 times them (:func:`time_ms`) beside
    their plain versions, their bounds and the library's call where one
    computes the same function (``F.rms_norm``; SDPA, causal, GQA; none
    for SwiGLU: ``x @ w_gate`` alone and both products in one call stand
    beside it). Returns {kernel: {arch: record}}, a decode step's record
    under "at_decode"."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(29)
    rn = lambda *shape, s=1.0: (torch.randn(
        *shape, generator=g, device="cuda") * s).to(torch.bfloat16)
    out = {"flash_attention": {}, "rmsnorm": {}, "swiglu": {}}
    for arch, (B, H, G, S, hd) in FAMILY_ATTN.items():
        q, k, v = rn(B, S, H, hd), rn(B, S, G, hd), rn(B, S, G, hd)
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        pairs = S * (S + 1) // 2
        out["flash_attention"][arch] = {
            "shape": f"q ({B}, {H}, {S}, {hd}) G={G} causal",
            "ms": time_ms(lambda: ops.flash_attention_bshd(q, k, v)),
            "plain_ms": time_ms(lambda: ref.flash_attention_ref(qt, kt, vt)),
            "library": "SDPA causal GQA",
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
            **bound(2 * (2 * B * H * S * hd + 2 * B * G * S * hd),
                    4 * B * H * hd * pairs, PEAK_BF16_FLOPS)}
        del q, k, v, qt, kt, vt

    def mlp(m, d, f, wg, wu, w_gu):
        x = rn(m, d)
        return {"shape": f"M={m} D={d} F={f}",
                "ms": time_ms(lambda: ops.swiglu(x, wg, wu)),
                "plain_ms": time_ms(lambda: ref.swiglu_ref(x, wg, wu)),
                "library": None, "library_ms": None,
                "gate_product_ms": time_ms(lambda: x @ wg),
                "both_products_ms": time_ms(lambda: x @ w_gu),
                **bound(2 * (m * d + 2 * d * f + m * f), 4 * m * d * f,
                        PEAK_BF16_FLOPS)}

    out["rmsnorm"] = family_norm_timing()
    for arch, (B, S, D, F_) in FAMILY_MLP.items():
        wg, wu = rn(D, F_, s=D ** -0.5), rn(D, F_, s=D ** -0.5)
        w_gu = torch.cat([wg, wu], 1)
        out["swiglu"][arch] = {**mlp(B * S, D, F_, wg, wu, w_gu),
                               "at_decode": mlp(B, D, F_, wg, wu, w_gu)}
        del wg, wu, w_gu
    return out


def norm_layout(m: int, D: int) -> str | None:
    """The layout a bf16 ``rmsnorm`` call of (m, D) on 16-byte boundaries
    takes on this card (route, G warps a row, R vectors a lane, rows a
    block; no cluster: one block holds a row), or None for a tree whose
    wrapper has no plan."""
    from repro_torch.kernels import rmsnorm as krms
    if not hasattr(krms, "plan"):
        return None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    p = krms.plan(m, D, 2, True, sms)
    return f"{p.route} G={p.warps} R={p.vectors} rows={p.rows} no cluster"


def norm_timing(x, scale) -> dict:
    """``rmsnorm`` on bf16 x (m, D), timed as phase 6 times the serve
    kernels (:func:`time_ms`) beside its plain version, ``F.rms_norm``
    (the yardstick the port never calls) and its bound, with the layout
    the call takes (:func:`norm_layout`)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    m, D = x.shape
    return {"shape": f"({m}, {D})", "layout": norm_layout(m, D),
            "ms": time_ms(lambda: ops.rmsnorm(x, scale)),
            "plain_ms": time_ms(lambda: ref.rmsnorm_ref(x, scale)),
            "library": "F.rms_norm",
            "library_ms": time_ms(lambda: F.rms_norm(x, (D,), scale, 1e-6)),
            **bound(2 * (2 * m * D + D), 4 * m * D)}


def family_norm_timing() -> dict:
    """Row 9 in bf16 at FAMILY_NORM's prefill (B x S rows) and decode (B
    rows) shapes, by :func:`norm_timing`. Returns {arch: record}, the
    decode step's under "at_decode"."""
    g = torch.Generator(device="cuda").manual_seed(30)
    rn = lambda *shape: torch.randn(*shape, generator=g,
                                    device="cuda").to(torch.bfloat16)
    out = {}
    for arch, (B, S, D) in FAMILY_NORM.items():
        scale = rn(D)
        out[arch] = {**norm_timing(rn(B * S, D), scale),
                     "at_decode": norm_timing(rn(B, D), scale)}
    return out


@contextlib.contextmanager
def moe_routes(forced=None):
    """Within the block, every ``moe.routing`` call appends its expert
    indices to the list this yields; with ``forced`` (index tensors, one a
    call, in call order) each call takes its indices from it instead, and
    its gates, slots, drops and loss follow from them by ``moe.route`` on
    its own router probabilities."""
    from repro_torch.models import moe
    real, seen = moe.routing, []
    todo = None if forced is None else iter(forced)

    def routing(cfg, p, xt):
        r = (real(cfg, p, xt) if todo is None else
             moe.route(cfg, moe.router_probs(cfg, p, xt), next(todo)))
        seen.append(r.expert_idx)
        return r
    moe.routing = routing
    try:
        yield seen
    finally:
        moe.routing = real


def route_agreement(a, b) -> float:
    return float((a == b).float().mean())


class CastOnIndex:
    """A stacked (L, ...) tensor whose layer ``i`` comes out in f32."""

    def __init__(self, stacked: torch.Tensor):
        self.stacked = stacked

    def __getitem__(self, i):
        return self.stacked[i].float()


def f32_view(params, tree_map):
    """The model's params in f32 without an f32 copy of its stacked
    layers: each is cast as the stack indexes it (a list stack, which
    the stack does not index, is cast whole)."""
    f32 = lambda tree: tree_map(lambda a: a.float(), tree)
    lazy = lambda layers: (f32(layers) if isinstance(layers, list)
                           else tree_map(CastOnIndex, layers))
    out = {k: f32(v) for k, v in params.items()
           if k not in ("layers", "encoder")}
    out["layers"] = lazy(params["layers"])
    if "encoder" in params:
        out["encoder"] = {"layers": lazy(params["encoder"]["layers"]),
                          "final_norm": f32(params["encoder"]["final_norm"])}
    return out


def full_width_serve(phase_n: int, arch: str, B: int, prompt: int, want, *,
                     layers: int | None = None, cut: str = "") -> dict:
    """One model at its published width in bf16 through the kernels: a
    warm-up, then the main path (counts set to 0 just before it) of a
    B x ``prompt`` prefill and SERVE_NEW - 1 decode steps, greedy; then
    its prefill and SERVE_TF teacher-forced decode steps through the
    kernels (under the profiler) and through the plain versions on the
    same weights, and through the plain versions in f32. The prompts, and
    after them a VLM's patch embeddings or an encoder-decoder's frames
    (f32 normals), come from ``default_rng(0)``, as ``serve`` draws them;
    decode positions count the vision prefix and take the encoder's
    memory. ``layers`` cuts the depth (``cut`` says why). The f32 pass
    casts each stacked layer as the stack takes it (:func:`f32_view`),
    so the whole depth is checked even where an f32 copy of the model
    would not fit. ``want(L)`` gives the exact launch counts. Prints
    phase ``phase_n``'s line and returns the counts.

    MoE routing is discontinuous: a rounding of the kernel path moves a
    token's fourth-best expert past its fifth, that token's residual
    moves by the size of an expert's output, and the flips cascade from
    layer to layer. So for an MoE model the plain and f32 passes that the
    logits are held against take the kernel pass's expert choices
    (:func:`moe_routes`), and what the routing itself does is held
    separately: the share of first-layer routes on which the kernel and
    plain passes disagree may be at most twice the share on which the
    plain bf16 and f32 passes disagree. On the same routes, the random
    experts (scaled by E^-0.5, the reference's ``dense_init``) still
    amplify a rounding layer by layer, so the 5 % bound applies to an
    MoE model only where its bf16 path stays within 5 % of f32."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import common
    from repro_torch.models import transformer as T
    gc.collect()
    torch.cuda.empty_cache()
    over = {"use_kernels": True, **({"num_layers": layers} if layers else {})}
    cfg = dataclasses.replace(get_config(arch), **over)
    check(cfg.dtype == "bfloat16", f"{arch} in bf16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    nbytes = lambda tree: sum(a.numel() * a.element_size()
                              for a in T._leaves(tree))
    model_gb = nbytes(params) / 1e9
    layer_gb = nbytes(params["layers"]) / cfg.num_layers / 1e9
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, prompt)),
                              dtype=torch.int32, device="cuda")
    stub = lambda: torch.as_tensor(rng.normal(size=(
        B, cfg.frontend_seq, cfg.frontend_dim)), dtype=torch.float32,
        device="cuda")
    extras = {}
    if cfg.family == "vlm" and cfg.frontend_seq:
        extras["patch_embeds"] = stub()
    if cfg.is_enc_dec:
        extras["frames"] = stub()
    start = prompt + (cfg.frontend_seq if cfg.family == "vlm" else 0)

    def generate(new):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache, memory = T.prefill(cfg, params, prompts, extras)
        cache = T.grow_cache(cfg, cache, new)
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        t_pre, t = time.perf_counter() - t, time.perf_counter()
        toks = [tok]
        for step in range(new - 1):
            logits, cache = T.decode_step(cfg, params, tok, cache,
                                          start + step, memory=memory)
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            toks.append(tok)
        torch.cuda.synchronize()
        return torch.cat(toks, 1), t_pre, time.perf_counter() - t

    generate(2)                  # warm-up, before the counts are set to 0
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tokens, t_pre, t_dec = generate(SERVE_NEW)
    counts = dict(ops.LAUNCHES)
    want = want(cfg.num_layers)
    check({n: c for n, c in counts.items() if c} == want,
          f"{arch} serve launches {counts} == {want}")
    check(tokens.shape == (B, SERVE_NEW) and int(tokens.min()) >= 0
          and int(tokens.max()) < cfg.vocab_size, "generated token ids")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    def teacher(kernels, c=cfg, p=params, profiles=None):
        """Prefill and SERVE_TF decode steps fed the generated tokens;
        with ``profiles`` (a list), each half runs under the profiler."""
        run = device_profile if profiles is not None else \
            (lambda fn: (fn(), None))
        (logits, cache, memory), prof = run(
            lambda: T.prefill(c, p, prompts, extras, kernels=kernels))
        cache = T.grow_cache(c, cache, SERVE_TF)
        outs = [logits.float()]

        def decode():
            nonlocal logits, cache
            for step in range(SERVE_TF):
                logits, cache = T.decode_step(c, p, tokens[:, step:step + 1],
                                              cache, start + step,
                                              memory=memory, kernels=kernels)
                outs.append(logits.float())
        _, prof2 = run(decode)
        if profiles is not None:
            profiles += [prof, prof2]
        return torch.cat(outs, 1)             # (B, 1 + SERVE_TF, vocab)

    profiles = []
    L = cfg.num_layers
    with moe_routes() as r_kern:
        kern = teacher(None, profiles=profiles)
    with moe_routes() as r_plain:
        plain = teacher(ops.PLAIN)
    check(bool(torch.isfinite(kern).all() and torch.isfinite(plain).all()),
          f"{arch}: finite logits")
    # the f32 pass: each stacked layer cast to f32 as the stack takes it
    # (an f32 copy of the whole of the larger models does not fit)
    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = f32_view(params, T.tree_map)
    routes = r_kern if cfg.is_moe else None
    if cfg.is_moe:
        free_agree = float((kern.argmax(-1) == plain.argmax(-1)).float()
                           .mean())
        free_d = float((kern - plain).abs().max())
        with moe_routes() as r_f32:      # the f32 pass on its own routes
            teacher(ops.PLAIN, c32, p32)
        with moe_routes(routes):         # the plain pass on the kernel's
            plain = teacher(ops.PLAIN)
    with moe_routes(routes):
        f32 = teacher(ops.PLAIN, c32, p32)
    del p32
    torch.cuda.synchronize()
    d_kp = (kern - plain).abs().amax(dim=(0, 2))        # per position
    d_pf = (plain - f32).abs().amax(dim=(0, 2))
    top = float(plain.abs().max())
    agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    # Kernel and plain version round bf16 at different places; their gap
    # is held to twice the plain bf16 path's own gap from f32 on the same
    # weights, and to 5 % of the largest |logit|, the latter for an MoE
    # model only where the bf16 path itself stays within 5 % of f32.
    check(float(d_kp.max()) <= 2 * float(d_pf.max()),
          f"{arch} kernel vs plain {float(d_kp.max())} <= 2 x bf16-vs-f32 "
          f"{float(d_pf.max())}")
    five = not cfg.is_moe or float(d_pf.max()) <= 0.05 * top
    check(not five or float(d_kp.max()) <= 0.05 * top,
          f"{arch} kernel vs plain {float(d_kp.max())} <= 5 % of max "
          f"|logit| {top}")
    held = "within both" if five else (
        "within the first; the 5 % bound is not applied: plain bf16 itself "
        f"is {float(d_pf.max()) / top:.1%} of max |logit| off f32")
    moe_text = ""
    if cfg.is_moe:
        miss_kp = 1 - route_agreement(r_kern[0], r_plain[0])
        miss_pf = 1 - route_agreement(r_plain[0], r_f32[0])
        check(miss_kp <= 2 * miss_pf,
              f"{arch} first-layer routes: kernel vs plain disagree on "
              f"{miss_kp:.4%} <= 2 x plain bf16 vs f32 {miss_pf:.4%}")
        last = route_agreement(r_kern[L - 1], r_plain[L - 1])
        moe_text = (f"; MoE routes of the prefill, the kernel and plain "
                    f"passes each on its own: {1 - miss_kp:.2%} equal in "
                    f"layer 1 (plain bf16 vs f32: {1 - miss_pf:.2%}, held "
                    f"to half the disagreement), {last:.2%} in layer {L} "
                    f"(the flips cascade), so their logits differ by up "
                    f"to {free_d:.3f} and their argmax agrees at "
                    f"{free_agree * 100:.1f} % of positions; the plain and "
                    f"f32 logits above take the kernel pass's routes")
    steps = SERVE_NEW - 1
    (pre_dev, pre_n, pre_top, pre_ours), (dec_dev, dec_n, dec_top, _) = \
        profiles
    dec_dev /= SERVE_TF
    busy = ("not measured (the profiler saw no device time)" if not dec_dev
            else f"{dec_dev / (t_dec / steps * 1e3) * 100:.1f} %")
    inputs = f"batch {B} x prompt {prompt}"
    if "patch_embeds" in extras:
        inputs += f" after {cfg.frontend_seq} f32 patch embeddings (dim " \
            f"{cfg.frontend_dim}), decode positions from {start}"
    if "frames" in extras:
        inputs += f", {cfg.frontend_seq} f32 frames (dim " \
            f"{cfg.frontend_dim}) through the {cfg.encoder_layers}-layer " \
            f"encoder"
    phase(phase_n, f"full-width serve: {cfg.name}{cut} "
              f"({common.count_params(params)} params, {model_gb:.2f} GB, "
              f"bf16, random weights from seed 0 drawn in {init_s:.2f} s, "
              f"init peak {init_peak_gb:.2f} GB = the model + "
              f"{init_peak_gb - model_gb:.2f} GB, one layer "
              f"{layer_gb:.3f} GB), {inputs} + {SERVE_NEW} new tokens, "
              f"use_kernels=True: prefill "
              f"{t_pre * 1e3:.1f} ms ({B * prompt / t_pre:.0f} prompt "
              f"tok/s), decode {t_dec / steps * 1e3:.2f} ms a step of {B} "
              f"tokens over {steps} steps ({B * steps / t_dec:.1f} tok/s), "
              f"peak memory {peak_gb:.2f} GB; launches "
              + ", ".join(f"{n} {c}" for n, c in counts.items() if c)
              + f" (as expected); kernels vs kernels=ops.PLAIN on the same "
              f"weights, prefill and {SERVE_TF} teacher-forced steps: max "
              f"|dlogit| prefill {float(d_kp[0]):.4f}, decode "
              f"{float(d_kp[1:].max()):.4f} (plain bf16 vs plain f32: "
              f"{float(d_pf[0]):.4f} / {float(d_pf[1:].max()):.4f}; max "
              f"|logit| {top:.3f}), held to 2 x bf16-vs-f32 and 5 % of max "
              f"|logit|: {held}; argmax agrees at "
              f"{agree * 100:.1f} % of positions{moe_text}; "
              f"torch.profiler device time, kernel path: prefill "
              f"{pre_dev:.2f} ms in {pre_n} kernels (top: {pre_top}; the "
              f"port's own: {pre_ours}), decode "
              f"{dec_dev:.3f} ms a step in {dec_n / SERVE_TF:.0f} kernels a "
              f"step (top: {dec_top}), so the device is busy {busy} of a "
              f"decode step's wall")
    return counts


def serve_full_width() -> dict:
    """Phase 15: SmolLM-360M at its published width, 8 x 1,024 prompt
    tokens (see :func:`full_width_serve`). Returns the launch counts."""
    from repro_torch.configs import get_config
    cfg = get_config(SERVE_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.num_heads,
           cfg.num_kv_heads) == (32, SERVE_D, SERVE_F, SERVE_H, SERVE_G),
          "SmolLM-360M at its published width")
    return full_width_serve(
        15, SERVE_ARCH, SERVE_B, SERVE_PROMPT,
        lambda L: {"flash_attention": L, "swiglu": L * SERVE_NEW,
                   "rmsnorm": (2 * L + 1) * SERVE_NEW})


def ssm_full_width() -> dict:
    """Phases 22 and 23: xLSTM-125M and Hymba-1.5B at their published
    widths, SSM_B x SSM_PROMPT prompt tokens each (see
    :func:`full_width_serve`). xLSTM launches ``mlstm_scan`` once per
    mLSTM layer in prefill and ``rmsnorm`` for ``final_norm`` only (its
    blocks' norms are the model's own, as in the reference); Hymba
    launches ``mlstm_scan`` and ``flash_attention`` once a layer in
    prefill and ``swiglu`` and ``rmsnorm`` on every pass. Returns the
    launch counts by arch."""
    from repro_torch.configs import get_config
    x, hy = get_config("xlstm-125m"), get_config("hymba-1.5b")
    check((x.num_layers, x.d_model, x.num_heads, x.ssm_expand,
           x.vocab_size, x.chunk_size, x.layer_types.count("slstm"))
          == (12, 768, 4, 2, 50_304, 256, 2),
          "xLSTM-125M at its published width")
    check((hy.num_layers, hy.d_model, hy.num_heads, hy.num_kv_heads,
           hy.resolved_head_dim, hy.sliding_window, hy.d_ff, hy.ssm_state,
           hy.chunk_size) == (32, 1600, 25, 5, 64, 1024, 5504, 16, 256),
          "Hymba-1.5B at its published width")
    mlstm = x.layer_types.count("mlstm")
    return {
        "xlstm-125m": full_width_serve(
            22, "xlstm-125m", SSM_B, SSM_PROMPT,
            lambda L: {"mlstm_scan": mlstm, "rmsnorm": SERVE_NEW}),
        "hymba-1.5b": full_width_serve(
            23, "hymba-1.5b", SSM_B, SSM_PROMPT,
            lambda L: {"mlstm_scan": L, "flash_attention": L,
                       "swiglu": L * SERVE_NEW,
                       "rmsnorm": (2 * L + 1) * SERVE_NEW})}


def family_full_width() -> dict:
    """Phases 29-32: the MoE, vision-prefix and encoder-decoder families at
    their published widths (see :func:`full_width_serve`), each freed
    before the next. MoE layers launch no ``swiglu`` (the reference's
    ``moe_ffn`` takes none), Whisper no ``rmsnorm`` or ``swiglu``
    (LayerNorm, GELU), and its encoder and cross-attention are plain.
    Returns the launch counts by arch."""
    from repro_torch.configs import get_config
    width = {a: get_config(a) for a in FAMILY_SERVES}
    q, l4 = width["qwen2-moe-a2.7b"], width["llama4-scout-17b-a16e"]
    vl, wh = width["internvl2-26b"], width["whisper-large-v3"]
    check((q.num_layers, q.d_model, q.num_heads, q.resolved_head_dim,
           q.num_experts, q.top_k, q.num_shared_experts, q.moe_d_ff,
           q.vocab_size) == (24, 2048, 16, 128, 60, 4, 4, 1408, 151_936),
          "Qwen1.5-MoE-A2.7B at its published width")
    check((l4.num_layers, l4.d_model, l4.num_heads, l4.num_kv_heads,
           l4.num_experts, l4.top_k, l4.num_shared_experts, l4.moe_d_ff,
           l4.vocab_size) == (48, 5120, 40, 8, 16, 1, 1, 8192, 202_048),
          "Llama-4-Scout at its published width")
    check((vl.num_layers, vl.d_model, vl.num_heads, vl.num_kv_heads,
           vl.d_ff, vl.frontend_seq, vl.frontend_dim)
          == (48, 6144, 48, 8, 16_384, 256, 1024),
          "InternVL2-26B at its published width")
    check((wh.num_layers, wh.encoder_layers, wh.d_model, wh.num_heads,
           wh.resolved_head_dim, wh.frontend_seq, wh.frontend_dim)
          == (32, 32, 1280, 20, 64, 1500, 128),
          "Whisper-large-v3 at its published width")
    want = {"qwen2-moe-a2.7b": lambda L: {
                "flash_attention": L, "rmsnorm": (2 * L + 1) * SERVE_NEW},
            "llama4-scout-17b-a16e": lambda L: {
                "flash_attention": L, "rmsnorm": (2 * L + 1) * SERVE_NEW},
            "internvl2-26b": lambda L: {
                "flash_attention": L, "swiglu": L * SERVE_NEW,
                "rmsnorm": (2 * L + 1) * SERVE_NEW},
            "whisper-large-v3": lambda L: {"flash_attention": L}}
    out = {}
    for arch, run in FAMILY_SERVES.items():
        cut = ""
        if run.get("layers"):
            cut = (f", the first {run['layers']} of its "
                   f"{width[arch].num_layers} layers (all of them are "
                   f"about 108 B params, 216 GB in bf16, past one 80 GB "
                   f"card)")
        out[arch] = full_width_serve(
            run["phase"], arch, run["B"], run["prompt"], want[arch],
            layers=run.get("layers"), cut=cut)
    return out


# The names of the serve path's hand-written kernels, as the profiler
# reports them
SERVE_KERNEL_NAMES = re.compile(r"(fa_|rmsnorm|swiglu|mlstm_scan)")


def device_profile(fn):
    """Run ``fn`` under ``torch.profiler`` (:func:`kernel_times`).
    Returns its result and (device ms summed over the kernels, the
    number of kernel launches, the five kernels with the most device
    time as text, the serve path's own kernels as text)."""
    out, times = kernel_times(fn)
    text = lambda items: ", ".join(f"{name[:48]} x{n} {ms:.2f} ms"
                                   for name, (ms, n) in items)
    top = text(list(times.items())[:5])
    ours = text((name, t) for name, t in times.items()
                if SERVE_KERNEL_NAMES.match(name))
    return out, (sum(ms for ms, _ in times.values()),
                 sum(n for _, n in times.values()), top, ours)


def serve_entry_point() -> None:
    """Phase 16: ``serve("smollm-360m")`` at its defaults on the card."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = serve("smollm-360m", verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: c for n, c in ops.LAUNCHES.items() if c}
    check(out.shape == (4, 16) and out.device.type == "cuda",
          "serve() returns (4, 16) tokens on the card")
    check(counts == {"flash_attention": 2, "swiglu": 32, "rmsnorm": 80},
          f"serve() launches {counts}")
    phase(16, f'serve("smollm-360m") defaults (reduced: 2 layers, d 256, '
              f"4 x 32 prompt, 16 tokens) on the card in {wall:.2f} s; "
              f"launches " + ", ".join(f"{n} {c}" for n, c in counts.items())
              + f"; first row {out[0, :8].tolist()}")


def ssm_serve_entry_points() -> None:
    """Phase 24: ``serve("xlstm-125m")`` and ``serve("hymba-1.5b")`` at
    their defaults (reduced: two layers, d 256, 4 x 32 prompt, 16 tokens)
    on the card, each with the counts set to 0 just before it."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    want = {"xlstm-125m": {"mlstm_scan": 2, "rmsnorm": 16},
            "hymba-1.5b": {"mlstm_scan": 2, "flash_attention": 2,
                           "swiglu": 32, "rmsnorm": 80}}
    parts = []
    for arch, expect in want.items():
        for name in ops.LAUNCHES:
            ops.LAUNCHES[name] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve(arch, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: c for n, c in ops.LAUNCHES.items() if c}
        check(out.shape == (4, 16) and out.device.type == "cuda",
              f"serve({arch!r}) returns (4, 16) tokens on the card")
        check(counts == expect, f"serve({arch!r}) launches {counts}")
        parts.append(f"{arch} {wall:.2f} s, launches "
                     + ", ".join(f"{n} {c}" for n, c in counts.items())
                     + f", first row {out[0, :8].tolist()}")
    phase(24, "serve() defaults on the card (reduced: 2 layers, d 256, 4 x "
              "32 prompt, 16 tokens): " + "; ".join(parts))


def family_serve_entry_points() -> None:
    """Phase 33: ``serve()`` at its defaults (reduced: two layers, d 256,
    4 x 32 prompt, 16 tokens, f32) on the card for the MoE, vision-prefix
    and encoder-decoder families, each with the counts set to 0 just
    before it."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    dense = {"flash_attention": 2, "rmsnorm": 80}
    want = {"qwen2-moe-a2.7b": dense, "llama4-scout-17b-a16e": dense,
            "internvl2-26b": {**dense, "swiglu": 32},
            "whisper-large-v3": {"flash_attention": 2}}
    parts = []
    for arch, expect in want.items():
        for name in ops.LAUNCHES:
            ops.LAUNCHES[name] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve(arch, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: c for n, c in ops.LAUNCHES.items() if c}
        check(out.shape == (4, 16) and out.device.type == "cuda",
              f"serve({arch!r}) returns (4, 16) tokens on the card")
        check(counts == expect, f"serve({arch!r}) launches {counts}")
        parts.append(f"{arch} {wall:.2f} s, launches "
                     + ", ".join(f"{n} {c}" for n, c in counts.items())
                     + f", first row {out[0, :8].tolist()}")
    phase(33, "serve() defaults on the card (reduced: 2 layers, d 256, 4 x "
              "32 prompt, 16 tokens; InternVL2 with 16 patch embeddings, "
              "Whisper with 16 frames): " + "; ".join(parts))


def agg_kernel_vs_plain() -> float:
    """Phase 17: ``fedavg_agg`` against its plain version, f32 and bf16.
    Returns max |err| at the fused kernel's shape in f32."""
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(17)
    main_err, n = None, 0
    Ks, Ps = (1, 3, MAIN_K, 64, 100), (1, 10, 255, 256, 257, 16_385,
                                       1_048_576, MAIN_P)
    for dtype in (torch.float32, torch.bfloat16):
        for K in Ks:
            for P in Ps:
                u = torch.randn(K, P, generator=g, device="cuda").to(dtype)
                w = torch.rand(K, generator=g, device="cuda")
                w = w / w.sum()
                got = ops.fedavg_agg(u, w)
                exp = ref.fedavg_agg_ref(u, w)
                torch.cuda.synchronize()
                check(got.dtype == dtype and got.shape == (P,),
                      f"fedavg_agg K={K} P={P} {dtype}: dtype and shape")
                rtol, atol = TOL[dtype]
                torch.testing.assert_close(got.float(), exp.float(),
                                           rtol=rtol, atol=atol)
                if dtype == torch.float32 and (K, P) == (MAIN_K, MAIN_P):
                    main_err = float((got - exp).abs().max())
                    check(torch.equal(got, ops.fedavg_agg(u, w)),
                          "fedavg_agg repeats bit for bit")
                n += 1
    # one launch over many leaves, bit-equal to one launch a leaf: the
    # CIFAR_CNN leaves at K = 13, and 40 leaves (two tables) at K = 2,100
    # (weights staged a tile at a time)
    from repro_torch.kernels import fedavg_agg as kagg
    from repro_torch.models import cnn
    trees = []
    for dtype in (torch.float32, torch.bfloat16):
        trees.append(({name: torch.randn((MAIN_K,) + shape, generator=g,
                                         device="cuda").to(dtype)
                       for name, shape in cnn.param_shapes(cnn.CIFAR_CNN).items()},
                      torch.rand(MAIN_K, generator=g, device="cuda"), 1))
    trees.append(({f"l{i}": torch.randn(2100, 1 + 37 * i, generator=g,
                                        device="cuda") for i in range(40)},
                  torch.rand(2100, generator=g, device="cuda"), 2))
    for tree, w, tables in trees:
        before = ops.LAUNCHES["fedavg_agg"]
        got = ops.fedavg_agg_tree(tree, w)
        check(ops.LAUNCHES["fedavg_agg"] - before == tables,
              f"fedavg_agg_tree over {len(tree)} leaves: {tables} launches")
        per_leaf = kagg.fedavg_agg_tree(tree, w, agg=kagg.fedavg_agg)
        torch.cuda.synchronize()
        check(all(torch.equal(got[k], per_leaf[k]) for k in tree),
              f"fedavg_agg_tree over {len(tree)} leaves bit-equal to one "
              f"launch a leaf")
    phase(17, f"fedavg_agg vs plain: {n} cases (K in {Ks}; P in {Ps}; f32 "
              f"and bf16) within f32 rtol 1e-5 / bf16 rtol 2^-7 (one bf16 "
              f"ulp); max |err| at K={MAIN_K} P={MAIN_P} f32: "
              f"{main_err:.3e}; repeat bit-identical; one launch over the 8 "
              f"CIFAR_CNN leaves (f32 and bf16) and two over 40 leaves at "
              f"K=2100 bit-equal to one launch a leaf")
    return main_err


def host_plane(base_ms: float) -> int:
    """Phase 18: the host-loop plane at CIFAR_CNN width through its entry
    point, then the rounds that launch ``fedavg_agg`` on the same data at
    K = 13, each held against ``kernels=ops.PLAIN``. Returns the kernel's
    launches."""
    from repro_torch import random as trandom
    from repro_torch.core import fairness
    from repro_torch.fl import device_data
    from repro_torch.fl.round import make_fl_round, make_fl_rounds_scan
    from repro_torch.fl.simulation import FLClassificationSim, SimConfig
    from repro_torch.kernels import fedavg_agg as kagg
    from repro_torch.kernels import ops
    from repro_torch.models import cnn
    rounds = 24
    out, wall, loop_s, counts, _, trainer, _ = service_loop(
        rounds=rounds, n_train=50_000, n_test=10_000)
    check(isinstance(trainer, FLClassificationSim),
          "run_fl_experiment's default plane is the host loop")
    hist, state = out["history"], out["state"]
    losses = [h["loss"] for h in hist]
    check(len(hist) == rounds, f"{len(hist)} host rounds trained, asked "
          f"{rounds}")
    check(all(np.isfinite(losses)), "host plane: finite losses")
    check(0.0 <= out["final_accuracy"] <= 1.0, "accuracy in [0, 1]")
    check(not any(counts.values()), "the host plane's default round (the "
          f"reference's: plain aggregate) launches no kernel: {counts}")
    rep = fairness.fairness_report(state.schedules[0], sorted(state.pool),
                                   x_star=3)
    check(rep["coverage"] and rep["bounded"],
          "host plane: first period's schedule covers the pool within x*")
    host_ms = loop_s / rounds * 1e3

    # the same data, 8 rounds at K = 13 through the kernel and the plain
    sim = SimConfig(eval_every=10 ** 9)          # no eval inside rounds 1-8
    host = FLClassificationSim(cnn.CIFAR_CNN, trainer.data, trainer.parts,
                               trainer.test, sim, device="cuda")
    p0 = host.params
    rng = np.random.default_rng(18)
    S = 8
    subsets = [sorted(rng.choice(100, MAIN_K, replace=False).tolist())
               for _ in range(S)]
    weights = [x / x.sum() for x in rng.random((S, MAIN_K))]
    loss = lambda p, b: cnn.loss_fn(cnn.CIFAR_CNN, p, b)
    kw = dict(local_lr=sim.local_lr, local_steps=sim.local_steps,
              server_lr=sim.server_lr, use_agg_kernel=True)

    def host_rounds(kernels):
        host.params = p0
        host.round_fn = make_fl_round(loss, kernels=kernels, **kw)
        res = host.run_rounds(1, subsets, weights)
        torch.cuda.synchronize()
        return host.params, np.stack([q for _, q, _ in res])

    dd = device_data.DeviceDataset.stage(trainer.data, trainer.parts, "cuda")
    sched = {"rows": torch.as_tensor(np.array(subsets), device="cuda"),
             "weights": torch.as_tensor(np.array(weights, np.float32),
                                        device="cuda"),
             "active": torch.ones(S, MAIN_K, device="cuda"),
             "round_ids": torch.arange(1, S + 1, device="cuda")}
    skw = dict(local_lr=sim.local_lr, local_steps=sim.local_steps,
               batch_size=sim.batch_size, server_lr=sim.server_lr,
               dropout_rate=sim.dropout_rate, fused_quality=False,
               use_agg_kernel=True)

    def scan_rounds(kernels):
        p, info = make_fl_rounds_scan(loss, kernels=kernels, **skw)(
            p0, dd, sched, trandom.prng_key(sim.seed, "cuda"))
        torch.cuda.synchronize()
        return p, info["q_values"].cpu().numpy()

    # the aggregate one launch a leaf (the single-matrix entry), as before
    # the leaves kernel: the one-launch rounds must equal it bit for bit
    per_leaf = types.SimpleNamespace(**{n: getattr(ops, n) for n in ops.__all__})
    per_leaf.fedavg_agg_tree = functools.partial(kagg.fedavg_agg_tree,
                                                 agg=ops.fedavg_agg)
    launches, gaps = {}, {}
    for name, drive in (("make_fl_round", host_rounds),
                        ("make_fl_rounds_scan", scan_rounds)):
        for n in ops.LAUNCHES:
            ops.LAUNCHES[n] = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        pk, qk = drive(ops)
        dt = time.perf_counter() - t
        launches[name] = {n: c for n, c in ops.LAUNCHES.items() if c}
        check(launches[name] == {"fedavg_agg": S},
              f"{name}(use_agg_kernel=True): launches {launches[name]} == "
              f"one a round over {S} rounds")
        pl, ql = drive(per_leaf)
        check(all(torch.equal(pk[n], pl[n]) for n in pk)
              and np.array_equal(qk, ql),
              f"{name}: one launch a round bit-equal to one a leaf")
        pp, qp = drive(ops.PLAIN)
        check(all(bool(torch.isfinite(v).all()) for v in pk.values()),
              f"{name}: finite params")
        dp = max(float((pk[n] - pp[n]).abs().max()) for n in pk)
        dq = float(np.abs(qk - qp).max())
        check(dp <= 1e-4, f"{name}: params kernel vs plain {dp} <= 1e-4")
        check(dq <= 1e-3, f"{name}: q kernel vs plain {dq} <= 1e-3")
        gaps[name] = (dp, dq, dt / S * 1e3, pk)
    dhs = max(float((gaps["make_fl_round"][3][n]
                     - gaps["make_fl_rounds_scan"][3][n]).abs().max())
              for n in p0)
    phase(18, f"host-loop plane (run_fl_experiment's default), CIFAR_CNN, "
              f"pool {len(state.pool)}, {rounds} rounds at n_train 50,000: "
              f"loss first {losses[0]:.4f} last {losses[-1]:.4f}, final "
              f"accuracy {out['final_accuracy']:.4f}; wall {wall:.2f} s, "
              f"service loop {loop_s:.2f} s = {host_ms:.1f} ms/round (device "
              f"plane, phase 5: {base_ms:.1f}); no kernel launched (the "
              f"reference's host round aggregates plainly) | on the same "
              f"data, {S} rounds at K={MAIN_K} with use_agg_kernel=True: "
              + "; ".join(f"{k}: fedavg_agg launches "
                          f"{launches[k].get('fedavg_agg', 0)} (one a round; "
                          f"params and q bit-equal to one launch a leaf), "
                          f"{g_[2]:.1f} ms/round, kernel vs plain max |dparams| "
                          f"{g_[0]:.3e} (tol 1e-4), max |dq| {g_[1]:.3e} (tol "
                          f"1e-3)" for k, g_ in gaps.items())
              + f"; host-assembled vs device-gathered rounds max |dparams| "
                f"{dhs:.3e}")
    return sum(c.get("fedavg_agg", 0) for c in launches.values())


def fault_plane() -> None:
    """Phase 19: the reference's bench_faults plan on both planes, 16
    rounds each at CIFAR_CNN width."""
    from repro_torch.core import FaultPlan
    lines = []
    for plane in ("host", "device"):
        out, wall, loop_s, _, _, _, rounds = service_loop(
            rounds=16, n_train=10_000, n_test=2_000, data_plane=plane,
            fault_plan=FaultPlan(**FAULT_PLAN), **FAULT_TASK)
        events = out["state"].rounds
        check(len(events) == len(rounds) == 16,
              f"{plane}: 16 rounds committed and trained, got "
              f"{len(events)} / {len(rounds)}")
        late = 0
        for ev, (arrival, returned, q) in zip(events, rounds):
            m = ev.metrics
            check("round_latency" in m, f"{plane}: round_latency reported")
            base = m["n_scheduled"] // 2             # over-scheduled x2
            quorum = max(1, int(np.ceil(FAULT_TASK["quorum_frac"] * base)))
            check(m["n_arrived"] >= quorum,
                  f"{plane}: round {m['round']} met its quorum")
            a = np.asarray(arrival, dtype=bool)
            check(not np.asarray(returned)[~a].any()
                  and (np.asarray(q)[~a] == 0).all(),
                  f"{plane}: a client that missed the close has b_t = 0, q = 0")
            check(int(a.sum()) == m["n_arrived"], f"{plane}: arrivals")
            late += int((~a).sum())
        check(late > 0, f"{plane}: some client missed a close")
        lat = [ev.metrics["round_latency"] for ev in events]
        lines.append(f"{plane}: {len(events)} rounds, {late} late or failed "
                     f"client slots, round_latency {min(lat):.3f}-"
                     f"{max(lat):.3f}, loss last "
                     f"{out['history'][-1]['loss']:.4f}, service loop "
                     f"{loop_s / len(events) * 1e3:.1f} ms/round")
    phase(19, f"fault plane, FaultPlan({FAULT_PLAN}) with {FAULT_TASK}, "
              f"n_train 10,000: every round met its quorum, and the trainer "
              f"returned b_t = 0 and q = 0 for every client that missed the "
              f"close | " + " | ".join(lines))


def library_settings() -> tuple[float, float]:
    """Phase 20: what a caller gets with no flag set: each plane twice
    and with ``FaultPlan()`` from one seed, bit for bit; then a chunk
    timed with the library's cuDNN pin and with PyTorch's defaults in its
    place. Returns (pinned, unpinned) ms per round."""
    from repro_torch.core import FaultPlan
    import repro_torch.fl.round as fl_round
    flags = lambda: (torch.backends.cudnn.allow_tf32,
                     torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark)
    before = flags()
    for plane in ("device", "host"):
        runs = []
        for plan in (None, None, FaultPlan()):
            out, *_, trainer, _ = service_loop(
                rounds=8, n_train=10_000, n_test=2_000, data_plane=plane,
                fault_plan=plan)
            runs.append((trainer.params, out["history"], out["final_accuracy"],
                         [e.metrics for e in out["state"].rounds]))
        same = lambda a, b: (all(torch.equal(a[0][n], b[0][n]) for n in a[0])
                             and a[1:] == b[1:])
        check(same(runs[0], runs[1]),
              f"{plane}: two runs from one seed give bit-equal params and "
              f"history")
        check(same(runs[0], runs[2]),
              f"{plane}: FaultPlan() gives the no-plan run bit for bit")
        check(all("round_latency" not in m for m in runs[2][3]),
              f"{plane}: the inactive plan takes the no-fault path")
    check(flags() == before, f"caller's cuDNN flags untouched: {flags()}")

    loss, dd, sched, params, key, kw = cifar_chunk()
    S = sched["rows"].shape[0]
    fn = fl_round.make_fl_rounds_scan(loss, **kw)
    pin = fl_round.conv_numerics

    def run(pinned: bool) -> float:
        fl_round.conv_numerics = pin if pinned else contextlib.nullcontext
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(params, dd, sched, key)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) / S * 1e3
        finally:
            fl_round.conv_numerics = pin

    run(True), run(False)                        # warm-up
    times = {True: [], False: []}
    for order in ((True, False), (False, True)) * 3:
        for pinned in order:
            times[pinned].append(run(pinned))
    pinned_ms = statistics.median(times[True])
    default_ms = statistics.median(times[False])
    with pin():
        inside = (torch.backends.cudnn.allow_tf32,
                  getattr(getattr(torch.backends.cudnn, "conv", None),
                          "fp32_precision", "n/a"))
    # the pin's effect on a conv of conv2's shape: its error from an f64
    # conv, pinned (full f32) and at PyTorch's defaults (TF32 allowed)
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(20)
    x = torch.randn(64, 32, 16, 16, generator=g, device="cuda")
    wt = torch.randn(64, 32, 3, 3, generator=g, device="cuda")
    exact = F.conv2d(x.double(), wt.double(), padding=1)
    with pin():
        err_pin = float((F.conv2d(x, wt, padding=1) - exact).abs().max())
    err_default = float((F.conv2d(x, wt, padding=1) - exact).abs().max())
    top = float(exact.abs().max())
    check(err_pin <= 1e-5 * top, f"pinned conv is full f32: max |err| "
          f"{err_pin} <= 1e-5 x max |out| {top}")
    phase(20, f"library settings, no flag set by the caller (cudnn "
              f"allow_tf32, deterministic, benchmark = {before}, unchanged "
              f"after): device and host planes, 8 rounds at n_train 10,000, "
              f"run twice and with FaultPlan() from seed 0: params, history "
              f"and final accuracy bit-equal; inside the pin cudnn "
              f"allow_tf32 {inside[0]}, conv fp32_precision {inside[1]!r}; "
              f"a (64, 32, 16, 16) x 3x3x32x64 conv against f64: max |err| "
              f"pinned {err_pin:.3e}, at the defaults {err_default:.3e} "
              f"(max |out| {top:.1f}); "
              f"a device-plane chunk (S={S}, K={MAIN_K}, CIFAR_CNN), median "
              f"of 6 alternated: pinned (full f32, deterministic) "
              f"{pinned_ms:.2f} ms/round, PyTorch's defaults (TF32, free "
              f"algorithms) {default_ms:.2f} ms/round")
    return pinned_ms, default_ms


def non_finite_case(K, P, chunk, kind, g):
    """Phase 25 inputs: unit normals with a NaN in every third chunk
    (``nan``), or +inf in every third chunk and -inf in the next
    (``inf``); the other chunks stay finite."""
    x = torch.randn(K, P, generator=g, device="cuda")
    nc = -(-P // chunk)
    c = torch.arange(0, nc, 3, device="cuda")
    x[:, (c * chunk + 5).clamp(max=P - 1)] = float(kind)
    if kind == "inf":
        c = c[c + 1 < nc]
        x[:, ((c + 1) * chunk + 9).clamp(max=P - 1)] = float("-inf")
    return x


def nan_equal(a, b) -> bool:
    """Equal, NaN compared as NaN."""
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(torch.where(a.isnan(), 0, a),
                            torch.where(b.isnan(), 0, b)))


def codec_non_finite() -> int:
    """Phase 25: the int8 codec kernels on chunks holding NaN or +-inf,
    against their plain versions (the JAX package's semantics). Returns
    the number of cases."""
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(25)
    n = 0
    for K, P in ((MAIN_K, MAIN_P), (3, 100_003)):
        for kind in ("nan", "inf"):
            for chunk in (100, 128, 256, 512):
                x = non_finite_case(K, P, chunk, kind, g)
                v, s = ops.quantize_i8(x, chunk)
                ev, es = ref.quantize_i8_ref(x, chunk)
                d, ed = ops.dequantize_i8(v, s, chunk), \
                    ref.dequantize_i8_ref(ev, es, chunk)
                wt = torch.rand(K, generator=g, device="cuda")
                wt = wt / wt.sum()
                agg = ops.fedavg_agg_quality_i8(v, s, wt, chunk)
                eagg = ref.fedavg_agg_quality_i8_ref(ev, es, wt, chunk)
                torch.cuda.synchronize()
                what = f"K={K} P={P} chunk={chunk} {kind}"
                check(torch.equal(v, ev) and nan_equal(s, es),
                      f"quantize_i8 {what}: values and scales equal the "
                      f"plain version, NaN as NaN")
                bad = ~torch.isfinite(s)
                want = float("nan") if kind == "nan" else float("inf")
                check(bool(bad.any()) and bool(torch.isfinite(s).any())
                      and nan_equal(s[bad], torch.full_like(s[bad], want)),
                      f"quantize_i8 {what}: the bad chunks' scales are "
                      f"{want}, the others finite")
                cols = torch.arange(P, device="cuda") // chunk
                check(not bool(v[bad[:, cols]].any()),
                      f"quantize_i8 {what}: a bad chunk's values are 0")
                check(nan_equal(d, ed), f"dequantize_i8 {what}: equal, NaN "
                                        f"as NaN")
                for a, b in zip(agg, eagg):
                    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5,
                                               equal_nan=True)
                n += 1
    aligned = 0
    for K, P in ALIGN_SHAPES:
        for kind in ("nan", "inf"):
            for chunk in ALIGN_CHUNKS:
                x = non_finite_case(K, P, chunk, kind, g)
                aligned += codec_at_offsets(
                    x, chunk, f"K={K} P={P} chunk={chunk} {kind}", nan_equal)
    phase(25, f"int8 codec kernels on non-finite chunks vs plain on the "
              f"card: {n} cases (K x P in 13x{MAIN_P} and 3x100003; chunks "
              f"100, 128, 256, 512; NaN in every third chunk, or +inf and "
              f"-inf in two of every three): quantize_i8 values and scales "
              f"equal (NaN as NaN; NaN chunks scale NaN, +-inf chunks scale "
              f"inf, values 0), dequantize_i8 equal, fedavg_agg_quality_i8 "
              f"within rtol 1e-5 with NaN where the plain version has it; "
              f"quantize_i8 and dequantize_i8 equal, NaN as NaN, in "
              f"{aligned} calls on misaligned views (x 0-12 bytes and the "
              f"int8 values 0-15 bytes off) over phase 11's shapes and "
              f"chunks, each with NaN or +-inf chunks")
    return n


def cifar_lifecycle(comp, opt, data, test, parts):
    """A provider, a device-plane trainer and the task of phase 12's
    compressed run, built as ``run_fl_experiment`` builds them; eval only
    at round 0, so no eval draw differs between a run and its resume."""
    from repro_torch.core import FLServiceProvider, TaskRequest
    from repro_torch.fl.simulation import (DeviceFLSim, SimConfig,
                                           pool_from_partition)
    from repro_torch.models import cnn
    sim = SimConfig(server_lr=0.01, eval_every=10_000)
    pool = pool_from_partition(data.labels, parts, data.num_classes, seed=0)
    trainer = DeviceFLSim(cnn.CIFAR_CNN, data, parts, test, sim,
                          pad_subset_to=SUBSET_N + SUBSET_DELTA,
                          compression=comp, server_opt=opt, device="cuda")
    task = TaskRequest(budget=1e9, n_star=100, subset_size=SUBSET_N,
                       subset_delta=SUBSET_DELTA, x_star=3,
                       max_periods=10_000, scheduler="mkp", seed=0,
                       round_chunk=8, max_rounds=16, compression=comp)
    return FLServiceProvider(pool), trainer, task


def event_key(e):
    return (e.period, e.round_index, list(e.subset), e.weights.tolist(),
            e.nid, e.metrics)


def resumed_run(make, stop_after: int, tmp: str):
    """``make()`` -> (provider, trainer, task). Steps a fresh task until
    ``stop_after`` rounds are committed, saves it with the trainer's
    server state, loads it into a fresh provider and trainer, and drains
    it. Returns (events, final state, resumed trainer, launches of the
    whole run, checkpoint bytes)."""
    import os
    from repro_torch.core import lifecycle
    from repro_torch.kernels import ops
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    provider, trainer, task = make()
    state, events = lifecycle.submit(provider, task), []
    while len(events) < stop_after:
        state, ev = lifecycle.step(provider, state, trainer)
        events += ev
    check(len(events) == stop_after, f"the run stops after round "
          f"{stop_after}: a chunk ends there ({len(events)} committed)")
    path = os.path.join(tmp, "task_state.ckpt")
    events += lifecycle.save_state(path, state, flush=True, trainer=trainer)
    size = os.path.getsize(path)
    del provider, trainer, state
    provider, trainer, _ = make()
    state = lifecycle.load_state(path)
    check(lifecycle.restore_trainer_state(state, trainer),
          "the checkpoint carries the trainer's server state")
    state, ev = lifecycle.drain(provider, state, trainer)
    torch.cuda.synchronize()
    return events + ev, state, trainer, dict(ops.LAUNCHES), size


def compressed_resume() -> dict:
    """Phase 26. Returns the launches of the resumed run by kernel."""
    import tempfile
    from repro_torch.core import lifecycle
    from repro_torch.data.synthetic import make_classification_data
    from repro_torch.fl.partition import partition_labels
    from repro_torch.kernels import ops
    comp, opt, rounds, cut = "topk:0.05+int8", "fedadam", 16, 8
    full = make_classification_data("cifar", 12_000, seed=0)
    data, test = full.subset(np.arange(10_000)), \
        full.subset(np.arange(10_000, 12_000))
    parts = partition_labels(data.labels, 100, "type2", data.num_classes,
                             seed=0)
    make = lambda: cifar_lifecycle(comp, opt, data, test, parts)
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    provider, trainer, task = make()
    t = time.perf_counter()
    state, ref_events = lifecycle.drain(provider,
                                        lifecycle.submit(provider, task),
                                        trainer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    whole = dict(ops.LAUNCHES)
    with tempfile.TemporaryDirectory() as tmp:
        events, rstate, rtrainer, counts, size = resumed_run(make, cut, tmp)
    check(len(ref_events) == len(events) == rounds,
          f"{rounds} rounds each way: {len(ref_events)} / {len(events)}")
    check([event_key(e) for e in events]
          == [event_key(e) for e in ref_events],
          "resumed events (period, round, subset, weights, nid, loss, "
          "bytes) equal the uninterrupted run's")
    check(lifecycle.as_run_result(rstate).reputation
          == lifecycle.as_run_result(state).reputation,
          "resumed reputation equals the uninterrupted run's")
    want, got = trainer.export_state(), rtrainer.export_state()
    check(sorted(want) == sorted(got)
          and all(np.array_equal(want[k], got[k]) for k in want),
          "resumed params and FedAdam moments equal the uninterrupted "
          "run's bit for bit")
    rows = ("fedavg_agg_quality", "topk_sparsify", "quantize_i8",
            "dequantize_i8", "fedavg_agg_quality_i8")
    for name in rows:
        want = rounds if name != "fedavg_agg_quality_i8" else 0
        check(whole[name] == counts[name] == want,
              f"{name}: {whole[name]} / {counts[name]} launches == {want}")
    phase(26, f"period-checkpoint resume, CIFAR_CNN device plane, {comp} + "
              f"{opt}, 100 clients, subsets of 10 +- 3, n_train 10,000: "
              f"{rounds} rounds uninterrupted ({wall:.2f} s) and saved after "
              f"round {cut} ({size} B with the trainer's "
              f"{len(rstate.trainer_state)} arrays), resumed in a fresh "
              f"provider and trainer: events, reputation, params and "
              f"FedAdam moments bit-equal; launches (uninterrupted / saved + "
              f"resumed) " + ", ".join(f"{n} {whole[n]} / {counts[n]}"
                                       for n in rows))
    return counts


# The federated LM task at SmolLM-360M's full width and depth: clients,
# subset size, sequence length, batch, local steps, rounds, training and
# test sequences. 40 clients (20 sequences each): stage 2 schedules 20
# clients in subsets of 10 as [10, 10, 9], three rounds a period, so four
# rounds in one chunk need the larger pool, whose periods are [10] x 5.
LM_CLIENTS, LM_SUBSET, LM_SEQ, LM_BATCH, LM_STEPS = 40, 10, 128, 4, 2
LM_ROUNDS, LM_CUT, LM_TRAIN, LM_TEST = 4, 2, 800, 40


def lm_lifecycle(data, test, parts, round_chunk):
    """A provider, the full-width LoRA trainer and its task."""
    from repro_torch.configs import smollm_360m
    from repro_torch.core import FLServiceProvider, TaskRequest
    from repro_torch.fl.simulation import SimConfig, pool_from_partition
    from repro_torch.fl.transformer_task import TransformerFLSim
    sim = SimConfig(batch_size=LM_BATCH, local_steps=LM_STEPS, local_lr=5.0,
                    server_lr=1.0, dropout_rate=0.0, eval_every=10_000,
                    seed=0)
    pool = pool_from_partition(data.labels, parts, data.num_classes, seed=0)
    trainer = TransformerFLSim(smollm_360m.config(), data, parts, test, sim,
                               device="cuda")
    task = TaskRequest(budget=1e9, n_star=LM_CLIENTS, subset_size=LM_SUBSET,
                       subset_delta=0, x_star=3, max_periods=10_000, seed=0,
                       round_chunk=round_chunk, max_rounds=LM_ROUNDS)
    return FLServiceProvider(pool), trainer, task


def lm_full_width() -> dict:
    """Phase 27. Returns the launches of the uninterrupted run."""
    import tempfile
    from repro_torch.core import lifecycle
    from repro_torch.data.synthetic import LMData, make_lm_data
    from repro_torch.fl.partition import partition_labels
    from repro_torch.kernels import ops
    from repro_torch.models import common
    vocab = 49_152
    full = make_lm_data(LM_TRAIN + LM_TEST, LM_SEQ, vocab, seed=0)
    data = LMData(full.tokens[:LM_TRAIN], full.labels[:LM_TRAIN],
                  full.num_classes, vocab)
    test = LMData(full.tokens[LM_TRAIN:], full.labels[LM_TRAIN:],
                  full.num_classes, vocab)
    parts = partition_labels(data.labels, LM_CLIENTS, "type2",
                             data.num_classes, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    provider, trainer, task = lm_lifecycle(data, test, parts, LM_ROUNDS)
    cfg = trainer.cfg
    n_base = common.count_params(trainer.base_params)
    n_ad = sum(v.numel() for v in trainer.params.values())
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.d_ff, cfg.vocab_size, cfg.dtype)
          == (32, 960, 15, 5, 2560, vocab, "bfloat16"),
          f"SmolLM-360M at full width and depth, bf16: {cfg}")
    check(n_ad == 860_160, f"LoRA adapters: {n_ad} parameters")
    state = lifecycle.submit(provider, task)
    state, _ = lifecycle.step(provider, state, trainer)   # -> SCHEDULED
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, ref_events = lifecycle.step(provider, state, trainer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    check(len(ref_events) == LM_ROUNDS,
          f"{LM_ROUNDS} rounds in one chunk, got {len(ref_events)}")
    check([len(e.subset) for e in ref_events] == [LM_SUBSET] * LM_ROUNDS,
          f"subsets of {LM_SUBSET}: {[len(e.subset) for e in ref_events]}")
    state, more = lifecycle.drain(provider, state, trainer)
    check(not more, "the task ends at its round budget")
    launches = dict(ops.LAUNCHES)
    check(launches["fedavg_agg_quality"] == LM_ROUNDS,
          f"fedavg_agg_quality launches {launches['fedavg_agg_quality']} == "
          f"{LM_ROUNDS}, one a round")
    losses = [e.metrics["loss"] for e in ref_events]
    check(all(np.isfinite(losses)), f"finite losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    acc = trainer.evaluate()
    with tempfile.TemporaryDirectory() as tmp:
        events, rstate, rtrainer, counts, size = resumed_run(
            lambda: lm_lifecycle(data, test, parts, LM_CUT), LM_CUT, tmp)
    check([event_key(e) for e in events]
          == [event_key(e) for e in ref_events],
          "resumed LM events (period, round, subset, weights, nid, loss) "
          "equal the uninterrupted run's")
    check(all(torch.equal(trainer.params[n], rtrainer.params[n])
              for n in trainer.params),
          "resumed adapters equal the uninterrupted run's bit for bit")
    check(counts["fedavg_agg_quality"] == LM_ROUNDS,
          "one fedavg_agg_quality launch a round in the resumed run")
    # one more round of the uninterrupted trainer under the profiler
    members = list(state.pool)[:LM_SUBSET]
    _, (dev_ms, n_kern, top, _) = device_profile(
        lambda: trainer.run_rounds(LM_ROUNDS, [members],
                                   [np.full(LM_SUBSET, 1 / LM_SUBSET,
                                            np.float32)]))
    del trainer, rtrainer
    torch.cuda.empty_cache()
    phase(27, f"federated LoRA LM task, SmolLM-360M at full width and depth "
              f"({n_base} backbone params, bf16, random weights from seed "
              f"0; {n_ad} f32 adapter params, rank 4 on attn/wq, attn/wv, "
              f"mlp/w_up), {LM_CLIENTS} clients, subsets of {LM_SUBSET}, "
              f"sequences of {LM_SEQ}, batch {LM_BATCH}, {LM_STEPS} local "
              f"steps: {LM_ROUNDS} rounds in one chunk {wall:.2f} s = "
              f"{wall / LM_ROUNDS * 1e3:.0f} ms/round, loss {losses[0]:.4f} "
              f"-> {losses[-1]:.4f}, next-token accuracy {acc:.4f}, peak "
              f"device memory {peak:.2f} GiB; fedavg_agg_quality launches "
              f"{launches['fedavg_agg_quality']} (U = {LM_SUBSET} x {n_ad} "
              f"f32); resumed after round {LM_CUT} from {size} B in chunks "
              f"of {LM_CUT}: events and adapters bit-equal, launches "
              f"{counts['fedavg_agg_quality']}; one more round under the "
              f"profiler: {dev_ms:.1f} ms of device time in {n_kern} "
              f"kernels; top: {top}")
    return launches


def examples_on_card() -> None:
    """Phase 28: the port's examples as a user runs them, on the card."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    lines = []
    for name, args in (("quickstart_torch.py", []),
                       ("train_noniid_torch.py",
                        ["--clients", "20", "--rounds", "10",
                         "--data-plane", "device"]),
                       ("fl_service_demo_torch.py", []),
                       ("serve_decode_torch.py", [])):
        t = time.perf_counter()
        out = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                              *args], cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=300)
        check(out.returncode == 0, f"examples/{name} {' '.join(args)} exit "
              f"{out.returncode}: {out.stdout[-1500:]} {out.stderr[-3000:]}")
        last = out.stdout.strip().splitlines()[-1]
        lines.append(f"{name} {' '.join(args)} ({time.perf_counter() - t:.1f}"
                     f" s): {last[:160]}")
    phase(28, "examples on the card, each exit 0 | " + " | ".join(lines))


# The sharded device plane (phase 34): phase 5's configuration, dropout
# off in all three runs (mesh mode does not simulate it).
SHARD_ROUNDS, SHARD_CHUNK = 24, 8
# FedSGD at SmolLM-360M's full width and depth (phase 36): clients,
# batch rows, sequence length, steps, microbatches of the accumulation
# check. Gradients accumulated over 4 microbatches against the full
# batch's, both from bf16 weights: each leaf's L2 gap within 2^-4 of its
# norm (8 bf16 ulps at 2^-7: the two passes round the same activations
# and products in bf16 in other groupings).
FEDSGD_CLIENTS, FEDSGD_B, FEDSGD_SEQ, FEDSGD_STEPS, FEDSGD_M = 24, 8, 1024, 8, 4
FEDSGD_GRAD_TOL = 2.0 ** -4


def cifar_setting(n_train: int, n_test: int):
    """CIFAR data, its 100-client ``type2`` partition and client pool,
    as ``run_fl_experiment`` builds them from seed 0."""
    from repro_torch.data.synthetic import make_classification_data
    from repro_torch.fl.partition import partition_labels
    from repro_torch.fl.simulation import pool_from_partition
    full = make_classification_data("cifar", n_train + n_test, seed=0)
    data = full.subset(np.arange(n_train))
    test = full.subset(np.arange(n_train, n_train + n_test))
    parts = partition_labels(data.labels, 100, "type2", data.num_classes,
                             seed=0)
    pool = pool_from_partition(data.labels, parts, data.num_classes, seed=0)
    return data, test, parts, pool


def cifar_task(seed: int, rounds: int):
    from repro_torch.core import TaskRequest
    return TaskRequest(budget=1e9, n_star=100, subset_size=SUBSET_N,
                       subset_delta=SUBSET_DELTA, x_star=3,
                       max_periods=10_000, scheduler="mkp", seed=seed,
                       round_chunk=SHARD_CHUNK, max_rounds=rounds)


def pad_slots(schedule: dict, K: int) -> dict:
    """A schedule's client axis padded with empty slots (row 0, weight 0,
    inactive) to ``K``: padding leaves the real slots' draws alone."""
    extra = K - schedule["rows"].shape[1]
    return {k: v if k == "round_ids" else
            torch.nn.functional.pad(v, (0, extra)) for k, v in
            schedule.items()}


def sharded_plane() -> dict:
    """Phase 34: the CIFAR_CNN device plane unsharded, on
    ``make_host_mesh()`` (one shard a card) and on 2 shards of cuda:0,
    from the same seed, each through the lifecycle; then every round of
    the unsharded run again through both sharded chunk functions from
    the parameters that entered it. Returns the sharded runs' launches
    by kernel."""
    from repro_torch.core import FLServiceProvider, lifecycle
    from repro_torch.fl.round import shard_devices
    from repro_torch.fl.simulation import DeviceFLSim, SimConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import cnn
    data, test, parts, pool = cifar_setting(50_000, 10_000)
    runs, sharded, calls = {}, dict.fromkeys(ops.LAUNCHES, 0), []
    for name, mesh in (("unsharded", None),
                       ("make_host_mesh()", make_host_mesh()),
                       ("2 shards of cuda:0", make_host_mesh("cuda:0", 2))):
        trainer = DeviceFLSim(cnn.CIFAR_CNN, data, parts, test,
                              SimConfig(dropout_rate=0.0),
                              pad_subset_to=SUBSET_N + SUBSET_DELTA,
                              mesh=mesh, device="cuda" if mesh is None
                              else None)
        if mesh is None:               # record what enters every chunk
            unsharded_fn = trainer.chunk_fn

            def recorded(params, staged, schedule, key):
                calls.append(({k: v.clone() for k, v in params.items()},
                              schedule))
                return unsharded_fn(params, staged, schedule, key)
            trainer.chunk_fn = recorded
        provider = FLServiceProvider(pool)
        state = lifecycle.submit(provider, cifar_task(0, SHARD_ROUNDS))
        for n in ops.LAUNCHES:
            ops.LAUNCHES[n] = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        with recording() as rounds:
            state, events = lifecycle.drain(provider, state, trainer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if mesh is not None:
            for n, c in ops.LAUNCHES.items():
                sharded[n] += c
        losses = [e.metrics["loss"] for e in events]
        check(len(events) == SHARD_ROUNDS and all(np.isfinite(losses)),
              f"{name}: {len(events)} rounds of finite loss, asked "
              f"{SHARD_ROUNDS}")
        runs[name] = (events, rounds, wall, trainer, dict(ops.LAUNCHES),
                      mesh)
    base_events, base_rounds, _, base, base_counts, _ = runs["unsharded"]
    check(base_counts["fedavg_agg_quality"] == SHARD_ROUNDS,
          "the unsharded plane launches fedavg_agg_quality once a round")
    check(all(c == 0 for c in sharded.values()),
          f"the sharded plane launches no kernel: {sharded}")

    # every round again from the parameters that entered it: the
    # sharded chunk functions against the unsharded one
    gaps = {name: [0.0, 0.0, 0.0] for name in list(runs)[1:]}
    n_rounds = 0
    for params, schedule in calls:
        for t in range(schedule["rows"].shape[0]):
            one = {k: v[t:t + 1] for k, v in schedule.items()}
            K = one["rows"].shape[1]
            nxt, want = unsharded_fn(params, base.data, one, base.base_key)
            for name in gaps:
                trainer, mesh = runs[name][3], runs[name][5]
                n = len(shard_devices(mesh))
                got_p, got = trainer.chunk_fn(
                    params, trainer.data, pad_slots(one, -(-K // n) * n),
                    trainer.base_key)
                cut = {k: got[k][:, :K] for k in ("masks", "q_values",
                                                 "client_losses")}
                check(torch.equal(cut["masks"], want["masks"]),
                      f"{name}: round {int(one['round_ids'][0])}'s masks "
                      f"bit-equal to the unsharded plane's")
                pairs = [(cut["q_values"], want["q_values"]),
                         (cut["client_losses"], want["client_losses"]),
                         (got["mean_loss"], want["mean_loss"])] + \
                    [(got_p[k], nxt[k]) for k in nxt]
                check(all(torch.allclose(a, b, rtol=1e-3, atol=1e-4)
                          for a, b in pairs),
                      f"{name}: round {int(one['round_ids'][0])}'s q, "
                      f"losses and parameters within rtol 1e-3 / atol "
                      f"1e-4 of the unsharded plane's")
                g = gaps[name]
                g[0] = max(g[0], float((pairs[0][0] - pairs[0][1]).abs()
                                       .max()))
                g[1] = max(g[1], float(((pairs[2][0] - pairs[2][1])
                                        / pairs[2][1]).abs().max()))
                g[2] = max(g[2], max(float((a - b).abs().max())
                                     for a, b in pairs[3:]))
            params = nxt
            n_rounds += 1
    check(n_rounds == SHARD_ROUNDS, f"{n_rounds} rounds held again")
    lines = []
    for name, (events, rounds, wall, trainer, _, _) in runs.items():
        same = sum(event_key(e)[:5] == event_key(b)[:5]
                   for e, b in zip(events, base_events))
        check(all(np.array_equal(r[1], b[1])
                  for r, b, e, f in zip(rounds, base_rounds, events,
                                        base_events)
                  if list(e.subset) == list(f.subset)),
              f"{name}: returned masks bit-equal where the subsets agree")
        end = max(float((trainer.params[k] - base.params[k]).abs().max())
                  for k in base.params)
        line = (f"{name} {wall / SHARD_ROUNDS * 1e3:.1f} ms/round, accuracy "
                f"{trainer.evaluate():.4f}, loss {events[0].metrics['loss']:.4f}"
                f" -> {events[-1].metrics['loss']:.4f}, {same}/{SHARD_ROUNDS} "
                f"rounds with the unsharded schedule, final params "
                f"{end:.2e} apart")
        if name in gaps:
            line += (f"; rounds held again from equal params: largest gaps "
                     f"q {gaps[name][0]:.2e}, mean loss {gaps[name][1]:.2e} "
                     f"rel, params {gaps[name][2]:.2e}")
        lines.append(line)
    phase(34, f"sharded device plane, CIFAR_CNN, 100 clients, type2, 50,000 "
              f"samples, subsets of 10 +- 3, {SHARD_ROUNDS} rounds in chunks "
              f"of {SHARD_CHUNK}, dropout 0, wall per round of the service "
              f"loop (stage 2 + training, set-up excluded): "
              + " | ".join(lines) + f" | the sharded runs launch no kernel "
              f"(the unsharded {base_counts['fedavg_agg_quality']} "
              f"fedavg_agg_quality)")
    return sharded


def placement_on_card() -> None:
    """Phase 35: ``ServiceScheduler(n_devices=1)`` with two real
    device-plane tenants (each gets ``place_on(0)``) against the same
    tasks drained alone, bit for bit; ``place_on(1)`` refused on one
    card; on two or more cards, tenants on cuda:0 and cuda:1 too."""
    from repro_torch.core import (FLServiceProvider, ServiceScheduler,
                                  as_run_result, lifecycle)
    from repro_torch.fl.simulation import DeviceFLSim, SimConfig
    from repro_torch.models import cnn
    data, test, parts, pool = cifar_setting(10_000, 2_000)
    rounds = SHARD_CHUNK
    tasks = [cifar_task(seed, rounds) for seed in (0, 1)]
    placed_on = []

    def make():
        trainer = DeviceFLSim(cnn.CIFAR_CNN, data, parts, test,
                              SimConfig(eval_every=10_000),
                              pad_subset_to=SUBSET_N + SUBSET_DELTA,
                              device="cuda")
        hook = trainer.place_on
        trainer.place_on = lambda i: (placed_on.append(i), hook(i))
        return trainer

    alone = []
    for task in tasks:
        provider, trainer = FLServiceProvider(pool), make()
        _, events = lifecycle.drain(provider, lifecycle.submit(provider,
                                                               task), trainer)
        alone.append(([event_key(e) for e in events], trainer.params))

    def scheduled(n_devices):
        sched = ServiceScheduler(FLServiceProvider(pool),
                                 n_devices=n_devices, placement="round_robin")
        trainers = [make() for _ in tasks]
        for task, trainer in zip(tasks, trainers):
            sched.submit(task, trainer)
        t = time.perf_counter()
        done = sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        for tid, (events, params) in enumerate(alone):
            check([event_key(e) for e in done[tid].rounds] == events
                  and all(torch.equal(trainers[tid].params[k].cpu(),
                                      params[k].cpu()) for k in params),
                  f"n_devices={n_devices}: task {tid}'s events and params "
                  f"bit-equal to the task drained alone")
        return [str(t.device) for t in trainers], wall

    placed_on.clear()
    devices, wall = scheduled(1)
    check(placed_on == [0, 0], f"place_on calls {placed_on}, want [0, 0]")
    count = torch.cuda.device_count()
    line = f"two tenants on {devices} ({wall:.2f} s) bit-equal alone"
    if count < 2:
        try:
            make().place_on(1)
            raised = None
        except ValueError as e:
            raised = str(e)
        check(raised is not None, "place_on(1) raises on a one-card machine")
        line += f"; place_on(1) raised: {raised}"
    else:
        placed_on.clear()
        devices, wall = scheduled(2)
        check(placed_on == [0, 1] and devices == ["cuda:0", "cuda:1"],
              f"round_robin over two cards: {placed_on}, {devices}")
        line += f"; on two cards {devices} ({wall:.2f} s) bit-equal alone"
    phase(35, f"placement on the card, torch.cuda.device_count() = {count}: "
              f"ServiceScheduler(n_devices=1), CIFAR_CNN device plane, "
              f"10,000 samples, {rounds} rounds a task: {line}")


def fedsgd_full_width() -> dict:
    """Phase 36: FedSGD at SmolLM-360M's full width and depth through
    ``launch.train.train``; a fixed batch's loss over 8 steps; microbatch
    accumulation against the full batch. Returns the launches of the
    train run by kernel."""
    from repro_torch import optim
    from repro_torch.configs import smollm_360m
    from repro_torch.core import generate_subsets
    from repro_torch.data.synthetic import make_lm_data
    from repro_torch.fl.partition import client_histograms, partition_labels
    from repro_torch.fl.round import make_fedsgd_step
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    cfg = smollm_360m.config()
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.d_ff, cfg.vocab_size, cfg.dtype, cfg.remat)
          == (32, 960, 15, 5, 2560, 49_152, "bfloat16", False),
          f"SmolLM-360M at full width and depth, bf16: {cfg}")
    data = make_lm_data(FEDSGD_CLIENTS * 64, FEDSGD_SEQ, cfg.vocab_size,
                        seed=0)
    parts = partition_labels(data.labels, FEDSGD_CLIENTS, "type2",
                             data.num_classes, seed=0)
    hists = client_histograms(data.labels, parts, data.num_classes)
    sched = generate_subsets(hists, n=4, delta=1, x_star=3)
    rows = [max(FEDSGD_B // len(s), 1) * len(s)
            for s in sched.subsets[:FEDSGD_STEPS]]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for n in ops.LAUNCHES:
        ops.LAUNCHES[n] = 0
    out = train.train(cfg, data, parts, hists, steps=FEDSGD_STEPS,
                      batch=FEDSGD_B, subset=4, lr=3e-3, seed=0,
                      device="cuda")
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(x.numel() for x in optim.tree_leaves(out["params"]))
    losses, step_s = out["losses"], out["step_s"]
    del out
    torch.cuda.empty_cache()
    check(all(np.isfinite(losses)), f"finite losses {losses}")
    check(all(c == 0 for c in launches.values()),
          f"FedSGD launches no kernel (no kernel has a backward): {launches}")
    tok_s = sum(r * FEDSGD_SEQ for r in rows[1:]) / sum(step_s[1:])

    # 8 steps on one fixed batch of 8 x 1,024: clients 0-3, two
    # sequences each, weighted as launch.train weights them
    plain = dataclasses.replace(cfg, use_kernels=False)
    batch = train.client_batch(plain, data, parts, hists, [0, 1, 2, 3],
                               FEDSGD_B, np.random.default_rng(1), "cuda")
    check(batch["tokens"].shape == (FEDSGD_B, FEDSGD_SEQ),
          f"fixed batch {tuple(batch['tokens'].shape)}")
    loss = lambda p, b: T.loss_fn(plain, p, b)
    params = T.init_params(plain, torch.Generator("cuda").manual_seed(0))
    opt = optim.adam(optim.warmup_cosine(3e-3, 10, FEDSGD_STEPS),
                     grad_clip=1.0)
    step = make_fedsgd_step(loss, opt)
    p, state, fixed, walls = params, opt.init(params), [], []
    for _ in range(FEDSGD_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        p, state, m = step(p, state, batch)
        fixed.append(float(m["loss"]))
        walls.append(time.perf_counter() - t)
    check(fixed[-1] < fixed[0], f"the fixed batch's loss falls: {fixed}")
    _, (dev_ms, n_kern, top, _) = device_profile(
        lambda: step(p, state, batch))
    wall_ms = statistics.median(walls[1:]) * 1e3
    del p, state

    # microbatch accumulation: the optimizer's state becomes the grads
    catch = types.SimpleNamespace(
        init=lambda q: {},
        update=lambda g, s, q=None: (optim.tree_map(torch.zeros_like, g), g))
    _, g1, m1 = make_fedsgd_step(loss, catch)(params, {}, batch)
    _, gm, mm = make_fedsgd_step(loss, catch, microbatches=FEDSGD_M)(
        params, {}, batch)
    l1, lm = float(m1["loss"] + m1["aux_loss"]), float(mm["loss"])
    check(abs(lm - l1) <= 1e-2 * abs(l1),
          f"first-step loss, {FEDSGD_M} microbatches {lm} vs 1 {l1}")
    gaps = [float((a - b.float()).norm() / b.float().norm().clamp_min(1e-30))
            for a, b in zip(optim.tree_leaves(gm), optim.tree_leaves(g1))]
    check(max(gaps) <= FEDSGD_GRAD_TOL,
          f"accumulated gradients within 2^-4 of the full batch's by leaf "
          f"(L2): largest {max(gaps):.3e}")
    del g1, gm, params
    torch.cuda.empty_cache()
    phase(36, f"FedSGD, SmolLM-360M at full width and depth ({n_params} "
              f"params, bf16, random weights from seed 0, use_kernels off, "
              f"remat off), {FEDSGD_CLIENTS} clients type2, "
              f"generate_subsets(n=4, delta=1, x_star=3), batches of "
              f"{rows} x {FEDSGD_SEQ} by launch.train's composition, adam("
              f"warmup_cosine(3e-3, 10, {FEDSGD_STEPS}), grad_clip=1.0): "
              f"losses {[round(x, 4) for x in losses]}, step wall first "
              f"{step_s[0]:.3f} s then median "
              f"{statistics.median(step_s[1:]) * 1e3:.1f} ms, {tok_s:.0f} "
              f"tokens/s, peak device memory {peak:.2f} GB; fixed batch of "
              f"{FEDSGD_B} x {FEDSGD_SEQ}: loss {fixed[0]:.4f} -> "
              f"{fixed[-1]:.4f}, median step {wall_ms:.1f} ms, one step "
              f"under the profiler {dev_ms:.1f} ms of device time in "
              f"{n_kern} kernels = busy {dev_ms / wall_ms:.1%} of a step; "
              f"top: {top}; {FEDSGD_M} microbatches vs 1: loss {lm:.5f} vs "
              f"{l1:.5f}, largest gradient gap by leaf {max(gaps):.3e} "
              f"(bound {FEDSGD_GRAD_TOL:g}); launches {launches}")
    return launches


def train_entry_point() -> None:
    """Phase 37: ``python -m repro_torch.launch.train --steps 20`` at its
    defaults, as a user runs it."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--steps", "20"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"launch.train exit {out.returncode}: "
          f"{out.stdout[-1500:]} {out.stderr[-3000:]}")
    m = re.search(r"final loss ([-\d.]+) \(first ([-\d.]+)\)", out.stdout)
    check(m is not None and float(m[1]) < float(m[2]),
          f"the final loss is below the first: {out.stdout[-500:]}")
    lines = out.stdout.strip().splitlines()
    phase(37, f"python -m repro_torch.launch.train --steps 20 (reduced "
              f"SmolLM-360M, cuda): exit 0 in {time.perf_counter() - t:.1f} "
              f"s | {lines[0]} | {lines[-1]}")


# The input steps at SmolLM-360M's full width (phase 38): phase 15's
# serve shape, and one train_4k step of this many sequences of 4,096.
STEP_TRAIN_B = 2
# The dry-run on the host (phase 40): (arch, shape, extra CLI arguments,
# the artifact's mesh name).
DRYRUN_RUNS = (("smollm-360m", "train_4k", (), "16x16"),
               ("smollm-360m", "train_4k", ("--multi-pod",), "2x16x16"),
               ("qwen2-moe-a2.7b", "decode_32k", ("--opt", "1"),
                "16x16-opt1"))
H100_HBM_GB = 80


def input_steps_full_width() -> dict:
    """Phase 38: ``launch.inputs``' step builders at SmolLM-360M's full
    width and depth in bf16. ``make_prefill_step`` / ``make_serve_step``
    with the kernels at phase 15's shape (counts set to 0 just before,
    read just after), logits bit-equal to phase 15's loop on the same
    weights; one ``make_train_step`` step at train_4k's config (remat on)
    against ``make_fedsgd_step`` with the same optimizer, and the peak
    memory with and without remat. Returns the serve launches."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.fl.round import make_fedsgd_step
    from repro_torch.kernels import ops
    from repro_torch.launch import inputs as I
    from repro_torch.models import transformer as T
    from repro_torch.optim import adam
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(SERVE_ARCH), use_kernels=True)
    check((cfg.num_layers, cfg.d_model, cfg.dtype) == (32, SERVE_D,
                                                       "bfloat16"),
          "SmolLM-360M at full width and depth, bf16")
    params = T.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT)),
        dtype=torch.int32, device="cuda")
    greedy = lambda lg: lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)

    def direct(new):                     # phase 15's loop
        logits, cache, _ = T.prefill(cfg, params, prompts)
        cache = T.grow_cache(cfg, cache, new)
        out = [logits]
        for step in range(new - 1):
            logits, cache = T.decode_step(cfg, params, greedy(out[-1]),
                                          cache, SERVE_PROMPT + step)
            out.append(logits)
        return out

    def stepped(new):                    # through the step builders
        prefill_step = I.make_prefill_step(cfg)
        serve_step = I.make_serve_step(cfg)
        logits, cache = prefill_step(params, {"tokens": prompts})
        cache = T.grow_cache(cfg, cache, new)
        out = [logits]
        for step in range(new - 1):
            logits, cache = serve_step(
                params, {"tokens": greedy(out[-1]),
                         "index": SERVE_PROMPT + step}, cache)
            out.append(logits)
        return out

    want = direct(SERVE_NEW)
    stepped(2)                  # warm-up, before the counts are set to 0
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    got = stepped(SERVE_NEW)
    torch.cuda.synchronize()
    counts = {n: c for n, c in ops.LAUNCHES.items() if c}
    L = cfg.num_layers
    check(counts == {"flash_attention": L, "swiglu": L * SERVE_NEW,
                     "rmsnorm": (2 * L + 1) * SERVE_NEW},
          f"input steps launches {counts}")
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "step builders' logits bit-equal to phase 15's loop")
    del want, got

    plain = dataclasses.replace(cfg, use_kernels=False)
    S = I.SHAPES["train_4k"][0]
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (STEP_TRAIN_B, S + 1)),
                           dtype=torch.int32, device="cuda")
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "weights": torch.full((STEP_TRAIN_B,), 1.0 / STEP_TRAIN_B,
                                   device="cuda")}

    def one_step(step, opt):
        state = opt.init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        _, _, m = step(params, state, batch)
        loss = float(m["loss"])
        wall = time.perf_counter() - t
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        del state, m
        torch.cuda.empty_cache()
        return loss, peak, wall

    tcfg = I.shape_config(plain, "train_4k")
    check(tcfg.remat, "train_4k's config takes remat")
    step, opt = I.make_train_step(tcfg)
    loss, peak, wall = one_step(step, opt)
    check(np.isfinite(loss), f"finite train_4k loss {loss}")
    same = make_fedsgd_step(functools.partial(T.loss_fn, tcfg),
                            adam(1e-4, grad_clip=1.0))
    loss_same = one_step(same, opt)[0]
    check(loss_same == loss, f"make_train_step loss {loss} == "
          f"make_fedsgd_step's {loss_same}")
    ncfg = I.shape_config(plain, "train_4k", remat=False)
    try:
        loss_n, peak_n, wall_n = one_step(I.make_train_step(ncfg)[0], opt)
        check(loss_n == loss, f"loss without remat {loss_n} == {loss}")
        no_remat = (f"without remat: loss equal, peak {peak_n:.2f} GB, "
                    f"wall {wall_n:.2f} s")
    except torch.cuda.OutOfMemoryError:
        no_remat = "without remat: out of memory"
    del params
    gc.collect()
    torch.cuda.empty_cache()
    phase(38, f"launch.inputs step builders, {cfg.name} at full width and "
              f"depth, bf16, random weights from seed 0: make_prefill_step "
              f"+ {SERVE_NEW - 1} make_serve_step calls on {SERVE_B} x "
              f"{SERVE_PROMPT} prompts with use_kernels: launches {counts}, "
              f"logits bit-equal to phase 15's loop at every step; "
              f"make_train_step at train_4k's config (remat on, use_kernels "
              f"off), {STEP_TRAIN_B} x {S} tokens: loss {loss:.5f} "
              f"(make_fedsgd_step with the same optimizer: equal), peak "
              f"{peak:.2f} GB above the weights, wall {wall:.2f} s; "
              f"{no_remat}")
    return counts


def cuda_event_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` calls of ``fn``'s time between two CUDA
    events, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def roofline_on_card() -> None:
    """Phase 39: the dry-run's roofline held against the card. The trace
    of SmolLM-360M's plain prefill at phase 15's 8 x 1,024 on a 1x1 mesh
    counts exactly the flops ``FlopCounterMode`` counts over the real
    plain prefill on the card; the kernel and plain prefills (CUDA
    events, median of 5) each take at least the trace's ``compute_s``."""
    import gc
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import inputs as I
    from repro_torch.launch import roofline as R
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import transformer as T
    plain = get_config(SERVE_ARCH)
    check(not plain.use_kernels, "the dry-run traces the plain path")
    shape = (SERVE_PROMPT, SERVE_B, "prefill")
    t = time.perf_counter()
    traced = D.trace_step(plain, shape, make_production_mesh(shape=(1, 1)))
    trace_s = time.perf_counter() - t
    mf = I.model_flops_for(plain, shape)
    terms = R.derive_terms({"flops": traced["flops"],
                            "bytes accessed": traced["bytes_accessed"]},
                           traced["coll"], 1, mf)
    kern = dataclasses.replace(plain, use_kernels=True)
    params = T.init_params(plain, torch.Generator("cuda").manual_seed(0))
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, plain.vocab_size, (SERVE_B, SERVE_PROMPT)), dtype=torch.int32,
        device="cuda")
    with torch.no_grad():
        with FlopCounterMode(display=False) as fc:
            T.prefill(plain, params, prompts)
        real = fc.get_total_flops()
        check(real == traced["flops"], f"traced prefill flops "
              f"{traced['flops']} == FlopCounterMode's on the card {real}")
        ms = {name: cuda_event_ms(lambda c=c: T.prefill(c, params, prompts))
              for name, c in (("kernels", kern), ("plain", plain))}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    floor_ms = max(terms.compute_s, terms.memory_s) * 1e3
    for name, v in ms.items():
        check(v >= terms.compute_s * 1e3, f"{name} prefill {v:.3f} ms >= "
              f"compute_s {terms.compute_s * 1e3:.3f} ms")
    phase(39, f"roofline vs the card: SmolLM-360M prefill {SERVE_B} x "
              f"{SERVE_PROMPT}, bf16, traced on a 1x1 mesh in {trace_s:.1f} "
              f"s: flops {traced['flops']:.6e} (FlopCounterMode on the card: "
              f"equal), unfused bytes {traced['bytes_accessed']:.6e}, "
              f"compute_s {terms.compute_s * 1e3:.4f} ms, memory_s "
              f"{terms.memory_s * 1e3:.4f} ms (unfused, not held), "
              f"bottleneck {terms.bottleneck}; CUDA events, median of 5: "
              f"kernel prefill {ms['kernels']:.3f} ms = "
              f"{ms['kernels'] / floor_ms:.2f} x max(compute_s, memory_s), "
              f"plain prefill {ms['plain']:.3f} ms = "
              f"{ms['plain'] / floor_ms:.2f} x; both >= compute_s")


def dryrun_cli() -> None:
    """Phase 40: ``python -m repro_torch.launch.dryrun`` as a user runs
    it, three runs at once on the host (the trace needs no card): each
    artifact ``ok`` with flops > 0 and a bottleneck named; SmolLM's
    runs with no split dim replicated by hand; the multi-pod run traced
    on pod and data as one mesh dim of 32, its per-device flops half
    the single pod's within 1 %."""
    import os
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    lines, arts = [], {}
    with tempfile.TemporaryDirectory() as out:
        procs = []
        for arch, shape, extra, _ in DRYRUN_RUNS:
            cmd = [sys.executable, "-W", "ignore", "-m",
                   "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                   shape, "--out", out, *extra]
            procs.append((time.perf_counter(), subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
        for (arch, shape, extra, mesh), (t, proc) in zip(DRYRUN_RUNS,
                                                         procs):
            try:
                stdout, stderr = proc.communicate(timeout=600)
            finally:
                proc.kill()
            wall = time.perf_counter() - t
            check(proc.returncode == 0, f"dryrun {arch} {shape} {extra} "
                  f"exit {proc.returncode}: {stdout[-1500:]} "
                  f"{stderr[-3000:]}")
            with open(os.path.join(out, f"{arch}__{shape}__{mesh}.json")) \
                    as f:
                art = json.load(f)
            roof = art["roofline"]
            check(art["ok"] and roof["flops"] > 0 and roof["bottleneck"]
                  in ("compute", "memory", "collective"),
                  f"dryrun artifact {arch} {shape} {mesh}: {art}")
            arts[mesh] = art
            mem = art["memory"]
            per_dev = (mem["argument_size_in_bytes"]
                       + mem["temp_size_in_bytes"]) / 1e9
            lines.append(
                f"{arch} {shape} {mesh}: ok, {per_dev:.2f} GB a device of "
                f"{H100_HBM_GB} GB, flops/dev {roof['flops']:.4e}, compute "
                f"{roof['compute_s']:.4f} s, memory {roof['memory_s']:.4f} "
                f"s, collective {roof['collective_s']:.4f} s, bottleneck "
                f"{roof['bottleneck']}, trace {art['trace_s']} s, wall "
                f"{wall:.1f} s, mesh dims {art['mesh_dims']}, "
                f"ops run by hand {art['handled_ops']}")
    one, two = arts["16x16"], arts["2x16x16"]
    check(two["mesh_dims"] == {"pod+data": 32, "model": 16},
          f"multi-pod traced on {two['mesh_dims']}")
    for art in (one, two):
        check(not any("replicated" in op for op in art["handled_ops"]),
              f"smollm-360m train_4k {art['mesh']}: no split dim "
              f"replicated by hand: {art['handled_ops']}")
    ratio = two["roofline"]["flops"] / one["roofline"]["flops"]
    check(abs(ratio - 0.5) <= 0.005, f"smollm-360m train_4k: flops a "
          f"device on 2x16x16 / 16x16 = {ratio:.6f}, 0.5 within 1 %")
    lines.append(f"2x16x16 / 16x16 flops a device {ratio:.6f}")
    phase(40, "python -m repro_torch.launch.dryrun on the host, three runs "
              "at once | " + " | ".join(lines))


def record(name, source, replaces, launches, err, t) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            **t}


def main() -> int:
    card()
    build()
    err = kernel_vs_plain()
    chunk_kernel_vs_plain()
    launches, base_ms = slice_run()
    fleet = fleet_pool()
    t = timing(fleet)
    errs = new_kernels_vs_plain()
    topk_launches, task0 = fleet_intake(fleet)
    mkp_launches = stage2_on_card(task0)
    intake_batch()
    errs.update(codec_kernels_vs_plain())
    codec_launches = compressed_loop(base_ms)
    none_is_uncompressed()
    serve_errs, fam_kernels = serve_kernels_vs_plain()
    errs.update(serve_errs)
    serve_launches = serve_full_width()
    serve_entry_point()
    agg_err = agg_kernel_vs_plain()
    agg_launches = host_plane(base_ms)
    fault_plane()
    library_settings()
    scan_err = scan_kernel_vs_plain()
    ssm_launches = ssm_full_width()
    ssm_serve_entry_points()
    codec_non_finite()
    resume_launches = compressed_resume()
    lm_launches = lm_full_width()
    examples_on_card()
    family_launches = family_full_width()
    family_serve_entry_points()
    shard_launches = sharded_plane()
    placement_on_card()
    fedsgd_launches = fedsgd_full_width()
    train_entry_point()
    step_launches = input_steps_full_width()
    roofline_on_card()
    dryrun_cli()
    by_path = lambda name: {"launches_by_path": {
        "compressed_resume": resume_launches[name],
        "lm_full_width": lm_launches[name],
        "sharded_plane": shard_launches[name],
        "fedsgd": fedsgd_launches[name]}}
    csrc = "src/repro_torch/kernels/csrc/"
    records = [
        record("fedavg_agg_quality", csrc + "fedavg_agg_quality.cu",
               "src/repro/kernels/fedavg_agg.py:91", launches, err,
               {**t["fedavg_agg_quality"], **by_path("fedavg_agg_quality")}),
        record("fedavg_agg", csrc + "fedavg_agg.cu",
               "src/repro/kernels/fedavg_agg.py:40", agg_launches, agg_err,
               t["fedavg_agg"]),
        record("segmented_topk", csrc + "segmented_topk.cu",
               "src/repro/kernels/segmented_topk.py:62", topk_launches,
               errs["segmented_topk"], t["segmented_topk"]),
        # stage 2 runs mkp_greedy in its place: 0 launches on the path
        record("mkp_utility", csrc + "mkp_utility.cu",
               "src/repro/kernels/mkp_utility.py:42",
               mkp_launches["mkp_utility"], errs["mkp_utility"],
               {**t["mkp_utility"], "path_counterpart": "mkp_greedy"}),
        record("mkp_greedy", csrc + "mkp_utility.cu",
               "src/repro/kernels/mkp_utility.py:42",
               mkp_launches["mkp_greedy"], errs["mkp_greedy"],
               {**t["mkp_greedy"],
                "stage2_wall_s": mkp_launches["stage2_wall_s"]})]
    for name, source, line in (
            ("topk_sparsify", "segmented_topk.cu", 81),
            ("quantize_i8", "quantize_i8.cu", 117),
            ("dequantize_i8", "quantize_i8.cu", 145),
            ("fedavg_agg_quality_i8", "fedavg_agg_quality.cu", 197)):
        records.append(record(name, csrc + source,
                              f"src/repro/kernels/compression.py:{line}",
                              codec_launches[name], errs[name],
                              {**t[name], **by_path(name)}))
    by_arch = {SERVE_ARCH: serve_launches, **ssm_launches, **family_launches}
    for name, line in (("rmsnorm", "rmsnorm.py:23"), ("swiglu", "swiglu.py:38"),
                       ("flash_attention", "flash_attention.py:77")):
        records.append(record(name, csrc + name + ".cu",
                              "src/repro/kernels/" + line,
                              serve_launches[name], errs[name],
                              {**t[name], "launches_by_arch": {
                                  a: c.get(name, 0)
                                  for a, c in by_arch.items()},
                               "launches_input_steps": step_launches[name],
                               "at_families": fam_kernels[name]}))
    records.append(record(
        "mlstm_scan", csrc + "mlstm_scan.cu",
        "src/repro/kernels/mlstm_scan.py:95",
        sum(c["mlstm_scan"] for c in ssm_launches.values()), scan_err,
        {**t["mlstm_scan"], "launches_by_arch": {
            a: c["mlstm_scan"] for a, c in ssm_launches.items()}}))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
