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
    many blocks, odd P);
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
    ragged S; ragged M, D, F); ``swiglu`` takes its expected route at
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
    at their default (reduced) sizes.

Phases 5, 8, 9, 12, 15, 16, 18, 22, 23 and 24 set their kernels' launch
counts to 0 just before and read them just after. Each phase line carries the
seconds since the script started. Any failure raises and exits non-zero. The
last two lines are the kernel records and ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import contextlib
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

    def norm_timed(m, x):
        return {"ms": time_ms(lambda: ops.rmsnorm(x, scale)),
                "plain_ms": time_ms(lambda: ref.rmsnorm_ref(x, scale)),
                "library_ms": time_ms(lambda: F.rms_norm(x, (D,), scale,
                                                         1e-6)),
                **bound(2 * (2 * m * D + D), 4 * m * D)}

    def mlp_timed(m, d, f, wg, wu):
        x, w_gu = rn(m, d), torch.cat([wg, wu], 1)
        return {"ms": time_ms(lambda: ops.swiglu(x, wg, wu)),
                "plain_ms": time_ms(lambda: ref.swiglu_ref(x, wg, wu)),
                "library_ms": None,
                "gate_product_ms": time_ms(lambda: x @ wg),
                "both_products_ms": time_ms(lambda: x @ w_gu),
                **bound(2 * (m * d + 2 * d * f + m * f), 4 * m * d * f,
                        PEAK_BF16_FLOPS)}

    norm = norm_timed(M, rn(M, D))
    norm["at_decode"] = norm_timed(SERVE_B, rn(SERVE_B, D))
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
              f"chunks keep scale 0, +-amax saturate at +-127); max |err| "
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


def serve_kernels_vs_plain() -> dict:
    """Phase 14: the serve path's three kernels against their plain
    versions on the card, f32 and bf16. Returns max |err| at the serve
    shapes in bf16 (prefill's for rmsnorm and swiglu)."""
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
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((M, D), (SERVE_B, 1, D), *hymba_norm, (4, 50),
                      (3, 5, 128), (1, 1)):
            x, s = rn(shape, dtype, 3.0), rn(shape[-1:], dtype)
            held("rmsnorm", (shape, dtype), ops.rmsnorm(x, s),
                 ref.rmsnorm_ref(x, s))
        for m, d, f in SWIGLU_CASES:
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
            (200, 962, 2560): "mma", (8, 964, 2560): "mma"}
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
    phase(14, f"serve kernels vs plain on the card, f32 and bf16: rmsnorm "
              f"{n['rmsnorm']} cases (rows x D in {M}x{D}, {SERVE_B}x{D}, "
              f"{SSM_B * SSM_PROMPT}x1600, {SSM_B}x1600, 4x50, 15x128, 1x1), "
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
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return main


def full_width_serve(phase_n: int, arch: str, B: int, prompt: int,
                     want) -> dict:
    """One model at its published width in bf16 through the kernels: a
    warm-up, then the main path (counts set to 0 just before it) of a
    B x ``prompt`` prefill and SERVE_NEW - 1 decode steps, greedy; then
    its prefill and SERVE_TF teacher-forced decode steps through the
    kernels (under the profiler), through the plain versions, and
    through the plain versions in f32 on the same weights. ``want(L)``
    gives the exact launch counts. Prints phase ``phase_n``'s line and
    returns the counts."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import common
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config(arch), use_kernels=True)
    check(cfg.dtype == "bfloat16", f"{arch} in bf16")
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, prompt)), dtype=torch.int32, device="cuda")

    def generate(new):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache, _ = T.prefill(cfg, params, prompts)
        cache = T.grow_cache(cfg, cache, new)
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        t_pre, t = time.perf_counter() - t, time.perf_counter()
        toks = [tok]
        for step in range(new - 1):
            logits, cache = T.decode_step(cfg, params, tok, cache,
                                          prompt + step)
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
        (logits, cache, _), prof = run(
            lambda: T.prefill(c, p, prompts, kernels=kernels))
        cache = T.grow_cache(c, cache, SERVE_TF)
        outs = [logits.float()]

        def decode():
            nonlocal logits, cache
            for step in range(SERVE_TF):
                logits, cache = T.decode_step(c, p, tokens[:, step:step + 1],
                                              cache, prompt + step,
                                              kernels=kernels)
                outs.append(logits.float())
        _, prof2 = run(decode)
        if profiles is not None:
            profiles += [prof, prof2]
        return torch.cat(outs, 1)             # (B, 1 + SERVE_TF, vocab)

    profiles = []
    kern, plain = teacher(None, profiles=profiles), teacher(ops.PLAIN)
    p32 = T.tree_map(lambda a: a.float(), params)
    f32 = teacher(ops.PLAIN, dataclasses.replace(cfg, dtype="float32"), p32)
    del p32
    torch.cuda.synchronize()
    check(bool(torch.isfinite(kern).all()), "finite logits")
    d_kp = (kern - plain).abs().amax(dim=(0, 2))        # per position
    d_pf = (plain - f32).abs().amax(dim=(0, 2))
    top = float(plain.abs().max())
    agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    # Kernel and plain version round bf16 at different places; their gap
    # is held to twice the plain bf16 path's own gap from f32 on the same
    # weights, and to 5 % of the largest |logit|.
    check(float(d_kp.max()) <= 2 * float(d_pf.max()),
          f"{arch} kernel vs plain {float(d_kp.max())} <= 2 x bf16-vs-f32 "
          f"{float(d_pf.max())}")
    check(float(d_kp.max()) <= 0.05 * top,
          f"{arch} kernel vs plain {float(d_kp.max())} <= 5 % of max "
          f"|logit| {top}")
    steps = SERVE_NEW - 1
    (pre_dev, pre_n, pre_top, pre_ours), (dec_dev, dec_n, dec_top, _) = \
        profiles
    dec_dev /= SERVE_TF
    busy = ("not measured (the profiler saw no device time)" if not dec_dev
            else f"{dec_dev / (t_dec / steps * 1e3) * 100:.1f} %")
    phase(phase_n, f"full-width serve: {cfg.name} "
              f"({common.count_params(params)} params, bf16, random weights "
              f"from seed 0 drawn in {init_s:.2f} s), batch {B} x prompt "
              f"{prompt} + {SERVE_NEW} new tokens, use_kernels=True: prefill "
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
              f"|logit| {top:.3f}); argmax agrees at {agree * 100:.1f} % of "
              f"positions; torch.profiler device time, kernel path: prefill "
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
    errs.update(serve_kernels_vs_plain())
    serve_launches = serve_full_width()
    serve_entry_point()
    agg_err = agg_kernel_vs_plain()
    agg_launches = host_plane(base_ms)
    fault_plane()
    library_settings()
    scan_err = scan_kernel_vs_plain()
    ssm_launches = ssm_full_width()
    ssm_serve_entry_points()
    csrc = "src/repro_torch/kernels/csrc/"
    records = [
        record("fedavg_agg_quality", csrc + "fedavg_agg_quality.cu",
               "src/repro/kernels/fedavg_agg.py:91", launches, err,
               t["fedavg_agg_quality"]),
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
                              codec_launches[name], errs[name], t[name]))
    for name, line in (("rmsnorm", "rmsnorm.py:23"), ("swiglu", "swiglu.py:38"),
                       ("flash_attention", "flash_attention.py:77")):
        records.append(record(name, csrc + name + ".cu",
                              "src/repro/kernels/" + line,
                              serve_launches[name], errs[name], t[name]))
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
