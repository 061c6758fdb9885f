"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``repro_torch`` (never JAX, never the JAX package) through its
main path at the paper's CIFAR CNN width and holds every CUDA kernel of
that path against its plain PyTorch version. Phases, one line each:

1. the card: fail without CUDA; print ``nvidia-smi`` name and power limit;
2. build the kernels from the sources in this checkout (``nvcc`` into
   ``build/``), with the build time;
3. each kernel against its plain version on the card, at the main
   path's shape and at ragged shapes, in f32 and bf16;
4. one round chunk (S=4, CIFAR_CNN) from the same parameters through
   the kernel and through the plain aggregate (TF32 off for matmuls and
   cuDNN convolutions, so both runs are full f32);
5. the slice: ``run_fl_experiment(..., data_plane="device")`` on the card
   with launch counts set to 0 just before and read just after;
6. kernel, plain version and library yardstick timed with CUDA events
   (median of 20 samples of 10 back-to-back calls), beside the kernel's
   bound.

Any failure raises and exits non-zero. The last two lines are the
kernel record and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet: HBM rate and f32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
MAIN_K, MAIN_P = 13, 1_070_794      # subset_size + delta; CIFAR_CNN params
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-5)}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def phase(n: int, msg: str) -> None:
    print(f"[phase {n}] {msg}", flush=True)


def card() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: chip_smoke.py needs an "
                         "NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    phase(1, f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")


def build() -> None:
    from repro_torch.kernels import fedavg_agg
    t0 = time.perf_counter()
    fedavg_agg.library()
    dt = time.perf_counter() - t0
    phase(2, f"built fedavg_agg_quality in {dt:.2f} s; ptxas per entry: "
             + "; ".join(ptxas_entries(fedavg_agg.build_log())))


def ptxas_entries(log: str) -> list[str]:
    """One ``name<dtype,K bucket>: registers, spills`` item per kernel
    entry of an ``nvcc -Xptxas -v`` log. Template arguments are read from
    the mangled name (``IfLi16E`` is <f32, 16>), past any namespace."""
    entries, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN?(\w+)'", line)
        if m:
            rest = m.group(1)
            while d := re.match(r"\d+", rest):     # <len><name> parts
                n = int(d.group(0))
                name, rest = rest[d.end():d.end() + n], rest[d.end() + n:]
            targs = re.match(r"I(f|13__nv_bfloat16)Li(\d+)E", rest)
            if targs:
                dtype = "f32" if targs.group(1) == "f" else "bf16"
                name += f"<{dtype},{targs.group(2)}>"
            spill = ""
        elif "spill stores" in line:
            spill = line.strip()
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            entries.append(f"{name}: {m.group(1)} registers, {spill}")
            name = None
    check(bool(entries), "ptxas report lists the kernel entries")
    return entries


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


def chunk_kernel_vs_plain() -> None:
    from repro_torch import random as trandom
    from repro_torch.data.synthetic import make_classification_data
    from repro_torch.fl import device_data
    from repro_torch.fl.partition import partition_labels
    from repro_torch.fl.round import make_fl_rounds_scan
    from repro_torch.kernels import ref
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
    loss = lambda p, b: cnn.loss_fn(cfg, p, b)
    p_k, i_k = make_fl_rounds_scan(loss, **kw)(params, dd, sched, key)
    p_p, i_p = make_fl_rounds_scan(
        loss, aggregate=ref.fedavg_agg_quality_ref, **kw)(params, dd, sched,
                                                          key)
    torch.cuda.synchronize()
    dp = max(float((p_k[n] - p_p[n]).abs().max()) for n in p_k)
    dq = float((i_k["q_values"] - i_p["q_values"]).abs().max())
    check(torch.equal(i_k["masks"], i_p["masks"]), "chunk masks equal")
    check(all(bool(torch.isfinite(v).all()) for v in p_k.values()),
          "chunk params finite")
    check(dp <= 1e-4, f"chunk params kernel vs plain {dp} <= 1e-4")
    check(dq <= 1e-3, f"chunk q kernel vs plain {dq} <= 1e-3")
    phase(4, f"round chunk S={S} K={K} CIFAR_CNN (TF32 off for matmul and "
             f"cuDNN): kernel vs plain aggregate max |dparams| {dp:.3e} "
             f"(tol 1e-4), max |dq| {dq:.3e} (tol 1e-3), masks equal")


def slice_run() -> int:
    from repro_torch.core import fairness, lifecycle
    from repro_torch.fl.simulation import run_fl_experiment
    from repro_torch.kernels import ops
    rounds = 24
    drain, loop_s = lifecycle.drain, []

    def timed_drain(*args, **kwargs):
        """The service loop alone (stage 2, training, reputation),
        without the data generation and staging around it."""
        t = time.perf_counter()
        result = drain(*args, **kwargs)
        torch.cuda.synchronize()
        loop_s.append(time.perf_counter() - t)
        return result

    lifecycle.drain = timed_drain
    ops.LAUNCHES["fedavg_agg_quality"] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = run_fl_experiment("cifar", "type2", n_clients=100,
                                rounds=rounds, n_train=50_000,
                                n_test=10_000, subset_size=10,
                                subset_delta=3, data_plane="device",
                                round_chunk=8)
        torch.cuda.synchronize()
    finally:
        lifecycle.drain = drain
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES["fedavg_agg_quality"]
    hist, state = out["history"], out["state"]
    trained = len(hist)
    losses = [h["loss"] for h in hist]
    check(trained == rounds, f"{trained} rounds trained, asked {rounds}")
    check(len(loop_s) == 1, "one service loop per run")
    check(launches == trained,
          f"kernel launches {launches} == rounds trained {trained}")
    check(all(np.isfinite(losses)), "finite losses")
    check(0.0 <= out["final_accuracy"] <= 1.0, "accuracy in [0, 1]")
    rep = fairness.fairness_report(state.schedules[0],
                                   sorted(state.pool), x_star=3)
    check(rep["coverage"] and rep["bounded"],
          "first period's schedule covers the pool within x*")
    phase(5, f"slice: pool {len(state.pool)} clients, {trained} rounds, "
             f"loss first {losses[0]:.4f} last {losses[-1]:.4f}, final "
             f"accuracy {out['final_accuracy']:.4f}; wall {wall:.2f} s, of "
             f"which the service loop {loop_s[0]:.2f} s = "
             f"{loop_s[0] / trained * 1e3:.1f} ms/round (rest: data "
             f"set-up and final eval); fedavg_agg_quality launches "
             f"{launches}")
    return launches


def time_ms(fn, samples: int = 20, calls: int = 10) -> float:
    """Median over ``samples`` of the device time of ``calls``
    back-to-back calls between two CUDA events, per call (so the host's
    launch overhead hides behind the queue)."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def timing() -> dict:
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(2)
    u = torch.randn(MAIN_K, MAIN_P, generator=g, device="cuda")
    w = torch.softmax(torch.randn(MAIN_K, generator=g, device="cuda"), 0)
    ms = time_ms(lambda: ops.fedavg_agg_quality(u, w))
    plain_ms = time_ms(lambda: ref.fedavg_agg_quality_ref(u, w))
    mv_ms = time_ms(lambda: torch.mv(u.T, w))
    nbytes = 4 * (MAIN_K * MAIN_P + MAIN_K + MAIN_P + 2 * MAIN_K + 1)
    flops = 6 * MAIN_K * MAIN_P + 2 * MAIN_P
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    phase(6, f"K={MAIN_K} P={MAIN_P} f32 median of 20 x 10 calls: kernel {ms:.4f} ms, "
             f"plain {plain_ms:.4f} ms, torch.mv(U.T, w) (agg only) "
             f"{mv_ms:.4f} ms; bound {max(bytes_ms, ops_ms):.4f} ms "
             f"({nbytes} B at 3.35 TB/s; {flops} flop at 67 TFLOP/s)")
    return {"ms": ms, "plain_ms": plain_ms, "agg_only_mv_ms": mv_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def main() -> int:
    card()
    build()
    err = kernel_vs_plain()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chunk_kernel_vs_plain()
    launches = slice_run()
    t = timing()
    record = {"name": "fedavg_agg_quality", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/fedavg_agg_quality.cu",
              "replaces": "src/repro/kernels/fedavg_agg.py:91",
              "launches": launches, "max_abs_err": err, "ms": t["ms"],
              "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
              "bound_by": t["bound_by"], "library_ms": None,
              "agg_only_mv_ms": t["agg_only_mv_ms"]}
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
