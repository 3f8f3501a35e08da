"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, in order, each printing one line (``[phase] ...``) and failing
loudly:

1. environment: torch, the card, its power limit (nvidia-smi);
2. kernel build: nvcc of every ``src/repro_torch/kernels/csrc`` source;
3. RMSNorm: drives ``ops.rmsnorm`` (forward and backward) with the launch
   counts set to 0 and asserts the kernel ran; then holds the kernel
   against its plain version at each shape (f32 tol 1e-5, bf16 tol 2e-2)
   and times kernel, plain version and ``torch.nn.functional.rms_norm``
   (a yardstick the port never calls);
4. goldens: the four open-loop golden points of
   ``tests/test_golden_metrics.py`` through ``run_sweep_batched`` on the
   card, held against ``tests/goldens/*.json`` (integers exact, floats
   rel 1e-6);
5. fig2 at paper size: substrate, interposer and wireless 4C4M, load 1.0,
   10 000 cycles with 1 000 of warm-up, in one batched call, with the
   kernel launch counts set to 0 before and read after; held against
   ``tests/torch_fixtures/fig2_reference.json`` (written by the JAX
   package) under the same bounds.

It prints the card's name and power limit and a JSON line of kernel
numbers, and as its last line ``{"ok": true, "device": {...}}``.  Without
a CUDA device, or without the rest of the repository, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12            # f32 outside the tensor cores
RMS_SHAPES = [                    # (shape, dtype name, tol)
    ((128, 512), "float32", 1e-5),
    ((2, 64, 1024), "float32", 1e-5),
    ((300, 768), "float32", 1e-5),
    ((128, 2048), "bfloat16", 2e-2),
    ((4, 32, 256), "bfloat16", 2e-2),
    ((8192, 4096), "bfloat16", 2e-2),    # granite-8b d_model
    ((8192, 16384), "bfloat16", 2e-2),   # llama3-405b d_model
    ((8192, 4096), "float32", 1e-5),
]
HEADLINE = ((8192, 4096), "bfloat16")
GOLDEN_CASES = {
    "wireless_4c4m_load02": dict(fabric=2, load=0.2, p_mem=0.2),
    "interposer_4c4m_load02": dict(fabric=1, load=0.2, p_mem=0.2),
    "substrate_4c4m_load02": dict(fabric=0, load=0.2, p_mem=0.2),
    "app_canneal_wireless_4c4m": dict(fabric=2, load=1.0, p_mem=0.2,
                                      app="canneal"),
}
INT_FIELDS = ("pkts_delivered", "flits_delivered", "flits_injected")
FLOAT_FIELDS = ("offered_load", "throughput", "bw_gbps_core",
                "avg_pkt_latency", "avg_pkt_energy_pj", "energy_pj_bit")


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def close(a: float, b: float) -> bool:
    """Within rel 1e-6; NaN matches NaN (no latency sample in the window)."""
    return (math.isnan(a) and math.isnan(b)) or math.isclose(a, b,
                                                             rel_tol=1e-6)


def check_metrics(tag: str, got, want: dict) -> None:
    """Integers exact, floats (and energy terms) within rel 1e-6."""
    bad = []
    for f in INT_FIELDS + tuple(f for f in ("cycles_run", "drain_cycle")
                                if f in want):
        if int(getattr(got, f)) != want[f]:
            bad.append(f"{f}: {getattr(got, f)} != {want[f]}")
    for f in FLOAT_FIELDS:
        if not close(getattr(got, f), want[f]):
            bad.append(f"{f}: {getattr(got, f)!r} vs {want[f]!r}")
    for k, v in want["energy_breakdown"].items():
        if not close(got.energy_breakdown[k], v):
            bad.append(f"energy.{k}: {got.energy_breakdown[k]!r} vs {v!r}")
    if bad:
        raise AssertionError(f"{tag} disagrees with the reference: {bad}")


def phase_rmsnorm(dev, rmsnorm, ops, ref) -> dict:
    import torch
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(shape, dtype):
        x = torch.randn(shape, generator=gen, device=dev).to(dt[dtype])
        w = (1.0 + 0.1 * torch.randn(shape[-1:], generator=gen, device=dev)
             ).to(dt[dtype])
        return x, w

    cases = [(s, d, tol, *inputs(s, d)) for s, d, tol in RMS_SHAPES]
    # the kernel's own path: the public entry point, forward and backward
    rmsnorm.launches = 0
    for _, _, _, x, w in cases:
        xg = x.clone().requires_grad_(True)
        ops.rmsnorm(xg, w).float().sum().backward()
    torch.cuda.synchronize()
    path_launches = rmsnorm.launches
    if path_launches != len(cases):
        raise AssertionError(f"ops.rmsnorm launched the kernel "
                             f"{path_launches} times for {len(cases)} calls")
    say("rmsnorm", f"ops.rmsnorm path: {path_launches} kernel launches "
        f"for {len(cases)} forward calls")

    rows = []
    for shape, dtype, tol, x, w in cases:
        x2 = x.reshape(-1, shape[-1])
        y = rmsnorm.rmsnorm_2d(x2, w)
        yr = ref.rmsnorm_ref(x2, w)
        torch.cuda.synchronize()
        err = (y.float() - yr.float()).abs()
        max_err = float(err.max())
        if not bool((err <= tol + tol * yr.float().abs()).all()):
            raise AssertionError(f"rmsnorm {shape} {dtype}: max abs err "
                                 f"{max_err} beyond tol {tol}")
        n, d = x2.shape
        nbytes = (2 * n * d + d) * x2.element_size()
        flops = 4 * n * d
        bound_s = max(nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS)
        rec = dict(
            shape=list(shape), dtype=dtype, max_abs_err=max_err, tol=tol,
            ms=time_ms(lambda: rmsnorm.rmsnorm_2d(x2, w)),
            plain_ms=time_ms(lambda: ref.rmsnorm_ref(x2, w)),
            library_ms=time_ms(lambda: torch.nn.functional.rms_norm(
                x2, (d,), w, 1e-6)),
            bound_ms=bound_s * 1e3,
            bound_by="bytes" if nbytes / H100_BYTES_PER_S
            >= flops / H100_F32_FLOPS else "operations")
        rows.append(rec)
        say("rmsnorm", json.dumps(rec))
    head = next(r for r in rows if tuple(r["shape"]) == HEADLINE[0]
                and r["dtype"] == HEADLINE[1])
    return dict(name="rmsnorm", route="cuda",
                source="src/repro_torch/kernels/csrc/rmsnorm.cu",
                replaces="src/repro/kernels/rmsnorm.py:23",
                launches=path_launches, max_abs_err=head["max_abs_err"],
                ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=head["library_ms"],
                shape=head["shape"], dtype=head["dtype"], per_shape=rows)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.constants import Fabric, SimParams
    from repro_torch.core.sweep import SweepPoint, run_sweep_batched
    from repro_torch.kernels import _build, ops, ref, rmsnorm

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say("env", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    print(smi, flush=True)

    t = time.perf_counter()
    logs = _build.build()
    say("build", f"{time.perf_counter() - t:.1f} s for {sorted(logs)}")
    for k, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                say("build", f"{k}: {line.strip()}")

    kern = phase_rmsnorm(dev, rmsnorm, ops, ref)

    sim_g = SimParams(cycles=1500, warmup=300, seed=0)
    pts = [SweepPoint(4, 4, Fabric(c["fabric"]), load=c["load"],
                      p_mem=c["p_mem"], app=c.get("app"), sim=sim_g)
           for c in GOLDEN_CASES.values()]
    t = time.perf_counter()
    ms = run_sweep_batched(pts, device=dev)
    dt_g = time.perf_counter() - t
    for (gname, _), m in zip(GOLDEN_CASES.items(), ms):
        gold = json.loads((ROOT / "tests" / "goldens" / f"{gname}.json")
                          .read_text())
        assert gold["sim"] == {"cycles": 1500, "warmup": 300, "seed": 0}
        check_metrics(gname, m, gold["metrics"])
    say("goldens", f"4 golden points match ({dt_g:.2f} s, one batch)")

    fx = json.loads((ROOT / "tests" / "torch_fixtures" /
                     "fig2_reference.json").read_text())
    sim_p = SimParams(**fx["sim"])
    fabs = [Fabric.SUBSTRATE, Fabric.INTERPOSER, Fabric.WIRELESS]
    pts = [SweepPoint(4, 4, f, load=1.0, p_mem=0.2, sim=sim_p) for f in fabs]
    rmsnorm.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    ms = run_sweep_batched(pts, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    sim_launches = {"rmsnorm": rmsnorm.launches}
    res = dict(zip(fabs, ms))
    for f in fabs:
        check_metrics(f"fig2 {f.name}", res[f], fx["points"][f.name]["metrics"])
    w, i, s = res[Fabric.WIRELESS], res[Fabric.INTERPOSER], \
        res[Fabric.SUBSTRATE]
    bw_check = w.bw_gbps_core > i.bw_gbps_core > s.bw_gbps_core
    en_check = w.avg_pkt_energy_pj < i.avg_pkt_energy_pj \
        < s.avg_pkt_energy_pj
    say("fig2", json.dumps(dict(
        wall_s=wall, points=len(pts), points_per_s=len(pts) / wall,
        lane_cycles_per_s=len(pts) * sim_p.cycles / wall,
        batch_steps_per_s=sim_p.cycles / wall,
        wireless_highest_bw=bw_check, wireless_lowest_energy=en_check,
        kernel_launches_on_path=sim_launches,
        bw_gbps_core={f.name: res[f].bw_gbps_core for f in fabs},
        avg_pkt_energy_pj={f.name: res[f].avg_pkt_energy_pj for f in fabs},
        power=smi)))
    # the paper's grid runs no kernel of this repository: no kernel may
    # have been expected on it, and none ran
    if any(sim_launches.values()):
        raise AssertionError(f"unexpected kernel launches: {sim_launches}")

    print(json.dumps({"kernels": [kern]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
