"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, in order, each printing one line (``[phase] ...``) and failing
loudly:

1. environment: torch, the card, its power limit (nvidia-smi);
2. kernel build: nvcc of every ``src/repro_torch/kernels/csrc`` source,
   with ptxas's registers, spills and warnings of each kernel and the
   tensor-core kernels' shared memory (it fails on a spill in either, on
   any of the SSD kernel's eight instances, P boxes 1-4 with x by TMA or
   by the threads, missing from the report, or on ``setmaxnreg`` ignored
   in the flash kernel, C7508);
3. RMSNorm: drives ``ops.rmsnorm`` (forward and backward) with the launch
   counts set to 0 and asserts the kernel ran; then holds the kernel
   against its plain version at each shape (f32 tol 1e-5, bf16 tol 2e-2)
   and times kernel, plain version and ``torch.nn.functional.rms_norm``
   (a yardstick the port never calls);
4. goldens: the four open-loop golden points of
   ``tests/test_golden_metrics.py`` through ``run_sweep_batched`` on the
   card, held against ``tests/goldens/*.json`` (integers exact, floats
   rel 1e-6);
5. fig2 at paper width: substrate, interposer and wireless 4C4M, load 1.0,
   2 000 cycles with 500 of warm-up (the paper's 10 000 cut for this
   script's time limit), in one batched call, with the
   kernel launch counts set to 0 before and read after; held against
   ``tests/torch_fixtures/fig2_reference.json`` (written by the JAX
   package) under the same bounds;
6. flash attention, two kernels chosen by ``flash_attention.route``: the
   tensor-core kernel (bf16, hd 64-256) and the CUDA-core kernel (the
   rest).  Drives ``ops.flash_attention`` on each route with the counts
   set to 0; holds each case against ``ref.attention_ref`` at the cases
   of ``tests/test_kernels_flash.py`` (f32 2e-5, bf16 2e-2) and at the
   shapes of the model path (granite-8b, gemma-7b's hd 256, hymba-1.5b's
   window, mixtral-8x22b, Sq != Skv with ``q_offset``; bf16 1e-3 + 2^-7
   |o|, and granite and gemma in f32 at 2e-5), each case naming its route
   and moving its route's count by one; times at the bf16 path shapes of
   the tensor-core kernel and of the CUDA-core kernel through its own
   entry point, and at granite-8b's, hymba-1.5b's and mixtral-8x22b's
   shapes also of the plain version and ``scaled_dot_product_attention``
   (a yardstick the port never calls; hymba's window as a mask) with the
   name of the kernel SDPA ran;
   the CUDA-core kernel, its plain version and SDPA on granite-8b's f32
   inputs;
7. SSD, two kernels chosen by ``ssd_scan.route``: the tensor-core kernel
   (bf16 x, B, C, Q 64-256, even P; x by TMA where P % 16 == 0, else by
   the threads) and the CUDA-core kernel (the rest).  The
   CUDA-core kernel against ``ref.ssd_intra_chunk_ref`` at the cases of
   ``tests/test_kernels_ssd.py`` (f32 1e-4, bf16 5e-2) and at mamba2-1.3b's
   f32 cell, where ``ops.ssd`` whole (one launch) is held against its
   plain composition on the CPU (2e-4); times of the kernel, its plain
   version, ``ops.ssd`` and ``ops.ssd`` composed with the plain version.
   The tensor-core kernel at bf16 cases of (Q, P, N) with ragged chunks
   and heads and B, C by group (``heads`` 1, 8, 64), P not a multiple of
   16 (24, 50, 100, 130, 200, 250: x by the threads, one to four boxes, Q
   64 to 256), and at mamba2-1.3b's shape (B 2 x 64 heads, 32 chunks of
   128, P 64, N 128), each held to 1e-4 of each output's largest entry
   and, with the scores rounded to bf16 as the model path asks, to 2^-7
   (a flipped rounding of one score), each launch moving its route's
   count by one; times at the model's shape, scores rounded, of
   the tensor-core kernel, the CUDA-core kernel through its own entry
   point and the plain version, with the bound and the share of it; the
   same at hymba-1.5b's forward cell (B 2 x 64 heads of P 50, N 16: x by
   the threads), held at 1e-4 with f32 scores and 2^-7 with rounded ones;
8. granite-8b at full width and 2 layers against
   ``tests/torch_fixtures/granite8b_2l_reference.json`` (written by the JAX
   package with the same ``carry.numpy_params`` weights): ``Model.loss``
   with ``impl="pallas"`` (2 tensor-core kernel launches), the forward's
   top-5 logits
   at 8 positions, and a greedy ``Engine`` run, teacher-forced on the
   reference's tick inputs;
9. granite-8b at full size (36 layers, seeded weights on the card):
   ``Model.loss`` at B 2 x S 4096 with ``impl="pallas"`` (36 launches of
   the tensor-core kernel)
   against ``impl="naive"``, loss and whole logit rows at 8 positions of
   each sequence, then ``launch/serve.py``'s engine serving 8 requests on
   4 slots (no kernel launch, as in the reference).

10. mamba2-1.3b at full width and 2 layers against
    ``tests/torch_fixtures/mamba2_2l_reference.json`` (the JAX package op
    by op, same ``carry.numpy_params`` weights): ``Model.loss`` with
    ``impl="pallas"`` (2 tensor-core SSD launches), the forward's top-5
    logits at 8 positions across the chunk edges, and a greedy ``Engine``
    run teacher-forced on the reference's tick inputs (f32 SSM state);
11. mamba2-1.3b at full size (48 layers, seeded weights on the card):
    ``Model.loss`` at B 2 x S 4096 with ``impl="pallas"`` (48 launches of
    the tensor-core SSD kernel, none of any other kernel) against
    ``impl="naive"``: the loss, and every layer's output on naive's
    residual stream (at random weights these 48 layers move the logits by
    their whole scale for a one-ulp change of one input, which the phase
    measures and prints, so whole logit rows are reported, not held);
    the same forward timed with the CUDA-core SSD kernel forced in
    through its own entry point (the two routes in turns: kernel,
    forced, forced, kernel); then ``launch/serve.py``'s engine
    serving 8 requests on 4 slots (no kernel launch);
12. fig8 at paper width: the grid of ``benchmarks/fig8_memory.py``
    (closed-loop memory on 4C4M's three fabrics at loads 0.05-1.0 with
    windows 4 and 16, and canneal closed-loop; 32 points, 2 000 cycles
    with 500 of warm-up, fig8's 6 000 cut for this script's time limit)
    in one ``run_sweep_batched`` call, held against
    ``tests/torch_fixtures/fig8_reference.json`` (every ``Metrics``
    field: integers exact, floats rel 1e-6), with fig8's own checks (the
    in-flight count never exceeds the window; AMAT grows with load);
13. the closed-loop golden ``memcl_wireless_4c4m_load03`` against
    ``tests/goldens`` (the memory fields too);
14. fig7 at paper size: the gemma-7b one-shot and the compiled psum
    traces of ``benchmarks/fig7_ml_traces.py`` (16 devices on 4C4M, the
    psum step's HLO text from ``tests/torch_fixtures/fig7_psum.hlo.txt``)
    on three fabrics (the one-shot trace on two: its substrate lane
    drains last, at 11 008 cycles, where the others drain by 3 840, and
    the interposer lane runs the same wireline program), a 96 000-cycle
    budget with early drain, in one call, held against
    ``tests/torch_fixtures/fig7_reference.json`` (``drain_cycle``,
    ``phase_end`` and the air counters included); every trace completes
    and the cycle-vs-analytic link energy is within 2x.  fig7's three
    synthetic ring traces drain only after 63 488-78 848 cycles and are
    left, with the one-shot substrate lane, to
    ``benchmarks_torch/fig7_traces.py``;
15. fig9 at paper size, the lossy and living PHY: the quality grid of
    ``benchmarks/fig9_lossy_channel.py`` (link budgets 13-26 dB x
    adaptive/fixed:0/fixed:-1 x three fabrics, 4C4M at load 0.5, 6 000
    cycles with 1 000 of warm-up: 54 points in two batches, the ARQ
    program and the ideal one), its drift sweep (0/2/4/6 dB x online,
    static, fixed:0, fixed:-1 at 19 dB: 16 points in four batches, one per
    static flag set) and its one-shot all-reduce at 22 dB (8 000 cycles),
    plus a small drop-heavy multicast trace and a short-birth living point
    whose window boundaries are replayed after it drains; every point held
    against ``tests/torch_fixtures/fig9_reference.json`` (every
    ``Metrics`` field), fig9's hard checks (adaptive air efficiency >=
    0.98x each fixed policy at every budget, adaptive aggregate goodput,
    wireline bit-identical across policies, online >= static >= fixed:0
    and online >= every fixed under drift, the trace complete with nothing
    dropped), and the drifted PER tables and re-selected rates of every
    window of the drift points.

16. hymba-1.5b at full width and 2 layers against
    ``tests/torch_fixtures/hymba1p5b_2l_reference.json`` (the JAX package
    op by op; ``carry.numpy_params`` weights with the norm weights drawn
    apart, ``ones_jitter``): ``Model.loss`` with ``impl="pallas"`` on a
    2560-token batch past the 2048-token window (2 launches of the
    tensor-core flash kernel, 2 of the tensor-core SSD kernel, x by the
    threads: hymba's SSM heads have P 50; none of the CUDA-core SSD
    kernel), the top-5 logits at 10 positions across chunk edges
    and past the window, and the greedy engine; faults: the heads summed
    rather than averaged, the SSM heads normed with ``ln1``;
17. hymba-1.5b at full size (32 layers): the forward at B 2 x S 4096
    (32 tensor-core flash launches with the window, 32 tensor-core SSD
    launches, no CUDA-core SSD launch) against ``impl="naive"`` layer by
    layer, as phase 11, the logit rows and the one-ulp sensitivity
    reported; the same forward timed with the CUDA-core SSD kernel forced
    in through its own entry point, as phase 11; serving as phase 9;
    faults: ``y_diag`` zeroed, keys 128 back dropped;
18. mixtral-8x22b at full width and 2 layers against
    ``tests/torch_fixtures/mixtral8x22b_2l_reference.json``: the loss, the
    top-5 logits, the port's dispatch on the reference's router
    probabilities of each layer (every one of the 512 tokens' top-2
    experts and every assignment dropped for capacity, exactly), the
    port's own router probabilities (2^-5 of each token's largest; the
    tokens this moves to another expert are reported) and the greedy
    engine; faults: top-k ties broken toward the higher expert, capacity
    + 1; ``torch.topk`` in place of the stable sort is reported;
19. mixtral-8x22b at full width and 8 of its 56 layers (one 80 GB card):
    the forward (8 tensor-core flash launches) against ``impl="naive"``
    layer by layer (a one-ulp change can move a token to another expert),
    serving; faults as phase 9;
20. the scatter engine (``core/simulator_ref.py``) against the gather
    engine on the card: ten cases of 200 cycles (substrate, interposer and
    wireless 4C4M under uniform traffic, the matching and single media,
    the token MAC, closed-loop memory, fig9's small multicast trace, the
    lossy channel at 16 dB, a living channel), every state leaf equal but
    the engines' own encodings; each engine's host ms a cycle, and CUDA
    kernels a step call on each program (the driver's left out); faults:
    masked scatter writes clamped into the table instead
    of dropped, the reply birth's minimum into ``rdy`` taken as a maximum;
21. fig2-fig6 and the ablations (``benchmarks/fig2_uniform.py`` to
    ``ablations.py``: 67 points in the scripts' ``run_sweep_batched``
    calls, the WI-density points through the raw API) at 500 cycles
    with 100 of warm-up, the paper's 10 000 cut for this script's time
    limit, against ``tests/torch_fixtures/paper_figs_reference.json``'s
    ``cut`` set: every ``Metrics`` field, every ``*.check`` row's truth
    value and every derived gain or reduction (rel 1e-6); faults as extra
    points: one interposer link a pair where the fixture has two, WI
    clusters of 8 cores where it has 16.  ``benchmarks_torch/
    paper_figs.py`` runs the same phase at paper size.

Phases 12-14 each plant two faults that their checks must reject: as
extra lanes of the same call, tables packed with the bank service one
cycle longer, the window one wider, a request's birth one cycle early,
or the first trace phase closing one ejection early; and a rerun of the
one-shot wireless point with multicast transmit energy counted per copy.
Phase 15 plants four: ``max_retx`` one higher on the 13 dB fixed:0
wireless point (an extra lane), and, in reruns of the small trace or the
living point, broadcast ARQ anchored on the best member link
(``simulator._group_link`` swapped), the drift walk's seed xored with
another constant and the chunked driver's window replay skipped.
Each prints wall seconds, points/s, lane-cycles/s and the slowest lane's
``drain_cycle`` with the card's name and power limit, and reads every
kernel's launch count after its run (no kernel of this repository runs
on the simulator).

Phases 8 and 9 also plant two faults in the flash entry point (output
zeroed; keys 128 and more back dropped), phases 10 and 11 two in the SSD
intra-chunk entry point (``y_diag`` zeroed; the decay dropped, L = 1 on
the lower triangle), and fail unless their logit checks reject each.
Each path is driven with every kernel's launch count set to 0 just before
and read just after.  It prints the card's name and power limit and a JSON line of kernel
numbers, and as its last line ``{"ok": true, "device": {...}}``.  Without
a CUDA device, or without the rest of the repository, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12            # f32 outside the tensor cores
H100_BF16_FLOPS = 989e12          # bf16 tensor cores, dense
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


FLASH_CASES = [   # tests/test_kernels_flash.py
    # (B, Sq, Skv, H, Hkv, hd, causal, window, dtype name, tol)
    (1, 128, 128, 2, 2, 64, True, 0, "float32", 2e-5),
    (2, 256, 256, 4, 2, 64, True, 0, "float32", 2e-5),
    (1, 128, 128, 4, 1, 32, True, 0, "float32", 2e-5),
    (1, 256, 256, 2, 2, 64, True, 64, "float32", 2e-5),
    (1, 128, 128, 2, 2, 64, False, 0, "float32", 2e-5),
    (1, 200, 200, 2, 2, 64, True, 0, "float32", 2e-5),
    (1, 128, 128, 2, 2, 128, True, 0, "bfloat16", 2e-2),
    (1, 64, 256, 2, 2, 64, True, 0, "float32", 2e-5),
]
# Shapes of the model path.  With randn inputs at S 4096 the outputs are
# small (mean |o| ~0.02-0.04), so the test cases' bf16 2e-2 would be half an
# output.  Both the kernel and ``attention_ref`` compute in f32 and round
# once to bf16 at the end, so in bf16 they differ by at most one bf16 ulp
# (<= 2^-7 |o|) plus f32 summation order (~1e-6): held to 1e-3 + 2^-7 |o|.
# The f32 runs of the granite-8b and gemma-7b shapes (hd 128 and 256, the
# versions the models run) are held to the test cases' 2e-5.
FLASH_PATH = {    # (B, Sq, Skv, H, Hkv, hd, causal, window, dtype name)
    "granite-8b": (2, 4096, 4096, 32, 8, 128, True, 0, "bfloat16"),
    "gemma-7b": (1, 4096, 4096, 16, 16, 256, True, 0, "bfloat16"),
    "hymba-1.5b": (2, 4096, 4096, 25, 5, 64, True, 2048, "bfloat16"),
    "mixtral-8x22b": (2, 4096, 4096, 48, 8, 128, True, 0, "bfloat16"),
    "granite-8b q_offset": (1, 1024, 4096, 32, 8, 128, True, 0, "bfloat16"),
    "granite-8b f32": (2, 4096, 4096, 32, 8, 128, True, 0, "float32"),
    "gemma-7b f32": (1, 4096, 4096, 16, 16, 256, True, 0, "float32"),
}
# the path shapes also timed against the plain version and SDPA
FLASH_LIBRARY = ("granite-8b", "hymba-1.5b", "mixtral-8x22b")
FLASH_PATH_TOL = {"bfloat16": (1e-3, 2.0 ** -7), "float32": (2e-5, 2e-5)}
SSD_CASES = [     # tests/test_kernels_ssd.py: (BH, c, Q, P, N, dtype, tol)
    (2, 2, 16, 8, 16, "float32", 1e-4),
    (4, 4, 32, 16, 32, "float32", 1e-4),
    (1, 1, 64, 64, 128, "float32", 1e-4),
    (2, 2, 16, 8, 16, "bfloat16", 5e-2),
]
MAMBA = dict(b=1, l=4096, h=64, p=64, n=128, chunk=128)   # mamba2-1.3b
# the tensor-core SSD kernel: (groups, heads, chunks, Q, P, N), bf16 x/B/C
SSD_TC_CASES = [
    (3, 1, 5, 64, 64, 64),
    (2, 8, 3, 128, 64, 128),
    (1, 64, 2, 128, 128, 256),
    (3, 8, 1, 256, 64, 128),
    (1, 64, 3, 128, 64, 128),
    # P not a multiple of 16: x loaded by the threads, not TMA
    (2, 64, 2, 128, 50, 16),
    (1, 8, 3, 64, 24, 16),
    (3, 2, 2, 128, 100, 32),
    (1, 2, 1, 256, 130, 16),
    (1, 4, 2, 256, 250, 32),
    (1, 2, 1, 128, 200, 16),
]
SSD_TC_PATH = (2, 64, 32, 128, 64, 128)    # mamba2-1.3b forward, B 2 x 4096
SSD_HYMBA_PATH = (2, 64, 32, 128, 50, 16)  # hymba-1.5b forward, B 2 x 4096
SSD_TC_TOL = 1e-4                          # of each output's largest entry
# With the scores rounded to bf16 (the model path), kernel and plain
# version each round their own f32 sums: where those differ in the last
# place a score rounds to the neighbouring bf16 value, moving a y entry by
# 2^-8 of one term (measured 1.7e-4 of the largest entry at the model's
# shape).  Held to 2^-7 of each output's largest entry, as ops.ssd's
# bf16-rounded states are.
SSD_TC_ROUNDED_TOL = 2.0 ** -7
# mixtral-8x22b's depth on one 80 GB card: 8 of 56 layers (~40 GB of
# weights; each layer's experts alone are ~4.8 GB)
MIXTRAL_LAYERS = 8
GRANITE_LOSS_RTOL = 1e-3     # 2 layers, port on the card vs JAX on the CPU
FULL_LOSS_RTOL = 1e-3        # pallas (f32 softmax) vs naive (bf16 p)
# Logits, relative to the largest reference logit.  The loss of random
# weights sits near ln(vocab) whatever attention does, so the forward is
# also held by its logits, which attention determines.  2 layers (port vs
# JAX, top-5 at the fixture's positions, and decode): 2^-5, eight bf16 ulps
# at the top binade, for flipped roundings of bf16 activations.
LOGIT_REL = 2.0 ** -5
# 36 layers, ``impl="pallas"`` vs ``"naive"`` (bf16 scores and p) over whole
# logit rows: the flips compound over the layers; 2^-4.
FULL_LOGIT_REL = 2.0 ** -4
POSITIONS_FULL = [0, 1, 63, 64, 2047, 2048, 4000, 4095]
POSITIONS_MAMBA = [0, 1, 127, 128, 2047, 2048, 4000, 4095]   # chunk edges


@contextlib.contextmanager
def swapped(obj, name: str, value):
    """``obj.name = value`` (``obj[name]`` for a dict) inside the block: a
    kernel's plain version in its caller, or a fault planted to show that
    a check sees it."""
    get, put = ((obj.__getitem__, obj.__setitem__) if isinstance(obj, dict)
                else (lambda n: getattr(obj, n),
                      lambda n, v: setattr(obj, n, v)))
    old = get(name)
    put(name, value)
    try:
        yield
    finally:
        put(name, old)


def logits_at(model, params, tokens, positions):
    """``lm_loss``'s logits at ``positions`` of every row, over the real
    vocabulary (not the padded rows ``lm_loss`` masks with -1e30): f32
    [B*P, vocab]."""
    from repro_torch.models import transformer as tf
    h = tf.lm_hidden(model.cfg, params, tokens, impl=model.impl)
    lg = tf.lm_logits(model.cfg, params, h[:, positions]).float()
    return lg[..., :model.cfg.vocab].reshape(-1, model.cfg.vocab)


def flash_faults(ops) -> dict:
    """Faults in ``ops.flash_attention``: its output zeroed; the keys 128
    and more behind each query dropped, as a kernel that lost tiles
    would."""
    import torch
    real = ops.flash_attention
    return {
        "output zeroed": (ops, "flash_attention",
                          lambda q, k, v, **kw: torch.zeros_like(q)),
        "keys 128 back dropped": (ops, "flash_attention",
                                  lambda q, k, v, **kw: real(
                                      q, k, v, causal=True, window=128)),
    }


def ssd_faults(ssd_scan) -> dict:
    """Faults in ``ssd_scan.ssd_intra_chunk``: ``y_diag`` zeroed; the decay
    dropped (A = 0: L = 1 on the lower triangle, and no decay of the chunk
    states), as a kernel that lost its decay would."""
    import torch
    real = ssd_scan.ssd_intra_chunk

    def zeroed(*a, **kw):
        y, st, dc = real(*a, **kw)
        return torch.zeros_like(y), st, dc

    def no_decay(x, dt, A, B, C, **kw):
        return real(x, dt, torch.zeros_like(A), B, C, **kw)

    return {"y_diag zeroed": (ssd_scan, "ssd_intra_chunk", zeroed),
            "decay dropped": (ssd_scan, "ssd_intra_chunk", no_decay)}


def planted_faults(faults: dict, model, params, batch, measure,
                   limit: float) -> dict:
    """Run the check ``measure() <= limit`` again with each fault of
    ``faults`` (``{name: (obj, attribute, fake)}``) planted in turn, and
    require it to reject each.  Returns each fault's error and loss."""
    import torch
    out = {}
    for name, (obj, attr, fake) in faults.items():
        with swapped(obj, attr, fake), torch.no_grad():
            err = measure()
            loss = float(model.loss(params, batch))
        if not err > limit:
            raise AssertionError(f"fault '{name}' passes the check: "
                                 f"{err} <= {limit}")
        out[name] = dict(err=err, loss=loss)
    return out


def layer_errors(model, params, tokens) -> list:
    """Each layer's sequence mixer (``transformer.mixer``: attention, SSM,
    or both) with ``impl="pallas"`` against ``impl="naive"`` on the same
    input: the residual stream of the naive forward.  Returns each layer's
    max abs difference of the mixer's output over naive's largest entry."""
    import torch
    from repro_torch.models import transformer as tf
    cfg = model.cfg
    x = tf.embed(params["embed"], tokens).to(torch.bfloat16)
    pos = torch.arange(x.shape[1], device=x.device)
    errs = []
    with torch.no_grad():
        for i in range(cfg.n_layers):
            lp = tf.layer_params(params["layers"], i)
            want, got = (tf.mixer(cfg, x, lp, positions=pos, causal=True,
                                  impl=impl) for impl in ("naive", "pallas"))
            want = want.float()
            errs.append(float((got.float() - want).abs().max()
                              / want.abs().max()))
            x = x + want.to(x.dtype)
            if "ffn" in lp:
                x = x + tf.ffn(cfg, x, lp)
    return errs


@contextlib.contextmanager
def moe_routing():
    """Every MoE layer call inside the block: its router probabilities
    and top-k experts, from wrapped ``moe.top_k`` and ``moe.dispatch_plan``
    (``{"probs": [T, E], "experts": [T, k]}`` per call)."""
    from repro_torch.models import moe
    calls = []
    real_top_k, real_plan = moe.top_k, moe.dispatch_plan

    def top_k(probs, k):
        calls.append({"probs": probs})
        return real_top_k(probs, k)

    def plan(experts, n_experts, cap):
        calls[-1]["experts"] = experts
        return real_plan(experts, n_experts, cap)

    with swapped(moe, "top_k", top_k), swapped(moe, "dispatch_plan", plan):
        yield calls


def dispatch_mismatches(cfg, routing: list, dev) -> int:
    """The port's dispatch (``moe.top_k``, ``moe.capacity``,
    ``moe.dispatch_plan``) applied to the reference's own router
    probabilities of each layer: tokens whose top-k experts differ from
    the reference's, plus dropped assignments in one list but not the
    other.  An integer function of the probabilities, held exactly."""
    import numpy as np
    import torch
    from repro_torch.models import moe
    n = 0
    for w in routing:
        probs = torch.tensor(w["probs"], dtype=torch.float32, device=dev)
        _, experts = moe.top_k(probs, cfg.top_k)
        plan = moe.dispatch_plan(experts, cfg.n_experts,
                                 moe.capacity(cfg, probs.shape[0]))
        n += int((experts.cpu().numpy() != np.array(w["experts"]))
                 .any(-1).sum())
        got = {tuple(r) for r in moe.dropped(plan).cpu().tolist()}
        n += len(got ^ {tuple(r) for r in w["dropped"]})
    return n


def own_routing(calls, routing: list) -> dict:
    """The port's own forward against the reference's routing, layer by
    layer: the router probabilities' largest deviation relative to each
    token's largest probability, and the tokens whose top-k experts
    differ.  Only the first layer's probabilities can be held (to
    ``LOGIT_REL``): its router reads the attention output of the same
    embeddings, and its bf16 logits round the other way only where two
    summation orders differ, so a token changes experts only at a near
    tie; from the second layer on, a token that changed experts, or that
    an expert's queue dropped in its place, carries an O(1) different
    input, which the later deviations report."""
    import numpy as np
    if len(calls) != len(routing):
        return dict(prob_rel_err=[math.inf], tokens_rerouted=[-1])
    errs, moved = [], []
    for c, w in zip(calls, routing):
        got, want = c["probs"].float().cpu().numpy(), np.array(w["probs"])
        errs.append(float((np.abs(got - want).max(1) / want.max(1)).max()))
        moved.append(int((c["experts"].cpu().numpy()
                          != np.array(w["experts"])).any(-1).sum()))
    return dict(prob_rel_err=errs, tokens_rerouted=moved)


def moe_faults(moe) -> dict:
    """Faults in the MoE layer: top-k ties broken toward the higher expert
    (the order ``torch.topk`` does not promise), and one more slot per
    expert than the reference's capacity."""
    real_top_k, real_cap = moe.top_k, moe.capacity

    def higher_first(probs, k):
        vals, idx = real_top_k(probs.flip(-1), k)
        return vals, probs.shape[-1] - 1 - idx

    return {"ties to the higher expert": (moe, "top_k", higher_first),
            "capacity + 1": (moe, "capacity",
                             lambda cfg, T: real_cap(cfg, T) + 1)}


def cuda_core_ssd(ssd_scan) -> tuple:
    """``phase_full``'s ``forced``: the CUDA-core SSD kernel through its
    own entry point in place of ``ssd_scan.ssd_intra_chunk``."""
    import torch

    def fn(x, dt, A, B, C, **kw):
        BH, c, Q, P = x.shape
        outs = tuple(torch.empty(s, device=x.device) for s in (
            (BH, c, Q, P), (BH, c, P, B.shape[-1]), (BH, c)))
        ssd_scan.launch_route("cuda_core", x, dt, A, B, C, *outs, **kw)
        return outs

    return ("cuda_core_ssd", ssd_scan, "ssd_intra_chunk", fn)


def hybrid_faults(tf, params) -> dict:
    """Faults in the hybrid layer: the heads summed rather than averaged,
    and the SSM heads normed with ``ln1`` rather than ``ln_ssm`` (their
    weights differ in a fixture drawn with ``ones_jitter``)."""
    return {"heads summed": (tf, "mix_heads", lambda a, s: a + s),
            "ln1 for the SSM heads": (params["layers"], "ln_ssm",
                                      params["layers"]["ln1"])}


FLASH_TC = ("flash_attention_tc", "flash_attention")   # the count of
SSD_TC = ("ssd_scan_tc", "ssd_scan")    # a tensor-core route, and of both


def per_layer(n: int, *kernels) -> dict:
    """Expected launch counts: ``n`` for each count named."""
    return {k: n for k in kernels}


def expect_counts(tag: str, got: dict, want: dict) -> None:
    """Every count as ``want`` says, every other count 0."""
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"{tag} launched {got}, want {full}")


def counts(kmods) -> dict:
    """Every kernel's launch count; ``flash_attention`` and ``ssd_scan``
    count both of their routes, ``*_tc`` the tensor-core route alone."""
    out = {k: m.launches for k, m in kmods.items()}
    out["flash_attention_tc"] = kmods["flash_attention"].tc_launches
    out["ssd_scan_tc"] = kmods["ssd_scan"].tc_launches
    return out


def zero(kmods) -> None:
    import torch
    torch.cuda.synchronize()
    for m in kmods.values():
        m.launches = 0
    kmods["flash_attention"].tc_launches = 0
    kmods["ssd_scan"].tc_launches = 0


def build_report(_build, logs: dict) -> None:
    """ptxas's lines for each kernel (registers, spills, warnings) and the
    tensor-core kernels' shared memory; fails on a spill in either
    tensor-core kernel (every instance of the SSD one: P boxes 1-4, x by
    TMA or by the threads, each of which must be reported) or on
    ``setmaxnreg`` ignored (C7508)."""
    import ctypes
    import re
    for k, log in logs.items():
        entry, seen = "", set()
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = re.sub(r"^_ZN\d+_GLOBAL__N__\w*?_cu_[0-9a-f]+\d+",
                               "", m.group(1)).split("EE")[0][:32]
                inst = re.search(r"ssd_intra_tcILi(\d)ELb([01])", entry)
                if inst:
                    how = {"1": "TMA", "0": "threads"}[inst.group(2)]
                    entry = f"ssd_intra_tc<PB {inst.group(1)}, x by {how}>"
            if any(w in line for w in ("registers", "spill", "error",
                                       "warning", "C7508")):
                say("build", f"{k} {entry}: {line.strip()}")
                if "registers" in line:
                    seen.add(entry)
        if k in ("flash_attention_tc", "ssd_scan_tc") and (
                "C7508" in log or re.search(r"[1-9]\d* bytes spill", log)):
            raise AssertionError(f"{k}: ptxas spills or ignores "
                                 f"setmaxnreg:\n{log}")
        want = {f"ssd_intra_tc<PB {pb}, x by {how}>" for pb in range(1, 5)
                for how in ("TMA", "threads")}
        if k == "ssd_scan_tc" and log and not want <= seen:
            raise AssertionError(f"ssd_scan_tc: ptxas reported no registers "
                                 f"for {sorted(want - seen)}:\n{log}")
    fn = _build.load("flash_attention_tc").flash_attention_tc_smem
    fn.argtypes, fn.restype = [ctypes.c_int64], ctypes.c_int
    say("build", "flash_attention_tc dynamic shared memory (bytes by head "
        f"dim): {json.dumps({hd: fn(hd) for hd in (64, 128, 192, 256)})}")
    from repro_torch.kernels import ssd_scan
    shapes = sorted({c[3:] for c in SSD_TC_CASES}
                    | {SSD_TC_PATH[3:], SSD_HYMBA_PATH[3:]})
    say("build", "ssd_scan_tc dynamic shared memory (bytes by Q, P, N): "
        + json.dumps({str(q): ssd_scan.smem_bytes("tensor_core", *q)
                      for q in shapes}))
    q = SSD_HYMBA_PATH[3:]
    say("build", f"ssd_scan (CUDA cores) dynamic shared memory at hymba's "
        f"(Q, P, N) {q}: {ssd_scan.smem_bytes('cuda_core', *q)} bytes")


def top_kernel(fn) -> str:
    """The name of the CUDA kernel that takes the most time in one call
    of ``fn`` (which backend a library call chose), from
    ``torch.profiler``."""
    import torch
    cuda = torch.profiler.ProfilerActivity.CUDA
    for _ in range(2):           # a trace has come back empty once in three
        with torch.profiler.profile(activities=[cuda]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if evs:
            return max(evs,
                       key=lambda e: e.time_range.elapsed_us()).name[:160]
    return "not measured (the profiler saw no CUDA kernel)"


def attention_pairs(Sq, Skv, causal, window, q_offset) -> int:
    """Unmasked (query, key) pairs: the work the masks leave."""
    import numpy as np
    qpos = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(qpos, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(Sq,
                                                                   np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def bound(nbytes: float, flops: float, rate: float) -> tuple:
    tb, tf = nbytes / H100_BYTES_PER_S, flops / rate
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def phase_flash(dev, flash_attention, ops, ref, kmods) -> tuple:
    """Returns the closing line's entries of the tensor-core kernel and of
    the CUDA-core kernel."""
    import torch
    import torch.nn.functional as F
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gen = torch.Generator(device=dev).manual_seed(1)

    def qkv(B, Sq, Skv, H, Hkv, hd, dtype):
        mk = lambda *s: torch.randn(s, generator=gen, device=dev  # noqa
                                    ).to(dt[dtype])
        return mk(B * H, Sq, hd), mk(B * Hkv, Skv, hd), mk(B * Hkv, Skv, hd)

    # each route's own path: the public entry point at granite-8b's shape,
    # [B, S, H, hd] in the model's layout, bf16 then f32
    B, S, H, Hkv, hd = 2, 4096, 32, 8, 128
    paths = {}
    for dtype in ("bfloat16", "float32"):
        q, k, v = (t.view(B, -1, S, hd).transpose(1, 2)
                   for t in qkv(B, S, S, H, Hkv, hd, dtype))
        zero(kmods)
        ops.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        paths[dtype] = counts(kmods)
        del q, k, v
    if paths["bfloat16"]["flash_attention_tc"] != 1 \
            or paths["float32"]["flash_attention_tc"] \
            or paths["float32"]["flash_attention"] != 1:
        raise AssertionError(f"ops.flash_attention launched {paths}; want "
                             "the tensor-core kernel for bf16, the "
                             "CUDA-core kernel for f32")
    say("flash", f"ops.flash_attention path at granite-8b's shape: {paths}")

    cases = [(f"test {i}", c[:-1], (c[-1], c[-1]))
             for i, c in enumerate(FLASH_CASES)] \
        + [(tag, c, FLASH_PATH_TOL[c[-1]]) for tag, c in FLASH_PATH.items()]
    rows = []
    for tag, (B, Sq, Skv, H, Hkv, hd, causal, window, dtype), (atol, rtol) \
            in cases:
        q, k, v = qkv(B, Sq, Skv, H, Hkv, hd, dtype)
        q_offset = Skv - Sq
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        route = flash_attention.route(q.dtype, hd)
        before = (flash_attention.launches, flash_attention.tc_launches)
        got = flash_attention.flash_attention_bhsd(q, k, v, **kw)
        want = ref.attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        moved = (flash_attention.launches - before[0],
                 flash_attention.tc_launches - before[1])
        if moved != (1, int(route == "tensor_core")):
            raise AssertionError(f"flash {tag}: route {route}, counts moved "
                                 f"by {moved}")
        d = (got.float() - want.float()).abs()
        err = float(d.max())
        if not bool((d <= atol + rtol * want.float().abs()).all()):
            raise AssertionError(f"flash {tag} ({route}): max abs err {err} "
                                 f"beyond {atol} + {rtol} |want|")
        rec = dict(case=tag, route=route, B=B, Sq=Sq, Skv=Skv, H=H, Hkv=Hkv,
                   hd=hd, causal=causal, window=window, q_offset=q_offset,
                   dtype=dtype, max_abs_err=err, atol=atol, rtol=rtol,
                   mean_abs_want=float(want.float().abs().mean()))
        if tag in FLASH_PATH:
            pairs = attention_pairs(Sq, Skv, causal, window, q_offset)
            flops = 4.0 * hd * B * H * pairs
            nbytes = (2 * q.numel() + k.numel() + v.numel()) \
                * q.element_size()
            rate = H100_BF16_FLOPS if dtype == "bfloat16" else H100_F32_FLOPS
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, rate)
            rec["gflop"] = flops / 1e9
        if tag in FLASH_PATH and (dtype == "bfloat16"
                                  or tag == "granite-8b f32"):
            o = torch.empty_like(q)
            rec["ms"] = time_ms(lambda: flash_attention.flash_attention_bhsd(
                q, k, v, **kw), iters=10)
            if route == "tensor_core":
                # the CUDA-core kernel on the same bf16 inputs, through its
                # own entry point
                rec["cuda_core_ms"] = time_ms(
                    lambda: flash_attention.launch_route(
                        "cuda_core", q, k, v, o, **kw), iters=3)
            if not q_offset and tag.split()[0] in FLASH_LIBRARY:
                rec["plain_ms"] = time_ms(lambda: ref.attention_ref(
                    q, k, v, **kw), iters=3)
                q4, k4, v4 = (t.view(B, -1, t.shape[1], hd)
                              for t in (q, k, v))
                mask = None
                if window:          # SDPA takes a window only as a mask
                    pos = torch.arange(Sq, device=dev)
                    mask = (pos[None] <= pos[:, None]) \
                        & (pos[None] > pos[:, None] - window)

                def library():
                    return F.scaled_dot_product_attention(
                        q4, k4, v4, attn_mask=mask,
                        is_causal=causal and mask is None, enable_gqa=True)

                rec["library_ms"] = time_ms(library, iters=10)
                rec["library_kernel"] = top_kernel(library)
            rec["tflops"] = flops / rec["ms"] / 1e9
            rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        rows.append(rec)
        say("flash", json.dumps(rec))
        del q, k, v, got, want, d
    entries = []
    for name, src, tag, dtype in (
            ("flash_attention_tc", "flash_attention_tc.cu", "granite-8b",
             "bfloat16"),
            ("flash_attention", "flash_attention.cu", "granite-8b f32",
             "float32")):
        head = next(r for r in rows if r["case"] == tag)
        entries.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}",
            replaces="src/repro/kernels/flash_attention.py:71",
            launches=paths[dtype][name], path=f"ops.flash_attention, "
            f"{dtype} at granite-8b's shape", max_abs_err=head["max_abs_err"],
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], shape=[2, 4096, 32, 8, 128],
            dtype=dtype))
    entries[0]["per_case"] = rows
    return tuple(entries)


def phase_ssd(dev, ssd_scan, ops, ref, kmods) -> tuple:
    """Returns the closing line's entries of the tensor-core kernel (x by
    TMA, and x by the threads) and of the CUDA-core kernel."""
    import torch
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gen = torch.Generator(device=dev).manual_seed(2)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa

    def cell_inputs(BH, c, Q, P, N, dtype):
        return (rnd(BH, c, Q, P).to(dt[dtype]),
                torch.nn.functional.softplus(rnd(BH, c, Q)),
                -torch.exp(0.3 * rnd(BH)),
                rnd(BH, c, Q, N).to(dt[dtype]),
                rnd(BH, c, Q, N).to(dt[dtype]))

    def check(tag, args, tol, scaled=False, heads=1, round_scores=False):
        """Elementwise ``tol + tol * |want|``; ``scaled``: ``tol`` of each
        output's largest entry (large cells: the f32 error of sums of
        Q * N products grows with the outputs' size, not each entry's).
        The launch must move the count of the route ``route`` names, and
        only that."""
        name = ssd_scan.route(tuple(t.dtype for t in args), *args[0].shape[2:],
                              args[3].shape[-1])
        before = (ssd_scan.launches, ssd_scan.tc_launches)
        got = ssd_scan.ssd_intra_chunk(*args, heads=heads,
                                       round_scores=round_scores)
        want = plain(*args, heads=heads, round_scores=round_scores)
        torch.cuda.synchronize()
        moved = (ssd_scan.launches - before[0],
                 ssd_scan.tc_launches - before[1])
        if moved != (1, int(name == "tensor_core")):
            raise AssertionError(f"ssd {tag}: route {name}, counts moved "
                                 f"by {moved}")
        err = 0.0
        for g, w in zip(got, want):
            d = (g - w).abs()
            err = max(err, float(d.max()))
            lim = tol * w.abs().max() if scaled else tol + tol * w.abs()
            if not bool((d <= lim).all()):
                raise AssertionError(f"ssd {tag}: max abs err "
                                     f"{float(d.max())} beyond tol {tol}")
        return err

    def plain(x, dt, A, B, C, heads=1, round_scores=False):
        """The plain version of ``ssd_intra_chunk(..., heads=heads)``:
        B and C expanded per head, then ``ref.ssd_intra_chunk_ref``."""
        return ref.ssd_intra_chunk_ref(x, dt, A,
                                       B.repeat_interleave(heads, 0),
                                       C.repeat_interleave(heads, 0),
                                       round_scores=round_scores)

    for i, (BH, c, Q, P, N, dtype, tol) in enumerate(SSD_CASES):
        args = cell_inputs(BH, c, Q, P, N, dtype)
        err = check(f"test {i}", args, tol)
        say("ssd", json.dumps(dict(
            case=f"test {i}", route=ssd_scan.route(
                tuple(t.dtype for t in args), Q, P, N), BH=BH, c=c, Q=Q,
            P=P, N=N, dtype=dtype, max_abs_err=err, tol=tol)))

    m = MAMBA
    b, l, h, p, n, Q = m["b"], m["l"], m["h"], m["p"], m["n"], m["chunk"]
    x = 0.5 * rnd(b, l, h, p)
    dtv = torch.nn.functional.softplus(rnd(b, l, h))
    A = -torch.exp(0.2 * rnd(h))
    B = 0.3 * rnd(b, l, n)
    C = 0.3 * rnd(b, l, n)
    zero(kmods)
    y, st = ops.ssd(x, dtv, A, B, C, chunk=Q)
    torch.cuda.synchronize()
    path = counts(kmods)
    if path["ssd_scan"] != 1 or path["ssd_scan_tc"] \
            or path["flash_attention"] or path["rmsnorm"]:
        raise AssertionError(f"ops.ssd launched {path}, want one CUDA-core "
                             "ssd launch")
    # ops.ssd rounds the chunk states to bf16 (as the reference does), so
    # f32 differences of the two intra-chunk versions can flip a rounding:
    # one bf16 ulp of a state entry, carried on.  Held to 2^-7 of each
    # output's largest entry.
    y_c, st_c = ops.ssd(*(t.cpu() for t in (x, dtv, A, B, C)), chunk=Q)
    errs = {}
    for tag, g, w in (("y", y.cpu(), y_c), ("state", st.cpu(), st_c)):
        errs[tag] = (float((g - w).abs().max()), float(w.abs().max()))
        if errs[tag][0] > 2.0 ** -7 * errs[tag][1]:
            raise AssertionError(f"ops.ssd on the card vs its plain "
                                 f"composition: (max err, max |ref|) {errs}")
    say("ssd", f"ops.ssd at mamba2-1.3b's shape {m}: {path['ssd_scan']} "
        f"launch; vs plain composition (max abs err, max |ref|) {errs}")

    # the kernel alone at the cell shape ops.ssd gave it
    c = l // Q
    args = cell_inputs(b * h, c, Q, p, n, "float32")
    err = check("mamba2-1.3b cell", args, 1e-4, scaled=True)
    cells = b * h * c
    tri = Q * (Q + 1) // 2
    flops = 2.0 * cells * (tri * n + tri * p + Q * p * n)
    nbytes = sum(t.numel() * t.element_size() for t in args) \
        + 4 * cells * (Q * p + p * n + 1)
    bound_ms, bound_by = bound(nbytes, flops, H100_F32_FLOPS)
    rec = dict(case="mamba2-1.3b f32 cell", route="cuda_core", BH=b * h,
               c=c, Q=Q, P=p, N=n,
               dtype="float32", max_abs_err=err, bound_ms=bound_ms,
               bound_by=bound_by, gflop=flops / 1e9, mbytes=nbytes / 1e6,
               ms=time_ms(lambda: ssd_scan.ssd_intra_chunk(*args)),
               plain_ms=time_ms(lambda: ref.ssd_intra_chunk_ref(*args),
                                iters=5),
               ops_ssd_ms=time_ms(lambda: ops.ssd(x, dtv, A, B, C, chunk=Q),
                                  iters=5))
    # ``ops.ssd`` composed with the plain intra-chunk block, on the card
    with swapped(ssd_scan, "ssd_intra_chunk", ref.ssd_intra_chunk_ref):
        rec["ops_ssd_plain_ms"] = time_ms(
            lambda: ops.ssd(x, dtv, A, B, C, chunk=Q), iters=5)
    say("ssd", json.dumps(rec))
    mamba_f32_cell = rec

    # the tensor-core kernel: bf16 x, B, C by group, f32 dt and A
    def tc_inputs(G, heads, c, Q, P, N):
        x, dt_, A_, B_, C_ = cell_inputs(G * heads, c, Q, P, N, "bfloat16")
        return (x, dt_, A_, B_[:G].contiguous(), C_[:G].contiguous())

    for G, heads, c, Q, P, N in SSD_TC_CASES:
        args = tc_inputs(G, heads, c, Q, P, N)
        tag = f"tc G{G} heads{heads} c{c} Q{Q} P{P} N{N}"
        if ssd_scan.route(tuple(t.dtype for t in args), Q, P, N) \
                != "tensor_core":
            raise AssertionError(f"ssd {tag}: not on the tensor-core route")
        err = check(tag, args, SSD_TC_TOL, scaled=True, heads=heads)
        err_rounded = check(f"{tag} scores rounded", args,
                            SSD_TC_ROUNDED_TOL, scaled=True, heads=heads,
                            round_scores=True)
        say("ssd", json.dumps(dict(case=tag, route="tensor_core", BH=G * heads,
                                   c=c, Q=Q, P=P, N=N, heads=heads,
                                   dtype="bfloat16", max_abs_err=err,
                                   tol=f"{SSD_TC_TOL} x max|want|",
                                   max_abs_err_scores_rounded=err_rounded,
                                   tol_scores_rounded=f"{SSD_TC_ROUNDED_TOL}"
                                                      " x max|want|")))
    # the model's shape, in the Pallas kernel's arithmetic (f32 scores)
    # and in the model path's (scores rounded to bf16, as the reference's)
    G, heads, c, Q, P, N = SSD_TC_PATH
    args = tc_inputs(G, heads, c, Q, P, N)
    err_f32 = check("mamba2-1.3b forward cell, f32 scores", args, SSD_TC_TOL,
                    scaled=True, heads=heads)
    err = check("mamba2-1.3b forward cell", args, SSD_TC_ROUNDED_TOL,
                scaled=True, heads=heads, round_scores=True)
    cells = G * heads * c
    tri = Q * (Q + 1) // 2
    flops = 2.0 * cells * (tri * N + tri * P + Q * P * N)
    # each input read once at its dtype (B and C once per group), each
    # output written once
    nbytes = sum(t.numel() * t.element_size() for t in args) \
        + 4 * cells * (Q * P + P * N + 1)
    bound_ms, bound_by = bound(nbytes, flops, H100_BF16_FLOPS)
    outs = [torch.empty((cells // c, c, Q, P), device=dev),
            torch.empty((cells // c, c, P, N), device=dev),
            torch.empty((cells // c, c), device=dev)]
    kw = dict(heads=heads, round_scores=True)
    rec = dict(case="mamba2-1.3b forward cell", route="tensor_core",
               BH=G * heads, c=c, Q=Q, P=P, N=N, heads=heads,
               dtype="bfloat16", round_scores=True, max_abs_err=err,
               max_abs_err_f32_scores=err_f32, bound_ms=bound_ms,
               bound_by=bound_by, gflop=flops / 1e9, mbytes=nbytes / 1e6,
               ms=time_ms(lambda: ssd_scan.ssd_intra_chunk(*args, **kw)),
               cuda_core_ms=time_ms(lambda: ssd_scan.launch_route(
                   "cuda_core", *args, *outs, **kw), iters=5),
               plain_ms=time_ms(lambda: plain(*args, **kw), iters=5),
               power=nvidia_smi())
    rec["tflops"] = flops / rec["ms"] / 1e9
    rec["share_of_bound"] = bound_ms / rec["ms"]
    say("ssd", json.dumps(rec))

    tc = dict(name="ssd_intra_chunk_tc", route="cuda",
              source="src/repro_torch/kernels/csrc/ssd_scan_tc.cu",
              replaces="src/repro/kernels/ssd_scan.py:56", x_load="TMA",
              launches=None, max_abs_err=err, ms=rec["ms"],
              plain_ms=rec["plain_ms"], bound_ms=bound_ms,
              bound_by=bound_by, library_ms=None,
              cuda_core_ms=rec["cuda_core_ms"], shape=[G * heads, c, Q, P, N],
              heads=heads, dtype="bfloat16")
    # the same kernel with x loaded by the threads, on its main path:
    # hymba-1.5b's forward cell (B 2 x 64 heads of P 50, N 16, 32 chunks of
    # 128; bf16 x, B and C by group), in the Pallas kernel's arithmetic
    # (f32 scores) and the model path's (scores rounded to bf16), timed
    # beside the CUDA-core kernel through its own entry point and the
    # plain version
    G, heads, c, Q, P, N = SSD_HYMBA_PATH
    args = tc_inputs(G, heads, c, Q, P, N)
    if ssd_scan.route(tuple(t.dtype for t in args), Q, P, N) \
            != "tensor_core":
        raise AssertionError("ssd: hymba's cell is not on the tensor-core "
                             "route")
    kw = dict(heads=heads, round_scores=True)
    err_f32 = check("hymba-1.5b forward cell, f32 scores", args, SSD_TC_TOL,
                    scaled=True, heads=heads)
    err = check("hymba-1.5b forward cell", args, SSD_TC_ROUNDED_TOL,
                scaled=True, **kw)
    cells = G * heads * c
    tri = Q * (Q + 1) // 2
    flops = 2.0 * cells * (tri * N + tri * P + Q * P * N)
    nbytes = sum(t.numel() * t.element_size() for t in args) \
        + 4 * cells * (Q * P + P * N + 1)
    bound_ms, bound_by = bound(nbytes, flops, H100_BF16_FLOPS)
    outs = [torch.empty((cells // c, c, Q, P), device=dev),
            torch.empty((cells // c, c, P, N), device=dev),
            torch.empty((cells // c, c), device=dev)]
    hy = dict(case="hymba-1.5b forward cell", route="tensor_core",
              x_load="threads", BH=G * heads, c=c, Q=Q, P=P, N=N,
              heads=heads, dtype="bfloat16", round_scores=True,
              max_abs_err=err, max_abs_err_f32_scores=err_f32,
              tol=f"{SSD_TC_ROUNDED_TOL} (f32 scores {SSD_TC_TOL}) x "
                  "max|want|", bound_ms=bound_ms,
              bound_by=bound_by, gflop=flops / 1e9, mbytes=nbytes / 1e6,
              ms=time_ms(lambda: ssd_scan.ssd_intra_chunk(*args, **kw)),
              cuda_core_ms=time_ms(lambda: ssd_scan.launch_route(
                  "cuda_core", *args, *outs, **kw), iters=5),
              plain_ms=time_ms(lambda: plain(*args, **kw), iters=5))
    hy["ms_again"] = time_ms(lambda: ssd_scan.ssd_intra_chunk(*args, **kw))
    hy["power"] = nvidia_smi()
    hy["share_of_bound"] = bound_ms / hy["ms"]
    hy["cuda_core_share_of_bound"] = bound_ms / hy["cuda_core_ms"]
    say("ssd", json.dumps(hy))
    tc_x = dict(name="ssd_intra_chunk_tc_thread_x", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_scan_tc.cu",
                replaces="src/repro/kernels/ssd_scan.py:56",
                x_load="threads", launches=None, max_abs_err=err,
                ms=hy["ms"], plain_ms=hy["plain_ms"], bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None,
                cuda_core_ms=hy["cuda_core_ms"],
                shape=[G * heads, c, Q, P, N], heads=heads, dtype="bfloat16")
    # the CUDA-core kernel on its path: ops.ssd at mamba2-1.3b's f32 cell
    cell = mamba_f32_cell
    cuda_core = dict(
        name="ssd_intra_chunk", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:56",
        launches=path["ssd_scan"],
        path="ops.ssd, f32 at mamba2-1.3b's shape (1 per call; phase 7)",
        max_abs_err=cell["max_abs_err"], ms=cell["ms"],
        plain_ms=cell["plain_ms"], bound_ms=cell["bound_ms"],
        bound_by=cell["bound_by"], library_ms=None,
        shape=[cell["BH"], cell["c"], cell["Q"], cell["P"], cell["N"]],
        dtype="float32")
    return tc, tc_x, cuda_core


def phase_reference(dev, kmods, tag: str, fixture: str, expect: dict,
                    faults) -> dict:
    """A model at full width and 2 layers vs the JAX package's fixture;
    ``Model.loss`` must launch the kernels as ``expect`` says (per
    forward) and nothing else.  ``faults(params)``: the faults the logit
    check must reject.  A fixture with ``routing`` (MoE) also holds every
    layer's top-k experts per token and its dropped assignments exactly,
    and its check rejects a fault that moves either."""
    import numpy as np
    import torch
    from repro_torch import carry
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Engine, Request

    t0 = time.perf_counter()
    fx = json.loads((ROOT / "tests" / "torch_fixtures" / fixture)
                    .read_text())
    cfg = get_config(fx["arch"]).scaled(n_layers=fx["n_layers"])
    params = carry.numpy_params(
        cfg, fx["weights_seed"], ones_jitter=fx.get("ones_jitter", 0.0),
        leaf_fn=lambda name, a: carry.leaf_to_device(name, a, dev),
        rounded=False)
    torch.cuda.synchronize()
    t_weights = time.perf_counter() - t0
    model = Model(cfg, impl="pallas")
    lb = fx["loss_batch"]
    batch = {k: torch.tensor(lb[k], dtype=torch.int32, device=dev)
             for k in ("tokens", "labels")}
    zero(kmods)
    with torch.no_grad():
        loss = float(model.loss(params, batch))
    path = counts(kmods)
    expect_counts(f"{tag} Model.loss", path, expect)
    if abs(loss - fx["loss"]) > GRANITE_LOSS_RTOL * abs(fx["loss"]):
        raise AssertionError(f"2-layer loss {loss} vs reference "
                             f"{fx['loss']} (rel tol {GRANITE_LOSS_RTOL})")

    # the forward's logits (the kernel's output through both layers) at the
    # fixture's positions: top-5 values, relative to each position's largest
    f = fx["forward"]
    fids, fvals = np.array(f["top_ids"]), np.array(f["top_vals"])
    routing = fx.get("routing")

    def fixture_err(lg) -> float:
        got = np.take_along_axis(lg.cpu().numpy(), fids, 1)
        return float((np.abs(got - fvals).max(1)
                      / np.abs(fvals).max(1)).max())

    def forward():
        """Logits at the fixture's positions, their top-5 error and, for
        MoE, the routing of every layer."""
        with moe_routing() as calls, torch.no_grad():
            lg = logits_at(model, params, batch["tokens"], f["positions"])
        return lg, fixture_err(lg), calls

    lg, fwd_err, calls = forward()
    top1 = lg.argmax(1).tolist()
    if fwd_err > LOGIT_REL or any(a not in ids
                                  for a, ids in zip(top1, fids.tolist())):
        raise AssertionError(f"2-layer forward logits vs reference: rel err "
                             f"{fwd_err} (tol {LOGIT_REL}), argmax {top1}")
    extra = {}
    if routing:
        from repro_torch.models import moe
        extra = own_routing(calls, routing)
        extra["dispatch_mismatches"] = dispatch_mismatches(cfg, routing, dev)
        if extra["prob_rel_err"][0] > LOGIT_REL \
                or extra["dispatch_mismatches"]:
            raise AssertionError(f"{tag} routing vs reference: {extra}")
        extra.update(dropped_per_layer=[len(r["dropped"]) for r in routing],
                     capacity=routing[0]["cap"])
        # ``torch.topk`` in place of the stable sort: reported, not a
        # planted fault (its order of ties is not promised either way)
        with swapped(moe, "top_k", lambda p, k: torch.topk(p, k)):
            extra["torch_topk_dispatch_mismatches"] = dispatch_mismatches(
                cfg, routing, dev)

    def measure() -> float:
        err = forward()[1]
        return max(err, dispatch_mismatches(cfg, routing, dev)) if routing \
            else err

    faults = planted_faults(faults(params), model, params, batch, measure,
                            LOGIT_REL)

    g = fx["greedy"]
    # teacher-forced on the reference's tick inputs
    cache = model.init_decode_state(g["slots"], g["max_seq"], device=dev)
    worst, ties = 0.0, {}
    with torch.no_grad():
        for t, tick in enumerate(g["ticks"]):
            toks = torch.tensor(tick["tokens"], dtype=torch.int32,
                                device=dev)[:, None]
            logits, cache = model.decode(params, cache, toks,
                                         tick["cache_len"])
            lg = logits.cpu().numpy()
            for s in range(g["slots"]):
                ids = np.array(tick["top_ids"][s])
                vals = np.array(tick["top_vals"][s])
                tol = LOGIT_REL * np.abs(vals).max()
                dev_ = np.abs(lg[s, ids] - vals).max()
                worst = max(worst, float(dev_ / np.abs(vals).max()))
                if dev_ > tol:
                    raise AssertionError(f"tick {t} slot {s}: top-5 logits "
                                         f"{lg[s, ids]} vs {vals}")
                # the greedy token may differ only where the reference's
                # top-1 lead over another top-5 token is within the two
                # tokens' deviations (bf16 ties are common)
                d = np.abs(lg[s, ids] - vals)
                flip = bool(any(vals[0] - vals[k] <= d[0] + d[k]
                                for k in range(1, len(ids))))
                top = int(lg[s].argmax())
                if top != ids[0] and not (flip and top in ids):
                    raise AssertionError(f"tick {t} slot {s}: port argmax "
                                         f"{top} vs reference {ids[0]}")
                ties[(t, s)] = flip
    # free-running greedy engine: equal tokens up to the first near tie
    eng = Engine(model, params, slots=g["slots"], max_seq=g["max_seq"])
    reqs = [Request(rid=i, prompt=pr, max_new=g["max_new"])
            for i, pr in enumerate(g["prompts"])]
    assert len(reqs) == g["slots"]          # one request per slot, no refill
    for r in reqs:
        eng.submit(r)
    zero(kmods)
    eng.run(max_ticks=100)
    serve_path = counts(kmods)
    compared = 0
    for s, (r, want) in enumerate(zip(reqs, g["outputs"])):
        if not r.done or len(r.out) != len(want):
            raise AssertionError(f"request {s} unfinished: {r.out}")
        for j, (a, b_) in enumerate(zip(r.out, want)):
            if ties[(len(r.prompt) - 1 + j, s)]:
                break                         # may flip: stop comparing
            if a != b_:
                raise AssertionError(f"request {s} token {j}: {r.out} vs "
                                     f"{want}")
            compared += 1
    res = dict(loss=loss, loss_ref=fx["loss"],
               loss_rel_err=abs(loss - fx["loss"]) / abs(fx["loss"]),
               launches_per_loss=path, weights_s=t_weights,
               forward_top5_rel_err=fwd_err, planted_faults=faults,
               **extra,
               top5_worst_rel_err=worst, greedy_tokens_compared=compared,
               greedy_tokens_total=sum(len(o) for o in g["outputs"]),
               possible_flips=sum(ties.values()), outputs=[r.out for r in reqs],
               engine_launches=serve_path, wall_s=time.perf_counter() - t0)
    say(tag, json.dumps(res))
    del params, cache
    torch.cuda.empty_cache()
    return res


def phase_full(dev, kmods, smi, tag: str, arch: str, expect: dict,
               faults: dict, positions, forced=None, by_layer: bool = False,
               layers: int = 0) -> dict:
    """A model at full size (``layers``: a cut depth, at full width): the
    forward with the kernels (launched as ``expect`` says, nothing else)
    against ``impl="naive"``, and serving.  ``forced``: ``(label, obj,
    attribute, fn)``, the forward also timed with ``fn`` in place of
    ``obj.attribute`` (another route of the kernel), the two routes in
    turns: kernel, forced, forced, kernel.

    The check, and the faults it must reject: whole logit rows at
    ``positions`` within ``FULL_LOGIT_REL``; with ``by_layer`` (a model
    with SSM layers, whose random-weight logits move by their whole scale
    after many layers for a one-ulp change of one input, or with MoE
    layers, where such a change can move a token to another expert; both
    measured here as ``sensitivity``) each layer's sequence mixer on
    naive's residual stream within ``LOGIT_REL`` (``layer_errors``), the
    logit rows reported beside it."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.serve.sampler import SamplerConfig

    cfg = get_config(arch)
    if layers:
        cfg = cfg.scaled(n_layers=layers)
    model = Model(cfg, impl="pallas")
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t
    n_params = sum(p.numel() for p in _tensors(params))
    gen = torch.Generator(device=dev).manual_seed(3)
    B, S = 2, 4096
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen, device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with torch.no_grad():
        model.loss(params, {k: v[:, :128] for k, v in batch.items()})
        zero(kmods)
        t = time.perf_counter()
        loss_p = float(model.loss(params, batch))
        t_fwd = time.perf_counter() - t
        path = counts(kmods)
        expect_counts(f"{tag} forward", path, expect)
        peak_fwd = torch.cuda.max_memory_allocated(dev)
        if forced is not None:
            label, obj, attr, fn = forced
            # the routes in turns: kernel, forced, forced, kernel
            forced_s = []
            with swapped(obj, attr, fn):
                for _ in range(2):
                    t = time.perf_counter()
                    float(model.loss(params, batch))
                    forced_s.append(time.perf_counter() - t)
            t = time.perf_counter()
            float(model.loss(params, batch))
            t_fwd2 = time.perf_counter() - t
        naive = Model(cfg, impl="naive")
        t = time.perf_counter()
        loss_n = float(naive.loss(params, batch))
        t_naive = time.perf_counter() - t
        lg_p = logits_at(model, params, batch["tokens"], positions)
        lg_n = logits_at(naive, params, batch["tokens"], positions)
    if not (abs(loss_p - loss_n) <= FULL_LOSS_RTOL * abs(loss_n)
            and math.isfinite(loss_p)):
        raise AssertionError(f"{tag} loss: pallas {loss_p} vs naive "
                             f"{loss_n} (rel tol {FULL_LOSS_RTOL})")

    def naive_err(lg) -> float:
        return float((lg - lg_n).abs().max() / lg_n.abs().max())

    logit_err = naive_err(lg_p)
    extra = {}
    if by_layer:
        from repro_torch.models import transformer as tf
        real_embed = tf.embed

        def nudged(emb, tokens):
            """The embedding with one entry moved by one bf16 ulp."""
            x = real_embed(emb, tokens).clone()
            x[0, 0, 0] = x[0, 0, 0] * (1 + 2.0 ** -7)
            return x

        with swapped(tf, "embed", nudged), torch.no_grad():
            extra["sensitivity"] = naive_err(logits_at(
                naive, params, batch["tokens"], positions))
        errs = layer_errors(model, params, batch["tokens"])
        extra["layer_errs"] = errs
        err, limit = max(errs), LOGIT_REL

        def measure():
            return max(layer_errors(model, params, batch["tokens"]))
    else:
        err, limit = logit_err, FULL_LOGIT_REL

        def measure():
            return naive_err(logits_at(model, params, batch["tokens"],
                                       positions))
    if not err <= limit:
        raise AssertionError(f"{tag}: pallas vs naive rel err {err} (tol "
                             f"{limit}, {'by layer' if by_layer else 'logit rows'})")
    faults = planted_faults(faults, model, params, batch, measure, limit)
    fwd = dict(layers=cfg.n_layers, n_params=n_params, init_s=t_init,
               loss_pallas=loss_p,
               loss_naive=loss_n, rel_diff=abs(loss_p - loss_n) / loss_n,
               logit_rel_err=logit_err, planted_faults=faults,
               forward_s=t_fwd, forward_tokens_per_s=B * S / t_fwd,
               naive_forward_s=t_naive, launches=path,
               peak_gib=peak_fwd / 2**30, power=smi, **extra)
    if forced is not None:
        fwd.update({f"forward_s_{forced[0]}": forced_s[0],
                    f"forward_tokens_per_s_{forced[0]}": B * S / forced_s[0],
                    f"forward_s_{forced[0]}_again": forced_s[1],
                    f"forward_tokens_per_s_{forced[0]}_again":
                        B * S / forced_s[1],
                    "forward_s_again": t_fwd2,
                    "forward_tokens_per_s_again": B * S / t_fwd2})
    say(f"{tag}-full", json.dumps(fwd))

    torch.cuda.reset_peak_memory_stats(dev)
    zero(kmods)
    res = serve.serve_requests(
        model, params, requests=8, slots=4, max_seq=4096, max_new=32,
        sampler=SamplerConfig(temperature=0.8, top_k=50),
        prompt_lens=(16, 65))
    serve_path = counts(kmods)
    if res["done"] != 8 or any(len(r.out) != 32 for r in res["requests"]):
        raise AssertionError(f"serve: {res['done']} of 8 requests done")
    if any(serve_path.values()):
        raise AssertionError(f"serve launched kernels: {serve_path}")
    out = dict(requests=8, done=res["done"], tokens=res["tokens"],
               prompt_tokens=res["prompt_tokens"], ticks=res["ticks"],
               wall_s=res["wall_s"], tokens_per_s=res["tokens_per_s"],
               ms_per_tick=1e3 * res["wall_s"] / res["ticks"],
               kernel_launches=serve_path,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
               power=nvidia_smi())
    say(f"{tag}-serve", json.dumps(out))
    del params
    torch.cuda.empty_cache()
    return dict(forward=fwd, serve=out)


# ---------------------------------------------------------------------------
# closed-loop memory and trace workloads (phases 12-14)

FIG7_SMOKE = ("gemma-7b-oneshot", "compiled")
# lanes the smoke leaves to ``benchmarks_torch/fig7_traces.py``: the
# one-shot's substrate lane holds the batch in lockstep to 11 008 cycles
FIG7_SMOKE_SKIP = {("gemma-7b-oneshot", "SUBSTRATE")}
MEM_FIELDS = ("amat_cycles", "amat_reads", "mem_reads", "mem_writes",
              "mem_row_hit_rate", "mem_queue_cycles", "mem_service_cycles",
              "mem_bw_gbps", "outst_peak")


def _diff(want, got, path: str, bad: list) -> None:
    if isinstance(want, dict):
        if set(want) != set(got):
            bad.append(f"{path}: keys {sorted(got)} != {sorted(want)}")
            return
        for k in want:
            _diff(want[k], got[k], f"{path}.{k}", bad)
    elif isinstance(want, list):
        if len(want) != len(got):
            bad.append(f"{path}: {len(got)} entries != {len(want)}")
            return
        for i, (w, g) in enumerate(zip(want, got)):
            _diff(w, g, f"{path}[{i}]", bad)
    elif isinstance(want, float):
        if not close(float(got), want):
            bad.append(f"{path}: {got!r} vs {want!r}")
    elif got != want:
        bad.append(f"{path}: {got!r} != {want!r}")


def check_all(tag: str, got, want: dict) -> None:
    """Every ``Metrics`` field against the reference's record: integers
    (lists of them too) exact, floats within rel 1e-6."""
    import dataclasses
    bad: list = []
    _diff(want, dataclasses.asdict(got), "", bad)
    if bad:
        raise AssertionError(f"{tag} disagrees with the reference: "
                             f"{bad[:6]}{' ...' if len(bad) > 6 else ''}")


def rejected(tag: str, check) -> str:
    """Run a check that a planted fault must fail; its first complaint."""
    try:
        check()
    except AssertionError as e:
        return str(e)[:160]
    raise AssertionError(f"planted fault not rejected: {tag}")


@contextlib.contextmanager
def planted_tables(simulator, faults: dict):
    """``simulator.pack`` hands the points whose ``sim`` object is a key
    of ``faults`` tables changed by its value: a fault planted in the
    packed tables of an extra lane, for the phase's check to reject."""
    import dataclasses
    orig = simulator.pack

    def pack(topo, rt, tt, phy, sim, *a, **kw):
        ps = orig(topo, rt, tt, phy, sim, *a, **kw)
        f = faults.get(id(sim))
        return dataclasses.replace(ps, ss=f(ps.ss)) if f else ps

    with swapped(simulator, "pack", pack):
        yield


def sim_rates(ms, wall: float, budget: int) -> dict:
    return dict(wall_s=wall, points=len(ms), points_per_s=len(ms) / wall,
                lane_cycles_per_s=len(ms) * budget / wall,
                simulated_lane_cycles_per_s=sum(m.drain_cycle for m in ms)
                / wall,
                slowest_drain_cycle=max(m.drain_cycle for m in ms))


def phase_fig8(dev, kmods, smi) -> dict:
    """fig8's grid against its JAX fixture, fig8's own checks, and
    two planted faults riding as extra lanes of the one batched call."""
    import torch
    from repro_torch.core import simulator
    from repro_torch.core.constants import SimParams
    from repro_torch.core.sweep import run_sweep_batched
    from repro_torch.memory import DramTimingParams
    from benchmarks_torch import figures

    fx = figures.fixture("fig8_reference.json")
    sim = SimParams(**fx["sim"])
    cases = [p["case"] for p in fx["points"]]
    pts = [figures.fig8_point(c, sim) for c in cases]
    # faults at the heaviest wireless window-4 point: the bank service one
    # cycle longer; the max_outstanding window one wider
    hot = cases.index(dict(fabric=2, load=1.0, max_outstanding=4))
    f_sims = [SimParams(**fx["sim"]) for _ in range(2)]
    faults = {id(f_sims[0]): lambda ss: ss._replace(
                  t_row_hit=ss.t_row_hit + 1, t_row_miss=ss.t_row_miss + 1),
              id(f_sims[1]): lambda ss: ss._replace(
                  max_outst=ss.max_outst + 1)}
    zero(kmods)
    t = time.perf_counter()
    with planted_tables(simulator, faults):
        ms = run_sweep_batched(
            pts + [figures.fig8_point(cases[hot], s) for s in f_sims],
            device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = counts(kmods)
    expect_counts("fig8", launches, {})
    ms, fms = ms[:len(pts)], ms[len(pts):]
    for p, m in zip(fx["points"], ms):
        check_all(f"fig8 {m.name}", m, p["metrics"])
    # fig8's hard checks: the window caps the in-flight count, and AMAT
    # grows with load on every (fabric, window) curve
    default_window = DramTimingParams().max_outstanding
    cap_ok = all(m.outst_peak <= c.get("max_outstanding", default_window)
                 for c, m in zip(cases, ms))
    sat = []
    for mo in {c["max_outstanding"] for c in cases if "app" not in c}:
        for fab in {c["fabric"] for c in cases}:
            curve = [m.amat_cycles for c, m in zip(cases, ms)
                     if c.get("max_outstanding") == mo
                     and c["fabric"] == fab and m.amat_reads > 0]
            if len(curve) >= 2:
                sat.append(curve[-1] > curve[0])
    if not (cap_ok and sat and all(sat)):
        raise AssertionError(f"fig8 checks: cap {cap_ok}, amat grows {sat}")
    want = fx["points"][hot]["metrics"]
    why = [rejected(f"fig8 {n}", lambda m=m: check_all("fault", m, want))
           for n, m in zip(("bank service +1", "window +1"), fms)]
    rec = sim_rates(ms, wall, sim.cycles)
    rec.update(lanes=len(ms) + len(fms), cycles=sim.cycles,
               outstanding_never_exceeds_window=cap_ok,
               amat_grows_with_load=all(sat),
               faults_rejected=why, kernel_launches_on_path=launches,
               power=smi)
    say("fig8", json.dumps(rec))
    return rec


def phase_memcl(dev, kmods, smi) -> dict:
    """The closed-loop golden point against ``tests/goldens``, with two
    planted faults as extra lanes (bank service one cycle longer; the
    read round trip's start one cycle early)."""
    import torch
    from repro_torch.core import simulator
    from repro_torch.core.constants import Fabric, SimParams
    from repro_torch.core.sweep import SweepPoint, run_sweep_batched
    from repro_torch.memory import MemSweepSpec

    name = "memcl_wireless_4c4m_load03"
    gold = json.loads((ROOT / "tests" / "goldens" / f"{name}.json")
                      .read_text())
    assert gold["sim"] == {"cycles": 1500, "warmup": 300, "seed": 0}
    sims = [SimParams(cycles=1500, warmup=300, seed=0) for _ in range(3)]
    faults = {id(sims[1]): lambda ss: ss._replace(
                  t_row_hit=ss.t_row_hit + 1, t_row_miss=ss.t_row_miss + 1),
              id(sims[2]): lambda ss: ss._replace(
                  req_birth=ss.req_birth - (ss.req_birth < 2**30).int())}
    pts = [SweepPoint(4, 4, Fabric.WIRELESS, load=0.0,
                      mem=MemSweepSpec(load=0.3), sim=s) for s in sims]
    zero(kmods)
    t = time.perf_counter()
    with planted_tables(simulator, faults):
        ms = run_sweep_batched(pts, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = counts(kmods)
    expect_counts("memcl", launches, {})

    def check(m):
        check_metrics(name, m, gold["metrics"])
        bad = [f"{f}: {getattr(m, f)!r} vs {gold['metrics']['memory'][f]!r}"
               for f in MEM_FIELDS
               if not close(float(getattr(m, f)),
                            gold["metrics"]["memory"][f])]
        if bad:
            raise AssertionError(f"{name} memory: {bad}")

    check(ms[0])
    why = [rejected(f"memcl {n}", lambda m=m: check(m))
           for n, m in zip(("bank service +1", "request birth -1"), ms[1:])]
    rec = sim_rates(ms[:1], wall, 1500)
    rec.update(lanes=len(ms), amat_cycles=ms[0].amat_cycles,
               mem_bw_gbps=ms[0].mem_bw_gbps, faults_rejected=why,
               kernel_launches_on_path=launches, power=smi)
    say("memcl-golden", json.dumps(rec))
    return rec


def phase_fig7(dev, kmods, smi, names=FIG7_SMOKE,
               skip=FIG7_SMOKE_SKIP) -> dict:
    """fig7's traces ``names`` x three fabrics at paper size (but the
    (trace, fabric) lanes in ``skip``) against the JAX fixture, every
    trace complete, the cycle-vs-analytic link energy within 2x; a
    planted phase fault rides as an extra lane, and a planted multicast
    energy fault reruns the one-shot wireless point."""
    import torch
    from repro_torch.core import simulator, traffic
    from repro_torch.core.constants import Fabric, SimParams
    from repro_torch.core.sweep import run_sweep_batched
    from repro_torch.core.topology import build_xcym
    from repro_torch.interconnect.fabric import price_table
    from benchmarks_torch import figures

    fx = figures.fixture("fig7_reference.json")
    sim = SimParams(**fx["sim"])
    traces = figures.fig7_traces(names)
    for (name, tr), want in zip(traces, [t for t in fx["traces"]
                                         if t["name"] in names]):
        assert want["name"] == name
        if tr.describe() != want["describe"] \
                or not close(tr.bytes_total(), want["bytes_total"]):
            raise AssertionError(f"fig7 trace {name}: {tr.describe()} vs "
                                 f"{want['describe']}")
    ref = {(p["trace"], p["fabric"]): p for p in fx["points"]}
    meta = [(name, tr, fab) for name, tr in traces
            for fab in figures.FIG7_FABRICS if (name, fab) not in skip]
    pts = [figures.fig7_point(n, tr, fab, sim) for n, tr, fab in meta]
    # fault 1: the one-shot wireless point with its first phase closing
    # one ejection early (phase_need short by one)
    mc_i = [(n, f) for n, _, f in meta].index(("gemma-7b-oneshot",
                                               "WIRELESS")) \
        if "gemma-7b-oneshot" in names else 0
    f_sim = SimParams(**fx["sim"])
    faults = {id(f_sim): lambda ss: ss._replace(
        phase_need=ss.phase_need - (torch.arange(
            ss.phase_need.shape[0], device=ss.phase_need.device) == 0).int())}
    zero(kmods)
    t = time.perf_counter()
    with planted_tables(simulator, faults):
        ms = run_sweep_batched(pts + [figures.fig7_point(
            meta[mc_i][0], meta[mc_i][1], meta[mc_i][2], f_sim)], device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = counts(kmods)
    expect_counts("fig7", launches, {})
    ms, fm = ms[:len(pts)], ms[-1]
    worst, rows = 0.0, {}
    phy = pts[0].phy
    for (name, tr, fab), m in zip(meta, ms):
        want = ref[(name, int(Fabric[fab]))]
        check_all(f"fig7 {m.name}", m, want["metrics"])
        if not m.trace_done:
            raise AssertionError(f"fig7 {m.name}: trace not complete")
        topo = build_xcym(figures.N_CHIPS, figures.N_MEM, Fabric[fab])
        tt = traffic.from_trace(topo, tr, phy.pkt_flits)
        _tot, pj_bit = price_table(topo, tt, phy.pkt_flits, phy.flit_bits)
        if not close(pj_bit, want["analytic_pj_bit"]):
            raise AssertionError(f"fig7 {m.name}: analytic {pj_bit} vs "
                                 f"{want['analytic_pj_bit']}")
        bits = max(m.flits_delivered, 1) * phy.flit_bits
        ratio = m.energy_breakdown["links"] / bits / pj_bit
        worst = max(worst, ratio, 1 / ratio)
        rows[m.name] = dict(drain_cycle=m.drain_cycle,
                            trace_cycles=m.trace_cycles,
                            wl_tx_flits=m.wl_tx_flits,
                            wl_rx_flits=m.wl_rx_flits, energy_ratio=ratio)
    if worst > 2.0:
        raise AssertionError(f"fig7: link energy ratio {worst} > 2x")
    want = ref[(meta[mc_i][0], int(Fabric[meta[mc_i][2]]))]["metrics"]
    why = [rejected("fig7 phase_need -1",
                    lambda: check_all("fault", fm, want))]
    if "gemma-7b-oneshot" in names:
        # fault 2: multicast transmit energy counted per copy, not once
        t2 = time.perf_counter()
        with swapped(simulator, "_air_counted",
                     lambda ss, incoming, *a: incoming):
            fm2 = run_sweep_batched([pts[mc_i]], device=dev)[0]
        torch.cuda.synchronize()
        wall_fault = time.perf_counter() - t2
        why.append(rejected("fig7 multicast energy per copy",
                            lambda: check_all("fault", fm2, want)))
    rec = sim_rates(ms, wall, sim.cycles)
    rec.update(traces=list(names), lanes=len(ms) + 1,
               budget_cycles=sim.cycles, all_traces_complete=True,
               worst_energy_ratio=worst, faults_rejected=why,
               fault_rerun_wall_s=wall_fault if len(why) > 1 else None,
               points_detail=rows, kernel_launches_on_path=launches,
               power=smi)
    say("fig7", json.dumps(rec))
    return rec


def _i32s(rec: dict, key: str, shape) -> "np.ndarray":
    import base64
    import zlib

    import numpy as np
    raw = zlib.decompress(base64.b64decode(rec[key]))
    return np.frombuffer(raw, "<i4").reshape(shape)


def phase_fig9(dev, kmods, smi, emit=None) -> dict:
    """fig9 at paper size against its JAX fixture: the quality grid (54
    points, two batches), the drift sweep (16 points, four batches) and
    the one-shot all-reduce over the lossy channel, with fig9's hard
    checks; the small broadcast-ARQ trace and the short-birth living point
    whose window boundaries are replayed after its drain; the drifted
    tables of every window of the drift points on the card.  Four planted
    faults must be rejected: ``max_retx`` one higher (an extra lane of the
    quality grid), broadcast ARQ anchored on the best member (a rerun of
    the small trace), the drift walk's seed xored with another constant
    and the window replay skipped (reruns of the living point).  ``emit``
    gets fig9's CSV rows."""
    import torch
    from repro_torch.core import chunked, simulator, sweep
    from repro_torch.core.constants import SimParams
    from repro_torch.core.metrics import compute_metrics
    from repro_torch.core.sweep import run_sweep_batched
    from repro_torch.phy import living
    from benchmarks_torch import figures

    fx = figures.fixture("fig9_reference.json")
    sim = SimParams(**fx["sim"])
    load, p_mem = fx["load"], fx["p_mem"]
    qcases = [p["case"] for p in fx["quality"]]
    dcases = [p["case"] for p in fx["drift"]]
    qpts = [figures.fig9_quality_point(c, sim, load, p_mem) for c in qcases]
    dpts = [figures.fig9_drift_point(c, sim, load, p_mem,
                                     fx["drift_budget_db"]) for c in dcases]
    if figures.bcast_trace(fx["bcast"]["case"]["payload_bytes"]) \
            .describe() != fx["bcast"]["describe"]:
        raise AssertionError("fig9: the broadcast trace differs from the "
                             "fixture's")
    # fault 1: one more ARQ attempt on the lossiest point (13 dB, fixed:0)
    hot = qcases.index(dict(budget_db=13.0, policy="fixed:0", fabric=2))
    f_sim = SimParams(**fx["sim"])
    faults = {id(f_sim): lambda ss: ss._replace(max_retx=ss.max_retx + 1)}

    def single(kind):
        ps = figures.fig9_packed(kind, fx[kind]["case"], dev)
        return compute_metrics(ps, simulator.run(ps),
                               fx[kind]["metrics"]["name"], 0.0)

    zero(kmods)
    walls = {}
    t = time.perf_counter()
    with planted_tables(simulator, faults):
        qms = run_sweep_batched(qpts + [figures.fig9_quality_point(
            qcases[hot], f_sim, load, p_mem)], device=dev)
    torch.cuda.synchronize()
    walls["quality"] = time.perf_counter() - t
    t = time.perf_counter()
    dms = run_sweep_batched(dpts, device=dev)
    torch.cuda.synchronize()
    walls["drift"] = time.perf_counter() - t
    got = {}
    for kind in ("mc_trace", "bcast", "replay"):
        t = time.perf_counter()
        got[kind] = single(kind)
        torch.cuda.synchronize()
        walls[kind] = time.perf_counter() - t
    launches = counts(kmods)
    expect_counts("fig9", launches, {})
    qms, fm = qms[:len(qpts)], qms[-1]
    for p, m in zip(fx["quality"], qms):
        check_all(f"fig9 {m.name}", m, p["metrics"])
    for p, m in zip(fx["drift"], dms):
        check_all(f"fig9 {m.name}", m, p["metrics"])
    for kind, m in got.items():
        check_all(f"fig9 {kind}", m, fx[kind]["metrics"])
    checks = figures.fig9_checks(list(zip(qcases, qms)),
                                 list(zip(dcases, dms)), got["mc_trace"],
                                 emit)
    if not all(checks.values()):
        raise AssertionError(f"fig9 checks: {checks}")
    # the drifted tables of every window the drift points visit
    tables = 0
    for amp, rec in fx["windows"].items():
        n, W = rec["n_wi"], rec["windows"]
        pt = figures.fig9_drift_point(dict(amp_db=float(amp), arm="online"),
                                      sim, load, p_mem, fx["drift_budget_db"])
        topo, rt, tt, _ = sweep._build_point(pt)
        ps = simulator.pack(topo, rt, tt, pt.phy, pt.sim,
                            phy_spec=pt.phy_spec, device=dev)
        ss = simulator.SimStatic(*(x[None] for x in ps.ss))
        R = int(ss.wl_serv_r.shape[1])
        want_q = _i32s(rec, "perq_r", (W, R, n, n))
        want_r = _i32s(rec, "rate", (W, n, n))
        for win in range(W):
            perq_r, gp_q = living.entry_tables(ss, win)
            rate = living.first_argmax(gp_q, 1)
            if not ((perq_r[0, :, :n, :n].cpu().numpy() == want_q[win])
                    .all() and (rate[0, :n, :n].cpu().numpy()
                                == want_r[win]).all()):
                raise AssertionError(f"fig9 drifted tables differ: {amp} dB "
                                     f"window {win}")
            tables += 1
    want_hot = fx["quality"][hot]["metrics"]
    why = [rejected("fig9 max_retx +1",
                    lambda: check_all("fault", fm, want_hot))]

    def best_member(rows, member):
        return torch.where(member, rows[:, :, None, :],
                           torch.iinfo(rows.dtype).max).amin(-1)

    t = time.perf_counter()
    with swapped(simulator, "_group_link", best_member):
        fb = single("bcast")
    why.append(rejected("fig9 broadcast ARQ on the best member",
                        lambda: check_all("fault", fb,
                                          fx["bcast"]["metrics"])))
    with swapped(living, "DRIFT_SEED", living.DRIFT_SEED ^ 0x5A5A5A5A):
        fd = single("replay")
    why.append(rejected("fig9 drift seed ^ 0x5A5A5A5A",
                        lambda: check_all("fault", fd,
                                          fx["replay"]["metrics"])))
    with swapped(chunked, "replay_windows", lambda fn, st, *a: st):
        fr = single("replay")
    why.append(rejected("fig9 window replay skipped",
                        lambda: check_all("fault", fr,
                                          fx["replay"]["metrics"])))
    torch.cuda.synchronize()
    walls["fault_reruns"] = time.perf_counter() - t
    main_wall = walls["quality"] + walls["drift"] + walls["mc_trace"]
    rec = dict(
        points=len(qms) + len(dms) + 1,
        lanes=len(qms) + 1 + len(dms) + 1,     # + the fault lane, the trace
        batches=dict(quality=len({c["fabric"] == 2 for c in qcases}),
                     drift=len({(c["amp_db"] > 0, c["arm"] == "online")
                                for c in dcases})),
        cycles=sim.cycles, wall_s=walls, figure_wall_s=main_wall,
        points_per_s=(len(qms) + len(dms) + 1) / main_wall,
        lane_cycles_per_s=(len(qms) + 1 + len(dms)) * sim.cycles
        / (walls["quality"] + walls["drift"]),
        mc_trace_drain_cycle=got["mc_trace"].drain_cycle,
        bcast_drain_cycle=got["bcast"].drain_cycle,
        replay=dict(drain_cycle=got["replay"].drain_cycle,
                    wl_resel=got["replay"].wl_resel),
        drift_tables_checked=tables, checks=checks, faults_rejected=why,
        kernel_launches_on_path=launches, power=smi)
    say("fig9", json.dumps(rec))
    return rec


def phase_hybrid_moe(dev, kmods, smi) -> dict:
    """Phases 16-19: hymba-1.5b and mixtral-8x22b, each at 2 layers
    against its fixture and then at full size (mixtral at 8 layers).
    Returns each full forward's launch counts."""
    from repro_torch.kernels import ops, ssd_scan
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    hymba = FLASH_TC + SSD_TC     # both tensor-core routes (SSD: P 50)
    paths = {}
    phase_reference(dev, kmods, "hymba-2l", "hymba1p5b_2l_reference.json",
                    per_layer(2, *hymba),
                    lambda params: hybrid_faults(tf, params))
    full = phase_full(
        dev, kmods, smi, "hymba", "hymba-1.5b", per_layer(32, *hymba),
        {"y_diag zeroed": ssd_faults(ssd_scan)["y_diag zeroed"],
         "keys 128 back dropped": flash_faults(ops)["keys 128 back dropped"]},
        POSITIONS_MAMBA, forced=cuda_core_ssd(ssd_scan), by_layer=True)
    paths["hymba-1.5b forward, 32 layers"] = full["forward"]["launches"]
    phase_reference(dev, kmods, "mixtral-2l",
                    "mixtral8x22b_2l_reference.json",
                    per_layer(2, *FLASH_TC), lambda params: moe_faults(moe))
    full = phase_full(dev, kmods, smi, "mixtral", "mixtral-8x22b",
                      per_layer(MIXTRAL_LAYERS, *FLASH_TC), flash_faults(ops),
                      POSITIONS_FULL, by_layer=True, layers=MIXTRAL_LAYERS)
    paths[f"mixtral-8x22b forward, {MIXTRAL_LAYERS} layers"] = \
        full["forward"]["launches"]
    return paths


# ---------------------------------------------------------------------------
# the scatter engine and the paper's fig2-fig6 and ablations (phases 20-21)

SCATTER_CYCLES = 200
SCATTER_CASES = ("substrate", "interposer", "wireless", "matching", "single",
                 "token", "mem_on", "multicast", "phy_on", "living")
SCATTER_SKIP = {"out_wo", "mc_src"}   # the engines' own encodings
# one case of each step program, for the kernel counts (the media and
# MAC variants run the open-loop program)
SCATTER_PROFILED = ("wireless", "mem_on", "multicast", "phy_on", "living")


def scatter_case(case: str, cycles: int = SCATTER_CYCLES):
    """(topo, rt, tt, phy, sim, phy_spec) of one phase-20 case: 4C4M,
    uniform traffic at load 0.7 (30% memory) on the three fabrics and the
    wireless variants (matching and single media, the token MAC),
    closed-loop memory traffic (window 4), fig9's small multicast trace,
    the lossy channel at 16 dB and a living channel (4 dB drift with
    re-selection)."""
    from repro_torch.core import traffic
    from repro_torch.core.constants import (DEFAULT_PHY, Fabric, MacMode,
                                            PhyParams, SimParams)
    from repro_torch.core.routing import compute_routing
    from repro_torch.core.topology import build_xcym
    from repro_torch.phy import PhySweepSpec
    from benchmarks_torch import figures
    fab = {"substrate": Fabric.SUBSTRATE,
           "interposer": Fabric.INTERPOSER}.get(case, Fabric.WIRELESS)
    phy = {"matching": PhyParams(wireless_medium="matching"),
           "single": PhyParams(wireless_medium="single",
                               wireless_flit_cycles=5)}.get(case, DEFAULT_PHY)
    sim = SimParams(cycles=cycles, warmup=100,
                    mac=MacMode.TOKEN if case == "token"
                    else MacMode.CONTROL_PACKET)
    topo = build_xcym(4, 4, fab, phy)
    spec = None
    if case == "mem_on":
        from repro_torch.memory import DramTimingParams, closed_loop_uniform
        tt = closed_loop_uniform(topo, 0.5, cycles, phy.pkt_flits,
                                 dram=DramTimingParams(max_outstanding=4),
                                 seed=17)
    elif case == "multicast":
        tt = traffic.from_trace(topo, figures.bcast_trace(1024.0),
                                phy.pkt_flits)
    else:
        tt = traffic.uniform_random(topo, 0.7, 0.3, cycles, phy.pkt_flits,
                                    seed=11)
        if case == "phy_on":
            spec = PhySweepSpec(link_budget_db=16.0, max_retx=3)
        elif case == "living":
            spec = PhySweepSpec(link_budget_db=17.0, max_retx=3,
                                drift_amp_db=4.0, reselect=True)
    return topo, compute_routing(topo), tt, phy, sim, spec


def state_diff(a, b, skip=SCATTER_SKIP) -> list:
    """The leaves (of both engines' states) whose name, dtype, shape or
    value differ."""
    import torch
    bad = [f for f in a._fields if f not in skip and f not in b._fields]
    for f in a._fields:
        if f in skip or f not in b._fields:
            continue
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
            bad.append(f)
    return bad


def kernels_per_step(step, st, cycles=(1, 2)):
    """CUDA kernels one call of a cycle step launches (the driver's own
    kernels left out), from a ``torch.profiler`` trace of ``step(st, t)``
    at each cycle of ``cycles``; None if the profiler saw none."""
    import torch
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            for t in cycles:
                st = step(st, t)
        torch.cuda.synchronize()
    n = sum(e.device_type == torch.autograd.DeviceType.CUDA
            for e in prof.events())
    return n / len(cycles) if n else None


def step_kernels(pg, pr) -> tuple:
    """Kernels per cycle of the gather and the scatter step for one
    point's packed tables (each engine's own ``pack``), from its initial
    state."""
    from repro_torch.core import simulator, simulator_ref
    ssg = simulator.SimStatic(*(x[None] for x in pg.ss))
    stg = simulator.init_state(*simulator._state_dims(pg),
                               mem_on=pg.mem_on, phy_on=pg.phy_on,
                               living=pg.drift_on or pg.reselect,
                               R=int(pg.ss.wl_serv_r.shape[0]), lanes=1,
                               device=ssg.cycles.device)
    sg = simulator.make_step(pg.B, **pg.flags(), mc_on=pg.mc_on)
    d = simulator.derive(ssg, pg.B)
    ssr = simulator_ref.SimStatic(*(x[None] for x in pr.ss))
    N, K = pr.ss.births.shape
    str_ = simulator_ref.init_state(
        pr.B, int(N), int(pr.ss.phase_need.shape[0]), int(K), pr.Y, pr.BK,
        mem_on=pr.mem_on, phy_on=pr.phy_on,
        living=pr.drift_on or pr.reselect,
        R=int(pr.ss.wl_serv_r.shape[0]), lanes=1, device=ssr.cycles.device)
    sr = simulator_ref.make_step(pr.B, pr.Wout, pr.RXW, **pr.flags())
    return (kernels_per_step(lambda s, t: sg(ssg, d, s, t), stg),
            kernels_per_step(lambda s, t: sr(ssr, s, t), str_))


def phase_scatter(dev, kmods, smi) -> dict:
    """Phase 20: the scatter engine (``core/simulator_ref.py``) on the card,
    held bitwise against the gather engine (which phases 4, 5 and 12-15
    pin to the JAX package) on every state leaf but the engines' own
    encodings (``out_wo``; ``mc_src``, which the gather engine's
    ``src_of`` stands for): ten cases of
    ``SCATTER_CYCLES`` cycles (``scatter_case``).  Prints each engine's
    host ms per cycle (the chunked driver's run) and, for one case of
    each step program, CUDA kernels per step call (``step_kernels``).  Two planted faults must be
    rejected: masked scatter writes clamped into the table instead of
    dropped (JAX's ``mode="drop"``), on the wireless case; the reply-birth
    minimum into ``rdy`` taken as a maximum, on the memory case (a plain
    ``.set`` there equals the minimum: each reply slot is born once)."""
    import torch
    from repro_torch.core import simulator, simulator_ref
    zero(kmods)
    rows, packed = {}, {}
    t_all = time.perf_counter()
    for case in SCATTER_CASES:
        topo, rt, tt, phy, sim, spec = scatter_case(case)
        pg = simulator.pack(topo, rt, tt, phy, sim, phy_spec=spec, device=dev)
        pr = simulator_ref.pack(topo, rt, tt, phy, sim, phy_spec=spec,
                                device=dev)
        packed[case] = (pg, pr)
        t = time.perf_counter()
        g = simulator.run(pg)
        torch.cuda.synchronize()
        tg = time.perf_counter() - t
        t = time.perf_counter()
        r = simulator_ref.run(pr)
        torch.cuda.synchronize()
        tr = time.perf_counter() - t
        bad = state_diff(r, g)
        if bad:
            raise AssertionError(f"scatter engine != gather engine on {case}:"
                                 f" {bad}")
        if int(g.flits_inj) == 0:
            raise AssertionError(f"{case}: no traffic")
        rows[case] = dict(
            flags=pr.flags(), flits_injected=int(g.flits_inj),
            wl_nacks=int(g.wl_nacks), pkts_dropped=int(g.pkts_dropped),
            wl_resel=int(g.wl_resel), cur_phase=int(g.cur_phase),
            host_ms_per_cycle_gather=tg * 1e3 / sim.cycles,
            host_ms_per_cycle_scatter=tr * 1e3 / sim.cycles)
    wall = time.perf_counter() - t_all
    launches = counts(kmods)
    expect_counts("scatter engine", launches, {})
    for case in SCATTER_PROFILED:
        kg, kr = step_kernels(*packed[case])
        rows[case].update(kernels_per_cycle_gather=kg,
                          kernels_per_cycle_scatter=kr)
    real_index, real_put = simulator_ref._index, simulator_ref._put

    def clamped(dims, idx):          # out-of-range writes kept, clamped
        return real_index(dims, idx).clamp(max=math.prod(dims) - 1)

    def rdy_max(a, ix, val, how):    # the reply birth as a maximum
        if how != "min":
            return real_put(a, ix, val, how)
        return -real_put(-a, ix, -torch.as_tensor(val), "min")

    why = []
    for name, case, attr, fn in (
            ("masked writes clamped, not dropped", "wireless", "_index",
             clamped),
            ("rdy reply birth .min -> .max", "mem_on", "_put", rdy_max)):
        pg, pr = packed[case]
        g = simulator.run(pg)
        with swapped(simulator_ref, attr, fn):
            r = simulator_ref.run(pr)

        def check(r=r, g=g, case=case):
            bad = state_diff(r, g)
            if bad:
                raise AssertionError(f"{case}: {bad}")
        why.append(rejected(name, check))
    rec = dict(cases=rows, cycles=SCATTER_CYCLES, wall_s=wall,
               all_leaves_equal=True, faults_rejected=why,
               kernel_launches_on_path=launches, power=smi)
    say("scatter", json.dumps(rec))
    return rec


def phase_paper_figs(dev, kmods, smi, set_name: str = "cut",
                     figs=None, emit=None, faults: bool = True) -> dict:
    """fig2-fig6 and the ablations against ``tests/torch_fixtures/
    paper_figs_reference.json``'s set ``set_name``: ``cut`` (phase 21,
    500 cycles with 100 of warm-up, the paper's 10 000 cut for this
    script's time limit) or ``paper`` (``benchmarks_torch/paper_figs.py``).
    Each figure's ``run_sweep_batched`` calls and WI-density points run
    as the script runs them (``figures.paper_calls``), with the launch
    counts set to 0 before and read after; every point is held against
    the fixture (every ``Metrics`` field: integers exact, floats rel
    1e-6, NaN = NaN), every ``*.check`` row to the reference's truth
    value and every derived gain or reduction to rel 1e-6.  ``faults``
    plants two that must be rejected: an extra lane of the ablations'
    two-links call with ``interposer_links_per_pair`` 1 where the fixture
    has 2, and a WI-density run with ``wi_cluster_cores`` 8 where it has
    16.  ``emit`` gets each script's CSV rows (paper-reported rows
    included, not held).  Prints a JSON line per figure: wall s, points/s,
    lane-cycles/s, batches, host set-up s (builders + ``pack``) and the
    card's name and power limit."""
    import torch
    from repro_torch.core import simulator, sweep
    from repro_torch.core.constants import Fabric, PhyParams
    from repro_torch.core.metrics import compute_metrics
    from repro_torch.core.sweep import SweepPoint
    from benchmarks_torch import figures

    fx = figures.fixture("paper_figs_reference.json")["sets"][set_name]
    sim = figures.paper_sim(fx["sim"])
    emit = emit or (lambda row: None)
    out = {}
    for fig in figs or figures.PAPER_FIGS:
        want = fx["figs"][fig]
        calls = figures.paper_calls(fig, sim)
        if figures.call_cases(calls, sim) != [p["case"]
                                              for p in want["points"]]:
            raise AssertionError(f"{fig}: the grid is not the fixture's")
        extra = {}
        if faults and fig == "ablations":
            # the two-links call's 4C4M interposer point, one link a pair
            name = want["points"][7]["metrics"]["name"]
            extra = {1: [SweepPoint(4, 4, Fabric.INTERPOSER, load=1.0,
                                    sim=sim, name=name)]}
        tm = {"setup_s": 0.0, "batches": 0, "depth": 0}

        def timed(fn, key):
            def wrap(*a, **kw):    # the outermost timed call counts
                t0 = time.perf_counter()
                tm["depth"] += 1
                try:
                    return fn(*a, **kw)
                finally:
                    tm["depth"] -= 1
                    if not tm["depth"]:
                        tm[key] += time.perf_counter() - t0
            return wrap

        def counted(*a, **kw):
            tm["batches"] += 1
            return run_batch(*a, **kw)

        run_batch = simulator.run_batch
        zero(kmods)
        t = time.perf_counter()
        with swapped(sweep, "_build_point", timed(sweep._build_point,
                                                  "setup_s")), \
                swapped(figures, "density_packed",
                        timed(figures.density_packed, "setup_s")), \
                swapped(simulator, "pack", timed(simulator.pack,
                                                 "setup_s")), \
                swapped(simulator, "run_batch", counted):
            ms = figures.run_paper_calls(calls, sim, dev, extra)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = counts(kmods)
        expect_counts(f"paper {fig}", launches, {})
        n = len(want["points"])
        ms, fms = ms[:n], ms[n:]
        for p, m in zip(want["points"], ms):
            check_all(f"{fig} {m.name}", m, p["metrics"])
        rep = figures.paper_report(fig, ms)
        if rep["checks"] != want["checks"]:
            raise AssertionError(f"{fig} checks {rep['checks']} != "
                                 f"{want['checks']}")
        bad = []
        _diff(want["derived"], rep["derived"], f"{fig}.derived", bad)
        if bad:
            raise AssertionError(f"{fig} derived rows disagree: {bad}")
        for r in rep["rows"]:
            emit(r)
        why = []
        if faults and fig == "ablations":
            why.append(rejected("interposer_links_per_pair 1 for 2", lambda: (
                check_all("fault", fms[0], want["points"][7]["metrics"]))))
            ps, load = figures.density_packed(8, sim, dev)
            m8 = compute_metrics(ps, simulator.run(ps), "density_16", load)
            (want16,) = [p["metrics"] for p in want["points"]
                         if p["case"].get("wi_cluster_cores") == 16]
            why.append(rejected("wi_cluster_cores 8 for 16",
                                lambda: check_all("fault", m8, want16)))
        rec = sim_rates(ms, wall, sim.cycles)
        rec.update(set=set_name, cycles=sim.cycles, warmup=sim.warmup,
                   batches=tm["batches"], host_setup_s=tm["setup_s"],
                   checks=rep["checks"], derived_rows=len(rep["derived"]),
                   faults_rejected=why, kernel_launches_on_path=launches,
                   power=smi)
        say(f"paper {fig}", json.dumps(rec))
        out[fig] = rec
    return out


def _tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tensors(v)
        else:
            yield v


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.constants import Fabric, SimParams
    from repro_torch.core.sweep import SweepPoint, run_sweep_batched
    from repro_torch.kernels import (_build, flash_attention, ops, ref,
                                     rmsnorm, ssd_scan)
    kmods = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
             "ssd_scan": ssd_scan}

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say("env", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    print(smi, flush=True)

    t = time.perf_counter()
    logs = _build.build()
    say("build", f"{time.perf_counter() - t:.1f} s for {sorted(logs)}")
    build_report(_build, logs)

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
    zero(kmods)
    t = time.perf_counter()
    ms = run_sweep_batched(pts, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    sim_launches = counts(kmods)
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

    flash_tc, flash_cc = phase_flash(dev, flash_attention, ops, ref, kmods)
    ssd_tc, ssd_tcx, ssd_cc = phase_ssd(dev, ssd_scan, ops, ref, kmods)
    phase_reference(dev, kmods, "granite-2l", "granite8b_2l_reference.json",
                    per_layer(2, *FLASH_TC), lambda params: flash_faults(ops))
    full = phase_full(dev, kmods, smi, "granite", "granite-8b",
                      per_layer(36, *FLASH_TC), flash_faults(ops),
                      POSITIONS_FULL)
    # the main path's launches: the 36-layer forward of phase 9
    path = full["forward"]["launches"]
    flash_tc.update(launches=path["flash_attention_tc"],
                    launches_all_routes=path["flash_attention"],
                    path="granite-8b forward, 36 layers (phase 9)")

    phase_reference(dev, kmods, "mamba2-2l", "mamba2_2l_reference.json",
                    per_layer(2, *SSD_TC), lambda params: ssd_faults(ssd_scan))
    full = phase_full(dev, kmods, smi, "mamba2", "mamba2-1.3b",
                      per_layer(48, *SSD_TC), ssd_faults(ssd_scan),
                      POSITIONS_MAMBA, forced=cuda_core_ssd(ssd_scan),
                      by_layer=True)
    # the main path's launches: the 48-layer forward of phase 11
    path = full["forward"]["launches"]
    ssd_tc.update(launches=path["ssd_scan_tc"],
                  launches_all_routes=path["ssd_scan"],
                  path="mamba2-1.3b forward, 48 layers (phase 11)")

    # the simulator's closed-loop memory and trace paths (no kernel of
    # this repository runs on them; each phase reads the counts after)
    phase_fig8(dev, kmods, smi)
    phase_memcl(dev, kmods, smi)
    phase_fig7(dev, kmods, smi)
    # the lossy and living PHY: fig9 at paper size
    phase_fig9(dev, kmods, smi)

    # the hybrid and MoE families (phases 16-19)
    paths = phase_hybrid_moe(dev, kmods, smi)
    flash_tc["launches_by_path"] = {
        "granite-8b forward, 36 layers": flash_tc["launches"],
        **{k: v["flash_attention_tc"] for k, v in paths.items()}}
    ssd_by_path = {"mamba2-1.3b forward, 48 layers": ssd_tc["launches"],
                   **{k: v["ssd_scan_tc"] for k, v in paths.items()}}
    ssd_tc["launches_by_path"] = ssd_by_path
    # the thread-loaded instance (P % 16 != 0) is hymba's
    hy = "hymba-1.5b forward, 32 layers"
    ssd_tcx.update(launches=paths[hy]["ssd_scan_tc"],
                   launches_all_routes=paths[hy]["ssd_scan"],
                   path=f"{hy} (phase 17)", launches_by_path=ssd_by_path)

    # the scatter engine against the gather engine, and fig2-fig6 with
    # the ablations at the smoke's cut (phases 20-21)
    phase_scatter(dev, kmods, smi)
    phase_paper_figs(dev, kmods, smi, "cut")

    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": [kern, flash_tc, flash_cc, ssd_tc, ssd_tcx,
                                  ssd_cc]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
