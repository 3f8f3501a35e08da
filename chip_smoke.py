"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line (``[phase] ...``) and failing loudly (the
order in which they run is given after the list):

1. environment: torch, the card, its power limit (nvidia-smi);
2. kernel build: nvcc of every ``src/repro_torch/kernels/csrc`` source
   (the CUDA-core kernels' first versions, ``csrc/v1/``, too: phases 6
   and 7 time them beside the redesigned ones), with ptxas's registers,
   spills and warnings of each kernel, the tensor-core kernels' shared
   memory and the CUDA-core kernels' blocks per SM (it fails on a spill
   in either tensor-core or either CUDA-core kernel, on any of the SSD
   kernel's eight instances, P boxes 1-4 with x by TMA or by the threads,
   missing from the report, or on ``setmaxnreg`` ignored in the flash
   kernel, C7508);
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
   inputs, and the CUDA-core kernel beside its first version
   (``csrc/v1/flash_attention.cu``, built in this call) in turns on those
   inputs and on hymba-1.5b's f32 shape (hd 64, the window; also held to
   2e-5), each with its share of the bound;
7. SSD, two kernels chosen by ``ssd_scan.route``: the tensor-core kernel
   (bf16 x, B, C, Q 64-256, even P; x by TMA where P % 16 == 0, else by
   the threads) and the CUDA-core kernel (the rest).  The
   CUDA-core kernel against ``ref.ssd_intra_chunk_ref`` at the cases of
   ``tests/test_kernels_ssd.py`` (f32 1e-4, bf16 5e-2) and at mamba2-1.3b's
   f32 cell, where ``ops.ssd`` whole (one launch) is held against its
   plain composition on the CPU (2e-4); times of the kernel, its plain
   version, ``ops.ssd`` and ``ops.ssd`` composed with the plain version,
   the kernel beside its first version (``csrc/v1/ssd_scan.cu``) in turns,
   the kernel with B and C by group as ``ops.ssd`` gives them (1e-4 of the
   largest entry), each with its share of the bound, and the kernel at
   hymba-1.5b's f32 cell (P 50, N 16, 64 heads by group; 1e-4).
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
    residual stream (at random weights these layers move the logits by
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
    traces of ``benchmarks/fig7_ml_traces.py`` (16 devices on 4C4M; the
    compiled trace built from the port's own psum step,
    ``workloads/graph.py::psum_trace``, which must equal
    ``trace_from_hlo`` of ``tests/torch_fixtures/fig7_psum.hlo.txt``
    phase by phase and message by message, and reject the step's two
    sums left uncombined)
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
    engine on the card: ten cases of 140 cycles (substrate, interposer and
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
22. whisper-tiny at full size (4 + 4 layers, d 384, 6 heads of 64)
    against ``tests/torch_fixtures/whisper_tiny_reference.json`` (the JAX
    package op by op; B 2 x 448 tokens over 1 500 frame embeddings from
    the fixture's seed): the loss, the top-5 logits across the decoder and
    the greedy engine; then ``Model.loss`` at B 16 against
    ``impl="naive"`` by loss and logit rows, and serving.  The flash
    kernel's launches are held by route, causality and shape: 4
    non-causal at BH 96 x 1 500 (a ragged last tile) for the encoder, 4
    causal at 448 for the decoder, none for the cross-attention (the
    blockwise path, as in the reference); faults: the encoder made
    causal, as phase 9's;
23. llava-next-mistral-7b at full width and 2 layers against
    ``tests/torch_fixtures/llava_2l_reference.json`` (B 1 x (576 patches
    + 2 048 tokens) = 2 624 rows: the loss over the text, the top-5
    logits from the first text positions on, the greedy engine; faults:
    the patches put after the tokens, the loss taken over the patch
    positions), then at full size (32 layers, ~7.3 B parameters) at B 2 x
    (576 + 4 096) = 4 672 rows, 32 tensor-core flash launches, held
    against ``impl="naive"`` layer by layer as phases 11, 17 and 19, and
    serving;
24. training (hymba-1.5b, ``launch/train.py``'s default arch): four
    ``make_train_step`` steps at full width and 2 layers
    (``impl="blockwise"``, as the reference; ``SyntheticLM`` B 8 x S 256)
    against ``tests/torch_fixtures/train_hymba_2l_reference.json`` (per
    step loss, gnorm, lr; per leaf the mean move, the moments, a sample's
    directions), which must reject four AdamW faults (the bias correction
    dropped, the clip skipped, the layers' vectors not decayed, the final
    norm decayed); no kernel launch on the path; a step with
    ``impl="pallas"`` raises; a restart drill (``RestartableLoop`` with a
    ``CheckpointManager``: a step failing once at step 3 restores step 2
    and replays, against an uninterrupted run; a flipped byte in the
    newest checkpoint is skipped); then ``launch/train.py`` at full size,
    12 steps, its losses, step ms and tokens/s;
25. compressed data parallelism (``train/grad_compress.py``) on a process
    group of one rank (NCCL) and ``make_host_mesh()``: hymba-1.5b at full
    size, ``launch/train.py``'s defaults (B 8 x S 256, cosine lr peak
    3e-3, ``impl="blockwise"``), ``DP_STEPS`` steps of
    ``make_dp_train_step`` with int8 error feedback: the loss falls, no
    kernel of this repository launches, and the step ms, peak memory and
    ``wire_bytes_per_step`` (int8 and bf16) print beside phase 24's
    uncompressed step; on one step's gradients (with the carried
    residual) the card's ``quantize`` codes, scales and residuals equal
    the CPU's bit for bit; ``hierarchical_grad_reduce`` on a (1, 1)
    ("pod", "data") mesh returns its input unchanged;
26. the GPipe pipeline (``train/pipeline.py``) with one stage and 4
    microbatches on the same process group: hymba-1.5b at full width and
    ``PP_LAYERS`` layers, B 8 x S 256, loss and gradients against
    ``Model.loss`` on the card (``PP_TOL``), no kernel launched, the
    times of both.  Schedules of more than one stage need more than one
    card: the gloo tests hold them (``tests/test_torch_pipeline.py``);
27. the multi-pod dry run (``launch/dryrun.py``): (a) in a process of its
    own (``python3 chip_smoke.py --phase dryrun OUT``), so that its fake
    group of 512 ranks never meets the NCCL group, whisper-tiny
    ``train_4k`` and hymba-1.5b ``decode_32k`` on the 16 x 16 mesh with
    the meshes on the card's device type, held against
    ``tests/torch_fixtures/dryrun_reference.json`` (status, argument
    bytes, ``model_flops`` exact; dot FLOPs within
    ``DRYRUN_FLOPS_TOL``; collective bytes on the train cell), the
    card's allocated bytes unchanged and its peak 0 during the cells;
    (b) beside it, phase 24's step (hymba-1.5b, B 8 x S 256) dry-run on
    a (1, 1) mesh of a one-rank group: its argument bytes equal to the
    storages of the parameters, AdamW state and batch of that step on
    the card, its dot FLOPs equal to ``StepAnalysis`` over one real
    step; the dry run's roofline terms and peak printed beside phase
    24's measured step and peak, with the achieved TFLOP/s; (c) in (a)'s
    process, hymba-1.5b ``train_4k`` on the 16 x 16 mesh with ``--pp 4``
    (16 stages of 2 layers, 4 microbatches) against
    ``tests/torch_fixtures/dryrun_flags_reference.json``: status,
    argument bytes exact, dot FLOPs within ``DRYRUN_FLOPS_TOL``, and its
    hand-offs counted as 2 (M + S - 1) = 38 collective-permutes of the
    rank's f32 boundary buffer (104 857 600 bytes each), printed beside
    the reference's 39 trip-expanded ones;
28. the port's examples at their JAX scripts' settings, beside fig9
    (host-bound): ``examples/torch_quickstart.py`` (4C4M in three fabrics
    at loads 1.0 and 0.05, 4 000 cycles with 800 of warm-up, one batched
    call) against ``tests/torch_fixtures/quickstart_reference.json``'s
    ``script`` rows (the reference's ``run_point``; integers exact,
    floats rel 1e-6; the rows held against another fabric's must be
    rejected), ``examples/torch_serve_lm.py`` and
    ``examples/torch_train_lm.py`` (the ~100M hymba member, 300 steps,
    checkpoints every 20: the loss falls); no kernel launch;
29. gemma-7b at full size (28 layers, d 3 072, 16 heads of 256, vocab
    256 000): the forward at B 2 x S 4096 (28 tensor-core flash launches
    at hd 256) against ``impl="naive"`` by loss and logit rows, and
    serving, as phase 9;
30. starcoder2-7b at full size (32 layers, LayerNorm, non-gated GELU, 36
    query heads over 4 kv heads of 128), as phase 29;
31. dbrx-132b at full width and ``DBRX_LAYERS`` of its 40 layers (16
    experts, top 4), held layer by layer as phase 19;
32. llama3-405b at full width and ``LLAMA3_LAYERS`` of its 126 layers
    (d 16 384, 128 query heads over 8), as phase 29;
33. the simulator's execution chunk and the sweep's drivers against
    ``tests/torch_fixtures/chunk_reference.json`` (written by the JAX
    package, ``make_chunk_reference.py``), every ``SimState`` leaf
    (integers exact, floats rel 1e-6) or every ``Metrics`` field, in four
    processes (``python3 chip_smoke.py --phase chunk PART``, the parts of
    ``CHUNK_PARTS``): the 4C4M wireless point of
    ``tests/test_chunked_exec.py`` (load 0.5, 700 cycles with 100 of
    warm-up) through ``simulator.run(chunk=)`` at chunks 32 and 96 in
    one, 128 and 256 in another, each run's wall printed on a line of
    its own; a fig9 drift point (19 dB, 4 dB drift, re-selection) whose
    births are cut to 16 cycles, at chunk 96 (it drains at 480, off the
    128-cycle window, so the boundaries from 512 on fire in the driver's
    replay) and 128; and the three fabrics of a 4C4M point at a
    512-cycle budget through ``run_sweep_batched(driver="monolithic")``
    and ``driver="chunked"`` (its wireless lane drains at 384 and stays
    frozen while the wireline lanes run on), with ``sweep.POINTS_RUN``'s
    move; no kernel launch;
34. the f32 path to the CUDA-core kernels: hymba-1.5b at full width and 2
    layers with f32 weights (``Model(param_dtype=torch.float32)``, drawn
    from a seed on the card), B 2 x S 2560 past the 2048-token window:
    ``impl="pallas"`` launches the CUDA-core flash kernel twice (hd 64,
    the window) and the CUDA-core SSD kernel twice (P 50, N 16, B and C by
    group), nothing else; held against ``impl="naive"`` by the logits at 7
    positions (2^-8 of the largest) and the loss (rel 1e-4); faults: keys
    128 back dropped, ``y_diag`` zeroed.  The closing line's entries of
    the two CUDA-core kernels take their ``launches`` from this phase.

Phase 15 (fig9) runs in a second process on the same card (``python3
chip_smoke.py --phase fig9``, ``Apart``): one host thread's dispatch
bounds it for 6-10 minutes while the card idles.  This process runs
phases 1-3, 6-7, 34 and 8-11 alone, then starts fig9's process, a third one for
27 (a) and (c) (``DryrunApart``: it allocates nothing on the card and
runs no kernel) and phase 33's four, runs 4-5, 12-14, 20-21 and 28 (the
other host-bound phases) beside them, prints phase 33's output and then
fig9's when their processes end (failing if one failed), then runs
16-19, 29-32 and 22-27.  So the walls of phases 4-5, 12-15, 20-21, 28
(the examples, train_lm's step times among them) and 33 and of 27 (a)
and (c) are taken beside another process; the kernel timings (phases 3,
6 and 7) and the model phases 8-11, 16-19, 22-26, 29-32 and 34 are taken
with the card to themselves.

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
Phase 33 plants four: the drain check passing at the first chunk
boundary past warm-up while the lane still carries traffic (a rerun of
the 700-cycle point in each of its two processes), the chunk ignored
(the loop run in chunks of 128: the chunk-128 run of the drift point
held against the chunk-96 record), the window replay skipped (the state
the driver hands ``replay_windows`` in the chunk-96 run, closed as the
driver closes it) and the sweep's ``driver`` ignored (the chunked result
held against the monolithic record).

Phases 8, 9 and 29-32 also plant two faults in the flash entry point
(output zeroed; keys 128 and more back dropped), phases 10 and 11 two in
the SSD intra-chunk entry point (``y_diag`` zeroed; the decay dropped,
L = 1 on the lower triangle), and fail unless their logit checks reject
each.
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

sys.path.insert(0, str(ROOT / "src"))
from repro_torch.interconnect.cost_model import (  # noqa: E402
    H100, H100_F32_FLOPS)

H100_BYTES_PER_S = H100.hbm_bw     # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = H100.peak_flops  # bf16 tensor cores, dense
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
    "gemma-7b": (2, 4096, 4096, 16, 16, 256, True, 0, "bfloat16"),
    "starcoder2-7b": (2, 4096, 4096, 36, 4, 128, True, 0, "bfloat16"),
    "llama3-405b": (2, 4096, 4096, 128, 8, 128, True, 0, "bfloat16"),
    "hymba-1.5b": (2, 4096, 4096, 25, 5, 64, True, 2048, "bfloat16"),
    "mixtral-8x22b": (2, 4096, 4096, 48, 8, 128, True, 0, "bfloat16"),
    # whisper-tiny's encoder: non-causal, 1 500 frames (ragged last tile)
    "whisper-tiny encoder": (16, 1500, 1500, 6, 6, 64, False, 0,
                             "bfloat16"),
    # llava's 576 patches + 4 096 tokens (ragged)
    "llava-next-mistral-7b": (2, 4672, 4672, 32, 8, 128, True, 0,
                              "bfloat16"),
    "granite-8b q_offset": (1, 1024, 4096, 32, 8, 128, True, 0, "bfloat16"),
    "granite-8b f32": (2, 4096, 4096, 32, 8, 128, True, 0, "float32"),
    "gemma-7b f32": (1, 4096, 4096, 16, 16, 256, True, 0, "float32"),
    # the f32 hymba path's shape (phase 34): hd 64, the 2048-token window
    "hymba-1.5b f32": (2, 4096, 4096, 25, 5, 64, True, 2048, "float32"),
}
# the path shapes also timed against the plain version and SDPA
FLASH_LIBRARY = ("granite-8b", "hymba-1.5b", "mixtral-8x22b",
                 "whisper-tiny", "llava-next-mistral-7b", "gemma-7b",
                 "starcoder2-7b", "llama3-405b")
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
# depth cuts for one 80 GB card, beside the naive run's peak
DBRX_LAYERS = 6          # of 40: ~6.5 GB a layer
LLAMA3_LAYERS = 2        # of 126: ~6.4 GB a layer + 8.4 GB of embeddings,
#                          and ~41 GiB of f32 scores in the naive attention
#                          (at 4 layers it ran out of memory there)
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


def logits_at(model, params, batch, positions):
    """``lm_loss``'s logits at ``positions`` of every row (text positions
    for the VLM), over the real vocabulary (not the padded rows
    ``lm_loss`` masks with -1e30): f32 [B*P, vocab]."""
    from repro_torch.models import transformer as tf
    h = tf.lm_hidden(model.cfg, params, batch["tokens"], impl=model.impl,
                     frames=batch.get("frames"),
                     patches=batch.get("patches"))
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


@contextlib.contextmanager
def flash_launches():
    """Every flash kernel launch inside the block, as ``(route, causal,
    BH, Sq, Skv)``, read from a wrapped ``flash_attention.launch_route``
    (the function that launches either kernel)."""
    from repro_torch.kernels import flash_attention
    calls = []
    real = flash_attention.launch_route

    def launch(name, q, k, v, o, *, causal, window, q_offset):
        calls.append((name, bool(causal), q.shape[0], q.shape[1],
                      k.shape[1]))
        return real(name, q, k, v, o, causal=causal, window=window,
                    q_offset=q_offset)

    with swapped(flash_attention, "launch_route", launch):
        yield calls


def expect_split(tag: str, calls: list, want: dict) -> dict:
    """``calls`` (``flash_launches``) counted by (route, causal, BH, Sq,
    Skv) must be ``want`` exactly; returns the counts, keyed by text."""
    import collections
    got = collections.Counter(calls)
    if dict(got) != want:
        raise AssertionError(f"{tag} flash launches {dict(got)}, want {want}")
    return {f"{r} causal={c} BH={bh} Sq={sq} Skv={sk}": n
            for (r, c, bh, sq, sk), n in got.items()}


def stub_inputs(cfg, B: int, dev, *, seed=None, gen=None) -> dict:
    """The frontend stubs' embeddings of a batch of ``B`` (frames for the
    encoder-decoder, patches for the VLM; none for the others), N(0, 1)
    f32: from ``np.random.default_rng(seed)`` as the fixtures draw them,
    or from the torch generator ``gen`` on ``dev``."""
    import numpy as np
    import torch
    n = {"encdec": ("frames", cfg.audio_frames_default),
         "vlm": ("patches", cfg.vlm_patches_default)}.get(cfg.family)
    if n is None:
        return {}
    shape = (B, n[1], cfg.d_model)
    if gen is not None:
        return {n[0]: torch.randn(shape, generator=gen, device=dev)}
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return {n[0]: torch.from_numpy(a).to(dev)}


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


def layer_errors(model, params, batch) -> list:
    """Each layer's sequence mixer (``transformer.mixer``: attention, SSM,
    or both) with ``impl="pallas"`` against ``impl="naive"`` on the same
    input: the residual stream of the naive forward (a decoder-only or
    VLM model: the VLM's patches lead the stream).  Returns each layer's
    max abs difference of the mixer's output over naive's largest entry."""
    import torch
    from repro_torch.models import transformer as tf
    cfg = model.cfg
    x = tf.lm_embed(cfg, params, batch["tokens"], batch.get("patches"))
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
    (``{"probs": [T, E], "experts": [T, k]}`` per call, the dispatch
    groups' tokens in turn)."""
    from repro_torch.models import moe
    calls = []
    real_top_k, real_plan = moe.top_k, moe.dispatch_plan

    def top_k(probs, k):
        calls.append({"probs": probs.reshape(-1, probs.shape[-1])})
        return real_top_k(probs, k)

    def plan(experts, n_experts, cap):
        calls[-1]["experts"] = experts.reshape(-1, experts.shape[-1])
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


# kernels whose ptxas report must show no spill (the first versions of the
# CUDA-core kernels, csrc/v1/, are timed only)
SPILL_FREE = ("flash_attention_tc", "ssd_scan_tc", "flash_attention",
              "ssd_scan")
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
    """ptxas's lines for each kernel (registers, spills, warnings), the
    tensor-core kernels' shared memory and the CUDA-core kernels' blocks
    per SM; fails on a spill in either tensor-core kernel (every instance
    of the SSD one: P boxes 1-4, x by TMA or by the threads, each of which
    must be reported) or in either CUDA-core kernel (not their first
    versions, ``csrc/v1/``, built only to be timed beside them), or on
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
        if k in SPILL_FREE and (
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
    fa = _build.load("flash_attention").flash_attention_blocks_per_sm
    fa.argtypes, fa.restype = [ctypes.c_int64, ctypes.c_int], ctypes.c_int
    sb = _build.load("ssd_scan").ssd_intra_chunk_blocks_per_sm
    sb.argtypes, sb.restype = [ctypes.c_int64] * 3, ctypes.c_int
    say("build", "CUDA-core kernels' blocks per SM (occupancy calculator): "
        "flash_attention f32 by head dim "
        + json.dumps({hd: fa(hd, 1) for hd in (16, 32, 64, 128, 256)})
        + ", ssd_scan by (Q, P, N) " + json.dumps(
            {str(q): sb(*q) for q in ((128, 64, 128), (128, 50, 16),
                                      (16, 8, 16), (256, 50, 16))}))


def first_version(name: str):
    """The C entry point of CUDA-core kernel ``name`` (``flash_attention``
    or ``ssd_scan``) as first written, ``csrc/v1/``, built from its source
    in this call to be timed beside the redesigned kernel.  The first SSD
    kernel takes B and C per head (no ``heads``)."""
    import ctypes
    from repro_torch.kernels import _build
    if name == "flash_attention":
        fn = _build.load("flash_attention_v1").flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5 + [
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p]
    else:
        fn = _build.load("ssd_scan_v1").ssd_intra_chunk_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 5 + [
            ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def in_turns(new, old, iters: int) -> dict:
    """``new`` and ``old`` timed in turns (new, old, old, new) in one
    call: each one's mean of its two times, and the four."""
    turns = [time_ms(f, iters) for f in (new, old, old, new)]
    return dict(ms=(turns[0] + turns[3]) / 2,
                first_version_ms=(turns[1] + turns[2]) / 2,
                turns_ms=turns)


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
        if tag in ("granite-8b f32", "hymba-1.5b f32"):
            # the CUDA-core kernel and its first version on the same
            # inputs, in turns
            o = torch.empty_like(q)
            v1 = first_version("flash_attention")
            stream = torch.cuda.current_stream().cuda_stream

            def old():
                err = v1(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), q.shape[0], k.shape[0], Sq, Skv, hd,
                         int(causal), window, q_offset, hd ** -0.5, 0,
                         stream)
                if err:
                    raise RuntimeError(f"first flash kernel: cudaError {err}")

            rec["in_turns"] = in_turns(
                lambda: flash_attention.launch_route("cuda_core", q, k, v, o,
                                                     **kw), old, iters=5)
            rec["first_version_ms"] = rec["in_turns"]["first_version_ms"]
            rec["share_of_bound_in_turns"] = rec["bound_ms"] \
                / rec["in_turns"]["ms"]
            rec["power"] = nvidia_smi()
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
            dtype=dtype, share_of_bound=head["share_of_bound"]))
        if "first_version_ms" in head:
            entries[-1].update(first_version_ms=head["first_version_ms"],
                               in_turns=head["in_turns"])
    entries[0]["per_case"] = rows
    return tuple(entries)


def scores_rounding(ssd_scan, ref, plain, args, heads: int) -> dict:
    """Phase 7's kernel-vs-plain y error with the scores rounded to bf16,
    taken apart: again on the same inputs; with the plain version's prefix
    sums from ``torch.cumsum``; and at its worst entry (b, c, q, p), the
    scores of that row whose sum lies within 8 f32 steps of a bf16
    rounding midpoint, each with the weight of one bf16 step of it in y
    (the step times L[q, k] dt[k] x[k, p]).  One such weight equal to the
    error says it is one score rounded the other way."""
    import torch
    kw = dict(heads=heads, round_scores=True)

    def y_err():
        d = (ssd_scan.ssd_intra_chunk(*args, **kw)[0]
             - plain(*args, **kw)[0]).abs()
        return float(d.max()), d

    err, d = y_err()
    with swapped(ref, "xla_cumsum", lambda a, dim: torch.cumsum(a, dim)):
        err_torch = y_err()[0]
    x, dt, A, B, C = args
    bh, c, q, p = (int(i) for i in torch.unravel_index(d.argmax(), d.shape))
    g = bh // heads
    s = C[g, c, q].double() @ B[g, c, :q + 1].double().T        # [q + 1]
    a = dt[bh, c].float() * A[bh].float()
    acum = ref.xla_cumsum(a, -1)
    term = (torch.exp(acum[q] - acum[:q + 1]) * dt[bh, c, :q + 1]
            * x[bh, c, :q + 1, p].float()).double()
    step = 2.0 ** (torch.floor(torch.log2(s.abs())) - 7)    # bf16 spacing
    off = (s - (torch.floor(s / step) + 0.5) * step).abs() / (step * 2**-16)
    near = torch.nonzero(off < 8).flatten().tolist()
    return dict(err=err, err_again=y_err()[0], err_torch_cumsum=err_torch,
                at=[bh, c, q, p],
                near_ties=[dict(k=k, score=float(s[k]),
                                f32_steps_from_midpoint=float(off[k]),
                                one_step_in_y=float(step[k] * term[k].abs()))
                           for k in near])


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
    with swapped(ssd_scan, "ssd_intra_chunk", plain):
        rec["ops_ssd_plain_ms"] = time_ms(
            lambda: ops.ssd(x, dtv, A, B, C, chunk=Q), iters=5)
    # the kernel and its first version on the same inputs, in turns
    outs = [torch.empty((b * h, c, Q, p), device=dev),
            torch.empty((b * h, c, p, n), device=dev),
            torch.empty((b * h, c), device=dev)]
    v1 = first_version("ssd_scan")
    stream = torch.cuda.current_stream().cuda_stream

    def old():
        err = v1(*(t.data_ptr() for t in (*args, *outs)), b * h, c, Q, p, n,
                 0, stream)
        if err:
            raise RuntimeError(f"first SSD kernel: cudaError {err}")

    rec["in_turns"] = in_turns(lambda: ssd_scan.launch_route(
        "cuda_core", *args, *outs), old, iters=10)
    rec["first_version_ms"] = rec["in_turns"]["first_version_ms"]
    rec["share_of_bound"] = bound_ms / rec["ms"]
    rec["share_of_bound_in_turns"] = bound_ms / rec["in_turns"]["ms"]
    rec["tflops"] = flops / rec["ms"] / 1e9
    # as ops.ssd now launches it: B and C read by group (heads=64), each
    # read once; the bound counts them once
    grp = (*args[:3], args[3][:b].contiguous(), args[4][:b].contiguous())
    err_g = check("mamba2-1.3b cell, B and C by group", grp, 1e-4,
                  scaled=True, heads=h)
    g_bytes = sum(t.numel() * t.element_size() for t in grp) \
        + 4 * cells * (Q * p + p * n + 1)
    g_bound, g_by = bound(g_bytes, flops, H100_F32_FLOPS)
    rec["by_group"] = dict(
        heads=h, max_abs_err=err_g, bound_ms=g_bound, bound_by=g_by,
        ms=time_ms(lambda: ssd_scan.ssd_intra_chunk(*grp, heads=h)))
    rec["by_group"]["share_of_bound"] = g_bound / rec["by_group"]["ms"]
    rec["power"] = nvidia_smi()
    say("ssd", json.dumps(rec))
    mamba_f32_cell = rec
    # the f32 hymba path's cell (phase 34 at B 2 x S 4096): 64 heads of P
    # 50, N 16 over 32 chunks of 128, B and C by group
    G, heads, c, Q, P, N = SSD_HYMBA_PATH
    hx, hdt, hA, hB, hC = cell_inputs(G * heads, c, Q, P, N, "float32")
    hargs = (hx, hdt, hA, hB[:G].contiguous(), hC[:G].contiguous())
    err_h = check("hymba-1.5b f32 cell", hargs, 1e-4, scaled=True,
                  heads=heads)
    cells = G * heads * c
    tri = Q * (Q + 1) // 2
    h_flops = 2.0 * cells * (tri * N + tri * P + Q * P * N)
    h_bytes = sum(t.numel() * t.element_size() for t in hargs) \
        + 4 * cells * (Q * P + P * N + 1)
    h_bound, h_by = bound(h_bytes, h_flops, H100_F32_FLOPS)
    hy32 = dict(case="hymba-1.5b f32 cell", route="cuda_core", BH=G * heads,
                c=c, Q=Q, P=P, N=N, heads=heads, dtype="float32",
                max_abs_err=err_h, bound_ms=h_bound, bound_by=h_by,
                gflop=h_flops / 1e9, mbytes=h_bytes / 1e6,
                ms=time_ms(lambda: ssd_scan.ssd_intra_chunk(
                    *hargs, heads=heads)),
                plain_ms=time_ms(lambda: plain(*hargs, heads=heads),
                                 iters=5))
    hy32["share_of_bound"] = h_bound / hy32["ms"]
    say("ssd", json.dumps(hy32))
    del hx, hdt, hA, hB, hC, hargs, grp

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
    rec["rounded_scores_err"] = scores_rounding(ssd_scan, ref, plain, args,
                                                heads)
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
        dtype="float32", share_of_bound=cell["share_of_bound"],
        first_version_ms=cell["first_version_ms"],
        in_turns=cell["in_turns"], by_group=cell["by_group"],
        hymba_f32_cell={k: hy32[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound")})
    return tc, tc_x, cuda_core


F32_HYMBA = dict(B=2, S=2560)        # phase 34: past the 2048-token window
POSITIONS_F32 = [0, 1, 127, 128, 2047, 2048, 2559]
# phase 34, impl="pallas" vs "naive" with f32 weights: every product in f32
# on both sides, so they differ by f32 summation orders and by the chunk
# states' bf16 rounding (ssd_chunked) where those orders flip one.  Logits
# to 2^-8 of the largest, the loss to rel 1e-4.
F32_LOGIT_REL = 2.0 ** -8
F32_LOSS_RTOL = 1e-4


def phase_f32_hymba(dev, kmods, smi) -> dict:
    """Phase 34: hymba-1.5b at full width and 2 layers with f32 weights
    (``Model(param_dtype=torch.float32)``, weights drawn from a seed on the
    card), B 2 x S 2560.  Attention and the SSD block see f32 inputs, so
    ``impl="pallas"`` takes both CUDA-core kernels: 2 flash launches (hd 64,
    the 2048-token window) and 2 SSD launches (P 50, N 16, B and C by
    group), and no other.  Held against ``impl="naive"`` by the logits at
    ``POSITIONS_F32`` and the loss; the check must reject two planted
    faults (keys 128 back dropped; ``y_diag`` zeroed).  Returns the
    forward's launch counts, its wall and errors."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops, ssd_scan
    from repro_torch.models.model import Model
    t = time.perf_counter()
    cfg = get_config("hymba-1.5b").scaled(n_layers=2)
    gen = torch.Generator(device=dev).manual_seed(34)
    f32 = torch.float32
    pallas, naive = (Model(cfg, impl=impl, param_dtype=f32)
                     for impl in ("pallas", "naive"))
    params = pallas.init(gen, device=dev)
    toks = torch.randint(0, cfg.vocab, (F32_HYMBA["B"], F32_HYMBA["S"]),
                         generator=gen, device=dev)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    with torch.no_grad():
        zero(kmods)
        t0 = time.perf_counter()
        got = logits_at(pallas, params, batch, POSITIONS_F32)
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        launches = counts(kmods)
        expect_counts("f32 hymba forward", launches,
                      per_layer(2, "flash_attention", "ssd_scan"))
        want = logits_at(naive, params, batch, POSITIONS_F32)
        loss = {m.impl: float(m.loss(params, batch))
                for m in (pallas, naive)}

    def measure():
        with torch.no_grad():
            lg = logits_at(pallas, params, batch, POSITIONS_F32)
        return float((lg - want).abs().max() / want.abs().max())

    err = float((got - want).abs().max() / want.abs().max())
    loss_rel = abs(loss["pallas"] - loss["naive"]) / abs(loss["naive"])
    if not (err <= F32_LOGIT_REL and loss_rel <= F32_LOSS_RTOL
            and math.isfinite(loss["pallas"])):
        raise AssertionError(f"f32 hymba: pallas vs naive logits {err} "
                             f"(limit {F32_LOGIT_REL}), loss {loss}")
    faults = planted_faults(
        {"keys 128 back dropped": flash_faults(ops)["keys 128 back dropped"],
         "y_diag zeroed": ssd_faults(ssd_scan)["y_diag zeroed"]},
        pallas, params, batch, measure, F32_LOGIT_REL)
    out = dict(arch="hymba-1.5b", layers=2, param_dtype="float32",
               **F32_HYMBA, launches=launches, forward_s=forward_s,
               logit_err=err, limit=F32_LOGIT_REL, loss=loss,
               loss_rel=loss_rel, faults=faults,
               wall_s=time.perf_counter() - t, power=smi)
    say("f32-hymba", json.dumps(out))
    return out


def phase_reference(dev, kmods, tag: str, fixture: str, expect: dict,
                    faults, split=None) -> dict:
    """A model at full width and a few layers vs the JAX package's
    fixture; ``Model.loss`` must launch the kernels as ``expect`` says
    (per forward) and nothing else, and the flash kernel as ``split`` says
    by (route, causal, shape) (``expect_split``) if given.  The fixture's
    frontend stubs (frames, patches) are drawn from its seed.
    ``faults(params)``: the faults the logit check must reject.  A fixture
    with ``routing`` (MoE) also holds every layer's top-k experts per token
    and its dropped assignments exactly, and its check rejects a fault
    that moves either."""
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
    if "extras" in fx:
        batch.update(stub_inputs(cfg, len(lb["tokens"]), dev,
                                 seed=fx["extras"]["seed"]))
    zero(kmods)
    with flash_launches() as calls, torch.no_grad():
        loss = float(model.loss(params, batch))
    path = counts(kmods)
    expect_counts(f"{tag} Model.loss", path, expect)
    by_kind = expect_split(tag, calls, split) if split else None
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

    row0 = {k: v[:1] for k, v in batch.items()}   # the fixture's row

    def forward():
        """Logits at the fixture's positions of the batch's first row,
        their top-5 error and, for MoE, the routing of every layer."""
        with moe_routing() as calls, torch.no_grad():
            lg = logits_at(model, params, row0, f["positions"])
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
               **({"flash_launches": by_kind} if by_kind else {}),
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
               layers: int = 0, B: int = 2, S: int = 4096,
               split=None) -> dict:
    """A model at full size (``layers``: a cut depth, at full width): the
    forward of B x S tokens (with random frames or patches for the
    encoder-decoder and the VLM) with the kernels (launched as ``expect``
    says, nothing else; the flash kernel as ``split`` says by route,
    causality and shape, if given) against ``impl="naive"``, and
    serving.  ``forced``: ``(label, obj,
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
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen, device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             **stub_inputs(cfg, B, dev, gen=gen)}
    with torch.no_grad():
        model.loss(params, {k: v[:, :128] for k, v in batch.items()})
        zero(kmods)
        with flash_launches() as calls:
            t = time.perf_counter()
            loss_p = float(model.loss(params, batch))
            t_fwd = time.perf_counter() - t
        path = counts(kmods)
        expect_counts(f"{tag} forward", path, expect)
        by_kind = expect_split(f"{tag} forward", calls, split) if split \
            else None
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
        lg_p = logits_at(model, params, batch, positions)
        lg_n = logits_at(naive, params, batch, positions)
        peak_all = torch.cuda.max_memory_allocated(dev)
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
                naive, params, batch, positions))
        errs = layer_errors(model, params, batch)
        extra["layer_errs"] = errs
        err, limit = max(errs), LOGIT_REL

        def measure():
            return max(layer_errors(model, params, batch))
    else:
        err, limit = logit_err, FULL_LOGIT_REL

        def measure():
            return naive_err(logits_at(model, params, batch,
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
               **({"flash_launches": by_kind} if by_kind else {}),
               peak_gib=peak_fwd / 2**30,
               peak_gib_with_naive=peak_all / 2**30, power=smi, **extra)
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
    if "compiled" in names:
        # the compiled trace from the port's own step, which must be the
        # one of the reference's HLO text
        traces = [(n, own_compiled_trace(figures, tr, dev) if
                   n == "compiled" else tr) for n, tr in traces]
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


def own_compiled_trace(figures, hlo_trace, dev):
    """fig7's compiled trace built from the port's psum step
    (``workloads/graph.py``), scaled as ``figures.fig7_traces`` scales it:
    it must equal ``hlo_trace`` (from ``fig7_psum.hlo.txt``) phase by
    phase, and the step with its two sums left uncombined must not."""
    import torch
    import torch.distributed._functional_collectives as funcol
    from repro_torch.core.constants import Fabric
    from repro_torch.core.topology import build_xcym
    from repro_torch.workloads import graph
    from repro_torch.workloads.mapping import DeviceMap
    dm = DeviceMap(build_xcym(figures.N_CHIPS, figures.N_MEM,
                              Fabric.WIRELESS), figures.N_DEV)

    def same(tr) -> bool:
        return (tr.name, tr.phases, tr.meta) == \
            (hlo_trace.name, hlo_trace.phases, hlo_trace.meta)

    own = figures.autoscale(graph.psum_trace(dm, dev))
    if not same(own):
        raise AssertionError(f"fig7: the port's psum trace {own.describe()}"
                             f" != the HLO's {hlo_trace.describe()}")

    def uncombined(x, w, group):
        y = torch.tanh(x @ w)
        return (funcol.wait_tensor(funcol.all_reduce(y, "sum", group)),
                funcol.wait_tensor(funcol.all_reduce(y @ w.T, "sum", group)))

    with swapped(graph, "psum_step", uncombined):
        bad = figures.autoscale(graph.psum_trace(dm, dev))
    if same(bad):
        raise AssertionError("fig7: two uncombined sums give the HLO's "
                             "trace")
    say("fig7", f"compiled trace from the port's step: {own.describe()}; "
        f"uncombined: {bad.describe()} (rejected)")
    return own


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


def phase_hybrid(dev, kmods, smi) -> dict:
    """Phases 16-17: hymba-1.5b at 2 layers against its fixture and then
    at full size.  Returns the full forward's launch counts."""
    from repro_torch.kernels import ops, ssd_scan
    from repro_torch.models import transformer as tf

    hymba = FLASH_TC + SSD_TC     # both tensor-core routes (SSD: P 50)
    paths = {}
    t = time.perf_counter()
    phase_reference(dev, kmods, "hymba-2l", "hymba1p5b_2l_reference.json",
                    per_layer(2, *hymba),
                    lambda params: hybrid_faults(tf, params))
    full = phase_full(
        dev, kmods, smi, "hymba", "hymba-1.5b",
        per_layer(32, *hymba),
        {"y_diag zeroed": ssd_faults(ssd_scan)["y_diag zeroed"],
         "keys 128 back dropped": flash_faults(ops)["keys 128 back dropped"]},
        POSITIONS_MAMBA, forced=cuda_core_ssd(ssd_scan), by_layer=True)
    paths["hymba-1.5b forward"] = full["forward"]["launches"]
    say("hymba", f"phases 16-17 wall {time.perf_counter() - t:.1f} s")
    return paths


def phase_moe(dev, kmods, smi) -> dict:
    """Phases 18-19: mixtral-8x22b at 2 layers against its fixture and
    then at full width and ``MIXTRAL_LAYERS`` (~74 GiB at its peak: it
    runs alone on the card).  Returns the full forward's launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    paths = {}
    t = time.perf_counter()
    phase_reference(dev, kmods, "mixtral-2l",
                    "mixtral8x22b_2l_reference.json",
                    per_layer(2, *FLASH_TC), lambda params: moe_faults(moe))
    full = phase_full(dev, kmods, smi, "mixtral", "mixtral-8x22b",
                      per_layer(MIXTRAL_LAYERS, *FLASH_TC), flash_faults(ops),
                      POSITIONS_FULL, by_layer=True, layers=MIXTRAL_LAYERS)
    paths[f"mixtral-8x22b forward, {MIXTRAL_LAYERS} layers"] = \
        full["forward"]["launches"]
    say("mixtral", f"phases 18-19 wall {time.perf_counter() - t:.1f} s")
    return paths


NEW_ARCHS = (("gemma-7b", 0, False), ("starcoder2-7b", 0, False),
             ("dbrx-132b", DBRX_LAYERS, True),
             ("llama3-405b", LLAMA3_LAYERS, False))


def phase_archs(dev, kmods, smi) -> dict:
    """Phases 29-32: gemma-7b and starcoder2-7b at full size, dbrx-132b
    and llama3-405b at full width and a cut depth, each forward held
    against ``impl="naive"`` (dbrx's layer by layer, its MoE layers as
    mixtral's), one tensor-core flash launch a layer at the model's
    heads and sequence, serving, and the flash entry point's two faults.
    Returns each forward's launch counts."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    paths = {}
    for arch, layers, by_layer in NEW_ARCHS:
        t = time.perf_counter()
        cfg = get_config(arch)
        n = layers or cfg.n_layers
        tag = arch.split("-")[0]
        full = phase_full(dev, kmods, smi, tag, arch,
                          per_layer(n, *FLASH_TC), flash_faults(ops),
                          POSITIONS_FULL, by_layer=by_layer, layers=layers,
                          split={("tensor_core", True, 2 * cfg.n_heads, 4096,
                                  4096): n})
        name = f"{arch} forward" + (f", {n} layers" if layers else "")
        paths[name] = full["forward"]["launches"]
        say(tag, f"{name}: wall {time.perf_counter() - t:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# the scatter engine and the paper's fig2-fig6 and ablations (phases 20-21)

SCATTER_CYCLES = 140     # one living window boundary (128) past warm-up
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


# ---------------------------------------------------------------------------
# the encoder-decoder, the VLM and the training path (phases 22-24)

POSITIONS_WHISPER = [0, 1, 63, 64, 127, 128, 300, 447]   # decoder tokens
WHISPER_FULL = dict(B=16, S=448)     # 16 x 1 500 frames, 448 tokens
LLAVA_FULL = dict(B=2, S=4096)       # 2 x (576 patches + 4 096 tokens)


def whisper_faults(ops) -> dict:
    """The encoder's self-attention made causal: every flash call causal
    (the decoder's already is, and the cross-attention takes the blockwise
    path, not the kernel)."""
    real = ops.flash_attention

    def causal(q, k, v, **kw):
        kw["causal"] = True
        return real(q, k, v, **kw)

    return {"encoder made causal": (ops, "flash_attention", causal)}


def vlm_faults(tf) -> dict:
    """The VLM's layout: the patches put after the tokens; the loss taken
    over the first rows, patch positions included, not the text's."""
    import torch
    return {"patches after the tokens": (
                tf, "vlm_prefix", lambda px, x: torch.cat([x, px], dim=1)),
            "loss over the patch positions": (
                tf, "text_rows", lambda h, n: h[:, :n])}


def phase_encdec_vlm(dev, kmods, smi) -> dict:
    """Phases 22-23: whisper-tiny at full size against its fixture and
    against ``impl="naive"`` at B 16 (the flash kernel's non-causal,
    ragged path), llava-next-mistral-7b at 2 layers against its fixture
    and at full size (4 672 rows).  Returns each full forward's launch
    counts."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    paths = {}
    t0 = time.perf_counter()
    W = WHISPER_FULL
    enc, dec = ("tensor_core", False, 2 * 6, 1500, 1500), \
        ("tensor_core", True, 2 * 6, 448, 448)
    phase_reference(dev, kmods, "whisper", "whisper_tiny_reference.json",
                    per_layer(8, *FLASH_TC), lambda params: {
                        **whisper_faults(ops), **flash_faults(ops)},
                    split={enc: 4, dec: 4})
    bh = W["B"] * 6
    full = phase_full(
        dev, kmods, smi, "whisper", "whisper-tiny", per_layer(8, *FLASH_TC),
        {**whisper_faults(ops), **flash_faults(ops)}, POSITIONS_WHISPER,
        B=W["B"], S=W["S"],
        split={("tensor_core", False, bh, 1500, 1500): 4,
               ("tensor_core", True, bh, W["S"], W["S"]): 4})
    paths[f"whisper-tiny forward, B {W['B']}, 4 + 4 layers"] = \
        full["forward"]["launches"]
    say("whisper", f"phase 22 wall {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    L = LLAVA_FULL
    rows = 576 + 2048
    phase_reference(dev, kmods, "llava-2l", "llava_2l_reference.json",
                    per_layer(2, *FLASH_TC), lambda params: vlm_faults(tf),
                    split={("tensor_core", True, 32, rows, rows): 2})
    rows = 576 + L["S"]
    full = phase_full(
        dev, kmods, smi, "llava", "llava-next-mistral-7b",
        per_layer(32, *FLASH_TC), flash_faults(ops), POSITIONS_FULL,
        by_layer=True, B=L["B"], S=L["S"],
        split={("tensor_core", True, L["B"] * 32, rows, rows): 32})
    paths[f"llava-next-mistral-7b forward, {rows} rows, 32 layers"] = \
        full["forward"]["launches"]
    say("llava", f"phase 23 wall {time.perf_counter() - t0:.1f} s")
    return paths


TRAIN_FIXTURE = "train_hymba_2l_reference.json"
# The port on the card against the JAX package op by op on the CPU: four
# steps of hymba-1.5b at full width and 2 layers at lr up to 2.4e-3.  The
# gradients of the two packages differ by ~1% (bf16 activations rounded
# after sums taken in another order; 99.5% of the signs agree), the first
# AdamW step is nearly lr * sign(g), and the second step's gradient norm
# is a spike (58) that amplifies those differences (measured on the CPU,
# the port against the same fixture: loss 4.4e-3, gnorm 0.15 at the
# spike, 1e-3 before it; mean |p - p0| within 2.6% on every matrix and f32
# leaf; m 10%, v 17%).  So the check holds aggregates, each with ~2x
# margin over that measurement: per step loss, gnorm, lr; per leaf the
# mean |p - p0| (matrices and f32 leaves), the mean |m| and mean v, and
# the share of sampled entries moved in the fixture's direction; the norm
# weights sit at 1.0, where a bf16 step moves an entry by a whole ulp or
# not at all, so their moves are held summed over the layers' norm
# vectors (measured 6%) and for the final norm's vector (27%).
TRAIN_TOL = dict(loss=2e-2, gnorm=0.3, lr=1e-6, move=0.1, norms=0.3,
                 final_norm=0.6, m=0.3, v=0.5)
TRAIN_DIRECTION = 0.85       # sampled entries moved as in the fixture
DRILL_STEPS, DRILL_EVERY, DRILL_FAIL = 6, 2, 3
# the restart drill against an uninterrupted run of the same program:
# bitwise where the card's ops are deterministic; an atomic add in a
# backward (an index's gradient) can move one f32 sum and then a bf16
# rounding, so the share of entries of a leaf that differ is held to 5%
# and each step's loss to the fixture's tolerance
DRILL_SHARE = 0.05


def train_setup(cfg, fx: dict, steps: int, dev, impl="blockwise"):
    """``launch/train.py``'s pieces for ``steps`` steps of the fixture's
    shape: the step function, the optimizer, and the batch of a step on
    ``dev``."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import Model
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    opt = AdamW(lr=cosine_schedule(fx["lr"], warmup=max(steps // 20, 5),
                                   total=steps))
    fn = make_train_step(Model(cfg, impl=impl, xent_chunk=fx["xent_chunk"]),
                         opt)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=fx["seq"],
                                  global_batch=fx["batch"]))

    def batch(i):
        b = data.batch(i)
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}, \
            int(b["tokens"].sum())

    return fn, opt, batch


def clone_tree(tree):
    return {k: clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def train_fixture_errors(fx: dict, cfg, p0, dev) -> tuple:
    """The fixture's four steps from a copy of ``p0``; returns (the worst
    ratio of an error to its ``TRAIN_TOL``, the ratios by check, the
    metrics)."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as tf
    fn, opt, batch = train_setup(cfg, fx, fx["steps"], dev)
    params = clone_tree(p0)
    st = opt.init(params)
    got = []
    for i in range(fx["steps"]):
        b, tsum = batch(i)
        params, st, m = fn(params, st, b)
        got.append({k: float(v) for k, v in m.items()} | {"tokens_sum": tsum})
    ratio = {}

    def put(key, err, tol):
        ratio[key] = max(ratio.get(key, 0.0), err / tol)

    for g, w in zip(got, fx["metrics"]):
        if g["tokens_sum"] != w["tokens_sum"]:
            put("data", math.inf, 1.0)
        for k in ("loss", "gnorm", "lr"):
            put(k, abs(g[k] - w[k]) / abs(w[k]), TRAIN_TOL[k])
    p0f = dict(tf.leaves(p0))
    moments = {"m": dict(tf.leaves(st.m)), "v": dict(tf.leaves(st.v))}
    norms = [0.0, 0.0]                    # the layers' norm vectors' moves
    for name, p in tf.leaves(params):
        w = fx["leaves"][name]
        pf, p0n = p.float(), p0f[name].float()
        move = float((pf - p0n).abs().mean())
        rel = abs(move - w["mean_abs_delta"]) / max(w["mean_abs_delta"],
                                                     1e-30)
        is_norm = ("['ln" in name or "['norm_w']" in name) \
            and not tf.is_f32_leaf(name)
        if is_norm and name.startswith("['layers']"):
            norms[0] += move * p.numel()
            norms[1] += w["mean_abs_delta"] * p.numel()
        elif is_norm:
            put("final_norm", rel, TRAIN_TOL["final_norm"])
        else:
            put("move", rel, TRAIN_TOL["move"])
            idx = torch.from_numpy(np.random.default_rng(
                [fx["sample_seed"], p.numel()]).integers(
                    0, p.numel(), min(fx["sample"], p.numel()))).to(p.device)
            got_s = pf.reshape(-1)[idx].cpu().numpy()
            s0 = p0n.reshape(-1)[idx].cpu().numpy()
            want_s = np.array(w["sample"], np.float32)
            moved = (got_s != s0) | (want_s != s0)
            agree = float(np.mean(np.sign(got_s - s0)[moved]
                                  == np.sign(want_s - s0)[moved]))
            put("direction", (1 - agree) / (1 - TRAIN_DIRECTION), 1.0)
        mm = float(moments["m"][name].abs().mean())
        put("m", abs(mm - w["m_mean_abs"]) / max(w["m_mean_abs"], 1e-30),
            TRAIN_TOL["m"])
        vm = float(moments["v"][name].mean())
        put("v", abs(vm - w["v_mean"]) / max(w["v_mean"], 1e-30),
            TRAIN_TOL["v"])
    if norms[1]:
        put("norms", abs(norms[0] - norms[1]) / norms[1], TRAIN_TOL["norms"])
    return max(ratio.values()), ratio, got


def train_faults(optimizer, n_layers: int) -> dict:
    """Faults in AdamW: the bias correction dropped; the clip skipped (the
    norm still reported); weight decay on the matrices only, not on the
    stacked per-layer vectors the reference's ``ndim >= 2`` decays with
    them (as its comment, "matrices only", reads); weight decay on every
    leaf, the final norm's vector too."""
    import torch
    return {"bias correction dropped": (
                optimizer, "bias_correction", lambda b, step: torch.ones(())),
            "clip skipped": (
                optimizer, "clip_scale", lambda g, clip: torch.ones_like(g)),
            "layer vectors not decayed": (
                optimizer, "decayed", lambda p: p.ndim >= 2 and not (
                    p.ndim == 2 and p.shape[0] == n_layers)),
            "final norm decayed": (optimizer, "decayed", lambda p: True)}


def restart_drill(cfg, fx: dict, p0, dev) -> dict:
    """``RestartableLoop`` with a ``CheckpointManager`` in a temporary
    directory (a checkpoint every ``DRILL_EVERY`` steps): a step that
    fails once at ``DRILL_FAIL``, after its update was written into the
    parameters, restores the last checkpoint and replays; its final
    parameters and per-step losses against an uninterrupted run; then one
    flipped byte in the newest checkpoint, which ``latest_step`` must skip."""
    import os
    import tempfile
    import torch
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.checkpoint.fault_tolerance import RestartableLoop
    from repro_torch.models import transformer as tf
    fn, opt, batch = train_setup(cfg, fx, DRILL_STEPS, dev)

    def run(fail_at, directory):
        losses, failed = {}, set()

        def one(state, i):
            params, st, m = fn(*state, batch(i)[0])
            losses[i] = float(m["loss"])
            if i == fail_at and i not in failed:
                failed.add(i)
                raise RuntimeError(f"planted failure after step {i}")
            return params, st

        params = clone_tree(p0)
        state = (params, opt.init(params))
        if directory is None:
            for i in range(DRILL_STEPS):
                state = one(state, i)
            return state, losses, {"restarts": 0}
        ckpt = CheckpointManager(directory, keep=2)
        loop = RestartableLoop(ckpt, ckpt_every=DRILL_EVERY)
        state, diag = loop.run(state, one, DRILL_STEPS)
        return state, losses, diag

    t = time.perf_counter()
    (want, _), want_l, _ = run(None, None)
    t_plain = time.perf_counter() - t
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        (got, st), got_l, diag = run(DRILL_FAIL, d)
        t_drill = time.perf_counter() - t
        ckpt = CheckpointManager(d, keep=2)
        steps = ckpt.all_steps()
        newest = ckpt.latest_step()
        f = os.path.join(d, f"step_{newest:010d}", "leaf_00000.npy")
        with open(f, "r+b") as fh:          # flip the leaf's last byte
            fh.seek(-1, os.SEEK_END)
            byte = fh.read(1)
            fh.seek(-1, os.SEEK_END)
            fh.write(bytes([byte[0] ^ 0x40]))
        fallback = ckpt.latest_step()
        restored = ckpt.restore(fallback, (got, st))
    if diag["restarts"] != 1:
        raise AssertionError(f"restart drill: {diag['restarts']} restarts, "
                             "want 1")
    if sorted(got_l) != list(range(DRILL_STEPS)):
        raise AssertionError(f"restart drill ran steps {sorted(got_l)}")
    if steps != [DRILL_STEPS - DRILL_EVERY, DRILL_STEPS] \
            or newest != DRILL_STEPS \
            or fallback != DRILL_STEPS - DRILL_EVERY:
        raise AssertionError(f"checkpoints {steps}: newest {newest}, after "
                             f"the flipped byte {fallback}")
    diff = {}
    for (name, a), (_, b) in zip(tf.leaves(got), tf.leaves(want)):
        diff[name] = float((a.float() != b.float()).float().mean())
    bitwise = not any(diff.values()) and got_l == want_l
    loss_err = max(abs(got_l[i] - want_l[i]) / abs(want_l[i])
                   for i in want_l)
    if loss_err > TRAIN_TOL["loss"] or max(diff.values()) > DRILL_SHARE:
        raise AssertionError(f"restart drill vs uninterrupted: loss rel err "
                             f"{loss_err}, shares {diff}")
    return dict(restarts=diag["restarts"], checkpoints=steps,
                latest_after_flip=fallback, bitwise=bitwise,
                loss_rel_err=loss_err, worst_share=max(diff.values()),
                restored_step=int(restored[1].step), plain_s=t_plain,
                drill_s=t_drill, losses=[want_l[i] for i in sorted(want_l)])


def phase_train(dev, kmods, smi) -> dict:
    """Phase 24: the training path on hymba-1.5b, ``launch/train.py``'s
    default arch: four ``make_train_step`` steps at full width and 2
    layers (``impl="blockwise"``, as the reference) against the JAX
    fixture, with three planted AdamW faults; the launch counts (0: the
    path launches no kernel of this repository) and a step with
    ``impl="pallas"`` (it raises); the restart drill; then
    ``launch/train.py`` at full size, 12 steps."""
    import torch
    from repro_torch import carry
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.train import optimizer
    t0 = time.perf_counter()
    fx = json.loads((ROOT / "tests" / "torch_fixtures" / TRAIN_FIXTURE)
                    .read_text())
    cfg = get_config(fx["arch"]).scaled(n_layers=fx["n_layers"])
    p0 = carry.numpy_params(
        cfg, fx["weights_seed"],
        leaf_fn=lambda name, a: carry.leaf_to_device(name, a, dev),
        rounded=False)
    zero(kmods)
    t = time.perf_counter()
    worst, ratios, got = train_fixture_errors(fx, cfg, p0, dev)
    t_fixture = time.perf_counter() - t
    path = counts(kmods)
    expect_counts("training step", path, {})
    if not worst <= 1.0:
        raise AssertionError(f"training vs fixture: error / tolerance "
                             f"{ratios}")
    why = {}
    for name, (obj, attr, fake) in train_faults(
            optimizer, cfg.n_layers).items():
        with swapped(obj, attr, fake):
            w, r, _ = train_fixture_errors(fx, cfg, p0, dev)
        if not w > 1.0:
            raise AssertionError(f"fault '{name}' passes the training "
                                 f"check: {r}")
        why[name] = {k: v for k, v in r.items() if v > 1.0}
    fn, opt, batch = train_setup(cfg, fx, fx["steps"], dev, impl="pallas")
    try:
        params = clone_tree(p0)
        fn(params, opt.init(params), batch(0)[0])
    except RuntimeError as e:
        if "impl='blockwise'" not in str(e):
            raise
        pallas = str(e).split(":")[0]
    else:
        raise AssertionError("a training step with impl='pallas' ran")
    drill = restart_drill(cfg, fx, p0, dev)
    del p0
    torch.cuda.empty_cache()
    rec = dict(fixture_ratios=ratios, steps=got,
               fixture_metrics=fx["metrics"], fixture_s=t_fixture,
               kernel_launches_on_path=path, faults_rejected=why,
               pallas_step_raises=pallas, restart_drill=drill,
               wall_s=time.perf_counter() - t0, power=smi)
    say("train-2l", json.dumps(rec))

    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    zero(kmods)
    B, S, steps = 8, 256, 12
    res = launch_train.main(["--arch", "hymba-1.5b", "--steps", str(steps),
                             "--batch", str(B), "--seq", str(S),
                             "--log-every", "1"])
    full_path = counts(kmods)
    losses = res["losses"]
    expect_counts("launch/train.py", full_path, {})
    if not (all(map(math.isfinite, losses)) and len(losses) == steps
            and max(losses[-3:]) < losses[0]):
        raise AssertionError(f"full-size training losses {losses}")
    warm = res["step_s"][2:]                 # the first steps warm up
    full = dict(arch="hymba-1.5b", layers=32, batch=B, seq=S, steps=steps,
                losses=losses, step_ms=[1e3 * x for x in res["step_s"]],
                step_ms_mean_after_2=1e3 * sum(warm) / len(warm),
                tokens_per_s=B * S * len(warm) / sum(warm),
                wall_s=res["wall_s"], kernel_launches_on_path=full_path,
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                power=nvidia_smi())
    say("train-full", json.dumps(full))
    say("train", f"phase 24 wall {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return dict(fixture=rec, full=full)


DP_STEPS = 8                 # phase 25: cosine warm-up 5, then falling
PP_LAYERS = 32               # phase 26: hymba-1.5b at full depth
PP_MICRO = 4
# phase 26, the one-stage pipeline against ``Model.loss`` on the card:
# the same layers run on microbatches of 2 rows instead of 8, so cuBLAS
# may pick other kernels (other sums, other bf16 roundings), and autograd
# adds each leaf's four microbatch gradients in bf16; the loss to rel
# ``loss``, each gradient leaf to ``grad`` in relative L2 norm
PP_TOL = dict(loss=1e-3, grad=5e-2)


@contextlib.contextmanager
def process_group(dev):
    """A process group of one rank on the card (NCCL), left on exit."""
    from repro_torch.launch import mesh
    mesh.init_distributed(device=dev)
    try:
        yield mesh
    finally:
        mesh.shutdown()


def quantize_matches_cpu(grads: list, err: list) -> dict:
    """``quantize`` and the residual of ``g + err`` for every leaf on the
    card and on the CPU: the leaves whose codes, scale or residual
    differ in any bit."""
    import torch
    from repro_torch.train import grad_compress as gc
    bad, n = [], 0
    for i, (g, e) in enumerate(zip(grads, err)):
        gf = g.float() + e
        q, s = gc.quantize(gf)
        r = gc._residual(gf, q, s)
        gc_, q_, s_, r_ = (x.cpu() for x in (gf, q, s, r))
        cq, cs = gc.quantize(gc_)
        cr = gc._residual(gc_, cq, cs)
        n += gf.numel()
        if not (torch.equal(cq, q_) and torch.equal(cs, s_)
                and torch.equal(cr, r_)):
            bad.append(i)
    return {"leaves_differing": bad, "values": n}


def phase_dp(dev, kmods, smi, step24_ms: float) -> dict:
    """Phase 25: ``make_dp_train_step`` with int8 error feedback on a
    one-rank NCCL group, hymba-1.5b at full size."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.interconnect import scheduler
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import Model
    from repro_torch.train import grad_compress as gc
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    t0 = time.perf_counter()
    B, S, steps = 8, 256, DP_STEPS
    cfg = get_config("hymba-1.5b")
    with process_group(dev) as M:
        host = M.make_host_mesh(device=dev)
        model = Model(cfg, xent_chunk=128)
        opt = AdamW(lr=cosine_schedule(3e-3, warmup=max(steps // 20, 5),
                                       total=steps))
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        st, err = opt.init(params), gc.init_error(params)
        cc = gc.CompressionConfig()
        fn = gc.make_dp_train_step(model, opt, host, cc, device=dev)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S,
                                      global_batch=B))
        torch.cuda.reset_peak_memory_stats(dev)
        losses, step_s = [], []
        zero(kmods)
        for i in range(steps):
            b = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch(i).items()}
            t = time.perf_counter()
            params, st, err, m = fn(params, st, err, b)
            losses.append(float(m["loss"]))          # waits for the step
            step_s.append(time.perf_counter() - t)
        path = counts(kmods)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        expect_counts("compressed DP step", path, {})
        if not (all(map(math.isfinite, losses))
                and max(losses[-2:]) < losses[0]):
            raise AssertionError(f"compressed DP losses {losses}")
        # one step's gradients with the carried residual: card == CPU
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch(steps).items()}
        _, grads = value_and_grad(model.loss, params, b)
        t = time.perf_counter()
        quant = quantize_matches_cpu(grads, [e for _, e in tf.leaves(err)])
        quant["seconds"] = time.perf_counter() - t
        if quant["leaves_differing"]:
            raise AssertionError(f"quantize on the card != CPU: {quant}")
        pd = M.make_mesh((1, 1), ("pod", "data"), device=dev)
        tree = tf.unflatten(zip((k for k, _ in tf.leaves(params)), grads))
        same = [k for (k, g), (_, h) in zip(
            tf.leaves(tree), tf.leaves(scheduler.hierarchical_grad_reduce(
                tree, mesh=pd))) if not torch.equal(g, h)]
        if same:
            raise AssertionError(f"hierarchical_grad_reduce on (1, 1) "
                                 f"changed {same}")
        warm = step_s[2:]
        rec = dict(arch="hymba-1.5b", layers=cfg.n_layers, batch=B, seq=S,
                   steps=steps, losses=losses,
                   step_ms=[1e3 * x for x in step_s],
                   step_ms_mean_after_2=1e3 * sum(warm) / len(warm),
                   uncompressed_step_ms_phase24=step24_ms,
                   tokens_per_s=B * S * len(warm) / sum(warm),
                   peak_gib=peak,
                   wire_bytes_int8=gc.wire_bytes_per_step(params, cc),
                   wire_bytes_bf16=gc.wire_bytes_per_step(
                       params, gc.CompressionConfig(enabled=False)),
                   quantize_card_vs_cpu=quant,
                   hierarchical_identity=True,
                   kernel_launches_on_path=path,
                   wall_s=time.perf_counter() - t0, power=nvidia_smi())
        del params, st, err, grads, tree
    torch.cuda.empty_cache()
    say("dp", json.dumps(rec))
    return rec


def pp_errors(pl, pg, sl, sg) -> dict:
    """The pipeline's loss and gradients against the sequential ones: the
    loss's relative error and each leaf's relative L2 error, with their
    ratios to ``PP_TOL``."""
    g = [float((a.float() - b.float()).norm() / b.float().norm())
         for a, b in zip(pg, sg)]
    loss = abs(float(pl) - float(sl)) / abs(float(sl))
    return dict(loss_rel=loss, grad_rel_max=max(g),
                ratio=max(loss / PP_TOL["loss"], max(g) / PP_TOL["grad"]))


def phase_pp(dev, kmods, smi) -> dict:
    """Phase 26: ``make_pp_loss`` with one stage and ``PP_MICRO``
    microbatches against ``Model.loss``, hymba-1.5b at full width."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import Model
    from repro_torch.train import pipeline
    from repro_torch.train.loop import value_and_grad
    t0 = time.perf_counter()
    B, S = 8, 256
    cfg = get_config("hymba-1.5b").scaled(n_layers=PP_LAYERS)
    with process_group(dev) as M:
        host = M.make_host_mesh(device=dev)
        params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                 dev)
        b = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
            DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)
        ).batch(0).items()}
        loss_fn = pipeline.make_pp_loss(cfg, host, n_stages=1,
                                        n_micro=PP_MICRO, axis="model",
                                        xent_chunk=128, device=dev)
        seq = Model(cfg, xent_chunk=128).loss
        times = {"pp": [], "seq": []}
        torch.cuda.reset_peak_memory_stats(dev)
        zero(kmods)
        for _ in range(3):
            for name, fn in (("pp", loss_fn), ("seq", seq)):
                t = time.perf_counter()
                out = value_and_grad(fn, params, b)
                torch.cuda.synchronize()
                times[name].append(time.perf_counter() - t)
                if name == "pp":
                    pl, pg = out
                else:
                    sl, sg = out
                del out
        path = counts(kmods)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        expect_counts("pipeline loss", path, {})
        errs = pp_errors(pl, pg, sl, sg)
        rec = dict(arch="hymba-1.5b", layers=PP_LAYERS, batch=B, seq=S,
                   stages=1, micro=PP_MICRO, loss=float(pl),
                   seq_loss=float(sl), errors=errs, tol=PP_TOL,
                   pp_ms=[1e3 * x for x in times["pp"]],
                   seq_ms=[1e3 * x for x in times["seq"]],
                   peak_gib=peak, kernel_launches_on_path=path,
                   wall_s=time.perf_counter() - t0, power=nvidia_smi())
        del params, pg, sg
    torch.cuda.empty_cache()
    say("pp", json.dumps(rec))
    if not errs["ratio"] <= 1.0:
        raise AssertionError(f"pipeline vs Model.loss: {errs}")
    return rec


# phase 27: the dry run's cells on the card's device type, against the
# reference's compiled cells (``tests/torch_fixtures/dryrun_reference.json``)
DRYRUN_CELLS = (("whisper-tiny", "train_4k", "pod1_16x16"),
                ("hymba-1.5b", "decode_32k", "pod1_16x16"))
DRYRUN_FLOPS_TOL = 0.10        # the port's dot FLOPs against the HLO count
DRYRUN_PP = ("hymba-1.5b", "train_4k", "pod1_16x16", 4)   # phase 27 (c)


def dryrun_fake() -> dict:
    """Phase 27 (a), in a process of its own (``--phase dryrun``): the
    cells of ``DRYRUN_CELLS`` on a fake process group of 512 ranks, the
    meshes on the card's device type; the card's allocated bytes before
    and after."""
    import torch
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.launch import dryrun, mesh
    dev = torch.device("cuda")
    before = torch.cuda.memory_allocated(dev)
    mesh.init_fake(512)
    try:
        meshes = dict(dryrun.make_meshes("both", dev))
        # FakeTensorMode probes the CUDA context once per device form with
        # a 4-byte tensor of its own (``init_gpu_context``): done here, so
        # that the peak read after the cells is theirs alone
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            for d in (dev, torch.device("cuda", torch.cuda.current_device())):
                torch.empty(1, device=d)
        setup_max = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        rows = [dryrun.run_cell(get_config(a), SHAPES[s], meshes[m], m,
                                device=dev, seq_shard_decode=True)
                for a, s, m in DRYRUN_CELLS]
        wall = time.perf_counter() - t
        cells_max = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        a, s, m, pp = DRYRUN_PP
        t = time.perf_counter()
        pp_row = dryrun.run_cell(get_config(a), SHAPES[s], meshes[m], m,
                                 device=dev, seq_shard_decode=True, pp=pp)
        pp_wall = time.perf_counter() - t
        pp_max = torch.cuda.max_memory_allocated(dev)
    finally:
        mesh.shutdown()
    return dict(rows=rows, wall_s=wall, pp_row=pp_row, pp_wall_s=pp_wall,
                pp_max_allocated=pp_max, allocated_before=before,
                allocated_after=torch.cuda.memory_allocated(dev),
                max_allocated_setup=setup_max, max_allocated=cells_max)


def dryrun_errors(row: dict, fx: dict) -> list:
    """What in one dry-run row disagrees with the reference's fixture:
    status, per-device argument bytes (every argument against the
    declared shardings; the arguments read against
    ``argument_size_in_bytes``), ``model_flops``, dot FLOPs within
    ``DRYRUN_FLOPS_TOL``, collective bytes on a train cell."""
    key = (row["arch"], row["shape"], row["mesh"])
    comp = {(r["arch"], r["shape"], r["mesh"]): r for r in fx["compiled"]}
    grid = {(r["arch"], r["shape"], r["mesh"]): r for r in fx["grid"]}
    ref, cell = comp[key], grid[key]
    bad = []
    if row["status"] != ref["status"]:
        return [f"status {row['status'][:300]} != {ref['status']}"]
    if row["status"] != "OK":
        return bad
    if row["arg_bytes_per_dev"] != cell["arg_bytes_per_dev"]:
        bad.append(f"arg bytes {row['arg_bytes_per_dev']} != "
                   f"{cell['arg_bytes_per_dev']}")
    if row["read_arg_bytes_per_dev"] != ref["argument_size_in_bytes"]:
        bad.append(f"read arg bytes {row['read_arg_bytes_per_dev']} != "
                   f"{ref['argument_size_in_bytes']}")
    if row["model_flops"] != cell["model_flops"]:
        bad.append(f"model_flops {row['model_flops']} != "
                   f"{cell['model_flops']}")
    ratio = row["flops_per_dev"] / ref["flops_per_dev"]
    if not abs(ratio - 1) <= DRYRUN_FLOPS_TOL:
        bad.append(f"flops ratio {ratio}")
    if row["shape"].startswith("train") and \
            not row["coll_bytes_per_dev"] > 0:
        bad.append("no collective bytes on a train cell")
    return bad


def dryrun_pp_errors(row: dict, ref: dict) -> list:
    """What in phase 27 (c)'s row disagrees with the reference's ``pp``
    cell (``dryrun_flags_reference.json``): status, argument bytes exact,
    dot FLOPs within ``DRYRUN_FLOPS_TOL``, the hand-offs 2 (M + S - 1)
    collective-permutes over the 16 stages (stride 1) of the rank's f32
    boundary buffer each."""
    from repro_torch.configs.base import SHAPES, get_config
    if row["status"] != ref["status"]:
        return [f"status {row['status'][:300]} != {ref['status']}"]
    arch, shape, _, M = DRYRUN_PP
    cfg, sh = get_config(arch), SHAPES[shape]
    S, data = 16, 16
    each = sh.global_batch // M * sh.seq_len * cfg.d_model * 4 // data
    bad = []
    if row["read_arg_bytes_per_dev"] != ref["argument_size_in_bytes"] or \
            row["arg_bytes_per_dev"] != ref["declared_arg_bytes_per_dev"]:
        bad.append(f"arg bytes {row['read_arg_bytes_per_dev']} / "
                   f"{row['arg_bytes_per_dev']} != "
                   f"{ref['argument_size_in_bytes']}")
    ratio = row["flops_per_dev"] / ref["flops_per_dev"]
    if not abs(ratio - 1) <= DRYRUN_FLOPS_TOL:
        bad.append(f"flops ratio {ratio}")
    n, payload, _ = row["calls_by_group"].get(
        f"collective-permute g={S} stride=1", (0, 0, 0))
    if (n, payload) != (2 * (M + S - 1), 2 * (M + S - 1) * each):
        bad.append(f"hand-offs {n} permutes of {payload} B, want "
                   f"{2 * (M + S - 1)} of {each} B each")
    return bad


class DryrunApart:
    """Phase 27 (a) and (c) in a second process (``python3 chip_smoke.py
    --phase dryrun``), so that its fake group of 512 ranks never meets
    the NCCL group of phases 25-27 (b); its output goes to a temporary
    file; ``join`` returns its record."""

    def __init__(self):
        import tempfile
        self.out = tempfile.NamedTemporaryFile(mode="w+", suffix=".json")
        self.log = tempfile.TemporaryFile(mode="w+")
        self.proc = subprocess.Popen(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             "--phase", "dryrun", self.out.name], cwd=ROOT,
            stdout=self.log, stderr=subprocess.STDOUT)

    def join(self, timeout: float) -> dict:
        try:
            self.proc.wait(timeout=timeout)
        finally:
            self.kill()
        if self.proc.returncode:
            self.log.seek(0)
            raise AssertionError(f"phase 27 (a) failed (exit "
                                 f"{self.proc.returncode}): "
                                 f"{self.log.read()[-3000:]}")
        self.out.seek(0)
        return json.loads(self.out.read())

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def storage_bytes(tensors) -> int:
    """Bytes of the storages under ``tensors``, each storage once."""
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            total += st.nbytes()
    return total


def phase_dryrun(dev, smi, apart: DryrunApart, step24: dict) -> dict:
    """Phase 27: (a) the fake grid's cells against the reference (from
    ``apart``); (b) the dry-run cell of phase 24's training step
    (hymba-1.5b, B 8 x S 256, ``remat="none"``, f32 AdamW state) on a
    (1, 1) mesh of a one-rank group against one real step of it on the
    card: argument bytes equal to the storages the step holds (the step
    counter, a host int in the port, counted as the reference's int32
    scalar), dot FLOPs equal to ``StepAnalysis`` over the real step; the
    dry run's roofline terms and peak beside phase 24's measured step."""
    import torch
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.interconnect import graph_traffic as gt
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import Model
    from repro_torch.train.loop import TrainConfig, make_train_step
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    t0 = time.perf_counter()
    cfg = get_config("hymba-1.5b")
    B, S = step24["batch"], step24["seq"]
    shape = ShapeSpec("train_phase24", S, B, "train")
    with process_group(dev) as M:
        one = M.make_mesh((1, 1), ("data", "model"), device=dev)
        fake = dryrun.run_cell(cfg, shape, one, "1x1", device=dev,
                               remat="none")
    if fake["status"] != "OK":
        raise AssertionError(f"phase 27 (b) dry run: {fake['status']}\n"
                             f"{fake.get('traceback', '')}")
    # phase 24's step (launch/train.py), one step on the card
    model = Model(cfg, xent_chunk=128)
    opt = AdamW(lr=cosine_schedule(3e-3, warmup=5, total=step24["steps"]))
    step = make_train_step(model, opt, TrainConfig(microbatches=1))
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    state = opt.init(params)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)
    ).batch(0).items()}
    held = [t for _, t in tf.leaves(params)] + \
        [t for _, t in tf.leaves(state.m)] + \
        [t for _, t in tf.leaves(state.v)] + list(batch.values())
    real_bytes = storage_bytes(held) + 4          # + the int32 step
    _, st = gt.analyze(step, params, state, batch, arg_tensors=held)
    torch.cuda.synchronize()
    del params, state, batch, held
    torch.cuda.empty_cache()
    real = dict(arg_bytes=real_bytes, flops=st.flops_per_dev)
    step_s = step24["step_ms_mean_after_2"] / 1e3
    rec = dict(
        cell=dict(arch=cfg.name, batch=B, seq=S, remat="none",
                  state_dtype="float32"),
        dryrun={k: fake[k] for k in (
            "flops_per_dev", "bytes_per_dev", "arg_bytes_per_dev",
            "read_arg_bytes_per_dev", "peak_mem_per_dev", "t_compute_ms",
            "t_memory_ms", "t_collective_ms", "compile_s")},
        real_step=real,
        phase24=dict(step_ms=step24["step_ms_mean_after_2"],
                     peak_gib=step24["peak_gib"],
                     max_memory_allocated_bytes=step24["peak_gib"] * 2**30),
        achieved_tflops=fake["flops_per_dev"] / step_s / 1e12,
        share_of_bf16_peak=fake["flops_per_dev"] / step_s / H100.peak_flops,
        power=nvidia_smi())
    if fake["arg_bytes_per_dev"] != real_bytes:
        raise AssertionError(f"phase 27 (b): dry-run argument bytes "
                             f"{fake['arg_bytes_per_dev']} != the step's "
                             f"storages {real_bytes}")
    if fake["flops_per_dev"] != st.flops_per_dev:
        raise AssertionError(f"phase 27 (b): dry-run flops "
                             f"{fake['flops_per_dev']} != the real step's "
                             f"{st.flops_per_dev}")
    say("dryrun-step", json.dumps(rec))

    fx = json.loads((ROOT / "tests" / "torch_fixtures" /
                     "dryrun_reference.json").read_text())
    grid = apart.join(timeout=300)
    cells = []
    for row in grid["rows"]:
        ref = {(r["arch"], r["shape"], r["mesh"]): r for r in fx["compiled"]}[
            (row["arch"], row["shape"], row["mesh"])]
        errs = dryrun_errors(row, fx)
        cells.append(dict(
            cell=f"{row['arch']} {row['shape']} {row['mesh']}",
            status=row["status"][:200], errors=errs,
            flops=row.get("flops_per_dev"),
            ref_flops=ref.get("flops_per_dev"),
            arg_bytes=row.get("arg_bytes_per_dev"),
            read_arg_bytes=row.get("read_arg_bytes_per_dev"),
            ref_argument_size=ref.get("argument_size_in_bytes"),
            coll_by_op=row.get("coll_by_op"),
            ref_coll_by_op=ref.get("coll_by_op"),
            compile_s=row.get("compile_s")))
    pp_ref = {r["name"]: r for r in json.loads(
        (ROOT / "tests" / "torch_fixtures" / "dryrun_flags_reference.json")
        .read_text())["cells"]}["pp"]
    row = grid["pp_row"]
    pp_rec = dict(
        cell=" ".join(str(c) for c in DRYRUN_PP), status=row["status"][:200],
        errors=dryrun_pp_errors(row, pp_ref) + (
            [f"{grid['pp_max_allocated']} B allocated on the card"]
            if grid["pp_max_allocated"] else []),
        wall_s=grid["pp_wall_s"],
        flops=row.get("flops_per_dev"), ref_flops=pp_ref["flops_per_dev"],
        flops_ratio=row.get("flops_per_dev", 0) / pp_ref["flops_per_dev"],
        read_arg_bytes=row.get("read_arg_bytes_per_dev"),
        ref_argument_size=pp_ref["argument_size_in_bytes"],
        calls_by_group=row.get("calls_by_group"),
        ref_coll_counts=pp_ref["coll_counts"],
        ref_permutes=[(p["shape"], p["trip"]) for p in pp_ref["permutes"]],
        coll_by_op=row.get("coll_by_op"), ref_coll_by_op=pp_ref["coll_by_op"])
    say("dryrun-pp", json.dumps(pp_rec))
    if pp_rec["errors"]:
        raise AssertionError(f"phase 27 (c) against the reference: "
                             f"{pp_rec['errors']}")
    fake_rec = dict(cells=cells, wall_s=grid["wall_s"],
                    allocated_before=grid["allocated_before"],
                    allocated_after=grid["allocated_after"],
                    max_allocated_setup=grid["max_allocated_setup"],
                    max_allocated=grid["max_allocated"])
    say("dryrun-fake", json.dumps(fake_rec))
    bad = {c["cell"]: c["errors"] for c in cells if c["errors"]}
    if bad:
        raise AssertionError(f"phase 27 (a) against the reference: {bad}")
    if grid["allocated_after"] != grid["allocated_before"] or \
            grid["max_allocated"]:
        raise AssertionError(f"phase 27 (a) allocated on the card: "
                             f"{fake_rec}")
    say("dryrun", f"phase 27 wall {time.perf_counter() - t0:.1f} s")
    return dict(step=rec, fake=fake_rec)


def _tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tensors(v)
        else:
            yield v


def models_8_to_11(dev, kmods, smi) -> dict:
    """Phases 8-11: granite-8b and mamba2-1.3b, each at 2 layers against
    its fixture and then at full size.  Returns each full forward's launch
    counts."""
    from repro_torch.kernels import ops, ssd_scan
    paths = {}
    t = time.perf_counter()
    phase_reference(dev, kmods, "granite-2l", "granite8b_2l_reference.json",
                    per_layer(2, *FLASH_TC), lambda params: flash_faults(ops))
    full = phase_full(dev, kmods, smi, "granite", "granite-8b",
                      per_layer(36, *FLASH_TC), flash_faults(ops),
                      POSITIONS_FULL)
    paths["granite-8b forward"] = full["forward"]["launches"]
    say("granite", f"phases 8-9 wall {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_reference(dev, kmods, "mamba2-2l", "mamba2_2l_reference.json",
                    per_layer(2, *SSD_TC), lambda params: ssd_faults(ssd_scan))
    full = phase_full(dev, kmods, smi, "mamba2", "mamba2-1.3b",
                      per_layer(48, *SSD_TC), ssd_faults(ssd_scan),
                      POSITIONS_MAMBA, forced=cuda_core_ssd(ssd_scan),
                      by_layer=True)
    paths["mamba2-1.3b forward"] = full["forward"]["launches"]
    say("mamba2", f"phases 10-11 wall {time.perf_counter() - t:.1f} s")
    return paths


def phase_goldens_fig2(dev, kmods, smi) -> None:
    """Phases 4-5: the four open-loop goldens and the fig2 grid at paper
    width against their fixtures (no kernel of this repository runs)."""
    import torch
    from repro_torch.core.constants import Fabric, SimParams
    from repro_torch.core.sweep import SweepPoint, run_sweep_batched
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


def simulator_beside_fig9(dev, kmods, smi) -> None:
    """Phases 4-5, 12-14, 20-21 and 28, the other simulator phases and
    the examples, while fig9 runs in its own process: like fig9 they are
    bound by the host's dispatch while the card idles, so neither slows
    the other much (the model phases, which keep the card busy, run
    alone)."""
    # the goldens, fig2, the simulator's closed-loop memory and trace
    # paths (no kernel of this repository runs on them; each phase reads
    # the counts after)
    phase_goldens_fig2(dev, kmods, smi)
    phase_fig8(dev, kmods, smi)
    phase_memcl(dev, kmods, smi)
    phase_fig7(dev, kmods, smi)
    # the scatter engine against the gather engine, and fig2-fig6 with
    # the ablations at the smoke's cut
    phase_scatter(dev, kmods, smi)
    phase_paper_figs(dev, kmods, smi, "cut")
    phase_examples(dev, kmods, smi)


QUICKSTART_FIELDS = (("pkts_delivered", "flits_delivered", "flits_injected",
                      "cycles_run", "drain_cycle"),
                     ("offered_load", "throughput", "bw_gbps_core",
                      "avg_pkt_latency", "avg_pkt_energy_pj",
                      "energy_pj_bit"))


def check_quickstart(got: list, want: list) -> None:
    """``torch_quickstart.rows``' metrics against the fixture's points
    (fabric-major, loads 1.0 then 0.05): integers exact, floats rel 1e-6
    (NaN where the fixture has NaN)."""
    ints, floats = QUICKSTART_FIELDS
    ms = [(f.name, m) for f, sat, low in got for m in (sat, low)]
    bad = []
    for (fab, m), w in zip(ms, want):
        if fab != w["fabric"]:
            bad.append(f"{fab} != {w['fabric']}")
        for k in ints:
            if int(getattr(m, k)) != w["metrics"][k]:
                bad.append(f"{fab} {w['load']} {k}")
        for k in floats:
            a, b = float(getattr(m, k)), w["metrics"][k]
            if not (math.isnan(a) and math.isnan(b) or close(a, b)):
                bad.append(f"{fab} {w['load']} {k}: {a} vs {b}")
    if bad:
        raise AssertionError(f"quickstart against the reference: {bad}")


def phase_examples(dev, kmods, smi) -> dict:
    """Phase 28: ``examples/torch_quickstart.py``, ``torch_serve_lm.py``
    and ``torch_train_lm.py`` at their JAX scripts' settings (train
    without ``--fast``), their output kept to the end of each; the
    quickstart rows against the fixture's ``script`` set."""
    import io
    import torch
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_quickstart
    import torch_serve_lm
    import torch_train_lm
    fx = json.loads((ROOT / "tests" / "torch_fixtures" /
                     "quickstart_reference.json").read_text())["script"]
    sim = torch_quickstart.SIM
    if fx["sim"] != {"cycles": sim.cycles, "warmup": sim.warmup,
                     "seed": sim.seed}:
        raise AssertionError(f"quickstart budget {sim} != {fx['sim']}")
    rec = {}
    zero(kmods)
    t = time.perf_counter()
    got = torch_quickstart.rows(sim, dev)
    torch.cuda.synchronize()
    rec["quickstart"] = dict(wall_s=time.perf_counter() - t, points=6,
                             table=torch_quickstart.table(got))
    check_quickstart(got, fx["points"])
    # fault: the rows held against another fabric's reference
    shifted = fx["points"][2:] + fx["points"][:2]
    rec["quickstart"]["fault_rejected"] = rejected(
        "quickstart rows of another fabric",
        lambda: check_quickstart(got, shifted))
    for name, mod in (("serve_lm", torch_serve_lm),
                      ("train_lm", torch_train_lm)):
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = mod.main(["--device", "cuda"])
        torch.cuda.synchronize()
        rec[name] = dict(wall_s=time.perf_counter() - t,
                         tail=buf.getvalue().strip().splitlines()[-2:])
        if name == "train_lm":
            rec[name].update(steps=len(out["losses"]),
                             first_loss=out["losses"][0],
                             last_loss=out["losses"][-1],
                             step_ms_median=1e3 * sorted(out["step_s"])[
                                 len(out["step_s"]) // 2])
    rec["kernel_launches"] = counts(kmods)
    expect_counts("examples", rec["kernel_launches"], {})
    rec["power"] = smi
    say("examples", json.dumps(rec))
    return rec


# phase 33's parts, one process each: the four 700-cycle runs alone take
# ~20-30 s of host dispatch, so they split in two, and the drift point
# and the sweep go apart from them
CHUNK_PARTS = ("open:32,96", "open:128,256", "living", "sweep")


def chunk_packed(c: dict, dev):
    """A case of ``chunk_reference.json`` packed by the port, as
    ``make_chunk_reference.packed`` packs it with the JAX package."""
    from repro_torch.core import simulator, traffic
    from repro_torch.core.constants import DEFAULT_PHY, Fabric, SimParams
    from repro_torch.core.routing import compute_routing
    from repro_torch.core.topology import build_xcym
    from repro_torch.phy import PhySweepSpec
    topo = build_xcym(c["n_chips"], c["n_mem"], Fabric(c["fabric"]))
    tt = traffic.uniform_random(topo, c["load"], c["p_mem"],
                                c.get("birth_cycles", c["cycles"]),
                                DEFAULT_PHY.pkt_flits, seed=c["traffic_seed"])
    spec = PhySweepSpec(link_budget_db=c["budget_db"],
                        drift_amp_db=c["drift_amp_db"],
                        reselect=c["reselect"]) if "budget_db" in c else None
    return simulator.pack(topo, compute_routing(topo), tt, DEFAULT_PHY,
                          SimParams(cycles=c["cycles"], warmup=c["warmup"]),
                          phy_spec=spec, device=dev)


def check_state(tag: str, st, want: dict) -> None:
    """Every ``SimState`` leaf against the fixture's record (dtype, shape,
    value): integers exact, floats within rel 1e-6."""
    import base64
    import zlib

    import numpy as np
    bad = []
    for k, v in st._asdict().items():
        w = want[k]
        a = np.frombuffer(zlib.decompress(base64.b64decode(w["data"])),
                          np.dtype(w["dtype"]).newbyteorder("<"))
        a = a.reshape(w["shape"])
        g = v.cpu().numpy()
        if g.dtype != a.dtype or g.shape != a.shape:
            bad.append(f"{k}: {g.dtype}{g.shape} != {a.dtype}{a.shape}")
        elif a.dtype.kind == "f":
            if not np.allclose(g, a, rtol=1e-6, atol=0.0, equal_nan=True):
                bad.append(f"{k}: max |diff| {np.abs(g - a).max()!r}")
        elif not (g == a).all():
            bad.append(f"{k}: {(g != a).sum()} entries differ")
    if set(want) != set(st._fields):
        bad.append(f"leaves {sorted(st._fields)} != {sorted(want)}")
    if bad:
        raise AssertionError(f"{tag} disagrees with the reference: "
                             f"{bad[:6]}{' ...' if len(bad) > 6 else ''}")


def chunk_open(dev, kmods, smi, fx: dict, chunks: list) -> dict:
    """Phase 33 (open): the 700-cycle point at the fixture's ``chunks``,
    each run's wall printed on a line of its own; fault: the drain check
    made to pass at the first chunk boundary past warm-up, while the lane
    still carries traffic (a rerun at the first chunk that stops there)."""
    import torch
    from repro_torch.core import chunked, simulator
    c = fx["case"]
    ps = chunk_packed(c, dev)
    rec = dict(walls_s={}, drain_cycle={})
    zero(kmods)
    for chunk in chunks:
        t = time.perf_counter()
        st = simulator.run(ps, chunk=chunk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        check_state(f"chunk {chunk}", st, fx["chunks"][str(chunk)]["state"])
        rec["walls_s"][chunk] = wall
        rec["drain_cycle"][chunk] = int(st.drain_cycle)
        say("chunk", f"4C4M wireless load {c['load']}, {c['cycles']} cycles "
            f"with {c['warmup']} of warm-up, chunk {chunk}: wall {wall} s, "
            f"{c['cycles'] / wall} cycles/s, drain_cycle "
            f"{int(st.drain_cycle)}; {smi}")
    rec["kernel_launches"] = counts(kmods)
    expect_counts("chunk open", rec["kernel_launches"], {})

    def drained(ss, st, t0, mem_on=False):
        return torch.full((st.pkt_src.shape[0],), t0 >= c["warmup"],
                          device=st.pkt_src.device)

    with swapped(chunked, "drain_done", drained):
        st = simulator.run(ps, chunk=chunks[0])
    rec["faults_rejected"] = [rejected(
        "chunk: drained while the lane carries traffic",
        lambda: check_state("fault", st,
                            fx["chunks"][str(chunks[0])]["state"]))]
    return rec


def chunk_living(dev, kmods, smi, live: dict) -> dict:
    """Phase 33 (living): the drift point at its chunks.  Two faults, no
    rerun: the chunk ignored (the loop run in ``CHUNK_CYCLES`` steps gives
    the chunk-128 run, held against the chunk-96 record), and the window
    replay skipped (the state the driver hands ``replay_windows``, closed
    as the driver closes it)."""
    import torch
    from repro_torch.core import chunked, simulator
    ps = chunk_packed(live["case"], dev)
    rec = dict(walls_s={}, living={})
    replay, seen = chunked.replay_windows, []

    def spy(fn, st, stop, budgets):
        seen.append((st, stop))
        return replay(fn, st, stop, budgets)

    zero(kmods)
    got, handed = {}, {}
    with swapped(chunked, "replay_windows", spy):
        for chunk in live["case"]["chunks"]:
            t = time.perf_counter()
            got[chunk] = simulator.run(ps, chunk=chunk)
            handed[chunk] = seen[-1]
            torch.cuda.synchronize()
            rec["walls_s"][f"living_{chunk}"] = time.perf_counter() - t
            check_state(f"living chunk {chunk}", got[chunk],
                        live["chunks"][str(chunk)]["state"])
            rec["living"][chunk] = dict(
                drain_cycle=int(got[chunk].drain_cycle),
                wl_resel=int(got[chunk].wl_resel))
    rec["kernel_launches"] = counts(kmods)
    expect_counts("chunk living", rec["kernel_launches"], {})
    w96 = live["chunks"]["96"]["state"]
    why = [rejected("chunk ignored (chunk 96 run in chunks of 128)",
                    lambda: check_state("fault", got[128], w96))]
    pre, stop = handed[96]
    ss = simulator.SimStatic(*(x[None] for x in ps.ss))
    skipped = chunked._finalize(ss, pre, torch.tensor(
        stop, dtype=torch.int32, device=dev))
    skipped = simulator.SimState(*(x[0] for x in skipped))
    why.append(rejected("window replay skipped (chunk 96)",
                        lambda: check_state("fault", skipped, w96)))
    rec["faults_rejected"] = why
    return rec


def chunk_sweep(dev, kmods, smi, sw: dict) -> dict:
    """Phase 33 (sweep): the three fabrics under both drivers, with
    ``sweep.POINTS_RUN``'s move; fault: ``driver`` ignored, so that the
    monolithic call runs chunked (its chunked result held against the
    monolithic record: the wireless lane's ``drain_cycle`` differs)."""
    import torch
    from repro_torch.core import sweep
    from repro_torch.core.constants import Fabric, SimParams
    rec = dict(walls_s={})
    zero(kmods)
    got = {}
    pts = [sweep.SweepPoint(sw["case"]["n_chips"], sw["case"]["n_mem"],
                            Fabric(f), load=sw["case"]["load"],
                            p_mem=sw["case"]["p_mem"],
                            sim=SimParams(**sw["case"]["sim"]))
           for f in sw["case"]["fabrics"]]
    before = sweep.POINTS_RUN
    for driver in ("monolithic", "chunked"):
        t = time.perf_counter()
        ms = sweep.run_sweep_batched(pts, cycles=sw["case"]["cycles"],
                                     driver=driver, device=dev)
        torch.cuda.synchronize()
        rec["walls_s"][f"sweep_{driver}"] = time.perf_counter() - t
        for m, want in zip(ms, sw[driver]):
            check_all(f"sweep {driver} {m.name}", m, want)
        rec[f"sweep_{driver}_drain_cycle"] = [m.drain_cycle for m in ms]
        got[driver] = ms
    rec["points_run"] = sweep.POINTS_RUN - before
    if rec["points_run"] != sw["points_run"]:
        raise AssertionError(f"POINTS_RUN moved by {rec['points_run']}, "
                             f"the reference's by {sw['points_run']}")
    rec["kernel_launches"] = counts(kmods)
    expect_counts("chunk sweep", rec["kernel_launches"], {})
    rec["faults_rejected"] = [rejected(
        "driver ignored (the monolithic call run chunked)",
        lambda: [check_all("fault", m, want) for m, want in
                 zip(got["chunked"], sw["monolithic"])])]
    return rec


def phase_chunk(part: str) -> int:
    """Phase 33, in a process of its own for each part of ``CHUNK_PARTS``
    (``python3 chip_smoke.py --phase chunk PART``), beside fig9: the
    port's execution chunk (``simulator.run(chunk=)``) and
    ``run_sweep_batched(driver=)`` on the card against
    ``tests/torch_fixtures/chunk_reference.json``."""
    import torch
    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan
    kmods = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
             "ssd_scan": ssd_scan}
    fx = json.loads((ROOT / "tests" / "torch_fixtures" /
                     "chunk_reference.json").read_text())
    dev, smi = torch.device("cuda"), nvidia_smi()
    t = time.perf_counter()
    if part.startswith("open:"):
        rec = chunk_open(dev, kmods, smi, fx["open"],
                         [int(c) for c in part[5:].split(",")])
    elif part == "living":
        rec = chunk_living(dev, kmods, smi, fx["living"])
    else:
        rec = chunk_sweep(dev, kmods, smi, fx["sweep"])
    rec.update(part=part, wall_s=time.perf_counter() - t, power=smi)
    say("chunk", json.dumps(rec))
    return 0


class Apart:
    """A phase run in a process of its own on the same card (``python3
    chip_smoke.py --phase NAME ...``), beside the phases that follow: a
    phase bound by one host thread's dispatch while the card idles
    overlaps the others.  Its output goes to a temporary file, printed by
    ``join``, which raises if the process failed; ``kill`` stops it if
    this run ends first.  A thread notes when the process ends."""

    def __init__(self, *phase: str):
        import tempfile
        import threading
        self.name = " ".join(phase)
        self.out = tempfile.TemporaryFile(mode="w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             "--phase", *phase], stdout=self.out, stderr=subprocess.STDOUT,
            cwd=ROOT)
        self.ended = threading.Thread(target=self._note_end, daemon=True)
        self.ended.start()

    def _note_end(self) -> None:
        self.proc.wait()
        self.t1 = time.perf_counter()

    def join(self, timeout: float) -> float:
        """Print the process's output; its wall from start to end."""
        rc = self.proc.wait(timeout=timeout)
        self.ended.join()
        wall = self.t1 - self.t0
        self.out.seek(0)
        sys.stdout.write(self.out.read())
        say(self.name, f"its process ended after {wall:.1f} s, exit {rc}")
        if rc:
            raise AssertionError(f"phase {self.name} failed in its process "
                                 f"(exit {rc})")
        return wall

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.out.close()


def main(argv=None) -> int:
    import torch
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if argv[:2] == ["--phase", "dryrun"] and len(argv) == 3:
        # phase 27 (a), in a process of its own
        pathlib.Path(argv[2]).write_text(json.dumps(dryrun_fake()))
        return 0
    if argv[:2] == ["--phase", "chunk"] and argv[2:] in (
            [p] for p in CHUNK_PARTS):     # phase 33, one part
        return phase_chunk(argv[2])
    if argv == ["--phase", "fig9"]:      # fig9, in a process of its own
        from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan
        phase_fig9(torch.device("cuda"),
                   {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
                    "ssd_scan": ssd_scan}, nvidia_smi())
        return 0
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say("env", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    print(smi, flush=True)

    started: list = []          # processes that run_phases starts
    try:
        return run_phases(dev, name, smi, started)
    finally:
        for proc in started:
            proc.kill()


def run_phases(dev, name: str, smi: str, started: list) -> int:
    """Every phase but 1 (see the module docstring for the order); each
    process it starts beside it goes into ``started``."""
    import torch
    from repro_torch.kernels import (_build, flash_attention, ops, ref,
                                     rmsnorm, ssd_scan)
    kmods = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
             "ssd_scan": ssd_scan}
    t = time.perf_counter()
    logs = _build.build()
    say("build", f"{time.perf_counter() - t:.1f} s for {sorted(logs)}")
    build_report(_build, logs)

    kern = phase_rmsnorm(dev, rmsnorm, ops, ref)

    flash_tc, flash_cc = phase_flash(dev, flash_attention, ops, ref, kmods)
    ssd_tc, ssd_tcx, ssd_cc = phase_ssd(dev, ssd_scan, ops, ref, kmods)
    f32 = phase_f32_hymba(dev, kmods, smi)
    # the CUDA-core kernels' main path: the f32 hymba forward of phase 34;
    # their ops.* paths of phases 6-7 kept beside it
    for entry, count in ((flash_cc, "flash_attention"),
                         (ssd_cc, "ssd_scan")):
        entry.update(launches_ops_path=entry["launches"],
                     ops_path=entry["path"], launches=f32["launches"][count],
                     path="hymba-1.5b f32 forward, 2 layers (phase 34)")
    paths = models_8_to_11(dev, kmods, smi)
    # fig9 (phase 15) and phase 27 (a) and (c), the dry run's fake grid
    # (it touches no memory of the card and runs no kernel; read in phase
    # 27), run in processes of their own beside the other host-bound
    # phases; the kernel and model phases run before and after, alone on
    # the card
    fig9 = Apart("fig9")
    started.append(fig9)
    apart = DryrunApart()
    started.append(apart)
    # phase 33, the execution chunk and the sweep's drivers, in processes
    # of their own (host-bound, like fig9)
    chunk = [Apart("chunk", part) for part in CHUNK_PARTS]
    started.extend(chunk)
    simulator_beside_fig9(dev, kmods, smi)
    say("simulator", f"phases 4-5, 12-14, 20-21 and 28 wall "
        f"{time.perf_counter() - fig9.t0:.1f} s, beside fig9")
    say("chunk", f"phase 33 wall {max(a.join(timeout=600) for a in chunk)}"
        f" s in {len(chunk)} processes, beside fig9")
    fig9.join(timeout=1100)
    paths.update(phase_hybrid(dev, kmods, smi))
    paths.update(phase_moe(dev, kmods, smi))
    paths.update(phase_archs(dev, kmods, smi))
    # the encoder-decoder and the VLM, and the training path (no kernel
    # launches on it)
    paths.update(phase_encdec_vlm(dev, kmods, smi))
    train = phase_train(dev, kmods, smi)
    # the distributed training path on a process group of one rank
    phase_dp(dev, kmods, smi, train["full"]["step_ms_mean_after_2"])
    phase_pp(dev, kmods, smi)
    # the dry run: its fake grid's process, started beside fig9, and one
    # real step's cell on a one-rank group
    zero(kmods)
    phase_dryrun(dev, smi, apart, train["full"])
    expect_counts("dry run", counts(kmods), {})

    granite, mamba, hy = ("granite-8b forward", "mamba2-1.3b forward",
                          "hymba-1.5b forward")
    # the main path's launches: the granite forward of phase 9
    flash_tc.update(launches=paths[granite]["flash_attention_tc"],
                    launches_all_routes=paths[granite]["flash_attention"],
                    path=f"{granite} (phase 9)", launches_by_path={
                        k: v["flash_attention_tc"] for k, v in paths.items()
                        if v["flash_attention_tc"]})
    ssd_by_path = {k: v["ssd_scan_tc"] for k, v in paths.items()
                   if v["ssd_scan_tc"]}
    # the SSD's: mamba2's forward of phase 11; the thread-loaded instance
    # (P % 16 != 0) is hymba's
    ssd_tc.update(launches=paths[mamba]["ssd_scan_tc"],
                  launches_all_routes=paths[mamba]["ssd_scan"],
                  path=f"{mamba} (phase 11)", launches_by_path=ssd_by_path)
    ssd_tcx.update(launches=paths[hy]["ssd_scan_tc"],
                   launches_all_routes=paths[hy]["ssd_scan"],
                   path=f"{hy} (phase 17)", launches_by_path=ssd_by_path)

    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": [kern, flash_tc, flash_cc, ssd_tc, ssd_tcx,
                                  ssd_cc]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
