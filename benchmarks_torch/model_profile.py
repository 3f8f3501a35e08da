"""Where a model's forward and decode ticks, or its training step, spend
their time on the card.

    python3 benchmarks_torch/model_profile.py [--arch ARCH] [--layers N]
    python3 benchmarks_torch/model_profile.py --train [--arch ARCH]

Builds the model at full size (granite-8b: 36 layers; mamba2-1.3b: 48;
hymba-1.5b: 32; mixtral-8x22b at full width needs ``--layers 8`` to fit
one 80 GB card; seeded weights on the card) and reports, from
``torch.profiler`` traces:

- one ``Model.loss`` at B 2 x S 4096 with ``impl="pallas"``: the median
  wall s of three untraced forwards, then from a traced one its wall s,
  device-busy s (the sum of kernel durations), the device's idle share,
  the CUDA kernels it launched,
  and device time grouped into this repo's kernels (the flash kernel, the
  tensor-core and the CUDA-core SSD kernels), matrix products, the MoE
  dispatch (sorts, ``searchsorted``, index scatters and gathers: the
  kernels of ``models/moe.py``'s dispatch and combine, and the embedding's
  one gather) and the rest;
- 16 engine decode ticks with 4 slots and a 4096-slot cache (the SSM
  state, for mamba2) at positions near 64, as in ``chip_smoke.py``'s
  serve phase: host ms per
  tick, CUDA kernels per tick, device-busy ms per tick, idle share and the
  kernels with the most device time.

With ``--train``: ``launch/train.py``'s step (``impl="blockwise"``,
``xent_chunk=128``, AdamW with its cosine schedule) on ``SyntheticLM``
batches of the launcher's B 8 x S 256: the whole step's wall s (the mean of 3
after 2 warm-up steps), tokens/s, device-busy s and idle share, then its
three parts traced one at a time, each ending in a synchronize: the
forward (``Model.loss``), the backward (``torch.autograd.grad``) and the
optimizer (``AdamW.update``), each with wall s, device-busy s, kernels and
device time by group.

Needs a CUDA device; prints the card's name and power limit.
"""
from __future__ import annotations

import collections
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
TICKS = 16
TRAIN_BATCH, TRAIN_SEQ = 8, 256          # launch/train.py's defaults


def _trace(fn):
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
    return wall_us, kernels, by_name


DISPATCH = ("sort", "searchsorted", "index_put", "indexing_backward",
            "index_elementwise", "scatter", "gather", "cub::")


def _group(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "flash kernel"
    if "ssd_intra_tc" in n:
        return "SSD tensor-core kernel"
    if "ssd_intra" in n:
        return "SSD CUDA-core kernel"
    if "gemm" in n or "sm90" in n or "cutlass" in n or "nvjet" in n:
        return "matrix products"
    if any(k in n for k in DISPATCH):
        return "MoE dispatch"
    return "other"


def _summary(wall_us, kernels, by_name) -> dict:
    busy = sum(by_name.values())
    groups = collections.Counter()
    for n, us in by_name.items():
        groups[_group(n)] += us
    return dict(wall_s=wall_us / 1e6, device_busy_s=busy / 1e6,
                device_idle_share=1 - busy / wall_us if kernels else None,
                kernels=len(kernels),
                device_s_by_group={k: v / 1e6 for k, v in groups.items()},
                top_kernels_ms=[(n[:80], us / 1e3)
                                for n, us in by_name.most_common(5)])


def train_profile(cfg, dev, smi: str) -> dict:
    """``launch/train.py``'s step, whole and in its three parts."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import Model
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    model = Model(cfg, xent_chunk=128)
    opt = AdamW(lr=cosine_schedule(3e-3, warmup=5, total=100))
    step = make_train_step(model, opt)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    state = opt.init(params)
    batch, seq = TRAIN_BATCH, TRAIN_SEQ
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch))

    def inputs(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i).items()}

    for i in range(2):                               # warm-up
        params, state, m = step(params, state, inputs(i))
        float(m["loss"])
    t = time.perf_counter()
    for i in range(2, 5):
        params, state, m = step(params, state, inputs(i))
        float(m["loss"])
    step_s = (time.perf_counter() - t) / 3
    b = inputs(5)
    whole = _summary(*_trace(lambda: float(step(params, state, b)[2]
                                           ["loss"])))
    names, ps = zip(*tf.leaves(params))
    alias = [p.detach().requires_grad_(True) for p in ps]
    out = {}

    def forward():
        out["loss"] = model.loss(tf.unflatten(zip(names, alias)), b)

    def backward():
        out["grads"] = torch.autograd.grad(out["loss"], alias,
                                           allow_unused=True)

    def update():
        g = [torch.zeros_like(p) if x is None else x
             for p, x in zip(ps, out["grads"])]
        opt.update(tf.unflatten(zip(names, g)), state, params)

    parts = {name: _summary(*_trace(fn)) for name, fn in
             (("forward", forward), ("backward", backward),
              ("optimizer", update))}
    n_params = sum(p.numel() for p in ps)
    return dict(arch=cfg.name, layers=cfg.n_layers, params=n_params,
                batch=batch, seq=seq, step_s=step_s,
                tokens_per_s=batch * seq / step_s,
                traced_step=whole, parts=parts,
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                power=smi)


def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers (0: the config's)")
    ap.add_argument("--train", action="store_true",
                    help="profile launch/train.py's step instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("model_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    if args.layers:
        cfg = cfg.scaled(n_layers=args.layers)
    if args.train:
        rec = train_profile(cfg, dev, smi)
        print(json.dumps({"train": rec}), flush=True)
        return 0
    model = Model(cfg, impl="pallas")
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (2, 4097), generator=gen, device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    with torch.no_grad():
        model.loss(params, batch)                    # warm-up
        walls = []
        for _ in range(3):
            t = time.perf_counter()
            float(model.loss(params, batch))
            walls.append(time.perf_counter() - t)
        wall_us, kernels, by_name = _trace(lambda: model.loss(params, batch))
    busy = sum(by_name.values())
    groups = collections.Counter()
    for n, us in by_name.items():
        groups[_group(n)] += us
    fwd = dict(arch=cfg.name, layers=cfg.n_layers, tokens=2 * 4096,
               untraced_wall_s=sorted(walls)[1], wall_s=wall_us / 1e6,
               tokens_per_s=2 * 4096e6 / wall_us,
               device_busy_s=busy / 1e6,
               device_idle_share=1 - busy / wall_us if kernels else None,
               kernels=len(kernels),
               device_s_by_group={k: v / 1e6 for k, v in groups.items()},
               top_kernels_ms=[(n[:80], us / 1e3)
                               for n, us in by_name.most_common(6)],
               power=smi)
    print(json.dumps({"forward": fwd}), flush=True)

    slots, max_seq = 4, 4096
    cache = model.init_decode_state(slots, max_seq, device=dev)
    tok = torch.randint(0, cfg.vocab, (slots, 1), generator=gen, device=dev)

    def ticks(n, start):
        nonlocal cache
        for i in range(n):
            logits, cache = model.decode(params, cache, tok, start + i)
            logits.argmax(-1).cpu()                  # the engine's sync

    with torch.no_grad():
        ticks(4, 0)                                  # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        ticks(TICKS, 48)
        host_ms = (time.perf_counter() - t) * 1e3 / TICKS
        wall_us, kernels, by_name = _trace(lambda: ticks(TICKS, 64))
    busy = sum(by_name.values())
    dec = dict(arch=cfg.name, slots=slots, max_seq=max_seq, ticks=TICKS,
               host_ms_per_tick=host_ms,
               traced_wall_ms_per_tick=wall_us / 1e3 / TICKS,
               kernels_per_tick=len(kernels) / TICKS,
               device_busy_ms_per_tick=busy / 1e3 / TICKS,
               device_idle_share=1 - busy / wall_us if kernels else None,
               top_kernels_ms_per_tick=[(n[:80], us / 1e3 / TICKS)
                                        for n, us in by_name.most_common(6)],
               power=smi)
    print(json.dumps({"decode": dec}), flush=True)
    if not busy:
        print("model_profile: the profiler saw no CUDA kernels; device time "
              "not measured", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
