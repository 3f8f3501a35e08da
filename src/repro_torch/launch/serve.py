"""Serving entry point: batched decode with the slot engine (counterpart of
``repro/launch/serve.py``).

Usage (on the card; ``--device cpu`` runs it on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      --smoke --requests 8 --max-new 16

``--arch`` takes any decoder-only config (dense, moe, ssm, hybrid); the
default is the reference's, hymba-1.5b.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import get_config
from repro_torch.models.model import Model
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.sampler import SamplerConfig


def serve_requests(model: Model, params, *, requests: int, slots: int,
                   max_seq: int, max_new: int, sampler: SamplerConfig,
                   prompt_lens: tuple[int, int] = (4, 12)) -> dict:
    """Serve ``requests`` random prompts (lengths drawn from
    ``[prompt_lens[0], prompt_lens[1])``, ids from a numpy generator
    seeded 0) and time the whole run (at most 10 000 ticks)."""
    eng = Engine(model, params, slots=slots, max_seq=max_seq,
                 sampler=sampler)
    rng = np.random.default_rng(0)
    for r in range(requests):
        prompt = rng.integers(0, model.cfg.vocab,
                              rng.integers(*prompt_lens)).tolist()
        eng.submit(Request(rid=r, prompt=prompt, max_new=max_new))
    all_reqs = list(eng.queue)

    t0 = time.perf_counter()
    ticks = 0
    while (eng.queue or any(eng.active)) and ticks < 10_000:
        eng.step()
        ticks += 1
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    total = sum(len(r.out) for r in all_reqs)
    return {"requests": all_reqs, "done": sum(r.done for r in all_reqs),
            "tokens": total, "ticks": ticks, "wall_s": dt,
            "tokens_per_s": total / max(dt, 1e-9),
            "prompt_tokens": sum(len(r.prompt) for r in all_reqs)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    res = serve_requests(model, params, requests=args.requests,
                         slots=args.slots, max_seq=args.max_seq,
                         max_new=args.max_new,
                         sampler=SamplerConfig(temperature=args.temperature,
                                               top_k=50))
    print(f"served {args.requests} requests, {res['tokens']} tokens "
          f"in {res['ticks']} ticks, {res['wall_s']:.2f}s "
          f"({res['tokens_per_s']:.1f} tok/s) on {dev}", flush=True)
    for r in res["requests"][:3]:
        print(f"  req {r.rid}: {len(r.out)} tokens {r.out[:8]}...",
              flush=True)
    return {k: res[k] for k in ("tokens", "ticks", "wall_s")}


if __name__ == "__main__":
    main()
