"""End-to-end training driver (counterpart of ``repro/launch/train.py``).

One device, as the reference's driver, and eager torch (no compile step
stands in for ``jax.jit``); the data-parallel trainer with compressed
gradients (``train/grad_compress.py``) and the pipeline
(``train/pipeline.py``) run on a process group (``launch/mesh.py``).
With ``--ckpt-dir`` the step loop runs under the fault-tolerance
supervisor: periodic async checkpoints, restore on failure, straggler
logging.

Usage (on the card; ``--device cpu`` runs it on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
      --steps 200 --batch 8 --seq 256 [--smoke] [--ckpt-dir DIR]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as _device
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.checkpoint.fault_tolerance import RestartableLoop
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import transformer as tf
from repro_torch.models.model import Model
from repro_torch.train.loop import TrainConfig, make_train_step
from repro_torch.train.optimizer import AdamW, cosine_schedule


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = Model(cfg, xent_chunk=128)
    opt = AdamW(lr=cosine_schedule(args.lr, warmup=max(args.steps // 20, 5),
                                   total=args.steps))
    step_fn = make_train_step(model, opt,
                              TrainConfig(microbatches=args.microbatches))

    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    opt_state = opt.init(params)
    n_params = sum(int(p.numel()) for _, p in tf.leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M "
          f"batch={args.batch}x{args.seq}", flush=True)

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch))

    def add_extras(batch):
        out = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        if cfg.family == "vlm":
            out["patches"] = torch.zeros(
                (args.batch, cfg.vlm_patches_default, cfg.d_model),
                dtype=torch.float32, device=dev)
        if cfg.family == "encdec":
            out["frames"] = torch.zeros(
                (args.batch, cfg.audio_frames_default, cfg.d_model),
                dtype=torch.float32, device=dev)
        return out

    losses, step_s = [], []

    def one_step(state, step):
        params, opt_state = state
        t0 = time.perf_counter()
        batch = add_extras(data.batch(step))
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])          # waits for the step
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['gnorm']):.3f}", flush=True)
        return (params, opt_state)

    state = (params, opt_state)
    diagnostics = {}
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, keep=2)
        loop = RestartableLoop(ckpt, ckpt_every=args.ckpt_every)
        state, diagnostics = loop.run(state, one_step, args.steps)
    else:
        t0 = time.perf_counter()
        for step in range(args.steps):
            state = one_step(state, step)
        diagnostics["wall_s"] = time.perf_counter() - t0

    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})", flush=True)
    return {"losses": losses, "step_s": step_s, **diagnostics}


if __name__ == "__main__":
    main()
