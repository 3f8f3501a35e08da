"""Does ``chip_smoke.py`` phase 25's loss curve turn on the rounding of the
SSD prefix sums' gradient?  Its training over several seeds, with that
gradient added in two orders.

    python3 benchmarks_torch/dp_rounding.py [--seeds 0 1 2 3]
        [--grad port reference] [--compress on off] [--src DIR]

Phase 25's run: hymba-1.5b at full size, B 8 x S 256, 8 steps of AdamW
(cosine schedule to 3e-3, warm-up 5) through ``make_dp_train_step`` on a
one-rank NCCL group, with int8 error feedback (``--compress off``: the
plain all-reduce).  Seed s draws the weights from
``Generator.manual_seed(s)`` and the batches from ``DataConfig(seed=s)``;
phase 25 is seed 0.  ``--grad port`` runs the code as it stands;
``--grad reference`` replaces the gradient of ``models/ssm.py``'s
``xla_cumsum`` (``torch.cumsum``'s reversed scan) by the reversed scan in
the reference's order, XLA:CPU's for the transpose of ``jnp.cumsum`` as
jax 0.9.0 compiles it: each suffix sum of a block of 16 added left to
right, the block totals by the same rule, one add of the sum of the
blocks after it.  The forward is the same in both.

Prints the card's name and power limit, then one JSON line per run: the
losses, whether phase 25's check (the last two below the first) holds,
the largest rise from one step to the next, and the step's ms (the mean
after 2 warm-up steps).  ``--src DIR`` imports ``repro_torch`` from DIR
(another checkout's ``src``, to time a parent tree with ``--grad port``).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS, BATCH, SEQ = 8, 8, 256            # chip_smoke.py phase 25
BLOCK = 16


def reversed_scan(a):
    """Suffix sums along the last dim in XLA:CPU's order."""
    import torch.nn.functional as F
    L = a.shape[-1]
    if L <= BLOCK:
        p = F.pad(a, (0, L - 1))
        s = p[..., 0:L]
        for k in range(1, L):
            s = s + p[..., k:k + L]
        return s
    nb = -(-L // BLOCK)
    if nb * BLOCK > L:
        a = F.pad(a, (0, nb * BLOCK - L))
    inner = reversed_scan(a.reshape(*a.shape[:-1], nb, BLOCK))
    after = F.pad(reversed_scan(inner[..., 0])[..., 1:], (0, 1))
    return (inner + after[..., None]).reshape(*a.shape[:-1], -1)[..., :L]


def reference_order(ref):
    """``xla_cumsum`` with the gradient in the reference's order."""
    import torch

    class Cumsum(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, dim):
            ctx.dim = dim
            return ref.xla_cumsum(a, dim)

        @staticmethod
        def backward(ctx, g):
            d = ctx.dim
            return reversed_scan(g.movedim(d, -1)).movedim(-1, d), None
    return Cumsum.apply


def run(seed: int, compress: bool, dev, M) -> dict:
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import Model
    from repro_torch.train import grad_compress as gc
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    cfg = get_config("hymba-1.5b")
    host = M.make_host_mesh(device=dev)
    model = Model(cfg, xent_chunk=128)
    opt = AdamW(lr=cosine_schedule(3e-3, warmup=5, total=STEPS))
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    st, err = opt.init(params), gc.init_error(params)
    fn = gc.make_dp_train_step(model, opt, host,
                               gc.CompressionConfig(enabled=compress),
                               device=dev)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH, seed=seed))
    losses, step_s = [], []
    for i in range(STEPS):
        b = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(i).items()}
        t = time.perf_counter()
        params, st, err, m = fn(params, st, err, b)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t)
    del params, st, err
    torch.cuda.empty_cache()
    warm = step_s[2:]
    return dict(losses=losses,
                check_holds=max(losses[-2:]) < losses[0],
                largest_rise=max(b - a for a, b in zip(losses, losses[1:])),
                step_ms_mean_after_2=1e3 * sum(warm) / len(warm))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--grad", nargs="+", default=["port", "reference"],
                    choices=["port", "reference"])
    ap.add_argument("--compress", nargs="+", default=["on"],
                    choices=["on", "off"])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("dp_rounding: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels import ref
    from repro_torch.launch import mesh
    from repro_torch.models import ssm
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    port = getattr(ssm, "xla_cumsum", None)
    mesh.init_distributed(device=dev)
    try:
        for grad in args.grad:
            if grad == "reference":
                ssm.xla_cumsum = reference_order(ref)
            elif port is not None:
                ssm.xla_cumsum = port
            for compress in args.compress:
                for seed in args.seeds:
                    rec = run(seed, compress == "on", dev, mesh)
                    print(json.dumps(dict(src=args.src, grad=grad,
                                          compress=compress, seed=seed,
                                          **rec, power=smi)), flush=True)
    finally:
        mesh.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
