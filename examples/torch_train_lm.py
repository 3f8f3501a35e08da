"""End-to-end example on the PyTorch port: train a ~100M-param LM for a
few hundred steps on the synthetic pipeline, with checkpoints and the
fault-tolerant restart loop (``examples/train_lm.py``'s settings).

The architecture is the hymba-1.5b family scaled to ~100M (registered in
``repro_torch.configs.base``'s registry as ``hymba-100m``): the hybrid
(attention + SSD) layer stack runs attention, the SSM, the gated MLP,
AdamW, remat and checkpointing.  ``--fast`` trains hymba-1.5b's smoke
config for 40 steps instead.  Checkpoints go to a temporary directory,
removed at the end.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--fast] [--device cpu]
"""
import argparse
import tempfile

from repro_torch.launch import train as train_mod


def hymba_100m():
    """The ~100M-parameter member of the hymba family, registered."""
    from repro_torch.configs.base import REGISTRY, get_config
    cfg = get_config("hymba-1.5b").scaled(
        name="hymba-100m", n_layers=10, d_model=768, n_heads=12,
        n_kv_heads=6, head_dim=64, d_ff=2304, vocab=32001,
        ssm_head_dim=48, sliding_window=512)
    REGISTRY[cfg.name] = cfg
    return cfg


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--arch", "hymba-1.5b",
                "--steps", "40" if args.fast else "300",
                "--batch", "4", "--seq", "128", "--lr", "1e-3",
                "--ckpt-dir", tmp, "--ckpt-every", "20",
                "--log-every", "5"]
        if args.fast:
            argv.append("--smoke")
        else:
            argv[1] = hymba_100m().name
        if args.device:
            argv += ["--device", args.device]
        out = train_mod.main(argv)
    losses = out["losses"]
    if not losses[-1] < losses[0]:
        raise SystemExit(f"loss should go down: {losses[0]} -> "
                         f"{losses[-1]}")
    print(f"OK: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return out


if __name__ == "__main__":
    main()
