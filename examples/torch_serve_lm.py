"""Serve a small model with batched requests through the slot engine, on
the PyTorch port (``examples/serve_lm.py``'s settings: mamba2-1.3b's
smoke config, 6 requests on 3 slots, 12 new tokens, 64 positions).

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse

from repro_torch.launch import serve as serve_mod


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    argv = ["--arch", "mamba2-1.3b", "--smoke", "--requests", "6",
            "--slots", "3", "--max-new", "12", "--max-seq", "64"]
    if args.device:
        argv += ["--device", args.device]
    out = serve_mod.main(argv)
    if not out["tokens"] > 0:
        raise SystemExit("no token served")
    print("OK: batched serving works (O(1)-state SSM decode).")
    return out


if __name__ == "__main__":
    main()
