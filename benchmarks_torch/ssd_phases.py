"""Where a block of the tensor-core SSD kernel spends its time, on the card.

    python3 benchmarks_torch/ssd_phases.py [--source FILE ...]

Builds each source of ``ssd_scan_tc.cu`` named (default: the checkout's,
``src/repro_torch/kernels/csrc/ssd_scan_tc.cu``; another version, such as
a parent commit's, for an A/B on one card) with the port's nvcc flags, and
a source that marks its phase boundaries with ``PHASE(k)`` once more with
``-DSSD_PHASE_STAMPS``, where thread 0 (and thread 128) of every block
writes ``%globaltimer`` there.  Prints
ptxas's registers and spills of every instance, then at hymba-1.5b's and
mamba2-1.3b's forward cells (B 2 x 64 heads, 32 chunks of 128; P 50, N 16
and P 64, N 128; bf16, scores rounded, as ``chip_smoke.py`` phase 7):

- each source's kernel time (CUDA events, 50 launches, sources in turns
  a, b, b, a), its outputs held bitwise to the port's wrapper's;
- the stamped build's (where there is one) mean microseconds per block
  in each phase: set-up
  (barriers, TMA issue, x by the threads where P % 16 != 0, acum) up to
  the block barrier; each warpgroup's row blocks of y = W x (S = C B^T,
  W, the products, y's stores; TMA's arrival included); B o w; the state
  tile(s); the whole block; and the blocks resident per SM on average
  (block-microseconds over the span times the SMs used).

A source that refuses a cell's shape is reported so.  Builds go to
``src/repro_torch/kernels/_build/ssd_phases/``.  Needs a CUDA device;
prints the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = {"hymba-1.5b": (2, 64, 32, 128, 50, 16),     # (G, heads, c, Q, P, N)
         "mamba2-1.3b": (2, 64, 32, 128, 64, 128)}
STAMPS = 8            # per block, as the kernel's PHASE(k): 0 start, 1
                      # set-up done, 2/3 y done by warpgroup 0/1, 4 B o w
                      # done, 5 end, 6 SM id
STAMPED = "SSD_PHASE_STAMPS"


def build(src: pathlib.Path, out: pathlib.Path, *flags: str) -> str:
    from repro_torch.kernels import _build
    res = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o",
                          str(out), str(src)], capture_output=True,
                         text=True, timeout=600)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}"
                           f"{res.stderr}")
    return res.stdout + res.stderr


def registers(log: str) -> dict:
    """ptxas's registers and spill bytes per kernel instance."""
    out, entry = {}, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(ssd_intra_tcILi\d"
                      r"(?:ELb[01])?)", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and entry:
            out.setdefault(entry, {})["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.setdefault(entry, {})["registers"] = int(m.group(1))
    return out


def load(path: pathlib.Path) -> ctypes.CDLL | None:
    if not path.exists():
        return None
    lib = ctypes.CDLL(str(path))
    lib.ssd_intra_chunk_tc_fwd.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int64] * 6 + [ctypes.c_int, ctypes.c_void_p]
    lib.ssd_intra_chunk_tc_fwd.restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    import argparse
    import numpy as np
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", type=pathlib.Path,
                    help="an ssd_scan_tc.cu to profile (repeatable)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssd_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ssd_scan
    sources = args.source or [_build.CSRC / "ssd_scan_tc.cu"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out_dir = _build.BUILD_DIR / "ssd_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = []
    for i, src in enumerate(sources):
        src = src.resolve()
        plain_log = build(src, out_dir / f"libplain{i}.so")
        (out_dir / f"libstamped{i}.so").unlink(missing_ok=True)
        if STAMPED in src.read_text():
            build(src, out_dir / f"libstamped{i}.so", f"-D{STAMPED}")
        print(json.dumps(dict(source=str(src), ptxas=registers(plain_log))),
              flush=True)
        libs.append((str(src), load(out_dir / f"libplain{i}.so"),
                     load(out_dir / f"libstamped{i}.so")))

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for cell, (G, heads, c, Q, P, N) in CELLS.items():
        gen = torch.Generator(device=dev).manual_seed(2)
        rnd = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa
        BH = G * heads
        ins = (rnd(BH, c, Q, P).bfloat16(),
               torch.nn.functional.softplus(rnd(BH, c, Q)),
               -torch.exp(0.3 * rnd(BH)), rnd(G, c, Q, N).bfloat16(),
               rnd(G, c, Q, N).bfloat16())
        outs = (torch.empty((BH, c, Q, P), device=dev),
                torch.empty((BH, c, P, N), device=dev),
                torch.empty((BH, c), device=dev))
        want = ssd_scan.ssd_intra_chunk(*ins, heads=heads, round_scores=True)

        def run(lib):
            return lib.ssd_intra_chunk_tc_fwd(
                *(t.data_ptr() for t in (*ins, *outs)), BH, heads, c, Q, P,
                N, 1, stream)

        def time_ms(lib, iters=50):
            for _ in range(3):
                run(lib)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(iters):
                run(lib)
            ev[1].record()
            torch.cuda.synchronize()
            return ev[0].elapsed_time(ev[1]) / iters

        taken = []
        for src, plain, st in libs:
            if run(plain) != 0:
                print(json.dumps(dict(cell=cell, source=src,
                                      refused=[Q, P, N])), flush=True)
                continue
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(outs, want))
            taken.append((src, plain, st, equal))
        order = taken + taken[::-1]
        ms = {}
        for src, plain, _, _ in order:
            ms.setdefault(src, []).append(time_ms(plain))
        for src, _, st, equal in taken:
            if st is None:
                print(json.dumps(dict(cell=cell, source=src, ms=ms[src],
                                      outputs_equal_to_wrapper=equal,
                                      stamped="no PHASE marks", power=smi)),
                      flush=True)
                continue
            if run(st) != 0:
                raise RuntimeError(f"ssd_phases: stamped {src} failed")
            torch.cuda.synchronize()
            nb = BH * c
            buf = (ctypes.c_uint64 * (nb * STAMPS))()
            if st.ssd_phase_stamps(buf, ctypes.sizeof(buf)) != 0:
                raise RuntimeError("ssd_phases: reading the stamps failed")
            p = np.frombuffer(buf, dtype=np.uint64).reshape(nb, STAMPS) \
                .astype(np.int64)
            us = lambda a, b: (p[:, b] - p[:, a]) / 1e3  # noqa
            span = (p[:, 5].max() - p[:, 0].min()) / 1e3
            sms = len(np.unique(p[:, 6]))
            rec = dict(
                cell=cell, source=src, shape=[BH, c, Q, P, N],
                outputs_equal_to_wrapper=equal, ms=ms[src],
                setup_us=float(us(0, 1).mean()),
                y_warpgroup0_us=float(us(1, 2).mean()),
                y_warpgroup1_us=float(us(1, 3).mean()),
                b_o_w_us=float(((p[:, 4] - np.maximum(p[:, 2], p[:, 3]))
                                / 1e3).mean()),
                state_us=float(us(4, 5).mean()),
                block_us=float(us(0, 5).mean()),
                block_us_p90=float(np.percentile(us(0, 5), 90)),
                stamped_span_us=float(span), sms=int(sms),
                blocks_per_sm=float(us(0, 5).sum() / (span * sms)),
                power=smi)
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
