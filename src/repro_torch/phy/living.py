"""In-scan living-channel updates: SNR drift and rate re-selection (port
of ``repro.phy.living``).

- ``drift_unit``: the seeded thermal-cycle walk.  One knot per
  ``drift_period`` windows per unordered link (the channel is
  reciprocal), drawn from the counter-based murmur3 hash of the ARQ CRC
  (``phy.retx``), linearly interpolated between knots; values in
  ``[0, 1)``, scaled by ``drift_amp_db``.
- ``window_tables``: per-window PER thresholds, goodput estimates and
  (under ``reselect``) the per-link argmax over the rate table.  On a
  static channel it reads the host-packed integer tables ``wl_perq_r`` /
  ``wl_gp_q``, so in-scan re-selection re-derives the host pick; under
  drift it recomputes both in float32 with the reference's compiled
  arithmetic, emulated bit for bit by ``phy.xla_f32``.
- ``make_window_fn``: the ``window_fn(st, t)`` the step applies at every
  window boundary (``t % CHUNK_CYCLES == 0``) and the chunked driver
  replays after an early drain.

Here ``ss``/``st`` are the simulator's lane-leading tuples (a leading lane
dimension G on every leaf) and the cycle ``t`` is a Python int shared by
all lanes.  ``drift_unit`` broadcasts over the shapes of its arguments.
"""
from __future__ import annotations

import torch

from repro_torch.core.chunked import CHUNK_CYCLES
from repro_torch.core.constants import WMAX
from repro_torch.phy.rates import GP_SCALE, PER_Q
from repro_torch.phy.retx import M32, crc_hash
from repro_torch.phy.xla_f32 import fma, per_chain, powf10

# Domain-separation constant: the drift walk and the CRC draw share the
# packed ``phy_seed`` but must be independent streams.
DRIFT_SEED = 0xD51F7EED

f32, i32 = torch.float32, torch.int32


def drift_unit(phy_seed, win, period) -> torch.Tensor:
    """``shape + [WMAX, WMAX]`` f32 aging offsets in ``[0, 1)`` for scan
    window ``win``, where ``shape`` broadcasts ``phy_seed``, ``win`` and
    ``period`` (ints or integer tensors; on the tensors' device, else the
    CPU).

    Symmetric and deterministic in ``(phy_seed, win, period)``; knots sit
    every ``period`` windows, and between knots the offset is the linear
    interpolation ``h0 + (h1 - h0) * frac``, one fused multiply-add as in
    the reference's compiled step.  The hash's top 24 bits become the f32
    mantissa.
    """
    dev = next((x.device for x in (phy_seed, win, period)
                if isinstance(x, torch.Tensor)), None)
    seed = torch.as_tensor(phy_seed, device=dev).to(torch.int64) & M32
    per = torch.as_tensor(period, device=dev).to(i32)
    win = torch.as_tensor(win, device=dev).to(i32)
    ids = torch.arange(WMAX, dtype=i32, device=dev)
    lid = (torch.minimum(ids[:, None], ids[None, :]) * WMAX
           + torch.maximum(ids[:, None], ids[None, :]))
    dseed = (seed ^ DRIFT_SEED)[..., None, None]
    k = win // per
    frac = ((win % per).to(f32) / per.to(f32))[..., None, None]

    def knot(kk):
        return (crc_hash(dseed, lid, kk[..., None, None]) >> 8).to(f32) \
            * (1.0 / (1 << 24))

    h0, h1 = knot(k), knot(k + 1)
    return fma(h1 - h0, frac, h0)


def entry_tables(ss, win: int):
    """The drifted per-entry tables of window ``win``: ``(perq_r, gp_q)``,
    [G, R, WMAX, WMAX] int32 — PER thresholds and quantized goodput from
    the drifted SNR, with the reference's float32 arithmetic
    (``snr - amp * u``, ``10^(snr / 10)``, then the BER and PER chain;
    ``phy.xla_f32`` emulates its compiled form)."""
    u = drift_unit(ss.phy_seed, win, ss.wl_drift_period)         # [G,W,W]
    snr = fma(-ss.wl_drift_amp[:, None, None], u, ss.wl_snr)
    p = powf10(snr * torch.tensor(0.1, dtype=f32, device=snr.device))
    per = per_chain(p[:, None], ss.wl_gain_r[:, :, None, None],
                    ss.wl_pkt_bits[:, None, None, None])          # [G,R,W,W]
    perq_r = torch.clamp(torch.ceil(per * float(1 << PER_Q)),
                         max=float((1 << PER_Q) - 1)).to(i32)
    gp_q = torch.round(ss.wl_gbps_r[:, :, None, None] * (1 - per)
                       * float(GP_SCALE)).to(i32)
    return perq_r, gp_q


def first_argmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first maximum along ``dim`` (``jnp.argmax``'s rule,
    which ``torch.argmax`` does not promise on every device), int32."""
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    ar = torch.arange(n, dtype=i32, device=x.device).view(shape)
    top = x.amax(dim, keepdim=True)
    return torch.where(x == top, ar, n).amin(dim)


def window_tables(ss, rate_prev, win: int, drift_on: bool, reselect: bool):
    """Per-window ``(rate, serv, perq)`` [G, WMAX, WMAX] int32 tables.

    ``rate_prev`` is the carry's current per-link rate entry.  ``drift_on``
    recomputes PER thresholds and quantized goodput from the drifted SNR
    (``entry_tables``), otherwise the host-packed integer tables are read;
    ``reselect`` takes the per-link argmax over the quantized goodput
    (first maximum: ties go to the faster entry, as in the host pass),
    otherwise ``rate_prev`` stays.
    """
    G = rate_prev.shape[0]
    if drift_on:
        perq_r, gp_q = entry_tables(ss, win)
    else:
        perq_r, gp_q = ss.wl_perq_r, ss.wl_gp_q
    rate = first_argmax(gp_q, 1) if reselect else rate_prev
    perq = torch.gather(perq_r, 1, rate[:, None].long())[:, 0]
    serv = torch.gather(ss.wl_serv_r, 1,
                        rate.reshape(G, -1).long()).reshape(rate.shape)
    return rate, serv, perq


def make_window_fn(ss, drift_on: bool, reselect: bool):
    """Window-boundary update ``window_fn(st, t) -> st`` for lanes ``ss``.

    Refreshes the carry's dynamic link tables (``wl_serv_d``,
    ``wl_perq_d``, ``wl_rate_d``) for the window holding cycle ``t`` and
    counts re-selections (``wl_resel``) over the valid off-diagonal
    links.  At window 0 the previous rate is the host selection
    (``ss.wl_rate0``).  A pure function of the window index.
    """
    ids = torch.arange(WMAX, dtype=i32, device=ss.n_wi.device)
    valid = ids < ss.n_wi[:, None]                                # [G,W]
    live = valid[:, :, None] & valid[:, None, :] \
        & (ids[:, None] != ids[None, :])

    def fn(st, t: int):
        win = t // CHUNK_CYCLES
        prev = ss.wl_rate0 if win == 0 else st.wl_rate_d
        rate, serv, perq = window_tables(ss, prev, win, drift_on, reselect)
        changed = live & (rate != prev)
        return st._replace(
            wl_rate_d=rate, wl_serv_d=serv, wl_perq_d=perq,
            wl_resel=st.wl_resel + changed.sum((1, 2), dtype=i32))

    return fn
