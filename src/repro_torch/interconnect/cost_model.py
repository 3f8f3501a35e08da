"""Roofline terms + WiMCS-style fabric energy for compiled steps
(counterpart of ``repro/interconnect/cost_model.py``, copied: pure
arithmetic over the port's configs and ``ShapeSpec``; ``V5E``'s constants
are the reference's TPU v5e figures, unchanged).

Three-term roofline (per device):
    compute    = step FLOPs / peak_FLOPs
    memory     = step bytes / HBM_bw
    collective = wire_bytes / link_bw

``H100`` is the port's card, the one place its peak rates are written
(``chip_smoke.py`` and the dry run read them here): H100 SXM, bf16 dense
tensor-core peak 989 TFLOP/s, HBM3 3.35 TB/s, NVLink 4 at 450 GB/s a
direction per GPU as the collective bandwidth, and the 80 GB card's
device memory as ``torch.cuda.get_device_properties(0).total_memory``
reads it.  ``V5E`` is the reference's TPU v5e target (197 TFLOP/s bf16,
819 GB/s, ~50 GB/s a link).  The fabric pJ/bit are the paper's in both.

Fabric energy applies the paper's evaluation axis (pJ/bit) to the step's
collective traffic: the ICI mesh plays the interposer fabric, inter-pod DCN
the substrate serial I/O, and the paper's wireless single-hop medium is the
hypothetical in-package fabric — reported per step for comparison.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HwSpec:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12        # bf16
    hbm_bw: float = 819e9             # B/s
    ici_bw: float = 50e9              # B/s per link
    hbm_bytes: float = 16e9
    # fabric energies (pJ/bit), WiMCS mapping (DESIGN.md §2.2)
    e_ici_pj_bit: float = 1.3         # interposer-class wireline
    e_dcn_pj_bit: float = 5.0         # substrate-class serial I/O
    e_wireless_pj_bit: float = 2.3    # paper's mm-wave in-package link


V5E = HwSpec()

H100 = HwSpec(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
              ici_bw=450e9, hbm_bytes=85_017_493_504)
H100_F32_FLOPS = 67e12            # f32 outside the tensor cores


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    n_devices: int
    model_flops: float                # 6ND / 2ND useful flops (global)
    peak_mem_per_dev: float           # from memory_analysis

    hw: HwSpec = V5E

    @property
    def t_compute(self) -> float:
        return self.flops_per_dev / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_dev / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_dev / self.hw.ici_bw

    @property
    def bottleneck(self) -> str:
        t = {"compute": self.t_compute, "memory": self.t_memory,
             "collective": self.t_collective}
        return max(t, key=t.get)

    @property
    def t_step(self) -> float:
        """No-overlap upper bound: the max term (perfectly overlapped)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flop_ratio(self) -> float:
        hlo_total = self.flops_per_dev * self.n_devices
        return self.model_flops / hlo_total if hlo_total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-model-FLOPs utilization at the no-overlap bound (MFU-like)."""
        total = self.t_step * self.n_devices * self.hw.peak_flops
        return self.model_flops / total if total else 0.0

    def fabric_energy_mj(self) -> dict:
        """Step collective energy (mJ) if carried by each WiMCS fabric."""
        bits = self.coll_bytes_per_dev * self.n_devices * 8
        return {
            "ici_wireline": bits * self.hw.e_ici_pj_bit * 1e-12 * 1e3,
            "dcn_serial": bits * self.hw.e_dcn_pj_bit * 1e-12 * 1e3,
            "wireless_inpackage": bits * self.hw.e_wireless_pj_bit
            * 1e-12 * 1e3,
        }

    def row(self) -> str:
        return (f"{self.arch},{self.shape},{self.mesh},"
                f"{self.t_compute*1e3:.3f},{self.t_memory*1e3:.3f},"
                f"{self.t_collective*1e3:.3f},{self.bottleneck},"
                f"{self.useful_flop_ratio:.3f},{self.roofline_fraction:.3f},"
                f"{self.peak_mem_per_dev/1e9:.2f}")

    HEADER = ("arch,shape,mesh,t_compute_ms,t_memory_ms,t_collective_ms,"
              "bottleneck,useful_flop_ratio,roofline_fraction,mem_GB_dev")


def model_flops(cfg, shape) -> float:
    """Useful FLOPs per step: 6*N*D train, 2*N*D prefill, 2*N_active*B decode."""
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        if cfg.family == "encdec":
            tokens = shape.global_batch * (min(shape.seq_len, 448)
                                           + cfg.audio_frames_default)
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        if cfg.family == "encdec":
            tokens = shape.global_batch * (min(shape.seq_len, 448)
                                           + cfg.audio_frames_default)
        return 2.0 * n_active * tokens
    # decode: one token per sequence + attention over the KV cache
    flops = 2.0 * n_active * shape.global_batch
    if cfg.has_attention:
        kv_len = min(shape.seq_len, cfg.sliding_window) \
            if cfg.sliding_window else shape.seq_len
        flops += (4.0 * cfg.n_layers * cfg.n_heads * cfg.hd * kv_len
                  * shape.global_batch)
    return flops
