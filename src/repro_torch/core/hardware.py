"""Hardware models.

The Select-N algebra needs two numbers per platform: host-link transfer time
for a byte volume, and (for the FlexGen baseline's flawed estimator) peak
compute. Layer *compute* time is never estimated on the real system — it is
measured (the paper's core observation) — but the analytic models here also
power the paper-figure benchmarks, which reproduce the A10 setup of §5
without a GPU, and the TPU v5e roofline terms.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    name: str
    hbm_bytes: float            # device memory capacity
    hbm_bw: float               # bytes/s
    peak_flops: float           # dense fp16/bf16 FLOP/s
    host_link_bw: float         # bytes/s, host<->device (PCIe), per *bus*
    host_link_latency_s: float  # fixed per-transfer latency
    devices_per_bus: int = 1    # accelerators sharing the host link
    ici_bw: float = 0.0         # bytes/s per inter-chip link (TPU)
    # Achievable fractions of peak compute / HBM bandwidth. 1.0 = ideal
    # roofline. Calibrated presets (below) carry measured-equivalent values so
    # the "model" analyzer mode stands in for wall-clock measurement — the
    # peak-FLOPs estimator (``peak_exec_time``) deliberately ignores them,
    # reproducing FlexGen's flaw (paper Observation #2).
    compute_eff: float = 1.0
    mem_eff: float = 1.0

    def transfer_time(self, nbytes: float, bw_fraction: float = 1.0) -> float:
        """Seconds to move nbytes over the host link at a bandwidth share."""
        bw = self.host_link_bw * bw_fraction
        return self.host_link_latency_s + nbytes / bw

    def exec_time(self, flops: float, bytes_moved: float) -> float:
        """Roofline execution-time estimate (max of compute and memory),
        derated by the achievable-efficiency factors."""
        return max(flops / (self.peak_flops * self.compute_eff),
                   bytes_moved / (self.hbm_bw * self.mem_eff))

    def peak_exec_time(self, flops: float) -> float:
        """FlexGen-style peak-FLOPs estimate (the paper's Observation #2:
        systematically underestimates real execution time)."""
        return flops / self.peak_flops


# NVIDIA A10: the paper's evaluation platform (§3, §5).
A10 = HardwareModel(
    name="a10",
    hbm_bytes=24e9,
    hbm_bw=600e9,
    peak_flops=125e12,
    host_link_bw=24e9,          # paper: "The PCIe bandwidth is 24GB/s"
    host_link_latency_s=20e-6,
    devices_per_bus=2,
)

# A10 with measured-equivalent efficiency factors, calibrated so the modeled
# per-layer transfer/compute ratios of Qwen2-beta-7B (batch 4, seq 256) match
# the paper's measured Fig. 2(b): t_t/t_c = 3.5x prefill, 13.8x decode.
# compute_eff = 0.69 ~= real GEMM MFU; mem_eff = 0.58 ~= achievable HBM bw for
# decode GEMV. These stand in for the analyzer's wall-clock measurements when
# reproducing the paper's A10 figures on a CPU-only container.
A10_CALIBRATED = dataclasses.replace(
    A10, name="a10_calibrated", compute_eff=0.69, mem_eff=0.58)

# TPU v5e: this system's deployment target (per chip).
TPU_V5E = HardwareModel(
    name="tpu_v5e",
    hbm_bytes=16e9,
    hbm_bw=819e9,
    peak_flops=197e12,
    host_link_bw=32e9,          # PCIe gen4 x16 per host
    host_link_latency_s=20e-6,
    devices_per_bus=4,          # 4 v5e chips per host VM share the link
    ici_bw=50e9,
)

# NVIDIA H100 SXM (80 GB): the port's target. Datasheet numbers, not
# measured ones: 80 GB HBM3 at 3.35 TB/s, 989 TFLOP/s dense bf16, one card
# per PCIe Gen5 x16 host link (64 GB/s per direction).
H100 = HardwareModel(
    name="h100",
    hbm_bytes=80e9,
    hbm_bw=3.35e12,
    peak_flops=989e12,
    host_link_bw=64e9,
    host_link_latency_s=20e-6,
    devices_per_bus=1,
)

PRESETS = {"a10": A10, "a10_calibrated": A10_CALIBRATED, "tpu_v5e": TPU_V5E,
           "h100": H100}
