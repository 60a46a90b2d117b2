"""Analytic roofline model for the fused INT4 kernels.

Counterpart of ``fused4bit_tpu/utils/roofline.py``, with its bytes model and
report; the chip table holds the NVIDIA H100 only. ``H100_SXM`` is NVIDIA's
data sheet for the SXM part (dense rates, at the full 700 W power limit):
3350 GB/s of HBM3, 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32
outside them, 1979 TOP/s int8. A card set below 700 W runs slower under
load; a copy probe on the card (``chip_smoke.py`` prints one) gives the
bandwidth it reaches, which ``measured_hbm_gbps`` takes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ChipSpec", "H100_SXM", "linear_roofline", "RooflineReport"]


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_gbps: float          # HBM bandwidth, GB/s
    bf16_tflops: float       # bf16 tensor-core peak, TFLOP/s
    f32_tflops: float        # float32 peak outside the tensor cores, TFLOP/s
    int8_tops: float         # int8 tensor-core peak, TOP/s

    def peak_ops(self, kind: str) -> float:
        """Operations per second for operands of ``kind`` ("bf16", "f32", "int8")."""
        return {"bf16": self.bf16_tflops, "f32": self.f32_tflops,
                "int8": self.int8_tops}[kind] * 1e12


H100_SXM = ChipSpec(name="NVIDIA H100 SXM", hbm_gbps=3350.0, bf16_tflops=989.0,
                    f32_tflops=67.0, int8_tops=1979.0)


@dataclasses.dataclass
class RooflineReport:
    bytes_moved: int
    flops: int
    arithmetic_intensity: float
    ridge_intensity: float
    bound: str                      # "memory" | "compute"
    sol_latency_us: float           # speed-of-light latency
    achieved_gbps: Optional[float] = None
    achieved_tflops: Optional[float] = None
    pct_of_sol: Optional[float] = None

    def pretty(self) -> str:
        lines = [
            f"bytes/fwd          {self.bytes_moved/1e6:10.2f} MB",
            f"flops/fwd          {self.flops/1e9:10.2f} GFLOP",
            f"arith intensity    {self.arithmetic_intensity:10.2f} flop/byte"
            f" (ridge {self.ridge_intensity:.1f})  -> {self.bound}-bound",
            f"speed-of-light     {self.sol_latency_us:10.1f} us",
        ]
        if self.achieved_gbps is not None:
            lines.append(
                f"achieved           {self.achieved_gbps:10.1f} GB/s"
                f" ({self.pct_of_sol:.0f}% of SoL)"
            )
        if self.achieved_tflops is not None:
            lines.append(f"achieved           {self.achieved_tflops:10.2f} TFLOP/s")
        return "\n".join(lines)


def linear_roofline(
    batch: int,
    in_dim: int,
    out_dim: int,
    *,
    weight_bits: float = 4.0,
    act_bytes: int = 2,
    chip: ChipSpec = H100_SXM,
    measured_s: Optional[float] = None,
    measured_hbm_gbps: Optional[float] = None,
) -> RooflineReport:
    """Roofline for one quantized-linear forward at the bf16 peak.

    Bytes: read x [B, K], read packed [N, K*bits/8], read scales and zero
    points [2N f32], write y [B, N]; operations 2*B*K*N.
    """
    w_bytes = int(out_dim * in_dim * weight_bits / 8) + 8 * out_dim
    bytes_moved = batch * in_dim * act_bytes + w_bytes + batch * out_dim * act_bytes
    flops = 2 * batch * in_dim * out_dim
    ai = flops / bytes_moved
    peak_bw = measured_hbm_gbps or chip.hbm_gbps
    ridge = chip.bf16_tflops * 1e12 / (peak_bw * 1e9)
    bound = "memory" if ai < ridge else "compute"
    sol = max(bytes_moved / (peak_bw * 1e9), flops / (chip.bf16_tflops * 1e12))
    rep = RooflineReport(
        bytes_moved=bytes_moved,
        flops=flops,
        arithmetic_intensity=ai,
        ridge_intensity=ridge,
        bound=bound,
        sol_latency_us=sol * 1e6,
    )
    if measured_s:
        rep.achieved_gbps = bytes_moved / measured_s / 1e9
        rep.achieved_tflops = flops / measured_s / 1e12
        rep.pct_of_sol = 100.0 * sol / measured_s
    return rep
