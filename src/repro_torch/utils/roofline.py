"""Three-term roofline model for the NVIDIA H100 SXM5 (port of
``repro/utils/roofline.py``, DESIGN.md §7, with the card's constants in
place of the TPU v5e's):

    t_compute    = FLOPs            / 989e12  FLOP/s  (dense bf16)
    t_memory     = bytes            / 3.35e12 B/s     (HBM3)
    t_collective = collective_bytes / 450e9   B/s     (NVLink 4, one direction)

The constants are NVIDIA's H100 datasheet figures for the SXM5 part: 989
TFLOPS of dense BF16 tensor-core throughput (1,979 with sparsity), 3.35
TB/s of HBM3 bandwidth, and 900 GB/s of NVLink 4 bandwidth, 450 GB/s in
each direction. FLOPs, bytes and collective bytes are PER DEVICE, as the
reference's post-SPMD cost analysis gives them. MODEL_FLOPS uses the
paper-standard 6·N·D (train) / 2·N·D (per decoded token) with N = active
params and is GLOBAL (divided across chips for the useful-compute ratio).
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12        # bf16 dense / card
HBM_BW = 3.35e12           # B/s / card
LINK_BW = 450e9            # B/s / card, NVLink 4, one direction


@dataclasses.dataclass
class Roofline:
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops: float
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Perfect-overlap bound: the dominant term is the step time."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def hlo_flops_global(self) -> float:
        return self.hlo_flops * self.chips

    @property
    def useful_ratio(self) -> float:
        g = self.hlo_flops_global
        return self.model_flops / g if g else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model FLOPs over chip-seconds at the roofline step time."""
        denom = self.chips * PEAK_FLOPS * self.step_time
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "model_flops": self.model_flops, "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes_per_device": self.collective_bytes,
            "useful_ratio": self.useful_ratio, "mfu_bound": self.mfu_bound,
            "chips": self.chips,
        }


def make(hlo_flops_per_dev: float, hlo_bytes_per_dev: float,
         collective_bytes_per_dev: float, chips: int,
         model_flops: float) -> Roofline:
    return Roofline(
        t_compute=hlo_flops_per_dev / PEAK_FLOPS,
        t_memory=hlo_bytes_per_dev / HBM_BW,
        t_collective=collective_bytes_per_dev / LINK_BW,
        model_flops=model_flops, hlo_flops=hlo_flops_per_dev,
        hlo_bytes=hlo_bytes_per_dev,
        collective_bytes=collective_bytes_per_dev, chips=chips)


def model_flops_for(cfg, shape_info: dict) -> float:
    """6·N_active·tokens for train, 2·N_active·tokens for inference."""
    n = cfg.active_param_count()
    kind = shape_info["kind"]
    if kind == "train":
        if cfg.family == "whisper":
            tokens = shape_info["batch"] * (shape_info["seq"] + cfg.dec_len)
        else:
            tokens = shape_info["batch"] * shape_info["seq"]
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = shape_info["batch"] * shape_info["seq"]
        return 2.0 * n * tokens
    # decode: one token per sequence in the batch
    return 2.0 * n * shape_info["batch"]
