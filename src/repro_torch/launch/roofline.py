"""Roofline terms of a step from the cost counter's record
(``launch/hlo_analysis.py``).

Terms (per step, across the whole mesh):
    compute    = FLOPs_global      / (chips * PEAK_FLOPS)
    memory     = HBM_bytes_global  / (chips * HBM_BW)
    collective = collective_bytes_dev / LINK_BW    (per-device wire bytes)

The counter reads each rank's local shapes, so its FLOPs and bytes are per
device; the global terms multiply by the chip count.  Collective bytes are
the operand bytes of each c10d collective the rank issued, by kind (x2 for
all-reduce).

Hardware constants: the NVIDIA H100, by SKU (:data:`PEAKS`), from NVIDIA's
datasheet (https://www.nvidia.com/en-us/data-center/h100/); the module's
``PEAK_FLOPS``, ``HBM_BW`` and ``LINK_BW`` are the SXM card's.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class Peaks:
    """One card's datasheet peaks (dense; the sparsity figures are twice)."""
    hbm_bw: float       # device memory, bytes/s
    fp32: float         # fp32 FLOP/s outside the tensor cores (SIMT)
    bf16: float         # bf16 tensor-core FLOP/s
    link_bw: float      # NVLink 4, bytes/s one direction (the PCIe card: its bridge)


PEAKS = {
    "H100 SXM": Peaks(hbm_bw=3.35e12, fp32=67e12, bf16=989e12, link_bw=450e9),
    "H100 PCIe": Peaks(hbm_bw=2.0e12, fp32=51e12, bf16=756e12, link_bw=300e9),
    "H100 NVL": Peaks(hbm_bw=3.9e12, fp32=60e12, bf16=835e12, link_bw=300e9),
}


def sku(device_name: str) -> str:
    """The ``PEAKS`` key of a device named as ``torch.cuda.get_device_name``
    names it (the SXM card unless the name says PCIe or NVL)."""
    return "H100 PCIe" if "PCIe" in device_name else "H100 NVL" if "NVL" in device_name \
        else "H100 SXM"


def peaks(device_name: str) -> Peaks:
    return PEAKS[sku(device_name)]


PEAK_FLOPS = PEAKS["H100 SXM"].bf16      # bf16 per chip, dense
HBM_BW = PEAKS["H100 SXM"].hbm_bw         # bytes/s per chip
LINK_BW = PEAKS["H100 SXM"].link_bw       # bytes/s per chip, one direction of NVLink 4

# q rows per block of the bf16 flash_attention forward kernel
# (``kernels/csrc/flash_attention.cu``, its wgmma kernel's BQ): each block
# reads the whole K/V of its rows' range once
FLASH_Q_BLOCK = 64


def bound(nbytes: float, flops: float, *, hbm_bw: float, peak: float) -> tuple[float, str]:
    """The least time (ms) a kernel could take for ``nbytes`` of device
    memory traffic and ``flops`` operations at ``peak``: the larger of the
    two, and which one it is ("bytes" or "operations")."""
    t_bytes, t_ops = nbytes / hbm_bw, flops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_dev: float
    hlo_bytes_per_dev: float
    coll_bytes_per_dev: float
    model_flops: float            # 6*N*D (active) for the step's tokens
    mem_per_dev: dict[str, float]
    coll_breakdown: dict[str, float]
    scopes: dict[str, list] = dataclasses.field(default_factory=dict)
    seq_len: int = 0

    @property
    def t_compute(self) -> float:
        return self.hlo_flops_per_dev / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes_per_dev / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_dev / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / global counted FLOPs: remat/padding/capacity waste."""
        total = self.hlo_flops_per_dev * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-flops utilization at the roofline step time."""
        return self.model_flops / (self.chips * PEAK_FLOPS * self.step_time) \
            if self.step_time else 0.0

    # -- flash-adjusted memory term ---------------------------------------
    # The plain attention path (what a meta trace counts) materializes the
    # S^2 f32 score chains in device memory; the flash_attention kernel keeps
    # them on chip.  Adjusted traffic replaces the attn_core scope bytes
    # with the analytic flash traffic  F * (2/Bq + 2/S)  (K/V re-read per
    # q block of Bq = FLASH_Q_BLOCK rows, plus the q/o streams).
    @property
    def flash_adjusted_bytes(self) -> float:
        if "attn_core" not in self.scopes:
            return self.hlo_bytes_per_dev
        f_attn, b_attn = self.scopes["attn_core"]
        flash = f_attn * (2.0 / FLASH_Q_BLOCK + (2.0 / self.seq_len if self.seq_len else 0.0))
        return self.hlo_bytes_per_dev - b_attn + flash

    @property
    def t_memory_flash(self) -> float:
        return self.flash_adjusted_bytes / HBM_BW

    @property
    def step_time_flash(self) -> float:
        return max(self.t_compute, self.t_memory_flash, self.t_collective)

    @property
    def mfu_flash(self) -> float:
        return self.model_flops / (self.chips * PEAK_FLOPS * self.step_time_flash) \
            if self.step_time_flash else 0.0

    def to_json(self) -> dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops_per_dev": self.hlo_flops_per_dev,
            "hlo_bytes_per_dev": self.hlo_bytes_per_dev,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck, "step_time_s": self.step_time,
            "useful_flops_ratio": self.useful_flops_ratio, "mfu": self.mfu,
            "t_memory_flash_s": self.t_memory_flash,
            "step_time_flash_s": self.step_time_flash, "mfu_flash": self.mfu_flash,
            "mem_per_dev": self.mem_per_dev,
            "coll_breakdown": self.coll_breakdown,
            "scopes": self.scopes,
        }


def model_flops_for_cell(cfg, cell) -> float:
    """6*N_active*D for train, 2*N_active*D for inference fwd (per step)."""
    n_active = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * cell.global_batch


def analyse(costs, *, arch: str, shape: str, mesh_name: str, chips: int,
            model_flops: float, seq_len: int = 0) -> Roofline:
    """A :class:`Roofline` from the counter's ``Costs`` of one step
    (``hlo_analysis.analyze``), its memory record included.

    ``mem_per_dev`` keeps two cross-check fields: ``upcast_bytes`` (the
    bf16 -> f32 casts, which ``hlo_bytes_per_dev`` includes) and, when the
    step was counted with ``flop_counter=True``, ``flop_counter_flops``,
    ``torch.utils.flop_counter.FlopCounterMode``'s total, which misses the
    hand-written kernels' work on the card (ctypes calls it does not see);
    on meta tensors, where no kernel runs, it equals the counter's FLOPs."""
    mem = dict(costs.memory)
    coll = dict(costs.coll)
    coll.setdefault("total", 0.0)
    return Roofline(arch=arch, shape=shape, mesh=mesh_name, chips=chips,
                    hlo_flops_per_dev=costs.flops, hlo_bytes_per_dev=costs.bytes,
                    coll_bytes_per_dev=coll["total"], model_flops=model_flops,
                    mem_per_dev=mem, coll_breakdown=coll, scopes=dict(costs.scopes),
                    seq_len=seq_len)
