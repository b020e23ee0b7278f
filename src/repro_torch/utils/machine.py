"""Machine roofline profile: detected-or-overridable peak numbers.

Port of ``repro/utils/machine.py``. One ``machine_profile()`` resolves the
card's peaks in priority order: explicit values > ``REPRO_PEAK_FLOPS`` /
``REPRO_HBM_BW`` / ``REPRO_LINK_BW`` env vars > the card's name
(``torch.cuda.get_device_name()``) > the H100 SXM's data sheet, flagged
``assumed=True`` so reports can say so. The table lists NVIDIA parts only,
at NVIDIA's data-sheet figures; the port states no TPU figure.

The module constants are the H100 SXM rates that every bound of
``chip_smoke.py`` divides by. Importing this module touches no device.
"""
from __future__ import annotations

import os
from dataclasses import asdict, dataclass
from typing import Optional

# NVIDIA H100 SXM5 data sheet
HBM_BYTES_PER_S = 3.35e12        # HBM3
FP32_FLOPS_PER_S = 67e12         # fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # dense bf16 on the tensor cores
# fp32 work in 3xTF32 on the tensor cores: three TF32 products per fp32
# multiply-add at the 495 TFLOP/s dense TF32 rate
TF32X3_FLOPS_PER_S = 495e12 / 3
NVLINK_BYTES_PER_S = 50e9        # one NVLink 4 link (900 GB/s over 18)


@dataclass(frozen=True)
class MachineProfile:
    name: str
    peak_flops: float       # peak matmul flops/s per card (dense bf16)
    hbm_bw: float           # HBM bytes/s per card
    link_bw: float          # NVLink bytes/s per link
    assumed: bool = False   # True when nothing was detected or overridden

    def to_dict(self) -> dict:
        return asdict(self)


H100_SXM = MachineProfile("h100-sxm", BF16_FLOPS_PER_S, HBM_BYTES_PER_S,
                          NVLINK_BYTES_PER_S)

# torch.cuda.get_device_name() (prefix-matched, case-insensitive) ->
# data-sheet peaks
_KNOWN = {
    "nvidia h100 80gb hbm3": H100_SXM,
}


def profile_of(device_name: str) -> Optional[MachineProfile]:
    """The table's entry for a card's name, or ``None``."""
    kind = device_name.lower()
    for prefix, prof in _KNOWN.items():
        if kind.startswith(prefix):
            return prof
    return None


def _detect() -> Optional[MachineProfile]:
    try:
        import torch
        if not torch.cuda.is_available():
            return None
        return profile_of(torch.cuda.get_device_name())
    except Exception:
        return None


def _env(name: str) -> Optional[float]:
    v = os.environ.get(name)
    return float(v) if v else None


def machine_profile(peak_flops: Optional[float] = None,
                    hbm_bw: Optional[float] = None,
                    link_bw: Optional[float] = None) -> MachineProfile:
    """Resolve the machine's roofline peaks (module docstring priority)."""
    peak_flops = peak_flops if peak_flops is not None else \
        _env("REPRO_PEAK_FLOPS")
    hbm_bw = hbm_bw if hbm_bw is not None else _env("REPRO_HBM_BW")
    link_bw = link_bw if link_bw is not None else _env("REPRO_LINK_BW")
    base = _detect()
    assumed = base is None and not (peak_flops and hbm_bw and link_bw)
    base = base or H100_SXM
    name = (base.name if base is not H100_SXM or not assumed
            else "h100-sxm-assumed")
    if peak_flops or hbm_bw or link_bw:
        name += "+overrides"
    return MachineProfile(
        name=name,
        peak_flops=peak_flops if peak_flops is not None else base.peak_flops,
        hbm_bw=hbm_bw if hbm_bw is not None else base.hbm_bw,
        link_bw=link_bw if link_bw is not None else base.link_bw,
        assumed=assumed)
