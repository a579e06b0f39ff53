"""Published peaks of the cards the benchmark runs on.

HBM bandwidth by a substring of ``torch.cuda.get_device_name()``, first match wins
(NVIDIA's data sheets: H200 4.8 TB/s, H100 NVL 3.9 TB/s, H100 PCIe 2.0 TB/s, H100
SXM 3.35 TB/s). The rates assume the card's full power limit; every result carries
the limit it ran at.
"""

from __future__ import annotations

HBM_BYTES_PER_S = (("H200", 4.8e12), ("NVL", 3.9e12), ("PCIe", 2.0e12), ("H100", 3.35e12))


def hbm_bytes_per_s(device_name: str) -> float:
    for key, rate in HBM_BYTES_PER_S:
        if key in device_name:
            return rate
    raise RuntimeError(f"no HBM peak known for {device_name!r}")
