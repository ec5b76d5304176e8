"""Published peaks of the cards the benchmark runs on, by the name that
``torch.cuda.get_device_name()`` gives.

NVIDIA H100 SXM (data sheet, at its full power limit of 700 W): 80 GB
of HBM3 at 3.35 TB/s.  A card set below 700 W reaches less; the run
prints the card's power limit beside every roofline share.
"""

from typing import Optional

HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def hbm_bytes_per_s(kind: str) -> Optional[float]:
    return HBM_BYTES_PER_S.get(kind)
