"""The port's device rule.

Every entry point takes ``device=None``, which means the CUDA card.  Without a
card the call raises: nothing falls back to the CPU unless the caller asks for
it with ``device="cpu"`` (the tests do), and then the plain torch versions of
the kernels run.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The torch.device an entry point runs on; raises if it is CUDA and
    there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: ceph_tpu_torch runs on the card by "
            "default; pass device='cpu' to run the plain torch path")
    return dev
