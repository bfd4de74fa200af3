"""Device-resident decoded-picture buffer for the encoder.

The port's counterpart of ks265codec_tpu/encode/devdpb.py. Reference
pictures are produced on the device (the IDR's intra pass and each P
picture's coding pass leave their deblocked planes there) and consumed on
the device (the next pictures' motion search, decision and coding). The
planes are uploaded only for a picture that was reconstructed on the
host. The reference's `_stack3` (K19) is `torch.stack`.
"""

from __future__ import annotations

import numpy as np
import torch


class DeviceDPB:
    """FrameState.serial -> (y, cb, cr) uint8 padded device planes.

    Keyed by the monotonic per-FrameState serial, not id(): ids are reused
    after garbage collection."""

    def __init__(self, device=None):
        self.device = device
        self.entries: dict[int, tuple] = {}

    def put(self, fs, planes) -> None:
        self.entries[fs.serial] = tuple(planes)

    def get_or_upload(self, fs):
        """Device planes of a reference picture; uploads them (once, as a
        copy: `torch.from_numpy` would alias planes the host may reuse)
        when the picture was reconstructed on the host."""
        key = fs.serial
        planes = self.entries.get(key)
        if planes is None:
            if hasattr(fs, "ensure_planes"):
                fs.ensure_planes()
            planes = tuple(torch.tensor(np.asarray(p, np.uint8),
                                        device=self.device)
                           for p in (fs.y, fs.cb, fs.cr))
            self.entries[key] = planes
        return planes

    def trim(self, live_serials) -> None:
        """Drop device planes for pictures no longer in the DPB."""
        for k in list(self.entries):
            if k not in live_serials:
                del self.entries[k]


def stack_refs(dpb: DeviceDPB, ref_pics):
    """(refs_y, refs_cb, refs_cr) device stacks over unique ref pictures."""
    planes = [dpb.get_or_upload(rp.fs) for rp in ref_pics]
    return tuple(torch.stack([p[c] for p in planes]) for c in range(3))
