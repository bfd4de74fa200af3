"""Frame/resource pooling: recycle FrameState objects across pictures.

A 720p FrameState is ~8 MB across ~20 numpy arrays; the reference keeps
equivalent per-picture storage in preallocated pools (CFramePool /
qy265MallocPool arenas, SURVEY.md 2.1 "Resource pools"/"Memory pool") so
the steady-state encode/decode loop performs no allocation. This pool is
the TPU-native analog for the host side: device-side reconstruction
planes already live in the HBM-resident DeviceDPB (encode/devdpb.py) with
trim() as its release path.

Safety: FrameState.reset() assigns a fresh serial on every acquire, so
DeviceDPB/host caches keyed by serial can never alias a recycled frame;
pictures whose device fetch never completed drop (not mutate) the aliased
buffers (see reset()).
"""

from __future__ import annotations


class FramePool:
    """Recycles FrameState objects keyed by picture geometry."""

    def __init__(self, max_per_key: int = 8):
        self._free: dict[tuple, list] = {}
        self._pooled: set[int] = set()      # serials (double-release guard)
        self.max_per_key = max_per_key
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(sps):
        return (sps.pic_width_in_ctbs, sps.pic_height_in_ctbs,
                sps.ctb_size)

    def acquire(self, sps):
        from ..decode.slice_dec import FrameState
        free = self._free.get(self._key(sps))
        if free:
            fs = free.pop()
            self._pooled.discard(fs.serial)
            fs.reset(sps)
            self.hits += 1
            return fs
        self.misses += 1
        return FrameState(sps)

    def release(self, fs) -> None:
        """Return a frame nothing references anymore (not in a DPB, not
        queued for output, not the current picture). Double releases are
        ignored (serial guard)."""
        if fs.serial in self._pooled:
            return
        key = (fs.pw // fs.sps.ctb_size, fs.ph // fs.sps.ctb_size,
               fs.sps.ctb_size)
        lst = self._free.setdefault(key, [])
        if len(lst) < self.max_per_key:
            lst.append(fs)
            self._pooled.add(fs.serial)

    def clear(self) -> None:
        self._free.clear()
        self._pooled.clear()
