"""Streaming trajectory record / replay.

Long production runs need on-disk trajectories (the reference keeps nothing
— state dies with the window, SURVEY §5). The format is deliberately dumb
and fast: a JSON header, the per-particle constants once (species), then
raw float32 position frames appended sequentially — ~12·N bytes per frame,
written straight from the batched device→host snapshot readback and read
back zero-copy via ``numpy.memmap``.

    P3TRAJ01 | u32 header_len | header JSON | species i32[N] | frames f32[N,3]...

CLI: ``python -m particle3d run --record traj.p3t --snapshot-every 4``
then ``python -m particle3d replay --traj traj.p3t --gif out.gif``.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

_MAGIC = b"P3TRAJ01"


class TrajectoryWriter:
    """Appends position frames; ``meta`` should carry the config (use
    ``checkpoint._config_to_jsonable``) so replay can self-describe."""

    def __init__(self, path: str, n: int, species, meta: dict | None = None):
        self.path = path
        self.n = int(n)
        self.frames = 0
        header = json.dumps({"n": self.n, "meta": meta or {}}).encode()
        self._f = open(path, "wb")
        self._f.write(_MAGIC)
        self._f.write(struct.pack("<I", len(header)))
        self._f.write(header)
        sp = np.ascontiguousarray(np.asarray(species), np.int32)
        if sp.shape != (self.n,):
            raise ValueError(f"species must be [{self.n}], got {sp.shape}")
        self._f.write(sp.tobytes())

    def append(self, positions) -> None:
        pos = np.ascontiguousarray(np.asarray(positions), np.float32)
        if pos.shape != (self.n, 3):
            raise ValueError(f"frame must be [{self.n}, 3], got {pos.shape}")
        self._f.write(pos.tobytes())
        self.frames += 1

    def append_batch(self, frames) -> None:
        """frames f32[K, N, 3] — one write for a whole snapshot batch."""
        arr = np.ascontiguousarray(np.asarray(frames), np.float32)
        if arr.ndim != 3 or arr.shape[1:] != (self.n, 3):
            raise ValueError(f"batch must be [K, {self.n}, 3], got {arr.shape}")
        self._f.write(arr.tobytes())
        self.frames += arr.shape[0]

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TrajectoryReader:
    """Zero-copy random access to recorded frames (numpy memmap)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            if f.read(8) != _MAGIC:
                raise ValueError(f"{path} is not a p3t trajectory")
            (hlen,) = struct.unpack("<I", f.read(4))
            header = json.loads(f.read(hlen))
            self.n = int(header["n"])
            self.meta = header.get("meta", {})
            self._species_off = 12 + hlen
            self._data_off = self._species_off + 4 * self.n
        frame_bytes = 12 * self.n
        payload = os.path.getsize(path) - self._data_off
        self.frames = payload // frame_bytes
        self.species = np.memmap(path, np.int32, "r", self._species_off,
                                 (self.n,))
        self._pos = np.memmap(path, np.float32, "r", self._data_off,
                              (self.frames, self.n, 3))

    def __len__(self) -> int:
        return self.frames

    def __getitem__(self, i):
        return self._pos[i]

    def positions(self):
        """All frames as one memmapped array f32[frames, N, 3]."""
        return self._pos
