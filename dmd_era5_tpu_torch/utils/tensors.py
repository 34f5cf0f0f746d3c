"""Inputs as tensors: the models take tensors or host arrays alike, and
host blocks a reader fills reach a card through a ring of pinned buffers."""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["as_tensor", "home_device", "CopyRing"]


def as_tensor(a, dtype: torch.dtype, device: torch.device | str | None = None) -> torch.Tensor:
    """``a`` (a tensor or an array) as a ``dtype`` tensor on ``device``:
    by default where a tensor lies, else on the host.  A tensor already
    there in ``dtype`` is returned as it is; a writable host array is
    wrapped, not copied, before the move (a read-only one is copied,
    since torch wraps only writable arrays)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device or a.device, dtype=dtype)
    arr = np.asarray(a)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy()).to(device, dtype)


def home_device(a, device: torch.device | str | None = None) -> torch.device:
    """Where a computation on ``a`` runs: ``device`` when given, else
    where the tensor ``a`` lies, else (a host array) the card, which
    must then be present."""
    if device is not None:
        return torch.device(device)
    if isinstance(a, torch.Tensor):
        return a.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "this runs on a CUDA card and none is available; pass device='cpu' "
            "(or CPU tensors) to run it on the host"
        )
    return torch.device("cuda")


class CopyRing:
    """Host blocks to one CUDA device through ``slots`` pinned buffers and
    a copy stream of their own.

    A reader fills the next buffer in place (:meth:`host_buffer`, from its
    own thread); :meth:`to_device` then queues that buffer's copy to the
    device on the copy stream and makes the caller's current stream wait
    for that copy alone, so the copy of block i + 1 runs while the card
    still works on block i (a copy from pageable memory on the caller's
    stream waits for that work and holds the host until it is done).
    Buffers are sent in the order they were filled.  A buffer is handed
    out again only once the copy that last read it has finished, and only
    once that copy was queued: a reader that holds up to ``lead`` filled
    blocks the caller has not yet taken needs ``slots >= lead + 2`` (one
    more in the reader's hands, one in the caller's between taking a
    block and sending it), and a reader that laps the ring raises rather
    than overwrite a block not yet sent.  The device tensor is allocated
    on the copy stream and recorded on the caller's, so its memory is
    reused only after the caller's work on it.
    """

    def __init__(self, device, slots: int = 4):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self._buffers: list[torch.Tensor | None] = [None] * slots
        self._copied: list[torch.cuda.Event | None] = [None] * slots
        # filled and not yet sent, per slot (written by the reader on
        # filling, by the caller on sending)
        self._unsent = [False] * slots
        self._fill = self._send = 0

    def host_buffer(self, shape: tuple[int, ...], dtype) -> np.ndarray:
        """The next buffer as a numpy array of ``shape`` and ``dtype``, once
        the copy that last read it is done."""
        slot = self._fill
        if self._unsent[slot]:
            raise RuntimeError(f"the reader lapped the copy ring: {len(self._buffers)} slots "
                               "need at least the reader's lead + 2")
        self._fill = (slot + 1) % len(self._buffers)
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()
        dtype = np.dtype(dtype)
        nbytes = math.prod(shape) * dtype.itemsize
        buf = self._buffers[slot]
        if buf is None or buf.numel() < nbytes:
            buf = self._buffers[slot] = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        self._unsent[slot] = True
        return buf.numpy()[:nbytes].view(dtype).reshape(shape)

    def to_device(self, host: torch.Tensor) -> torch.Tensor:
        """The next filled buffer (``host``, a view of it) on the device."""
        slot = self._send
        buf = self._buffers[slot]
        if not self._unsent[slot] or host.data_ptr() != buf.data_ptr():
            raise ValueError("to_device takes the ring's next filled buffer")
        self._send = (slot + 1) % len(self._buffers)
        consumer = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            out = torch.empty(host.shape, dtype=host.dtype, device=self.device)
            out.copy_(host, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self.stream)
        self._copied[slot] = copied
        self._unsent[slot] = False
        consumer.wait_event(copied)
        out.record_stream(consumer)
        return out
