"""Out-of-core decomposition: stream a packed snapshot artifact through
the SVD without ever holding X in device memory.

PyTorch counterpart of ``dmd_era5_tpu/pipeline/streamed_fit.py``:
:func:`prefetched_row_blocks` (:51), :func:`streamed_randomized_svd`
(:84), :func:`streamed_exact_gram_svd` (:347) and
:func:`streamed_onepass_svd` (:485).  Row blocks of the artifact
(``snapmat/loader.py``) are read on a prefetch thread while the card
works on the current block.

Randomized route, n_iter + 2 passes over the file:

  passes 1..n_iter:  Z <- X^T (X Z), both products from one block visit
                     (Z_0 = Omega; Z re-orthonormalized between passes by
                     the Householder leaf, kernel K7 on the card);
  pass n_iter + 1:   Gy += y^T y, P += y^T X per block (y = X_blk Z); the
                     range basis Q = Y W^T stays implicit through the r x r
                     whitener W = gram_whiten(Gy), so B = Q^T X = W P;
  pass n_iter + 2:   U_blk = X_blk (Z W^T U_b), copied back to the host.

Every y = X_blk Z is the tiled matmul kernel K6 on the card, the ragged
last block included.  The other products are ``torch.matmul`` in full
f32 (TF32 off on the card), as the JAX package leaves them to XLA, with
its f32 accumulation across blocks.  Device residency is one block plus
r x T factors.

One-pass route (``ops/onepass.py``): one pass of Y = X_blk Omega (K6),
W += Psi_blk X_blk (K3) and G += Y^T Y (K4), the Y rows copied to the
host, then the U lift from host memory block by block (K6).

On a card the prefetch thread reads each block straight into a pinned
host buffer of a small ring (``utils.tensors.CopyRing``), whose copy
stream takes it to the card: the copy of block i + 1 can run while the
card works on block i, no fresh host array is allocated and faulted in
a block, and a buffer is refilled only once its last copy is done.
That bounds the work in flight, as the JAX package's ``_throttle``
bounded its asynchronous dispatch queue.
"""

from __future__ import annotations

import functools
import logging
import queue
import threading
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from dmd_era5_tpu_torch.core.logging import log_and_print, setup_logger
from dmd_era5_tpu_torch.ops.matmul import matmul
from dmd_era5_tpu_torch.ops.onepass import OnePassSketch, default_sketch_width, draw_omega
from dmd_era5_tpu_torch.ops.svd import SVDResult, sklearn_n_iter
from dmd_era5_tpu_torch.ops.tsqr import _local_factor
from dmd_era5_tpu_torch.snapmat.loader import packed_info, read_packed_rows
from dmd_era5_tpu_torch.utils.linalg import gram_whiten
from dmd_era5_tpu_torch.utils.tensors import CopyRing

logger = logging.getLogger(__name__)

__all__ = [
    "prefetched_row_blocks",
    "streamed_randomized_svd",
    "streamed_randomized_svd_core",
    "streamed_exact_gram_svd",
    "streamed_onepass_svd",
    "streamed_onepass_svd_core",
]


@functools.cache
def _stage_logger():
    """The one-pass route's log (its warning is printed as well)."""
    return setup_logger("StreamedFit-torch", "streamed_fit_torch.log")

Source = str | Path | np.ndarray


def prefetched_row_blocks(
    path: Source,
    n_rows: int,
    block_rows: int,
    depth: int = 2,
    *,
    _into=None,
) -> Iterator[tuple[int, np.ndarray]]:
    """Yield (row_start, block) with a background prefetch thread.

    The reader thread stays ``depth`` blocks ahead of the consumer, so
    disk reads overlap the copy to the card and the card's work.  A read
    that fails raises in the consumer (a pass never ends short), and a
    consumer that stops early stops the reader before returning.
    ``_into``: the destination allocator handed to ``read_packed_rows``
    (a :class:`CopyRing`'s ``host_buffer``: blocks are read straight into
    its pinned buffers).
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    abandoned = threading.Event()

    def reader():
        try:
            for r0 in range(0, n_rows, block_rows):
                if abandoned.is_set():
                    return
                r1 = min(r0 + block_rows, n_rows)
                blk = (read_packed_rows(path, r0, r1) if _into is None
                       else read_packed_rows(path, r0, r1, into=_into))
                q.put((r0, blk))
            q.put(done)
        except Exception as exc:  # the thread's boundary: the consumer re-raises it
            q.put(exc)

    thread = threading.Thread(target=reader, daemon=True)
    thread.start()
    try:
        while (item := q.get()) is not done:
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        abandoned.set()
        while thread.is_alive():  # free the slot a blocked put waits for
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass
        thread.join()


def _device(device) -> torch.device:
    """``None`` means the card; there is no CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the streamed SVD runs on a CUDA card and none is available; "
                "pass device='cpu' to run it on the host"
            )
        return torch.device("cuda")
    return torch.device(device)


def _columns(path: Source, col_limit: int | None) -> tuple[int, int, bool]:
    """(rows, columns decomposed, bf16 storage) of the artifact."""
    (n_rows, t_cols), _, bf16 = packed_info(path)
    if col_limit is not None:
        if not 0 < col_limit <= t_cols:
            raise ValueError(f"col_limit must be in (0, {t_cols}]; got {col_limit}")
        t_cols = col_limit
    return n_rows, t_cols, bf16


def _u_wire(u_dtype: str | None, bf16: bool) -> torch.dtype:
    """Dtype of U on its way back to the host: bf16 under ``"auto"`` when
    the artifact itself is bf16."""
    if u_dtype == "auto":
        return torch.bfloat16 if bf16 else torch.float32
    if u_dtype in (None, "float32"):
        return torch.float32
    if u_dtype in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"u_dtype must be auto/float32/bfloat16, got {u_dtype!r}")


def _to_device(blk: np.ndarray, t_cols: int, device, dtype=None,
               ring: CopyRing | None = None) -> torch.Tensor:
    """A host block as a contiguous tensor on ``device``: uint16 storage
    is bf16, trailing columns past ``t_cols`` are sliced off.  With
    ``ring`` the block (read into the ring's next pinned buffer) is
    copied on its copy stream and sliced on the device;
    without, it is sliced on the host and copied from pageable memory on
    the current stream, which waits for the card's work queued before it."""
    if ring is None and blk.shape[1] > t_cols:
        blk = np.ascontiguousarray(blk[:, :t_cols])
    if blk.dtype == np.uint16:
        arr = torch.from_numpy(blk.view(np.int16)).view(torch.bfloat16)
    else:
        arr = torch.from_numpy(blk)
    if ring is None:
        arr = arr.to(device)
    else:
        arr = ring.to_device(arr)
        if arr.shape[1] > t_cols:
            arr = arr[:, :t_cols].contiguous()
    return arr if dtype is None else arr.to(dtype)


def _device_blocks(path, n_rows: int, t_cols: int, block_rows: int, device, dtype=None,
                   depth: int = 2):
    """One pass over the artifact: (row_start, block on ``device``), the
    reader ``depth`` blocks ahead.  On a card the reader fills the pinned
    buffers of a :class:`CopyRing` of the pass's own, ``depth + 2`` of
    them (what a reader that far ahead needs), whose copy stream takes
    each block to the card."""
    device = torch.device(device)
    if device.type != "cuda":
        for r0, blk in prefetched_row_blocks(path, n_rows, block_rows, depth):
            yield r0, _to_device(blk, t_cols, device, dtype)
        return
    ring = CopyRing(device, slots=depth + 2)
    for r0, blk in prefetched_row_blocks(path, n_rows, block_rows, depth,
                                         _into=ring.host_buffer):
        yield r0, _to_device(blk, t_cols, device, dtype, ring)


def _stream_lift(path, n_rows, t_cols, block_rows, m_lift, u_wire, u_out, device,
                 block_dtype=None):
    """One pass: U = X m_lift, block by block into ``u_out`` (a numpy
    array, memmap or ``utils.hdf5`` dataset) or a fresh f32 host array; no (S, k)
    array on the card."""
    dest = u_out if u_out is not None else np.empty((n_rows, m_lift.shape[1]), np.float32)
    for r0, blk in _device_blocks(path, n_rows, t_cols, block_rows, device, block_dtype):
        u_blk = (blk.float() @ m_lift).to(u_wire)
        dest[r0 : r0 + u_blk.shape[0]] = u_blk.cpu().float().numpy()
    return dest


def streamed_randomized_svd(
    path: Source,
    n_components: int,
    block_rows: int = 1 << 16,
    n_oversamples: int = 10,
    n_iter: int | str = "auto",
    seed: int = 0,
    device=None,
    qr_method: str | None = None,
    block_dtype: torch.dtype | None = None,
    u_dtype: str | None = "auto",
    u_out=None,
    col_limit: int | None = None,
) -> SVDResult:
    """Randomized truncated SVD of a packed snapshot artifact, streamed.

    Counterpart of ``dmd_era5_tpu/pipeline/streamed_fit.py:84``; the
    (T, k + n_oversamples) Gaussian sketch is drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed`` (torch's
    numbers are not JAX's), then :func:`streamed_randomized_svd_core`
    runs the passes.  ``device=None`` is the card.  ``qr_method`` is
    accepted and ignored, as in the JAX package.  Returns U on the host
    (a float32 numpy array, or ``u_out``), s and V on ``device``.
    """
    del qr_method
    device = _device(device)
    _, t_cols, _ = _columns(path, col_limit)
    gen = torch.Generator(device=device).manual_seed(seed)
    omega = torch.randn(
        (t_cols, n_components + n_oversamples), generator=gen,
        dtype=torch.float32, device=device,
    )
    return streamed_randomized_svd_core(
        path, omega, n_components, block_rows=block_rows, n_iter=n_iter,
        device=device, block_dtype=block_dtype, u_dtype=u_dtype, u_out=u_out,
        col_limit=col_limit,
    )


def streamed_randomized_svd_core(
    path: Source,
    omega: torch.Tensor,
    n_components: int,
    block_rows: int = 1 << 16,
    n_iter: int | str = "auto",
    device=None,
    block_dtype: torch.dtype | None = None,
    u_dtype: str | None = "auto",
    u_out=None,
    col_limit: int | None = None,
) -> SVDResult:
    """The passes of :func:`streamed_randomized_svd`, given its sketch
    omega (T, r), r = k + n_oversamples.

    ``block_dtype``: dtype of the blocks on the card (default: the
    file's, so a bf16 artifact streams bf16); the iterate is cast to the
    block's dtype before each sketch, as the JAX package casts it, so on
    bf16 blocks Z is rounded to bf16 there.  ``u_dtype``: dtype of U on
    its way back (``"auto"``: bf16 for a bf16 artifact, else f32;
    ``"float32"``; ``"bfloat16"``); the host U is float32 either way.
    ``u_out``: a preallocated (rows, k) array-like that receives U
    block by block, returned as U.  ``col_limit``: decompose only the
    leading columns.
    """
    device = _device(device)
    n_rows, t_cols, bf16 = _columns(path, col_limit)
    u_wire = _u_wire(u_dtype, bf16)
    if omega.ndim != 2 or omega.shape[0] != t_cols or omega.shape[1] < n_components:
        raise ValueError(
            f"omega must be ({t_cols}, r) with r >= {n_components}; got {tuple(omega.shape)}"
        )
    if isinstance(n_iter, str):
        n_iter = sklearn_n_iter(n_components, (n_rows, t_cols))
    omega = omega.to(device=device, dtype=torch.float32)
    r = omega.shape[1]

    def blocks():
        for _, blk in _device_blocks(path, n_rows, t_cols, block_rows, device, block_dtype):
            yield blk

    def sketch(blk, z):
        return matmul(blk, z.to(blk.dtype))  # K6 on the card

    def gram_apply(z):
        """One pass: X^T (X z), both products from each block visit."""
        acc = torch.zeros((t_cols, r), dtype=torch.float32, device=device)
        for blk in blocks():
            acc += blk.T.float() @ sketch(blk, z)
        return acc

    logger.info(
        "Streaming SVD: %d x %d in %d-row blocks (%d blocks/pass, %d passes)",
        n_rows, t_cols, block_rows, -(-n_rows // block_rows), n_iter + 2,
    )
    z = omega
    if n_iter > 0:
        z = gram_apply(omega)  # pass 1
        for _ in range(n_iter - 1):  # passes 2..n_iter
            z, _ = _local_factor(z, "householder")
            z = gram_apply(z)
        z, _ = _local_factor(z, "householder")

    # pass n_iter + 1: the small range factors
    gy = torch.zeros((r, r), dtype=torch.float32, device=device)
    p = torch.zeros((r, t_cols), dtype=torch.float32, device=device)
    for blk in blocks():
        y = sketch(blk, z)
        gy += y.T @ y
        p += y.T @ blk.float()
    w_whiten = gram_whiten(gy)
    u_b, s, vt = torch.linalg.svd(w_whiten @ p, full_matrices=False)
    s, vt_k = s[:n_components], vt[:n_components]
    # deterministic signs from V alone (sklearn's v-based flip), applied
    # to the lift matrix before the U pass
    max_idx = torch.argmax(vt_k.abs(), dim=1)
    signs = torch.sign(vt_k[torch.arange(n_components, device=device), max_idx])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    vt_k = vt_k * signs[:, None]
    m_lift = z @ (w_whiten.T @ (u_b[:, :n_components] * signs[None, :]))  # (T, k)
    # pass n_iter + 2: U to the host
    u_host = _stream_lift(
        path, n_rows, t_cols, block_rows, m_lift, u_wire, u_out, device, block_dtype
    )
    return SVDResult(u_host, s, vt_k)


def streamed_exact_gram_svd(
    path: Source,
    n_components: int,
    block_rows: int = 1 << 18,
    device=None,
    u_dtype: str | None = "auto",
    u_out=None,
    col_limit: int | None = None,
) -> SVDResult:
    """Exact truncated SVD of a packed artifact in two passes.

    Counterpart of ``dmd_era5_tpu/pipeline/streamed_fit.py:347``:

      pass 1: G += X_blk^T X_blk, each block's product in full f32 on the
              card and summed on the host in float64 -- or, past
              T^2 * 4 bytes = 8 MB, summed on the card in float32 and
              fetched once, as the JAX package does;
      host:   eigh(G) in float64 -> s = sqrt(eigenvalues), V with
              sklearn's v-based signs;
      pass 2: U = X (V_k S^-1), block by block to the host (``u_dtype``,
              ``u_out`` as in :func:`streamed_randomized_svd`).

    No kernel of the port runs here.  ``device=None`` is the card.
    Returns U on the host, s (k,) and V (k, T) as float32 numpy arrays.
    """
    device = _device(device)
    n_rows, t_cols, bf16 = _columns(path, col_limit)
    u_wire = _u_wire(u_dtype, bf16)

    def block_grams():
        for _, blk in _device_blocks(path, n_rows, t_cols, block_rows, device):
            bf = blk.float()
            yield bf.T @ bf

    logger.info(
        "Streamed exact Gram SVD: %d x %d in %d-row blocks (2 passes)",
        n_rows, t_cols, block_rows,
    )
    if t_cols * t_cols * 4 <= (8 << 20):
        gram = np.zeros((t_cols, t_cols), np.float64)
        for g in block_grams():
            gram += g.cpu().numpy().astype(np.float64)
    else:
        acc = torch.zeros((t_cols, t_cols), dtype=torch.float32, device=device)
        for g in block_grams():
            acc += g
        gram = acc.cpu().numpy().astype(np.float64)

    evals, vecs = np.linalg.eigh(gram)  # ascending, f64
    idx = np.argsort(evals)[::-1][:n_components]
    s = np.sqrt(np.maximum(evals[idx], 0.0))
    v_cols = vecs[:, idx]  # (T, k)
    max_idx = np.argmax(np.abs(v_cols), axis=0)
    signs = np.sign(v_cols[max_idx, np.arange(len(idx))])
    signs = np.where(signs == 0, 1.0, signs)
    v_cols = v_cols * signs[None, :]
    m_lift = torch.from_numpy(
        (v_cols / np.maximum(s, 1e-300)[None, :]).astype(np.float32)
    ).to(device)
    u_host = _stream_lift(path, n_rows, t_cols, block_rows, m_lift, u_wire, u_out, device)
    return SVDResult(u_host, s.astype(np.float32), v_cols.T.astype(np.float32))


def streamed_onepass_svd(
    path: Source,
    n_components: int,
    block_rows: int = 1 << 16,
    n_oversamples: int | None = None,
    l_sketch: int | None = None,
    seed: int = 0,
    center: bool = False,
    device=None,
    info: dict | None = None,
    warn_tail_rel_err: float = 0.1,
) -> SVDResult:
    """Randomized truncated SVD of a packed artifact in ONE disk pass.

    Counterpart of ``dmd_era5_tpu/pipeline/streamed_fit.py:485``, the
    two-sided sketch of ``ops/onepass.py``: the co-range sketch W = Psi X
    sums beside the range sketch per row block, so the file is never read
    again.  The (T, r) sketch Omega is drawn from a ``torch.Generator``
    on ``device`` seeded with ``seed`` (torch's numbers are not JAX's);
    :func:`streamed_onepass_svd_core` runs the pass.  ``device=None`` is
    the card.
    """
    device = _device(device)
    (_, t_cols), _, _ = packed_info(path)
    omega = draw_omega(t_cols, default_sketch_width(n_components, n_oversamples), seed, device)
    return streamed_onepass_svd_core(
        path, omega, n_components, block_rows=block_rows, l_sketch=l_sketch, seed=seed,
        center=center, device=device, info=info, warn_tail_rel_err=warn_tail_rel_err,
    )


def streamed_onepass_svd_core(
    path: Source,
    omega: torch.Tensor,
    n_components: int,
    block_rows: int = 1 << 16,
    l_sketch: int | None = None,
    seed: int = 0,
    center: bool = False,
    device=None,
    info: dict | None = None,
    warn_tail_rel_err: float = 0.1,
) -> SVDResult:
    """The pass of :func:`streamed_onepass_svd`, given its sketch omega
    (T, r).  Blocks are taken as f32 on the card (a bf16 artifact is
    decoded there); Psi's panel of a block is keyed by ``seed`` and the
    block's first row.  The out-of-core contract: device residency stays
    O(one block), the range sketch's rows are kept in host memory and U
    is lifted from them block by block (``y_store="host"``).

    ``info``: an optional dict that receives ``onepass_tail_rel_err_est``,
    the sketches' estimate of the rank-k relative Frobenius error
    (``ops.onepass.onepass_core``); a warning is logged and printed when
    it exceeds ``warn_tail_rel_err``, so the one-pass trade is never
    silent.  Returns U on the host (a float32 numpy array), s and V on
    ``device``.
    """
    device = _device(device)
    (n_rows, t_cols), _, _ = packed_info(path)
    sk = OnePassSketch(t_cols, n_components, l_sketch=l_sketch, seed=seed, center=center,
                       device=device, y_store="host", omega=omega)
    log_and_print(
        _stage_logger(),
        f"One-pass streaming SVD: {n_rows} x {t_cols} in {block_rows}-row blocks "
        "(single disk pass)",
    )
    for r0, blk in _device_blocks(path, n_rows, t_cols, block_rows, device, torch.float32):
        sk.update(r0, blk)
    res = sk.finalize()
    err_est = sk.tail_rel_err_est
    if info is not None:
        info["onepass_tail_rel_err_est"] = round(err_est, 6)
    if err_est > warn_tail_rel_err:
        log_and_print(
            _stage_logger(),
            f"One-pass SVD posterior error estimate {err_est:.3f} exceeds "
            f"{warn_tail_rel_err:.2f}: the trailing components of this "
            "decomposition are sketch-noise-dominated (the one-pass "
            "accuracy trade).  Reduce n_components, raise l_sketch, or "
            "use svd_backend='streamed' for a high-accuracy fit.",
            "warning",
        )
    return res
