"""Streaming sketch and incremental SVD over snapshot column blocks.

PyTorch counterpart of ``dmd_era5_tpu/ops/streaming.py`` (north-star
config 5 of ``BASELINE.json``: a streaming/updating rank-k SVD):

- :class:`StreamingSketch`: Y += X_blk Omega_blk as column blocks of the
  snapshot matrix stream to the device.  On a card each host block is
  copied into pinned memory and from there with ``non_blocking=True`` on
  a copy stream, so the copy of block i + 1 overlaps the product of
  block i, the overlap the JAX package took from its asynchronous
  dispatch.
- :func:`svd_rank_update`: Brand's incremental SVD, which appends new
  columns to a truncated factorization without refactoring the history.
  Its S-sized products run on the port's kernels (the plain PyTorch
  versions on CPU tensors): L = U^T C on the projection K3, U L and the
  lift [U, J] U_m on the tiled matmul K6.  The residual's QR is the
  library's: an (S, c) panel at ERA5 size is far outside the Householder
  kernel's envelope.
"""

from __future__ import annotations

from typing import Iterable

import torch

from dmd_era5_tpu_torch.ops.matmul import matmul, project
from dmd_era5_tpu_torch.ops.svd import SVDResult
from dmd_era5_tpu_torch.ops.tsqr import qr_positive

__all__ = ["StreamingSketch", "svd_rank_update", "LIFT_ROWS"]

# rows of [U, J] a lift launch takes at once: each is a copy of that many
# rows of both, so the (S, k + c) concatenation never exists whole
LIFT_ROWS = 1 << 21


class StreamingSketch:
    """Accumulate Y = X @ Omega (f32) from streamed column blocks.

    Omega's rows are consumed in step with the streamed columns, so the
    time dimension never has to be resident: only the (S, r) accumulator
    and the blocks in flight live on the device (``device``: Omega's
    unless given).
    """

    def __init__(self, s_rows: int, omega, device=None):
        omega = torch.as_tensor(omega, dtype=torch.float32)
        self.device = torch.device(device) if device is not None else omega.device
        self.omega = omega.to(self.device)
        self._col = 0
        self._y = None
        self._s_rows = s_rows
        self._copies: torch.cuda.Stream | None = None

    @property
    def columns_seen(self) -> int:
        return self._col

    def _to_device(self, x_block) -> torch.Tensor:
        blk = torch.as_tensor(x_block, dtype=torch.float32)
        if self.device.type != "cuda" or blk.device.type != "cpu":
            return blk.to(self.device)
        if self._copies is None:
            self._copies = torch.cuda.Stream(self.device)
        consumer = torch.cuda.current_stream(self.device)
        # the pinned copy is kept by the host allocator until the copy ends
        pinned = blk.contiguous().pin_memory()
        with torch.cuda.stream(self._copies):
            out = pinned.to(self.device, non_blocking=True)
        consumer.wait_stream(self._copies)
        out.record_stream(consumer)
        return out

    def update(self, x_block) -> None:
        """Fold in the next (S, c) column block (host or device array)."""
        c = x_block.shape[1]
        blk = self._to_device(x_block)
        if self._y is None:
            self._y = torch.zeros((self._s_rows, self.omega.shape[1]), dtype=torch.float32,
                                  device=self.device)
        self._y += blk @ self.omega[self._col:self._col + c]
        self._col += c

    def result(self) -> torch.Tensor:
        if self._y is None:
            raise ValueError("No blocks streamed")
        return self._y

    def run(self, blocks: Iterable) -> torch.Tensor:
        for blk in blocks:
            self.update(blk)
        return self.result()


def svd_rank_update(
    svd: SVDResult,
    new_cols: torch.Tensor,
    n_components: int | None = None,
) -> SVDResult:
    """Append columns to a truncated SVD (incremental / updating SVD).

    Given X ~ U diag(s) V (tensors on one device, f32) and new snapshots
    C (S, c) there, factor [X, C] ~ U' diag(s') V' at the same (or the
    given) rank:

        L = U^T C                  (K3)
        J, K = qr(C - U L)         (U L on K6; the library QR)
        M = [[diag(s), L], [0, K]] ((k+c) x (k+c), torch.linalg.svd)
        U' = [U, J] U_m            (K6, LIFT_ROWS rows a launch)
        V' = V_m^T blockdiag(V, I)
    """
    u, s, v = svd.U, svd.s, svd.V
    k, c = s.shape[0], new_cols.shape[1]
    n_components = n_components or k
    new_cols = new_cols.to(device=u.device, dtype=torch.float32).contiguous()

    l_proj = project(new_cols, u)  # (k, c)
    resid = matmul(u, l_proj).neg_().add_(new_cols)  # C - U L in U L's storage
    j_dirs, k_tri = qr_positive(resid)  # (S, c), (c, c)
    del resid

    m = torch.zeros((k + c, k + c), dtype=torch.float32, device=u.device)
    m[:k, :k] = torch.diag(s.float())
    m[:k, k:] = l_proj
    m[k:, k:] = k_tri
    um, sm, vmt = torch.linalg.svd(m, full_matrices=False)
    um = um[:, :n_components].contiguous()
    sm, vmt = sm[:n_components], vmt[:n_components]

    u_new = torch.empty((u.shape[0], n_components), dtype=torch.float32, device=u.device)
    for r0 in range(0, u.shape[0], LIFT_ROWS):
        r1 = min(r0 + LIFT_ROWS, u.shape[0])
        u_new[r0:r1] = matmul(torch.cat([u[r0:r1], j_dirs[r0:r1]], dim=1), um)
    # V' = V_m^T [[V, 0], [0, I]]
    v_new = torch.cat([vmt[:, :k] @ v.to(vmt.dtype), vmt[:, k:]], dim=1)
    return SVDResult(u_new, sm, v_new)
