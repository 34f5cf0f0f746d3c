"""One-pass randomized SVD via two-sided sketching.

PyTorch counterpart of ``dmd_era5_tpu/ops/onepass.py``: X is factored
from a single read, so an out-of-core artifact is streamed once
(``pipeline/streamed_fit.py::streamed_onepass_svd``).

Math (Tropp-Yurtsever-Udell-Cevher, "Practical sketching algorithms for
low-rank matrix approximation"):

    Y = Xc Omega        (S, r)   range sketch
    W = Psi Xc          (l, T)   co-range sketch, l >= r (default 2r)
    Q = orth(Y)                  (Cholesky of the Gram matrix G = Y^T Y)
    B = (Psi Q)^+ W     (r, T)   solve, no second pass over X
    Xc ~= Q B,  svd(B) -> truncated triplets,

with ``Psi Y = W Omega``, so Psi is applied once, and G summed per row
block beside the sketches.  The one-pass estimate trades a constant
factor on the residual tail for the saved pass.

Each row block's three products run on the port's kernels (the plain
PyTorch versions on a CPU tensor): Y_blk = X_blk Omega on the tiled
matmul K6, Psi_blk X_blk on the projection K3 (the panel in its
(rows, l) layout), Y_blk^T Y_blk on the Gram kernel K4.  W and G are
summed over blocks in float64 on the device, and the small core solve
runs in float64 there; the JAX package sums and solves in f32.  Row
blocks may come in any order: the left sketch panel of a block is
regenerated from (seed, row offset).
"""

from __future__ import annotations

import numpy as np
import torch

from dmd_era5_tpu_torch.ops.matmul import matmul, project
from dmd_era5_tpu_torch.ops.qr_panel import gram
from dmd_era5_tpu_torch.ops.svd import SVDResult
from dmd_era5_tpu_torch.ops.tsqr import qr_positive
from dmd_era5_tpu_torch.utils.linalg import safe_cholesky
from dmd_era5_tpu_torch.utils.tensors import home_device

__all__ = [
    "OnePassSketch",
    "onepass_svd",
    "onepass_core",
    "onepass_finalize",
    "psi_panel",
    "default_sketch_width",
    "draw_omega",
]

_MASK = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), by 16-bit halves of c
    so that no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def psi_panel(seed: int, row_offset: int, n_rows: int, l_sketch: int,
              device=None) -> torch.Tensor:
    """Deterministic (n_rows, l) Rademacher panel of the left sketch, on
    ``device`` (default: the CPU).

    The transpose of ``dmd_era5_tpu/ops/onepass.py:65``'s (l, n_rows)
    panel, bit for bit: each entry is the murmur3-style mix of (seed,
    global row index, sketch row) in uint32 wraparound arithmetic,
    computed in int64 and masked to 32 bits after every multiply and
    add, so the global Psi is the same under any row blocking.
    """
    i = (torch.arange(n_rows, dtype=torch.int64, device=device) + row_offset) & _MASK
    j = torch.arange(l_sketch, dtype=torch.int64, device=device)
    seed_term = ((seed & _MASK) * 0xC2B2AE35) & _MASK
    x = _mul32(i, 0x9E3779B9)[:, None] ^ _mul32(j, 0x85EBCA6B)[None, :] ^ seed_term
    # murmur3 fmix32 finalizer
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return ((x & 1) * 2 - 1).to(torch.float32)


def _block_update(w: torch.Tensor, g: torch.Tensor, x_blk: torch.Tensor, omega: torch.Tensor,
                  psi_blk: torch.Tensor, *, center: bool) -> torch.Tensor:
    """Fold one f32 row block into the f64 sums W (l, T) and G (r, r) in
    place and return its Y rows (``dmd_era5_tpu/ops/onepass.py:97``):

        Y_blk = Xc_blk Omega     (K6)
        W    += Psi_blk Xc_blk   (K3)
        G    += Y_blk^T Y_blk    (K4)

    Centring subtracts the rank-1 corrections mu colsum(Omega) and
    Psi_blk mu, mu the block rows' means over the full T.
    """
    y_blk = matmul(x_blk, omega)
    w_blk = project(x_blk, psi_blk)
    if center:
        mu = x_blk.mean(dim=1, keepdim=True)  # (bm, 1)
        y_blk -= mu * omega.sum(dim=0, keepdim=True)
        w_blk -= psi_blk.T @ mu
    w += w_blk
    g += gram(y_blk, "highest")
    return y_blk


def default_sketch_width(n_components: int, n_oversamples: int | None) -> int:
    """The JAX package's range sketch width: k + 10, rounded up to a
    multiple of 128 past 32 unless the oversampling is given."""
    r = n_components + (n_oversamples if n_oversamples is not None else 10)
    if n_oversamples is None and r > 32:
        r = -(-r // 128) * 128
    return r


def draw_omega(t_cols: int, r: int, seed: int, device) -> torch.Tensor:
    """The (T, r) Gaussian range sketch, from a ``torch.Generator`` on
    ``device`` seeded with ``seed`` (torch's numbers, not JAX's)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((t_cols, r), generator=gen, dtype=torch.float32, device=device)


class OnePassSketch:
    """Accumulate the two-sided sketch from streamed row blocks.

    Usage::

        sk = OnePassSketch(t_cols, n_components=10)
        for r0, blk in row_blocks:          # each blk: (bm, T)
            sk.update(r0, blk)
        result = sk.finalize()              # SVDResult, X never re-read

    ``device``: the card unless given.  ``omega``: the (T, r) range
    sketch; by default drawn from a ``torch.Generator`` on the device
    seeded with ``seed`` (torch's numbers are not JAX's, so a caller that
    wants the JAX package's sketch passes it here).  ``y_store``:
    ``"device"`` keeps the (S, r) Y rows on the device; ``"host"`` copies
    each block's rows to host memory at once and lifts U block by block
    on the device at :meth:`finalize` (each Y block copied up, lifted by
    K6, copied back into a preallocated host U), so device residency
    stays O(one block).  Returns U on ``y_store``'s side, s and V on the
    device.
    """

    def __init__(
        self,
        t_cols: int,
        n_components: int,
        n_oversamples: int | None = None,
        l_sketch: int | None = None,
        seed: int = 0,
        center: bool = False,
        device=None,
        y_store: str = "device",
        omega: torch.Tensor | None = None,
    ):
        if y_store not in ("device", "host"):
            raise ValueError(f"y_store must be device|host: {y_store}")
        self.device = home_device(None, device)
        if omega is None:
            omega = draw_omega(t_cols, default_sketch_width(n_components, n_oversamples), seed,
                               self.device)
        r = omega.shape[1]
        if tuple(omega.shape) != (t_cols, r) or r < n_components:
            raise ValueError(f"omega must be ({t_cols}, r >= {n_components}); "
                             f"got {tuple(omega.shape)}")
        self.n_components = n_components
        self.r = r
        self.l_sketch = l_sketch or 2 * r
        self.seed = seed
        self.center = center
        self.omega = omega.to(device=self.device, dtype=torch.float32).contiguous()
        self.w = torch.zeros((self.l_sketch, t_cols), dtype=torch.float64, device=self.device)
        self.g = torch.zeros((r, r), dtype=torch.float64, device=self.device)
        self.y_store = y_store
        self._y_parts: list[tuple[int, torch.Tensor]] = []
        self.rows_seen = 0

    def update(self, row_offset: int, x_block) -> None:
        """Fold in the rows ``[row_offset, row_offset + len(x_block))``
        (a host array or a tensor; taken as f32 on the device)."""
        blk = torch.as_tensor(x_block).to(device=self.device, dtype=torch.float32).contiguous()
        psi_blk = psi_panel(self.seed, row_offset, blk.shape[0], self.l_sketch, self.device)
        y_blk = _block_update(self.w, self.g, blk, self.omega, psi_blk, center=self.center)
        if self.y_store == "host":
            y_blk = y_blk.cpu()
        self._y_parts.append((row_offset, y_blk))
        self.rows_seen += blk.shape[0]

    def finalize(self) -> SVDResult:
        if not self._y_parts:
            raise ValueError("No blocks streamed")
        lift, s, vt, err_est = onepass_core(self.w, self.g, self.omega, self.n_components)
        # the posterior rank-k error estimate, stamped into the artifact's
        # attrs by the pipeline so the one-pass trade is never silent
        self.tail_rel_err_est = float(err_est)
        parts = [p for _, p in sorted(self._y_parts, key=lambda t: t[0])]
        if self.y_store == "device":
            return SVDResult(matmul(torch.cat(parts), lift), s, vt)
        u = np.empty((self.rows_seen, self.n_components), np.float32)
        r0 = 0
        for part in parts:
            u[r0:r0 + part.shape[0]] = matmul(part.to(self.device), lift).cpu().numpy()
            r0 += part.shape[0]
        return SVDResult(u, s, vt)


def onepass_core(w: torch.Tensor, g: torch.Tensor, omega: torch.Tensor, n_components: int):
    """Small core solve without the Y lift
    (``dmd_era5_tpu/ops/onepass.py:251``): returns (lift (r, k) f32, s
    (k,) f32, vt (k, T) f32, tail_rel_err_est) with U = Y lift, in
    float64 on W's device.

    ``tail_rel_err_est`` estimates ||Xc - U diag(s) V||_F / ||Xc||_F
    from the sketches alone: for a Rademacher Psi, E||Psi M||_F^2 =
    l ||M||_F^2, so the sketch-solve residual over sqrt(l) estimates
    ||Xc - Q B||_F and ||W||_F / sqrt(l) estimates ||Xc||_F; the
    truncation adds the discarded tail of B's singular values, in
    quadrature.
    """
    w, g = w.double(), g.double()
    # upper R with G = R^T R, ridged as the JAX package ridges it (1e-7 of
    # G's mean diagonal): where Y's least eigenvalues sit far below that,
    # U = Y R^-1 u_b is orthonormal only as far as the ridge allows
    r_fac = safe_cholesky(g).T
    eye = torch.eye(r_fac.shape[0], dtype=r_fac.dtype, device=r_fac.device)
    r_inv = torch.linalg.solve_triangular(r_fac, eye, upper=True)
    psi_q = (w @ omega.double()) @ r_inv  # Psi Y R^-1 = Psi Q, (l, r)
    q_pq, r_pq = qr_positive(psi_q)
    b = torch.linalg.solve_triangular(r_pq, q_pq.T @ w, upper=True)  # (r, T)
    u_b, s, vt = torch.linalg.svd(b, full_matrices=False)
    l_rows = w.shape[0]
    w_norm_sq = (w * w).sum()
    resid = w - psi_q @ b
    resid_sq = (resid * resid).sum()  # ~ l ||Xc - Q B||_F^2
    tail_sq = (s[n_components:] ** 2).sum()  # ||B - B_k||_F^2
    tail_rel_err_est = torch.sqrt(
        (resid_sq / l_rows + tail_sq) / torch.clamp(w_norm_sq / l_rows, min=1e-30)
    )
    s, vt_k = s[:n_components], vt[:n_components]
    # deterministic signs from V alone (sklearn's svd_flip), folded into the lift
    max_idx = torch.argmax(vt_k.abs(), dim=1)
    signs = torch.sign(vt_k[torch.arange(n_components, device=vt_k.device), max_idx])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    vt_k = vt_k * signs[:, None]
    lift = r_inv @ (u_b[:, :n_components] * signs[None, :])
    return lift.float(), s.float(), vt_k.float(), tail_rel_err_est


def onepass_finalize(y: torch.Tensor, w: torch.Tensor, g: torch.Tensor, omega: torch.Tensor,
                     n_components: int) -> SVDResult:
    """Solve the small core problem and lift (no X access): y (S, r) f32
    range sketch, w (l, T) co-range sketch, g = y^T y, omega (T, r)."""
    lift, s, vt, _ = onepass_core(w, g, omega, n_components)
    return SVDResult(matmul(y, lift), s, vt)


def onepass_svd(
    x,
    n_components: int,
    n_oversamples: int | None = None,
    l_sketch: int | None = None,
    seed: int = 0,
    center: bool = False,
    block_rows: int | None = None,
    device=None,
    omega: torch.Tensor | None = None,
) -> SVDResult:
    """One-pass randomized SVD of an in-memory matrix, one device
    (``dmd_era5_tpu/ops/onepass.py:332``).  ``device``: x's, if x is a
    tensor, else the card unless given."""
    device = home_device(x, device)
    s_rows = x.shape[0]
    sk = OnePassSketch(x.shape[1], n_components, n_oversamples=n_oversamples,
                       l_sketch=l_sketch, seed=seed, center=center, device=device, omega=omega)
    block_rows = block_rows or s_rows
    for r0 in range(0, s_rows, block_rows):
        sk.update(r0, x[r0:min(r0 + block_rows, s_rows)])
    return sk.finalize()
