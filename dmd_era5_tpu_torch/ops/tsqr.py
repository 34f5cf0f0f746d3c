"""Tall-skinny QR, on one device and row-sharded over a mesh axis.

PyTorch counterpart of ``dmd_era5_tpu/ops/tsqr.py``: the
positive-diagonal QR, the local factorization leaves and their default,
and the tree combine of the leaves' R factors across the ranks of a
mesh axis.  Each rank factors its local row block (the leaf), and the
small R factors merge pairwise in a butterfly ladder (``ppermute`` with
partner ``idx XOR 2^level``): log2 P exchanges for a power-of-two P,
ceil(log2 P) + 1 otherwise (the highest ranks fold into low partners
first and get their result back in one packed exchange), never an
all-gather, each payload at most 2 T^2 elements.  Every member of a
merge group factors the same stack, the lower index on top, so R ends
identical on every rank with no broadcast.  Q is recovered rank-locally
as the leaf Q times a small chain product, ``torch.matmul`` in f32 (the
JAX package's ``jnp.matmul(..., precision=HIGHEST)``; no TF32).  The
``"xla"`` leaf existed only for a CPU mesh under a TPU default backend
and is gone.
"""

from __future__ import annotations

import torch

from dmd_era5_tpu_torch.ops.qr_panel import cholqr2, cholqr2_split, householder_panel
from dmd_era5_tpu_torch.parallel.collectives import ppermute
from dmd_era5_tpu_torch.parallel.mesh import AXIS_SPACE, Mesh

__all__ = ["qr_positive", "tsqr", "tsqr_orthonormalize", "default_qr_method", "QR_METHODS"]

QR_METHODS = ("householder", "cholqr2", "cholqr2_split")


def qr_positive(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Reduced QR with the diag(R) >= 0 sign convention
    (``dmd_era5_tpu/ops/tsqr.py:58``)."""
    q, r = torch.linalg.qr(x, mode="reduced")
    signs = torch.sign(torch.diagonal(r))
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return q * signs[None, :], r * signs[:, None]


def in_householder_kernel_envelope(m: int, n: int) -> bool:
    """Whether the JAX package would run its Pallas Householder panel
    kernel (K7) on an (m, n) panel: n <= 256 and the panel plus two
    scratch copies within 12 MiB (``dmd_era5_tpu/ops/tsqr.py:91-95``)."""
    return n <= 256 and 3 * m * n * 4 <= 12 * 1024 * 1024


def _local_factor(x: torch.Tensor, method: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Local tall-skinny factorization (``dmd_era5_tpu/ops/tsqr.py:66``).

    ``"cholqr2"`` and ``"cholqr2_split"`` run the CholeskyQR2 leaves of
    :mod:`ops.qr_panel` on the Gram kernel.  ``"householder"`` is the
    backward-stable leaf.  Off the CPU, inside the JAX package's envelope
    for its Householder panel kernel, it runs
    :func:`ops.qr_panel.householder_panel` (K7 on a CUDA tensor; any
    other device raises there); outside the envelope and on the CPU it
    takes the library QR, as the JAX package does.
    """
    if method == "cholqr2":
        return cholqr2(x)
    if method == "cholqr2_split":
        return cholqr2_split(x)
    if method != "householder":
        raise ValueError(f"qr method must be one of {QR_METHODS}, got {method!r}")
    if x.device.type != "cpu" and in_householder_kernel_envelope(*x.shape):
        return householder_panel(x)
    return qr_positive(x)


def default_qr_method(x: torch.Tensor) -> str:
    """The JAX package's accelerator default, the split-precision
    CholQR2 leaf, for a CUDA tensor; its non-TPU default, Householder
    (library QR), for any other (``dmd_era5_tpu/ops/tsqr.py:102``)."""
    return "cholqr2_split" if x.device.type == "cuda" else "householder"


def _combine_tree(r1: torch.Tensor, axis_name: str, mesh: Mesh, p: int):
    """Tree R combine for any p: fold + butterfly + packed return
    (``dmd_era5_tpu/ops/tsqr.py:110``).

    Returns (chain, R): ``chain`` (rk0, rk_final) maps the leaf Q1 onto
    this rank's rows of the global Q (Q_local = Q1 @ chain); ``R``
    (rk_final, T) is identical on every rank.  With q = 2^floor(log2 p)
    and rem = p - q > 0, rank q + j folds its R into rank j (one QR of
    the pair stack there, which keeps the high rank's block of Q2); low
    ranks rem..q-1 merge with a phantom zero block (R padded with zero
    rows, the chain with an [I 0] block).  The butterfly runs over the q
    low ranks, and one packed exchange returns (kept block @ butterfly
    chain, R) to each folded rank.  Every rank of the axis takes part in
    every exchange (one ``ppermute`` each, as every device of the JAX
    body does); the high ranks idle through the butterfly.
    """
    idx = mesh.coords[axis_name]
    t_cols = r1.shape[1]
    q_pow = 1 << (p.bit_length() - 1)  # largest power of two <= p
    rem = p - q_pow
    high = idx >= q_pow

    r = r1
    chain_pre = stash = None
    if rem:
        rk = r.shape[0]
        rk_next = min(2 * rk, t_cols)
        r_other = ppermute(r, axis_name, mesh, [(q_pow + j, j) for j in range(rem)])
        if idx < rem:
            q2, r = qr_positive(torch.cat([r, r_other]))
            chain_pre = q2[:rk, :rk_next]
            stash = q2[rk : 2 * rk, :rk_next]  # the folded rank's block
        elif not high:
            chain_pre = torch.eye(rk, rk_next, dtype=r.dtype, device=r.device)
            r = torch.cat([r, r.new_zeros((rk_next - rk, t_cols))])

    chain_bfly = None
    stage = 1
    while stage < q_pow:
        r_other = ppermute(r, axis_name, mesh, [(i, i ^ stage) for i in range(q_pow)])
        if not high:
            rk = r.shape[0]
            rk_next = min(2 * rk, t_cols)
            am_low = (idx & stage) == 0
            # lower index always on top: every member of a merge group
            # factors the identical stack, so R stays replicated
            top, bot = (r, r_other) if am_low else (r_other, r)
            q2, r = qr_positive(torch.cat([top, bot]))
            my_block = q2[:rk, :rk_next] if am_low else q2[rk : 2 * rk, :rk_next]
            chain_bfly = my_block if chain_bfly is None else chain_bfly @ my_block
        stage *= 2

    if chain_pre is None:
        chain = chain_bfly
    elif chain_bfly is None:
        chain = chain_pre
    else:
        chain = chain_pre @ chain_bfly

    if rem:
        # pack (the folded rank's chain, R) into one buffer: one exchange
        rk0 = r1.shape[0]
        rk_f = min(rk0 * 2 * q_pow, t_cols)  # the rank after the fold and the ladder
        payload = r1.new_zeros((rk_f, rk_f + t_cols))
        if idx < rem:
            payload[:rk0, :rk_f] = stash if chain_bfly is None else stash @ chain_bfly
            payload[:, rk_f:] = r
        received = ppermute(payload, axis_name, mesh, [(j, q_pow + j) for j in range(rem)])
        if high:
            chain, r = received[:rk0, :rk_f], received[:, rk_f:]
    return chain, r


def _combine(r1: torch.Tensor, axis_name: str, mesh: Mesh):
    p = mesh.shape[axis_name]
    if p == 1:
        # nothing to combine: the chain is the identity on the leaf rank
        return torch.eye(r1.shape[0], dtype=r1.dtype, device=r1.device), r1
    return _combine_tree(r1, axis_name, mesh, p)


def _tsqr_body(x_block: torch.Tensor, axis_name: str, mesh: Mesh, method: str):
    q1, r1 = _local_factor(x_block, method)  # (m_loc, rk), (rk, T)
    chain, r = _combine(r1, axis_name, mesh)
    return q1 @ chain, r


def tsqr_orthonormalize(y_block: torch.Tensor, axis_name: str, mesh: Mesh | None,
                        method: str) -> torch.Tensor:
    """Orthonormalize a row-sharded tall-skinny matrix, Q only: the local
    factor, the tree-reduced R combine, the rank-local Q recovery
    (``dmd_era5_tpu/ops/tsqr.py:227``).  Without a mesh, or on an axis of
    one rank, the local factor's Q."""
    q1, r1 = _local_factor(y_block, method)
    if mesh is None or mesh.shape[axis_name] == 1:
        return q1
    chain, _ = _combine(r1, axis_name, mesh)
    return q1 @ chain


def tsqr(x: torch.Tensor, mesh: Mesh | None = None, axis_name: str = AXIS_SPACE,
         method: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """QR of a tall-skinny matrix (``dmd_era5_tpu/ops/tsqr.py:241``).

    Without a mesh (or on an axis of one rank) x is the whole (S, T)
    matrix: one local factorization by ``method`` (default
    :func:`default_qr_method`).  With one, x is this rank's row block of
    a matrix row-sharded over ``axis_name`` (zero-padded by the caller,
    ``parallel.shard_rows``): returns this rank's rows of Q and the R
    that every rank of the axis holds alike.
    """
    method = method or default_qr_method(x)
    if mesh is None or mesh.shape[axis_name] == 1:
        return _local_factor(x, method)
    return _tsqr_body(x, axis_name, mesh, method)
