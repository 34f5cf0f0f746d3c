"""Truncated SVD of a tall snapshot matrix, on one device or a mesh.

PyTorch counterpart of ``dmd_era5_tpu/ops/svd.py``:

- ``"standard"``: the exact SVD, by the Gram route (one Gram pass,
  ``eigh``, one fused Rayleigh-Ritz pass; the tall-skinny default) or
  the TSQR route (QR of X, SVD of the small R);
- ``"randomized"``: sklearn's randomized SVD, re-orthonormalizing the
  sketch through the TSQR leaf at every power iteration;
- :func:`randomized_svd_2d`: the randomized SVD of a matrix split over
  the mesh's space AND time axes;

and the result container, sklearn's v-based sign flip and its
``n_iter='auto'`` rule.  The exact routes do not flip signs; only the
randomized ones do, as sklearn does.

On a mesh (SPMD, as ``ops.tsqr.tsqr``): x is this rank's row block of a
matrix row-sharded over ``axis_name`` (zero-padded by the caller,
``parallel.shard_rows``), every S-sized product stays on the rank, and
only T- and r-sized factors cross it (``parallel.collectives``): the
Gram route psums the raw Gram, G_y and C; the randomized route psums
X^T Q and Q^T X and re-orthonormalizes by tree TSQR.  U comes back as
this rank's row block, s and V alike on every rank
(``parallel.sharding.assemble_rows`` gathers U).  ``pallas_ok`` and the
plain fallbacks it selected exist only for a CPU mesh under a TPU
backend and are gone.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dmd_era5_tpu_torch.ops.matmul import sketch_center_gram_project
from dmd_era5_tpu_torch.ops.qr_panel import gram
from dmd_era5_tpu_torch.ops.tsqr import default_qr_method, tsqr, tsqr_orthonormalize
from dmd_era5_tpu_torch.parallel.collectives import all_gather, psum
from dmd_era5_tpu_torch.parallel.mesh import AXIS_SPACE, AXIS_TIME, Mesh
from dmd_era5_tpu_torch.utils.linalg import gram_whiten, orth_small

__all__ = [
    "SVDResult",
    "exact_truncated_svd",
    "exact_truncated_svd_gram",
    "randomized_svd",
    "randomized_svd_2d",
    "truncated_svd",
    "sklearn_n_iter",
]


class SVDResult(NamedTuple):
    """U (S, k) (on a mesh: this rank's row block), s (k,) and V (k, T)
    with rows as components."""

    U: torch.Tensor
    s: torch.Tensor
    V: torch.Tensor


def _svd_flip_v_based(U: torch.Tensor, V: torch.Tensor):
    """Deterministic signs via the max-|.| entry of each right singular
    vector (sklearn's ``svd_flip(u_based_decision=False)``).

    Scales U IN PLACE (it is S-sized; a copy would double the basis's
    memory) and returns (U, flipped copy of V).
    """
    max_idx = torch.argmax(V.abs(), dim=1)
    signs = torch.sign(V[torch.arange(V.shape[0], device=V.device), max_idx])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return U.mul_(signs[None, :]), V * signs[:, None]


def sklearn_n_iter(n_components: int, shape: tuple[int, int]) -> int:
    """sklearn's n_iter='auto' rule: 7 if k < 0.1 * min(shape) else 4."""
    return 7 if n_components < 0.1 * min(shape) else 4


def _psum_or_id(x: torch.Tensor, axis_name: str, mesh: Mesh | None) -> torch.Tensor:
    return x if mesh is None else psum(x, axis_name, mesh)


def _global_rows(x: torch.Tensor, axis_name: str, mesh: Mesh | None) -> int:
    """The row count of the matrix whose block (or whole) x is."""
    return x.shape[0] * (1 if mesh is None else mesh.shape[axis_name])


def gaussian_sketch(rows: int, cols: int, seed: int | torch.Generator,
                    device: torch.device) -> torch.Tensor:
    """A (rows, cols) standard normal f32 sketch drawn from ``seed``, a
    ``torch.Generator`` or an int that seeds a fresh one on ``device``:
    alike on every rank of a mesh, whose ranks share a device type."""
    gen = seed
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((rows, cols), generator=gen, dtype=torch.float32, device=device)


def _lane_width(n_components: int, t_cols: int) -> int:
    """The Rayleigh-Ritz subspace width of the exact routes: k rounded up
    to a multiple of 128, at most T.  The JAX package widens for its
    lanes; the extra exact eigenvectors change the Rayleigh-Ritz space,
    so the port keeps the width (``dmd_era5_tpu/ops/svd.py:187-191``)."""
    return min(-(-n_components // 128) * 128, t_cols)


# ---------------------------------------------------------------- exact


def exact_truncated_svd(x: torch.Tensor, n_components: int, mesh: Mesh | None = None,
                        axis_name: str = AXIS_SPACE) -> SVDResult:
    """Exact truncated SVD of a tall (S, T) matrix by TSQR.

    Counterpart of ``dmd_era5_tpu/ops/svd.py:101``: X = Q R with the
    default leaf (:func:`ops.tsqr.default_qr_method`; on a mesh the tree
    combine over ``axis_name``), the SVD of the (T, T) R on every rank,
    and U = Q U_R on the rank's rows.  The lift is full f32 (the JAX
    package's is ``Precision.HIGH``, bf16x3 on a TPU).
    """
    q, r = tsqr(x, mesh, axis_name)
    u_r, s, vt = torch.linalg.svd(r, full_matrices=False)
    u = q @ u_r[:, :n_components]
    return SVDResult(u, s[:n_components], vt[:n_components, :])


def raw_gram(x: torch.Tensor, gram_precision: str) -> torch.Tensor:
    """X^T X at the requested precision (``dmd_era5_tpu/ops/svd.py:131``):
    the Gram kernel at every T.  The JAX package leaves T > 1024 to XLA's
    f32 sums, a VMEM limit of its Pallas kernel.  f32 sums over millions
    of rows make G indefinite in its noise directions, and this kernel,
    which sums in f64, has no such limit."""
    return gram(x, precision=gram_precision)


def _gram_route_core(x: torch.Tensor, n_components: int, gram_precision: str = "highest",
                     mesh: Mesh | None = None, axis_name: str = AXIS_SPACE):
    """Gram-route exact SVD (``dmd_era5_tpu/ops/svd.py:150``); on a mesh
    x is the rank's row block and the three small factors are psum'd.

    1. G = X^T X (one pass over X, the Gram kernel);
    2. ``eigh(G)`` gives the exact top right subspace V_k, widened to
       :func:`_lane_width`; ONE fused pass (``sketch_center_gram_project``,
       centring off) gives y = X V_k, G_y = y^T y and C = y^T X;
    3. the CholQR2 whitener W of G_y makes Q = y W^T orthonormal without
       forming it; B = Q^T X = W C is small, and its SVD restores the
       singular values to f32 accuracy; U = y (W^T U_b).
    """
    g = _psum_or_id(raw_gram(x, gram_precision), axis_name, mesh)
    _, vecs = torch.linalg.eigh(g)  # ascending eigenvalues
    k_pad = _lane_width(n_components, x.shape[1])
    v_k = vecs.flip(-1)[:, :k_pad].to(x.dtype).contiguous()
    y, _, _, g_y, c = sketch_center_gram_project(x, v_k, center=False)
    g_y = _psum_or_id(g_y, axis_name, mesh)
    c = _psum_or_id(c, axis_name, mesh)
    w = gram_whiten(g_y, base_ridge=1e-7)
    u_b, s, vt = torch.linalg.svd(w @ c, full_matrices=False)
    u = y.float() @ (w.T @ u_b[:, :n_components])
    return u, s[:n_components], vt[:n_components, :]


def exact_truncated_svd_gram(
    x: torch.Tensor, n_components: int, gram_precision: str = "highest",
    mesh: Mesh | None = None, axis_name: str = AXIS_SPACE,
) -> SVDResult:
    """Exact truncated SVD via the T x T Gram matrix (T << S).

    Counterpart of ``dmd_era5_tpu/ops/svd.py:228``: the top-k subspace
    from ``eigh`` of the f32 Gram and the triplets from a Rayleigh-Ritz
    SVD through an orthonormalized basis, so the accuracy matches the
    TSQR route down to the sqrt(eps)-conditioned tail, in two passes
    over X.
    """
    return SVDResult(*_gram_route_core(x, n_components, gram_precision, mesh, axis_name))


# ------------------------------------------------------------ randomized


def _rand_svd_core(
    x: torch.Tensor,
    omega: torch.Tensor,
    n_components: int,
    n_iter: int,
    gemm_dtype: torch.dtype,
    qr_method: str,
    mesh: Mesh | None = None,
    axis_name: str = AXIS_SPACE,
):
    """Randomized SVD given its Gaussian sketch omega (T, r)
    (``dmd_era5_tpu/ops/svd.py:275``); on a mesh x is the rank's row
    block, X^T Q and Q^T X are psum'd and the range basis is
    re-orthonormalized by tree TSQR.

    The S-sized products take their inputs in ``gemm_dtype`` and sum in
    f32; each power iteration re-orthonormalizes through the TSQR leaf
    ``qr_method`` and the (T, r) iterate through ``orth_small``.
    """

    def big_gemm(a, b):
        return a.to(gemm_dtype).float() @ b.to(gemm_dtype).float()

    def orthonormalize(y):
        return tsqr_orthonormalize(y, axis_name, mesh, qr_method)

    omega = omega.to(device=x.device, dtype=torch.float32)
    q = orthonormalize(big_gemm(x, omega))
    for _ in range(n_iter):
        z = orth_small(_psum_or_id(big_gemm(x.T, q), axis_name, mesh))
        del q  # the old basis goes before the new sketch
        q = orthonormalize(big_gemm(x, z))
    b = _psum_or_id(q.T @ x.float(), axis_name, mesh)
    u_b, s, vt = torch.linalg.svd(b, full_matrices=False)
    # only the kept components are lifted: the flip of each depends on
    # its own row of V alone
    u = q @ u_b[:, :n_components]
    del q
    u, vt = _svd_flip_v_based(u, vt[:n_components, :])
    return u, s[:n_components], vt


def randomized_svd(
    x: torch.Tensor,
    n_components: int,
    n_oversamples: int = 10,
    n_iter: int | str = "auto",
    seed: int | torch.Generator = 0,
    gemm_dtype: torch.dtype = torch.float32,
    qr_method: str | None = None,
    mesh: Mesh | None = None,
    axis_name: str = AXIS_SPACE,
    omega: torch.Tensor | None = None,
) -> SVDResult:
    """Randomized truncated SVD of a tall (S, T) matrix, or of the matrix
    whose row block x is on ``mesh``.

    Counterpart of ``dmd_era5_tpu/ops/svd.py:328``: sklearn's semantics
    (k + n_oversamples Gaussian columns, n_iter='auto' rule on the whole
    matrix's shape, truncation to k, v-based sign flip).  The
    (T, k + n_oversamples) sketch is ``omega`` where given (alike on
    every rank), else drawn from ``seed`` (:func:`gaussian_sketch`);
    torch's numbers are not JAX's.
    """
    t_cols = x.shape[1]
    n_random = n_components + n_oversamples
    if isinstance(n_iter, str):
        n_iter = sklearn_n_iter(n_components, (_global_rows(x, axis_name, mesh), t_cols))
    if omega is None:
        omega = gaussian_sketch(t_cols, n_random, seed, x.device)
    u, s, vt = _rand_svd_core(x, omega, n_components, n_iter, gemm_dtype,
                              qr_method or default_qr_method(x), mesh, axis_name)
    return SVDResult(u, s, vt)


# --------------------------------------------------- 2D (space x time)


def randomized_svd_2d(
    x: torch.Tensor,
    n_components: int,
    mesh: Mesh,
    n_oversamples: int = 10,
    n_iter: int | str = "auto",
    seed: int | torch.Generator = 0,
    space_axis: str = AXIS_SPACE,
    time_axis: str = AXIS_TIME,
    gemm_dtype: torch.dtype = torch.float32,
    qr_method: str | None = None,
    omega: torch.Tensor | None = None,
) -> SVDResult:
    """Randomized SVD of a matrix split over the space AND time axes.

    Counterpart of ``dmd_era5_tpu/ops/svd.py:384,443``: x is this rank's
    (S_loc, T_loc) block of the (S, T) matrix, rows over ``space_axis``,
    columns over ``time_axis`` (``parallel.grid_sharded``).  Each step
    psums the sketch over time, re-orthonormalizes by tree TSQR over
    space, psums X^T Q over space and all-gathers the (T, r) iterate over
    time; nothing S-sized crosses a rank except the (S_loc, r) sketch's
    sum over time.  ``omega`` (T, r) as in :func:`randomized_svd`.
    Returns U as the rank's (S_loc, k) rows (alike across time), s and V
    alike on every rank.
    """
    s_loc, t_loc = x.shape
    t_cols = t_loc * mesh.shape[time_axis]
    n_random = n_components + n_oversamples
    if isinstance(n_iter, str):
        n_iter = sklearn_n_iter(n_components, (s_loc * mesh.shape[space_axis], t_cols))
    qr_method = qr_method or default_qr_method(x)
    if omega is None:
        omega = gaussian_sketch(t_cols, n_random, seed, x.device)
    t0 = mesh.coords[time_axis] * t_loc
    omega_loc = omega.to(device=x.device, dtype=torch.float32)[t0 : t0 + t_loc]

    def big_gemm(a, b):
        return a.to(gemm_dtype).float() @ b.to(gemm_dtype).float()

    def orthonormalize(y):
        return tsqr_orthonormalize(y, space_axis, mesh, qr_method)

    q = orthonormalize(psum(big_gemm(x, omega_loc), time_axis, mesh))
    for _ in range(n_iter):
        z_loc = psum(big_gemm(x.T, q), space_axis, mesh)  # (T_loc, r)
        z = orth_small(all_gather(z_loc, time_axis, mesh, axis=0, tiled=True))
        del q
        q = orthonormalize(psum(big_gemm(x, z[t0 : t0 + t_loc]), time_axis, mesh))
    b = all_gather(psum(q.T @ x.float(), space_axis, mesh), time_axis, mesh, axis=1, tiled=True)
    u_b, s, vt = torch.linalg.svd(b, full_matrices=False)
    u = q @ u_b[:, :n_components]
    del q
    u, vt = _svd_flip_v_based(u, vt[:n_components, :])
    return SVDResult(u, s[:n_components], vt)


# ------------------------------------------------------------ dispatcher


def truncated_svd(
    x: torch.Tensor,
    n_components: int,
    svd_type: str = "standard",
    seed: int = 0,
    gemm_dtype: torch.dtype = torch.float32,
    exact_method: str = "auto",
    gram_precision: str = "bf16_split",
    mesh: Mesh | None = None,
    axis_name: str = AXIS_SPACE,
) -> SVDResult:
    """Dispatch matching ``svd_on_era5``'s semantics
    (``dmd_era5_tpu/ops/svd.py:496``); on ``mesh`` x is the rank's row
    block over ``axis_name``.

    ``exact_method``: ``"auto"`` takes the Gram route when the matrix is
    decisively tall-skinny (T <= 4096 and S >= 4 T, the ERA5 regime,
    on the whole matrix's S) and TSQR otherwise; ``"gram"`` or ``"tsqr"``
    force one.  ``gram_precision`` is the Gram route's first pass:
    ``"bf16_split"`` (K5, the default) or ``"highest"`` (K4).
    """
    if svd_type == "standard":
        s_rows, t_cols = _global_rows(x, axis_name, mesh), x.shape[1]
        method = exact_method
        if method == "auto":
            method = "gram" if (t_cols <= 4096 and s_rows >= 4 * t_cols) else "tsqr"
        if method == "gram":
            return exact_truncated_svd_gram(x, n_components, gram_precision, mesh, axis_name)
        return exact_truncated_svd(x, n_components, mesh, axis_name)
    if svd_type == "randomized":
        return randomized_svd(x, n_components, seed=seed, gemm_dtype=gemm_dtype, mesh=mesh,
                              axis_name=axis_name)
    raise ValueError(f"SVD type {svd_type} is not supported.")
