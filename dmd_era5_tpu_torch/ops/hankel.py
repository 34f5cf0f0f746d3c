"""SVDs of the delay embedding H_d(X) without building it.

PyTorch counterpart of the single-device paths of
``dmd_era5_tpu/ops/hankel.py``: the unfused operators and the
randomized SVD on them, the fused randomized SVD and the exact one.
Row block j of H_d(X) is X[:, j : j+T-d+1] (delay coordinate d-1-j), so
H_d(X) @ Omega for every block at once is ONE product X @ W with the
(T, d*r) stacked sketch W of :func:`stacked_sketch_matrix`:

- :func:`hankel_sketch` is that product on the tiled matmul (K6),
  :func:`hankel_project` Q^T H_d(X) from one projection C = Q'^T X (K3)
  and a shifted sum of C's blocks, and :func:`hankel_randomized_svd` the
  randomized SVD on the two, orthonormalized by the QR leaves;
- in the fused SVDs each pass over X is one fused
  ``ops.matmul.sketch_center_gram_project``, and U, in the embedded row
  layout (delay block j at rows [j*S, (j+1)*S)), is lifted one block at
  a time from its own column slice of the pass's y_wide, so no reshaped
  copy of y_wide is made.

The JAX package computes the unfused products with ``jnp.matmul`` at
``HIGHEST``; K6 and K3 sum f32 products into f64 tiles on the card, so
they stay at least as close to the exact sums.  On a CPU tensor their
plain versions run.

On a mesh (SPMD, ``dmd_era5_tpu/ops/hankel.py:168-883``) each rank holds
its block of the RAW X, and only small factors cross ranks:

- space-sharded (:func:`hankel_randomized_svd_sharded`, the sharded
  :func:`hankel_exact_svd`): a rank's row block covers its rows of every
  delay block (the shifts act on time, which is whole on the rank), so
  U comes back as the rank's interleaved (d*S_loc, k) block, delay block
  j at its rows [j*S_loc, (j+1)*S_loc); the Grams, the (r, T-d+1)
  projections and the R factors are psum'd or exchanged;
- time- and grid-sharded (:func:`hankel_sketch_time_sharded`,
  :func:`delay_embed_time_sharded`, :func:`hankel_randomized_svd_2d`):
  a rank holds a column block; a sketch contracts it against its own
  rows of the shifted Omega and psums over time, and the delay windows
  that cross a column boundary do so through a d-1 column halo of the
  small (d*r, L) projection, or of X itself for the blockwise embedding.

``parallel.sharding.assemble_rows`` turns the interleaved blocks into the
global delay-major U (``dmd_era5_tpu/ops/hankel.py:356-360``).
"""

from __future__ import annotations

import torch

from dmd_era5_tpu_torch.ops.matmul import matmul, project, sketch_center_gram_project
from dmd_era5_tpu_torch.ops.svd import (
    SVDResult,
    _global_rows,
    _lane_width,
    _psum_or_id,
    _svd_flip_v_based,
    gaussian_sketch,
    raw_gram,
    sklearn_n_iter,
)
from dmd_era5_tpu_torch.parallel.collectives import (
    all_gather,
    halo_exchange_left,
    halo_exchange_right,
    psum,
)
from dmd_era5_tpu_torch.parallel.mesh import AXIS_SPACE, AXIS_TIME, Mesh
from dmd_era5_tpu_torch.utils.linalg import gram_whiten, orth_small

__all__ = [
    "stacked_sketch_matrix",
    "hankel_sketch",
    "hankel_project",
    "hankel_randomized_svd",
    "hankel_randomized_svd_fused",
    "hankel_randomized_svd_fused_core",
    "hankel_randomized_svd_sharded",
    "hankel_randomized_svd_2d",
    "hankel_sketch_time_sharded",
    "delay_embed_time_sharded",
    "hankel_exact_svd",
]

# sketch columns past n_components: 28 makes the standard k = 100 a
# 128-wide sketch (the JAX package's default)
N_OVERSAMPLES = 28


def stacked_sketch_matrix(omega: torch.Tensor, d: int, t_cols: int) -> torch.Tensor:
    """W (T, d*r): column block j is Omega with rows shifted down by j."""
    t_out, r = omega.shape
    if t_out != t_cols - d + 1:
        raise ValueError(f"omega {tuple(omega.shape)} does not fit d={d}, T={t_cols}")
    w = omega.new_zeros((t_cols, d * r))
    for j in range(d):
        w[j : j + t_out, j * r : (j + 1) * r] = omega
    return w


def hankel_sketch(x: torch.Tensor, omega: torch.Tensor, d: int) -> torch.Tensor:
    """Y = H_d(X) @ Omega, (S*d, r), in one pass over X (K6 on the card).

    x (S, T) and omega (T-d+1, r) share x's dtype (float32 or bfloat16);
    Y is float32 (``dmd_era5_tpu/ops/hankel.py:72``).
    """
    s_rows, t_cols = x.shape
    r = omega.shape[1]
    y_wide = matmul(x, stacked_sketch_matrix(omega, d, t_cols).to(x.dtype))  # (S, d*r)
    # block j of Y is y_wide's j-th column slice, stacked as rows j*S:(j+1)*S
    return y_wide.view(s_rows, d, r).transpose(0, 1).reshape(d * s_rows, r)


def hankel_project(q: torch.Tensor, x: torch.Tensor, d: int) -> torch.Tensor:
    """B = Q^T H_d(X), (r, T-d+1) float32, in one pass over X (K3 on the card).

    q (S*d, r) in the delay-block row layout, x (S, T)
    (``dmd_era5_tpu/ops/hankel.py:89``): C = Q'^T X with Q' (S, d*r) the
    d blocks of Q side by side, then B = sum_j C_j[:, j : j+T-d+1].
    """
    sd, r = q.shape
    s_rows, t_cols = x.shape
    if sd != s_rows * d:
        raise ValueError(f"q has {sd} rows; H_{d}(x) has {s_rows * d}")
    t_out = t_cols - d + 1
    q_wide = q.reshape(d, s_rows, r).transpose(0, 1).reshape(s_rows, d * r).to(x.dtype)
    c = project(x, q_wide).view(d, r, t_cols)  # (d*r, T)
    return sum(c[j, :, j : j + t_out] for j in range(d))


def _sketch_of(x: torch.Tensor, t_out: int, n_random: int, omega, seed) -> torch.Tensor:
    """The (T-d+1, r) f32 sketch on x's device: ``omega`` where given,
    else drawn from ``seed`` (alike on every rank)."""
    if omega is None:
        omega = gaussian_sketch(t_out, n_random, seed, x.device)
    return omega.to(device=x.device, dtype=torch.float32)


def hankel_randomized_svd(
    x: torch.Tensor,
    d: int,
    n_components: int,
    n_oversamples: int = 10,
    n_iter: int | str = "auto",
    generator: int | torch.Generator | None = None,
    qr_method: str | None = None,
    omega: torch.Tensor | None = None,
    mesh: Mesh | None = None,
    axis_name: str = AXIS_SPACE,
) -> SVDResult:
    """Randomized truncated SVD of H_d(X) without building it, x (S, T) f32
    on one device or x the rank's row block on ``mesh``.

    Counterpart of ``dmd_era5_tpu/ops/hankel.py:114`` (and of its
    space-sharded body, ``:168``): the same steps as a randomized SVD of
    the embedded matrix (sketch, orthonormalize, ``n_iter`` power
    iterations, sklearn's v-based sign flip), every product with H_d(X)
    through :func:`hankel_sketch` (K6) and :func:`hankel_project` (K3),
    so only X and (S*d, r)-sized factors are held.  The range basis is
    orthonormalized by ``tsqr.tsqr_orthonormalize`` at ``qr_method``
    (default ``tsqr.default_qr_method``: the split CholQR2 leaf, K5, on
    a card; tree TSQR over ``axis_name`` on a mesh, where the (r, T-d+1)
    projections are psum'd) and the time-side iterate by ``orth_small``.
    The (T-d+1, n_components + n_oversamples) Gaussian sketch is
    ``omega`` where given, else drawn from ``generator`` (a generator or
    a seed, 0 when None; alike on every rank).  n_iter='auto' reads the
    whole embedded matrix's shape.  U has the embedded row layout (delay
    block j at rows [j*S, (j+1)*S)); on a mesh it is the rank's
    interleaved (d*S_loc, k) block.
    """
    from dmd_era5_tpu_torch.ops.tsqr import default_qr_method, tsqr_orthonormalize

    t_out = x.shape[1] - d + 1
    n_random = n_components + n_oversamples
    if isinstance(n_iter, str):
        n_iter = sklearn_n_iter(n_components, (_global_rows(x, axis_name, mesh) * d, t_out))
    qr_method = qr_method or default_qr_method(x)
    omega = _sketch_of(x, t_out, n_random, omega, 0 if generator is None else generator)

    def orthonormalize(y):
        return tsqr_orthonormalize(y, axis_name, mesh, qr_method)

    def project_b(q):  # (r, t_out), summed over the axis
        return _psum_or_id(hankel_project(q, x, d), axis_name, mesh)

    q = orthonormalize(hankel_sketch(x, omega, d))
    for _ in range(n_iter):
        z = orth_small(project_b(q).T)  # (t_out, r): H^T Q, orthonormalized
        del q  # the old basis goes before the new sketch: both are (S*d, r)
        q = orthonormalize(hankel_sketch(x, z, d))
    u_b, s, vt = torch.linalg.svd(project_b(q), full_matrices=False)
    u = q @ u_b[:, :n_components]
    del q
    u, vt = _svd_flip_v_based(u, vt[:n_components])
    return SVDResult(u, s[:n_components], vt)


def hankel_randomized_svd_fused(
    x: torch.Tensor,
    d: int,
    n_components: int,
    generator: torch.Generator | None = None,
    gemm_dtype: torch.dtype = torch.bfloat16,
) -> SVDResult:
    """Fused-kernel randomized SVD of H_d(X), x (S, T) on one device.

    Draws the (T-d+1, n_components + N_OVERSAMPLES) Gaussian sketch from
    ``generator`` (a fresh one seeded 0 on x's device when None) and
    runs :func:`hankel_randomized_svd_fused_core`.
    """
    omega = gaussian_sketch(x.shape[1] - d + 1, n_components + N_OVERSAMPLES,
                            0 if generator is None else generator, x.device)
    return hankel_randomized_svd_fused_core(x, d, n_components, omega, gemm_dtype=gemm_dtype)


def hankel_randomized_svd_fused_core(
    x: torch.Tensor,
    d: int,
    n_components: int,
    omega: torch.Tensor,
    gemm_dtype: torch.dtype = torch.bfloat16,
    n_iter: int | str = "auto",
    mesh: Mesh | None = None,
    axis_name: str = AXIS_SPACE,
) -> SVDResult:
    """The SVD given its sketch omega (T-d+1, r), x (S, T) on one device
    or x the rank's row block on ``mesh`` (``dmd_era5_tpu/ops/hankel.py:208``).

    sklearn's n_iter='auto' rule, on the whole embedded matrix's shape,
    sets the power iterations.  Each of the n_iter + 1 passes returns
    from one read of X
    y_wide = X W (S, d*r), G_wide = y_wide^T y_wide and
    C_wide = y_wide^T X; Y^T Y is the sum of G_wide's diagonal r x r
    blocks and B = Q^T H_d(X) follows from the CholQR2 whitener and the
    column-shifted sum of C_wide's blocks.  On a mesh only those two
    small sums, (r, r) and (r, T-d+1), are psum'd over ``axis_name``.
    U is lifted one delay block at a time from its own column slice of
    y_wide, so no reshaped copy of y_wide is made.  U has the embedded
    row layout: delay block j at rows [j*S, (j+1)*S); on a mesh it is
    the rank's interleaved (d*S_loc, k) block.
    """
    t_cols = x.shape[1]
    t_out = t_cols - d + 1
    n_random = omega.shape[1]
    if isinstance(n_iter, str):
        n_iter = sklearn_n_iter(n_components, (_global_rows(x, axis_name, mesh) * d, t_out))
    xg = x.to(gemm_dtype)
    omega = omega.to(device=x.device, dtype=torch.float32)

    def fused_pass(z):
        w = stacked_sketch_matrix(z, d, t_cols).to(gemm_dtype)
        y_wide, _, _, g_wide, c_wide = sketch_center_gram_project(
            xg, w, out_dtype=gemm_dtype, center=False
        )
        g = sum(
            g_wide[j * n_random : (j + 1) * n_random, j * n_random : (j + 1) * n_random]
            for j in range(d)
        )
        c_h = sum(
            c_wide[j * n_random : (j + 1) * n_random, j : j + t_out] for j in range(d)
        )
        inv_chol = gram_whiten(_psum_or_id(g, axis_name, mesh), base_ridge=1e-6)
        # b = Q^T H, Q = Y L^-T implicit
        return y_wide, inv_chol, inv_chol @ _psum_or_id(c_h, axis_name, mesh)

    z = omega
    for _ in range(n_iter):
        _, _, b = fused_pass(z)
        z = orth_small(b.T)
    y_wide, inv_chol, b = fused_pass(z)

    u_b, s, vt = torch.linalg.svd(b, full_matrices=False)
    u = _lift_blocks(y_wide, inv_chol.T @ u_b[:, :n_components], d)
    del y_wide
    u, vt = _svd_flip_v_based(u, vt[:n_components])
    return SVDResult(u, s[:n_components], vt)


def _lift_blocks(y_wide: torch.Tensor, lift: torch.Tensor, d: int) -> torch.Tensor:
    """U (d*S, k) f32: delay block j is y_wide's j-th column slice times
    lift (r, k), written in place into its row block of U."""
    s_rows, r = y_wide.shape[0], y_wide.shape[1] // d
    u = torch.empty((d * s_rows, lift.shape[1]), dtype=torch.float32, device=y_wide.device)
    for j in range(d):
        torch.matmul(y_wide[:, j * r : (j + 1) * r].float(), lift, out=u[j * s_rows : (j + 1) * s_rows])
    return u


def hankel_exact_svd(
    x: torch.Tensor, d: int, n_components: int, gram_precision: str = "bf16_split",
    mesh: Mesh | None = None, axis_name: str = AXIS_SPACE,
) -> SVDResult:
    """Exact truncated SVD of H_d(X), x (S, T) on one device or x the
    rank's row block on ``mesh``.

    Counterpart of ``dmd_era5_tpu/ops/hankel.py:474-628``, the
    deterministic (``svd_type="standard"``) sibling of
    :func:`hankel_randomized_svd_fused`, in two passes over the raw X:

    1. the raw Gram G = X^T X (``ops.svd.raw_gram``: the Gram kernel,
       bf16-split by default); the embedded Gram follows from the banded
       identity (H^T H)[i, j] = sum_b G[i+b, j+b], and its ``eigh`` gives
       the exact top right subspace V_k, widened as in the Gram route;
    2. ONE fused pass with the stacked shift of V_k gives y_wide, whose
       diagonal Gram blocks sum to y^T y and whose shifted projection
       blocks sum to y^T H; the CholQR2 whitener and a small SVD then
       restore the triplets to f32 accuracy.

    On a mesh the raw Gram, y^T y and y^T H are psum'd over
    ``axis_name`` and U is the rank's interleaved (d*S_loc, k) block.
    No signs are flipped (the JAX function flips none).
    """
    t_cols = x.shape[1]
    t_out = t_cols - d + 1
    g_raw = _psum_or_id(raw_gram(x, gram_precision), axis_name, mesh)
    g_h = sum(g_raw[b : b + t_out, b : b + t_out] for b in range(d))
    _, vecs = torch.linalg.eigh(g_h)  # ascending
    k_pad = _lane_width(n_components, t_out)
    v_k = vecs.flip(-1)[:, :k_pad].contiguous()
    w = stacked_sketch_matrix(v_k, d, t_cols).to(x.dtype)
    y_wide, _, _, g_wide, c_wide = sketch_center_gram_project(x, w, center=False)
    g_y = sum(g_wide[j * k_pad : (j + 1) * k_pad, j * k_pad : (j + 1) * k_pad] for j in range(d))
    c_h = sum(c_wide[j * k_pad : (j + 1) * k_pad, j : j + t_out] for j in range(d))
    g_y = _psum_or_id(g_y, axis_name, mesh)
    c_h = _psum_or_id(c_h, axis_name, mesh)
    w_wh = gram_whiten(g_y, base_ridge=1e-7)
    u_b, s, vt = torch.linalg.svd(w_wh @ c_h, full_matrices=False)
    u = _lift_blocks(y_wide, w_wh.T @ u_b[:, :n_components], d)
    return SVDResult(u, s[:n_components], vt[:n_components, :])


# ------------------------------------------------------------- on a mesh


def hankel_randomized_svd_sharded(
    x: torch.Tensor,
    d: int,
    n_components: int,
    mesh: Mesh,
    n_oversamples: int = 10,
    n_iter: int | str = "auto",
    seed: int | torch.Generator = 0,
    axis_name: str = AXIS_SPACE,
    qr_method: str | None = None,
    fused: bool = True,
    gemm_dtype: torch.dtype = torch.float32,
    omega: torch.Tensor | None = None,
) -> SVDResult:
    """Randomized SVD of H_d(X) over the rows of ``axis_name``, x this
    rank's (S_loc, T) row block (``dmd_era5_tpu/ops/hankel.py:281``).

    ``fused`` (the JAX package's "auto" wherever the port runs):
    :func:`hankel_randomized_svd_fused_core` on the mesh, each power
    iteration ONE pass of K1 over the rank's rows in ``gemm_dtype`` (f32
    by default; the JAX package picks bf16 on a TPU mesh).  Else
    :func:`hankel_randomized_svd` on the mesh (K6, tree TSQR at
    ``qr_method``, K3).  The sketch: ``omega`` (T-d+1, k + n_oversamples)
    where given, else drawn from ``seed``.  Returns U as the rank's
    interleaved (d*S_loc, k) block, s and V alike on every rank.
    """
    if not fused:
        return hankel_randomized_svd(x, d, n_components, n_oversamples, n_iter, seed,
                                     qr_method, omega, mesh=mesh, axis_name=axis_name)
    omega = _sketch_of(x, x.shape[1] - d + 1, n_components + n_oversamples, omega, seed)
    return hankel_randomized_svd_fused_core(x, d, n_components, omega, gemm_dtype, n_iter,
                                            mesh=mesh, axis_name=axis_name)


def _time_segment(omega_pad: torch.Tensor, d: int, l_cols: int, c0: int) -> torch.Tensor:
    """(L, d*r): column block j holds the rows of the padded sketch that
    delay block j of H_d(X) @ Omega takes from local columns
    [c0, c0 + L) (``dmd_era5_tpu/ops/hankel.py:805``)."""
    seg = omega_pad[c0 : c0 + l_cols + d - 1]
    return torch.cat([seg[d - 1 - j : d - 1 - j + l_cols] for j in range(d)], dim=1)


def _sketch_time_body(x_loc: torch.Tensor, omega_pad: torch.Tensor, d: int,
                      mesh: Mesh, axis_name: str) -> torch.Tensor:
    """This rank's column block's share of H_d(X) @ Omega, (d*S, r),
    psum'd over ``axis_name``: one product with the (L, d*r) segment
    (K6 on the card)."""
    s_rows, l_cols = x_loc.shape
    r = omega_pad.shape[1]
    w = _time_segment(omega_pad, d, l_cols, mesh.coords[axis_name] * l_cols)
    y_wide = psum(matmul(x_loc, w.to(x_loc.dtype).contiguous()), axis_name, mesh)
    return y_wide.view(s_rows, d, r).transpose(0, 1).reshape(d * s_rows, r)


def hankel_sketch_time_sharded(x: torch.Tensor, omega: torch.Tensor, d: int, mesh: Mesh,
                               axis_name: str = AXIS_TIME) -> torch.Tensor:
    """Y = H_d(X) @ Omega with X column-sharded over ``axis_name``: x is
    this rank's (S, L) column block, omega the whole (T-d+1, r) sketch
    (``dmd_era5_tpu/ops/hankel.py:825``).  Each rank contracts its
    columns against its rows of Omega zero-padded by d-1 at both ends,
    and the (d*S, r) partials are summed over the axis; Y is alike on
    every rank."""
    omega = omega.to(device=x.device, dtype=torch.float32)
    omega_pad = torch.nn.functional.pad(omega, (0, 0, d - 1, d - 1))
    return _sketch_time_body(x, omega_pad, d, mesh, axis_name)


def delay_embed_time_sharded(x: torch.Tensor, d: int, mesh: Mesh,
                             axis_name: str = AXIS_TIME) -> torch.Tensor:
    """This rank's (d*S, L) block of the blockwise delay embedding of X
    column-sharded over ``axis_name`` (``dmd_era5_tpu/ops/hankel.py:850``):
    local column t stacks X[:, t-d+1 .. t] after the left neighbour's d-1
    last columns arrive (``halo_exchange_left``); block j is delayed by
    d-1-j.  The first d-1 global columns are boundary-invalid (zeros
    from the left), as in the JAX package."""
    if d == 1:
        return x
    xh = halo_exchange_left(x, axis_name, mesh, halo=d - 1, axis=1)
    l_cols = x.shape[1]
    return torch.cat([xh[:, j : j + l_cols] for j in range(d)], dim=0)


def _hankel_project_grid(q: torch.Tensor, x_loc: torch.Tensor, d: int, mesh: Mesh,
                         space_axis: str, time_axis: str) -> torch.Tensor:
    """This rank's (r, L) columns of B = Q^T H_d(X) on the grid
    (``dmd_era5_tpu/ops/hankel.py:634``): C = Q'^T X_loc (K3 on the card)
    psum'd over space, then the shifted sum of its d blocks, whose
    windows cross the column boundary through a d-1 column right halo
    of the small (d*r, L) C (``halo_exchange_right``)."""
    sd, r = q.shape
    s_loc, l_cols = x_loc.shape
    q_wide = q.reshape(d, s_loc, r).transpose(0, 1).reshape(s_loc, d * r)
    c = psum(project(x_loc, q_wide.to(x_loc.dtype).contiguous()), space_axis, mesh)
    if d > 1:
        c = halo_exchange_right(c, time_axis, mesh, halo=d - 1, axis=1)
    c = c.view(d, r, l_cols + d - 1)
    return sum(c[j, :, j : j + l_cols] for j in range(d))


def hankel_randomized_svd_2d(
    x: torch.Tensor,
    d: int,
    n_components: int,
    mesh: Mesh,
    t_valid: int | None = None,
    n_oversamples: int = 10,
    n_iter: int | str = "auto",
    seed: int | torch.Generator = 0,
    space_axis: str = AXIS_SPACE,
    time_axis: str = AXIS_TIME,
    qr_method: str | None = None,
    omega: torch.Tensor | None = None,
) -> SVDResult:
    """Randomized SVD of H_d(X) with X split over space AND time
    (``dmd_era5_tpu/ops/hankel.py:668,724``).

    x is this rank's (S_loc, L) block of the (S, T_pad) matrix, columns
    past ``t_valid`` (default T_pad) zero padding.  The sketch contracts
    local columns against shifted rows of Omega (psum over time), the
    (d*S_loc, r) range basis is orthonormalized by tree TSQR over space,
    and B = Q^T H_d(X) moves only (d*r)-row factors and a d-1 column halo;
    padded windows get zero rows of the sketch and are cut from B.
    ``omega`` (t_valid-d+1, k + n_oversamples) as in
    :func:`hankel_randomized_svd_sharded`.  Returns U as the space rank's
    interleaved (d*S_loc, k) block (alike across time), s and V
    (k, t_valid-d+1) alike on every rank.
    """
    from dmd_era5_tpu_torch.ops.tsqr import default_qr_method, tsqr_orthonormalize

    s_loc, l_cols = x.shape
    t_pad = l_cols * mesh.shape[time_axis]
    t_valid = t_pad if t_valid is None else t_valid
    t_out = t_valid - d + 1
    n_random = n_components + n_oversamples
    if isinstance(n_iter, str):
        n_iter = sklearn_n_iter(n_components, (s_loc * mesh.shape[space_axis] * d, t_out))
    qr_method = qr_method or default_qr_method(x)
    omega = _sketch_of(x, t_out, n_random, omega, seed)

    def pad(z):  # (t_out, r) -> (T_pad + d - 1, r): the sketch's row layout
        return torch.nn.functional.pad(z, (0, 0, d - 1, t_pad - t_out))

    def orthonormalize(y):
        return tsqr_orthonormalize(y, space_axis, mesh, qr_method)

    def project_b(q):
        b_loc = _hankel_project_grid(q, x, d, mesh, space_axis, time_axis)
        return all_gather(b_loc, time_axis, mesh, axis=1, tiled=True)[:, :t_out]

    q = orthonormalize(_sketch_time_body(x, pad(omega), d, mesh, time_axis))
    for _ in range(n_iter):
        z = orth_small(project_b(q).T)
        del q
        q = orthonormalize(_sketch_time_body(x, pad(z), d, mesh, time_axis))
    u_b, s, vt = torch.linalg.svd(project_b(q), full_matrices=False)
    u = q @ u_b[:, :n_components]
    del q
    u, vt = _svd_flip_v_based(u, vt[:n_components])
    return SVDResult(u, s[:n_components], vt)
