"""Out-of-core decomposition demo of the PyTorch port: factor a matrix
without holding it.

The port's counterpart of ``examples/demo_out_of_core.py``: write a packed
snapshot artifact to disk (an HDF5 file of bf16 words, as the JAX demo
writes it, through the port's own HDF5 codec), then run

- the streamed randomized SVD (n_iter + 2 disk passes, the card holds
  one row block at a time, U returns on the host),
- the one-pass two-sided sketch (a SINGLE disk pass), and
- the EXACT two-pass Gram route (the T x T Gram summed in f64, one eigh,
  one lift pass),

each over 4,096-row blocks, and compare all three against numpy dense.

Run from the repo root:
    python examples/torch_demo_out_of_core.py                # on the card
    python examples/torch_demo_out_of_core.py --device cpu   # on the host
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dmd_era5_tpu_torch.pipeline.streamed_fit import (  # noqa: E402
    streamed_exact_gram_svd,
    streamed_onepass_svd,
    streamed_randomized_svd,
)
from dmd_era5_tpu_torch.snapmat.loader import save_packed_matrix  # noqa: E402


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="'cpu' runs on the host (default: the card)")
    device = parser.parse_args(argv).device

    rng = np.random.default_rng(0)
    s_rows, t_cols, k = 1 << 15, 128, 12

    # a matrix with known decaying structure + noise
    u_true, _ = np.linalg.qr(rng.standard_normal((s_rows, 16)))
    v_true, _ = np.linalg.qr(rng.standard_normal((t_cols, 16)))
    sig = np.geomspace(100.0, 5.0, 16)
    x = ((u_true * sig) @ v_true.T).astype(np.float32)
    x += 0.01 * rng.standard_normal(x.shape).astype(np.float32)

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "snapshots.h5"
        # bf16 packing halves the disk and stream footprint; every
        # streamed backend decodes it
        save_packed_matrix(path, x, d=1, bf16=True)
        print(f"packed artifact: {path.stat().st_size / 1e6:.1f} MB")

        t0 = time.perf_counter()
        res = streamed_randomized_svd(path, k, block_rows=4096, device=device)
        t_streamed = time.perf_counter() - t0

        t0 = time.perf_counter()
        res1 = streamed_onepass_svd(path, k, block_rows=4096, device=device)
        t_onepass = time.perf_counter() - t0

        t0 = time.perf_counter()
        res_x = streamed_exact_gram_svd(path, k, block_rows=4096, device=device)
        t_exact = time.perf_counter() - t0

    s_ref = np.linalg.svd(x, compute_uv=False)[:k]
    s, s1, sx = (torch.as_tensor(r.s).cpu().numpy() for r in (res, res1, res_x))
    err_s = np.max(np.abs(s - s_ref) / s_ref)
    err_1 = np.max(np.abs(s1[:8] - s_ref[:8]) / s_ref[:8])
    err_x = np.max(np.abs(sx - s_ref) / s_ref)
    print(f"streamed  ({t_streamed:5.1f}s): U {tuple(res.U.shape)} on host, "
          f"max s rel err {err_s:.2e}")
    print(f"one-pass  ({t_onepass:5.1f}s): single disk read, head-8 s rel err {err_1:.2e}")
    print(f"exact gram({t_exact:5.1f}s): 2 disk passes, max s rel err {err_x:.2e} "
          "(bf16-storage-bounded)")
    # one-pass trades a constant-factor accuracy hit for the saved pass;
    # the exact route is bounded only by the bf16 storage rounding
    assert err_s < 5e-2 and err_1 < 2e-1 and err_x < 2e-2
    print("out-of-core factors agree with dense numpy.")
    return {"streamed": err_s, "onepass": err_1, "exact_gram": err_x,
            "seconds": {"streamed": t_streamed, "onepass": t_onepass, "exact_gram": t_exact}}


if __name__ == "__main__":
    main()
