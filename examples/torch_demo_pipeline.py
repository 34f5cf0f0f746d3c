"""End-to-end demo of the PyTorch port: mock ERA5 -> SVD -> optimized DMD -> forecast.

The port's counterpart of ``examples/demo_pipeline.py``, with the same
configuration: the three stage mains of ``dmd_era5_tpu_torch`` on mock
data (the ingest on the host, the SVD and the DMD fit on the card), then
the artifacts inspected.  Writes HDF5 artifacts and a store under
``DMD_ERA5_TPU_ROOT`` (or the repository), through the port's own HDF5
codec and store log: it needs torch and numpy only.

Run from the repo root:
    python examples/torch_demo_pipeline.py                # on the card
    python examples/torch_demo_pipeline.py --device cpu   # on the host
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from dmd_era5_tpu_torch.pipeline import era5_dmd, era5_download  # noqa: E402

# source_path "mock_data": the mock ingest stamps this into the artifact,
# and the SVD stage's cache matcher compares against it
CONFIG = {
    "source_path": "mock_data",
    "start_datetime": "2019-01-01T00",
    "end_datetime": "2019-01-03T00",
    "delta_time": "1h",
    "variables": "temperature,u_component_of_wind",
    "levels": "1000,850",
    "svd_type": "randomized",
    "delay_embedding": 2,
    "mean_center": True,
    "scale": False,
    "n_components": 16,
    "save_data_matrix": False,
    "dmd_rank": 10,
    "optimized": True,
    "forecast_steps": 12,
    "forecast_holdout": 6,
    "lm_max_iter": 40,
}


def report(results, added: bool, retrieved: bool) -> None:
    """Print the fit's eigenvalues, residual, holdout skill and forecast."""
    eigs = results["eigenvalues"].values
    amps = results["amplitudes"].values
    print("continuous eigenvalues (1/hour), by |amplitude|:")
    for i in np.argsort(-amps):
        print(
            f"  alpha = {eigs[i].real:+.4f} {eigs[i].imag:+.4f}i   "
            f"|b| = {amps[i]:.2f}   period = "
            f"{2 * np.pi / abs(eigs[i].imag):.1f} h"
            if eigs[i].imag
            else f"  alpha = {eigs[i].real:+.4f} (non-oscillatory)  |b| = {amps[i]:.2f}"
        )
    print(f"\nDMD residual: {results.attrs['dmd_residual']:.3e}")
    if "forecast_rmse" in results.attrs:
        rmse = results.attrs["forecast_rmse"]
        p_rmse = results.attrs["persistence_rmse"]
        acc = results.attrs["forecast_acc"]
        print(
            f"holdout skill ({len(rmse)} leads): RMSE {rmse[0]:.3f} -> "
            f"{rmse[-1]:.3f} (persistence {p_rmse[0]:.3f} -> "
            f"{p_rmse[-1]:.3f}), ACC {acc[0]:.3f} -> {acc[-1]:.3f}"
        )
    fc = results["forecast"]
    print(f"forecast field: {fc.shape} (space x time, last 12 steps unseen) "
          f"on {fc.data.device}")
    print(f"artifact versioned: {added}, retrieved from store: {retrieved}")


def main(argv: list[str] | None = None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="'cpu' runs on the host (default: the card)")
    device = parser.parse_args(argv).device

    print("=== stage 1: ingest (mock backend) ===")
    era5_download.main(CONFIG, use_mock_data=True, use_store=True)

    print("\n=== stages 2+3: SVD -> optimized DMD ===")
    results, added, retrieved = era5_dmd.main(
        CONFIG, write_artifact=True, use_store=True, device=device
    )

    print("\n=== results ===")
    report(results, added, retrieved)
    return results


if __name__ == "__main__":
    main()
