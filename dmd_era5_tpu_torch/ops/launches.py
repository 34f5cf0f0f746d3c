"""The hand-written kernels' launch counters, by kernel key.

Each kernel's wrapper (``ops.matmul``, ``ops.qr_panel``) adds one to its
counter where it launches its kernel on the card, and nowhere else.
:func:`launch_counts` reads them under the keys K1-K7 of the kernel
table (K4 and K5 are ``gram``'s two precisions);
:func:`route_counts` reads K2's by route (the cluster kernels or K1's
stages, ``ops/k2.py``'s table); :func:`reset_launch_counts` sets them all
to 0.
"""

from __future__ import annotations

from dmd_era5_tpu_torch.ops import matmul, qr_panel

KEYS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7")


def launch_counts() -> dict[str, int]:
    """Each kernel's launches since its counter was last set to 0."""
    return {"K1": matmul.sketch_center_gram_project.launches,
            "K2": matmul.sketch_center_gram.launches,
            "K3": matmul.project.launches,
            "K4": qr_panel.gram.launches["highest"],
            "K5": qr_panel.gram.launches["bf16_split"],
            "K6": matmul.matmul.launches,
            "K7": qr_panel.householder_panel.launches}


def route_counts() -> dict[str, int]:
    """K2's launches since its counters were last set to 0, by route."""
    return {f"K2/{route}": n for route, n in matmul.sketch_center_gram.launches_by_route.items()}


def reset_launch_counts() -> None:
    """Every kernel's launch counter to 0."""
    matmul.sketch_center_gram_project.launches = 0
    matmul.sketch_center_gram.launches = 0
    matmul.sketch_center_gram.launches_by_route.update(
        {r: 0 for r in matmul.sketch_center_gram.launches_by_route})
    matmul.project.launches = 0
    matmul.matmul.launches = 0
    qr_panel.gram.launches.update({p: 0 for p in qr_panel.gram.launches})
    qr_panel.householder_panel.launches = 0
