#!/usr/bin/env python3
"""Time the port's pure-Python LZ4 decoder on one ARCO-ERA5-sized chunk.

    python3 scripts/torch_lz4_rate.py [--seed N]

Builds the blosc-LZ4 frame of ``chip_smoke.py``'s step 16g (153.7 MB,
c-blosc's 512 KiB blocks, four split streams a block, each stream a
4-byte literal run and a 60-byte overlapping match, repeated), decodes it
through ``dmd_era5_tpu_torch.snapmat.zarr_reader`` and checks the bytes
against the chunk that built it; prints the rate.  Needs no card: the
decoder runs on the host (~18 s on one Xeon core).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

ARCO_CHUNK = 37 * 721 * 1440 * 4  # one hour of all 37 levels, f32


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    res = chip_smoke.lz4_rate(ARCO_CHUNK, args.seed)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
