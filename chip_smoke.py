#!/usr/bin/env python3
"""Drive the port's main path once on one NVIDIA GPU, at ERA5-week size.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout of this repository, on a machine with
one CUDA card (an H100: the kernels are built for sm_90a).  Phases, each
of which raises on failure so the script exits non-zero:

0. device: name and power limit from nvidia-smi; full-f32 matmul flags;
1. build: one nvcc per kernel source of ``dmd_era5_tpu_torch/ops/csrc``,
   all started together, into ``build/dmd_era5_tpu_torch/``;
2. K1 (the fused sketch/Gram/projection kernel) against its plain
   PyTorch version on the card, at the fit step's bench shape and at a
   2^20-row Hankel shape, with times;
3. the slice at one week of hourly 0.25-degree ERA5 (15 variable-level
   blocks of 721 x 1440 rows, 168 hours), generated on the device from
   the seed: centre rows, randomized Hankel SVD (d = 2, k = 100),
   optDMD (rank 6), a 24-step forecast;
4. the fused fit step (k = 100, sketch 128) on the same matrix, f32 and
   bf16;
5. K1 against its plain version again, on that matrix with the sketch
   widths and flags the main path gave it;
6. the Gram kernels K4 (full f32) and K5 (bf16 split) against their
   plain versions and the f64 sums, on that matrix and on a 110-column
   sketch of it; K4's routes on its mainloop (``csrc/atb_wgmma.cuh``) held
   by name: the matrix's rows by TMA, 82 of its columns by one bulk copy a
   slab, one launch without scratch at 34 x 166 and 6 x 95;
7. the ``svd_type = standard`` path on that matrix: exact Hankel SVD
   (d = 2, k = 100) -> optDMD -> forecast, with phase 3's randomized
   singular values held below the exact ones;
8. ``truncated_svd`` at d = 1 on that matrix by its four routes (Gram
   route with K5, Gram route with K4, TSQR, randomized), held to one
   another;
9. the out-of-core SVD at the same size: (a) the tiled matmul K6 and the
   Householder panel K7 against their plain versions at the streamed
   path's shapes (K7 also at its envelope's edges), K6 also against the
   f64 product with a one-TF32-pass control, and both kernels' device
   times beside their wrappers' and the library's; (b) the centred X
   written from the card to a packed
   ``.npy`` artifact (10.47 GB) in a temporary directory (``TMPDIR``),
   deleted at the end; (c) ``streamed_randomized_svd`` on it (65,536-row
   blocks, n_iter auto = 4: six passes, K6 on every block of five, K7
   four times), then (e) optDMD and the forecast on its result at d = 1;
   (d) ``streamed_exact_gram_svd`` (2^18-row blocks, no kernel); both
   held to phase 8 (b) and to an out-of-core bound on device memory;
11. (run next, on the week still on the card) (a) K2 and K3 against
   their plain versions at the shapes and types of the pass below, with
   times; then the randomized Hankel SVD at d = 3, k = 100 in bf16: a
   384-wide sketch, past the fused kernel K1, so each of its five passes
   takes the two-pass route (K2 ``sketch_center_gram``, on its clusters,
   then K3 ``project``), then optDMD and the forecast;
12. (run next, on the week still on the card) the SVD stage's entry
   points, with ``DMD_ERA5_TPU_ROOT`` and ``DMD_ERA5_TPU_REMOTE`` in a
   temporary directory (``TMPDIR``), removed at the end; every file goes
   through the port's own HDF5 codec and store log (no h5py, no yaml).
   (a) north-star config 1, ``config.ini``'s
   ``[era5-download]`` and ``[era5-svd]`` on the mock backend (the global
   numpy state seeded): ``era5_download.main`` and ``era5_svd.main`` with
   the store, then ``era5_svd.main`` again as a workdir cache hit; s held
   below the f64 s of the saved X, U^T U to 1e-3, the store's logs
   naming both artifacts, K1 5 launches; (b) north-star config 3: the
   week's raw X (the centred X plus phase 3's row means, in place) written
   as the ERA5 slice, a FieldSet of (time, level, latitude, longitude)
   fields (10.47 GB), then ``era5_svd.main`` on ``[era5-svd]`` with the
   week's dates, variables and levels, ``n_components = 100`` and X not
   saved (the sliced fields moved to the card once, flattened and
   standardized there; K1 5 launches; a 12.46 GB U written), then again
   as a workdir cache hit whose U is the first run's bit for bit.
   (b)'s s are held within the interlace of phase 7's exact Hankel s,
   the leading 6 within 1e-5 of phase 3's, U^T U to 1e-3 (on the
   artifact read back) and X_mean against phase 3's row means, with each
   step's wall time, the phase's peak device memory, the bytes written
   to disk and each file step's GB/s;
13. (run next, on the week still on the card) the DMD stage's entry
   points.  (a) North-star config 1, ``config.ini``'s ``[era5-dmd]`` as
   it is but for the mock's source_path (rank 6, optimized, 24 forecast
   steps): ``era5_dmd.main`` with the files and the store, then again as
   a workdir cache hit; shapes,
   finite values, the attrs, K1 5 launches.  (b) The week's optDMD from
   12b's results (rank 6, 24 forecast steps): the planted eigenvalues
   within 1e-2, the 24 future columns within 5e-2 of the noise-free
   signal, the field filled block by block on the card equal to the
   one-shot ``undo_preprocessing(rollout(...))`` in row chunks (1e-5 of
   max|field|), no kernel launch.  (c) The week with a 24-hour holdout:
   ``compute_svd_results`` on the slice as 12b read it back (144 train
   hours; K1 5
   launches), then the fit scored on the withheld day: RMSE, ACC and
   bias per lead, DMD's and persistence's, within 1e-5 of an f64
   one-shot over the same forecast and weights, and DMD's RMSE at lead
   24 below persistence's.  (d) The week bagged (8 trials of 80%): the
   trial-mean eigenvalues within 1e-2 of the planted ones, finite stds,
   the trials used recorded, no kernel launch, and peak device memory
   less than 8 x the modes' 1.49 GB above (b)'s.  Each fit prints its
   steps' wall times (U's move to the card, the fit, the scores, the
   forecast, the rest), the device memory it took and the host's RSS;
14. (run next, on the week still in memory; (d) runs inside phase 9,
   while its packed artifact exists) mrDMD, DMDc, the ensemble and the
   mode analysis, at full width (config 3, nothing cut): (a) config 1
   with ``multiresolution_levels = 2`` and ``control_input = "diurnal"``
   through the DMD stage as in 13a (K1 7, K4 5); (b) mrDMD in the POD
   subspace of 12b's SVD (3 levels at rank 6, 1.5 cycles a window; K4
   once a window): the slow parts equal U (Z - residual) within 1e-5 of
   ||Z|| (row blocks), the planted eigenvalues at level 0 within 1e-2,
   the 84-hour pair slow at level 1 alone; (c) after (g), the week's raw
   X freed, the raw refit (rank 6) of the centred d = 2 embedding
   (31,147,200 x 167, 20.8 GB) on the card, K4 once a window, slow parts
   + residual = X within 1e-5 of ||X||; (d) ``fit_mrdmd_streamed`` over
   phase 9's artifact (K4 once a 65,536-row block, 238, into f64 sums on
   the card; then the mode pass) against ``fit_mrdmd`` on the same X on
   the card: eigenvalues matched within 5e-3, equal mask counts,
   residual_fro within 2e-2; (e) DMDc (diurnal) on 12b's SVD: A's
   eigenvalues within 1e-2 of the planted ones; the k-sized fit and the
   same call on the plain versions (the host) within
   ``DMDC_GRAM_ROUTE_GAP`` of an f64 exact-SVD formula, its forced
   rollout against Z (1e-1); (f) ``fit_per_variable_level`` on the week's
   FieldSet (15 members of 1,038,240 x 168, k = 100, ``solve_dmd`` at
   rank 6; K1 15): each member's s within the interlace of its f64
   values up to the f32 eigh's backward error (``FIT_STEP_EIGH_SLACK``),
   the leading 6 within 1e-4, its planted eigenvalues within 1e-2; (g) ``mode_spectrum``
   and ``modes_to_grid`` on 13b's result: the planted periods, grid
   entries equal to the flat modes' rows; (h) ``varpro_lm_checkpointed``
   resuming from its own file (the file's bytes and read time logged).
   Each part prints its wall time and device
   memory rise, the phase the host's RSS;
15. the one-pass and updating SVD (north-star config 5's half on one
   card).  (a) Inside phase 9, while its artifact exists:
   ``streamed_onepass_svd`` (k = 100) over it, one disk pass (K6, K3, K4
   once a 65,536-row block, 238 each) and the U lift from host memory
   (K6 238): the leading 6 s within 1e-3 of phase 8 (b)'s, the tail
   estimate within [0.5, 3] x the true rank-100 error (computed on the
   card from X), U^T U printed beside 9c's.  (d) Then the profiler
   (``utils.profiling.trace``) on one pass of 9c with each block copied
   from pageable memory on the compute stream, the same pass through the
   pinned ring, and one pass of 15a: the device's idle share and the
   share of the H2D copies that overlaps kernels, read from the traces;
   15a's core on the card beside the same core on the host in f64; K3
   (W = Psi^T X_blk, the +-1 panel), K6 (Y = X_blk Omega, 128 columns a
   CTA) and K4 (G of a Y block) against their plain versions and the f64
   sums at 15a's block shapes; K3 at
   15a's block against its bound (``roofline``).  (c) After
   phase 13: 13c's SVD (144 hours) updated by the withheld 24 hours and
   the boundary hour by ``era5_svd_update.update_from_slice`` on the
   slice as 12b's main read it back from its file (the week goes through
   its files once, in 12b: its own files would pass the machine's 45 GiB
   cap on a call's disk writes): V over the week's 167 embedded hours, U^T U
   to 2e-3, the leading 6 s within 1e-4 of the exact Hankel SVD of the
   same matrix (phase 7's route, run again on the week centred by the
   144-hour mean); K3 (U^T C) and K6 (U L, a lift chunk) on the
   update's own operands against their plain versions and the f64 sums;
   then the DMD forecast rollout (rank 6, 24 steps) on the updated
   factors with the planted eigenvalues within 1e-2.  (b)
   Config 1 with ``svd_backend = onepass`` in memory (K6 2, K3 1, K4 1):
   the estimate in the attrs, the reconstruction within 1.6 x optimal.
   Each part prints its prediction before it runs;
10. one year of hourly 1-degree ERA5 (181 x 360 points, 15 variable-level
   blocks, 8,760 hours: 977,400 rows), generated on the card from the
   seed after the week is freed, centred in place, with the exact
   singular values of X and of its d = 2 Hankel embedding from an f64
   Gram and f64 ``eigvalsh``: (a) K2 and K3 against their plain versions
   at the path's shapes, with times, K5 on X (K = 8,760) against the
   f64 Gram of the references (no plain version: it does not fit), and
   K7 on Z = X^T (X Omega) (8,760 x 110, spectrum s^2), the panel that
   the streamed randomized route's first leaf gets from this year; (b)
   the SVD stage's dispatcher ``svd_on_era5`` on ``config.ini``'s
   ``[era5-svd]`` defaults at that size (hankel, randomized, f32: eight
   two-pass passes); (c) optDMD and
   the forecast on it; (d) ``svd_type = standard`` through the same
   dispatcher (the exact Hankel SVD: K5 once, one two-pass pass); (e)
   ``fit_step_fused`` and ``fit_step_lean`` (k = 100, sketch 128)
   against each other, against the exact loss and a control; (b), (d)
   and (e)'s singular values are held below the exact ones; (f) K1 and
   the two-pass route timed on the same X and sketch;
16. (run last, on the card freed) config.ini's real-data source path on
   a Zarr store laid out as ARCO-ERA5's (the committed
   ``tests/fixtures/arco_era5_fullscale.zmetadata.json``): (a) variable
   ``temperature`` (99, 37, 721, 1440) f32 in chunks of one hour (153.7 MB
   each, 15.2 GB), the levels in ARCO's order, CF time, fill NaN,
   consolidated metadata, 2018-12-31T23 to 2019-01-05T01, each hour made
   on the card by ``make_era5``'s recipe with its own offset a level and
   stored as a blosc memcpy frame, in a temporary directory (``TMPDIR``,
   which must hold ~17.1 GB; the phase fails, never skips, when it does
   not), deleted at the end; (b) ``config.ini``'s ``[era5-download]`` with
   source_path the store (``download_era5_data``: ``_open_remote_era5``,
   slicing, the config attributes, the slice saved): exactly the window's 97 chunks read
   (the store's gets counted), bytes read against kept (~37), the slice
   equal bit for bit to the generated 1000 hPa hours; (c)
   ``era5_svd.compute_svd_results`` on ``[era5-svd]`` (K1 5) and
   ``era5_dmd``'s fit and forecast on ``[era5-dmd]``: the planted
   eigenvalues within 1e-2, s within the interlace of the f64 exact s of
   H_2 of the centred X; (d) ``zarr_to_packed`` to a ``.npy``, equal bit for
   bit to ``build_snapshot_matrix``, and ``streamed_randomized_svd`` (k 10)
   over it (K6 and K7 held exactly), s against the f64 exact s of the same
   X; then the same to an HDF5 ``.h5`` written by the port's codec, X read
   back bit for bit and the streamed SVD from it (K6 and K7 again) with U
   and s bit for bit the ``.npy`` route's, each pass timed beside the
   ``.npy`` one; (e) the unfused ``hankel_randomized_svd`` (d 2, k 10: K6, K3 and the
   split CholQR2 leaf's K5 held exactly) against
   ``hankel_randomized_svd_fused`` and the f64 exact SVD of H_2(X); then
   K1, K3, K6 and K7 against their plain versions on the operands (c)-(e)
   gave them; (f) one chunk at ARCO's size as c-blosc lays out a zlib
   frame (1 MiB blocks, each shuffled on its own and split into four
   streams) decoded and held against its bytes, with its rate; (g) the
   pure-Python LZ4 decoder's rate on one 153.7 MB blosc-LZ4 chunk in
   c-blosc's layout for ARCO's codec (512 KiB blocks, four streams a
   block), its streams built by construction (a 4-byte literal run and a
   60-byte overlapping match, repeated), held against its chunk; (h)
   (b)'s slice written as netCDF-C lays out a compressed variable
   (``tests/torch_nc4_writer.py``: superblock 2, version 2 object headers,
   new-style groups, one hour a chunk, shuffle + deflate at level 4,
   chunks compressed in threads), read back by ``load_fieldset`` bit for
   bit, then ``era5_svd.main`` on ``[era5-svd]`` with that file as the
   stage's slice (K1 5, each distinct K1 call held on its operands
   against its plain version and the f64 sums, within 5e-7 of them,
   which one TF32 pass misses at these rows), U and s bit for bit
   (c)'s; the file deleted after;
17. (inside phase 9, while its artifact exists) the mesh: (a) one rank
   over NCCL in this process (a ``file://`` store under ``TMPDIR``): the
   meshed fit step (``make_fit_step`` on a (1, 1, 1) mesh) at f32 and
   bf16 against phase 4's ``fit_step_fused`` on the same X and Omega (s
   within 2e-3 of s[0], the loss within 1e-3, the leading U's
   orthonormality as phase 4 holds it), K1 once a step, every collective
   within B_loc r T elements; (b) 2 and 3 ranks sharing the card over
   gloo, spawned after phase 1 built the kernels: each reads its rows of
   the artifact (``load_row_sharded``), runs the meshed step (K1; held to
   (a)'s), then tree TSQR of its Yc (the split CholQR2 leaf, K5) and of
   an 8,192 x 110 panel a rank (the Householder leaf, K7): R on every
   rank within 2e-4 of max|R| of one-device ``tsqr`` of the whole panel,
   Q^T Q no further from I than one device's plus 1e-5, log2 P or
   ceil(log2 P) + 1 exchanges of at most 2 T^2 elements, the ranks'
   launches counted; (c) the portable step on (1, 2, 2), 4 ranks, on the
   week's first 2^20 rows (a cut of depth), held to (a)'s step on the
   same rows; one ``[17] mesh`` line with each part's times, collective
   calls and bytes by op, and peak device memory, beside the card's name
   and power limit.
18. (riding in 17's worlds) the SVD layer on the mesh: (a) after 17a, on
   a (1, 1, 1) mesh over NCCL in this process, the fused sharded Hankel
   SVD (phase 3's sketch; K1) and the sharded exact Hankel SVD (K5 + K1)
   on the week, held to phases 3 and 7 (s within 1e-5 of s[0], the
   leading 6 columns of U spanning theirs); (b) in 17b's ranks (P = 2, 3)
   on their rows of the artifact: the sharded Hankel SVD at d = 2 fused
   (K1) and unfused (K6, K3, the split CholQR2 leaf K5 under tree TSQR),
   the sharded exact Hankel SVD, ``truncated_svd`` by its Gram route
   (K5 + K1), its TSQR route (the centred fault held in
   ``TSQR_CENTRED_FAULT``'s bracket) and its randomized route, each held
   to its one-device run (phases 3, 7 and 8, and the unfused SVD run
   here on the same sketch): s, the ranks' U blocks' summed Gram, every
   rank's collectives within tests/test_21_comm_pattern.py's bounds,
   exact launches; K1, K6, K5 (on the rows and on the sketch) and K3
   first held to their plain versions at a rank's shapes in this process; (c) in 17c's ranks on (1, 2, 2),
   the same 2^20 rows: ``randomized_svd_2d``, ``hankel_randomized_svd_2d``
   (d = 2), ``hankel_sketch_time_sharded`` (against the f64 product) and
   ``delay_embed_time_sharded`` (bit for bit), against one device on the
   same rows (s within 1e-5 of s[0]; a control with the projection's
   right halo dropped must miss that), K6, K3 and K5 first held to their
   plain versions at rank 0's shapes in this process; (d) in 17b's two ranks, config 1 (``config.ini``) with
   ``mesh_shape = space=2`` by three routes (the sharded randomized
   Hankel SVD, the standard one, and ``svd_backend = inmem``: rank 0
   writes the packed ``.npy``, each rank reads its rows): ``era5_svd.main``
   with the files (the slice staged by the one-device run), against the
   same one-device run in this process.  ``[18a]``-``[18d]`` lines carry each
   part's times, each rank's times and peak memory, the collectives.
19. (riding in 17's worlds) the DMD models on the mesh, each part's
   one-device reference first in this process, and K1 (on a member, N
   110, and on rank 0's 34 rows of DMDc's stack, N 128) and K4 (on DMDc's
   two stacks' rank 0 blocks) against their plain versions at the ranks'
   shapes: (a) in 17b's P = 3 ranks, ``fit_per_variable_level`` over
   data=3 on the week's 15 members (5 a rank, each rank reading its
   members' rows of the artifact through memmaps; ``solve_dmd`` at rank
   6), the state gathered whole to every rank, held to the same ensemble
   on a (1, 1, 1) mesh here (each member's s within 1e-5 of its s[0],
   the eigenvalues of a_red's leading 6 x 6 block and the DMD
   eigenvalues as matched sets within 1e-5, a_red within
   ``MODELS_A_REC_TOL`` of its recompute from the member's own s and V,
   U's orthonormality within 17a's 1e-3 (leading 6) and twice one
   device's (all), each member's leading-6 span within
   ``MODELS_SPAN_TOL``; each reading also with members 0 and 1 swapped,
   a planted gather fault); (b) in
   the P = 2 ranks, the ensemble over data=2 (15 members padded to 16,
   no DMD solve) as (a), then BOP-DMD over data=2 (8 trials of 80%) on
   the ranks' own 18b fused Hankel SVD (d = 2, k = 100; U made whole on
   each rank's card through a file in the page cache), held to one
   device's bag on phase 3's sketch (eigenvalues within 1e-5 as matched
   sets, amplitudes 1e-4) and the planted eigenvalues (1e-2), its own
   collectives one gather over data; (c) in the P = 3 ranks, DMDc
   (diurnal, rank 6) over space=3 on the same factors (Z's 100 rows do
   not divide 3: zero rows pad them), held to one device's (discrete
   eigenvalues within ``DMDC_GRAM_ROUTE_GAP``, b^T b and b^T a b within
   1e-2), its own collectives the Gram route's 6 psums and U's 2 gathers
   over space; (d) in 17c's 4 ranks on data=2,space=2, config 1's
   settings, grid and window through ``era5_svd.main`` with the files
   (the slice staged by the one-device run) and
   ``fit_dmd_from_svd_results`` (bagged, 8 trials, with the diurnal
   DMDc) on its mock slice with three planted waves
   (``planted_slice``): every rank's results alike, s within 1e-5 of
   s[0] of one device's ``inmem`` route, the fit held to the one-device
   fit on the same factors (the bag as (b), DMDc as (c)), the bag to
   the planted waves within 2e-3 and to the one-device fit with its LM
   in the ranks' blocks; the witness (``lm_witness``): config 1's own
   mock, one device's bag as one batch and in the ranks' blocks, and the
   same trials solved on the mesh held to the blocks' run.  K1 and K4
   are first held against their plain versions at rank 0's shapes of
   (a)-(d) here (a member; DMDc's row blocks at P = 3 and of config 1
   at space=2; config 1's Hankel row block).
   ``[19a]``-``[19d]`` lines carry each part's readings, each rank's
   seconds and peak memory, the collectives and launches.
20. (run last, after 16) the port's tools and examples on the card: (a)
   ``scripts/torch_verify.py`` in this process, its fifteen oracle checks
   (``scripts/tpu_verify.py``'s, through the port; each check's launches
   held to ``VERIFY_LAUNCHES``) and its seven kernel checks (K1-K7
   against their plain versions and f64 sums, one launch each), all 22
   passed; (b) ``examples/torch_demo_out_of_core.py``'s ``main`` (its
   HDF5 file of bf16 words under ``TMPDIR``; its three streamed routes held
   to its own limits against numpy); (c) ``examples/torch_demo_pipeline.py``:
   its ``main`` with the files and the store under a temporary root, s
   at most
   the f64 s of the stage's X times 1 + 1e-4 (12a's gate), 10 finite
   eigenvalues, the forecast's shape, the holdout scores; (d)
   ``utils.linalg.lstsq_implicit``'s forward Jacobian (``torch.func.jacfwd``
   through its rule) against the same through ``complex_lstsq``, on
   tests/test_13_checkpoint.py:78-115's case (rtol 1e-3, atol 1e-4).
   The launches of (a)'s oracle checks, (b) and (c) are held to
   ``TOOLS_LAUNCHES`` and counted; (a)'s kernel checks are comparisons.
   After each of (a), (b) and (c), every distinct kernel call it made (by
   kernel, shapes, dtypes and flags; recorded by ``kernel_operands``) is
   held against its plain version and the f64 sums on its own operands,
   by the compare helper of its kernel with its limits and controls
   (``hold_operands``, uncounted).

Phases 3-4, 7, each call of 8, 9c-e, 9d, 11, 12, 13, 14, 15a-c, 17a-c, 18a-d, 19a-d, 10b-e,
16c-e and 20a-c (20a's oracle checks) are the main path (17b's, 17c's, 18b-d's and 19's on the ranks, reported back):
every kernel's launch count is set to 0 just before each and read just
after, and checked exactly.  The comparisons (2, 5, 6, 9a, 11a, 10a,
10f, 14c-d's, 15c-d's, 16's, 17b's, 18b's, 18c's and 19's at a rank's shapes,
20a's kernel checks and 20a-c's held calls),
15d's passes, 18's and 19's one-device references (19d's fits on the ranks'
factors and its witness too) and 18c's halo-dropped control are not counted.  The last line is the JSON result; the line before
it the card's name and power limit; before that one JSON line with every
kernel, and before that one line a K1 comparison with the device ms of
each of K1's three stages (sketch, G, C) and one line a K2 comparison
with the device ms of each of its two (sketch, G) and its route (the
cluster kernels of ``sketch_center_gram.cu`` or K1's first two stages, by
``ops/k2.py``'s table); the kernel line has one K2 entry a route, each
with its main-path launches.  Without CUDA the script exits non-zero before printing any
result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CSRC = "dmd_era5_tpu_torch/ops/csrc"
# name, source, the TPU kernel it replaces, by key of the launch counts
KERNELS = {
    "K1": ("sketch_center_gram_project", f"{CSRC}/sketch_center_gram_project.cu",
           "dmd_era5_tpu/ops/matmul.py:183"),
    # the TPU's whole-T (K2a) and T-tiled (K2b) variants; this entry is K2's
    # route on K1's sketch and G stages (the year's f32), K2_CLUSTERS its
    # route on thread-block clusters (ops/k2.py's table: bf16 at N 257-512)
    "K2": ("sketch_center_gram", f"{CSRC}/sketch_center_gram_project.cu",
           "dmd_era5_tpu/ops/matmul.py:142, dmd_era5_tpu/ops/matmul.py:442"),
    "K3": ("project", f"{CSRC}/project.cu", "dmd_era5_tpu/ops/matmul.py:593"),
    "K4": ("gram_highest", f"{CSRC}/atb.cu", "dmd_era5_tpu/ops/qr_panel.py:40"),
    "K5": ("gram_bf16_split", f"{CSRC}/gram.cu", "dmd_era5_tpu/ops/qr_panel.py:62"),
    "K6": ("matmul", f"{CSRC}/matmul.cu", "dmd_era5_tpu/ops/matmul.py:79"),
    "K7": ("householder_panel", f"{CSRC}/householder.cu", "dmd_era5_tpu/ops/qr_panel.py:212"),
}
K2_CLUSTERS = ("sketch_center_gram", f"{CSRC}/sketch_center_gram.cu", KERNELS["K2"][2])
# K2's main-path launches by route (``ops.launches.route_counts``), summed
# over the phases that run it (10 on K1's stages, 11 on the clusters)
K2_ROUTES = {"clusters": 0, "stages": 0}
# phase 11a's K2 reading at the d = 3 pass: the clusters' line
K2_D3: dict = {}
# H100 SXM published peaks (NVIDIA data sheet, dense): f32 on CUDA cores,
# bf16 and TF32 on tensor cores, HBM3
PEAK_F32, PEAK_BF16, HBM_BYTES_S = 67e12, 989e12, 3.35e12
PEAK_TF32 = 495e12

# one week of hourly 0.25-degree ERA5, 3 variables x 5 pressure levels
N_LAT, N_LON, N_BLOCKS, T_HOURS = 721, 1440, 15, 168
LEVELS = (1000.0, 850.0, 700.0, 500.0, 250.0)
# planted damped oscillating pairs: damping (1/h), period (h), amplitude (K)
PAIRS = ((-0.002, 24.0, 12.0), (-0.004, 12.0, 8.0), (-0.001, 84.0, 6.0))
NOISE_FRACTION = 0.01  # noise std relative to the planted signal's rms
CHUNK = 1 << 20
# truncated_svd's TSQR route on the row-centred week (phase 8 (c)), a known
# fault: brackets around its readings on an H100 (max|U^T U - I| 1.41e-3,
# leading 6 s 7.0e-5 off the Gram route's)
TSQR_CENTRED_FAULT = {"orth": (5e-4, 2e-3), "lead6": 2e-4}
# the streamed SVD's blocks (the JAX package's defaults) and sketch width
RAND_BLOCK, EXACT_BLOCK, R_SKETCH = 1 << 16, 1 << 18, 110
GIB = 1 << 30
# one year of hourly 1-degree ERA5 (2019), the same 15 variable-level
# blocks; pairs damped slowly enough to keep >= 10% of their amplitude
# at hour 8,760
YEAR_LAT, YEAR_LON, YEAR_DEG, YEAR_HOURS = 181, 360, 1.0, 8760
YEAR_PAIRS = ((-1e-4, 24.0, 12.0), (-2e-4, 12.0, 8.0), (-5e-5, 730.0, 6.0))
# config.ini's [era5-svd] with only these overrides (phase 10 b, d)
YEAR_CONFIG = dict(start_datetime="2019-01-01T00", end_datetime="2019-12-31T23",
                   variables="temperature,u_component_of_wind,v_component_of_wind",
                   levels="1000,850,700,500,250", n_components=100)
# the year's fit step (phase 10 e) on an H100: its loss over the exact
# rank-100 loss, at most (reads 1.0182; the control, the same fit with
# components 7-100 dropped, 1.0234); the share of the exact energy of
# components 7-100 that its s must hold (reads 0.852; 0 without them)
FIT_LOSS_LIMIT = 1.021
FIT_TAIL_SHARE_MIN = 0.8
# K3's C against the f64 sums at the main path's shapes (the year's N 256
# and N 128, the d = 3 pass), of max|C|: 3xTF32 reads 0.9-1.0e-7 there on
# an H100, the f32 library product 5.3e-7; one TF32 pass must read above it
K3_F64_LIMIT = 2e-7
# K6's out against the f64 product at the streamed block and its ragged tail
# (f32 operands), of max|out|: at most this many times the plain f32
# product's error in the same run (3xTF32 with the MMA sums restarted every
# chunk reads 1.9e-7 and 2.2e-7 there on an H100, the plain version 4.9e-7
# and 5.2e-7, one TF32 pass 8.9e-5 and 9.2e-5; the MMAs chained over a tile,
# scripts/torch_k6_phases.py's `chained` variant, 1.6e-6 and 2.0e-6)
K6_F64_FACTOR = 2.0
# K1 against the two-pass route at the year (phase 10f), in CUDA-event ms:
# since K2 runs K1's sketch and G stages the two read alike (163.5 and
# 163.2 ms on an H100), so K1 is held within 3% of them
K1_VS_TWO_PASS = 1.03
# K1's stage device times (sketch, G, C) and K2's (sketch, G) by shape,
# printed before the kernels line
K1_STAGES: list[dict] = []
K2_STAGES: list[dict] = []


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def synced(fn, *args, **kwargs):
    """(result, seconds) of fn, between two device synchronizations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps: int = 3) -> float:
    """Mean device time of fn in ms, by CUDA events, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn in ms, by CUDA events, after one warm-up:
    the launches are queued behind a sleep of the card, so that it runs
    them back to back however long the host takes to issue each one (the
    sleep grows until the host is done before it ends)."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    while True:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()  # the card still sleeps: every launch is queued
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / reps
        check(cycles < 1 << 32, "device_ms: the host never got ahead of the card")
        cycles *= 4


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def phase_device() -> str:
    check(torch.cuda.is_available(), "CUDA is not available: this script needs a GPU")
    check((ROOT / "dmd_era5_tpu_torch").is_dir(), f"no dmd_era5_tpu_torch package beside {__file__}")
    smi = smi_line()
    # a float32 product on the card is full f32 (the JAX package's HIGHEST)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(f"[0] device {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | TF32 off, matmul precision highest")
    return smi


def phase_build() -> None:
    from dmd_era5_tpu_torch.ops import _build, atb, k2, matmul, qr_panel

    names = sorted({Path(src).stem for _, src, _ in (*KERNELS.values(), K2_CLUSTERS)})
    loaders = (matmul._kernel_library, matmul._project_library, matmul._matmul_library,
               qr_panel._kernel_library, qr_panel._householder_library, atb._library,
               k2._library)
    t0 = time.perf_counter()
    # each loader runs its own nvcc at first use; threads start them together
    with ThreadPoolExecutor(max_workers=len(loaders)) as pool:
        for fut in [pool.submit(f) for f in loaders]:
            fut.result()
    log(f"[1] built {', '.join(names)} in {time.perf_counter() - t0:.2f} s "
        "(nvcc, sm_90a, one process per source)")
    for name in names:
        # the log of this source's build (named by its hash), not another's
        # whose name extends it (sketch_center_gram_project)
        for path in sorted(_build.BUILD_DIR.glob(f"{name}_[0-9a-f]*.log")):
            for line in path.read_text().splitlines():
                if "Compiling entry" in line or "registers" in line or "spill" in line:
                    log(f"    ptxas {name}: {line.strip()}")


def launch_counts() -> dict:
    """The kernels' launch counts, by key of KERNELS."""
    from dmd_era5_tpu_torch.ops.launches import launch_counts as counts_now

    return counts_now()


def counts(**nonzero: int) -> dict:
    """Expected launch counts: the given ones, 0 for every other kernel."""
    return {key: nonzero.get(key, 0) for key in KERNELS}


def record_k2_routes() -> dict:
    """Add K2's launches by route since the counters were last reset (a
    main-path run's) into ``K2_ROUTES``, and return them
    (``ops.launches.route_counts``)."""
    from dmd_era5_tpu_torch.ops.launches import route_counts

    routes = route_counts()
    for key, n in routes.items():
        K2_ROUTES[key.split("/")[1]] += n
    return routes


def reset_counts() -> None:
    from dmd_era5_tpu_torch.ops.launches import reset_launch_counts

    reset_launch_counts()


@contextlib.contextmanager
def one_tf32_pass():
    """f32 library products in one TF32 pass inside, the flag restored: the
    control that a 3xTF32 kernel's accuracy limit must tell apart."""
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


# set inside ``emulated_tf32``: ``tf32_mm`` then emulates its pass
TF32_EMULATED = [False]


@contextlib.contextmanager
def emulated_tf32():
    """``tf32_mm`` emulates one TF32 pass inside, the setting restored."""
    saved = TF32_EMULATED[0]
    TF32_EMULATED[0] = True
    try:
        yield
    finally:
        TF32_EMULATED[0] = saved


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """t in f32 rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x0FFF + ((bits >> 13) & 1)) & -0x2000).view(torch.float32)


def tf32_exact(*tensors: torch.Tensor) -> bool:
    """Whether every tensor is exact in TF32 (bf16 values, signs): one
    TF32 pass of their product is then as exact as three, and no limit
    tells the two apart.  Read a row chunk at a time (the operands may
    be tens of GB), stopping at the first chunk with a low mantissa bit."""
    return all(bool(((c.float().contiguous().view(torch.int32) & 0x1FFF) == 0).all())
               for t in tensors for c in _chunks(t))


def tf32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass, the control that a 3xTF32 kernel's accuracy
    limit must tell apart: the library product with TF32 allowed, or
    inside ``emulated_tf32`` a and b rounded to TF32 and multiplied in
    full f32 (the library takes no TF32 path at some small or unaligned
    shapes: a 4,096 x 128 by 128 x 22 product of f32 reads as full f32)."""
    if TF32_EMULATED[0]:
        return tf32_round(a) @ tf32_round(b)
    with one_tf32_pass():
        return a @ b


def bound(flops: float, peak: float, nbytes: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    operations over the peak rate for their type and the bytes (each
    input read once, each output written once) over the HBM rate."""
    t_ops, t_mem = flops / peak, nbytes / HBM_BYTES_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def _chunk_rows(*arrays: torch.Tensor) -> int:
    """Rows per chunk: 2^19, fewer where an f64 copy of a chunk of the
    widest array would pass 1 GiB (the year's X is 8,760 wide)."""
    width = max([1, *(a.shape[1] for a in arrays if a.ndim == 2)])
    return max(1, min(1 << 19, GIB // (8 * width)))


def _chunks(a: torch.Tensor, rows: int | None = None):
    """Row chunks of a (a 0-d tensor as one chunk of one)."""
    a = a.reshape(1) if a.ndim == 0 else a
    rows = rows or _chunk_rows(a)
    return [a[r:r + rows] for r in range(0, a.shape[0], rows)]


def rel_err(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor | None = None
            ) -> tuple[float, float]:
    """(relative Frobenius error, max abs error) of a against b, in f64,
    over row chunks: an (M, N) f64 copy at ERA5 size would be 32 GB.
    The error is relative to |scale| where given, else to |b|."""
    num = den = max_abs = 0.0
    ref = b if scale is None else scale
    rows = _chunk_rows(a, b, ref)
    for ac, bc, sc in zip(_chunks(a, rows), _chunks(b, rows), _chunks(ref, rows)):
        diff = ac.double() - bc.double()
        num += float((diff * diff).sum())
        den += float(sc.double().square().sum())
        max_abs = max(max_abs, float(diff.abs().max()))
    return math.sqrt(num / max(den, 1e-300)), max_abs


def row_abs_sums(x: torch.Tensor) -> torch.Tensor:
    """sum_t |x[r, t]| per row, in f64, over row chunks."""
    return torch.cat([xc.double().abs().sum(dim=1) for xc in _chunks(x)])


def within_bf16_ulp(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Every entry of a within one bf16 ulp of b's (plus f32 roundoff
    slack where centring cancels), over row chunks.  The ulp of b is
    2^(floor(log2|b|) - 7), its exponent taken exactly (frexp): a
    floating log2 of a power of two may fall just below it."""
    top = float(b.abs().max())
    rows = _chunk_rows(a, b)
    for ac, bc in zip(_chunks(a, rows), _chunks(b, rows)):
        bd = bc.double()
        ulp = torch.exp2(torch.frexp(bd.abs().clamp_min(1e-30)).exponent.double() - 8)
        if not bool(((ac.double() - bd).abs() <= ulp + 2.0**-20 * top).all()):
            return False
    return True


def gram_f64(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """A^T B (B = A by default) in f64 over row chunks: the exact sums of
    the stored f32 matrices, against which the kernels are read."""
    b = a if b is None else b
    out = torch.zeros((a.shape[1], b.shape[1]), dtype=torch.float64, device=a.device)
    rows = _chunk_rows(a, b)
    for ac, bc in zip(_chunks(a, rows), _chunks(b, rows)):
        out += ac.double().T @ bc.double()
    return out


def compare_kernel(label, x, w, dtype, centred=False, f64_limit=1e-5, **flags) -> dict:
    """K1 against its plain version on the card, on the same x and w.

    Tolerances: f32 outputs relative Frobenius error <= 1e-5; bf16 Yc
    within one bf16 ulp; the f32 stats <= 1e-5.  G and C: the plain
    version sums them in f32, which over millions of rows is itself off
    by up to ~1e-5 of |G|, so both are also read against the f64 sums of
    the plain version's stored Yc.  The kernel must be within
    ``f64_limit`` (1e-5; tests/test_torch_cuda.py's 1e-6 where a small X
    lets one TF32 pass come within 1e-5) of those and within 1e-5 plus
    the plain version's own error of the plain version.  With ``centred`` (x's rows already have zero mean)
    each row sum cancels to roundoff in both versions, where a relative
    error means nothing; the row sums are then read against the sum of
    their terms' magnitudes, sum_t |x|, the scale of a sum's forward
    error bound (for scalar stats, against sum_r (sum_t |x|)^2), and
    held to the same 1e-5.  On f32 operands a control, one TF32 pass
    (the library products Yc^T Yc and Yc^T X of the plain version's Yc
    with TF32 allowed, the flag restored), must miss the 1e-5 that G and
    C meet against the f64 sums (``f64_limit``).  Times are CUDA-event ms; outputs are
    freed before timing, as at ERA5 size each Yc is up to 16 GB.  Each
    stage's device ms (sketch, G, C) is read alone on the same buffers
    and kept in ``K1_STAGES``.
    """
    from dmd_era5_tpu_torch.ops.matmul import (
        _sketch_center_gram_project_plain,
        sketch_center_gram_project,
    )

    def kernel():
        return sketch_center_gram_project(x, w, out_dtype=dtype, **flags)

    def plain():
        return _sketch_center_gram_project_plain(x, w, out_dtype=dtype, **flags)

    got = kernel()
    ref = plain()
    torch.cuda.synchronize()
    names = ("yc", "rowsum", "rowsumsq", "G", "C")
    errs, max_abs = {}, {}
    for name, a, b in zip(names, got, ref):
        if b is None:
            continue
        scale = None
        if centred and name == "rowsum":
            scale = row_abs_sums(x)
            if flags.get("scalar_stats"):
                scale = scale.square().sum()
        errs[name], max_abs[name] = rel_err(a, b, scale)
    exact = {"G": gram_f64(ref[0]), "C": gram_f64(ref[0], x)}
    err_exact = {f"{v}_{name}_vs_f64": rel_err(out, exact[name])[0]
                 for name in exact
                 for v, out in (("kernel", got[names.index(name)]),
                                ("plain", ref[names.index(name)]))}
    bf16 = dtype == torch.bfloat16
    if not bf16:
        one_pass = {"G": tf32_mm(ref[0].T, ref[0]), "C": tf32_mm(ref[0].T, x)}
        for name, out in one_pass.items():
            err_exact[f"one_tf32_pass_{name}_vs_f64"] = rel_err(out, exact[name])[0]
            check(err_exact[f"one_tf32_pass_{name}_vs_f64"] > f64_limit,
                  f"{label}: one TF32 pass reads {name} within {f64_limit} of the f64 sums: "
                  "the limit does not tell 3xTF32 from it")
        del one_pass
    if bf16:
        check(within_bf16_ulp(got[0], ref[0]), f"{label}: bf16 Yc beyond one ulp")
    for name, e in errs.items():
        if name in ("G", "C"):
            limit = 1e-5 + err_exact[f"plain_{name}_vs_f64"]
            e_k = err_exact[f"kernel_{name}_vs_f64"]
            check(e_k <= f64_limit,
                  f"{label}: {name} relative error vs f64 sums {e_k:.3e} > {f64_limit}")
        elif name == "yc" and bf16:
            continue  # held to one ulp above
        else:
            limit = 1e-5
        check(e <= limit, f"{label}: {name} relative error {e:.3e} > {limit:.3e}")
    del got, ref, exact
    # turns: plain, kernel, kernel, plain
    p1, k1, k2, p2 = event_ms(plain), event_ms(kernel), event_ms(kernel), event_ms(plain)
    m, t = x.shape
    n = w.shape[1]
    bound_ms, bound_by = k1_bound(m, t, n, x.dtype, flags.get("scalar_stats", False))
    res = dict(label=label, m=m, t=t, n=n, dtype=str(dtype).replace("torch.", ""),
               flags=flags, centred=centred, rel_err=errs, **err_exact, max_abs_err=max_abs,
               ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=bound_ms, bound_by=bound_by,
               stage_device_ms=k1_stage_ms(x, w, dtype, flags))
    K1_STAGES.append(dict(label=label, m=m, t=t, n=n, dtype=res["dtype"], **res["stage_device_ms"]))
    log(f"    {json.dumps(res)}")
    return res


def k1_bound(m: int, t: int, n: int, dtype: torch.dtype, scalar_stats: bool
             ) -> tuple[float, str]:
    """K1's bound on the tensor cores: X W (2 m n t), the symmetric half of
    Yc^T Yc (m n (n + 1)) and Yc^T X (2 m n t), three TF32 passes of each
    for f32 operands, one bf16 pass for bf16; X and W read, Yc, the
    statistics, G and C written."""
    bf16 = dtype == torch.bfloat16
    size = 2 if bf16 else 4
    stats = 2 if scalar_stats else 2 * m
    return bound((1 if bf16 else 3) * m * n * (4 * t + n + 1), PEAK_BF16 if bf16 else PEAK_TF32,
                 size * (m * t + t * n + m * n) + 4 * (stats + n * n + n * t))


def k1_stage_ms(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype, flags: dict,
                reps: int = 5, stages: int = 7) -> dict:
    """Device ms of each of K1's stages alone (``chip_smoke.device_ms``),
    each launched through the wrapper's plan on one set of buffers after
    one whole call has filled them; not counted as launches.  K2's two
    (sketch and G, on the route of ``ops/k2.py``'s table) with
    ``stages=3``."""
    from dmd_era5_tpu_torch.ops.matmul import _k2_plan, _scgp_plan

    args = {key: flags.get(key, default) for key, default in (
        ("center", True), ("stats_col", False), ("scalar_stats", False), ("t_valid", None),
        ("emit_yc", True))}
    if stages == 3:
        out, run, _ = _k2_plan(x, w, dtype, args["center"], args["t_valid"])
    else:
        out, run = _scgp_plan(x, w, dtype, **args, stages=stages)
    run(stages)
    times = {name: device_ms(lambda mask=mask: run(mask), reps)
             for name, mask in (("sketch", 1), ("G", 2), ("C", 4)) if stages & mask}
    del out, run
    return times


def phase_kernel_vs_plain(seed: int) -> None:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    log("[2] K1 against its plain version, smoke shapes (relative Frobenius errors; "
        "CUDA-event ms)")
    shapes = [(1 << 19, 512, 128, dt, dict(center=True, scalar_stats=True, stats_col=sc))
              for dt in (torch.float32, torch.bfloat16) for sc in (False, True)]
    shapes.append((1 << 20, T_HOURS, 256, torch.float32, dict(center=False)))
    for m, t, n, dtype, flags in shapes:
        x = torch.randn((m, t), generator=gen, device="cuda").to(dtype)
        w = torch.randn((t, n), generator=gen, device="cuda").to(dtype)
        compare_kernel("smoke", x, w, dtype, **flags)
        del x, w


def phase_kernel_at_path_shapes(x: torch.Tensor, seed: int) -> dict:
    """K1 against its plain version on the slice's own X, with the sketch
    widths and flags the main path gives it: the Hankel pass (stacked W,
    N = 256, no centring, f32) and the fit step (N = 128, centring, scalar
    stats, f32 and bf16).  Run after the main path's launch count is read."""
    from dmd_era5_tpu_torch.ops.hankel import stacked_sketch_matrix

    log(f"[5] K1 against its plain version on the ERA5-week X {tuple(x.shape)} "
        "(rows centred: row sums read against sum_t |x|)")
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    t = x.shape[1]
    omega = torch.randn((t - 1, 128), generator=gen, device=x.device)
    hankel = compare_kernel("hankel_pass", x, stacked_sketch_matrix(omega, 2, t),
                            torch.float32, centred=True, center=False)
    omega = torch.randn((t, 128), generator=gen, device=x.device)
    compare_kernel("fit_step", x, omega, torch.float32, centred=True,
                   center=True, scalar_stats=True)
    xb = x.to(torch.bfloat16)
    compare_kernel("fit_step", xb, omega.to(torch.bfloat16), torch.bfloat16,
                   centred=True, center=True, scalar_stats=True)
    del xb
    log(f"    peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return hankel


def make_era5_week(seed: int):
    """X (S, 168) f32 on the card: one week of hourly 0.25-degree ERA5."""
    return make_era5(seed, N_LAT, N_LON, 0.25, T_HOURS, PAIRS)


def make_era5_year(seed: int):
    """X (S, 8760) f32 on the card: one year of hourly 1-degree ERA5."""
    return make_era5(seed, YEAR_LAT, YEAR_LON, YEAR_DEG, YEAR_HOURS, YEAR_PAIRS)


def make_era5(seed: int, n_lat: int, n_lon: int, deg: float, t_hours: int, pairs):
    """X (S, T) f32 on the card, S = 15 n_lat n_lon: per row the mock
    temperature recipe's mean, (265 - lapse) cos(latitude), plus the
    planted damped pairs with random complex patterns, plus noise at 1%
    of the signal's rms.  Rows are drawn in chunks of at most 2^20 rows
    and 1 GiB."""
    dev = torch.device("cuda")
    s_rows = N_BLOCKS * n_lat * n_lon
    chunk = min(CHUNK, max(1, GIB // (4 * t_hours)))
    gen = torch.Generator(device=dev).manual_seed(seed)
    hours = torch.arange(t_hours, dtype=torch.float64, device=dev)
    alpha = torch.tensor([complex(d, 2 * math.pi / p) for d, p, _ in pairs],
                         dtype=torch.complex128, device=dev)
    amps = torch.tensor([a for *_, a in pairs], dtype=torch.float64, device=dev)

    def dynamics(h):
        return (amps[:, None] * torch.exp(alpha[:, None] * h[None, :])).to(torch.complex64)

    dyn = dynamics(hours)
    # Re(c e) with Re c, Im c ~ N(0, 1) has variance |e|^2
    signal_rms = float(torch.sqrt((dyn.abs() ** 2).sum(0).mean()))
    noise_std = NOISE_FRACTION * signal_rms
    x = torch.empty((s_rows, t_hours), dtype=torch.float32, device=dev)
    patterns = torch.empty((s_rows, len(pairs)), dtype=torch.complex64, device=dev)
    row_mean = torch.empty(s_rows, dtype=torch.float32, device=dev)
    levels = torch.tensor(LEVELS, dtype=torch.float32, device=dev)
    for r0 in range(0, s_rows, chunk):
        r1 = min(r0 + chunk, s_rows)
        rows = torch.arange(r0, r1, device=dev)
        lapse = (1000.0 - levels[(rows // (n_lat * n_lon)) % len(LEVELS)]) / 100.0
        lat = 90.0 - deg * ((rows // n_lon) % n_lat).float()
        row_mean[r0:r1] = (265.0 - lapse) * torch.cos(torch.deg2rad(lat))
        c = torch.complex(
            torch.randn((r1 - r0, len(pairs)), generator=gen, device=dev),
            torch.randn((r1 - r0, len(pairs)), generator=gen, device=dev),
        )
        patterns[r0:r1] = c
        x[r0:r1] = (
            row_mean[r0:r1, None]
            + c.real @ dyn.real - c.imag @ dyn.imag
            + noise_std * torch.randn((r1 - r0, t_hours), generator=gen, device=dev)
        )

    def truth(h):
        """Noise-free field (rows' mean plus planted signal) at hours h."""
        d = dynamics(h)
        return row_mean[:, None] + patterns.real @ d.real - patterns.imag @ d.imag

    planted = torch.cat([alpha, alpha.conj()]).to(torch.complex64)  # 6 eigenvalues
    return x, truth, row_mean, planted, noise_std


def matched_eig_error(found: torch.Tensor, true: torch.Tensor) -> float:
    """Greedy nearest matching of eigenvalue sets (tests/test_05_dmd.py)."""
    left = list(found.cpu().numpy())
    err = 0.0
    for tv in true.cpu().numpy():
        d = [abs(f - tv) for f in left]
        i = min(range(len(d)), key=d.__getitem__)
        err = max(err, float(d[i]))
        left.pop(i)
    return err


def dmd_and_forecast(label: str, svd, week: dict, times: dict, d: int = 2) -> None:
    """optDMD (rank 6) on a Hankel SVD and a 24-step forecast past the
    window, held to the planted eigenvalues and the noise-free signal."""
    from dmd_era5_tpu_torch.models import optdmd_from_svd, rollout, undo_preprocessing

    rank, steps = 6, 24
    u, s, v = svd
    t_fit = torch.arange(v.shape[1], dtype=torch.float32, device=u.device)
    opt, times["optdmd"] = synced(optdmd_from_svd, u, s, v, t_fit, rank=rank)
    eig_err = matched_eig_error(opt.alpha, week["alpha_true"])
    log(f"    {label} optDMD: {opt.n_iters} LM steps, residual {float(opt.residual):.3e}, "
        f"alpha {[complex(round(a.real, 5), round(a.imag, 5)) for a in opt.alpha.cpu().tolist()]}, "
        f"matched error vs planted {eig_err:.2e}")
    check(len(week["alpha_true"]) == rank and eig_err < 1e-2,
          f"{label}: planted eigenvalues not recovered: matched error {eig_err:.3e}")

    # 24 hours past the window; embedded time i is hour i + d - 1
    t_fut = torch.arange(v.shape[1], v.shape[1] + steps, dtype=torch.float32, device=u.device)

    def forecast():
        return undo_preprocessing(rollout(opt, t_fut), week["mean"].repeat(d), None, delay=d)

    fc, times["forecast"] = synced(forecast)
    s_rows = week["x"].shape[0]
    check(fc.shape == (s_rows, steps), f"{label}: forecast shape {tuple(fc.shape)}")
    check(bool(torch.isfinite(fc).all()), f"{label}: forecast has non-finite values")
    ref = week["truth"](t_fut.double() + d - 1)
    fc_err = float((fc - ref).norm() / (ref - week["row_mean"][:, None]).norm())
    log(f"    {label} forecast {tuple(fc.shape)}: relative error of the anomaly vs the "
        f"noise-free planted signal {fc_err:.3e}")
    check(fc_err < 5e-2, f"{label}: forecast relative error {fc_err:.3e} >= 5e-2")


def phase_slice(seed: int) -> dict:
    """Phase 3.  Returns the week: the centred X, its row means, the
    noise-free truth, the planted eigenvalues and the randomized s."""
    from dmd_era5_tpu_torch.ops import hankel_randomized_svd_fused
    from dmd_era5_tpu_torch.snapmat import standardize_data

    d, k = 2, 100
    torch.cuda.reset_peak_memory_stats()
    (x, truth, row_mean, alpha_true, noise_std), t_gen = synced(make_era5_week, seed)
    log(f"[3] ERA5 week X {tuple(x.shape)} f32 ({x.numel() * 4 / 1e9:.2f} GB) generated "
        f"in {t_gen:.2f} s; noise std {noise_std:.4f}")
    times = {"generate": t_gen}

    (x, mean, _), times["center"] = synced(standardize_data, x, scale=False)
    week = dict(x=x, mean=mean, truth=truth, row_mean=row_mean, alpha_true=alpha_true)
    before = launch_counts()["K1"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    svd, times["hankel_svd"] = synced(
        hankel_randomized_svd_fused, x, d, k, generator=gen, gemm_dtype=torch.float32
    )
    svd_launches = launch_counts()["K1"] - before
    check(svd_launches == 5, f"Hankel SVD launched K1 {svd_launches} times, expected 5")
    u, s, v = svd
    gram = u.T @ u
    orth = float((gram - torch.eye(k, device=u.device)).abs().max())
    check(orth <= 1e-3, f"U^T U - I max {orth:.3e} > 1e-3")
    check(bool((s > 0).all()) and bool((s[1:] <= s[:-1]).all()), "s not positive descending")
    log(f"    SVD: U {tuple(u.shape)}, max|U^T U - I| {orth:.2e}, s[:8] "
        f"{[round(float(a), 2) for a in s[:8]]}, K1 launches {svd_launches}")
    dmd_and_forecast("randomized", svd, week, times, d)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"    stage wall times (s): {json.dumps({a: round(b, 3) for a, b in times.items()})}; "
        f"peak device memory {peak:.2f} GB")
    week["s_rand"] = s.clone()
    week["u6_rand"], week["orth_rand"] = u[:, :6].clone(), orthonormality(u)  # 18's references
    del u, s, v, svd, gram
    return week


def phase_fit_step(x: torch.Tensor, seed: int) -> None:
    from dmd_era5_tpu_torch.pipeline import fit_step_fused

    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    omega = torch.randn((x.shape[1], 128), generator=gen, device=x.device)
    for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 1e-2)):
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()["K1"]
        state, secs = synced(fit_step_fused, x, omega, 100, gemm_dtype=dtype)
        launches = launch_counts()["K1"] - before
        check(launches == 1, f"fit step launched K1 {launches} times, expected 1")
        check(bool(torch.isfinite(state.loss)), "fit step loss not finite")
        # the leading components are the planted rank; the other 94 sit at
        # the noise floor (cond(G) ~ 2e7), held to the JAX tests' bound for
        # all components of a bf16 fit (tests/test_07_train_step.py:212)
        gram = state.u.float().T @ state.u.float()
        dev = (gram - torch.eye(gram.shape[0], device=x.device)).abs()
        lead = len(PAIRS) * 2
        orth = float(dev[:lead, :lead].max())
        check(orth <= tol, f"{dtype} fit step: leading U^T U - I max {orth:.3e} > {tol}")
        check(float(dev.max()) <= 1.5e-1, f"{dtype} fit step: U^T U - I max {float(dev.max()):.3e}")
        log(f"[4] fit_step_fused {str(dtype)[6:]}: {secs:.3f} s, loss {float(state.loss):.4e}, "
            f"s[:8] {[round(float(a), 2) for a in state.s[:8]]}, max|U^T U - I| leading "
            f"{lead} {orth:.2e} (all 100: {float(dev.max()):.2e}), K1 launches {launches}, "
            f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del state


def compare_gram(label: str, a: torch.Tensor, precision: str, exact: torch.Tensor | None = None,
                 reps: int = 3) -> dict:
    """K4 or K5 against its plain version and the f64 sums of A^T A.

    Tolerances: ``"highest"`` within 1e-6 relative Frobenius error of the
    f64 sums, which on f32 A one TF32 pass (the library product with TF32
    allowed, the control) must miss; ``"bf16_split"`` within
    3e-5 max|G| of them (tests/test_25_linalg.py:102: the split drops
    L^T L and rounds L to bf16, ~1e-6 relative), read beside one bf16
    pass (bf16(A)^T bf16(A) summed in f64, the control): its rounding
    errors are unbiased and may average out below the limit over
    millions of rows, so where it does the control is logged and not
    held (tests/test_torch_cuda.py holds it on data built to miss).  Two
    calls must give G bit for bit.  Against the plain
    version, whose f32 library sums over millions of rows are off by up
    to ~1e-5 themselves: within the kernel's own limit plus the plain
    version's error.  G must be exactly symmetric.  Times are CUDA-event
    ms in turns plain, kernel, kernel, plain; the library call is one f32
    ``a.T @ a`` (TF32 off), which the port never makes.  With ``exact``
    given (the f64 sums, formed by the caller) there is no plain version:
    at the year its f32 copies of H and L (2 x 34 GB) do not fit beside
    A, and ``plain_ms`` is None."""
    from dmd_era5_tpu_torch.ops.qr_panel import _gram_plain, gram

    def kernel():
        return gram(a, precision)

    def plain():
        return _gram_plain(a, precision)

    def library():
        return a.T @ a

    with_plain = exact is None
    exact = gram_f64(a) if exact is None else exact
    got = kernel()
    again = kernel()
    torch.cuda.synchronize()
    check(torch.equal(got, got.T), f"{label} {precision}: G not exactly symmetric")
    check(torch.equal(got, again), f"{label} {precision}: two calls differ")
    del again
    scale = float(exact.abs().max())
    res = dict(label=label, precision=precision, m=a.shape[0], k=a.shape[1])
    res["kernel_rel_vs_f64"] = rel_err(got, exact)[0]
    res["kernel_max_abs_vs_f64_over_max"] = float((got.double() - exact).abs().max()) / scale
    if with_plain:
        ref = plain()
        res["plain_rel_vs_f64"] = rel_err(ref, exact)[0]
        res["plain_max_abs_vs_f64_over_max"] = float((ref.double() - exact).abs().max()) / scale
        res["rel_vs_plain"], res["max_abs_err"] = rel_err(got, ref)
        del ref
    else:
        res["max_abs_err"] = float((got.double() - exact).abs().max())
    if precision == "highest":
        limit = 1e-6
        check(res["kernel_rel_vs_f64"] <= limit,
              f"{label} K4: G relative error vs f64 {res['kernel_rel_vs_f64']:.3e} > {limit}")
        if a.dtype == torch.float32 and tf32_exact(a):
            res["one_tf32_pass_rel_vs_f64"] = None  # nothing to tell apart
        elif a.dtype == torch.float32:
            res["one_tf32_pass_rel_vs_f64"] = rel_err(tf32_mm(a.T, a), exact)[0]
            check(res["one_tf32_pass_rel_vs_f64"] > limit,
                  f"{label} K4: one TF32 pass reads {res['one_tf32_pass_rel_vs_f64']:.3e}, within "
                  f"{limit}: the limit does not tell 3xTF32 from it")
    else:
        limit = 3e-5
        check(res["kernel_max_abs_vs_f64_over_max"] <= limit,
              f"{label} K5: G max error vs f64 {res['kernel_max_abs_vs_f64_over_max']:.3e} "
              f"max|G| > {limit}")
        ctrl = torch.zeros_like(exact)
        for ac in _chunks(a):
            h = ac.bfloat16().double()
            ctrl += h.T @ h
        res["one_bf16_pass_max_abs_vs_f64_over_max"] = float((ctrl - exact).abs().max()) / scale
        del ctrl, h
        if res["one_bf16_pass_max_abs_vs_f64_over_max"] <= limit:
            log(f"    {label} K5: one bf16 pass reads "
                f"{res['one_bf16_pass_max_abs_vs_f64_over_max']:.3e} max|G|, within {limit} on "
                "this data (unbiased roundings average out): not held here")
    if with_plain:
        if precision == "highest":
            limit_plain = limit + res["plain_rel_vs_f64"]
            got_plain = res["rel_vs_plain"]
        else:
            limit_plain = limit + res["plain_max_abs_vs_f64_over_max"]
            got_plain = res["max_abs_err"] / scale
        check(got_plain <= limit_plain,
              f"{label} {precision}: kernel vs plain {got_plain:.3e} > {limit_plain:.3e}")
    del got, exact
    if with_plain:
        p1, k1, k2, p2 = (event_ms(f, reps) for f in (plain, kernel, kernel, plain))
        res.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2)
    else:
        res.update(ms=event_ms(kernel, reps), plain_ms=None)
    res["library_ms"] = event_ms(library, reps)
    m, k = a.shape
    size = a.element_size()
    if precision == "highest":  # the symmetric half: 3xTF32 on f32 A, one bf16 pass on bf16 A
        bf16 = a.dtype == torch.bfloat16
        res["bound_ms"], res["bound_by"] = bound(
            (1 if bf16 else 3) * m * k * (k + 1), PEAK_BF16 if bf16 else PEAK_TF32,
            size * m * k + 4 * k * k)
    else:  # H^T H (symmetric half) and H^T L, both bf16 products
        res["bound_ms"], res["bound_by"] = bound(
            m * k * (k + 1) + 2 * m * k * k, PEAK_BF16, size * m * k + 4 * k * k)
    log(f"    {json.dumps(res)}")
    return res


def k4_route(a: torch.Tensor) -> dict:
    """How K4 (``csrc/atb.cu``) takes a: its mainloop and block
    (``ops/atb.py::gram_block``), A's copy path as the library picks it
    (``atb.copy_modes``: the blocks' rows by one bulk copy a slab, TMA
    boxes or element by element; "registers" for the row-share mainloop,
    whose loads are staged through them) and its row shares (one: one
    launch, no scratch)."""
    from dmd_era5_tpu_torch.ops import atb

    m, k = a.shape
    block = atb.gram_block(k, a.dtype, m)
    copy = "registers" if block.mainloop == "row_share" else atb.copy_modes(a, block)[0]
    return dict(mainloop=block.mainloop, n=block.n, sums=block.sums, blocks=block.blocks,
                copy=copy, row_shares=atb.row_shares(a, block))


def phase_gram_vs_plain(x: torch.Tensor, seed: int) -> dict:
    """Phase 6: K4 and K5 on the centred ERA5-week X and on an f32 sketch
    Y = X Omega (S x 110, the randomized route's panel); then K4's three
    routes on its mainloop held by name: X's rows by TMA, the rows of X's
    first 82 columns (328 bytes, not 16-byte aligned: 14c's window) by a
    bulk copy a slab on 2^20 rows, and the one-launch route of one row
    share at 19c's and 19d's DMDc shapes (X's first 34 x 166, its
    664-byte rows by one bulk copy of a slab's whole rows, and 6 x 95).
    Y goes to the row-share mainloop by the table."""
    log(f"[6] K4 and K5 against their plain versions and the f64 sums, on X {tuple(x.shape)} "
        "and its sketch Y (S x 110)")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    y = x @ torch.randn((x.shape[1], 110), generator=gen, device=x.device)
    out = {(name, p): compare_gram(name, a, p)
           for name, a in (("X", x), ("Y", y)) for p in ("highest", "bf16_split")}
    small = {"34x166": x[:34, :166].contiguous(), "6x95": x[:6, :95].contiguous()}
    panels = {"82": x[: 1 << 20, :82].contiguous(), **small}
    for name, a in panels.items():
        out[(name, "highest")] = compare_gram(f"X {name}", a, "highest", reps=20)
    routes = {"X": k4_route(x), "Y": k4_route(y), **{name: k4_route(a) for name, a in panels.items()}}
    new = [routes[name] for name in ("X", "82", *small)]
    check(all(r["mainloop"] == "atb_wgmma" for r in new) and routes["X"]["copy"] == "tma"
          and routes["82"]["copy"] == "bulk" and routes["82"]["row_shares"] > 1
          and routes["34x166"]["copy"] == "bulk"
          and all(routes[name]["row_shares"] == 1 for name in small),
          f"[6] K4's routes are not TMA (X), bulk (82 columns; 34 x 166's whole rows) and one "
          f"launch (34 x 166, 6 x 95) on its mainloop: {routes}")
    log(f"    K4 routes (mainloop, block n, f64 sums, blocks a share, copy path, row shares): "
        f"{json.dumps(routes)}")
    del y, small, panels
    log(f"    peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return out


def orthonormality(u: torch.Tensor) -> float:
    """max |U^T U - I|, U^T U summed in f64."""
    g = gram_f64(u)
    return float((g - torch.eye(g.shape[0], dtype=g.dtype, device=g.device)).abs().max())


def subspace_cos_min(u1: torch.Tensor, u2: torch.Tensor) -> float:
    """Cosine of the largest principal angle between span(U1) and
    span(U2): the least singular value of Q1^T Q2 with Q_i = U_i L_i^-T
    orthonormal (L_i L_i^T = U_i^T U_i, all in f64), so the columns'
    own f32 departure from orthonormality does not count as an angle."""
    l1 = torch.linalg.cholesky(gram_f64(u1))
    l2 = torch.linalg.cholesky(gram_f64(u2))
    m = torch.linalg.solve_triangular(l1, gram_f64(u1, u2), upper=False)
    m = torch.linalg.solve_triangular(l2, m.T, upper=False).T
    return float(torch.linalg.svdvals(m).min())


def check_interlace(label: str, s_rand: torch.Tensor, s_exact: torch.Tensor,
                    n_lead: int = 6) -> dict:
    """Rayleigh-Ritz values of a sketched subspace stay below the exact
    singular values: s_rand <= s_exact (1 + 1e-4); the leading ``n_lead``
    (the planted 6, and an uncentred X's mean before them), well above
    the noise floor, agree to 1e-4."""
    ratio = (s_rand.double().cpu() / s_exact.double().cpu())
    lead = float((ratio[:n_lead] - 1).abs().max())
    check(float(ratio.max()) <= 1 + 1e-4,
          f"{label}: randomized s above exact s, max ratio {float(ratio.max()):.8f}")
    check(lead <= 1e-4, f"{label}: leading {n_lead} singular values differ by {lead:.3e} > 1e-4")
    return {"max_ratio": float(ratio.max()), "at": int(ratio.argmax()),
            "min_ratio": float(ratio.min()), f"lead{n_lead}_rel": lead}


def phase_standard(week: dict) -> dict:
    """Phase 7: the svd_type = standard path, exact Hankel SVD (d = 2,
    k = 100; K5 once, K1 once) -> optDMD -> forecast."""
    from dmd_era5_tpu_torch.ops import hankel_exact_svd

    d, k = 2, 100
    x = week["x"]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = {}
    svd, times["hankel_exact_svd"] = synced(hankel_exact_svd, x, d, k)
    u, s, v = svd
    orth = orthonormality(u)
    check(orth <= 1e-3, f"exact Hankel SVD: U^T U - I max {orth:.3e} > 1e-3")
    check(bool((s > 0).all()) and bool((s[1:] <= s[:-1]).all()), "s not positive descending")
    log(f"[7] exact Hankel SVD: U {tuple(u.shape)}, max|U^T U - I| {orth:.2e}, s[:8] "
        f"{[round(float(a), 2) for a in s[:8]]}")
    inter = check_interlace("phase 3 vs exact Hankel", week["s_rand"], s)
    log(f"    randomized s (phase 3) / exact s: {json.dumps(inter)}")
    dmd_and_forecast("standard", svd, week, times, d)
    week["s_exact"] = s.clone()  # phase 12 holds the SVD stage's s below these
    week["u6_exact"], week["orth_exact"] = u[:, :6].clone(), orth  # 18's references
    launches = launch_counts()
    check(launches == counts(K1=1, K5=1),
          f"standard path launches {launches}, expected K1 1, K5 1, no other")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"    stage wall times (s): {json.dumps({a: round(b, 3) for a, b in times.items()})}; "
        f"launches {launches}; peak device memory {peak:.2f} GB")
    del u, s, v, svd
    return launches


def phase_truncated(x: torch.Tensor, seed: int) -> tuple[dict, dict]:
    """Phase 8: truncated_svd at d = 1 by its four routes, each a main-path
    run of its own with exact launch counts; U orthonormal to 1e-3; the
    three exact routes held to one another (s: leading 6 to 1e-5, all 100
    to 2e-3, the tolerance of tests/test_03_svd.py:158,182; leading-6
    subspaces to 1 - 1e-6) and the randomized s below the exact s.

    The TSQR route (c) is the exception, a known fault of the reference
    (ROADMAP Queue 3).  Row centring makes X 1 = 0, so X is
    rank-deficient: outside the range of the split CholQR2 leaf, the JAX
    package's accelerator default (dmd_era5_tpu/ops/qr_panel.py:200-202:
    cond(X) well below 1/sqrt(eps_f32)).  Q's null column leaves the
    second Gram pass nearly singular, which amplifies the split Gram's
    ~1e-6 error in every direction (the JAX leaf does the same).  The
    leaf is kept, and (c) is held to a bracket around its own readings,
    ``TSQR_CENTRED_FAULT``, so that a fix and a further loss both fail
    the run; its readings are logged above the checks.

    Returns the launch counts and route (b)'s s and leading 6 columns of
    U, against which phase 9 holds the streamed routes."""
    from dmd_era5_tpu_torch.ops import truncated_svd

    k = 100
    routes = [
        ("a gram bf16_split", dict(svd_type="standard"), counts(K1=1, K5=1)),
        ("b gram highest", dict(svd_type="standard", gram_precision="highest"),
         counts(K1=1, K4=1)),
        ("c tsqr", dict(svd_type="standard", exact_method="tsqr"), counts(K5=2)),
        ("d randomized", dict(svd_type="randomized", seed=seed + 5), counts(K5=10)),
    ]
    total = dict.fromkeys(KERNELS, 0)
    s_of, lead_u, orth_of = {}, {}, {}
    for label, kwargs, expect in routes:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        (u, s, v), secs = synced(truncated_svd, x, k, **kwargs)
        launches = launch_counts()
        check(launches == expect, f"truncated_svd {label}: launches {launches}, expected {expect}")
        for key, n in launches.items():
            total[key] += n
        check(u.shape == (x.shape[0], k) and v.shape == (k, x.shape[1]),
              f"truncated_svd {label}: shapes {tuple(u.shape)}, {tuple(v.shape)}")
        orth_of[label] = orthonormality(u)
        s_of[label] = s.clone()
        if not label.startswith("d"):
            lead_u[label] = u[:, :6].clone()
        log(f"[8] truncated_svd {label}: {secs:.3f} s, max|U^T U - I| {orth_of[label]:.2e}, "
            f"s[:8] {[round(float(a), 2) for a in s[:8]]}, s[-1] {float(s[-1]):.3f}, launches "
            f"{launches}, peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del u, s, v
    # every route's readings are logged above before any is held to its limits
    exact = [label for label, *_ in routes if not label.startswith("d")]
    ref = exact[0]
    pairs = {}
    for other in exact[1:]:
        rel = (s_of[other].double() / s_of[ref].double() - 1).abs()
        pairs[other] = (float(rel[:6].max()), float(rel.max()),
                        subspace_cos_min(lead_u[ref], lead_u[other]))
        log(f"    {other} vs {ref}: s rel diff leading 6 {pairs[other][0]:.2e}, all 100 "
            f"{pairs[other][1]:.2e}; leading-6 subspace cos min 1 - {1 - pairs[other][2]:.2e}")
    rand = routes[3][0]
    tsqr_route = routes[2][0]
    fault = "known fault, split CholQR2 leaf on row-centred X (ROADMAP Queue 3)"
    for label, orth in orth_of.items():
        s = s_of[label]
        if label == tsqr_route:
            lo, hi = TSQR_CENTRED_FAULT["orth"]
            check(lo < orth <= hi, f"truncated_svd {label}: {fault}: U^T U - I max {orth:.3e} "
                  f"outside ({lo}, {hi}]: the fault is fixed or worse")
        else:
            check(orth <= 1e-3, f"truncated_svd {label}: U^T U - I max {orth:.3e} > 1e-3")
        check(bool((s > 0).all()) and bool((s[1:] <= s[:-1]).all()),
              f"truncated_svd {label}: s not positive descending")
    for other, (lead, every, cos) in pairs.items():
        limit = 1e-5
        if other == tsqr_route:
            limit = TSQR_CENTRED_FAULT["lead6"]
            other = f"{other} ({fault})"
        check(lead <= limit, f"{other} vs {ref}: leading 6 s differ by {lead:.3e} > {limit}")
        check(every <= 2e-3, f"{other} vs {ref}: s differ by {every:.3e} > 2e-3")
        check(cos > 1 - 1e-6, f"{other} vs {ref}: leading-6 subspaces cos min {cos:.9f}")
    log(f"    randomized s / exact s ({ref}): "
        f"{json.dumps(check_interlace('randomized vs exact', s_of[rand], s_of[ref]))}")
    ref_b = routes[1][0]
    # phase 18 holds the meshed routes to (a), (c) and (d): (s, U^T U - I)
    mesh_refs = {name: (s_of[label].cpu(), orth_of[label]) for name, label in
                 (("gram", routes[0][0]), ("tsqr", tsqr_route), ("randomized", rand))}
    return total, {"s": s_of[ref_b], "u6": lead_u[ref_b], "routes": mesh_refs}


def compare_matmul(label: str, x: torch.Tensor, w: torch.Tensor, f64_gate: bool) -> dict:
    """K6 against its plain version, the f64 product and the library on
    the card, on the same x and w.

    Tolerances: relative Frobenius error <= 1e-5 of the plain version's
    out -- both sum f32-faithful products (3xTF32 against full f32; bf16
    x bf16 is exact in f32) over K = 168 terms, in another order.  Against
    the f64 product of the stored operands (max error over max|out|): where
    ``f64_gate`` (f32 operands: the streamed block and the ragged tail),
    K6's at most ``K6_F64_FACTOR`` times the plain f32 product's in this
    run, and a control, one TF32 pass (``torch.mm`` with TF32 allowed, the
    flag restored), above that limit, so that it tells 3xTF32 from one
    pass.  Times: ``ms`` is the wrapper's, calls issued back to back
    (CUDA events), ``device_ms`` the kernel's alone (``device_ms``: its
    launches queued behind a sleep of the card), and the same pair for
    the library call.  Library call: one ``torch.mm`` in f32 (TF32 off), or for bf16 operands
    ``torch.mm(..., out_dtype=torch.float32)`` where the installed torch has
    it (else none); the port never makes it.  Bound: 3xTF32, three
    tensor-core passes of 2MKN, for f32 operands; one bf16 pass for bf16."""
    from dmd_era5_tpu_torch.ops.matmul import _matmul_plain, matmul

    def kernel():
        return matmul(x, w)

    def plain():
        return _matmul_plain(x, w, torch.float32)

    bf16 = x.dtype == torch.bfloat16

    def library():
        return torch.mm(x, w, out_dtype=torch.float32) if bf16 else torch.mm(x, w)

    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    rel, max_abs = rel_err(got, ref)
    check(rel <= 1e-5, f"{label}: K6 relative error {rel:.3e} > 1e-5")
    w64 = w.double()
    rows = _chunk_rows(x, ref)  # the f64 product a row chunk at a time
    scale = max(float((xc.double() @ w64).abs().max()) for xc in _chunks(x, rows))

    def vs_f64(out: torch.Tensor) -> float:
        return max(float((oc.double() - xc.double() @ w64).abs().max())
                   for oc, xc in zip(_chunks(out, rows), _chunks(x, rows))) / scale

    (m, k), n = x.shape, w.shape[1]
    res = dict(label=label, m=m, k=k, n=n, dtype=str(x.dtype)[6:], rel_err=rel,
               max_abs_err=max_abs, kernel_vs_f64_over_max=vs_f64(got),
               plain_vs_f64_over_max=vs_f64(ref))
    del got, ref
    if f64_gate:
        control = not tf32_exact(x, w)  # else nothing to tell apart
        res["one_tf32_pass_vs_f64_over_max"] = vs_f64(tf32_mm(x, w)) if control else None
        limit = K6_F64_FACTOR * res["plain_vs_f64_over_max"]
        check(res["kernel_vs_f64_over_max"] <= limit,
              f"{label} K6: out vs f64 {res['kernel_vs_f64_over_max']:.3e} max|out| > "
              f"{K6_F64_FACTOR} x the plain f32 product's ({limit:.3e})")
        check(not control or res["one_tf32_pass_vs_f64_over_max"] > limit,
              f"{label} K6: one TF32 pass reads {res['one_tf32_pass_vs_f64_over_max']:.3e} "
              f"max|out|, within {limit:.3e}: the limit does not tell 3xTF32 from it")
    try:
        library()
    except (RuntimeError, TypeError, NotImplementedError):
        library_ms = library_device_ms = None
    else:
        library_ms, library_device_ms = event_ms(library, reps=20), device_ms(library)
    p1, k1, k2, p2 = (event_ms(f, reps=20) for f in (plain, kernel, kernel, plain))
    size = x.element_size()
    bound_ms, bound_by = bound((1 if bf16 else 3) * 2 * m * k * n, PEAK_BF16 if bf16 else PEAK_TF32,
                               size * (m * k + k * n) + 4 * m * n)
    res.update(ms=(k1 + k2) / 2, device_ms=device_ms(kernel), plain_ms=(p1 + p2) / 2,
               library_ms=library_ms, library_device_ms=library_device_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    log(f"    {json.dumps(res)}")
    for key in ("ms", "device_ms"):
        check(res[key] >= bound_ms, f"{label} K6: {key} {res[key]:.4f} below its bound {bound_ms:.4f}")
    return res


def library_device_ms(fn) -> float | None:
    """``device_ms`` of a library call, or None where the call waits for
    the card itself, so that the host never gets ahead of it."""
    try:
        return device_ms(fn)
    except AssertionError:
        return None


def compare_householder(label: str, a: torch.Tensor, gate_q: bool = True) -> dict:
    """K7 against its plain version (the same column sweep in torch ops)
    and the library QR on the card.

    Tolerances: R's entries within 1e-5 of max|R| of the plain version's
    (the same arithmetic summed in another order); max|Q^T Q - I| <= 1e-4
    (tests/test_08_kernels.py:255) and |QR - A| / |A| <= 1e-5 (backward
    stability).  Where ``gate_q`` (a Gaussian panel, cond < 10) Q within
    5e-5 of the plain version's in relative Frobenius norm; not on an
    ill-conditioned panel, whose trailing columns of Q the two orders of
    summation may turn apart within the orthogonality gate.  Library
    call: ``torch.linalg.qr`` with the diag(R) >= 0 flip; its
    orthogonality and reconstruction are logged beside the kernel's.
    Times: ``ms`` the wrapper's, calls back to back (CUDA events);
    ``device_ms`` the kernel's alone (its launches queued behind a sleep
    of the card), the same pair for the library; ``ctas`` the CTAs the
    wrapper chose."""
    from dmd_era5_tpu_torch.ops.qr_panel import (
        _householder_limits, _householder_plain, householder_panel, householder_shares)
    from dmd_era5_tpu_torch.ops.tsqr import qr_positive

    def kernel():
        return householder_panel(a)

    def plain():
        q, r = _householder_plain(a)
        signs = torch.where(torch.diagonal(r) < 0, -1.0, 1.0)
        return q * signs, r * signs[:, None]

    def library():
        return qr_positive(a)

    (q, r), (q_p, r_p), (q_l, r_l) = kernel(), plain(), library()
    torch.cuda.synchronize()
    m, n = a.shape
    eye = torch.eye(n, dtype=torch.float64, device=a.device)
    a64 = a.double()
    res = dict(label=label, m=m, n=n,
               ctas=len(householder_shares(m, n, *_householder_limits(a.device))))
    for who, qq, rr in (("kernel", q, r), ("plain", q_p, r_p), ("library", q_l, r_l)):
        res[f"{who}_orth"] = float((qq.double().T @ qq.double() - eye).abs().max())
        res[f"{who}_recon"] = float((qq.double() @ rr.double() - a64).norm() / a64.norm())
    r_err = float((r - r_p).abs().max()) / float(r_p.abs().max())
    q_rel = float((q.double() - q_p.double()).norm() / q_p.double().norm())
    res.update(r_max_abs_over_max=r_err, q_rel=q_rel,
               max_abs_err=max(float((q - q_p).abs().max()), float((r - r_p).abs().max())))
    check(res["kernel_orth"] <= 1e-4, f"{label}: K7 Q^T Q - I max {res['kernel_orth']:.3e} > 1e-4")
    check(res["kernel_recon"] <= 1e-5, f"{label}: K7 |QR - A|/|A| {res['kernel_recon']:.3e} > 1e-5")
    check(r_err <= 1e-5, f"{label}: K7 R vs plain {r_err:.3e} of max|R| > 1e-5")
    if gate_q:
        check(q_rel <= 5e-5, f"{label}: K7 Q vs plain relative {q_rel:.3e} > 5e-5")
    del q, r, q_p, r_p, q_l, r_l
    p1, k1, k2, p2 = (event_ms(f, reps=r) for f, r in ((plain, 3), (kernel, 20), (kernel, 20), (plain, 3)))
    # Householder QR with Q formed: 4 m n^2 - 4 n^3 / 3 flops in f32; A
    # read once, Q and R written once
    bound_ms, bound_by = bound(4 * m * n * n - 4 * n**3 / 3, PEAK_F32, 4 * (2 * m * n + n * n))
    res.update(ms=(k1 + k2) / 2, device_ms=device_ms(kernel), plain_ms=(p1 + p2) / 2,
               library_ms=event_ms(library, reps=20), library_device_ms=library_device_ms(library),
               bound_ms=bound_ms, bound_by=bound_by)
    log(f"    {json.dumps(res)}")
    for key in ("ms", "device_ms"):
        check(res[key] >= bound_ms, f"{label} K7: {key} {res[key]:.4f} below its bound {bound_ms:.4f}")
    return res


def phase_streamed_kernels(x: torch.Tensor, seed: int) -> dict:
    """Phase 9a: K6 on the first and the ragged last row block of X with a
    (168, 110) orthonormal iterate, in f32 and with bf16 operands; K7 on
    the iterate's (168, 110) shape and its envelope's two edges."""
    from dmd_era5_tpu_torch.ops.tsqr import qr_positive

    n_rows = x.shape[0]
    tail = n_rows % RAND_BLOCK
    log(f"[9a] K6 and K7 against their plain versions (block {RAND_BLOCK} rows, ragged tail "
        f"{tail}; CUDA-event ms)")
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    blk = x[:RAND_BLOCK]
    omega = torch.randn((x.shape[1], R_SKETCH), generator=gen, device=x.device)
    z = qr_positive(blk.T @ (blk @ omega))[0].contiguous()
    out = {"f32": compare_matmul("block f32", blk, z, f64_gate=True),
           "bf16": compare_matmul("block bf16", blk.bfloat16(), z.bfloat16(), f64_gate=False),
           "tail": compare_matmul("ragged tail f32", x[n_rows - tail:], z, f64_gate=True)}
    for m, n in ((x.shape[1], R_SKETCH), (8760, 110), (4096, 256)):
        panel = torch.randn((m, n), generator=gen, device=x.device)
        out[(m, n)] = compare_householder(f"panel {m}x{n}", panel)
    return out


def write_artifact(x: torch.Tensor, directory: Path) -> tuple[Path, float]:
    """Phase 9b: X from the card to a packed .npy artifact, chunk by
    chunk.  Fails when the directory lacks room for it."""
    from dmd_era5_tpu_torch.snapmat.loader import packed_info, save_packed_matrix

    path = directory / "era5_week_x.npy"
    need = x.numel() * x.element_size()
    free = shutil.disk_usage(directory).free
    log(f"[9b] artifact {path}: {need / 1e9:.2f} GB to write, {free / 1e9:.2f} GB free there")
    check(free >= need + GIB, f"no room for the {need / 1e9:.2f} GB artifact in {directory} "
          f"({free / 1e9:.2f} GB free); point TMPDIR at a larger disk")
    shape, secs = synced(save_packed_matrix, path, x)
    check(packed_info(path)[::2] == (tuple(x.shape), False) and shape == tuple(x.shape),
          f"artifact shape {shape}")
    log(f"    written in {secs:.2f} s ({need / secs / 1e9:.2f} GB/s), {path.stat().st_size} bytes")
    return path, secs


@contextlib.contextmanager
def pass_clock():
    """Wall time of each pass over the artifact, into the yielded list:
    wraps the streamed module's block reader, from its first block to
    the card's finishing the work of its last."""
    from dmd_era5_tpu_torch.pipeline import streamed_fit

    reader, times = streamed_fit.prefetched_row_blocks, []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        yield from reader(*args, **kwargs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)

    streamed_fit.prefetched_row_blocks = timed
    try:
        yield times
    finally:
        streamed_fit.prefetched_row_blocks = reader


def streamed_run(label: str, fn, *args, **kwargs):
    """(result, seconds, per-pass seconds, device-memory rise) of one
    streamed SVD call, the rise over what was allocated when it began."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with pass_clock() as passes:
        res, secs = synced(fn, *args, **kwargs)
    rise = torch.cuda.max_memory_allocated() - base
    log(f"    {label}: {secs:.2f} s, passes (s) {[round(t, 3) for t in passes]}, "
        f"device memory rise {rise / 1e6:.1f} MB")
    check(rise <= GIB, f"{label}: device memory rose {rise / 1e9:.2f} GB > 1 GiB: not out of core")
    return res, secs, passes, rise


def held_to_exact(label: str, s: torch.Tensor, ref: dict) -> dict:
    """Leading 6 singular values within 1e-5 of phase 8 (b)'s."""
    rel = (s.double().cpu() / ref["s"].double().cpu() - 1).abs()
    out = {"lead6_rel": float(rel[:6].max()), "all_rel": float(rel.max())}
    check(out["lead6_rel"] <= 1e-5,
          f"{label}: leading 6 s differ from phase 8 (b) by {out['lead6_rel']:.3e} > 1e-5")
    return out


def phase_streamed(week: dict, ref8: dict, seed: int) -> dict:
    """Phase 9b-e: the out-of-core SVD of the centred ERA5-week X from a
    packed artifact, both routes, and optDMD with the forecast on the
    randomized one; then phase 14 (d), the streamed mrDMD over the same
    artifact.  Returns the main path's launch counts."""
    from dmd_era5_tpu_torch.pipeline import (
        prefetched_row_blocks,
        streamed_exact_gram_svd,
        streamed_randomized_svd,
    )

    x = week["x"]
    n_rows, t_cols = x.shape
    n_blocks = -(-n_rows // RAND_BLOCK)
    times = {}
    directory = Path(tempfile.mkdtemp(prefix="dmd_era5_streamed_"))
    try:
        path, times["artifact_write"] = write_artifact(x, directory)

        log(f"[9c] streamed_randomized_svd(k = 100): {n_blocks} blocks of {RAND_BLOCK} rows "
            "per pass, n_iter auto")
        reset_counts()
        res, times["streamed_randomized"], passes, rise_r = streamed_run(
            "randomized", streamed_randomized_svd, path, 100, seed=seed + 7)
        times["randomized_passes"] = passes
        check(len(passes) == 6, f"randomized route read the artifact {len(passes)} times, not 6")
        u = torch.from_numpy(res.U).cuda()
        s, v = res.s, res.V
        del res
        orth = orth_9c = orthonormality(u)
        check(orth <= 1e-3, f"streamed randomized: U^T U - I max {orth:.3e} > 1e-3")
        lead = held_to_exact("streamed randomized", s, ref8)
        inter = check_interlace("streamed randomized vs phase 8 (b)", s, ref8["s"])
        log(f"    U {tuple(u.shape)} on the host, max|U^T U - I| {orth:.2e}, s[:8] "
            f"{[round(float(a), 2) for a in s[:8]]}; vs phase 8 (b): {json.dumps(lead)}, "
            f"{json.dumps(inter)}")
        log("[9e] optDMD (rank 6) and a 24-step forecast on the streamed randomized SVD (d = 1)")
        dmd_and_forecast("streamed", (u, s, v), week, times, d=1)
        launches = launch_counts()
        expect = counts(K6=5 * n_blocks, K7=4)
        check(launches == expect, f"streamed randomized path launches {launches}, expected {expect}")
        log(f"    launches {launches}")
        del u, s, v

        log(f"[9d] streamed_exact_gram_svd(k = 100): {-(-n_rows // EXACT_BLOCK)} blocks of "
            f"{EXACT_BLOCK} rows per pass")
        reset_counts()
        res, times["streamed_exact"], times["exact_passes"], rise_e = streamed_run(
            "exact", streamed_exact_gram_svd, path, 100, block_rows=EXACT_BLOCK)
        check(launch_counts() == counts(), f"exact streamed route launched {launch_counts()}")
        u = torch.from_numpy(res.U).cuda()
        s_e = torch.from_numpy(res.s)
        del res
        # U = X V S^-1 carries the f32 per-block Gram's error over s_i s_j
        # into its noise-floor columns: held to 1e-2, its own reading logged
        orth = orthonormality(u)
        check(orth <= 1e-2, f"streamed exact: U^T U - I max {orth:.3e} > 1e-2")
        lead = held_to_exact("streamed exact", s_e, ref8)
        cos = subspace_cos_min(u[:, :6], ref8["u6"])
        log(f"    max|U^T U - I| {orth:.2e}, s[:8] {[round(float(a), 2) for a in s_e[:8]]}; "
            f"vs phase 8 (b): {json.dumps(lead)}, leading-6 subspace cos min 1 - {1 - cos:.2e}")
        check(lead["all_rel"] <= 2e-3, f"streamed exact: s differ from phase 8 (b) by "
              f"{lead['all_rel']:.3e} > 2e-3")
        check(cos > 1 - 1e-6, f"streamed exact: leading-6 subspace cos min {cos:.9f}")
        del u
        mr_launches = phase_mrdmd_streamed(week, path)
        onepass_launches, times["onepass"] = phase_onepass_streamed(week, path, ref8, orth_9c,
                                                                    seed)
        times["trace"] = phase_trace(week, path, seed)
        mesh_launches = phase_mesh(week, path, seed, ref8)

        # where a pass's time goes: the same blocks read only, then read and
        # copied to the card, with no work on them
        t0 = time.perf_counter()
        for _ in prefetched_row_blocks(path, n_rows, RAND_BLOCK):
            pass
        times["pass_read_only"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _, blk in prefetched_row_blocks(path, n_rows, RAND_BLOCK):
            torch.from_numpy(blk).to("cuda")
        torch.cuda.synchronize()
        times["pass_read_and_copy"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    times["memory_rise_mb"] = {"randomized": rise_r / 1e6, "exact": rise_e / 1e6}
    log(f"    stage wall times (s): {json.dumps(times)}")
    log(f"    9c {times['streamed_randomized']:.2f} s, 9d {times['streamed_exact']:.2f} s "
        f"(before the pinned ring: {PAGEABLE_STREAMED_S['9c']} and "
        f"{PAGEABLE_STREAMED_S['9d']} s)")
    return {key: n + mr_launches[key] + onepass_launches[key] + mesh_launches[key]
            for key, n in expect.items()}


# phase 17: the ranks that share the card in 17b, 17c's portable mesh and
# its cut of the week's rows, 17b's per-rank panel inside K7's envelope;
# the tolerances (tests/test_07_train_step.py's mesh ones, s read relative
# to s[0]; tests/test_03_svd.py's TSQR atol relative to max|R|; Q^T Q at
# most the one-device reading plus MESH_ORTH_SLACK)
MESH_WORLDS = (2, 3)
MESH_PORTABLE, MESH_PORTABLE_ROWS = "data=1,space=2,time=2", 1 << 20
MESH_PANEL = (8192, 110)
MESH_S_RTOL, MESH_LOSS_ATOL, MESH_R_ATOL, MESH_ORTH_SLACK = 2e-3, 1e-3, 2e-4, 1e-5


def fit_omega(t_cols: int, seed: int) -> torch.Tensor:
    """Phase 4's sketch (T x 128), drawn again from its seed."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    return torch.randn((t_cols, 128), generator=gen, device="cuda")


def mesh_panel(world: int, seed: int) -> torch.Tensor:
    """17b's TSQR panel: MESH_PANEL[0] rows a rank, standard normal."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    return torch.randn((world * MESH_PANEL[0], MESH_PANEL[1]), generator=gen, device="cuda")


def log_summary(log) -> dict:
    """A collective log by op (calls, elements, bytes) and its largest
    payload by axis."""
    return {"by_op": log.by_op(),
            "largest": {a: log.largest(a) for a in ("data", "space", "time")},
            "ppermute": log.count("ppermute"), "all_gather": log.count("all_gather")}


def ranks_summary(ranks: list[dict], logs: tuple[str, ...]) -> dict:
    """The ranks' collective calls and bytes by op summed over the ranks,
    their largest payload by axis, and their slowest time of each step."""
    out = {}
    for key in logs:
        by_op = {}
        for res in ranks:
            for op, row in res[key]["by_op"].items():
                acc = by_op.setdefault(op, {"calls": 0, "bytes": 0})
                acc["calls"] += row["calls"]
                acc["bytes"] += row["bytes"]
        out[key] = {"by_op": by_op, "largest": {a: max(r[key]["largest"][a] for r in ranks)
                                                for a in ("data", "space", "time")}}
    out["slowest_s"] = {k: max(r["times"][k] for r in ranks) for k in ranks[0]["times"]}
    out["peak_gb"] = [round(r["peak_gb"], 3) for r in ranks]
    return out


def held_to(label: str, s: torch.Tensor, loss: float, ref_s: torch.Tensor, ref_loss: float
            ) -> dict:
    """s within MESH_S_RTOL of ref's s[0], the loss within MESH_LOSS_ATOL."""
    ds = float((s.double().cpu() - ref_s.double().cpu()).abs().max()) / float(ref_s[0])
    dl = abs(loss - ref_loss)
    check(ds <= MESH_S_RTOL, f"{label}: s differ by {ds:.3e} of s[0] > {MESH_S_RTOL}")
    check(dl <= MESH_LOSS_ATOL, f"{label}: loss differs by {dl:.3e} > {MESH_LOSS_ATOL}")
    return {"s_rel": ds, "loss_abs": dl}


@contextlib.contextmanager
def off_card(x: torch.Tensor):
    """x's card memory freed inside, its values kept in pinned host memory
    and put back after, in the same storage (every reference to x stays
    valid): room for the ranks that share the card with this process."""
    storage = x.untyped_storage()
    check(storage.resizable() and x.storage_offset() == 0 and x.is_contiguous()
          and storage.nbytes() == x.numel() * x.element_size(),
          "off_card: x is not the whole of a storage of its own")
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    nbytes = storage.nbytes()
    storage.resize_(0)
    torch.cuda.empty_cache()
    try:
        yield
    finally:
        storage.resize_(nbytes)
        x.copy_(host)
        del host


def _minus(a: dict, b: dict) -> dict:
    return {key: a[key] - b[key] for key in a}


def _by_value(obj, back: bool = False):
    """A rank's readings with every tensor as a numpy array (``back``: the
    reverse), so that they cross the queue by value: a tensor would cross
    as a file descriptor that a rank which has exited no longer serves."""
    if isinstance(obj, dict):
        return {key: _by_value(value, back) for key, value in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_by_value(value, back) for value in obj)
    if not back and isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if back and isinstance(obj, np.ndarray) and obj.dtype != object:
        return torch.from_numpy(obj)
    return obj


def mesh_rank(rank: int, world: int, init: str, path: str, seed: int, kind: str, queue) -> None:
    """One rank of 17b, 18b and 19a-c (and at P = 2 18d) (``kind``
    "fused") or of 17c, 18c and 19d ("portable"), a process of its own on
    the shared card; puts its readings on ``queue``, 17's launches apart
    from 18's and 19's."""
    import traceback

    import torch.distributed as dist

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        from dmd_era5_tpu_torch.parallel import initialize_distributed, make_mesh
        from dmd_era5_tpu_torch.parallel.collectives import collective_log
        from dmd_era5_tpu_torch.pipeline import fit_step

        t_start = time.perf_counter()
        backend = initialize_distributed(init, world_size=world, rank=rank)
        torch.cuda.reset_peak_memory_stats()
        res = {"backend": backend, "times": {}}
        if kind == "fused":
            from dmd_era5_tpu_torch.ops.matmul import sketch_center_gram_project
            from dmd_era5_tpu_torch.ops.tsqr import tsqr
            from dmd_era5_tpu_torch.snapmat import load_row_sharded

            mesh = make_mesh()
            (x_loc, _), res["times"]["load"] = synced(load_row_sharded, path, mesh)
            omega = fit_omega(x_loc.shape[1], seed)
            reset_counts()
            with collective_log() as flog:
                state, res["times"]["fit"] = synced(fit_step, x_loc[None], omega, mesh, 100)
            res.update(s=state.s[0].cpu(), loss=float(state.loss), fit_log=log_summary(flog))
            del state
            # 18b on the rank's rows, its launches and peak memory apart
            peak, before = torch.cuda.max_memory_allocated(), launch_counts()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            res["svd"], res["times"]["svd_18b"] = synced(
                run_svd_mesh_routes, tuple(SVD_MESH_LAUNCHES), x_loc, mesh, seed)
            res["peak_gb_18b"] = torch.cuda.max_memory_allocated() / 1e9
            svd_launches = _minus(launch_counts(), before)
            # 19 on the same rows, its launches apart from 17's with 18b's
            before = launch_counts()
            res["models"], res["times"]["models_19"] = synced(models_mesh_rank, x_loc, mesh,
                                                               world, path, seed)
            svd_launches = {key: n + m for (key, n), m in
                            zip(svd_launches.items(), _minus(launch_counts(), before).values())}
            torch.cuda.reset_peak_memory_stats()
            yc = sketch_center_gram_project(x_loc, omega)[0]
            del x_loc
            with collective_log() as tlog:
                (q, r), res["times"]["tsqr_yc"] = synced(tsqr, yc, mesh)
            res.update(r_yc=r.cpu(), qtq_yc=gram_f64(q).cpu(), tsqr_log=log_summary(tlog))
            del yc, q
            panel = mesh_panel(world, seed)[rank * MESH_PANEL[0]:(rank + 1) * MESH_PANEL[0]]
            with collective_log() as hlog:
                (q, r), res["times"]["tsqr_panel"] = synced(tsqr, panel.contiguous(), mesh,
                                                           method="householder")
            res.update(r_hh=r.cpu(), qtq_hh=gram_f64(q).cpu(), hh_log=log_summary(hlog))
            del q, r, panel
            peak = max(peak, torch.cuda.max_memory_allocated())
            res["launches"] = _minus(launch_counts(), svd_launches)
            if world == 2:  # 18d: config 1's stage over these two ranks
                torch.cuda.empty_cache()
                res["stage"], res["times"]["stage_18d"] = synced(stage_mesh_routes, seed)
        else:
            mesh = make_mesh(MESH_PORTABLE)
            per, t_loc = MESH_PORTABLE_ROWS // mesh.shape["space"], T_HOURS // mesh.shape["time"]
            r0, t0 = mesh.coords["space"] * per, mesh.coords["time"] * t_loc
            rows = np.load(path, mmap_mode="r")[r0:r0 + per, t0:t0 + t_loc]
            x_loc = torch.from_numpy(np.ascontiguousarray(rows)).cuda()
            omega = fit_omega(T_HOURS, seed)
            reset_counts()
            with collective_log() as flog:
                state, res["times"]["fit"] = synced(fit_step, x_loc[None], omega, mesh, 100)
            res.update(s=state.s[0].cpu(), loss=float(state.loss), fit_log=log_summary(flog),
                       coords=mesh.coords)
            del state
            res["launches"], peak = launch_counts(), torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            res["grid"], res["times"]["grid_18c"] = synced(grid_mesh_rank, x_loc, mesh, path, seed)
            res["peak_gb_18c"] = torch.cuda.max_memory_allocated() / 1e9
            del x_loc
            torch.cuda.empty_cache()
            res["stage_models"], res["times"]["models_19d"] = synced(stage_models_rank, seed,
                                                                     Path(path).parent)
        res["peak_gb"] = peak / 1e9
        res["times"]["rank"] = time.perf_counter() - t_start
        queue.put((rank, _by_value(res)))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(world: int, kind: str, path: Path, seed: int) -> tuple[list[dict], float]:
    """``world`` ranks of ``kind`` (spawned processes, gloo through a
    ``file://`` store under ``TMPDIR``) on the shared card; (their readings
    by rank, wall time).  Any rank's failure fails the phase."""
    import multiprocessing
    import queue as queue_module

    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    directory = Path(tempfile.mkdtemp(prefix="dmd_era5_mesh_"))
    init = f"file://{directory / 'store'}"
    procs = [ctx.Process(target=mesh_rank, args=(r, world, init, str(path), seed, kind, queue))
             for r in range(world)]
    # the ranks share the card with this process: segments that grow in
    # place keep each rank's freed blocks from fragmenting its share
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    free, total = torch.cuda.mem_get_info()
    log(f"    {world} {kind} ranks: the card before them: {torch.cuda.memory_allocated() / 1e9:.2f} "
        f"GB allocated in this process, {free / 1e9:.1f} of {total / 1e9:.1f} GB free")
    t0 = time.perf_counter()
    try:
        for proc in procs:
            proc.start()
        results, deadline = {}, time.monotonic() + 600
        while len(results) < world:  # drained before the joins; stops at a failure
            try:
                rank, res = queue.get(timeout=5)
            except queue_module.Empty:
                dead = [r for r, proc in enumerate(procs) if r not in results
                        and proc.exitcode not in (None, 0)]
                check(not dead and time.monotonic() < deadline,
                      f"17 {kind} ranks {dead} died before their readings (exit codes "
                      f"{[proc.exitcode for proc in procs]}), or 600 s passed")
                continue
            results[rank] = _by_value(res, back=True)
            if "error" in res:
                break
        errors = [f"rank {r}:\n{res['error']}" for r, res in sorted(results.items())
                  if "error" in res]
        check(not errors, f"17 {kind} ranks failed:\n" + "\n".join(errors))
        for proc in procs:
            proc.join(timeout=120)
        check(all(proc.exitcode == 0 for proc in procs),
              f"17 {kind} ranks exit codes {[proc.exitcode for proc in procs]}")
    finally:
        os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        shutil.rmtree(directory, ignore_errors=True)
    return [results[r] for r in range(world)], time.perf_counter() - t0


def mesh_kernels_vs_plain(x: torch.Tensor, omega: torch.Tensor, world: int, seed: int) -> dict:
    """17b's kernels against their plain versions at the shapes a rank of
    ``world`` gives them, on rank 0's rows of the week (``row_block``, as
    ``load_row_sharded`` cuts them) and its panel, with the smoke's gates:
    K1 as the meshed step launches it, K5 on that block's Yc (the split
    CholQR2 leaf's Gram), K7 on the rank's 8,192 x 110 panel.  Uncounted;
    returns each kernel's errors and times."""
    from dmd_era5_tpu_torch.ops.matmul import sketch_center_gram_project
    from dmd_era5_tpu_torch.parallel.sharding import row_block

    r0, r1, _ = row_block(x.shape[0], world, 0)
    x_loc = x[r0:r1]
    label = f"17b P={world} rank 0"
    k1 = compare_kernel(label, x_loc, omega, torch.float32, centred=True)
    yc = sketch_center_gram_project(x_loc, omega)[0]
    k5 = compare_gram(label, yc, "bf16_split")
    del yc
    k7 = compare_householder(label, mesh_panel(world, seed)[:MESH_PANEL[0]])
    torch.cuda.empty_cache()
    times = ("ms", "plain_ms", "bound_ms", "library_ms")
    return {"K1": {"m": k1["m"], "rel_err": k1["rel_err"],
                   "G_vs_f64": k1["kernel_G_vs_f64"], "C_vs_f64": k1["kernel_C_vs_f64"],
                   **{key: k1.get(key) for key in times}},
            "K5": {"m": k5["m"], "G_vs_f64_over_max": k5["kernel_max_abs_vs_f64_over_max"],
                   **{key: k5.get(key) for key in times}},
            "K7": {"r_vs_plain_over_max": k7["r_max_abs_over_max"], "q_rel": k7["q_rel"],
                   "orth": k7["kernel_orth"], **{key: k7.get(key) for key in times}}}


def phase_mesh_one_rank(x: torch.Tensor, omega: torch.Tensor) -> tuple[dict, dict, dict]:
    """17a: the meshed fit step on a (1, 1, 1) mesh of this process over
    NCCL (a ``file://`` store), at f32 and bf16, against phase 4's
    ``fit_step_fused`` on the same X and Omega, and on the first
    ``MESH_PORTABLE_ROWS`` rows (17c's reference).  Returns (the readings,
    the launch counts, the f32 step's and the cut's (s, loss))."""
    import torch.distributed as dist

    from dmd_era5_tpu_torch.parallel import initialize_distributed, make_mesh
    from dmd_era5_tpu_torch.parallel.collectives import collective_log
    from dmd_era5_tpu_torch.pipeline import fit_step_fused, make_fit_step

    directory = Path(tempfile.mkdtemp(prefix="dmd_era5_mesh_"))
    out, refs, launches = {}, {}, counts()
    try:
        backend = initialize_distributed(f"file://{directory / 'store'}", world_size=1, rank=0)
        check(backend == "nccl", f"17a: a one-rank group on one card chose {backend}")
        t0 = time.perf_counter()
        mesh = make_mesh()
        out["mesh_s"] = time.perf_counter() - t0
        log(f"[17a] one rank over {backend}: mesh {mesh.shape} on {mesh.device}")
        bound = x.shape[1] * omega.shape[1]  # B_loc r T with B_loc = 1
        for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 1e-2)):
            ref = fit_step_fused(x, omega, 100, gemm_dtype=dtype)
            ref_s, ref_loss = ref.s.cpu(), float(ref.loss)
            del ref
            reset_counts()
            step = make_fit_step(mesh, 100, gemm_dtype=dtype)
            with collective_log() as clog:
                state, secs = synced(step, x[None], omega)
            got = launch_counts()
            check(got == counts(K1=1), f"17a {dtype}: launches {got}, expected K1 once")
            for key, n in got.items():
                launches[key] += n
            name = str(dtype)[6:]
            held = held_to(f"17a {name}", state.s[0], float(state.loss), ref_s, ref_loss)
            gram = gram_f64(state.u[0])
            dev = (gram - torch.eye(100, dtype=gram.dtype, device=gram.device)).abs()
            lead = len(PAIRS) * 2
            orth = float(dev[:lead, :lead].max())
            check(orth <= tol, f"17a {name}: leading U^T U - I max {orth:.3e} > {tol}")
            check(float(dev.max()) <= 1.5e-1, f"17a {name}: U^T U - I max {float(dev.max()):.3e}")
            largest = clog.largest()
            check(largest <= bound, f"17a {name}: a collective of {largest} elements > {bound}")
            out[name] = dict(seconds=secs, loss=float(state.loss), orth_lead=orth,
                             orth_all=float(dev.max()), **held, collectives=log_summary(clog))
            log(f"    {name}: {secs:.3f} s, loss {float(state.loss):.4e} (fused step "
                f"{ref_loss:.4e}), s off by {held['s_rel']:.2e} of s[0], leading U^T U - I "
                f"{orth:.2e}, collectives {clog.by_op()} (largest {largest} <= {bound})")
            if dtype == torch.float32:
                refs["week"] = (state.s[0].cpu(), float(state.loss))
            del state, gram, dev
        reset_counts()
        cut = make_fit_step(mesh, 100)(x[None, :MESH_PORTABLE_ROWS], omega)
        check(launch_counts() == counts(K1=1), f"17a cut: launches {launch_counts()}")
        launches["K1"] += 1
        refs["cut"] = (cut.s[0].cpu(), float(cut.loss))
        del cut
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(directory, ignore_errors=True)
    return out, launches, refs


def phase_mesh(week: dict, path: Path, seed: int, ref8: dict) -> dict:
    """Phases 17, 18 and 19: the distributed layer, the SVD layer and the
    DMD models on it, on the card, inside phase 9 while its packed
    artifact of the week exists.  18's and 19's parts ride in 17's worlds
    (a spawn costs ~8 s): 18a after 17a in this process, 18b (and 18d at
    P = 2) and 19a-c in 17b's ranks, 18c and 19d in 17c's
    (``phase_svd_mesh_one_rank``, ``mesh_rank``, ``models_mesh_rank``,
    ``stage_models_rank``).  Phase 17:  (a) one rank over NCCL in
    this process; (b) P = 2 and 3 ranks sharing the card over gloo, each
    reading its rows of the artifact (``load_row_sharded``): the fused
    meshed step (K1), tree TSQR of its Yc (the split CholQR2 leaf, K5)
    and of a panel inside K7's envelope (the Householder leaf, K7), the
    three kernels first held against their plain versions at a rank's
    shapes in this process (``mesh_kernels_vs_plain``); (c)
    the portable step on (1, 2, 2), 4 ranks on the week's first
    ``MESH_PORTABLE_ROWS`` rows (a cut of depth), against (a)'s step on
    the same rows.  The ranks are spawned after phase 1 built every
    kernel library.  Returns the launch counts of 17a-c, 18a-d and 19a-d."""
    from dmd_era5_tpu_torch.ops.matmul import sketch_center_gram_project
    from dmd_era5_tpu_torch.ops.tsqr import tsqr
    from dmd_era5_tpu_torch.pipeline import era5_dmd, era5_svd

    x = week["x"]
    t_phase = time.perf_counter()
    omega = fit_omega(x.shape[1], seed)
    summary = {"card": smi_line()}
    (summary["17a"], launches, refs), summary["17a"]["seconds"] = synced(
        phase_mesh_one_rank, x, omega)
    (summary["18a"], launches_18a), secs = synced(phase_svd_mesh_one_rank, week, seed)
    summary["18a"]["seconds"] = secs
    del week["u6_rand"], week["u6_exact"]  # 18a's alone: room for the ranks
    for key, n in launches_18a.items():
        launches[key] += n
    svd_refs, summary["18b_refs_s"] = synced(svd_mesh_refs, week, ref8, seed)
    bounds = svd_mesh_bounds(x.shape[1])
    own18 = secs + summary["18b_refs_s"]  # 18's seconds in this process
    log("[19] the models on the mesh: one-device references in this process first (the "
        "ensemble on a (1, 1, 1) mesh, the fused Hankel SVD with the bag and DMDc), K1 and "
        "K4 at the ranks' shapes")
    models_refs, own19 = synced(models_mesh_refs, week, seed, path.parent)
    log(f"    references: {json.dumps({k: models_refs[k] for k in ('times', 'kernels')})}")

    # 17b's references, uncounted: one-device TSQR of the whole Yc (the
    # split CholQR2 leaf) and of each world's whole panel (library QR:
    # past K7's envelope)
    yc = sketch_center_gram_project(x, omega)[0]
    q, r_ref = tsqr(yc)
    del yc
    ref_yc = (r_ref, orthonormality(q))
    del q
    ref_hh = {}
    for world in MESH_WORLDS:
        q, r = tsqr(mesh_panel(world, seed), method="householder")
        ref_hh[world] = (r, orthonormality(q))
        del q
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"[17b] ranks sharing the card over gloo ({free / 1e9:.1f} of {total / 1e9:.1f} GB "
        f"free on it): the fused meshed step, tree TSQR of Yc (K5 leaf) and of a "
        f"{MESH_PANEL[0]} x {MESH_PANEL[1]} panel a rank (K7 leaf)")
    week_s, week_loss = refs["week"]
    for world in MESH_WORLDS:
        log(f"    P = {world}: K1, K5 and K7 against their plain versions at a rank's shapes")
        kernels = mesh_kernels_vs_plain(x, omega, world, seed)
        log(f"    P = {world}: 18b's K1, K6, K5 and K3 against their plain versions at a rank's "
            "shapes")
        svd_kernels, secs = synced(svd_kernels_vs_plain, x, world, seed)
        own18 += secs
        # the ranks read their rows from the artifact: the week's X leaves
        # the card while they run (two ranks' 18b take ~52 GB of it)
        if world == 2:  # 18d's world: config 1 one device here first, under one stage root
            with stage_root():
                stage_ref, stage_ref_s = synced(stage_mesh_routes, seed)
                own18 += stage_ref_s
                with off_card(x):
                    ranks, wall = run_ranks(world, "fused", path, seed)
        else:
            with off_card(x):
                ranks, wall = run_ranks(world, "fused", path, seed)
        part = {"wall_s": wall, **ranks_summary(ranks, ("fit_log", "tsqr_log", "hh_log")),
                "kernels": kernels}
        want = (int(math.log2(world)) if world & (world - 1) == 0
                else math.ceil(math.log2(world)) + 1)
        for rank, res in enumerate(ranks):
            label = f"17b P={world} rank {rank}"
            check(res["backend"] == "gloo", f"{label}: backend {res['backend']}")
            held = held_to(label, res["s"], res["loss"], week_s, week_loss)
            for key, value in held.items():
                part[key] = max(part.get(key, 0.0), value)
            for key, (r_ref, _), cols in (("yc", ref_yc, 128), ("hh", ref_hh[world], 110)):
                r = res[f"r_{key}"].to(r_ref.device)
                err = float((r - r_ref).abs().max()) / float(r_ref.abs().max())
                check(err <= MESH_R_ATOL, f"{label} {key}: R off by {err:.3e} of max|R|")
                log_ = res["tsqr_log" if key == "yc" else "hh_log"]
                check(log_["ppermute"] == want and log_["all_gather"] == 0 and
                      log_["largest"]["space"] <= 2 * cols * cols,
                      f"{label} {key}: exchanges {log_} (want {want} ppermute, each <= "
                      f"{2 * cols * cols})")
                part[f"r_err_{key}"] = max(part.get(f"r_err_{key}", 0.0), err)
            check(res["fit_log"]["largest"]["space"] <= 128 * T_HOURS,
                  f"{label}: fit collectives {res['fit_log']}")
            check(res["launches"] == counts(K1=2, K5=2, K7=1),
                  f"{label}: launches {res['launches']}, expected K1 2, K5 2, K7 1")
            for key, n in res["launches"].items():
                launches[key] += n
        for key, (_, orth_ref) in (("yc", ref_yc), ("hh", ref_hh[world])):
            qtq = sum(res[f"qtq_{key}"] for res in ranks)
            orth = float((qtq - torch.eye(qtq.shape[0], dtype=qtq.dtype)).abs().max())
            check(orth <= orth_ref + MESH_ORTH_SLACK,
                  f"17b P={world} {key}: max|Q^T Q - I| {orth:.3e} > one device's "
                  f"{orth_ref:.3e} + {MESH_ORTH_SLACK}")
            part[f"orth_{key}"] = (orth, orth_ref)
        summary[f"17b_P{world}"] = part
        log(f"    P = {world}: {wall:.2f} s wall; s off {part['s_rel']:.2e} of s[0], loss off "
            f"{part['loss_abs']:.2e}; R off {part['r_err_yc']:.2e} (Yc), {part['r_err_hh']:.2e} "
            f"(panel) of max|R|; "
            f"Q^T Q - I {part['orth_yc'][0]:.2e} vs {part['orth_yc'][1]:.2e} one device (Yc), "
            f"{part['orth_hh'][0]:.2e} vs {part['orth_hh'][1]:.2e} (panel); {want} exchanges; "
            f"peak GB by rank {part['peak_gb']}; at a rank's shapes "
            + ", ".join(f"{key} {k['ms']:.3f} ms (plain {k['plain_ms']:.3f}, bound "
                        f"{k['bound_ms']:.4f})" for key, k in kernels.items()))
        label = f"18b P={world}"
        part18 = {"routes": held_svd_routes(label, [r["svd"] for r in ranks], svd_refs, bounds,
                                            SVD_MESH_LAUNCHES),
                  "kernels": svd_kernels, "rank_s": [round(r["times"]["svd_18b"], 3) for r in ranks],
                  "peak_gb": [round(r["peak_gb_18b"], 3) for r in ranks]}
        for res in ranks:
            for route in res["svd"].values():
                for key, n in route["launches"].items():
                    launches[key] += n
        summary[f"18b_P{world}"] = part18
        log(f"    {label}: by route (s off one device's, of s[0]; max|U^T U - I| vs one device's; "
            f"largest collective) "
            + "; ".join(f"{name} {r['s_rel']:.2e}, {r['orth']:.2e} vs {r['orth_one_device']:.2e}, "
                        f"{r['largest']}, {r['seconds']} s" for name, r in part18["routes"].items())
            + f"; the rank's 18b {part18['rank_s']} s, peak GB by rank {part18['peak_gb']}; at a "
            "rank's shapes " + ", ".join(
                f"{key} {k['ms']:.3f} ms (plain {k['plain_ms']:.3f}, library {k['library_ms']}, "
                f"bound {k['bound_ms']:.4f})" for key, k in svd_kernels.items()))
        part19 = held_models(ranks, models_refs, world)
        for res in ranks:
            for name in part19:
                for key, n in res["models"][name]["launches"].items():
                    launches[key] += n
        summary[f"19_P{world}"] = part19
        for name, read in part19.items():
            log(f"[{name[:3]}] P = {world}, {name}: {json.dumps(read, default=str)}")
        if world == 2:
            summary["18d"] = held_stage_routes(ranks, stage_ref)
            summary["18d"]["one_device_s"] = stage_ref_s
            summary["18d"]["rank_s"] = [round(r["times"]["stage_18d"], 3) for r in ranks]
            for res in ranks:
                for route in res["stage"].values():
                    for key, n in route["launches"].items():
                        launches[key] += n
            log(f"[18d] config 1 over 2 ranks (mesh_shape space=2, "
                "era5_svd.main with the files): "
                f"{json.dumps(summary['18d'], default=str)}")

    log(f"[17c] the portable step on {MESH_PORTABLE}: 4 ranks sharing the card over gloo, the "
        f"week's first {MESH_PORTABLE_ROWS} rows (a cut of depth: 2^20 of "
        f"{x.shape[0]} rows), against 17a's step on the same rows")
    grid_refs, secs = synced(grid_mesh_refs, x, seed)
    own18 += secs
    log("    18c's K6, K3 and K5 against their plain versions at rank 0's shapes")
    grid_kernels, secs = synced(grid_kernels_vs_plain, x, seed)
    own18 += secs
    with stage_root():  # 19d's config 1: one device here first, then the ranks
        with first_call(era5_svd, "svd_on_era5") as flat, \
                first_call(era5_dmd, "dmdc_from_svd") as dmdc_call:
            (stage19_ref, _), secs = synced(stage_models_fit, None, seed)
        own19 += secs
        log("    19d's K1 and K4 against their plain versions at rank 0's shapes on "
            f"{MODELS_MESH}; the LM witness on config 1's i.i.d. mock")
        stage19_kernels, secs = synced(stage_models_kernels, flat["kwargs"]["da_flat"].data,
                                       dmdc_call["args"])
        own19 += secs
        del flat, dmdc_call
        witness, secs = synced(lm_witness, seed, path.parent)
        own19 += secs
        ranks, wall = run_ranks(4, "portable", path, seed)
    cut_s, cut_loss = refs["cut"]
    part = {"wall_s": wall, **ranks_summary(ranks, ("fit_log",))}
    for rank, res in enumerate(ranks):
        label = f"17c rank {rank}"
        held = held_to(label, res["s"], res["loss"], cut_s, cut_loss)
        for key, value in held.items():
            part[key] = max(part.get(key, 0.0), value)
        check(res["launches"] == counts(), f"{label}: launches {res['launches']}")
        sketch_sum = MESH_PORTABLE_ROWS // 2 * 128
        check(res["fit_log"]["largest"]["time"] == sketch_sum
              and res["fit_log"]["largest"]["space"] <= 128 * T_HOURS,
              f"{label}: collectives {res['fit_log']}")
    summary["17c"] = part
    log(f"    {wall:.2f} s wall; s off {part['s_rel']:.2e} of s[0], "
        f"loss off {part['loss_abs']:.2e}; the time-axis sketch sum "
        f"{MESH_PORTABLE_ROWS // 2 * 128} elements a rank through host memory")
    summary["18c"] = held_grid_ranks(ranks, grid_refs)
    summary["18c"]["kernels"] = grid_kernels
    for res in ranks:
        for key, n in res["grid"]["launches"].items():
            launches[key] += n
    log(f"[18c] on {MESH_PORTABLE} (17c's ranks, the same {MESH_PORTABLE_ROWS} rows): "
        f"{json.dumps(summary['18c'], default=str)}")
    summary["19d"] = held_stage_models([res["stage_models"] for res in ranks], stage19_ref, witness)
    summary["19d"]["kernels"] = stage19_kernels
    for res in ranks:
        for key, n in res["stage_models"]["launches"].items():
            launches[key] += n
    log(f"[19d] config 1 on {MODELS_MESH} over 17c's 4 ranks (era5_svd.main with the files, "
        f"then fit_dmd_from_svd_results): {json.dumps(summary['19d'], default=str)}")
    summary["seconds"] = time.perf_counter() - t_phase
    summary["18_own_seconds"] = own18  # 18a, its references and kernel checks in this process
    summary["19_own_seconds"] = own19  # 19's references and kernel checks in this process
    log(f"[17] mesh, [18] SVD and [19] models on the mesh {json.dumps(summary, default=str)}")
    log(f"    launches {launches}")
    return launches


# phase 18: the SVD layer on the mesh.  The one-device runs each route is
# held to: phase 3 (fused Hankel, the same sketch), 7 (exact Hankel), 8's
# routes (a) Gram, (c) TSQR and (d) randomized (the same sketch), and the
# unfused Hankel SVD on 18's own sketch, run here.  s read relative to
# s[0] within SVD_MESH_S_TOL: every route but the TSQR one runs the same
# algorithm on the same sketch as one device (only the psums' order
# differs, or tree TSQR replaces the one-device leaf; the readings are
# 1e-7-2e-6).  A halo column dropped at 18c's time boundary (one window
# in 167) moves s by ~1e-3 of s[0]: 18c runs that control and it must
# miss the limit.  U's summed Gram no further from I than one device's
# plus MESH_ORTH_SLACK, or 1e-3 (the smoke's limit) where the leaf
# differs; the TSQR route in the centred fault's bracket.  Collective
# bounds: tests/test_21_comm_pattern.py's.
SVD_MESH_K, SVD_MESH_D = 100, 2
SVD_MESH_S_TOL = 1e-5
SVD_MESH_LAUNCHES = {  # in the ranks' order: the largest footprint first
    "unfused": counts(K3=5, K5=10, K6=5), "fused": counts(K1=5), "exact": counts(K1=1, K5=1),
    "gram": counts(K1=1, K5=1), "tsqr": counts(K5=2), "randomized": counts(K5=10),
}
# 18c on (1, 2, 2) and 18d's three routes of config 1 (config.ini's
# [era5-svd] with mesh_shape space=2 and these overrides)
SVD_GRID_LAUNCHES = counts(K3=5, K5=20, K6=6)
STAGE_MESH_ROUTES = (("randomized", {}), ("standard", {"svd_type": "standard"}),
                     ("inmem", {"svd_backend": "inmem"}))


def svd_mesh_omegas(t_cols: int, seed: int) -> dict:
    """18's sketches, drawn alike in every process from their seeds:
    phase 3's (fused Hankel, 128 columns) and the unfused Hankel SVD's
    (110 = k + 10 columns, as the JAX sharded default)."""
    def draw(cols, offset):
        gen = torch.Generator(device="cuda").manual_seed(seed + offset)
        return torch.randn((t_cols - SVD_MESH_D + 1, cols), generator=gen, device="cuda")

    return {"fused": draw(128, 1), "unfused": draw(SVD_MESH_K + 10, 18)}


def svd_mesh_bounds(t_cols: int) -> dict:
    """Each route's largest collective payload (elements) allowed by
    tests/test_21_comm_pattern.py: the (r, T-d+1) projection or 4 r^2
    for the randomized routes (r = k + 10, or 128 fused), T^2 for the
    exact Hankel SVD's raw Gram, 2 T^2 for the exact routes at d = 1."""
    t_out, r = t_cols - SVD_MESH_D + 1, SVD_MESH_K + 10
    rand = max(2 * r * t_cols, 4 * r * r)
    return {"fused": 128 * t_out, "unfused": rand, "exact": t_cols * t_cols,
            "gram": 2 * t_cols * t_cols, "tsqr": 2 * t_cols * t_cols, "randomized": rand}


def svd_mesh_route(name: str, x: torch.Tensor, mesh, omegas: dict, seed: int):
    """One of 18's SVDs on this rank's rows x of the week, on ``mesh``."""
    from dmd_era5_tpu_torch.ops import hankel
    from dmd_era5_tpu_torch.ops.svd import truncated_svd

    d, k = SVD_MESH_D, SVD_MESH_K
    if name == "fused":
        return hankel.hankel_randomized_svd_sharded(x, d, k, mesh, n_oversamples=28,
                                                    omega=omegas["fused"])
    if name == "unfused":
        return hankel.hankel_randomized_svd_sharded(x, d, k, mesh, fused=False,
                                                    omega=omegas["unfused"])
    if name == "exact":
        return hankel.hankel_exact_svd(x, d, k, mesh=mesh)
    if name == "randomized":
        return truncated_svd(x, k, svd_type="randomized", seed=seed + 5, mesh=mesh)
    return truncated_svd(x, k, svd_type="standard", mesh=mesh,
                         exact_method="tsqr" if name == "tsqr" else "auto")


def run_svd_mesh_routes(names, x: torch.Tensor, mesh, seed: int) -> dict:
    """18's routes ``names`` on this rank's rows x: each one's s, its U
    block's Gram in f64 (summed over the ranks by the caller), seconds,
    collective log and launches, U freed before the next."""
    from dmd_era5_tpu_torch.parallel.collectives import collective_log

    omegas = svd_mesh_omegas(x.shape[1], seed)
    out = {}
    for name in names:
        before = launch_counts()
        with collective_log() as clog:
            (u, s, _), secs = synced(svd_mesh_route, name, x, mesh, omegas, seed)
        after = launch_counts()
        out[name] = {"s": s.cpu(), "gram": gram_f64(u).cpu(), "seconds": secs,
                     "log": log_summary(clog),
                     "launches": {key: after[key] - before[key] for key in after}}
        del u, s
        torch.cuda.empty_cache()
    return out


def svd_mesh_refs(week: dict, ref8: dict, seed: int) -> dict:
    """18b's one-device references: (s, max|U^T U - I|) by route; the
    unfused Hankel SVD on 18's sketch run here (uncounted)."""
    from dmd_era5_tpu_torch.ops.hankel import hankel_randomized_svd

    omega = svd_mesh_omegas(week["x"].shape[1], seed)["unfused"]
    u, s, _ = hankel_randomized_svd(week["x"], SVD_MESH_D, SVD_MESH_K, omega=omega)
    refs = {"unfused": (s.cpu(), orthonormality(u)), **ref8["routes"],
            "fused": (week["s_rand"].cpu(), week["orth_rand"]),
            "exact": (week["s_exact"].cpu(), week["orth_exact"])}
    del u, s
    torch.cuda.empty_cache()
    return refs


def svd_kernels_vs_plain(x: torch.Tensor, world: int, seed: int) -> dict:
    """18b's kernels against their plain versions at the shapes a rank of
    ``world`` gives them, on rank 0's rows of the week: K1 as the fused
    sharded pass launches it (stacked W of phase 3's sketch, N 256, no
    centring), K5 on the rows (the exact, Gram and TSQR routes' raw Gram),
    K6 as ``hankel_sketch`` (W of 18's unfused sketch, N 220), K3 as
    ``hankel_project`` (Q' of that sketch's Y side by side, (S_loc, 220)),
    K5 on that Y (the split CholQR2 leaf's Gram).
    Uncounted; returns each kernel's errors and times."""
    from dmd_era5_tpu_torch.ops.hankel import hankel_sketch, stacked_sketch_matrix
    from dmd_era5_tpu_torch.parallel.sharding import row_block

    r0, r1, _ = row_block(x.shape[0], world, 0)
    x_loc = x[r0:r1]
    t = x.shape[1]
    omegas = svd_mesh_omegas(t, seed)
    label = f"18b P={world} rank 0"
    k1 = compare_kernel(label, x_loc, stacked_sketch_matrix(omegas["fused"], SVD_MESH_D, t),
                        torch.float32, centred=True, center=False)
    k5x = compare_gram(label, x_loc, "bf16_split")  # the exact routes' raw Gram
    w = stacked_sketch_matrix(omegas["unfused"], SVD_MESH_D, t)
    k6 = compare_matmul(label, x_loc, w, f64_gate=True)
    y = hankel_sketch(x_loc, omegas["unfused"], SVD_MESH_D)
    k5 = compare_gram(label, y, "bf16_split")
    s_loc, r = x_loc.shape[0], omegas["unfused"].shape[1]
    q_wide = y.view(SVD_MESH_D, s_loc, r).transpose(0, 1).reshape(s_loc, SVD_MESH_D * r)
    del y
    k3 = compare_project(label, x_loc, q_wide)
    del q_wide
    torch.cuda.empty_cache()
    times = ("ms", "plain_ms", "bound_ms", "library_ms")
    return {"K1": {"m": k1["m"], "rel_err": k1["rel_err"], "G_vs_f64": k1["kernel_G_vs_f64"],
                   "C_vs_f64": k1["kernel_C_vs_f64"], **{key: k1.get(key) for key in times}},
            "K6": {key: k6.get(key) for key in ("rel_err", "kernel_vs_f64_over_max", *times)},
            "K5": {"G_vs_f64_over_max": k5["kernel_max_abs_vs_f64_over_max"],
                   **{key: k5.get(key) for key in times}},
            "K5_x": {"G_vs_f64_over_max": k5x["kernel_max_abs_vs_f64_over_max"],
                     **{key: k5x.get(key) for key in times}},
            "K3": {key: k3.get(key) for key in ("C_vs_plain_over_max", "kernel_C_vs_f64_over_max",
                                                 *times)}}


def grid_kernels_vs_plain(x: torch.Tensor, seed: int) -> dict:
    """18c's kernels against their plain versions at the shapes rank 0 of
    (1, 2, 2) gives them on the week's first MESH_PORTABLE_ROWS rows, its
    (S_loc, L) = (2^19, 84) block: K6 as the time-sharded sketch launches
    it (the block @ its (L, d r) segment of 18's unfused sketch, N 220),
    K3 as ``_hankel_project_grid`` (the block against Q' (S_loc, d r), the
    rank's sketch Y side by side), K5 on that Y (d S_loc, r), the
    ``hankel_randomized_svd_2d`` TSQR leaf's Gram, and on its first
    (S_loc, r) rows, the ``randomized_svd_2d`` leaf's shape.  Uncounted;
    returns each kernel's errors and times."""
    from dmd_era5_tpu_torch.ops.hankel import _time_segment, hankel_sketch

    d, s_loc, l_cols = SVD_MESH_D, MESH_PORTABLE_ROWS // 2, T_HOURS // 2
    rows = x[:s_loc]
    block = rows[:, :l_cols].contiguous()
    omega = svd_mesh_omegas(T_HOURS, seed)["unfused"]
    label = "18c rank 0"
    segment = _time_segment(torch.nn.functional.pad(omega, (0, 0, d - 1, d - 1)), d, l_cols, 0)
    k6 = compare_matmul(label, block, segment.contiguous(), f64_gate=True)
    y = hankel_sketch(rows, omega, d)  # (d S_loc, r): the rank's sketch summed over time
    k5 = {"hankel2d": compare_gram(label, y, "bf16_split"),
          "svd2d": compare_gram(label, y[:s_loc], "bf16_split")}
    r = omega.shape[1]
    q_wide = y.view(d, s_loc, r).transpose(0, 1).reshape(s_loc, d * r)
    del y
    k3 = compare_project(label, block, q_wide)
    del q_wide, block
    torch.cuda.empty_cache()
    times = ("ms", "plain_ms", "bound_ms", "library_ms")
    out = {"K6": {key: k6.get(key) for key in ("rel_err", "kernel_vs_f64_over_max", *times)},
           "K3": {key: k3.get(key) for key in ("C_vs_plain_over_max", "kernel_C_vs_f64_over_max",
                                                *times)}}
    for name, k in k5.items():
        out[f"K5_{name}"] = {"m": k["m"], "G_vs_f64_over_max": k["kernel_max_abs_vs_f64_over_max"],
                             **{key: k.get(key) for key in times}}
    return out


def held_svd_routes(label: str, parts: list[dict], refs: dict, bounds: dict,
                    expect: dict) -> dict:
    """Phase 18's checks on the ranks' readings of each route (``parts``,
    one dict by route a rank): s alike on every rank and held to the
    one-device run (``refs``: (s, orthonormality)), U's summed Gram,
    each rank's collective log within ``bounds`` and its launches
    ``expect`` exactly.  Returns the readings by route."""
    out = {}
    exact = refs.get("gram", (None,))[0]
    for name in parts[0]:
        rows = [p[name] for p in parts]
        s = rows[0]["s"]
        check(all(torch.equal(r["s"], s) for r in rows), f"{label} {name}: s differ across ranks")
        ref_s, ref_orth = refs[name]
        s_rel = float((s.double() - ref_s.double()).abs().max() / ref_s.double()[0])
        gram = sum(r["gram"] for r in rows)
        orth = float((gram - torch.eye(gram.shape[0], dtype=gram.dtype)).abs().max())
        largest = max(r["log"]["largest"]["space"] for r in rows)
        read = {"s_rel": s_rel, "orth": orth, "orth_one_device": ref_orth, "largest": largest,
                "seconds": [round(r["seconds"], 4) for r in rows],
                "collectives": rows[0]["log"]["by_op"]}
        if name == "tsqr":
            lo, hi = TSQR_CENTRED_FAULT["orth"]
            rel = (s.double() / exact.double() - 1).abs()
            read.update(lead6_vs_gram=float(rel[:6].max()), all_vs_gram=float(rel.max()))
            check(lo < orth <= hi, f"{label} tsqr: known fault, split CholQR2 leaf on row-"
                  f"centred X (ROADMAP Queue 3): U^T U - I max {orth:.3e} outside ({lo}, {hi}]")
            check(read["lead6_vs_gram"] <= TSQR_CENTRED_FAULT["lead6"]
                  and read["all_vs_gram"] <= 2e-3, f"{label} tsqr: s vs the Gram route {read}")
        elif name in ("fused", "exact", "gram"):
            check(s_rel <= SVD_MESH_S_TOL, f"{label} {name}: s off one device's by {s_rel:.3e} "
                  f"of s[0] > {SVD_MESH_S_TOL}")
            check(orth <= ref_orth + MESH_ORTH_SLACK, f"{label} {name}: max|U^T U - I| "
                  f"{orth:.3e} > one device's {ref_orth:.3e} + {MESH_ORTH_SLACK}")
        else:
            check(s_rel <= SVD_MESH_S_TOL, f"{label} {name}: s off one device's by {s_rel:.3e} "
                  f"of s[0] > {SVD_MESH_S_TOL}")
            check(orth <= 1e-3, f"{label} {name}: max|U^T U - I| {orth:.3e} > 1e-3")
        check(largest <= bounds[name], f"{label} {name}: a collective of {largest} elements > "
              f"{bounds[name]} (tests/test_21_comm_pattern.py)")
        for rank, r in enumerate(rows):
            check(r["launches"] == expect[name], f"{label} {name} rank {rank}: launches "
                  f"{r['launches']}, expected {expect[name]}")
        out[name] = read
    return out


def phase_svd_mesh_one_rank(week: dict, seed: int) -> tuple[dict, dict]:
    """18a: the fused sharded Hankel SVD (phase 3's sketch) and the
    sharded exact Hankel SVD on a (1, 1, 1) mesh of this process over
    NCCL, against phases 3 and 7 on the same X: s within SVD_MESH_S_TOL
    of s[0], U's leading 6 columns spanning phase 3's and 7's (cosine
    above 1 - 1e-6), launches exact.  Returns (readings, launches)."""
    import torch.distributed as dist

    from dmd_era5_tpu_torch.parallel import initialize_distributed, make_mesh

    directory = Path(tempfile.mkdtemp(prefix="dmd_era5_mesh_"))
    x = week["x"]
    launches, out = counts(), {}
    try:
        backend = initialize_distributed(f"file://{directory / 'store'}", world_size=1, rank=0)
        check(backend == "nccl", f"18a: a one-rank group on one card chose {backend}")
        mesh = make_mesh()
        omegas = svd_mesh_omegas(x.shape[1], seed)
        bounds = svd_mesh_bounds(x.shape[1])
        for name, (ref_s, ref_u6) in (("fused", (week["s_rand"], week["u6_rand"])),
                                      ("exact", (week["s_exact"], week["u6_exact"]))):
            from dmd_era5_tpu_torch.parallel.collectives import collective_log

            reset_counts()
            with collective_log() as clog:
                (u, s, _), secs = synced(svd_mesh_route, name, x, mesh, omegas, seed)
            got = launch_counts()
            check(got == SVD_MESH_LAUNCHES[name], f"18a {name}: launches {got}")
            for key, n in got.items():
                launches[key] += n
            s_rel = float((s.double() - ref_s.double()).abs().max() / ref_s.double()[0])
            cos = subspace_cos_min(u[:, :6], ref_u6)
            orth = orthonormality(u)
            del u
            check(s_rel <= SVD_MESH_S_TOL, f"18a {name}: s off one device's by {s_rel:.3e}")
            check(cos > 1 - 1e-6, f"18a {name}: leading-6 subspace cos min {cos:.9f}")
            check(orth <= 1e-3, f"18a {name}: max|U^T U - I| {orth:.3e}")
            check(clog.largest() <= bounds[name], f"18a {name}: collectives {clog.by_op()}")
            out[name] = dict(seconds=secs, s_rel=s_rel, lead6_cos=cos, orth=orth,
                             collectives=log_summary(clog))
            log(f"[18a] {name} on one rank over {backend}: {secs:.3f} s, s off one device's "
                f"{s_rel:.2e} of s[0], leading-6 cos 1 - {1 - cos:.2e}, max|U^T U - I| "
                f"{orth:.2e}, collectives {clog.by_op()}, launches {got}")
            torch.cuda.empty_cache()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(directory, ignore_errors=True)
    return out, launches


def grid_mesh_rank(x_loc: torch.Tensor, mesh, path: str, seed: int) -> dict:
    """18c on this rank's (S/2, T/2) block of the week's first
    MESH_PORTABLE_ROWS rows: ``randomized_svd_2d`` and
    ``hankel_randomized_svd_2d`` (d = 2, 18's unfused sketch), s and U's
    block Gram back; ``hankel_sketch_time_sharded`` and
    ``delay_embed_time_sharded`` held here against the rank's whole rows
    (the f64 product; the embedding bit for bit); then, after the
    launches are read, ``hankel_randomized_svd_2d`` again with the right
    halo dropped (a control: its s must miss the limit)."""
    from dmd_era5_tpu_torch.ops import hankel
    from dmd_era5_tpu_torch.ops.svd import randomized_svd_2d
    from dmd_era5_tpu_torch.parallel.collectives import collective_log

    d, k = SVD_MESH_D, SVD_MESH_K
    omega = svd_mesh_omegas(T_HOURS, seed)["unfused"]
    out, before = {}, launch_counts()
    for name, fn in (("svd2d", lambda: randomized_svd_2d(x_loc, k, mesh, seed=seed + 18)),
                     ("hankel2d", lambda: hankel.hankel_randomized_svd_2d(x_loc, d, k, mesh,
                                                                          omega=omega))):
        with collective_log() as clog:
            (u, s, _), secs = synced(fn)
        out[name] = {"s": s.cpu(), "gram": gram_f64(u).cpu(), "seconds": secs,
                     "log": log_summary(clog)}
        del u, s
        torch.cuda.empty_cache()
    per = MESH_PORTABLE_ROWS // mesh.shape["space"]
    r0, t_loc = mesh.coords["space"] * per, x_loc.shape[1]
    t0 = mesh.coords["time"] * t_loc
    rows = torch.from_numpy(np.ascontiguousarray(np.load(path, mmap_mode="r")[r0:r0 + per]))
    rows = rows.cuda()
    with collective_log() as clog:
        y, secs = synced(hankel.hankel_sketch_time_sharded, x_loc, omega, d, mesh)
    w = hankel.stacked_sketch_matrix(omega.double(), d, T_HOURS)
    y_ref = (rows.double() @ w).view(per, d, -1).transpose(0, 1).reshape(d * per, -1)
    err = float((y.double() - y_ref).abs().max() / y_ref.abs().max())
    out["sketch"] = {"err": err, "seconds": secs, "log": log_summary(clog)}
    del y, y_ref
    with collective_log() as clog:
        emb, secs = synced(hankel.delay_embed_time_sharded, x_loc, d, mesh)
    want = torch.zeros_like(emb)
    for j in range(d):  # block j at global column t holds X[:, t - (d - 1) + j]
        lo = max(0, d - 1 - j - t0)
        want[j * per:(j + 1) * per, lo:] = rows[:, t0 + lo - (d - 1) + j:t0 + t_loc - (d - 1) + j]
    out["embed"] = {"equal": bool(torch.equal(emb, want)), "seconds": secs,
                    "log": log_summary(clog)}
    del emb, want, rows
    after = launch_counts()
    out["launches"] = {key: after[key] - before[key] for key in after}

    def dropped_halo(c, axis_name, mesh_, halo, axis):  # the neighbour's columns never arrive
        return torch.nn.functional.pad(c, (0, halo))

    # the control, uncounted: hankel2d with the projection's right halo dropped
    saved = hankel.halo_exchange_right
    hankel.halo_exchange_right = dropped_halo
    try:
        (u, s, _), secs = synced(hankel.hankel_randomized_svd_2d, x_loc, d, k, mesh, omega=omega)
    finally:
        hankel.halo_exchange_right = saved
    out["halo_dropped"] = {"s": s.cpu(), "seconds": secs}
    del u, s
    torch.cuda.empty_cache()
    return out


def stage_mesh_routes(seed: int) -> dict:
    """18d's config 1 (config.ini's [era5-svd] on the mock, mesh_shape
    from the caller's world: space=2 over 2 ranks, auto for one process)
    by STAGE_MESH_ROUTES: ``era5_svd.main`` with the files, the slice
    staged first by the one-device run (the global numpy state seeded)
    under the stage root the ranks inherit.  Returns each route's factors,
    backend, X, seconds and launches."""
    import torch.distributed as dist

    from dmd_era5_tpu_torch.core import config_parser
    from dmd_era5_tpu_torch.pipeline import era5_download, era5_svd

    meshed = dist.is_initialized()
    if not meshed:  # the one-device run stages the slice the ranks read
        from dmd_era5_tpu_torch.utils.io_h5 import save_fieldset

        np.random.seed(seed)
        dl = config_parser(stage_config("era5-download"), "era5-download")
        save_fieldset(era5_download.download_era5_data(dl, use_mock_data=True), dl["save_path"])
    out = {}
    for name, overrides in STAGE_MESH_ROUTES:
        cfg = stage_config("era5-svd", source_path="mock_data",
                           mesh_shape="space=2" if meshed else "auto", **overrides)
        before = launch_counts()
        t0 = time.perf_counter()
        res = era5_svd.main(dict(cfg), write_artifact=False)[0]
        torch.cuda.synchronize()
        after = launch_counts()
        out[name] = {"u": np.asarray(res["U"].values), "s": np.asarray(res["s"].values),
                     "x": np.asarray(res["X"].values), "backend": res.attrs["svd_backend"],
                     "svd_seconds": res.attrs["svd_seconds"], "wall": time.perf_counter() - t0,
                     "launches": {key: after[key] - before[key] for key in after}}
    return out


def held_stage_routes(ranks: list[dict], ref: dict) -> dict:
    """18d's checks: each route's U and s alike on both ranks, U^T U to
    1e-3, s at most the f64 s of the stage's X (1 + 1e-4, as 12a), the
    launches of a rank those of the one-device run; s held to one
    device's: the standard route's within 1e-4 (tests/test_20_svd_backends.py:154),
    the inmem route's within 1e-3 (the same sketch; tests/test_03_svd.py:265).
    The randomized route's sketch (k + 10 columns, the JAX sharded
    default) is narrower than the one-device fused SVD's (k + 28) and the
    same as the inmem route's (drawn alike from seed 0), whose subspace
    iteration it is: its s within 1e-3 of the one-device inmem route's."""
    out = {}
    for name, _ in STAGE_MESH_ROUTES:
        got, one = ranks[0]["stage"][name], ref[name]
        for r in ranks[1:]:
            check(np.array_equal(np.asarray(r["stage"][name]["u"]), np.asarray(got["u"]))
                  and np.array_equal(np.asarray(r["stage"][name]["s"]), np.asarray(got["s"])),
                  f"18d {name}: the ranks' U or s differ")
        want = {"randomized": "hankel", "standard": "hankel", "inmem": "inmem"}[name]
        check(got["backend"] == want == one["backend"],
              f"18d {name}: backend {got['backend']} (one device {one['backend']}), want {want}")
        s = np.asarray(got["s"], dtype=np.float64)
        held = np.asarray((ref["inmem"] if name == "randomized" else one)["s"], dtype=np.float64)
        s_f64 = np.linalg.svd(np.asarray(got["x"], dtype=np.float64), compute_uv=False)[: len(s)]
        u = np.asarray(got["u"], dtype=np.float64)
        orth = float(np.abs(u.T @ u - np.eye(u.shape[1])).max())
        ratio = s / s_f64
        read = {"s_rel_held": float(np.abs(s / held - 1).max()),
                "ratio_f64": (float(ratio.min()), float(ratio.max())),
                "ratio_f64_one_device": (float((one["s"] / s_f64).min()),
                                         float((one["s"] / s_f64).max())),
                "orth": orth, "svd_seconds": [r["stage"][name]["svd_seconds"] for r in ranks],
                "wall": [round(r["stage"][name]["wall"], 3) for r in ranks],
                "one_device_svd_seconds": one["svd_seconds"], "launches": got["launches"]}
        check(orth <= 1e-3, f"18d {name}: max|U^T U - I| {orth:.3e} > 1e-3")
        check(float(ratio.max()) <= 1 + 1e-4, f"18d {name}: s above the f64 s of X {read}")
        for rank, r in enumerate(ranks):
            check(r["stage"][name]["launches"] == one["launches"],
                  f"18d {name} rank {rank}: launches {r['stage'][name]['launches']}, one "
                  f"device {one['launches']}")
        limit = 1e-4 if name == "standard" else 1e-3
        check(read["s_rel_held"] <= limit, f"18d {name}: s off one device's by "
              f"{read['s_rel_held']:.3e} > {limit}")
        out[name] = read
    return out


def grid_mesh_refs(x: torch.Tensor, seed: int) -> dict:
    """18c's one-device references on the week's first MESH_PORTABLE_ROWS
    rows, on the same sketches (uncounted): the randomized SVD (18c's
    seed) and the unfused Hankel SVD at d = 2 (18's unfused sketch)."""
    from dmd_era5_tpu_torch.ops.hankel import hankel_randomized_svd
    from dmd_era5_tpu_torch.ops.svd import randomized_svd

    cut = x[:MESH_PORTABLE_ROWS]
    omega = svd_mesh_omegas(x.shape[1], seed)["unfused"]
    out = {}
    for name, fn in (("svd2d", lambda: randomized_svd(cut, SVD_MESH_K, seed=seed + 18)),
                     ("hankel2d", lambda: hankel_randomized_svd(cut, SVD_MESH_D, SVD_MESH_K,
                                                                omega=omega))):
        u, s, _ = fn()
        out[name] = (s.cpu(), orthonormality(u))
        del u, s
    torch.cuda.empty_cache()
    return out


def held_grid_ranks(ranks: list[dict], refs: dict) -> dict:
    """18c's checks: the grid SVDs' s alike on every rank and within
    SVD_MESH_S_TOL of s[0] of one device's on the same rows and sketch
    (the halo-dropped control's outside it), U's
    Gram summed over the space ranks (U is alike across time) within
    1e-3 of I; the time-sharded sketch within SVD_MESH_S_TOL of the f64
    product (of its max), the embedding bit for bit; the collectives of
    tests/test_21_comm_pattern.py:91,123 (only the sketch's (d S_loc, r)
    sum over time scales with rows) and the launches exactly."""
    s_loc, r, d = MESH_PORTABLE_ROWS // 2, SVD_MESH_K + 10, SVD_MESH_D
    bounds = {"svd2d": s_loc * r, "hankel2d": d * s_loc * r, "sketch": d * s_loc * r,
              "embed": s_loc * (d - 1)}
    out = {}
    for name in ("svd2d", "hankel2d"):
        rows = [res["grid"][name] for res in ranks]
        s = rows[0]["s"]
        check(all(torch.equal(row["s"], s) for row in rows), f"18c {name}: s differ across ranks")
        ref_s, ref_orth = refs[name]
        s_rel = float((s.double() - ref_s.double()).abs().max() / ref_s.double()[0])
        gram = sum(row["gram"] for row, res in zip(rows, ranks) if res["coords"]["time"] == 0)
        orth = float((gram - torch.eye(gram.shape[0], dtype=gram.dtype)).abs().max())
        check(s_rel <= SVD_MESH_S_TOL, f"18c {name}: s off one device's by {s_rel:.3e} of s[0] "
              f"> {SVD_MESH_S_TOL}")
        check(orth <= 1e-3, f"18c {name}: max|U^T U - I| {orth:.3e} > 1e-3")
        out[name] = {"s_rel": s_rel, "orth": orth, "orth_one_device": ref_orth,
                     "seconds": [round(row["seconds"], 3) for row in rows]}
    ref_s = refs["hankel2d"][0].double()
    dropped = max(float((res["grid"]["halo_dropped"]["s"].double() - ref_s).abs().max() / ref_s[0])
                  for res in ranks)
    check(dropped > SVD_MESH_S_TOL, f"18c control: hankel2d with its right halo dropped reads "
          f"s off by {dropped:.3e} of s[0], within {SVD_MESH_S_TOL}: the limit does not tell it")
    out["halo_dropped_s_rel"] = dropped
    for rank, res in enumerate(ranks):
        grid = res["grid"]
        check(grid["sketch"]["err"] <= SVD_MESH_S_TOL,
              f"18c rank {rank}: time-sharded sketch off the f64 product by {grid['sketch']['err']:.3e}")
        check(grid["embed"]["equal"], f"18c rank {rank}: the time-sharded embedding differs")
        for name, bound_ in bounds.items():
            largest = grid[name]["log"]["largest"]
            check(max(largest.values()) <= bound_,
                  f"18c rank {rank} {name}: collectives {grid[name]['log']} over {bound_}")
        check(grid["launches"] == SVD_GRID_LAUNCHES,
              f"18c rank {rank}: launches {grid['launches']}, expected {SVD_GRID_LAUNCHES}")
    out["sketch_err"] = max(res["grid"]["sketch"]["err"] for res in ranks)
    out["rank_s"] = [round(res["times"]["grid_18c"], 3) for res in ranks]
    out["peak_gb"] = [round(res["peak_gb_18c"], 3) for res in ranks]
    out["collectives"] = {name: ranks[0]["grid"][name]["log"]["by_op"]
                          for name in ("svd2d", "hankel2d", "sketch", "embed")}
    return out


# phase 19: the DMD models on the mesh, riding in 17's worlds: 19a (P = 3)
# and 19b (P = 2) the ensemble over data=P, 19b the bag over data=2 and 19c
# (P = 3) DMDc over the world's space=3, both on the ranks' own 18b fused
# Hankel SVD, U made whole on each rank's card (``whole_u``); 19d (17c's 4 ranks)
# config 1 through the stage's compute body and fit on data=2,space=2.
# Each part's one-device reference is computed first in this process,
# uncounted (``models_mesh_refs``, ``stage_models_fit``).  The ensemble is
# held to the same ensemble on a (1, 1, 1) mesh of this process: the same
# algebra, where the mesh-free loop's ``fit_step_fused`` takes s from an
# f32 eigh of B B^T (~2e-5 of s[0] off at the noise floor, phase 14f's
# FIT_STEP_EIGH_SLACK); the data split changes the batches of the small
# algebra, and so its roundoff (s 5.4e-6 of s[0] apart on an H100), which
# moves the noise-floor components of V: not only among themselves, as
# the top-100 boundary lies inside the noise floor, so all of a_red's
# eigenvalues are read but not held (0.85 apart on an H100, as far as
# two members' are).  a_red is held through the eigenvalues of its
# leading 6 x 6 block (the planted dynamics' regression) and against its
# recompute from the member's own gathered s and V in the ranks'
# batches; U by its orthonormality and each member's leading-6 span
# against the reference's (whose leading columns go to the ranks in a
# file beside the artifact).  Each gate's reading with members 0 and 1
# swapped is logged beside it: the members share their planted
# dynamics, so s, the span and the recompute tell them apart, the
# eigenvalues do not.  The bag (tests/test_23_bopdmd.py :141-147's tolerances)
# and DMDc are held to one device's on phase 3's sketch: their fits see
# only S V, and the factors are ~1.7e-6 of s[0] apart (18b); DMDc's
# discrete eigenvalues within DMDC_GRAM_ROUTE_GAP (its Gram route's known
# ridge choice, R5), a_red and b_red through b^T b and b^T a b, which a
# rotation of the output basis leaves alone, within MODELS_INVARIANT_TOL.
MODELS_OMEGA_SEED = 19
MODELS_S_TOL = 1e-5  # a member's s against one device's, of its s[0]
BAG_EIG_ATOL, BAG_AMP_RTOL = 1e-5, 1e-4
MODELS_INVARIANT_TOL = 1e-2
MODELS_SPAN_TOL = 1e-6  # a member's leading-6 U span: 1 - cos min, 18a's limit
MODELS_A_REC_TOL = 1e-6  # a_red against its recompute from s and V, of max|a_red|
MODELS_MESH = "data=2,space=2"  # 19d's mesh
MODELS_MESH_AXES = {axis: int(n) for axis, n in (part.split("=") for part in MODELS_MESH.split(","))}
U_LEAD_FILE, LM_WITNESS_FILE = "u_lead_19.npy", "lm_witness_19d.pt"  # beside the artifact
# 19d's slice: config 1's mock fields replaced by three damped travelling
# waves (rank 6, config 1's dmd_rank; frequency 1/h, damping 1/h,
# wavenumber) under 0.1% noise, as the CPU tests plant test_11's slice:
# on the mock's i.i.d. noise the LM fits chase noise, and the card's
# batched products round a batch of 4 trials (a rank's share of the
# bag) otherwise than one of 8, so the fits stop elsewhere.  Both are
# witnessed on one device (``lm_witness``): the bag on config 1's own
# mock solved as one batch and in the ranks' blocks, and 19d's ranks
# solve the same trials on the mesh, held to the blocks' run; 19d's bag
# is held to the one-device fit on its own factors both ways
PLANTED_WAVES = ((0.35, 0.005, 1), (0.8, 0.02, 3), (0.15, 0.01, 2))
# each part's launches a rank (19d's one-device fit on the ranks' factors
# apart, uncounted); 19b's ensemble takes no DMD solve (19a's does)
MODELS_LAUNCHES = {"19a": counts(K1=5), "19b_ensemble": counts(K1=8), "19b_bag": counts(K1=5),
                   "19c": counts(K1=5 + 2, K4=2), "19d": counts(K1=5 + 2, K4=2)}


def week_times() -> np.ndarray:
    """The week's hourly stamps (config 3's window)."""
    start = np.datetime64(WEEK_CONFIG["start_datetime"], "ns")
    return start + np.arange(T_HOURS) * np.timedelta64(1, "h")


def week_members(x):
    """The week's X (S, T) as the ensemble's FieldSet: one (level,
    latitude, longitude, time) field a variable, views of x's rows
    (``make_era5``'s order: variable, level, latitude, longitude), x a
    tensor or a memmap (a rank then reads only its members' rows)."""
    from dmd_era5_tpu_torch.utils.labels import Coord, Field, FieldSet

    coords = {"level": Coord("level", np.asarray(LEVELS)),
              "latitude": Coord("latitude", 90.0 - 0.25 * np.arange(N_LAT)),
              "longitude": Coord("longitude", 0.25 * np.arange(N_LON)),
              "time": Coord("time", week_times())}
    block = len(LEVELS) * N_LAT * N_LON
    return FieldSet({var: Field(x[i * block:(i + 1) * block].reshape(len(LEVELS), N_LAT, N_LON,
                                                                     x.shape[1]),
                                ("level", "latitude", "longitude", "time"), coords, name=var)
                     for i, var in enumerate(WEEK_VARIABLES)})


def models_omega(seed: int) -> torch.Tensor:
    """The ensemble's sketch (T x 110: k + the default 10), alike in every
    process from its seed."""
    gen = torch.Generator(device="cuda").manual_seed(seed + MODELS_OMEGA_SEED)
    return torch.randn((T_HOURS, SVD_MESH_K + 10), generator=gen, device="cuda")


def week_control() -> torch.Tensor:
    """The diurnal series at the embedded week's transitions (q = 2, T - d)."""
    from dmd_era5_tpu_torch.pipeline.era5_dmd import _control_series

    return torch.from_numpy(_control_series("diurnal", week_times()[SVD_MESH_D - 1:])).cuda()


def whole_u(u_loc: torch.Tensor, mesh, rows: int, path: Path) -> torch.Tensor:
    """The whole (d S, k) U of the ranks' interleaved blocks on this
    rank's card, delay-major, the padding cut, through the page cache:
    every rank writes its rows of each delay block into one raw f32 file
    at ``path`` (rank 0 sizes it), then reads all of it through a pinned
    buffer, a chunk of rows at a time.  Gloo's host path moves ~0.5 GB/s
    on the card's machine (23.3 s a rank for this U, all-gathered 25
    columns at a time), a memmap of the file 13.5-18.5 s (its page faults
    and pageable copies)."""
    import torch.distributed as dist

    from dmd_era5_tpu_torch.parallel.sharding import row_block

    d, k = SVD_MESH_D, u_loc.shape[1]
    s_loc, row_bytes = u_loc.shape[0] // d, 4 * k
    if dist.get_rank() == 0:
        with open(path, "wb") as f:
            f.truncate(d * rows * row_bytes)
    dist.barrier()
    r0, r1, _ = row_block(rows, mesh.shape["space"], mesh.coords["space"])
    with open(path, "r+b") as f:
        for j in range(d):
            f.seek((j * rows + r0) * row_bytes)
            f.write(u_loc[j * s_loc : j * s_loc + r1 - r0].cpu().numpy())
    dist.barrier()
    out = torch.empty((d * rows, k), dtype=torch.float32, device=u_loc.device)
    buf = torch.empty((CHUNK, k), dtype=torch.float32, pin_memory=True)
    with open(path, "rb") as f:
        for c0 in range(0, d * rows, CHUNK):
            n = min(CHUNK, d * rows - c0)
            check(f.readinto(memoryview(buf[:n].numpy()).cast("B")) == n * row_bytes,
                  f"whole_u: a short read of {path}")
            out[c0 : c0 + n].copy_(buf[:n])
    del buf
    dist.barrier()
    if dist.get_rank() == 0:
        path.unlink()
    return out


def dmdc_invariants(res) -> dict:
    """DMDc's discrete eigenvalues and b^T b, b^T a b (q x q): a rotation
    of the output basis (a_red -> R^T a R, b_red -> R^T b) leaves them."""
    a, b = res.a_red.double().cpu(), res.b_red.double().cpu()
    return {"eigenvalues": res.eigenvalues.cpu(), "btb": b.T @ b, "btab": b.T @ a @ b}


def held_dmdc(label: str, got: dict, ref: dict) -> dict:
    """DMDc's eigenvalues within DMDC_GRAM_ROUTE_GAP and its invariants
    within MODELS_INVARIANT_TOL (relative Frobenius) of ref's."""
    err = matched_eig_error(got["eigenvalues"].to(torch.complex128),
                            ref["eigenvalues"].to(torch.complex128))
    inv = {key: float((got[key] - ref[key]).norm() / ref[key].norm()) for key in ("btb", "btab")}
    check(err <= DMDC_GRAM_ROUTE_GAP, f"{label}: DMDc eigenvalues off one device's by {err:.3e}")
    check(max(inv.values()) <= MODELS_INVARIANT_TOL,
          f"{label}: DMDc's b^T b, b^T a b off one device's by {inv}")
    return {"eig_err": err, **{f"{key}_rel": value for key, value in inv.items()}}


def held_bag(label: str, got: dict, ref: dict) -> dict:
    """The bag's trial-mean eigenvalues within BAG_EIG_ATOL of ref's as
    matched sets, its amplitudes (matched the same way) within
    BAG_AMP_RTOL, the trials used equal."""
    err = matched_eig_error(got["eigenvalues"], ref["eigenvalues"])
    found, want = got["eigenvalues"].numpy(), ref["eigenvalues"].numpy()
    order = [int(np.argmin(np.abs(found - w))) for w in want]
    amp = float(np.abs(got["amplitudes"].numpy()[order] / ref["amplitudes"].numpy() - 1).max())
    check(err <= BAG_EIG_ATOL and amp <= BAG_AMP_RTOL and got["used"] == ref["used"],
          f"{label}: bag off one device's: eigenvalues {err:.3e}, amplitudes {amp:.3e}, "
          f"trials used {got['used']} vs {ref['used']}")
    return {"eig_err": err, "amp_rel": amp, "used": got["used"]}


def a_red_in_batches(st, n_data: int) -> torch.Tensor:
    """Each member's a_red recomputed from its own s and V by the step's
    ``_reduced_operator``, in the batches that a data axis of ``n_data``
    ranks ran it in (zero members padding the last, as in the step)."""
    from dmd_era5_tpu_torch.pipeline.train_step import _reduced_operator

    n = st.s.shape[0]
    per = -(-n // n_data)
    s, v = (torch.cat([a, a.new_zeros((per * n_data - n, *a.shape[1:]))]) for a in (st.s, st.v))
    return torch.cat([_reduced_operator(s[i * per:(i + 1) * per], v[i * per:(i + 1) * per])
                      for i in range(n_data)])[:n]


def ensemble_readings(fit, n_data: int, u_ref_lead: torch.Tensor | None = None) -> dict:
    """An ensemble's s, the eigenvalues of each member's a_red (all, and
    its leading 6 x 6 block's), a_red against its recompute from the
    member's own s and V in the ranks' batches (``a_red_in_batches``;
    largest |difference| over max|a_red|), the loss, the labels and U's
    orthonormality as 17a reads it (the leading 6 columns' and all
    100's, the worst member's).  Given the reference's leading 6 columns
    of U (B, S, 6): each member's leading-6 span against its own
    (``subspace_cos_min``, the least).  The recompute's and the span's
    readings also with members 0 and 1 swapped, a planted gather fault
    (member 1's against member 0's)."""
    lead = len(PAIRS) * 2
    st = fit.state
    a_rec = a_red_in_batches(st, n_data)
    a_max = float(st.a_red.abs().max())
    orth_lead = orth_all = 0.0
    for u in st.u:
        dev = (gram_f64(u) - torch.eye(u.shape[1], dtype=torch.float64, device=u.device)).abs()
        orth_lead = max(orth_lead, float(dev[:lead, :lead].max()))
        orth_all = max(orth_all, float(dev.max()))
    out = {"s": st.s.cpu(), "a_eig": torch.linalg.eigvals(st.a_red.double()).cpu(),
           "a_lead_eig": torch.linalg.eigvals(st.a_red[:, :lead, :lead].double()).cpu(),
           "a_rec": float((st.a_red - a_rec).abs().max()) / a_max,
           "a_rec_swapped": float((st.a_red[1] - a_rec[0]).abs().max()) / a_max,
           "loss": float(st.loss), "labels": fit.labels, "orth_lead": orth_lead,
           "orth_all": orth_all, "u_shape": tuple(st.u.shape)}
    if u_ref_lead is not None:
        out["u_span"] = min(subspace_cos_min(u[:, :lead], ref) for u, ref in zip(st.u, u_ref_lead))
        out["u_span_swapped"] = subspace_cos_min(st.u[1, :, :lead], u_ref_lead[0])
    return out


def kernel_readings(kernels: dict) -> dict:
    """Each compare_kernel / compare_gram result's errors and times."""
    return {name: {key: k.get(key) for key in (
        "m", "n", "k", "rel_err", "kernel_rel_vs_f64", "kernel_G_vs_f64", "kernel_C_vs_f64",
        "ms", "plain_ms", "bound_ms", "library_ms")} for name, k in kernels.items()}


def dmdc_kernels_vs_plain(label: str, z: torch.Tensor, u_ctrl: torch.Tensor, rank: int,
                          rank_omega: int, n_space: int) -> dict:
    """K4 and K1 against their plain versions on rank 0's row blocks of
    DMDc's two Gram-route SVDs over space=n_space (``models.dmdc``):
    [Z1; gamma U] (k + q rows, ``rank_omega`` components) and Z2 (k rows,
    ``rank``), each zero-padded to a multiple of n_space as ``shard_rows``
    pads it; K1 uncentred on V_k of the whole matrix's f64 Gram, as wide
    as ``ops.svd._lane_width`` makes it.  Uncounted."""
    from dmd_era5_tpu_torch.ops.svd import _lane_width
    from dmd_era5_tpu_torch.parallel.sharding import row_block

    x1, x2 = z[:, :-1], z[:, 1:]
    gamma = torch.sqrt(torch.mean(x1 * x1)) / torch.sqrt(torch.mean(u_ctrl * u_ctrl))
    out = {}
    for name, a, k in (("stack", torch.cat([x1, gamma * u_ctrl]), rank_omega), ("z2", x2, rank)):
        r0, r1, per = row_block(a.shape[0], n_space, 0)
        block = torch.zeros((per, a.shape[1]), dtype=torch.float32, device=a.device)
        block[: r1 - r0] = a[r0:r1]
        _, vecs = torch.linalg.eigh(gram_f64(a))
        v_k = vecs.flip(-1)[:, :_lane_width(k, a.shape[1])].float().contiguous()
        out[f"K4_{name}"] = compare_gram(f"{label} {name} rank 0", block, "highest")
        out[f"K1_{name}"] = compare_kernel(f"{label} {name} rank 0", block, v_k, torch.float32,
                                           center=False)
    return out


def models_mesh_refs(week: dict, seed: int, directory: Path) -> dict:
    """Phase 19's one-device references in this process, uncounted: the
    ensemble of the week's 15 members on a (1, 1, 1) mesh (19a-b; its U's
    leading 6 columns written to ``directory`` for the ranks), the fused
    Hankel SVD on phase 3's sketch with the bag (19b) and DMDc (19c) on
    it; and K1 and K4 against their plain versions at the shapes a rank
    gives them: K1 on a member (1,038,240 x 168, N 110, centring: the
    ensemble's step), and DMDc's K4 and K1 on rank 0's row blocks at
    P = 3 (``dmdc_kernels_vs_plain``: 34 of [Z1; gamma U]'s 102 rows, 34
    of Z2's 100 padded to 102)."""
    from dmd_era5_tpu_torch.models import bopdmd_from_svd, dmdc_from_svd
    from dmd_era5_tpu_torch.ops.hankel import hankel_randomized_svd_fused_core
    from dmd_era5_tpu_torch.parallel import single_device_mesh
    from dmd_era5_tpu_torch.pipeline import fit_per_variable_level

    x = week["x"]
    out, times = {"alpha_true": week["alpha_true"].cpu()}, {}
    omega = models_omega(seed)
    fit, times["ensemble"] = synced(fit_per_variable_level, week_members(x), SVD_MESH_K,
                                    mesh=single_device_mesh("cuda"), omega=omega,
                                    solve_dmd=True, dmd_rank=DMD_RANK)
    out["ensemble"] = {**ensemble_readings(fit, 1), "alpha": fit.dmd.alpha.cpu()}
    np.save(directory / U_LEAD_FILE, fit.state.u[:, :, : len(PAIRS) * 2].cpu().numpy())
    del fit
    torch.cuda.empty_cache()
    omegas = svd_mesh_omegas(x.shape[1], seed)
    (u, s, v), times["fused_svd"] = synced(hankel_randomized_svd_fused_core, x, SVD_MESH_D,
                                           SVD_MESH_K, omegas["fused"], torch.float32)
    t = torch.arange(v.shape[1], dtype=torch.float32, device="cuda")
    bag, times["bag"] = synced(bopdmd_from_svd, u, s, v, t, rank=DMD_RANK, n_trials=BAG_TRIALS,
                               trial_fraction=BAG_FRACTION)
    out["bag"] = {"eigenvalues": bag.eigenvalues.cpu(), "amplitudes": bag.amplitudes.cpu(),
                  "used": len(bag.trial_eigenvalues)}
    del bag
    u_ctrl = week_control()
    dmdc, times["dmdc"] = synced(dmdc_from_svd, u, s, v, u_ctrl, rank=DMD_RANK, dt=1.0)
    out["dmdc"] = dmdc_invariants(dmdc)
    del dmdc, u
    torch.cuda.empty_cache()
    # the kernels at a rank's shapes
    block = len(LEVELS) * N_LAT * N_LON // len(LEVELS)
    kernels = {"K1_member": compare_kernel("19a member", x[:block], omega, torch.float32,
                                           centred=True)}
    kernels.update(dmdc_kernels_vs_plain("19c DMDc", s[:, None] * v, u_ctrl, DMD_RANK,
                                         DMD_RANK + u_ctrl.shape[0], 3))
    out["kernels"] = kernel_readings(kernels)
    out["times"] = times
    torch.cuda.empty_cache()
    return out


def models_mesh_rank(x_loc: torch.Tensor, mesh, world: int, path: str, seed: int) -> dict:
    """Phase 19 in a fused world, on this rank: the ensemble over
    data=P from the artifact's members (19a at P = 3, 19b at P = 2), then
    on the rank's own 18b fused Hankel SVD (K1 5), U made whole on its
    card (``whole_u``), the bag over data=2 (19b) or DMDc over the world's space=3
    (19c).  Each part's readings, seconds, peak memory, collective log
    (the bag's and DMDc's own apart) and launches."""
    from dmd_era5_tpu_torch.models import bopdmd_from_svd, dmdc_from_svd
    from dmd_era5_tpu_torch.parallel import make_mesh
    from dmd_era5_tpu_torch.parallel.collectives import collective_log
    from dmd_era5_tpu_torch.pipeline import fit_per_variable_level

    out = {}
    data_mesh = make_mesh(f"data={world}")

    def part(name, fn):
        before = launch_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with collective_log() as clog:
            res, secs = synced(fn)
        res.update(seconds=secs, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   log=log_summary(clog), launches=_minus(launch_counts(), before))
        out[name] = res

    def ensemble():
        from dmd_era5_tpu_torch.pipeline import ensemble as ens

        fs = week_members(np.load(path, mmap_mode="r"))
        solve = world == 3
        with stage_clock(ens, "_local_members", "fit_step", "_whole_state",
                         "optdmd_from_svd_batched") as clock:
            fit = fit_per_variable_level(fs, SVD_MESH_K, mesh=data_mesh, omega=models_omega(seed),
                                         solve_dmd=solve, dmd_rank=DMD_RANK)
        steps = {"read": clock["_local_members"], "step": clock["fit_step"],
                 "gather": clock["_whole_state"], "lm": clock["optdmd_from_svd_batched"]}
        u_ref_lead = torch.from_numpy(np.load(Path(path).parent / U_LEAD_FILE)).cuda()
        return {**ensemble_readings(fit, world, u_ref_lead),
                **({"alpha": fit.dmd.alpha.cpu()} if solve else {}),
                "steps": {key: round(sum(v), 3) for key, v in steps.items()}}

    part("19a" if world == 3 else "19b_ensemble", ensemble)
    rows = N_BLOCKS * N_LAT * N_LON
    omegas = svd_mesh_omegas(x_loc.shape[1], seed)

    def on_factors(fn):
        steps = {}
        (u_loc, s, v), steps["svd"] = synced(svd_mesh_route, "fused", x_loc, mesh, omegas, seed)
        u, steps["whole_u"] = synced(whole_u, u_loc, mesh, rows,
                                     Path(path).parent / "u_19.f32")
        del u_loc
        with collective_log() as own:
            res, steps["fit"] = synced(fn, u, s, v)
        return {**res, "own_log": log_summary(own), "s_factors": s.cpu(),
                "steps": {key: round(v, 3) for key, v in steps.items()}}

    def bag(u, s, v):
        t = torch.arange(v.shape[1], dtype=torch.float32, device="cuda")
        res = bopdmd_from_svd(u, s, v, t, rank=DMD_RANK, n_trials=BAG_TRIALS,
                              trial_fraction=BAG_FRACTION, mesh=data_mesh)
        return {"eigenvalues": res.eigenvalues.cpu(), "amplitudes": res.amplitudes.cpu(),
                "used": len(res.trial_eigenvalues),
                "modes_finite": bool(torch.isfinite(res.modes).all())}

    def dmdc(u, s, v):
        res = dmdc_from_svd(u, s, v, week_control(), rank=DMD_RANK, dt=1.0, mesh=mesh)
        norms = torch.linalg.vector_norm(res.modes, dim=0)
        return {**dmdc_invariants(res), "modes_unit": float((norms - 1).abs().max())}

    if world == 2:
        part("19b_bag", lambda: on_factors(bag))
    else:
        part("19c", lambda: on_factors(dmdc))
    torch.cuda.empty_cache()
    return out


def stage_models_config(meshed: bool) -> tuple[dict, dict]:
    """19d's config 1: config.ini's [era5-svd] (raw, for ``era5_svd.main``)
    and [era5-dmd] (parsed) on the mock, the DMD fit bagged (BAG_TRIALS)
    with the diurnal control, the mesh MODELS_MESH over 17c's ranks; for
    one device the SVD's ``inmem`` route, whose sketch (k + 10 columns
    from seed 0) is the meshed Hankel route's (18d)."""
    from dmd_era5_tpu_torch.core import config_parser

    extra = {"mesh_shape": MODELS_MESH} if meshed else {"svd_backend": "inmem"}
    svd = stage_config("era5-svd", source_path="mock_data", **extra)
    dmd = config_parser(stage_config("era5-dmd", source_path="mock_data", bagging_trials=BAG_TRIALS,
                                     control_input="diurnal", **extra), "era5-dmd")
    return svd, dmd


def planted_slice(fs, seed: int):
    """19d's slice: each field of config 1's mock slice replaced by
    250 + 10 x (PLANTED_WAVES' damped travelling waves, each
    cos(lat) cos(phase) + sin(2 lat) sin(phase), phase = f t - k lon)
    plus 0.01 of standard normal noise drawn from ``seed``."""
    t = np.arange(fs.sizes["time"], dtype=np.float64)
    lat = np.deg2rad(fs.coord("latitude").values.astype(np.float64))[:, None]
    lon = np.deg2rad(fs.coord("longitude").values.astype(np.float64))[None, :]
    rng = np.random.default_rng(seed)
    for name in fs.variables:
        field = fs[name].transpose("time", "level", "latitude", "longitude")
        sig = np.zeros(field.shape)
        for freq, damp, klon in PLANTED_WAVES:
            phase = freq * t[:, None, None] - klon * lon[None]
            pattern = np.cos(lat)[None] * np.cos(phase) + np.sin(2 * lat)[None] * np.sin(phase)
            sig += (np.exp(-damp * t)[:, None, None] * pattern)[:, None]
        data = 250.0 + 10.0 * sig + 0.01 * rng.standard_normal(sig.shape)
        fs.data_vars[name] = field.copy(data=data.astype(np.float32))
    return fs


def stage_models_fit(mesh, seed: int, planted: bool = True) -> tuple[dict, object]:
    """19d's stage through its files: on one device (``mesh`` None)
    config 1's mock slice (the global numpy state seeded), with the
    planted waves (``planted_slice``) unless ``planted`` is False, is
    saved as the stage's slice under the stage root, which the ranks
    inherit and read; then ``era5_svd.main`` (no artifact written) and
    ``fit_dmd_from_svd_results`` on ``mesh``, each step timed.  Returns
    the readings and the SVD results."""
    from dmd_era5_tpu_torch.core import config_parser
    from dmd_era5_tpu_torch.pipeline import era5_dmd, era5_download, era5_svd
    from dmd_era5_tpu_torch.utils.io_h5 import save_fieldset

    svd_cfg, dmd_cfg = stage_models_config(mesh is not None)
    steps = {}
    if mesh is None:
        np.random.seed(seed)
        fs = era5_download.download_era5_data(
            config_parser(stage_config("era5-download"), "era5-download"), use_mock_data=True)
        if planted:
            fs = planted_slice(fs, seed)
        _, steps["slice_write"] = synced(save_fieldset, fs, config_parser(
            dict(svd_cfg), "era5-svd")["era5_slice_path"])
    with stage_clock(era5_dmd, "bopdmd_from_svd", "dmdc_from_svd", "_forecast_field") as clock:
        (svd_res, _, _), t_svd = synced(era5_svd.main, dict(svd_cfg), write_artifact=False)
        res = era5_dmd.fit_dmd_from_svd_results(svd_res, dmd_cfg, mesh=mesh)
    readings = stage_models_readings(res, svd_res)
    readings["steps"] = {"svd_main": round(t_svd, 3), **{k: round(v, 3) for k, v in steps.items()},
                         **{key: round(sum(v), 3) for key, v in clock.items()}}
    return readings, svd_res


def varpro_in_blocks(h, t, alpha0, n_blocks: int, **kwargs) -> tuple:
    """``varpro_lm_batched`` on one device in the blocks that a ``data``
    axis of ``n_blocks`` ranks solves (the members padded with copies of
    member 0, as the meshed call pads them), the blocks' results
    concatenated and the padding cut: the meshed solve without its
    gather."""
    from dmd_era5_tpu_torch.models.optdmd import varpro_lm_batched

    n = h.shape[0]
    per = -(-n // n_blocks)
    pad = per * n_blocks - n
    if t.ndim == 1:
        t = t.expand(n, -1)
    h, t, alpha0 = (torch.cat([a, a[:1].expand(pad, *a.shape[1:])]) if pad else a
                    for a in (h, t, alpha0))
    parts = [varpro_lm_batched(h[i * per:(i + 1) * per], t[i * per:(i + 1) * per],
                               alpha0[i * per:(i + 1) * per], **kwargs) for i in range(n_blocks)]
    return tuple(np.concatenate([part[j] for part in parts])[:n] for j in range(4))


@contextlib.contextmanager
def bag_lm_in_blocks(n_blocks: int):
    """The bag's batched LM (``models.bopdmd.varpro_lm_batched``) solved
    by :func:`varpro_in_blocks` over ``n_blocks`` inside the block."""
    from dmd_era5_tpu_torch.models import bopdmd as bop_mod

    saved = bop_mod.varpro_lm_batched

    def call(h, t, alpha0, mesh=None, **kwargs):
        check(mesh is None, "bag_lm_in_blocks: a meshed call")
        return varpro_in_blocks(h, t, alpha0, n_blocks, **kwargs)

    bop_mod.varpro_lm_batched = call
    try:
        yield
    finally:
        bop_mod.varpro_lm_batched = saved


def lm_gap(a: tuple, b: tuple) -> dict:
    """Two ``varpro_lm_batched`` results (alpha, B, residual, n_iters)
    trial by trial: bit for bit equal, the non-finite entries alike, the
    largest |alpha_a - alpha_b| over the finite ones, the trials whose
    step counts differ (numpy arrays or host tensors)."""
    a, b = ([np.asarray(x) for x in res] for res in (a, b))
    fin_a, fin_b = np.isfinite(a[0]), np.isfinite(b[0])
    both = fin_a & fin_b
    return {"bit_equal": all(np.array_equal(x, y, equal_nan=True) for x, y in zip(a, b)),
            "finite_alike": bool((fin_a == fin_b).all()),
            "alpha": float(np.abs(a[0][both] - b[0][both]).max()) if both.any() else 0.0,
            "iters_differ": int((a[3] != b[3]).sum())}


def lm_witness(seed: int, directory: Path) -> dict:
    """19d's witness on config 1's own mock (i.i.d. noise), one device,
    uncounted: the stage's fit with the bag's LM solved as one batch of
    BAG_TRIALS and in the blocks of MODELS_MESH's data axis
    (``bag_lm_in_blocks``), and the trials' LM alone both ways; the
    trials' LM inputs are saved to ``directory`` for 19d's ranks, which
    solve them on the mesh (``stage_models_rank``)."""
    from dmd_era5_tpu_torch.models import bopdmd as bop_mod
    from dmd_era5_tpu_torch.models.optdmd import varpro_lm_batched
    from dmd_era5_tpu_torch.pipeline import era5_dmd

    n_data = MODELS_MESH_AXES["data"]
    with first_call(bop_mod, "varpro_lm_batched") as call, stage_root():  # its own slice file
        whole, svd_res = stage_models_fit(None, seed, planted=False)
    with bag_lm_in_blocks(n_data):
        split = stage_models_readings(era5_dmd.fit_dmd_from_svd_results(
            svd_res, stage_models_config(False)[1]), svd_res)
    kwargs = {key: v for key, v in call["kwargs"].items() if key != "mesh"}
    lm_whole = varpro_lm_batched(*call["args"], **kwargs)
    lm_split = varpro_in_blocks(*call["args"], n_data, **kwargs)
    torch.save({"args": [a.cpu() for a in call["args"]], "kwargs": kwargs},
               directory / LM_WITNESS_FILE)
    return {"bag_gap": matched_eig_error(whole["bag"]["eigenvalues"], split["bag"]["eigenvalues"]),
            "used": (whole["bag"]["used"], split["bag"]["used"]),
            "lm_whole_vs_split": lm_gap(lm_whole, lm_split), "lm_split": lm_split}


def stage_models_kernels(flat: torch.Tensor, dmdc_args: tuple) -> dict:
    """19d's kernels against their plain versions at rank 0's shapes on
    MODELS_MESH (space=2), uncounted: K1 as the stage's fused Hankel pass
    launches it on the row block of config 1's flat X (its first sketch,
    stacked, uncentred, f32; 18d's randomized route runs the same pass at
    the same shape), and DMDc's K4 and K1 (``dmdc_kernels_vs_plain``) on
    Z = S V of one device's factors (the ranks' have the same shapes)."""
    from dmd_era5_tpu_torch.core import config_parser
    from dmd_era5_tpu_torch.ops.hankel import _sketch_of, stacked_sketch_matrix
    from dmd_era5_tpu_torch.parallel.sharding import row_block

    raw, dmd_cfg = stage_models_config(True)
    svd_cfg = config_parser(dict(raw), "era5-svd")
    d, k = svd_cfg["delay_embedding"], svd_cfg["n_components"]
    n_space = MODELS_MESH_AXES["space"]
    r0, r1, per = row_block(flat.shape[0], n_space, 0)
    block = torch.zeros((per, flat.shape[1]), dtype=torch.float32, device=flat.device)
    block[: r1 - r0] = flat[r0:r1]
    t = flat.shape[1]
    w = stacked_sketch_matrix(_sketch_of(block, t - d + 1, k + 10, None, 0), d, t)
    kernels = {"K1_hankel": compare_kernel("19d Hankel row block rank 0", block, w,
                                           torch.float32, centred=True, center=False)}
    del block
    s, v, u_ctrl = (torch.as_tensor(a).float().to(flat.device) for a in dmdc_args[1:4])
    rank = dmd_cfg["dmd_rank"]
    rank_omega = dmd_cfg.get("dmdc_rank_omega") or rank + u_ctrl.shape[0]
    kernels.update(dmdc_kernels_vs_plain("19d DMDc", s[:, None] * v, u_ctrl, rank, rank_omega,
                                         n_space))
    return kernel_readings(kernels)


def stage_models_readings(res, svd_res) -> dict:
    """19d's readings of a DMD FieldSet: the SVD's s, the bag's and DMDc's."""
    a = torch.from_numpy(res["dmdc_a_red"].values).double()
    b = torch.from_numpy(res["dmdc_b_red"].values).double()
    omega = torch.from_numpy(res["dmdc_eigenvalues"].values)
    return {"s": torch.from_numpy(np.asarray(svd_res["s"].values)),
            "bag": {"eigenvalues": torch.from_numpy(res["eigenvalues"].values),
                    "amplitudes": torch.from_numpy(res["amplitudes"].values),
                    "used": res.attrs["bagging_trials_used"]},
            "dmdc": {"eigenvalues": torch.exp(omega.to(torch.complex128)), "btb": b.T @ b,
                     "btab": b.T @ a @ b},
            "finite": all(bool(torch.isfinite(torch.as_tensor(res[name].data)).all())
                          for name in ("modes", "modes_std", "dmdc_modes", "forecast"))}


def stage_models_rank(seed: int, directory: Path) -> dict:
    """19d on this rank of 17c's world: config 1's stage on MODELS_MESH,
    its launches and collectives; then, uncounted, the one-device fit on
    this rank's own SVD results (the fit's reference on the same
    factors), once as one device runs it and once with the bag's LM in
    the blocks this rank's data axis solves (``bag_lm_in_blocks``); and
    the witness's i.i.d. trials (``lm_witness``) solved on the mesh."""
    from dmd_era5_tpu_torch.models.optdmd import varpro_lm_batched
    from dmd_era5_tpu_torch.parallel import make_mesh
    from dmd_era5_tpu_torch.parallel.collectives import collective_log
    from dmd_era5_tpu_torch.pipeline import era5_dmd

    mesh = make_mesh(MODELS_MESH)
    before = launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with collective_log() as clog:
        (res, svd_res), secs = synced(stage_models_fit, mesh, seed)
    res.update(seconds=secs, launches=_minus(launch_counts(), before), log=log_summary(clog),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    dmd_cfg = stage_models_config(True)[1]
    one = era5_dmd.fit_dmd_from_svd_results(svd_res, dmd_cfg)
    res["same_factors"] = stage_models_readings(one, svd_res)
    with bag_lm_in_blocks(mesh.shape["data"]):
        one = era5_dmd.fit_dmd_from_svd_results(svd_res, dmd_cfg)
    res["split_factors"] = stage_models_readings(one, svd_res)["bag"]
    witness = torch.load(directory / LM_WITNESS_FILE)
    res["iid_lm"] = varpro_lm_batched(*(a.cuda() for a in witness["args"]), **witness["kwargs"],
                                      mesh=mesh)
    return res


def held_models(ranks: list[dict], refs: dict, world: int) -> dict:
    """Phase 19's checks on a fused world's ranks: every rank's readings
    alike; the ensemble's s (of each member's s[0]) and a_red's
    leading block's eigenvalues against the (1, 1, 1) mesh's and a_red
    against its recompute from the member's s and V, its DMD eigenvalues
    as matched sets, U orthonormal (17a's leading limit, twice one
    device's reading for all columns) and each member's leading-6 span
    within MODELS_SPAN_TOL of the reference's (each reading also logged
    with members 0 and 1 swapped, a planted gather fault; all of a_red's
    eigenvalues read, not held); the bag (19b) or DMDc (19c) against one
    device's;
    the collectives (the bag's own: one gather over data; DMDc's own: the
    Gram route's psums and U's gathers over space) and launches exactly."""
    out = {}
    ens = "19a" if world == 3 else "19b_ensemble"
    ref = refs["ensemble"]
    got = ranks[0]["models"][ens]
    keys = ("s", "a_eig", "a_lead_eig") + (("alpha",) if "alpha" in got else ())
    for rank, res in enumerate(ranks):
        mine = res["models"][ens]
        check(all(torch.equal(mine[key], got[key]) for key in keys)
              and mine["labels"] == got["labels"] == ref["labels"],
              f"{ens} rank {rank}: readings differ from rank 0's")
        check(mine["u_span"] >= 1 - MODELS_SPAN_TOL,
              f"{ens} rank {rank}: a member's leading-6 U span off the reference's: cos min "
              f"{mine['u_span']:.9f}")

    def s_off(a, b):  # of each member's s[0]
        return float(((a.double() - b.double()).abs() / b.double()[..., :1]).max())

    def eig_off(a, b):
        return max(matched_eig_error(x, y) for x, y in zip(a, b))

    s_rel = s_off(got["s"], ref["s"])
    a_eig = eig_off(got["a_lead_eig"], ref["a_lead_eig"])
    a_all = eig_off(got["a_eig"], ref["a_eig"])  # read, not held: see the comment above
    eig = eig_off(got["alpha"], ref["alpha"]) if "alpha" in got else None
    check(s_rel <= MODELS_S_TOL and a_eig <= BAG_EIG_ATOL and got["a_rec"] <= MODELS_A_REC_TOL
          and (eig is None or eig <= BAG_EIG_ATOL),
          f"{ens}: off one device's ensemble: s {s_rel:.3e} of s[0], a_red's leading block's "
          f"eigenvalues {a_eig:.3e}, DMD eigenvalues {eig}; a_red off its recompute from the "
          f"member's s and V by {got['a_rec']:.3e} of max|a_red|")
    check(got["orth_lead"] <= 1e-3 and got["orth_all"] <= 2 * ref["orth_all"],
          f"{ens}: U^T U - I leading {got['orth_lead']:.3e} (1e-3, 17a's), all "
          f"{got['orth_all']:.3e} (twice one device's {ref['orth_all']:.3e})")
    # a planted fault's readings: members 0 and 1 swapped in the gather
    swapped = {"s_rel": s_off(got["s"][1], ref["s"][0]),
               "a_lead_eig_err": matched_eig_error(got["a_lead_eig"][1], ref["a_lead_eig"][0]),
               "a_eig_err": matched_eig_error(got["a_eig"][1], ref["a_eig"][0]),
               "a_rec": got["a_rec_swapped"], "u_span": got["u_span_swapped"]}
    if eig is not None:
        swapped["eig_err"] = matched_eig_error(got["alpha"][1], ref["alpha"][0])
    out[ens] = {"s_rel": s_rel, "a_lead_eig_err": a_eig, "a_eig_err": a_all, "eig_err": eig,
                "a_rec": got["a_rec"], "u_span": min(r["models"][ens]["u_span"] for r in ranks),
                "swapped": swapped, "orth_lead": (got["orth_lead"], ref["orth_lead"]),
                "orth_all": (got["orth_all"], ref["orth_all"]), "loss": got["loss"],
                "loss_one_device": ref["loss"], "u_shape": got["u_shape"],
                "steps": [r["models"][ens]["steps"] for r in ranks]}
    fit = "19b_bag" if world == 2 else "19c"
    got = ranks[0]["models"][fit]
    for rank, res in enumerate(ranks):
        mine = res["models"][fit]
        check(all(torch.equal(mine[key], got[key]) for key in mine
                  if isinstance(mine[key], torch.Tensor)),
              f"{fit} rank {rank}: readings differ from rank 0's")
    if world == 2:
        out[fit] = held_bag(fit, got, refs["bag"])
        out[fit]["planted"] = matched_eig_error(got["eigenvalues"], refs["alpha_true"])
        check(out[fit]["planted"] < 1e-2, f"{fit}: planted eigenvalues off by {out[fit]['planted']}")
        check(got["modes_finite"], f"{fit}: modes not finite")
        own = [res["models"][fit]["own_log"] for res in ranks]
        check(all(o["by_op"].keys() == {"all_gather"} and o["all_gather"] == 1
                  and o["largest"]["space"] == 0 for o in own),
              f"{fit}: the bag's collectives {own}, want one gather over data")
    else:
        out[fit] = held_dmdc(fit, got, refs["dmdc"])
        check(got["modes_unit"] < 1e-5, f"{fit}: modes not unit columns ({got['modes_unit']})")
        out[fit]["planted"] = matched_eig_error(torch.log(got["eigenvalues"].to(torch.complex128)),
                                                refs["alpha_true"].to(torch.complex128))
        check(out[fit]["planted"] < 1e-2, f"{fit}: planted eigenvalues off by {out[fit]['planted']}")
        own = [res["models"][fit]["own_log"] for res in ranks]
        check(all(o["by_op"].get("psum", {}).get("calls") == 6
                  and o["by_op"].get("all_gather", {}).get("calls") == 2
                  and len(o["by_op"]) == 2 and o["largest"]["data"] == 0 for o in own),
              f"{fit}: DMDc's collectives {own}, want 6 psums and 2 gathers over space")
    out[fit]["steps"] = [r["models"][fit]["steps"] for r in ranks]
    for name in (ens, fit):
        for rank, res in enumerate(ranks):
            check(res["models"][name]["launches"] == MODELS_LAUNCHES[name],
                  f"{name} rank {rank}: launches {res['models'][name]['launches']}, expected "
                  f"{MODELS_LAUNCHES[name]}")
        out[name].update(
            rank_s=[round(r["models"][name]["seconds"], 3) for r in ranks],
            peak_gb=[round(r["models"][name]["peak_gb"], 3) for r in ranks],
            collectives=ranks[0]["models"][name]["log"]["by_op"],
            own_collectives=ranks[0]["models"][name].get("own_log", {}).get("by_op"))
    return out


def held_stage_models(ranks: list[dict], ref: dict, witness: dict) -> dict:
    """19d's checks: every rank's readings alike; the SVD's s within
    SVD_MESH_S_TOL of s[0] of one device's ``inmem`` route on the same
    sketch (18b's limit; the planted slice's noise-floor components move
    by more than 18d's 1e-3 of their own size); the fit against the
    one-device fit on the same factors: the bag (BAG_EIG_ATOL,
    BAG_AMP_RTOL; the planted eigenvalues within 2e-3, test_11's), DMDc
    (``held_dmdc``); the bag against the one-device fit with its LM in
    the ranks' blocks, and the witness's i.i.d. trials solved on the mesh
    against the same blocks on one device (``lm_witness``), both within
    BAG_EIG_ATOL with the same step counts; the S-sized fields finite;
    the launches of a rank exactly."""
    got = ranks[0]
    for rank, res in enumerate(ranks):
        check(torch.equal(res["s"], got["s"])
              and all(torch.equal(res[p][key], got[p][key]) for p in ("bag", "dmdc")
                      for key in got[p] if isinstance(got[p][key], torch.Tensor)),
              f"19d rank {rank}: results differ from rank 0's")
        check(res["launches"] == MODELS_LAUNCHES["19d"] and res["finite"],
              f"19d rank {rank}: launches {res['launches']}, expected {MODELS_LAUNCHES['19d']}; "
              f"finite {res['finite']}")
    s_rel = float((got["s"].double() - ref["s"].double()).abs().max() / ref["s"].double()[0])
    check(s_rel <= SVD_MESH_S_TOL, f"19d: s off one device's inmem route by {s_rel:.3e} of s[0] "
          f"> {SVD_MESH_S_TOL}")
    same = got["same_factors"]
    planted = torch.tensor([complex(-damp, sign * freq) for freq, damp, _ in PLANTED_WAVES
                            for sign in (1, -1)], dtype=torch.complex64)
    err = matched_eig_error(got["bag"]["eigenvalues"], planted)
    check(err <= 2e-3, f"19d: the bag's eigenvalues off the planted waves' by {err:.3e}")
    split = held_bag("19d (the LM in the ranks' blocks)", got["bag"], got["split_factors"])
    split["bit_equal"] = all(torch.equal(got["bag"][key], got["split_factors"][key])
                             for key in ("eigenvalues", "amplitudes"))
    iid = [lm_gap(res["iid_lm"], witness["lm_split"]) for res in ranks]
    for rank, gap in enumerate(iid):
        check(gap["finite_alike"] and gap["alpha"] <= BAG_EIG_ATOL and not gap["iters_differ"],
              f"19d rank {rank}: the i.i.d. trials on the mesh off one device's blocks: {gap}")
    return {"s_rel": s_rel, "planted": err, "bag": held_bag("19d", got["bag"], same["bag"]),
            "bag_vs_split": split, "iid_mesh_vs_split": iid[0],
            "iid_witness": {key: witness[key] for key in ("bag_gap", "used", "lm_whole_vs_split")},
            "dmdc": held_dmdc("19d", got["dmdc"], same["dmdc"]),
            "bag_vs_one_device_stage": matched_eig_error(got["bag"]["eigenvalues"],
                                                         ref["bag"]["eigenvalues"]),
            "rank_s": [round(r["seconds"], 3) for r in ranks],
            "steps": [r["steps"] for r in ranks], "one_device_steps": ref["steps"],
            "peak_gb": [round(r["peak_gb"], 3) for r in ranks],
            "collectives": got["log"]["by_op"], "largest": got["log"]["largest"]}


def compare_sketch_center_gram(label: str, x: torch.Tensor, w: torch.Tensor, center: bool,
                               out_dtype: torch.dtype = torch.float32) -> tuple[dict, torch.Tensor]:
    """K2 against its plain version on the card, on the same x and w
    (both f32 or both bf16), Yc in ``out_dtype``.  Tolerances: an f32 Yc
    within 1e-5 relative Frobenius error of the plain version's, a bf16
    Yc within one bf16 ulp of it; the row sums of squares within 1e-5;
    the row sums read against sum_t |x| (x's rows are centred, so the
    sums cancel to roundoff); G exactly symmetric and within 1e-5 max|G|
    of the f64 sums of the kernel's own stored Yc, and within that plus
    the plain version's own error of the plain version.  On f32 operands
    and an f32 Yc a control, one TF32 pass (the library products X W,
    centred as the plain version centres, and Yc^T Yc of the kernel's Yc,
    with TF32 allowed, the flag restored), must miss both 1e-5 limits.
    No single library call computes this function.  The device ms of its
    two stages alone (sketch, G) go into ``K2_STAGES``, with the route
    ``ops/k2.py``'s table gives (the clusters or K1's stages); the limits
    are the same on either.  Returns the readings and the kernel's Yc."""
    from dmd_era5_tpu_torch.ops.k2 import k2_block
    from dmd_era5_tpu_torch.ops.matmul import _sketch_center_gram_plain, sketch_center_gram

    def kernel():
        return sketch_center_gram(x, w, out_dtype=out_dtype, center=center)

    def plain():
        return _sketch_center_gram_plain(x, w, out_dtype, center)

    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    check(torch.equal(got[3], got[3].T), f"{label} K2: G not exactly symmetric")
    res = dict(label=label, m=x.shape[0], t=x.shape[1], n=w.shape[1], center=center,
               dtype=str(x.dtype).replace("torch.", ""),
               out_dtype=str(out_dtype).replace("torch.", ""),
               route=k2_block(x.shape[0], x.shape[1], w.shape[1], x.dtype, out_dtype,
                              base_aligned=x.data_ptr() % 16 == 0).route)
    res["yc_rel"], res["max_abs_err"] = rel_err(got[0], ref[0])
    res["rowsum_rel"] = rel_err(got[1], ref[1], row_abs_sums(x))[0]
    res["rowsumsq_rel"] = rel_err(got[2], ref[2])[0]
    exact = gram_f64(got[0])
    scale = float(exact.abs().max())
    for who, g in (("kernel", got[3]), ("plain", ref[3])):
        res[f"{who}_G_vs_f64_over_max"] = float((g.double() - exact).abs().max()) / scale
    res["G_vs_plain_over_max"] = float((got[3].double() - ref[3].double()).abs().max()) / scale
    log(f"    {json.dumps(res)}")
    if out_dtype == torch.bfloat16:
        check(within_bf16_ulp(got[0], ref[0]), f"{label} K2: bf16 Yc beyond one ulp")
    else:
        check(res["yc_rel"] <= 1e-5, f"{label} K2: yc_rel {res['yc_rel']:.3e} > 1e-5")
    for name in ("rowsum_rel", "rowsumsq_rel"):
        check(res[name] <= 1e-5, f"{label} K2: {name} {res[name]:.3e} > 1e-5")
    check(res["kernel_G_vs_f64_over_max"] <= 1e-5,
          f"{label} K2: G vs f64 {res['kernel_G_vs_f64_over_max']:.3e} max|G| > 1e-5")
    limit = 1e-5 + res["plain_G_vs_f64_over_max"]
    check(res["G_vs_plain_over_max"] <= limit,
          f"{label} K2: G vs plain {res['G_vs_plain_over_max']:.3e} > {limit:.3e}")
    if x.dtype == out_dtype == torch.float32:
        colw = w.sum(dim=0)
        inv_t = 1.0 / x.shape[1] if center else 0.0
        y1 = tf32_mm(x, w).sub_((ref[1] * inv_t)[:, None] * colw[None, :])
        g1 = tf32_mm(got[0].T, got[0])
        res["one_tf32_pass_yc_rel"] = rel_err(y1, ref[0])[0]
        res["one_tf32_pass_G_vs_f64_over_max"] = float((g1.double() - exact).abs().max()) / scale
        del y1, g1
        log(f"    K2 {label}: one TF32 pass: yc_rel {res['one_tf32_pass_yc_rel']:.3e}, G vs f64 "
            f"{res['one_tf32_pass_G_vs_f64_over_max']:.3e} max|G|")
        for name in ("one_tf32_pass_yc_rel", "one_tf32_pass_G_vs_f64_over_max"):
            check(res[name] > 1e-5, f"{label} K2: {name} {res[name]:.3e} is within 1e-5: the "
                  "limit does not tell 3xTF32 from one TF32 pass")
    yc = got[0]
    del got, ref, exact
    p1, k1, k2, p2 = event_ms(plain), event_ms(kernel), event_ms(kernel), event_ms(plain)
    m, t, n = res["m"], res["t"], res["n"]
    # on the tensor cores: X W (2 m t n) and the symmetric half of Yc^T Yc
    # (m n (n + 1)), three TF32 passes for f32 X, one bf16 pass for bf16 X;
    # X and W read, Yc, the (m, 2) stats and G written
    bf16 = x.dtype == torch.bfloat16
    nbytes = (x.element_size() * (m * t + t * n) + yc.element_size() * m * n
              + 4 * (2 * m + n * n))
    res.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=None)
    res["bound_ms"], res["bound_by"] = bound((1 if bf16 else 3) * m * n * (2 * t + n + 1),
                                             PEAK_BF16 if bf16 else PEAK_TF32, nbytes)
    res["stage_device_ms"] = k1_stage_ms(x, w, out_dtype, dict(center=center), stages=3)
    K2_STAGES.append(dict(label=label, m=m, t=t, n=n, dtype=res["dtype"],
                          out_dtype=res["out_dtype"], route=res["route"], **res["stage_device_ms"]))
    log(f"    K2 {label} ({res['route']}): ms {res['ms']:.3f} (plain {res['plain_ms']:.3f}, bound "
        f"{res['bound_ms']:.3f} by {res['bound_by']}), device ms alone {res['stage_device_ms']}")
    return res, yc


def compare_project(label: str, x: torch.Tensor, y: torch.Tensor) -> dict:
    """K3 against its plain version and the library on the card, on the
    same x and y (each f32 or bf16).  Tolerances: C within
    ``K3_F64_LIMIT`` max|C| of the f64 sums of Y^T X, and within 1e-5
    plus the plain version's own error of the plain version.  On f32
    operands a control, one TF32 pass (``torch.matmul(y.T, x)`` with TF32
    allowed, the flag restored), must miss that limit, so that it tells
    3xTF32 from one pass.  Library call: one ``torch.matmul(y.T, x)`` (f32
    with TF32 off), on bf16 operands ``torch.mm(y.T, x,
    out_dtype=torch.float32)``, the same function, on one of each none
    (``library_ms`` None); the port never makes it.  Bound: on the tensor cores, 3xTF32 for f32 operands (three
    passes of 2MNT), two passes for bf16 x f32, one bf16 pass for bf16.
    The line names K3's block (``project_block``: the mainloop, the
    orientation, m, n, the blocks along each side, where the f64 sums
    live)."""
    from dmd_era5_tpu_torch.ops.matmul import (
        _project_plain,
        _project_row_shares,
        project,
        project_block,
    )

    def kernel():
        return project(x, y)

    def plain():
        return _project_plain(x, y)

    bf16 = (x.dtype == torch.bfloat16) + (y.dtype == torch.bfloat16)

    def library():
        return torch.mm(y.T, x, out_dtype=torch.float32) if bf16 == 2 else torch.matmul(y.T, x)

    mixed = x.dtype != y.dtype  # no one library call takes bf16 by f32

    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    exact = gram_f64(y, x)
    scale = float(exact.abs().max())
    (m, t), n = x.shape, y.shape[1]
    block = project_block(m, n, t, y.dtype, x.dtype)
    res = dict(label=label, m=m, t=t, n=n, dtypes=[str(a.dtype).replace("torch.", "") for a in (x, y)],
               row_shares=_project_row_shares(x, y),
               block=dict(mainloop=block.mainloop,
                          orientation="C^T (X on m)" if block.transposed else "C (Y on m)",
                          m=block.m, n=block.n, blocks=[block.m_blocks, block.n_blocks],
                          sums=block.sums))
    for who, c in (("kernel", got), ("plain", ref)):
        res[f"{who}_C_vs_f64_over_max"] = float((c.double() - exact).abs().max()) / scale
    control = not bf16 and not tf32_exact(x, y)  # else nothing to tell apart
    if control:
        one_pass = tf32_mm(y.T, x)
        res["one_tf32_pass_C_vs_f64_over_max"] = (
            float((one_pass.double() - exact).abs().max()) / scale)
        del one_pass
    elif not bf16:
        res["one_tf32_pass_C_vs_f64_over_max"] = None
    diff = (got.double() - ref.double()).abs().max()
    res["max_abs_err"], res["C_vs_plain_over_max"] = float(diff), float(diff) / scale
    log(f"    {json.dumps(res)}")
    check(res["kernel_C_vs_f64_over_max"] <= K3_F64_LIMIT,
          f"{label} K3: C vs f64 {res['kernel_C_vs_f64_over_max']:.3e} max|C| > {K3_F64_LIMIT}")
    if control:
        check(res["one_tf32_pass_C_vs_f64_over_max"] > K3_F64_LIMIT,
              f"{label} K3: one TF32 pass reads {res['one_tf32_pass_C_vs_f64_over_max']:.3e} "
              f"max|C|, within {K3_F64_LIMIT}: the limit does not tell 3xTF32 from it")
    limit = 1e-5 + res["plain_C_vs_f64_over_max"]
    check(res["C_vs_plain_over_max"] <= limit,
          f"{label} K3: C vs plain {res['C_vs_plain_over_max']:.3e} > {limit:.3e}")
    del got, ref, exact
    p1, k1, k2, p2 = event_ms(plain), event_ms(kernel), event_ms(kernel), event_ms(plain)
    res.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
               library_ms=None if mixed else event_ms(library))
    passes, peak = ((3, PEAK_TF32), (2, PEAK_TF32), (1, PEAK_BF16))[bf16]
    res["bound_ms"], res["bound_by"] = bound(
        passes * 2 * m * n * t, peak,
        x.element_size() * m * t + y.element_size() * m * n + 4 * n * t)
    log(f"    K3 {label}: ms {res['ms']:.3f} (plain {res['plain_ms']:.3f}, library "
        f"{res['library_ms']}, bound {res['bound_ms']:.3f} by {res['bound_by']}), "
        f"{res['row_shares']} row shares")
    return res


@contextlib.contextmanager
def stage_clock(module, *names: str):
    """Wall time of each call of ``module.<name>`` between two device
    synchronizations, into the yielded dict (name -> list of seconds)."""
    saved = {name: getattr(module, name) for name in names}
    times = {name: [] for name in names}

    def timed(name):
        def call(*args, **kwargs):
            out, secs = synced(saved[name], *args, **kwargs)
            times[name].append(secs)
            return out
        return call

    for name in names:
        setattr(module, name, timed(name))
    try:
        yield times
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


@contextlib.contextmanager
def first_operands(module, name: str, keep: int):
    """The positional arguments of the first ``keep`` calls of
    ``module.<name>``, into the yielded list (later calls pass through)."""
    saved = getattr(module, name)
    calls: list[tuple] = []
    seen = 0

    def call(*args, **kwargs):
        nonlocal seen
        if seen < keep:
            calls.append(args)
        seen += 1
        return saved(*args, **kwargs)

    setattr(module, name, call)
    try:
        yield calls
    finally:
        setattr(module, name, saved)


@contextlib.contextmanager
def first_call(module, name: str):
    """The first call's arguments of ``module.<name>``, into the yielded
    dict ("args", "kwargs"; later calls pass through)."""
    saved = getattr(module, name)
    seen: dict = {}

    def call(*args, **kwargs):
        if not seen:
            seen.update(args=args, kwargs=kwargs)
        return saved(*args, **kwargs)

    setattr(module, name, call)
    try:
        yield seen
    finally:
        setattr(module, name, saved)


@contextlib.contextmanager
def first_result(module, name: str):
    """The first call's return value of ``module.<name>``, into the
    yielded dict ("value"; later calls pass through)."""
    saved = getattr(module, name)
    seen: dict = {}

    def call(*args, **kwargs):
        out = saved(*args, **kwargs)
        seen.setdefault("value", out)
        return out

    setattr(module, name, call)
    try:
        yield seen
    finally:
        setattr(module, name, saved)


def phase_wide_sketch(week: dict, seed: int) -> dict:
    """Phase 11: (a) K2 and K3 against their plain versions at the d = 3
    pass's shapes and types; then the randomized Hankel SVD at d = 3
    (N = 3 x 128 = 384, bf16 GEMMs, the function's default) on the
    ERA5-week X: past K1's N_MAX, so n_iter auto = 4 gives five two-pass
    passes (K2 5, K3 5, K1 0); then optDMD and the forecast at d = 3.
    Returns the main path's launch counts."""
    from dmd_era5_tpu_torch.ops import hankel_randomized_svd_fused, stacked_sketch_matrix

    d, k = 3, 100
    x = week["x"]
    t = x.shape[1]
    log("[11a] K2 and K3 against their plain versions at the d = 3 pass's shapes: bf16 X, "
        "stacked bf16 W (N = 384), bf16 Yc, no centring (CUDA-event ms)")
    torch.cuda.reset_peak_memory_stats()
    xb = x.to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    omega = torch.randn((t - d + 1, 128), generator=gen, device=x.device)
    w = stacked_sketch_matrix(omega, d, t).to(torch.bfloat16)
    k2_res, yc = compare_sketch_center_gram("d3_pass", xb, w, center=False,
                                            out_dtype=torch.bfloat16)
    check(k2_res["route"] == "clusters", f"d = 3 pass: K2 took {k2_res['route']}, not the clusters")
    K2_D3.update(k2_res)
    compare_project("d3_pass", xb, yc)
    del xb, w, yc
    log(f"    peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    times = {}
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    svd, times["hankel_svd_d3"] = synced(hankel_randomized_svd_fused, x, d, k, generator=gen)
    launches = launch_counts()
    routes = record_k2_routes()
    u, s, v = svd
    orth = orthonormality(u)
    log(f"[11] d = 3 randomized Hankel SVD (bf16, N = 384): U {tuple(u.shape)}, max|U^T U - I| "
        f"{orth:.2e}, s[:8] {[round(float(a), 2) for a in s[:8]]}, launches {launches}")
    check(launches == counts(K2=5, K3=5), f"d = 3 Hankel SVD launched {launches}, expected K2 5, K3 5")
    check(routes == {"K2/clusters": 5, "K2/stages": 0},
          f"d = 3 Hankel SVD: K2 by route {routes}, expected all 5 on the clusters")
    # bf16 Yc: the whitening describes the stored values (tests/test_07:212's bound)
    check(orth <= 1e-2, f"d = 3 Hankel SVD: U^T U - I max {orth:.3e} > 1e-2")
    check(bool((s > 0).all()) and bool((s[1:] <= s[:-1]).all()), "d = 3: s not positive descending")
    dmd_and_forecast("d=3", svd, week, times, d)
    times["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    log(f"    stage wall times (s): {json.dumps(times)} (peak_gb: device memory over the phase's start)")
    del u, s, v, svd
    return launches


# north-star config 3's week as the SVD stage's [era5-download] / [era5-svd]
# overrides of config.ini (phase 12 b); config 1 takes config.ini as it is
# but for the mock's source_path (phase 12 a)
WEEK_VARIABLES = ("temperature", "u_component_of_wind", "v_component_of_wind")
WEEK_CONFIG = dict(start_datetime="2019-01-01T00", end_datetime="2019-01-07T23",
                   variables=",".join(WEEK_VARIABLES), levels="1000,850,700,500,250")
WEEK_SVD = dict(n_components=100, save_data_matrix=False)


def stage_config(section: str, **overrides) -> dict:
    """The raw config.ini section with ``overrides`` (a user's dict)."""
    from dmd_era5_tpu_torch.core import config_reader

    return {**config_reader(section, ROOT / "config.ini"), **overrides}


def gb_per_s(nbytes: int, secs: float) -> float:
    """A file step's rate: its bytes over its wall time, in GB/s."""
    return nbytes / secs / 1e9 if secs > 0 else float("nan")


def file_sizes(directory: Path) -> int:
    """The bytes of the files under ``directory``."""
    return sum(p.stat().st_size for p in directory.rglob("*") if p.is_file())


@contextlib.contextmanager
def stage_root():
    """DMD_ERA5_TPU_ROOT and DMD_ERA5_TPU_REMOTE pointed into a new
    temporary directory (under TMPDIR), so that the stages' data/,
    store/ and logs/ land there; removed, and the variables restored, at
    the end."""
    import os

    names = ("DMD_ERA5_TPU_ROOT", "DMD_ERA5_TPU_REMOTE")
    saved = {name: os.environ.get(name) for name in names}
    directory = Path(tempfile.mkdtemp(prefix="dmd_era5_stage_"))
    os.environ["DMD_ERA5_TPU_ROOT"] = str(directory / "root")
    os.environ["DMD_ERA5_TPU_REMOTE"] = str(directory / "remote")
    try:
        yield directory
    finally:
        shutil.rmtree(directory, ignore_errors=True)
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def week_slice(week: dict):
    """North-star config 3's slice as the ingest stage leaves it: the
    week's raw X (the centred X plus phase 3's row means, added in place:
    no later phase reads the centred X) as a FieldSet of (time, level,
    latitude, longitude) fields, each a view of X's rows on the card,
    stamped with the attributes ``download_era5_data`` stamps."""
    from dmd_era5_tpu_torch.core import config_parser
    from dmd_era5_tpu_torch.pipeline import era5_download
    from dmd_era5_tpu_torch.utils.labels import Coord, Field, FieldSet

    x = week["x"]
    x.add_(week["mean"][:, None])
    levels = [int(v) for v in LEVELS]
    block = len(levels) * N_LAT * N_LON
    coords = {
        "time": Coord("time", np.datetime64(WEEK_CONFIG["start_datetime"], "ns")
                      + np.arange(T_HOURS) * np.timedelta64(3600, "s")),
        "level": Coord("level", np.asarray(levels)),
        "latitude": Coord("latitude", 90.0 - 0.25 * np.arange(N_LAT)),
        "longitude": Coord("longitude", 0.25 * np.arange(N_LON)),
    }
    fields = {
        var: Field(x[i * block:(i + 1) * block].view(len(levels), N_LAT, N_LON, T_HOURS)
                   .permute(3, 0, 1, 2), ("time", "level", "latitude", "longitude"), coords,
                   {"units": "K" if var == "temperature" else "m/s"}, var)
        for i, var in enumerate(WEEK_VARIABLES)
    }
    parsed = config_parser(stage_config("era5-download", **WEEK_CONFIG), "era5-download")
    return era5_download.add_config_attributes(FieldSet(fields), parsed)


def phase_stage_config1(seed: int) -> dict:
    """Phase 12 (a): north-star config 1, config.ini's [era5-download] and
    [era5-svd] on the mock backend (the global numpy state seeded):
    download with the store, the SVD stage with the store, then the
    stage again, a workdir cache hit.  Returns the stage's times."""
    from dmd_era5_tpu_torch.core import config_parser
    from dmd_era5_tpu_torch.pipeline import era5_download, era5_svd
    from dmd_era5_tpu_torch.pipeline.artifacts import file_md5, list_versions

    times = {}
    np.random.seed(seed)
    dl, times["download"] = synced(era5_download.main, stage_config("era5-download"),
                                   use_mock_data=True, use_store=True)
    check(dl == (True, False), f"config 1 download: (added, retrieved) {dl}, expected (True, False)")
    cfg = stage_config("era5-svd", source_path="mock_data")
    parsed = config_parser(dict(cfg), "era5-svd")
    before = launch_counts()["K1"]
    (res, added, retrieved), times["svd_stage"] = synced(
        era5_svd.main, dict(cfg), write_artifact=True, use_store=True)
    k1 = launch_counts()["K1"] - before
    check(added and not retrieved, f"config 1 SVD stage: added {added}, retrieved {retrieved}")
    check(k1 == 5, f"config 1 SVD stage launched K1 {k1} times, expected 5")
    (res2, added2, retrieved2), times["cache_hit"] = synced(
        era5_svd.main, dict(cfg), write_artifact=True, use_store=True)
    check(not added2 and not retrieved2 and launch_counts()["K1"] - before == 5,
          "config 1: the second SVD stage was not a workdir cache hit")
    check(np.array_equal(res2["U"].values, res["U"].values), "config 1: the cache hit's U differs")
    x = np.asarray(res["X"].values, dtype=np.float64)
    k = parsed["n_components"]
    s_exact = np.linalg.svd(x, compute_uv=False)[:k]
    s = np.asarray(res["s"].values, dtype=np.float64)
    u = torch.from_numpy(res["U"].values).cuda()
    orth = orthonormality(u)
    ratio = s / s_exact
    check(float(ratio.max()) <= 1 + 1e-4, f"config 1: s above the f64 s of X, max ratio {ratio.max()}")
    check(orth <= 1e-3, f"config 1: U^T U - I max {orth:.3e} > 1e-3")
    svd_log = list_versions(parsed["save_path"], data_type="era5_svd")
    slice_log = list_versions(parsed["era5_slice_path"], data_type="era5_slice")
    check([m for m, _ in svd_log] == [file_md5(parsed["save_path"])]
          and [m for m, _ in slice_log] == [file_md5(parsed["era5_slice_path"])],
          f"config 1: the store's logs {svd_log} / {slice_log} do not name the two artifacts")
    log(f"[12a] config 1 (mock, config.ini): X {x.shape}, s[:4] {[round(float(a), 3) for a in s[:4]]}, "
        f"s / f64 s of X from {float(ratio.min()):.5f} to {float(ratio.max()):.5f} (i.i.d. noise: "
        f"a flat spectrum, the gap not bounded), max|U^T U - I| {orth:.2e}, K1 launches {k1}, "
        f"store logs name slice {slice_log[0][0]} and results {svd_log[0][0]}; "
        f"wall (s) {json.dumps({a: round(b, 3) for a, b in times.items()})}")
    return times


def check_week_results(label: str, res, week: dict) -> dict:
    """Phase 12 (b)'s checks on the stage's results: s within the
    interlace of phase 7's exact Hankel s (as phase 3), the leading 6
    within 1e-5 of phase 3's, U^T U to 1e-3, X_mean against phase 3's
    row means (both delay blocks)."""
    s = torch.from_numpy(np.asarray(res["s"].values))
    inter = check_interlace(f"{label} vs exact Hankel (phase 7)", s, week["s_exact"].cpu())
    lead = float((s[:6].double() / week["s_rand"][:6].double().cpu() - 1).abs().max())
    check(lead <= 1e-5, f"{label}: leading 6 s differ from phase 3's by {lead:.3e} > 1e-5")
    u = torch.from_numpy(res["U"].values).cuda()
    orth = orthonormality(u)
    del u
    check(orth <= 1e-3, f"{label}: U^T U - I max {orth:.3e} > 1e-3")
    mean = week["mean"]
    x_mean = torch.from_numpy(np.asarray(res["X_mean"].values)).cuda().view(2, -1)
    mean_err = float((x_mean - mean).abs().max() / mean.abs().max())
    check(mean_err <= 1e-6, f"{label}: X_mean off phase 3's row means by {mean_err:.3e} of max")
    check(res.attrs["svd_backend"] == "hankel", f"{label}: backend {res.attrs['svd_backend']}")
    return {"vs_exact": inter, "lead6_vs_phase3": lead, "orth": orth, "x_mean_rel": mean_err}


def phase_stage(week: dict, seed: int):
    """Phase 12: the SVD stage's entry points on the card.  (a) north-star
    config 1 through the files and the store; (b) north-star config 3,
    the week, at full size: its raw X written as the ERA5 slice, then
    ``era5_svd.main`` on [era5-svd] with the week's overrides
    (``n_components`` 100, X not saved) and again as a workdir cache
    hit.  Each file step logs its wall time, bytes and GB/s.  Returns
    the launch counts, the slice (its fields views of X on the card),
    the slice as the first main read it back from its file (which 13c and
    15c take) and (b)'s results, read back on the hit."""
    from dmd_era5_tpu_torch.core import config_parser
    from dmd_era5_tpu_torch.pipeline import era5_svd
    from dmd_era5_tpu_torch.utils.io_h5 import save_fieldset

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    fs = week_slice(week)
    cfg = stage_config("era5-svd", **WEEK_CONFIG, **WEEK_SVD)
    times, io = {}, {}
    with stage_root() as directory:
        parsed = config_parser(dict(cfg), "era5-svd")  # its paths under the stage root
        times["config1"] = phase_stage_config1(seed)
        k1_a = launch_counts()["K1"]
        _, times["slice_write"] = synced(save_fieldset, fs, parsed["era5_slice_path"])
        with stage_clock(era5_svd, "load_fieldset", "_preprocess_on_device", "svd_on_era5",
                         "save_fieldset") as clock, \
                first_result(era5_svd, "load_fieldset") as loaded:
            (res, added, retrieved), times["stage_main"] = synced(
                era5_svd.main, dict(cfg), write_artifact=True)
            check(not added and not retrieved, "week: main added to or retrieved from a store")
            check(launch_counts()["K1"] - k1_a == 5, "week: K1 launches of main != 5")
            # the first run's U waits on the card, so the host holds one U at a time
            u_first = torch.from_numpy(res["U"].values).cuda()
            del res
            (hit, _, _), times["cache_hit_main"] = synced(era5_svd.main, dict(cfg),
                                                           write_artifact=True)
        check(launch_counts()["K1"] - k1_a == 5, "week: the second main computed again")
        u_hit = hit["U"].values
        same = all(torch.equal(u_first[r0:r0 + CHUNK].view(torch.int32), torch.from_numpy(
            u_hit[r0:r0 + CHUNK]).cuda().view(torch.int32)) for r0 in range(0, len(u_hit), CHUNK))
        check(same, "week: the cache hit's U is not the first run's bit for bit")
        del u_first
        res = hit  # the artifact read back
        fs_back = loaded["value"]  # the slice as the first main read it from its file
        disk = file_sizes(directory / "root")
        times["slice_load"], times["cache_hit_load"] = clock.pop("load_fieldset")
        (times["results_write"],) = clock.pop("save_fieldset")
        times.update({f"{name}_s": v for name, v in clock.items()})
        slice_bytes = Path(parsed["era5_slice_path"]).stat().st_size
        results_bytes = Path(parsed["save_path"]).stat().st_size
    for step, nbytes in (("slice_write", slice_bytes), ("slice_load", slice_bytes),
                         ("results_write", results_bytes), ("cache_hit_load", results_bytes)):
        io[step] = {"gb": nbytes / 1e9, "s": times[step], "gb_s": gb_per_s(nbytes, times[step])}
    out = check_week_results("week (12b)", res, week)
    launches = launch_counts()
    expect = counts(K1=10)
    check(launches == expect, f"phase 12 launched {launches}, expected {expect}")
    times["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    log(f"[12b] config 3 week through the SVD stage: U {res['U'].shape}, s[:8] "
        f"{[round(float(a), 2) for a in res['s'].values[:8]]}, {json.dumps(out)}, "
        f"metrics svd_seconds {res.attrs['svd_seconds']}, launches {launches}, disk bytes {disk}")
    log(f"    stage wall times (s): {json.dumps(times)} (peak_gb: device memory over the "
        "phase's start)")
    log(f"    [12b files] the week's slice and results through the port's HDF5 codec: "
        f"{json.dumps(io)} (bytes of the file over the step's wall time; the loads read the "
        "page cache's copy where it holds one)")
    return launches, fs, fs_back, res


# north-star config 1's DMD stage takes config.ini's [era5-dmd] as it is but for
# the mock's source_path; the week's (phase 13 b-d) adds the week's overrides
DMD_RANK, FORECAST_STEPS, HOLDOUT, BAG_TRIALS, BAG_FRACTION = 6, 24, 24, 8, 0.8


def host_memory() -> dict:
    """This process's resident set now (/proc/self/status VmRSS) and its
    peak over the process (getrusage's ru_maxrss), in GB."""
    import resource

    rss = next(int(line.split()[1]) for line in Path("/proc/self/status").read_text()
               .splitlines() if line.startswith("VmRSS:"))
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return {"rss_gb": rss * 1024 / 1e9, "peak_rss_gb": peak * 1024 / 1e9}


def dmd_result(res):
    """The fitted model of a DMD stage FieldSet (eigenvalues, amplitudes
    and the modes where they lie), as an OptDMDResult."""
    from dmd_era5_tpu_torch.models import OptDMDResult

    modes = res["modes"].data
    alpha = torch.from_numpy(res["eigenvalues"].values).to(modes.device)
    amps = torch.from_numpy(res["amplitudes"].values).to(modes.device)
    return OptDMDResult(alpha, modes, amps, None, None, 0)


def check_dmd_fit(label: str, res, week: dict) -> float:
    """The planted eigenvalues recovered within 1e-2 (as phase 3's
    optDMD), finite eigenvalues, amplitudes and modes."""
    eig = torch.from_numpy(res["eigenvalues"].values)
    err = matched_eig_error(eig, week["alpha_true"])
    check(err < 1e-2, f"{label}: planted eigenvalues not recovered: matched error {err:.3e}")
    for name in ("eigenvalues", "amplitudes"):
        check(bool(np.isfinite(res[name].values).all()), f"{label}: {name} not finite")
    check(bool(torch.isfinite(res["modes"].data).all()), f"{label}: modes not finite")
    return err


def check_week_forecast(label: str, res, week: dict, mean: np.ndarray, d: int = 2) -> dict:
    """The forecast field's future columns against the noise-free planted
    signal (anomaly error < 5e-2, as phase 3), and the whole field against
    the one-shot ``undo_preprocessing(rollout(...))`` of the same model,
    computed in row chunks of the undelayed rows (1e-5 of max|field|)."""
    from dmd_era5_tpu_torch.models import rollout, undo_preprocessing

    field = res["forecast"].data
    s_rows, n_cols = field.shape
    n_hist = n_cols - FORECAST_STEPS
    check(tuple(field.shape) == (week["x"].shape[0], T_HOURS - d + 1 + FORECAST_STEPS),
          f"{label}: forecast shape {tuple(field.shape)}")
    check(bool(torch.isfinite(field).all()), f"{label}: forecast not finite")
    # embedded time i is hour i + d - 1
    hours = torch.arange(n_hist, n_cols, dtype=torch.float64, device=field.device) + d - 1
    ref = week["truth"](hours)
    fc_err = float((field[:, n_hist:] - ref).norm() / (ref - week["row_mean"][:, None]).norm())
    del ref
    check(fc_err < 5e-2, f"{label}: forecast anomaly error {fc_err:.3e} >= 5e-2")
    model = dmd_result(res)
    t_all = torch.arange(n_cols, dtype=torch.float32, device=field.device)
    mean_rows = torch.from_numpy(mean[(d - 1) * s_rows:]).to(field.device)
    worst, scale = 0.0, float(field.abs().max())
    for r0 in range(0, s_rows, CHUNK):
        r1 = min(r0 + CHUNK, s_rows)
        part = model._replace(modes=model.modes[(d - 1) * s_rows + r0:(d - 1) * s_rows + r1])
        one_shot = undo_preprocessing(rollout(part, t_all), mean_rows[r0:r1], None, delay=1)
        worst = max(worst, float((field[r0:r1] - one_shot).abs().max()))
    check(worst <= 1e-5 * scale, f"{label}: streamed forecast off the one-shot by {worst:.3e}"
          f" > 1e-5 of max|field| {scale:.3e}")
    return {"future_anomaly_err": fc_err, "vs_one_shot": worst / scale}


def f64_scores(forecast: torch.Tensor, truth: torch.Tensor, w: torch.Tensor) -> dict:
    """Latitude-weighted RMSE, ACC (centred on the truth's row means) and
    bias per lead, in one f64 pass over the whole (S, L) fields."""
    f, t, w = forecast.double(), truth.double(), w.double()[:, None]
    clim = t.mean(dim=1, keepdim=True)
    fa, ta, err = f - clim, t - clim, f - t
    wsum = w.sum()
    return {
        "rmse": torch.sqrt((err * err * w).sum(0) / wsum).cpu().numpy(),
        "acc": ((fa * ta * w).sum(0) / torch.sqrt((fa * fa * w).sum(0) * (ta * ta * w).sum(0)))
        .cpu().numpy(),
        "bias": ((err * w).sum(0) / wsum).cpu().numpy(),
    }


def check_scores(label: str, got: dict, want: dict) -> float:
    """RMSE and ACC within 1e-5 relative of the f64 one-shot, the bias
    within 1e-5 of the same lead's RMSE.  Returns the worst share."""
    worst = 0.0
    for key in ("rmse", "acc", "bias"):
        g, w = np.asarray(got[key], np.float64), np.asarray(want[key], np.float64)
        scale = np.abs(want["rmse"]) if key == "bias" else np.abs(w)
        share = float((np.abs(g - w) / scale).max())
        check(share <= 1e-5, f"{label}: {key} off the f64 one-shot by {share:.3e} > 1e-5")
        worst = max(worst, share)
    return worst


def phase_dmd_config1(seed: int, label: str = "13a", expect: dict | None = None, **overrides):
    """Phase 13 (a): north-star config 1, config.ini's [era5-dmd] (rank
    6, optimized, 24 forecast steps) on the mock backend; phase 14 (a)
    the same with ``overrides``.  The mock slice downloaded into the
    store, ``era5_dmd.main`` with the files and the store, then again (a
    workdir cache hit).  Checks shapes, finite values, the attrs and the
    launches (``expect``, by default K1 exactly 5), and logs each step's
    wall time and the artifacts' bytes.  Returns the results."""
    from dmd_era5_tpu_torch.core import config_parser
    from dmd_era5_tpu_torch.pipeline import era5_dmd, era5_download

    cfg = stage_config("era5-dmd", source_path="mock_data", **overrides)
    parsed = config_parser(dict(cfg), "era5-dmd")
    times = {}
    np.random.seed(seed)
    before = launch_counts()
    steps = ("_svd_factors", "optdmd_from_svd", "_mrdmd", "_dmdc", "_forecast_field")
    with stage_clock(era5_dmd, *steps) as clock:
        _, times["download"] = synced(era5_download.main, stage_config("era5-download"),
                                      use_mock_data=True, use_store=True)
        (res, added, retrieved), times["dmd_main"] = synced(
            era5_dmd.main, dict(cfg), write_artifact=True, use_store=True)
        check(added and not retrieved,
              f"config 1 DMD stage: added {added}, retrieved {retrieved}")
        (hit, added2, retrieved2), times["cache_hit"] = synced(
            era5_dmd.main, dict(cfg), write_artifact=True, use_store=True)
        check(not added2 and not retrieved2,
              "config 1: the second DMD stage was not a cache hit")
        check(np.array_equal(hit["modes"].values, res["modes"].data.cpu().numpy()),
              "config 1: the cache hit's modes differ")
    times["artifact_gb"] = Path(parsed["save_path"]).stat().st_size / 1e9
    times["cache_hit_gb_s"] = gb_per_s(Path(parsed["save_path"]).stat().st_size, times["cache_hit"])
    times.update({f"{name}_s": round(sum(v), 3) for name, v in clock.items() if v})
    launched = {key: n - before[key] for key, n in launch_counts().items()}
    expect = expect or counts(K1=5)
    check(launched == expect, f"config 1 DMD stage ({label}) launched {launched}, expected "
          f"{expect}")
    n_space = 36 * 72  # config.ini: temperature at 1000 hPa on the 5-degree mock grid
    d, n_time = parsed["delay_embedding"], 97 - parsed["delay_embedding"] + 1  # 97 hours
    check(tuple(res["modes"].shape) == (n_space * d, DMD_RANK)
          and tuple(res["forecast"].shape) == (n_space, n_time + FORECAST_STEPS),
          f"config 1: modes {res['modes'].shape}, forecast {res['forecast'].shape}")
    check(bool(torch.isfinite(res["forecast"].data).all()) and bool(torch.isfinite(
        res["modes"].data).all()) and bool(np.isfinite(res["eigenvalues"].values).all()),
        "config 1: non-finite modes, eigenvalues or forecast")
    want = {"dmd_rank": DMD_RANK, "optimized": 1, "forecast_steps": FORECAST_STEPS,
            "bagging_trials": 0, "svd_type": "randomized", "delay_embedding": 2,
            "multiresolution_levels": overrides.get("multiresolution_levels", 0),
            "control_input": overrides.get("control_input", "none")}
    got = {key: res.attrs.get(key) for key in want}
    check(got == want and np.isfinite(res.attrs["dmd_residual"])
          and res.attrs["lm_iterations"] >= 1, f"config 1: attrs {got}")
    log(f"[{label}] config 1 (mock, config.ini's [era5-dmd]"
        f"{', ' + json.dumps(overrides) if overrides else ''}): modes "
        f"{tuple(res['modes'].shape)}, forecast {tuple(res['forecast'].shape)}, eigenvalues "
        f"{[complex(round(a.real, 4), round(a.imag, 4)) for a in res['eigenvalues'].values]}, "
        f"residual {res.attrs['dmd_residual']:.3e} ({res.attrs['lm_iterations']} LM steps; "
        f"i.i.d.-noise mock), launches {launched}; wall (s) "
        f"{json.dumps({a: round(b, 3) for a, b in times.items()})}")
    return res


def phase_dmd_stage(week: dict, fs, week_res, seed: int) -> dict:
    """Phase 13: the DMD stage's entry points on the card, after phase 12
    on the week still in memory.  (a) north-star config 1; (b) the week's
    optDMD from 12b's results (rank 6, 24 forecast steps); (c) the week
    with a 24-hour holdout: ``compute_svd_results`` on the slice (144
    train hours), then the fit scored on the withheld day against an f64
    one-shot; (d) the week bagged (8 trials of 80%).  ``fs`` is the slice
    as phase 12's main read it back from its file.  Returns the launch
    counts, (b)'s results without the forecast field and (c)'s SVD, which
    phase 15 (c) updates."""
    from dmd_era5_tpu_torch.core import config_parser
    from dmd_era5_tpu_torch.models import iter_forecast_blocks
    from dmd_era5_tpu_torch.models.verification import latitude_weights
    from dmd_era5_tpu_torch.pipeline import era5_dmd, era5_svd

    reset_counts()
    launches = counts()
    host_start = host_memory()
    with stage_root():
        phase_dmd_config1(seed)
    for key, n in launch_counts().items():
        launches[key] += n

    def week_config(**overrides) -> dict:
        fields = {"dmd_rank": DMD_RANK, "forecast_steps": FORECAST_STEPS, **overrides}
        return config_parser(stage_config("era5-dmd", **WEEK_CONFIG, **WEEK_SVD, **fields),
                             "era5-dmd")

    def run_fit(label: str, svd_res, parsed) -> tuple:
        """fit_dmd_from_svd_results with each step's wall time and the
        device memory it took over its start; no kernel may launch."""
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fit_name = "bopdmd_from_svd" if parsed["bagging_trials"] else "optdmd_from_svd"
        steps = ("_svd_factors", fit_name, "_holdout_scores", "_forecast_field")
        with stage_clock(era5_dmd, *steps) as clock:
            res, total = synced(era5_dmd.fit_dmd_from_svd_results, svd_res, parsed)
        times = {name: round(sum(v), 3) for name, v in clock.items() if v}
        times["total"] = round(total, 3)
        times["packaging_and_rest"] = round(total - sum(sum(v) for v in clock.values()), 3)
        times["peak_device_gb"] = round((torch.cuda.max_memory_allocated() - base) / 1e9, 3)
        times.update({k: round(v, 3) for k, v in host_memory().items()})
        check(launch_counts() == counts(), f"{label}: the fit launched {launch_counts()}")
        # dmd_seconds: a later call of optDMD in this process (phase 3 made the first)
        log(f"    {label} wall (s): {json.dumps(times)}; dmd_seconds attr "
            f"{res.attrs['dmd_seconds']} (not a process's first optDMD call: phase 3 made it)")
        return res, times

    # (b) the week's optDMD from 12b's results
    parsed_b = week_config()
    res_b, times_b = run_fit("13b optDMD", week_res, parsed_b)
    mean = np.asarray(week_res["X_mean"].values, dtype=np.float32)
    err_b = check_dmd_fit("13b", res_b, week)
    fc_b = check_week_forecast("13b", res_b, week, mean)
    log(f"[13b] config 3 week optDMD (rank {DMD_RANK}): eigenvalues matched error vs planted "
        f"{err_b:.2e}, residual {res_b.attrs['dmd_residual']:.3e} "
        f"({res_b.attrs['lm_iterations']} LM steps), forecast {tuple(res_b['forecast'].shape)} "
        f"{json.dumps(fc_b)}, no kernel launch")
    del res_b.data_vars["forecast"]  # 11.9 GB; phase 14 (g) reads the rest

    # (c) the week with a 24-hour holdout, from the SVD stage's compute body
    reset_counts()
    svd_cfg = config_parser(stage_config("era5-svd", **WEEK_CONFIG, **WEEK_SVD,
                                         forecast_holdout=HOLDOUT), "era5-svd")
    with stage_root():
        svd_c, t_svd = synced(era5_svd.compute_svd_results, fs, svd_cfg)
    k1 = launch_counts()["K1"]
    check(launch_counts() == counts(K1=5), f"13c: compute_svd_results launched {launch_counts()}")
    launches["K1"] += k1
    check(svd_c["V"].shape[1] == T_HOURS - HOLDOUT - 1, f"13c: V {svd_c['V'].shape}")
    res_c, _ = run_fit("13c holdout", svd_c, week_config(forecast_holdout=HOLDOUT,
                                                         forecast_steps=0))
    check_dmd_fit("13c", res_c, week)
    truth = torch.from_numpy(svd_c["holdout_truth"].values).cuda()
    persist = torch.from_numpy(svd_c["holdout_persistence"].values).cuda()
    lat = svd_c["holdout_truth"].coords["latitude_out"].values
    w = latitude_weights(lat, truth.device)
    t_hours = np.arange(T_HOURS - HOLDOUT - 1, dtype=np.float32)
    t_lead = (t_hours[-1] + np.arange(1, HOLDOUT + 1)).astype(np.float32)
    forecast = torch.cat([blk for _, blk in iter_forecast_blocks(
        dmd_result(res_c), t_lead, svd_c["X_mean"].values, None, delay=2)])
    got = {key: res_c.attrs[f"forecast_{key}"] for key in ("rmse", "acc", "bias")}
    got_p = {key: res_c.attrs[f"persistence_{key}"] for key in ("rmse", "acc", "bias")}
    share = check_scores("13c DMD", got, f64_scores(forecast, truth, w))
    share_p = check_scores("13c persistence", got_p,
                           f64_scores(persist[:, None].expand(-1, HOLDOUT), truth, w))
    del forecast, truth, persist
    log(f"[13c] config 3 week, {HOLDOUT}-hour holdout ({T_HOURS - HOLDOUT} train hours): "
        f"compute_svd_results {t_svd:.3f} s (K1 launches {k1}, svd_backend "
        f"{res_c.attrs['svd_backend']}); scores within {max(share, share_p):.2e} of the f64 "
        f"one-shot (held 1e-5)")
    for key in ("rmse", "acc", "bias"):
        log(f"    {key} by lead 1-{HOLDOUT}: DMD {[round(v, 4) for v in got[key]]}; "
            f"persistence {[round(v, 4) for v in got_p[key]]}")
    check(got["rmse"][-1] < got_p["rmse"][-1],
          f"13c: DMD's RMSE at lead {HOLDOUT} {got['rmse'][-1]:.4f} does not beat "
          f"persistence's {got_p['rmse'][-1]:.4f}")
    del res_c

    # (d) the week bagged
    parsed_d = week_config(bagging_trials=BAG_TRIALS, bagging_fraction=BAG_FRACTION)
    res_d, times_d = run_fit("13d bagged", week_res, parsed_d)
    err_d = check_dmd_fit("13d", res_d, week)
    for name in ("eigenvalues_std", "amplitudes_std"):
        check(bool(np.isfinite(res_d[name].values).all()), f"13d: {name} not finite")
    check(bool(torch.isfinite(res_d["modes_std"].data).all()), "13d: modes_std not finite")
    used = res_d.attrs.get("bagging_trials_used")
    check(isinstance(used, int) and 1 <= used <= BAG_TRIALS, f"13d: bagging_trials_used {used}")
    modes_gb = res_d["modes"].data.numel() * 8 / 1e9
    over = times_d["peak_device_gb"] - times_b["peak_device_gb"]
    check(over < BAG_TRIALS * modes_gb,
          f"13d: peak device memory {over:.2f} GB over 13b's, not below {BAG_TRIALS} x "
          f"{modes_gb:.2f} GB (a (trials, S*d, r) buffer?)")
    log(f"[13d] config 3 week bagged ({BAG_TRIALS} trials of {BAG_FRACTION}): {used} used, "
        f"trial-mean eigenvalues matched error vs planted {err_d:.2e}, eigenvalues std "
        f"{[float(f'{v:.3g}') for v in res_d['eigenvalues_std'].values]}, peak device memory "
        f"{over:.2f} GB over 13b's (limit {BAG_TRIALS * modes_gb:.2f}), no kernel launch")
    del res_d
    host_end = host_memory()
    log(f"    phase 13 host memory (GB): at its start {json.dumps(host_start)}, at its end "
        f"{json.dumps(host_end)} (peak_rss_gb: the process's peak so far)")
    return launches, res_b, svd_c


# mrDMD on the week (phase 14): 3 levels at rank 6.  The slow budget 1.5
# cycles a window makes the 84-hour pair slow at level 1 alone (margins
# >= 14% at T_used 164 and 168); 14 (d) takes 0.4, under which no planted
# pair is slow before the finest level, so each level's rank-6 fit holds
# the planted six and no noise direction (see phase_mrdmd_streamed)
MR_LEVELS, MR_RANK, MR_CYCLES, MR_CYCLES_STREAMED = 3, 6, 1.5, 0.4
MR_WINDOWS = 2**MR_LEVELS - 1
# DMDc's k-sized fit against the f64 exact-SVD formula, discrete eigenvalues:
# on the wide (k + q) x (T - 1) stack (102 rows under the 128-wide subspace)
# the Gram route's G_y is rank-deficient, and its whitener's second Cholesky
# takes the loose 1e-3 ridge or not by rounding; where it does, U's columns
# come out ~4e-4 short of unit norm and the eigenvalues 7.8e-4 off (the
# host's plain versions and the JAX package's dmdc_from_svd alike at the
# week's k and T; ROADMAP Queue 3, R5)
DMDC_GRAM_ROUTE_GAP = 2e-3
# the fused fit step's "hybrid" small algebra takes s from an f32 eigh of
# B B^T (the sketch's r x r), whose eigenvalues carry a backward error of
# about r eps_f32 max|s|^2: the ensemble's noise-floor s (4e-3 of s[0] on
# the week's members, sketch 110 of 168 columns, where the Ritz values sit
# close to the exact ones) may pass their f64 values by that much (read
# 1.0051 x on an H100); phase 14 (f) holds s^2 <= s_f64^2 (1 + 1e-4)^2 +
# this slack times s_f64[0]^2, the leading 6 within 1e-4
FIT_STEP_EIGH_SLACK = 128 * 2.0**-24


def mr_identity_error(res, expected_rows, n_rows: int, scale: float) -> float:
    """||sum of the levels' slow parts - expected|| / scale, summed in f64
    over row blocks of CHUNK rows: ``expected_rows(r0, r1)`` gives those
    rows of Z[:, :t_used] - residual."""
    from dmd_era5_tpu_torch.models import mrdmd_reconstruct

    num = 0.0
    for r0 in range(0, n_rows, CHUNK):
        r1 = min(r0 + CHUNK, n_rows)
        part = res._replace(levels=[lv._replace(modes=lv.modes[:, r0:r1]) for lv in res.levels])
        diff = mrdmd_reconstruct(part).double() - expected_rows(r0, r1).double()
        num += float(diff.square().sum())
    return math.sqrt(num) / scale


def mr_spectra_match(got, ref) -> float:
    """The largest distance of ref's eigenvalues to got's, matched per
    window nearest first (tests/test_torch_mrdmd.py), with equal slow and
    kept counts at every level."""
    worst = 0.0
    for lv, lv_ref in zip(got.levels, ref.levels):
        for w in range(lv_ref.omega.shape[0]):
            worst = max(worst, matched_eig_error(torch.from_numpy(lv.omega[w]),
                                                 torch.from_numpy(lv_ref.omega[w])))
        check(int(lv.slow_mask.sum()) == int(lv_ref.slow_mask.sum())
              and int(lv.kept_mask.sum()) == int(lv_ref.kept_mask.sum()),
              f"mrDMD level {lv.level}: mask counts {int(lv.slow_mask.sum())}/"
              f"{int(lv.kept_mask.sum())} against {int(lv_ref.slow_mask.sum())}/"
              f"{int(lv_ref.kept_mask.sum())}")
    return worst


def phase_mrdmd_streamed(week: dict, path: Path) -> dict:
    """Phase 14 (d), run inside phase 9 while its packed artifact of the
    centred week (d = 1, 15,573,600 x 168) exists: ``fit_mrdmd_streamed``
    over it (one Gram pass, K4 once a 65,536-row block into f64 sums on
    the card, 238 launches; then a mode pass) against ``fit_mrdmd`` on the
    same X on the card (K4 once a window): eigenvalues matched within
    5e-3, equal mask counts, residual_fro within 2e-2 (tests/test_26's
    tolerances), the two routes' slow parts within 2e-2 of ||X||, and the
    in-memory identity (slow parts + residual = X) within 1e-5 of ||X||.
    The budget (0.4 cycles) keeps every level's rank-6 fit on the planted
    six: a level left with fewer live planted modes than its rank fits
    noise directions, whose singular values cluster within ~0.2%
    (15.6M rows), so two summation orders (an f32 and an f64 Gram) pick
    different ones.  Returns the launch counts."""
    from dmd_era5_tpu_torch.models import fit_mrdmd, fit_mrdmd_streamed

    x = week["x"]
    n_rows = x.shape[0]
    n_blocks = -(-n_rows // RAND_BLOCK)
    kw = dict(dt=1.0, rank=MR_RANK, max_levels=MR_LEVELS, max_cycles=MR_CYCLES_STREAMED)
    log(f"[14d] fit_mrdmd_streamed over the artifact ({n_blocks} blocks of {RAND_BLOCK} rows, "
        f"{MR_LEVELS} levels at rank {MR_RANK}, {MR_CYCLES_STREAMED} cycles) against fit_mrdmd "
        "on the card")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    times = {}
    with pass_clock() as passes:
        got, times["streamed"] = synced(fit_mrdmd_streamed, path, block_rows=RAND_BLOCK,
                                        return_modes=True, **kw)
    times["passes"] = [round(t, 3) for t in passes]
    check(launch_counts() == counts(K4=n_blocks),
          f"14d streamed: launches {launch_counts()}, expected K4 {n_blocks}")
    ref, times["in_memory"] = synced(fit_mrdmd, x, return_modes=True, **kw)
    launches = launch_counts()
    check(launches == counts(K4=n_blocks + MR_WINDOWS),
          f"14d: launches {launches}, expected K4 {n_blocks} + {MR_WINDOWS}")
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    x_fro = math.sqrt(sum(float(c.double().square().sum()) for c in _chunks(x)))
    out = {"eig_matched": mr_spectra_match(got, ref),
           "residual_fro": got.residual_fro, "residual_fro_in_memory": ref.residual_fro,
           "x_fro_gram_vs_rows": got.x_fro / x_fro - 1}
    check(out["eig_matched"] <= 5e-3, f"14d: eigenvalues apart by {out['eig_matched']:.3e}")
    check(abs(got.residual_fro - ref.residual_fro) <= 2e-2 * ref.residual_fro + 1e-3 * x_fro,
          f"14d: residual_fro {got.residual_fro:.6e} against {ref.residual_fro:.6e}")
    out["slow_parts_vs_in_memory"] = mr_identity_error(
        got, lambda r0, r1: mr_identity_rows(ref, r0, r1), n_rows, x_fro)
    check(out["slow_parts_vs_in_memory"] < 2e-2,
          f"14d: slow parts apart by {out['slow_parts_vs_in_memory']:.3e} of ||X||")
    out["identity"] = mr_identity_error(
        ref, lambda r0, r1: x[r0:r1, : ref.t_used] - ref.residual[r0:r1], n_rows, x_fro)
    check(out["identity"] <= 1e-5, f"14d: slow parts + residual off X by {out['identity']:.3e}")
    out["planted_level0"] = matched_eig_error(torch.from_numpy(got.levels[0].omega[0]),
                                              week["alpha_true"])
    check(out["planted_level0"] < 1e-2,
          f"14d: planted eigenvalues at level 0 off by {out['planted_level0']:.3e}")
    del got, ref
    log(f"    {json.dumps(out)}; wall (s) {json.dumps(times)} (streamed, before the pinned "
        f"ring: {PAGEABLE_STREAMED_S['14d']}); device memory rise {peak:.2f} GB; launches "
        f"{launches}")
    compare_gram("14d block", x[:RAND_BLOCK], "highest", reps=20)  # K4 at the pass's block
    return launches


def mr_identity_rows(res, r0: int, r1: int) -> torch.Tensor:
    """Rows [r0, r1) of the sum of the levels' slow parts."""
    from dmd_era5_tpu_torch.models import mrdmd_reconstruct

    return mrdmd_reconstruct(res._replace(
        levels=[lv._replace(modes=lv.modes[:, r0:r1]) for lv in res.levels]))


def f64_dmdc_eigenvalues(z: torch.Tensor, u_ctrl: torch.Tensor, rank: int) -> torch.Tensor:
    """DMDc's unforced eigenvalues (discrete) in f64 on the host, exact
    SVDs (Proctor et al. 3.3; the row balancing and the 1e-3 cutoff of
    ``models/dmdc.py``): the reference of phase 14 (e)."""
    z, u = z.double().cpu(), u_ctrl.double().cpu()
    x1, x2 = z[:, :-1], z[:, 1:]
    gamma = float(x1.square().mean().sqrt() / u.square().mean().sqrt())
    ut, st, vt = torch.linalg.svd(torch.cat([x1, gamma * u]), full_matrices=False)
    p = rank + u.shape[0]
    ut, st, vt = ut[:, :p], st[:p], vt[:p]
    uh = torch.linalg.svd(x2, full_matrices=False)[0][:, :rank]
    st_inv = torch.where(st > 1e-3 * st[0], 1.0 / st, torch.zeros_like(st))
    k_fac = x2 @ (vt.T * st_inv[None, :])
    a_red = (uh.T @ k_fac) @ (ut[: z.shape[0]].T @ uh)
    return torch.linalg.eigvals(a_red)


def phase_multires(week: dict, week_res, res_b, seed: int) -> dict:
    """Phase 14: mrDMD, DMDc, the ensemble and the mode analysis on the
    card, after phase 13 on the week still in memory (14 (d) ran in phase
    9).  (a) north-star config 1 with ``multiresolution_levels = 2`` and
    ``control_input = "diurnal"`` through the DMD stage; (b) mrDMD in the
    POD subspace of 12b's SVD (3 levels at rank 6): the identity
    slow parts = U (Z - residual) in row blocks within 1e-5 of ||Z||, the
    planted eigenvalues at level 0, the 84-hour pair slow at level 1
    alone; (e) DMDc (diurnal) on 12b's SVD: A's eigenvalues against the
    planted ones (1e-2), the k-sized fit against an f64 reference with
    exact SVDs, its forced rollout against Z; (f) ``fit_per_variable_level``
    on the week's FieldSet (15 members of 1,038,240 x 168, k = 100,
    ``solve_dmd`` at rank 6): each member's s within the interlace of its
    f64 values up to the f32 eigh's backward error, its planted
    eigenvalues; (g) ``mode_spectrum`` and
    ``modes_to_grid`` on 13b's result; then the week's raw X is freed and
    (c) the raw refit (rank 6) of the centred d = 2 embedding
    (31,147,200 x 167, 20.8 GB) on the card, K4 once a window, the
    identity in full space in row blocks within 1e-5 of ||X||; (h)
    ``varpro_lm_checkpointed`` resuming from its own file.  Returns the
    launch counts."""
    from dmd_era5_tpu_torch.core import config_parser
    from dmd_era5_tpu_torch.models import (
        dmdc_from_svd,
        dmdc_rollout,
        fit_dmdc,
        fit_mrdmd,
        mode_spectrum,
        modes_to_grid,
        mrdmd_from_svd,
    )
    from dmd_era5_tpu_torch.models.mrdmd import _fro
    from dmd_era5_tpu_torch.pipeline import fit_per_variable_level
    from dmd_era5_tpu_torch.pipeline.era5_dmd import _control_series

    launches = counts()
    host_start = host_memory()

    def record(label: str, fn, *args, expect: dict, **kwargs):
        """fn on the main path: counts zeroed before and checked after;
        (result, wall seconds, device memory rise in GB)."""
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out, secs = synced(fn, *args, **kwargs)
        got = launch_counts()
        check(got == expect, f"{label}: launches {got}, expected {expect}")
        for key, n in got.items():
            launches[key] += n
        return out, secs, (torch.cuda.max_memory_allocated() - base) / 1e9

    # (a) config 1 with both branches
    with stage_root():
        reset_counts()
        res_a = phase_dmd_config1(seed, "14a", counts(K1=5 + 2, K4=3 + 2),
                                  multiresolution_levels=2, control_input="diurnal")
    for key, n in launch_counts().items():
        launches[key] += n
    n_space_a = 36 * 72 * 2
    check(tuple(res_a["mr_modes_L1"].shape) == (2, n_space_a, DMD_RANK)
          and tuple(res_a["dmdc_modes"].shape) == (n_space_a, DMD_RANK)
          and tuple(res_a["dmdc_control"].shape) == (2, 95), "14a: mrDMD / DMDc field shapes")
    for name in ("mr_modes_L0", "mr_modes_L1", "dmdc_modes"):
        check(bool(torch.isfinite(res_a[name].data).all()), f"14a: {name} not finite")
    rel = res_a.attrs["multiresolution_residual"]
    check(0.0 <= rel < 1.0 and np.isfinite(res_a.attrs["dmdc_residual"]),
          f"14a: residual shares {rel}, {res_a.attrs['dmdc_residual']}")
    log(f"    14a: multiresolution_residual {rel:.4f}, dmdc_residual "
        f"{res_a.attrs['dmdc_residual']:.4f}, mr_t_used {res_a.attrs['mr_t_used']}")
    del res_a

    # (b) mrDMD in the subspace of 12b's SVD
    u, t_u = synced(lambda: torch.from_numpy(week_res["U"].values).cuda())
    s = torch.from_numpy(np.asarray(week_res["s"].values)).cuda()
    v = torch.from_numpy(np.asarray(week_res["V"].values)).cuda()
    z = s[:, None] * v
    z_fro = float(z.norm())
    log(f"[14b] mrDMD ({MR_LEVELS} levels, rank {MR_RANK}, {MR_CYCLES} cycles) in the POD "
        f"subspace of 12b's SVD: U {tuple(u.shape)} onto the card in {t_u:.3f} s")
    mr_b, t_b, peak_b = record("14b", mrdmd_from_svd, u, s, v, dt=1.0, rank=MR_RANK,
                               max_levels=MR_LEVELS, max_cycles=MR_CYCLES,
                               expect=counts(K4=MR_WINDOWS))
    zr = z[:, : mr_b.t_used] - mr_b.residual
    ident_b, t_ident = synced(mr_identity_error, mr_b, lambda r0, r1: u[r0:r1] @ zr,
                              u.shape[0], z_fro)
    check(ident_b <= 1e-5, f"14b: slow parts off U (Z - residual) by {ident_b:.3e} of ||Z||")
    lv0, lv1 = mr_b.levels[0], mr_b.levels[1]
    err_b = matched_eig_error(torch.from_numpy(lv0.omega[0]), week["alpha_true"])
    check(err_b < 1e-2, f"14b: planted eigenvalues at level 0 off by {err_b:.3e}")
    slow84 = 2 * math.pi / 84.0  # the 84-hour pair's |omega|, its damping aside
    slow_sets = [np.abs(lv1.omega[w][lv1.slow_mask[w]]) for w in range(2)]
    check(not lv0.slow_mask.any() and all(len(a) == 2 and bool((abs(a - slow84) < 5e-3).all())
                                          for a in slow_sets),
          f"14b: slow at level 0 {lv0.omega[0][lv0.slow_mask[0]].tolist()}, at level 1 "
          f"{[a.tolist() for a in slow_sets]}")
    log(f"    identity {ident_b:.3e} of ||Z|| ({t_ident:.3f} s in row blocks), planted at level "
        f"0 within {err_b:.2e}, 84-hour pair slow at level 1 in both windows; wall {t_b:.3f} s, "
        f"device memory rise {peak_b:.2f} GB, residual share {mr_b.residual_fro / z_fro:.4f}")
    del mr_b, zr

    # (e) DMDc (diurnal) on 12b's SVD
    times_v = np.asarray(week_res["V"].coords["time"].values)
    u_ctrl = torch.from_numpy(_control_series("diurnal", times_v)).cuda()
    log(f"[14e] DMDc (diurnal, q = 2) at rank {DMD_RANK} on 12b's SVD")
    res_e, t_e, peak_e = record("14e", dmdc_from_svd, u, s, v, u_ctrl, rank=DMD_RANK, dt=1.0,
                                expect=counts(K4=2, K1=2))
    err_e = matched_eig_error(res_e.omega, week["alpha_true"])
    check(err_e < 1e-2, f"14e: A's eigenvalues off the planted ones by {err_e:.3e}")
    norms = torch.linalg.vector_norm(res_e.modes, dim=0)
    check(bool(torch.isfinite(res_e.modes).all()) and float((norms - 1).abs().max()) < 1e-5,
          "14e: lifted modes not finite unit columns")
    del res_e
    res_k, t_k, _ = record("14e k-sized", fit_dmdc, z, u_ctrl, rank=DMD_RANK,
                           expect=counts(K4=2, K1=2))
    res_p = fit_dmdc(z.cpu(), u_ctrl.cpu(), rank=DMD_RANK)  # the plain versions, on the host
    lam_ref = f64_dmdc_eigenvalues(z, u_ctrl, DMD_RANK)
    err_f64 = matched_eig_error(res_k.eigenvalues.to(torch.complex128), lam_ref)
    err_plain_f64 = matched_eig_error(res_p.eigenvalues.to(torch.complex128), lam_ref)
    err_plain = matched_eig_error(res_k.eigenvalues.cpu().to(torch.complex128),
                                  res_p.eigenvalues.to(torch.complex128))
    roll = dmdc_rollout(res_k, z[:, 0], u_ctrl)
    roll_err = float((roll - z).norm() / z.norm())
    log(f"    A's eigenvalues vs planted {err_e:.2e}; the k-sized fit (discrete eigenvalues) "
        f"vs the f64 exact-SVD formula {err_f64:.2e} (the plain versions' on the host "
        f"{err_plain_f64:.2e}; the two {err_plain:.2e} apart); one-step residual "
        f"{res_k.residual:.3e}; forced rollout over {z.shape[1]} hours {roll_err:.3e} of ||Z||; "
        f"wall {t_e:.3f} s (lifts included) + {t_k:.3f} s, device memory rise {peak_e:.2f} GB")
    check(max(err_f64, err_plain_f64) <= DMDC_GRAM_ROUTE_GAP,
          f"14e: k-sized fit's eigenvalues off the f64 exact-SVD formula by {err_f64:.3e} "
          f"(plain versions {err_plain_f64:.3e}) > {DMDC_GRAM_ROUTE_GAP}")
    check(roll_err < 1e-1, f"14e: forced rollout off Z by {roll_err:.3e}")
    # (h) the checkpointed LM on the week's projected data, resumed from its own file
    phase_checkpointed(z, week)
    del res_k, roll, u, s, v, z
    torch.cuda.empty_cache()

    # (f) the ensemble on the week's FieldSet
    fs = week.pop("fs")
    n_members = len(WEEK_VARIABLES) * len(LEVELS)
    log(f"[14f] fit_per_variable_level: {n_members} members of {N_LAT * N_LON} x {T_HOURS}, "
        f"k = 100, solve_dmd at rank {DMD_RANK}")
    ens, t_f, peak_f = record("14f", fit_per_variable_level, fs, 100, seed=seed + 14,
                              solve_dmd=True, dmd_rank=DMD_RANK, expect=counts(K1=n_members))
    del fs
    x = week["x"]
    block = N_LAT * N_LON
    worst = {"max_ratio": 0.0, "over_allowance": 0.0, "lead6_rel": 0.0, "planted": 0.0}
    for i in range(n_members):
        g = centred_gram_f64(x[i * block:(i + 1) * block])
        s_exact = torch.sqrt(torch.linalg.eigvalsh(g).flip(0).clamp_min(0))[:100]
        ratio = (ens.state.s[i].double() / s_exact).cpu()
        # the interlace, with the f32 eigh's backward error in s^2
        allow = torch.sqrt((1 + 1e-4) ** 2 + FIT_STEP_EIGH_SLACK
                           * (s_exact[0] / s_exact).square()).cpu()
        lead = float((ratio[:6] - 1).abs().max())
        check(bool((ratio <= allow).all()) and lead <= 1e-4,
              f"14f member {ens.labels[i]}: s / f64 s up to {float(ratio.max()):.6f} (allowed "
              f"{float(allow[ratio.argmax()]):.6f} there), leading 6 within {lead:.3e}")
        worst["max_ratio"] = max(worst["max_ratio"], float(ratio.max()))
        worst["over_allowance"] = max(worst["over_allowance"], float((ratio / allow).max()))
        worst["lead6_rel"] = max(worst["lead6_rel"], lead)
        err = matched_eig_error(ens.dmd.alpha[i], week["alpha_true"])
        check(err < 1e-2, f"14f member {ens.labels[i]}: planted eigenvalues off by {err:.3e}")
        worst["planted"] = max(worst["planted"], err)
    log(f"    labels {ens.labels[0]} .. {ens.labels[-1]}; s / f64 s worst {json.dumps(worst)}; "
        f"LM steps {ens.dmd.n_iters.tolist()}; loss {float(ens.state.loss):.4e}; wall "
        f"{t_f:.3f} s, device memory rise {peak_f:.2f} GB")
    del ens

    # (g) the spectrum and the grid of 13b's result
    (spec, grids), t_g = synced(lambda: (mode_spectrum(res_b["eigenvalues"].values,
                                                       res_b["amplitudes"].values),
                                         modes_to_grid(res_b)))
    periods = sorted(float(p) for p in spec.period)
    want = sorted([p for _, p, _ in PAIRS] * 2)
    check(all(abs(a / b - 1) < 1e-2 for a, b in zip(periods, want)),
          f"14g: periods {periods} against the planted {want}")
    g = grids["temperature"]
    check(g.data.shape == (len(LEVELS), N_LAT, N_LON, DMD_RANK)
          and float(g.coords["latitude"].values[0]) == 90.0,
          f"14g: grid {g.data.shape}, latitudes from {g.coords['latitude'].values[0]}")
    rows = np.random.default_rng(seed).choice(N_LAT * N_LON * len(LEVELS), 8, replace=False)
    flat = res_b["modes"].data[N_BLOCKS * N_LAT * N_LON:]  # delay block 0: the last S rows
    for row in rows:
        li, rest = divmod(int(row), N_LAT * N_LON)
        ai, oi = divmod(rest, N_LON)
        check(np.array_equal(g.data[li, ai, oi], flat[row].cpu().numpy()),
              f"14g: grid entry ({li}, {ai}, {oi}) is not the flat mode's row {row}")
    log(f"[14g] mode_spectrum and modes_to_grid on 13b's result: periods (h) "
        f"{[round(p, 2) for p in periods]}, e-folding (h) "
        f"{[round(float(e), 1) for e in spec.e_folding]}, grids "
        f"{ {k: tuple(v.data.shape) for k, v in grids.data_vars.items()} }; wall {t_g:.3f} s")
    del grids, spec

    # (c) the raw refit of the centred d = 2 embedding, the week's raw X freed
    mean = week["mean"]
    s_rows, t_raw = x.shape
    xe = torch.empty((2 * s_rows, t_raw - 1), dtype=torch.float32, device=x.device)
    for r0 in range(0, s_rows, CHUNK):
        r1 = min(r0 + CHUNK, s_rows)
        xe[r0:r1] = x[r0:r1, : t_raw - 1] - mean[r0:r1, None]
        xe[s_rows + r0 : s_rows + r1] = x[r0:r1, 1:] - mean[r0:r1, None]
    del x
    week["x"] = None  # no later phase reads the week's X
    torch.cuda.empty_cache()
    log(f"[14c] raw mrDMD refit (rank {MR_RANK}, {MR_LEVELS} levels, {MR_CYCLES} cycles) of "
        f"the centred d = 2 embedding {tuple(xe.shape)} ({xe.numel() * 4 / 1e9:.2f} GB) on the "
        "card")
    mr_c, t_c, peak_c = record("14c", fit_mrdmd, xe, dt=1.0, rank=MR_RANK, max_levels=MR_LEVELS,
                               max_cycles=MR_CYCLES, expect=counts(K4=MR_WINDOWS))
    xe_fro = _fro(xe[:, : mr_c.t_used])
    ident_c, t_ident = synced(mr_identity_error, mr_c,
                              lambda r0, r1: xe[r0:r1, : mr_c.t_used] - mr_c.residual[r0:r1],
                              xe.shape[0], xe_fro)
    check(ident_c <= 1e-5, f"14c: slow parts + residual off X by {ident_c:.3e} of ||X||")
    err_c = matched_eig_error(torch.from_numpy(mr_c.levels[0].omega[0]), week["alpha_true"])
    check(err_c < 1e-2, f"14c: planted eigenvalues at level 0 off by {err_c:.3e}")
    log(f"    identity {ident_c:.3e} of ||X|| ({t_ident:.3f} s in row blocks), planted at level "
        f"0 within {err_c:.2e}, residual share {mr_c.residual_fro / xe_fro:.4f}; wall "
        f"{t_c:.3f} s, device memory rise {peak_c:.2f} GB over X's "
        f"{xe.numel() * 4 / 1e9:.2f} GB (the residual, a window copy, the modes)")
    del mr_c
    torch.cuda.empty_cache()
    t_l = xe.shape[1] // 4 * 2  # level 1's window: T_used / 2 columns
    compare_gram("14c window", xe[:, t_l: 2 * t_l].contiguous(), "highest")
    del xe
    torch.cuda.empty_cache()

    log(f"    phase 14 host memory (GB): at its start {json.dumps(host_start)}, at its end "
        f"{json.dumps(host_memory())}; launches {launches}")
    return launches


def centred_gram_f64(x: torch.Tensor) -> torch.Tensor:
    """Xc^T Xc in f64 over row chunks, Xc = X with each row's mean over
    time taken out (the fit step's centring)."""
    out = torch.zeros((x.shape[1], x.shape[1]), dtype=torch.float64, device=x.device)
    for c in _chunks(x):
        cd = c.double()
        cd -= cd.mean(dim=1, keepdim=True)
        out += cd.T @ cd
    return out


def phase_checkpointed(z: torch.Tensor, week: dict) -> None:
    """Phase 14 (h): ``varpro_lm_checkpointed`` on the week's projected
    data H = Z^T (167 x 100) from the exact-DMD initial eigenvalues: four
    steps in chunks of two into a file under TMPDIR, then resumed from it
    to 50 steps in chunks of ten; the planted eigenvalues within 1e-2 and
    the direct ``varpro_lm`` within 1e-4."""
    from dmd_era5_tpu_torch.models import varpro_lm, varpro_lm_checkpointed
    from dmd_era5_tpu_torch.models.optdmd import _eig_init
    from dmd_era5_tpu_torch.utils.checkpoint import load_pytree

    t = torch.arange(z.shape[1], dtype=torch.float32, device=z.device)
    h = z.T.to(torch.complex64)
    alpha0 = _eig_init(z, t, DMD_RANK)
    directory = Path(tempfile.mkdtemp(prefix="dmd_era5_ckpt_"))
    try:
        path = str(directory / "lm.h5")
        _, first_s = synced(varpro_lm_checkpointed, h, t, alpha0, path, max_iter=4,
                            chunk_iters=2)
        (_, meta), load_s = synced(load_pytree, path)
        ckpt_bytes = Path(path).stat().st_size
        (alpha, _, rel, n_iters), secs = synced(varpro_lm_checkpointed, h, t, alpha0, path,
                                                max_iter=50, chunk_iters=10)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    direct = varpro_lm(h, t, alpha0, max_iter=50)
    err = matched_eig_error(alpha, week["alpha_true"])
    gap = matched_eig_error(alpha, direct[0])
    check(1 <= meta["iteration"] <= n_iters and err < 1e-2 and gap <= 1e-4,
          f"14h: resumed at {meta['iteration']}, {n_iters} steps, planted {err:.3e}, against "
          f"the direct solve {gap:.3e}")
    log(f"[14h] varpro_lm_checkpointed resumed from step {meta['iteration']} to {n_iters}: "
        f"planted within {err:.2e}, the direct solve within {gap:.2e}, residual "
        f"{float(rel):.3e}; {secs:.3f} s (the first 4 steps with their 2 checkpoints "
        f"{first_s:.3f} s; the checkpoint file {ckpt_bytes} bytes, read back in {load_s:.4f} s)")


def year_config(**overrides) -> dict:
    """The port's parse of config.ini's [era5-svd], with the year's
    overrides (YEAR_CONFIG) and ``overrides``."""
    from dmd_era5_tpu_torch.core import config_parser, config_reader

    raw = config_reader("era5-svd", ROOT / "config.ini")
    return config_parser({**raw, **YEAR_CONFIG, **overrides}, "era5-svd")


def phase_year(seed: int) -> tuple[dict, dict]:
    """Phase 10 on one year of hourly 1-degree ERA5.  Returns the main
    path's launch counts and the K2 / K3 readings at the Hankel shape."""
    from dmd_era5_tpu_torch.ops import hankel, stacked_sketch_matrix
    from dmd_era5_tpu_torch.ops.matmul import _sketch_center_gram_project_cuda, _two_pass
    from dmd_era5_tpu_torch.pipeline import fit_step_fused, fit_step_lean, svd_on_era5
    from dmd_era5_tpu_torch.utils.labels import Field

    torch.cuda.reset_peak_memory_stats()
    times, total = {}, dict.fromkeys(KERNELS, 0)
    (x, truth, row_mean, alpha_true, noise_std), times["generate"] = synced(make_era5_year, seed)
    m, t = x.shape

    def centre():  # in place: a centred copy would be a second 34 GB
        mean = x.mean(dim=1)
        x.sub_(mean[:, None])
        return mean

    mean, times["center"] = synced(centre)
    year = dict(x=x, mean=mean, truth=truth, row_mean=row_mean, alpha_true=alpha_true)
    log(f"[10] ERA5 year X {tuple(x.shape)} f32 ({x.numel() * 4 / 1e9:.2f} GB) generated in "
        f"{times['generate']:.2f} s, centred in place in {times['center']:.2f} s; noise std "
        f"{noise_std:.4f}")

    def references():
        g64 = gram_f64(x)
        lam_x = torch.linalg.eigvalsh(g64).flip(0).clamp_min(0)
        lam_h = torch.linalg.eigvalsh(g64[:-1, :-1] + g64[1:, 1:]).flip(0).clamp_min(0)
        return g64, lam_x.cpu(), lam_h.cpu()

    # the exact SVDs of X and of its d = 2 Hankel embedding H, whose Gram
    # is g[:-1, :-1] + g[1:, 1:] for g = X^T X: f64 sums and f64 eigvalsh
    (g64, lam_x, lam_h), times["references"] = synced(references)
    s_x_ref, s_h_ref = lam_x.sqrt(), lam_h.sqrt()
    log(f"    exact references (f64 Gram and eigvalsh) in {times['references']:.2f} s: s(X)[:8] "
        f"{[round(float(a), 2) for a in s_x_ref[:8]]}, s(H)[99] / s(H)[0] "
        f"{float(s_h_ref[99] / s_h_ref[0]):.3e}")

    log("[10a] K2 and K3 against their plain versions at the path's shapes, K5 against the f64 "
        "Gram (CUDA-event ms)")
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    w_hankel = stacked_sketch_matrix(torch.randn((t - 1, 128), generator=gen, device=x.device), 2, t)
    k2_res, yc = compare_sketch_center_gram("hankel_pass", x, w_hankel, center=False)
    k3_res = compare_project("hankel_pass", x, yc)
    del yc
    w_fit = torch.randn((t, 128), generator=gen, device=x.device)
    _, yc = compare_sketch_center_gram("fit_step", x, w_fit, center=True)
    compare_project("fit_step", x, yc)
    del yc
    log("    K5 on X (K = 8,760) against the f64 Gram of the references; no plain version "
        "(its f32 H and L would be 68.5 GB beside X)")
    k5_res = compare_gram("year_X", x, "bf16_split", exact=g64, reps=1)
    del g64
    log(f"    K7 on the panel the streamed randomized route's first leaf gets from this year: "
        f"Z = X^T (X Omega), Omega ({t} x {R_SKETCH}) from the seed (Z's spectrum s^2); Q not "
        "held to the plain version's")
    omega = torch.randn((t, R_SKETCH), generator=gen, device=x.device)
    compare_householder("year Z", x.T @ (x @ omega), gate_q=False)
    del omega

    log("[10b] svd_on_era5 on config.ini's [era5-svd] defaults, year overrides "
        f"{json.dumps(YEAR_CONFIG)}")
    field = Field(x, ("space", "time"))
    parsed = year_config()
    check((parsed["svd_type"], parsed["delay_embedding"], parsed["precision"],
           parsed["svd_backend"]) == ("randomized", 2, "float32", "auto"),
          f"config.ini's [era5-svd] defaults moved: {parsed}")
    reset_counts()
    (u, s, v), times["svd_on_era5"] = synced(svd_on_era5, None, parsed, da_flat=field)
    launches = launch_counts()
    record_k2_routes()
    u, s, v = (torch.from_numpy(a).cuda() for a in (u, s, v))
    orth = orthonormality(u)
    log(f"    metrics {json.dumps(parsed['metrics'])}; U {tuple(u.shape)}, max|U^T U - I| "
        f"{orth:.2e}, s[:8] {[round(float(a), 2) for a in s[:8]]}, launches {launches}")
    check(parsed["metrics"]["svd_backend"] == "hankel", "the year did not resolve to hankel")
    check(launches == counts(K2=8, K3=8), f"svd_on_era5 launched {launches}, expected K2 8, K3 8")
    check(orth <= 1e-3, f"year Hankel SVD: U^T U - I max {orth:.3e} > 1e-3")
    check(bool((s > 0).all()) and bool((s[1:] <= s[:-1]).all()), "year: s not positive descending")
    inter = check_interlace("year (b) vs the exact Hankel SVD", s.cpu(), s_h_ref[:100])
    log(f"    (b) vs the f64 Hankel SVD: {json.dumps(inter)}")
    log("[10c] optDMD (rank 6) and a 24-step forecast on (b)")
    dmd_and_forecast("year", (u, s, v), year, times, d=2)
    s_rand = s.clone()
    total = {key: total[key] + n for key, n in launches.items()}
    del u, s, v

    log("[10d] svd_type = standard through svd_on_era5: the exact Hankel SVD")
    parsed = year_config(svd_type="standard")
    reset_counts()
    with stage_clock(hankel, "raw_gram") as gram_clock, stage_clock(torch.linalg, "eigh") as eigh_clock:
        (u, s, v), times["svd_on_era5_standard"] = synced(svd_on_era5, None, parsed, da_flat=field)
    launches = launch_counts()
    record_k2_routes()
    times["raw_gram_k5"], times["eigh"] = gram_clock["raw_gram"], eigh_clock["eigh"]
    s = torch.from_numpy(s)
    # the exact route's V_k comes from an f32 eigh of a bf16-split Gram,
    # which resolves the noise-floor directions only roughly: its s are
    # Rayleigh-Ritz values of that subspace, held below the f64 ones
    inter = check_interlace("year (d) vs the exact Hankel SVD", s, s_h_ref[:100])
    ratio_bd = s_rand.double().cpu() / s.double()
    log(f"    metrics {json.dumps(parsed['metrics'])}; raw Gram (K5) {times['raw_gram_k5']} s, "
        f"eigh {times['eigh']} s; s[:8] {[round(float(a), 2) for a in s[:8]]}, s[-1] "
        f"{float(s[-1]):.3f}; vs the f64 Hankel SVD: {json.dumps(inter)}; (b) / (d) from "
        f"{float(ratio_bd.min()):.6f} to {float(ratio_bd.max()):.6f}; launches {launches}")
    check(launches == counts(K2=1, K3=1, K5=1),
          f"year standard path launched {launches}, expected K5 1, K2 1, K3 1")
    total = {key: total[key] + n for key, n in launches.items()}
    del u, s, v

    log("[10e] fit_step_fused and fit_step_lean (f32, k = 100, sketch 128)")
    omega = torch.randn((t, 128), generator=gen, device=x.device)
    states = {}
    for name, step in (("fused", fit_step_fused), ("lean", fit_step_lean)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        states[name], times[f"fit_step_{name}"] = synced(step, x, omega, 100)
        launches = launch_counts()
        record_k2_routes()
        log(f"    {name}: {times[f'fit_step_{name}']:.3f} s, loss {float(states[name].loss):.6e}, "
            f"launches {launches}, device memory over its start "
            f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB")
        check(launches == counts(K2=1, K3=1), f"fit_step_{name} launched {launches}, expected K2 1, K3 1")
        total = {key: total[key] + n for key, n in launches.items()}
    fused, lean = states["fused"], states["lean"]
    s_fit = fused.s.double().cpu()

    def loss_of(energy):  # the loss of a fit that keeps this much of ||Xc||^2, in f64
        return math.sqrt(max(0.0, 1.0 - float(energy) / float(lam_x.sum())))

    u_rel = [float((fused.u[:, :c] - lean.u[:, :c]).norm() / fused.u[:, :c].norm()) for c in (6, 100)]
    agree = dict(s_rel=float(((fused.s - lean.s).abs() / fused.s).max()),
                 loss_fused=float(fused.loss), loss_lean=float(lean.loss),
                 loss_exact=loss_of(lam_x[:100].sum()), loss_rank6=loss_of(lam_x[:6].sum()),
                 # the fit's own s in f64, and the control: the same fit with
                 # its 94 components past the planted 6 dropped
                 loss_fit_s_f64=loss_of((s_fit * s_fit).sum()),
                 loss_control=loss_of((s_fit[:6] * s_fit[:6]).sum()),
                 tail_share=float((s_fit[6:] * s_fit[6:]).sum() / lam_x[6:100].sum()),
                 u_rel_lead6=u_rel[0], u_rel_all=u_rel[1])
    log(f"    fused vs lean, the exact loss and the control: {json.dumps(agree)}")
    inter = check_interlace("year fit step vs the exact SVD of X", s_fit, s_x_ref[:100])
    log(f"    fit step vs the f64 SVD of X: {json.dumps(inter)}")
    check(agree["s_rel"] <= 1e-5 and abs(agree["loss_lean"] / agree["loss_fused"] - 1) <= 1e-4,
          "fit_step_lean does not agree with fit_step_fused")
    check(u_rel[0] <= 1e-4, f"fit steps: leading-6 U differ by {u_rel[0]:.3e}")
    # the step's loss is sqrt(1 - ||Z||^2 / ||Xc||^2), and the planted 6
    # hold all but ~1e-4 of ||Xc||^2: the one-pass sketch's Ritz values,
    # ~5e-6 below the exact ones there, put it well above the exact loss,
    # which the f32 formula barely moves (loss_fit_s_f64).  It must not
    # fall below the optimum, and stays under FIT_LOSS_LIMIT, below the
    # control's reading; components 7-100 must hold their share of the
    # exact tail's energy
    loss_exact = agree["loss_exact"]
    check(loss_exact * (1 - 1e-3) <= agree["loss_fused"] <= loss_exact * FIT_LOSS_LIMIT,
          f"fit step loss {agree['loss_fused']:.6e} vs the exact rank-100 loss {loss_exact:.6e}")
    check(agree["loss_control"] > loss_exact * FIT_LOSS_LIMIT,
          f"the control's loss {agree['loss_control']:.6e} is within the fit's limit")
    check(agree["tail_share"] >= FIT_TAIL_SHARE_MIN,
          f"fit step: components 7-100 hold {agree['tail_share']:.4f} of the exact energy, "
          f"< {FIT_TAIL_SHARE_MIN}")
    del fused, lean, states

    log("[10f] K1 and the two-pass route on the same X and the Hankel pass's sketch (N = 256)")
    args = (torch.float32, False, False, False, None, True)

    def k1():
        return _sketch_center_gram_project_cuda(x, w_hankel, *args)

    def two_pass():
        return _two_pass(x, w_hankel, *args)

    a, b = k1(), two_pass()
    agree = {name: rel_err(p, q)[0] for name, p, q in (("G", a[3], b[3]), ("C", a[4], b[4]))}
    del a, b
    times_f = [event_ms(f, reps=2) for f in (two_pass, k1, k1, two_pass)]
    res_f = dict(k1_ms=(times_f[1] + times_f[2]) / 2, two_pass_ms=(times_f[0] + times_f[3]) / 2,
                 k1_vs_two_pass_rel=agree)
    n = w_hankel.shape[1]  # K1's bound as compare_kernel counts it (Yc and the row stats written)
    res_f["k1_bound_ms"], res_f["k1_bound_by"] = k1_bound(m, t, n, x.dtype, False)
    res_f["k1_stage_device_ms"] = k1_stage_ms(x, w_hankel, torch.float32, dict(center=False))
    K1_STAGES.append(dict(label="year_10f", m=m, t=t, n=n, dtype="float32",
                          **res_f["k1_stage_device_ms"]))
    log(f"    {json.dumps(res_f)}")
    check(max(agree.values()) <= 1e-5, f"K1 and the two-pass route disagree: {agree}")
    # the two routes run the same mainloops (K2 is K1's sketch and G stages,
    # K3 the path of K1's C stage): the fused one no slower than the two
    # passes but for the two calls' order on the card
    check(res_f["k1_ms"] <= K1_VS_TWO_PASS * res_f["two_pass_ms"],
          f"K1 {res_f['k1_ms']:.1f} ms is past {K1_VS_TWO_PASS} x the two passes' "
          f"{res_f['two_pass_ms']:.1f} ms")
    times["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"    stage wall times (s): {json.dumps(times)}")
    del year, x, field
    return total, {"K2": k2_res, "K3": k3_res, "K5": k5_res}


# ------------------------------------------------- phase 15: one-pass and updating SVD

# phase 9c's, 9d's and 14d's wall times before streamed passes read into
# the pinned ring (s; NVIDIA H100 80GB HBM3, 700 W; PERF.md section 5),
# printed beside this run's
PAGEABLE_STREAMED_S = {"9c": 35.47, "9d": 11.84, "14d": 13.52}
# 15a: the one-pass s against phase 8 (b)'s exact ones (leading 6), and the
# bracket of its tail estimate over the true rank-100 error (test_17's)
ONEPASS_LEAD6, ONEPASS_EST_BRACKET = 1e-3, (0.5, 3.0)
# 15c: the updated s against the exact Hankel SVD of the same matrix
# (leading 6), U^T U (test_15's atol)
UPDATE_LEAD6, UPDATE_ORTH = 1e-4, 2e-3


def true_rel_err(x: torch.Tensor, u_host: np.ndarray, s: torch.Tensor, v: torch.Tensor) -> float:
    """||X - U diag(s) V||_F / ||X||_F on the card, X and the host U in
    row chunks, the sums in f64."""
    sv = (s.double()[:, None] * v.double()).float().to(x.device)
    num = den = 0.0
    for r0 in range(0, x.shape[0], CHUNK):
        xb = x[r0:r0 + CHUNK]
        diff = (xb - torch.from_numpy(u_host[r0:r0 + CHUNK]).to(x.device) @ sv).double()
        num += float(diff.square().sum())
        den += float(xb.double().square().sum())
    return math.sqrt(num / den)


def phase_onepass_streamed(week: dict, path: Path, ref8: dict, orth_9c: float,
                           seed: int) -> tuple[dict, dict]:
    """Phase 15 (a), inside phase 9 while its artifact of the centred week
    (d = 1) exists: ``streamed_onepass_svd`` (k = 100) in one disk pass of
    65,536-row blocks, K6, K3 and K4 once a block and K6 once a block for
    the lift from host memory.  The leading 6 s held to phase 8 (b)'s
    within ONEPASS_LEAD6, the tail estimate to ONEPASS_EST_BRACKET of the
    true rank-100 error (computed on the card from X), U^T U printed
    beside 9c's.  Returns the launch counts and the times."""
    from dmd_era5_tpu_torch.pipeline import streamed_onepass_svd

    x = week["x"]
    n_blocks = -(-x.shape[0] // RAND_BLOCK)
    log(f"[15a] streamed_onepass_svd(k = 100) over the artifact: one pass of {n_blocks} blocks "
        f"of {RAND_BLOCK} rows (K6, K3, K4 {n_blocks} each), then the U lift from host memory "
        f"(K6 {n_blocks}).  Predicted (H100): the pass 3-4.5 s (the host's read, as 9c's passes), "
        "the lift 2-5 s, device memory O(one block) above the phase's start")
    reset_counts()
    info: dict = {}
    res, secs, passes, rise = streamed_run("one-pass", streamed_onepass_svd, path, 100,
                                           block_rows=RAND_BLOCK, seed=seed + 15, info=info)
    launches = launch_counts()
    expect = counts(K3=n_blocks, K4=n_blocks, K6=2 * n_blocks)
    check(launches == expect, f"15a: launches {launches}, expected {expect}")
    check(len(passes) == 1, f"15a: the one-pass route read the artifact {len(passes)} times")
    s = res.s.cpu()
    lead = float((s[:6].double() / ref8["s"][:6].double().cpu() - 1).abs().max())
    check(lead <= ONEPASS_LEAD6, f"15a: leading 6 s differ from phase 8 (b) by {lead:.3e}")
    u = torch.from_numpy(res.U).cuda()
    orth = orthonormality(u)
    del u
    true = true_rel_err(x, res.U, res.s, res.V)
    est = info["onepass_tail_rel_err_est"]
    lo, hi = ONEPASS_EST_BRACKET
    check(lo * true <= est <= hi * true,
          f"15a: tail estimate {est:.4e} outside [{lo}, {hi}] x the true error {true:.4e}")
    times = {"total": secs, "pass": passes[0], "lift_and_core": secs - passes[0],
             "memory_rise_mb": rise / 1e6}
    log(f"    s[:8] {[round(float(a), 2) for a in s[:8]]}, leading 6 vs phase 8 (b) {lead:.2e} "
        f"(held {ONEPASS_LEAD6}), max|U^T U - I| {orth:.2e} (9c's {orth_9c:.2e}; not held), "
        f"tail_rel_err_est {est:.5f} against the true rank-100 error {true:.5f} (ratio "
        f"{est / true:.3f}, held to {list(ONEPASS_EST_BRACKET)}); launches {launches}; wall "
        f"(s) {json.dumps(times)}")
    return expect, times


def _merged(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _span(merged: list[tuple[float, float]]) -> float:
    return sum(b - a for a, b in merged)


def _overlap(m1: list[tuple[float, float]], m2: list[tuple[float, float]]) -> float:
    total, j = 0.0, 0
    for a, b in m1:
        while j < len(m2) and m2[j][1] <= a:
            j += 1
        k = j
        while k < len(m2) and m2[k][0] < b:
            total += min(b, m2[k][1]) - max(a, m2[k][0])
            k += 1
    return total


def device_timeline(trace_file: Path) -> dict:
    """From a Chrome trace of ``utils.profiling.trace`` around a
    ``record_function("pass")`` scope: the device's idle share over the
    scope (1 - the union of kernel, memcpy and memset intervals over its
    span) and the share of the host-to-device copies' time that overlaps
    a kernel."""
    events = json.loads(trace_file.read_text())["traceEvents"]
    scope = next(e for e in events if e.get("name") == "pass"
                 and e.get("cat") == "user_annotation" and e.get("ph") == "X")
    w0, w1 = float(scope["ts"]), float(scope["ts"]) + float(scope["dur"])

    def intervals(pred):
        return _merged([(max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"])))
                        for e in events if e.get("ph") == "X" and pred(e)
                        and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0])

    device = intervals(lambda e: e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    kernels = intervals(lambda e: e.get("cat") == "kernel")
    h2d = intervals(lambda e: e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""))
    n_h2d = sum(1 for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""))
    return {"window_s": (w1 - w0) / 1e6, "idle_share": 1 - _span(device) / (w1 - w0),
            "kernel_s": _span(kernels) / 1e6, "h2d_s": _span(h2d) / 1e6, "h2d_copies": n_h2d,
            "h2d_overlapping_kernels": _overlap(h2d, kernels) / max(_span(h2d), 1e-9)}


def q_orthonormality(g: torch.Tensor, ridge: float) -> float:
    """max|Q^T Q - I| of Q = Y R^-1 for the Gram G = Y^T Y and R the
    Cholesky factor of G + ridge mean(diag G) I, in f64 from G alone
    (Q^T Q = R^-T G R^-1); NaN where that Cholesky fails."""
    g = g.double()
    eye = torch.eye(g.shape[0], dtype=g.dtype, device=g.device)
    low, info = torch.linalg.cholesky_ex(g + ridge * g.diagonal().mean() * eye)
    if int(info) != 0:
        return float("nan")
    r_inv = torch.linalg.solve_triangular(low.T, eye, upper=True)
    return float((r_inv.T @ g @ r_inv - eye).abs().max())


def traced_pass(directory: Path, body) -> dict:
    """``device_timeline`` of one call of body (a pass over the artifact)
    under ``utils.profiling.trace``, the card synchronized inside the
    scope so that the span holds all of its work."""
    from dmd_era5_tpu_torch.utils.profiling import trace

    torch.cuda.synchronize()
    with trace(directory):
        with torch.profiler.record_function("pass"):
            body()
            torch.cuda.synchronize()
    return device_timeline(directory / "trace.json")


def phase_trace(week: dict, path: Path, seed: int) -> dict:
    """Phase 15 (d), inside phase 9: one pass of 9c (y = X_blk Z on K6,
    X_blk^T y summed) with each block read into a fresh host array and
    copied from pageable memory on the compute stream (the ring off,
    ``_to_device``'s ``ring=None``) and the same pass as the package runs
    it, each block read into the pinned ring and copied on its stream, in
    turns (off, on, on, off), and one
    pass of 15a (the one-pass sketch's block updates), each traced; the
    orthonormality of that sketch's Q by the Cholesky's ridge, and its
    core (``onepass_core``) on the card beside the same core run on the
    host in f64 from the same W, G and Omega; then K3 and K4 against
    their plain versions at 15a's block shapes (W = Psi^T X_blk with the
    +-1 panel, G of a Y block) and K3 against its bound by
    ``utils.profiling.roofline``.  Not counted."""
    from dmd_era5_tpu_torch.ops.matmul import matmul, project
    from dmd_era5_tpu_torch.ops.onepass import OnePassSketch, onepass_core, psi_panel
    from dmd_era5_tpu_torch.ops.tsqr import qr_positive
    from dmd_era5_tpu_torch.pipeline import streamed_fit
    from dmd_era5_tpu_torch.utils.profiling import roofline

    x = week["x"]
    (n_rows, t_cols), dev = x.shape, x.device
    log("[15d] the profiler (torch.profiler, CUDA activity) on one streamed pass each: 9c's with "
        "the ring off and on in turns, 15a's.  Predicted (H100): a ring pass 2.5-4 s against "
        "5-8 s off; the card idle 70-95% of a 9c pass (the host's read holds it); H2D copies "
        "overlapping kernels ~0 either way (a block's kernels end before the next block is "
        "read)")
    gen = torch.Generator(device="cuda").manual_seed(seed + 16)
    z = qr_positive(torch.randn((t_cols, R_SKETCH), generator=gen, device=dev))[0].contiguous()
    out = {}

    def randomized_pass(ring_on: bool):
        def body():
            acc = torch.zeros((t_cols, R_SKETCH), dtype=torch.float32, device=dev)
            if ring_on:
                blocks = streamed_fit._device_blocks(path, n_rows, t_cols, RAND_BLOCK, dev)
            else:
                blocks = ((r0, streamed_fit._to_device(blk, t_cols, dev, ring=None)) for r0, blk
                          in streamed_fit.prefetched_row_blocks(path, n_rows, RAND_BLOCK))
            for _, b in blocks:
                acc += b.T @ matmul(b, z)
        return body

    sketch = OnePassSketch(t_cols, 100, seed=seed + 15, device=dev, y_store="host")

    def onepass_pass():
        for r0, blk in streamed_fit._device_blocks(path, n_rows, t_cols, RAND_BLOCK, dev):
            sketch.update(r0, blk)

    directory = Path(tempfile.mkdtemp(prefix="dmd_era5_trace_"))
    try:
        # the ring off and on in turns (off, on, on, off): a pass's time moves
        # with the host's read
        for name, body in (("9c_ring_off", randomized_pass(False)),
                           ("9c_ring_on", randomized_pass(True)),
                           ("9c_ring_on_2", randomized_pass(True)),
                           ("9c_ring_off_2", randomized_pass(False)), ("15a", onepass_pass)):
            out[name] = traced_pass(directory / name, body)
            log(f"    {name}: {json.dumps(out[name])}")
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    # 15a's U^T U: Q = Y R^-1 from G alone, R the Cholesky of G ridged by
    # the core's 1e-7 of its mean diagonal and by less
    out["q_orthonormality_by_ridge"] = {
        ridge: q_orthonormality(sketch.g, ridge) for ridge in (1e-7, 1e-10, 1e-13)}
    log(f"    15a's Q = Y R^-1 from its G: max|Q^T Q - I| by the Cholesky's ridge (of G's mean "
        f"diagonal) {json.dumps(out['q_orthonormality_by_ridge'])}")
    # the same core on the host in f64 from the same sums: U^T U = lift^T G lift
    g_host = sketch.g.cpu()
    cores = {}
    for where, args in (("card", (sketch.w, sketch.g, sketch.omega)),
                        ("host_f64", (sketch.w.cpu(), g_host, sketch.omega.cpu()))):
        lift, s_core, _, est = onepass_core(*args, 100)
        lift = lift.cpu().double()  # (r, k)
        eye = torch.eye(lift.shape[1], dtype=torch.float64)
        cores[where] = {"s": s_core.cpu().double(), "est": float(est),
                        "u_orth_from_g": float((lift.T @ g_host @ lift - eye).abs().max())}
    out["core_card_vs_host_f64"] = {
        "s_rel": float((cores["card"]["s"] / cores["host_f64"]["s"] - 1).abs().max()),
        **{f"u_orth_from_g_{w}": c["u_orth_from_g"] for w, c in cores.items()},
        **{f"tail_rel_err_est_{w}": c["est"] for w, c in cores.items()}}
    log(f"    15a's core on the card and on the host in f64 from the same W, G, Omega: "
        f"{json.dumps(out['core_card_vs_host_f64'])}")

    # K3, K6 and K4 against their plain versions at 15a's block shapes: W =
    # Psi^T X_blk with the +-1 panel (3xTF32), the block's Y = X_blk Omega
    # (K6 at 128 columns a CTA) and its G
    blk = x[:RAND_BLOCK]
    psi = psi_panel(seed + 15, 0, RAND_BLOCK, 256, dev)
    out["k3_block"] = compare_project("15a block", blk, psi)
    out["k6_block"] = compare_matmul("15a Y block", blk, sketch.omega, f64_gate=True)
    y_blk = matmul(blk, sketch.omega)
    out["k4_y_block"] = compare_gram("15a Y block", y_blk, "highest", reps=20)
    del y_blk
    ms = device_ms(lambda: project(blk, psi))
    m, n = blk.shape[0], psi.shape[1]
    flops, nbytes = 3 * 2.0 * m * n * t_cols, 4.0 * (m * t_cols + m * n + n * t_cols)
    rf = roofline(flops, nbytes, ms / 1e3, device=dev, dtype="tf32")
    b_ms, by = bound(flops, PEAK_TF32, nbytes)
    out["k3_roofline"] = {**rf, "device_ms": ms, "bound_ms": b_ms, "bound_by": by}
    log(f"    K3 at 15a's block (X {m} x {t_cols}, Psi {m} x {n}): device {ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({by}); roofline {json.dumps(rf)}")
    return out


def phase_onepass_config1(seed: int) -> dict:
    """Phase 15 (b): north-star config 1 (config.ini's [era5-download] mock
    slice and [era5-svd]) with ``svd_backend = onepass``, in memory:
    ``compute_svd_results`` packs the embedded matrix and streams it in one
    pass (one block: K6 2, K3 1, K4 1).  The backend and the estimate in
    the attrs, U's shape and U^T U, the rank-k reconstruction of the
    embedded X within 1.6 x the optimal error (test_20's bound)."""
    from dmd_era5_tpu_torch.core import config_parser
    from dmd_era5_tpu_torch.pipeline import era5_download, era5_svd
    from dmd_era5_tpu_torch.snapmat import apply_delay_embedding, flatten_era5_variables
    from dmd_era5_tpu_torch.snapmat import standardize_data

    log("[15b] config 1 (mock, config.ini) with svd_backend = onepass, in memory.  Predicted "
        "(H100): under 0.5 s; K6 2, K3 1, K4 1; the estimate above 0.1 on the i.i.d.-noise "
        "mock (its warning printed)")
    with stage_root():
        np.random.seed(seed)
        dl = config_parser(stage_config("era5-download"), "era5-download")
        fs = era5_download.download_era5_data(dl, use_mock_data=True)
        cfg = config_parser(stage_config("era5-svd", source_path="mock_data",
                                         svd_backend="onepass"), "era5-svd")
        reset_counts()
        res, secs = synced(era5_svd.compute_svd_results, fs, cfg)
    launches = launch_counts()
    expect = counts(K3=1, K4=1, K6=2)
    check(launches == expect, f"15b: launches {launches}, expected {expect}")
    est = res.attrs.get("onepass_tail_rel_err_est")
    check(res.attrs["svd_backend"] == "onepass" and isinstance(est, float) and est > 0,
          f"15b: attrs svd_backend {res.attrs['svd_backend']}, estimate {est}")
    d, k = cfg["delay_embedding"], cfg["n_components"]
    std, _, _ = standardize_data(fs[cfg["variables"]], scale=False)
    x = np.asarray(apply_delay_embedding(flatten_era5_variables(std), d).data, np.float64)
    u = np.asarray(res["U"].values, np.float64)
    check(u.shape == (x.shape[0], k), f"15b: U {u.shape}")
    orth = float(np.abs(u.T @ u - np.eye(k)).max())
    err = float(np.linalg.norm(x - u @ (u.T @ x)))
    optimal = float(np.linalg.norm(np.linalg.svd(x, compute_uv=False)[k:]))
    check(err <= 1.6 * optimal, f"15b: reconstruction {err:.4e} > 1.6 x optimal {optimal:.4e}")
    log(f"    U {u.shape}, max|U^T U - I| {orth:.2e}, reconstruction / optimal {err / optimal:.4f} "
        f"(held 1.6), onepass_tail_rel_err_est {est}, launches {launches}, "
        f"{secs:.3f} s")
    return expect


def phase_incremental(week: dict, fs, svd_c, seed: int) -> dict:
    """Phase 15 (c), after phase 13 on the week still on the card: the
    update of 13c's SVD (the first 144 hours, d = 2, k = 100) by the
    withheld 24 hours and the boundary hour, ``update_svd_results`` on the
    card (31,147,200 x 24 new columns: K3 once, K6 once for U L and once
    a LIFT_ROWS chunk of the lift), ``era5_svd_update.update_from_slice``
    (the stage's compute body) on 13c's results and ``fs``, the slice as
    phase 12's main read it back from its file.  Its own files (a base
    slice and artifact, the week's slice, the updated artifact, the
    store's copies: ~70 GB) would pass the card machine's 45 GiB cap on
    what one call writes to its disk, which reads back at 0.2-0.7 GB/s
    (12b): the week goes through its files once, in 12b.  V's time is held to the week's 167
    embedded hours, U^T U to UPDATE_ORTH, the leading 6 s to the exact
    Hankel SVD of the same matrix (phase 7's route on the week centred by
    the 144-hour mean) within UPDATE_LEAD6.  The update's own operands
    then hold K3 (U^T C) and K6 (U L, the first lift chunk [U, J] U_m)
    against their plain versions and the f64 sums.  Then config 5's DMD
    forecast rollout (rank 6, 24 steps) on the updated results, the
    planted eigenvalues within 1e-2.  Then 15b.  Returns the launch
    counts."""
    from dmd_era5_tpu_torch.core import config_parser
    from dmd_era5_tpu_torch.ops import hankel_exact_svd, streaming
    from dmd_era5_tpu_torch.ops.streaming import LIFT_ROWS
    from dmd_era5_tpu_torch.pipeline import era5_dmd, era5_svd_update, incremental

    d, k = 2, 100
    x = week["x"]  # the raw week: phase 12's slice added the row means in place
    n_rows = x.shape[0]
    n_lift = -(-n_rows * d // LIFT_ROWS)
    log(f"[15c] update of 13c's SVD (144 h, d = {d}, k = {k}) by the withheld {HOLDOUT} hours + "
        f"the boundary hour: {n_rows * d} x {HOLDOUT} new columns (K3 1, K6 1 + {n_lift}).  "
        "Predicted (H100): the update 0.1-0.5 s on the card plus U's moves (12.46 GB each way "
        "at 2-9 GB/s), device memory rise under 35 GB; leading 6 s within 1e-4 of the exact "
        "SVD of the same matrix")
    mean144 = torch.from_numpy(np.asarray(svd_c["X_mean"].values[:n_rows], np.float32)).cuda()
    xc = x - mean144[:, None]
    del mean144
    ref, t_ref = synced(hankel_exact_svd, xc, d, k)
    s_ref = ref.s.double().cpu()
    del ref, xc

    cfg = stage_config("era5-svd", **WEEK_CONFIG, **WEEK_SVD)
    times = {"exact_reference": t_ref}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    with (stage_clock(incremental, "svd_rank_update") as clock,
          first_operands(streaming, "project", 1) as k3_args,
          first_operands(streaming, "matmul", 2) as k6_args):
        parsed = config_parser(dict(cfg), "era5-svd")
        log("    the update takes 13c's results and the slice as 12b's main read it back from its "
            "file (the week's files once, in 12b: the machine's disk-write cap)")
        updated, times["update_from_slice"] = synced(era5_svd_update.update_from_slice,
                                                     svd_c, fs, parsed)
        expect = counts(K3=1, K6=1 + n_lift)
    times["svd_rank_update"] = sum(clock["svd_rank_update"])
    times["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    launches = launch_counts()
    check(launches == expect, f"15c: launches {launches}, expected {expect}")
    t_v = np.asarray(updated["V"].coords["time"].values, dtype="datetime64[ns]")
    want = (np.datetime64(WEEK_CONFIG["start_datetime"], "ns")
            + np.arange(d - 1, T_HOURS) * np.timedelta64(3600, "s"))
    check(np.array_equal(t_v, want), f"15c: V's time {t_v[:2]}..{t_v[-1:]} ({len(t_v)} hours)")
    u = torch.from_numpy(updated["U"].values).cuda()
    orth = orthonormality(u)
    del u
    check(orth <= UPDATE_ORTH, f"15c: U^T U - I max {orth:.3e} > {UPDATE_ORTH}")
    rel = (torch.from_numpy(updated["s"].values).double() / s_ref - 1).abs()
    check(float(rel[:6].max()) <= UPDATE_LEAD6,
          f"15c: leading 6 s off the exact SVD of the same matrix by {float(rel[:6].max()):.3e}")
    log(f"    U {updated['U'].shape}, V {updated['V'].shape} (hours {d - 1}-{T_HOURS - 1}), "
        f"max|U^T U - I| {orth:.2e} (held {UPDATE_ORTH}), s vs the exact Hankel SVD of the "
        f"same matrix: leading 6 {float(rel[:6].max()):.2e} (held {UPDATE_LEAD6}), the rest up "
        f"to {float(rel.max()):.2e} (at {int(rel.argmax())}); launches {launches}; wall (s) "
        f"{json.dumps({a: round(b, 3) for a, b in times.items()})} (peak_gb: device memory "
        "over the update's start)")
    # K3 and K6 on the update's own operands: U^T C (project(C, U)), U L
    # and the first lift chunk
    log("    K3 and K6 at the update's shapes against their plain versions and the f64 sums")
    compare_project("15c U^T C", *k3_args[0])
    for label, (a, b) in zip(("15c U L", "15c lift chunk"), k6_args):
        compare_matmul(label, a, b, f64_gate=True)
    del k3_args, k6_args

    # config 5's DMD forecast rollout on the updated factors
    parsed_dmd = config_parser(stage_config("era5-dmd", **WEEK_CONFIG, **WEEK_SVD,
                                            dmd_rank=DMD_RANK, forecast_steps=FORECAST_STEPS),
                               "era5-dmd")
    reset_counts()
    res, t_fit = synced(era5_dmd.fit_dmd_from_svd_results, updated, parsed_dmd)
    check(launch_counts() == counts(), f"15c DMD: launched {launch_counts()}")
    err = check_dmd_fit("15c", res, week)
    check(tuple(res["forecast"].shape) == (n_rows, T_HOURS - d + 1 + FORECAST_STEPS),
          f"15c: forecast {tuple(res['forecast'].shape)}")
    log(f"    DMD forecast rollout on the updated SVD (rank {DMD_RANK}, {FORECAST_STEPS} steps): "
        f"eigenvalues matched error vs planted {err:.2e} (held 1e-2), forecast "
        f"{tuple(res['forecast'].shape)}, {t_fit:.3f} s, no kernel launch")
    del res, updated
    out = dict(expect)
    for key, n in phase_onepass_config1(seed).items():
        out[key] += n
    return out


# phase 16: config.ini's real-data source path on a store laid out as ARCO-ERA5
# (tests/fixtures/arco_era5_fullscale.zmetadata.json): one hour of all 37
# levels a chunk, so one level costs 37 levels' bytes
ARCO_METADATA = "tests/fixtures/arco_era5_fullscale.zmetadata.json"
ARCO_LEVELS = (1, 2, 3, 5, 7, 10, 20, 30, 50, 70, 100, 125, 150, 175, 200, 225, 250, 300,
               350, 400, 450, 500, 550, 600, 650, 700, 750, 775, 800, 825, 850, 875, 900,
               925, 950, 975, 1000)
# config.ini's 97-hour window (2019-01-01T00 to 2019-01-05T00) and one hour
# past each end, which the read must skip
ARCO_START, ARCO_HOURS = "2018-12-31T23", 99
ARCO_LEVEL_OFFSET_K = 1.0  # each level's own offset, its index times this
ARCO_PACKED_BLOCK = 1 << 16  # the streamed SVD's row block over the packed X


def arco_hours(seed: int):
    """The store's hours, one at a time on the card: a generator of
    (37 * 721 * 1440,) f32 fields in the store's (level, latitude,
    longitude) order, made by ``make_era5``'s recipe -- per row the mock
    temperature's mean (265 - lapse) cos(latitude), plus the level's
    index times ``ARCO_LEVEL_OFFSET_K`` (so that a wrong level index
    shows), the planted damped pairs with random complex patterns, and
    noise at 1% of the signal's rms -- and, first, the planted
    eigenvalues."""
    dev = torch.device("cuda")
    n_lev, block = len(ARCO_LEVELS), N_LAT * N_LON
    s_rows = n_lev * block
    gen = torch.Generator(device=dev).manual_seed(seed)
    hours = torch.arange(ARCO_HOURS, dtype=torch.float64, device=dev)
    alpha = torch.tensor([complex(d, 2 * math.pi / p) for d, p, _ in PAIRS],
                         dtype=torch.complex128, device=dev)
    amps = torch.tensor([a for *_, a in PAIRS], dtype=torch.float64, device=dev)
    dyn = (amps[:, None] * torch.exp(alpha[:, None] * hours[None, :])).to(torch.complex64)
    noise_std = NOISE_FRACTION * float(torch.sqrt((dyn.abs() ** 2).sum(0).mean()))
    rows = torch.arange(s_rows, device=dev)
    level = torch.tensor(ARCO_LEVELS, dtype=torch.float32, device=dev)[rows // block]
    lat = 90.0 - 0.25 * ((rows // N_LON) % N_LAT).float()
    row_mean = ((265.0 - (1000.0 - level) / 100.0) * torch.cos(torch.deg2rad(lat))
                + ARCO_LEVEL_OFFSET_K * (rows // block).float())
    del rows, level, lat
    p_re = torch.randn((s_rows, len(PAIRS)), generator=gen, device=dev)
    p_im = torch.randn((s_rows, len(PAIRS)), generator=gen, device=dev)
    yield torch.cat([alpha, alpha.conj()]).to(torch.complex64)
    for h in range(ARCO_HOURS):
        x = torch.addmv(row_mean, p_re, dyn[:, h].real.contiguous())
        x.addmv_(p_im, dyn[:, h].imag.contiguous(), alpha=-1.0)
        x.add_(torch.randn(s_rows, generator=gen, device=dev), alpha=noise_std)
        yield x


def write_arco_store(root: Path, seed: int) -> dict:
    """Phase 16 (a): the store under ``root``, written one hour at a time.

    Variable ``temperature`` (ARCO_HOURS, 37, 721, 1440) f32 in chunks of
    one hour, the levels in ARCO-ERA5's order, CF int64 time in hours
    since 1900-01-01, ``_ARRAY_DIMENSIONS``, fill NaN, consolidated
    ``.zmetadata``: the committed full-scale metadata with the shapes of
    this window.  Every chunk is a blosc frame flagged memcpy (0x2, the
    shuffle bit clear), which c-blosc and both packages' readers decode
    alike.  Returns the planted eigenvalues, the window's hours of the
    1000 hPa level (host, (97, 721 * 1440)), the last hour's raw bytes
    and the write's wall time."""
    fixture = json.loads((ROOT / ARCO_METADATA).read_text())["metadata"]
    n_lev = len(ARCO_LEVELS)
    epoch_hours = int((np.datetime64(ARCO_START, "h") - np.datetime64("1900-01-01", "h"))
                      .astype(np.int64))
    coords = {
        "time": np.arange(epoch_hours, epoch_hours + ARCO_HOURS, dtype="<i8"),
        "level": np.asarray(ARCO_LEVELS, dtype="<i8"),
        "latitude": (90.0 - 0.25 * np.arange(N_LAT)).astype("<f4"),
        "longitude": (0.25 * np.arange(N_LON)).astype("<f4"),
    }
    meta = {".zgroup": {"zarr_format": 2}, ".zattrs": fixture[".zattrs"]}
    for name, values in coords.items():
        meta[f"{name}/.zarray"] = {**fixture[f"{name}/.zarray"], "shape": [len(values)],
                                   "chunks": [len(values)]}
        meta[f"{name}/.zattrs"] = fixture[f"{name}/.zattrs"]
        (root / name).mkdir(parents=True)
        (root / name / "0").write_bytes(values.tobytes())
    meta["temperature/.zarray"] = {**fixture["temperature/.zarray"],
                                   "shape": [ARCO_HOURS, n_lev, N_LAT, N_LON],
                                   "chunks": [1, n_lev, N_LAT, N_LON]}
    meta["temperature/.zattrs"] = fixture["temperature/.zattrs"]
    (root / "temperature").mkdir()
    (root / ".zgroup").write_text(json.dumps(meta[".zgroup"]))
    (root / ".zmetadata").write_text(json.dumps({"metadata": meta,
                                                 "zarr_consolidated_format": 1}))

    block = N_LAT * N_LON
    level_1000 = ARCO_LEVELS.index(1000)
    truth = np.empty((ARCO_HOURS - 2, block), dtype=np.float32)
    host = torch.empty(n_lev * block, dtype=torch.float32, pin_memory=True)
    nbytes = host.numel() * 4
    # blosc1 header: version, versionlz, flags (memcpy), typesize, nbytes,
    # blocksize, cbytes (the 16-byte header plus the raw bytes)
    header = struct.pack("<BBBBIII", 2, 1, 0x2, 4, nbytes, nbytes, 16 + nbytes)
    t0 = time.perf_counter()
    hours = arco_hours(seed)
    planted = next(hours)
    for h, field in enumerate(hours):
        host.copy_(field)
        with open(root / "temperature" / f"{h}.0.0.0", "wb") as f:
            f.write(header)
            f.write(host.numpy().data)
        if 1 <= h <= ARCO_HOURS - 2:
            truth[h - 1] = host.numpy()[level_1000 * block:(level_1000 + 1) * block]
    secs = time.perf_counter() - t0
    return {"planted": planted, "truth": truth, "last_hour": host.numpy().tobytes(),
            "seconds": secs, "chunk_bytes": nbytes + 16}


@contextlib.contextmanager
def store_gets():
    """Every key a local Zarr store is asked for, with the bytes it gave,
    into the yielded list."""
    from dmd_era5_tpu_torch.snapmat import zarr_reader

    saved, gets = zarr_reader._LocalStore.get, []

    def get(self, key):
        data = saved(self, key)
        gets.append((key, 0 if data is None else len(data)))
        return data

    zarr_reader._LocalStore.get = get
    try:
        yield gets
    finally:
        zarr_reader._LocalStore.get = saved


def arco_read(store: Path, info: dict):
    """Phase 16 (b): config.ini's [era5-download] as it is but for its
    source_path, the store: ``download_era5_data`` (the slice saved under
    the stage root).  Holds
    the chunks read (exactly the window's 97) and the slice bit for bit
    against the generated 1000 hPa hours.  Returns the slice and its
    numbers."""
    from dmd_era5_tpu_torch.core import config_parser
    from dmd_era5_tpu_torch.pipeline import era5_download

    parsed = config_parser(stage_config("era5-download", source_path=str(store)),
                           "era5-download")
    with store_gets() as gets, stage_clock(era5_download, "save_fieldset") as clock:
        t0 = time.perf_counter()
        fs = era5_download.download_era5_data(parsed)
        (save_s,) = clock["save_fieldset"]
        secs = time.perf_counter() - t0 - save_s  # the read alone
    n_window = ARCO_HOURS - 2
    chunks = [(key, n) for key, n in gets if key.startswith("temperature/")]
    check([key for key, _ in chunks] == [f"temperature/{h}.0.0.0" for h in range(1, n_window + 1)],
          f"the read fetched {len(chunks)} chunks, not the window's {n_window}: "
          f"{[key for key, _ in chunks][:3]}...")
    data = fs["temperature"].data
    check(data.shape == (n_window, 1, N_LAT, N_LON) and data.dtype == np.float32,
          f"slice {data.shape} {data.dtype}")
    check(np.array_equal(data.reshape(n_window, -1).view(np.uint32), info["truth"].view(np.uint32)),
          "the slice differs from the generated 1000 hPa hours")
    times = fs.coord("time").values
    check(times[0] == np.datetime64("2019-01-01T00", "ns") and len(times) == n_window
          and fs.coord("level").values.tolist() == [1000], "the slice's coordinates")
    read_bytes, kept = sum(n for _, n in chunks), data.nbytes
    saved = Path(parsed["save_path"]).stat().st_size
    out = {"seconds": secs, "chunks": len(chunks), "bytes_read": read_bytes,
           "bytes_kept": kept, "read_over_kept": read_bytes / kept,
           "read_gb_s": read_bytes / secs / 1e9, "slice_bytes": saved, "save_s": save_s,
           "save_gb_s": gb_per_s(saved, save_s)}
    log(f"[16b] config.ini [era5-download] from the store: slice {data.shape}, {len(chunks)} "
        f"chunks read in {secs:.2f} s ({read_bytes / secs / 1e9:.2f} GB/s), bytes read "
        f"{read_bytes} / kept {kept} = {read_bytes / kept:.3f}, equal bit for bit to the "
        f"generated hours; the slice saved ({saved} bytes) in {save_s:.3f} s "
        f"({out['save_gb_s']:.2f} GB/s)")
    return fs, out


def arco_stages(fs, store: Path, info: dict, s_exact_h: torch.Tensor) -> tuple[dict, dict]:
    """Phase 16 (c): ``era5_svd.compute_svd_results`` on the card on
    [era5-svd] as it is but for its source_path (randomized, d = 2, 10
    components, centred; K1 5 launches), then ``era5_dmd``'s fit and
    forecast on [era5-dmd] (rank 6, 24 steps): the planted eigenvalues
    within 1e-2, s within the interlace of the f64 exact s of H_2(X),
    U^T U to 1e-3.  Returns the launch counts and K1's operands."""
    from dmd_era5_tpu_torch.core import config_parser
    from dmd_era5_tpu_torch.ops import hankel as hankel_mod
    from dmd_era5_tpu_torch.pipeline import era5_dmd, era5_svd

    parsed_svd = config_parser(stage_config("era5-svd", source_path=str(store)), "era5-svd")
    parsed_dmd = config_parser(stage_config("era5-dmd", source_path=str(store)), "era5-dmd")
    times = {}
    reset_counts()
    with first_operands(hankel_mod, "sketch_center_gram_project", 1) as k1_ops:
        svd, times["compute_svd_results"] = synced(era5_svd.compute_svd_results, fs, parsed_svd)
        res, times["dmd_fit_and_forecast"] = synced(era5_dmd.fit_dmd_from_svd_results, svd,
                                                    parsed_dmd)
    launches = launch_counts()
    check(launches == counts(K1=5), f"16c launched {launches}, expected K1 5 and no other")
    k, n_rows = parsed_svd["n_components"], N_LAT * N_LON
    s = torch.from_numpy(np.asarray(svd["s"].values))
    check(tuple(svd["U"].shape) == (2 * n_rows, k) and len(s) == k, f"16c U {svd['U'].shape}")
    inter = check_interlace("16c vs the f64 exact s of H_2(X)", s, s_exact_h.cpu())
    orth = orthonormality(torch.from_numpy(np.asarray(svd["U"].values)).cuda())
    check(orth <= 1e-3, f"16c: U^T U - I max {orth:.3e} > 1e-3")
    eig_err = check_dmd_fit("16c", res, {"alpha_true": info["planted"]})
    check(tuple(res["forecast"].shape) == (n_rows, ARCO_HOURS - 2 - 1 + FORECAST_STEPS),
          f"16c forecast {tuple(res['forecast'].shape)}")
    check(bool(torch.isfinite(res["forecast"].data).all()), "16c forecast not finite")
    ref = {"U": np.asarray(svd["U"].values), "s": np.asarray(svd["s"].values)}
    log(f"[16c] the SVD and DMD stages on the slice: s[:7] {[round(float(a), 2) for a in s[:7]]}, "
        f"{json.dumps(inter)}, max|U^T U - I| {orth:.2e}, eigenvalues "
        f"{[complex(round(a.real, 5), round(a.imag, 5)) for a in res['eigenvalues'].values]}, "
        f"matched error vs planted {eig_err:.2e}, forecast {tuple(res['forecast'].shape)}, "
        f"launches {launches}; wall (s) {json.dumps(times)}")
    return launches, {"k1": k1_ops[0], "times": times, "svd": ref}


def nc4_stage(fs, store: Path, ref: dict) -> tuple[dict, dict]:
    """Phase 16 (h): (b)'s slice written as netCDF-C lays out a compressed
    netCDF-4 variable (``tests/torch_nc4_writer.py``) at the SVD stage's
    slice path, loaded by ``load_fieldset`` and held bit for bit to the
    slice, then ``era5_svd.main`` on [era5-svd] as (c) takes it (its
    source_path the store) from that file: K1 5 launches, each distinct
    K1 call then held on its operands against its plain version and the
    f64 sums (uncounted; within 5e-7, which one TF32 pass misses at these
    rows), U and s bit for bit (c)'s.  The file is deleted
    after.  Returns the launch counts and the times."""
    from dmd_era5_tpu_torch.core import config_parser
    from dmd_era5_tpu_torch.pipeline import era5_svd
    from dmd_era5_tpu_torch.utils.io_h5 import load_fieldset

    writer = load_tool("tests/torch_nc4_writer.py")
    cfg = stage_config("era5-svd", source_path=str(store))
    parsed = config_parser(dict(cfg), "era5-svd")
    path, times = Path(parsed["era5_slice_path"]), {}
    check(not Path(parsed["save_path"]).exists(), "16h: SVD results already in the stage root")
    path.unlink(missing_ok=True)
    try:
        info, times["nc4_write"] = synced(writer.write_nc4_fieldset, fs, path, chunk_rows=1,
                                          level=4, threads=os.cpu_count() or 1)
        with open(path, "rb") as fh:
            head = fh.read(48)
            fh.seek(struct.unpack_from("<Q", head, 36)[0])
            root = fh.read(5)
        check(head[8] == 2 and root == b"OHDR\x02",
              "16h: the file is not of superblock 2 with a version 2 root object header")
        back, times["nc4_load"] = synced(load_fieldset, path)
        got, want = back["temperature"].data, np.asarray(fs["temperature"].data)
        check(got.shape == want.shape and got.dtype == want.dtype
              and np.array_equal(got.view(np.uint32), want.view(np.uint32)),
              "16h: the netCDF-4 file's slice differs from (b)'s")
        check(all(np.array_equal(back.coord(c).values, fs.coord(c).values)
                  for c in ("time", "level", "latitude", "longitude")),
              "16h: the netCDF-4 file's coordinates differ from (b)'s")
        del back, got
        reset_counts()
        with kernel_operands() as calls, \
                stage_clock(era5_svd, "load_fieldset", "svd_on_era5") as clock:
            (res, added, retrieved), times["svd_main"] = synced(era5_svd.main, dict(cfg),
                                                                write_artifact=False)
        launches = launch_counts()
        check(not added and not retrieved, "16h: main added to or retrieved from a store")
        check(launches == counts(K1=5), f"16h launched {launches}, expected K1 5 and no other")
        (times["main_load"],), (times["main_svd_on_era5"],) = clock["load_fieldset"], \
            clock["svd_on_era5"]
        u, s = np.asarray(res["U"].values), np.asarray(res["s"].values)
        same = (u.shape == ref["U"].shape and np.array_equal(u.view(np.uint32),
                                                             ref["U"].view(np.uint32))
                and np.array_equal(s.view(np.uint32), ref["s"].view(np.uint32)))
        check(same, "16h: U and s from the netCDF-4 file are not (c)'s bit for bit")
        del res, u
        # at 1,038,240 rows one emulated TF32 pass comes within 1e-6 of the
        # f64 sums (9.5e-7 on G): 5e-7 tells 3xTF32 (~2e-7) from it
        held = hold_operands("16h", calls, k1_limit=5e-7)
    finally:
        path.unlink(missing_ok=True)
    raw = info["raw_bytes"]
    out = {**info, **times, "ratio": raw / info["compressed_bytes"],
           "write_gb_s": gb_per_s(raw, times["nc4_write"]),
           "load_gb_s": gb_per_s(raw, times["nc4_load"]), "k1_held": len(held)}
    log(f"[16h] {smi_line()} | (b)'s slice as a netCDF-4 file (superblock 2, version 2 object "
        f"headers, {info['chunks']} chunks of one hour, shuffle + deflate 4): {info['bytes']} "
        f"bytes on disk for {raw} raw (ratio {out['ratio']:.3f}), written in "
        f"{times['nc4_write']:.3f} s ({out['write_gb_s']:.3f} GB raw/s, {os.cpu_count()} "
        f"threads); load_fieldset {times['nc4_load']:.3f} s, decode rate {out['load_gb_s']:.3f} "
        f"GB raw/s (the page cache's copy), equal bit for bit to (b)'s slice; era5_svd.main from "
        f"it in {times['svd_main']:.3f} s (its load {times['main_load']:.3f} s, svd_on_era5 "
        f"{times['main_svd_on_era5']:.3f} s), launches {launches}, U and s bit for bit (c)'s; "
        f"{len(held)} distinct K1 calls held on their operands")
    return launches, out


def arco_packed(store: Path, fs, directory: Path, seed: int) -> tuple[dict, dict]:
    """Phase 16 (d): ``zarr_to_packed`` from the store to a ``.npy``,
    equal bit for bit to ``build_snapshot_matrix`` of (b)'s slice; then
    ``streamed_randomized_svd`` (k 10) over it, K6 and K7 launches held
    exactly, s within the interlace of the f64 exact s of the same X on
    the card (its leading 7, the raw X's mean and the planted 6, within
    1e-4).  Then the same to an HDF5 ``.h5`` (the port's codec): X read
    back bit for bit, and the streamed SVD from it with the same seed,
    U and s equal bit for bit to the ``.npy`` route's, each pass timed
    beside the ``.npy`` one.  Returns the launch counts, the operands of
    K6's first block and K7's first leaf, X on the card and the times."""
    import importlib

    from dmd_era5_tpu_torch.ops import sklearn_n_iter
    from dmd_era5_tpu_torch.pipeline import streamed_fit, streamed_randomized_svd
    from dmd_era5_tpu_torch.snapmat import build_snapshot_matrix, zarr_to_packed

    tsqr_mod = importlib.import_module("dmd_era5_tpu_torch.ops.tsqr")  # ops.tsqr is a function
    path, times, k = directory / "arco_x.npy", {}, 10
    window = [fs.attrs["start_datetime"], fs.attrs["end_datetime"]]
    start, end = (np.datetime64(w).astype("datetime64[s]").item() for w in window)
    shape, times["zarr_to_packed"] = synced(zarr_to_packed, store, path, ["temperature"],
                                            start, end, [1000])
    x_host, _ = build_snapshot_matrix(fs)
    packed = np.load(path, mmap_mode="r")
    check(shape == x_host.shape and np.array_equal(packed.view(np.uint32), x_host.view(np.uint32)),
          "zarr_to_packed's X differs from build_snapshot_matrix's")
    del packed
    n_iter = sklearn_n_iter(k, shape)
    n_blocks = -(-shape[0] // ARCO_PACKED_BLOCK)
    reset_counts()
    with first_operands(streamed_fit, "matmul", 1) as k6_ops, \
            first_operands(tsqr_mod, "householder_panel", 1) as k7_ops:
        res, times["streamed_randomized"], times["passes"], _ = streamed_run(
            "16d streamed_randomized_svd", streamed_randomized_svd, path, k,
            block_rows=ARCO_PACKED_BLOCK, seed=seed + 16)
    launches = launch_counts()
    expect = counts(K6=(n_iter + 1) * n_blocks, K7=n_iter)
    check(launches == expect, f"16d launched {launches}, expected {expect}")
    s_exact = torch.linalg.eigvalsh(gram_f64(torch.from_numpy(x_host).cuda())).flip(0)
    s_exact = s_exact.clamp_min(0).sqrt()[:k]
    inter = check_interlace("16d vs the f64 exact s of X", res.s, s_exact, n_lead=7)
    orth7 = orthonormality(torch.from_numpy(res.U[:, :7]).cuda())
    check(orth7 <= 1e-3, f"16d: leading 7 columns of U off orthonormal by {orth7:.3e}")
    log(f"[16d] zarr_to_packed -> {path.name} {shape} in {times['zarr_to_packed']:.2f} s, equal bit "
        f"for bit to build_snapshot_matrix; streamed_randomized_svd (k {k}, n_iter {n_iter}, "
        f"{n_blocks} blocks): s[:8] {[round(float(a), 2) for a in res.s[:8]]}, {json.dumps(inter)}, "
        f"leading-7 max|U^T U - I| {orth7:.2e}, launches {launches}")
    npy_passes = times["passes"]
    launches_h5, h5_times = arco_packed_h5(store, x_host, res, window, k, seed)
    times.update(h5_times)
    for key, n in launches_h5.items():
        launches[key] += n
    log(f"    16d passes (s): .npy {[round(t, 3) for t in npy_passes]}, .h5 "
        f"{[round(t, 3) for t in h5_times['h5_passes']]}")
    return launches, {"k6": k6_ops[0], "k7": k7_ops[0], "times": times}


def arco_packed_h5(store: Path, x_host: np.ndarray, res_npy, window, k: int,
                   seed: int) -> tuple[dict, dict]:
    """16d's HDF5 route: ``zarr_to_packed`` to an ``.h5`` beside the
    ``.npy`` (the port's codec: X contiguous, the coordinates, ``bf16``),
    X read back bit for bit by ``read_packed_rows`` and the coordinates
    by ``packed_info``, then ``streamed_randomized_svd`` from it with the
    ``.npy`` route's seed: U and s bit for bit the ``.npy`` route's, its
    K6 and K7 launches held as the ``.npy`` route's.  Returns the launch
    counts and the times (the write's and the read-back's GB/s)."""
    from dmd_era5_tpu_torch.ops import sklearn_n_iter
    from dmd_era5_tpu_torch.pipeline import streamed_randomized_svd
    from dmd_era5_tpu_torch.snapmat import packed_info, read_packed_rows, zarr_to_packed

    directory = Path(tempfile.mkdtemp(prefix="dmd_era5_h5_"))
    times = {}
    try:
        path = directory / "arco_x.h5"
        start, end = (np.datetime64(w).astype("datetime64[s]").item() for w in window)
        shape, times["zarr_to_packed_h5"] = synced(zarr_to_packed, store, path, ["temperature"],
                                                   start, end, [1000])
        nbytes = path.stat().st_size
        back, times["h5_read_back"] = synced(read_packed_rows, str(path), 0, shape[0])
        (info_shape, meta, bf16), times["h5_info"] = synced(packed_info, str(path))
        check(shape == x_host.shape and info_shape == shape and not bf16
              and np.array_equal(back.view(np.uint32), x_host.view(np.uint32)),
              "16d .h5: zarr_to_packed's X read back differs from build_snapshot_matrix's")
        check(meta.variables == ["temperature"] and meta.levels.tolist() == [1000]
              and len(meta.times) == shape[1], f"16d .h5: meta {meta.variables} {meta.levels}")
        del back
        n_iter = sklearn_n_iter(k, shape)
        n_blocks = -(-shape[0] // ARCO_PACKED_BLOCK)
        reset_counts()
        res, times["h5_streamed_randomized"], times["h5_passes"], _ = streamed_run(
            "16d streamed_randomized_svd from the .h5", streamed_randomized_svd, str(path), k,
            block_rows=ARCO_PACKED_BLOCK, seed=seed + 16)
        launches = launch_counts()
        expect = counts(K6=(n_iter + 1) * n_blocks, K7=n_iter)
        check(launches == expect, f"16d .h5 launched {launches}, expected {expect}")
        same = (np.array_equal(res.U.view(np.uint32), res_npy.U.view(np.uint32))
                and torch.equal(res.s.cpu(), res_npy.s.cpu()))
        check(same, "16d: the .h5 route's U and s are not the .npy route's bit for bit")
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    times["h5_write_gb_s"] = gb_per_s(nbytes, times["zarr_to_packed_h5"])
    times["h5_read_back_gb_s"] = gb_per_s(nbytes, times["h5_read_back"])
    log(f"[16d .h5] zarr_to_packed -> arco_x.h5 ({nbytes} bytes) in "
        f"{times['zarr_to_packed_h5']:.2f} s (the store's read included: {times['h5_write_gb_s']:.3f}"
        f" GB of file a second), read back bit "
        f"for bit in {times['h5_read_back']:.3f} s ({times['h5_read_back_gb_s']:.2f} GB/s; the "
        f"page cache's copy); streamed_randomized_svd from it in "
        f"{times['h5_streamed_randomized']:.2f} s, U and s bit for bit the .npy route's, "
        f"launches {launches}")
    return launches, times


def arco_unfused(xc: torch.Tensor, s_exact_h: torch.Tensor, v_exact_h: torch.Tensor,
                 seed: int) -> tuple[dict, dict]:
    """Phase 16 (e): ``hankel_randomized_svd`` (the unfused operators:
    K6 sketches, K3 projections, the card's default leaf, the split
    CholQR2 on K5) on (b)'s X centred as [era5-svd] centres it, d = 2,
    k = 10, launches held exactly; then, uncounted,
    ``hankel_randomized_svd_fused`` on the same X.  test_08_kernels.py
    :133-155's tolerances on the planted 6: s within 1e-4 of the fused
    SVD's and of the f64 exact s of H_2(X), U and V within 1e-3 of the
    fused SVD's, V within 1e-3 of the exact right singular vectors (each
    up to sign); every s within the exact s' interlace.  Returns the
    launch counts and the operands of K6's and K3's first calls."""
    from dmd_era5_tpu_torch.ops import hankel as hankel_mod
    from dmd_era5_tpu_torch.ops import (hankel_randomized_svd, hankel_randomized_svd_fused,
                                        sklearn_n_iter)

    d, k, lead = 2, 10, 6
    t_out = xc.shape[1] - d + 1
    n_iter = sklearn_n_iter(k, (xc.shape[0] * d, t_out))
    times = {}
    reset_counts()
    with first_operands(hankel_mod, "matmul", 1) as k6_ops, \
            first_operands(hankel_mod, "project", 1) as k3_ops:
        res, times["hankel_randomized_svd"] = synced(
            hankel_randomized_svd, xc, d, k,
            generator=torch.Generator(device="cuda").manual_seed(seed + 17))
    launches = launch_counts()
    expect = counts(K6=n_iter + 1, K3=n_iter + 1, K5=2 * (n_iter + 1))
    check(launches == expect, f"16e launched {launches}, expected {expect}")
    fused, times["fused"] = synced(hankel_randomized_svd_fused, xc, d, k,
                                   generator=torch.Generator(device="cuda").manual_seed(seed + 17),
                                   gemm_dtype=torch.float32)
    out = {}
    for name, other in (("unfused", res), ("fused", fused)):
        out[name] = check_interlace(f"16e {name} vs the f64 exact s of H_2(X)", other.s,
                                    s_exact_h.cpu())
    s_rel = float((res.s[:lead].double() / fused.s[:lead].double() - 1).abs().max())
    u_gap = float((res.U[:, :lead] - fused.U[:, :lead]).abs().max())
    v_gap = float((res.V[:lead] - fused.V[:lead]).abs().max())
    v_ex = v_exact_h[:lead].to(res.V.dtype)
    signs = torch.sign((res.V[:lead] * v_ex).sum(1, keepdim=True))
    v_exact_gap = float((res.V[:lead] - signs * v_ex).abs().max())
    orth = orthonormality(res.U)
    out.update(s_vs_fused=s_rel, u_vs_fused=u_gap, v_vs_fused=v_gap, v_vs_exact=v_exact_gap,
               orth=orth)
    check(s_rel <= 1e-4, f"16e: planted s differ from the fused SVD's by {s_rel:.3e} > 1e-4")
    check(max(u_gap, v_gap, v_exact_gap) <= 1e-3,
          f"16e: U / V off the fused SVD's by {u_gap:.3e} / {v_gap:.3e}, V off the exact "
          f"by {v_exact_gap:.3e} (> 1e-3)")
    check(orth <= 1e-3, f"16e: U^T U - I max {orth:.3e} > 1e-3")
    log(f"[16e] hankel_randomized_svd (unfused, d {d}, k {k}, n_iter {n_iter}) on the centred "
        f"slice: s[:7] {[round(float(a), 2) for a in res.s[:7]]}, {json.dumps(out)}, launches "
        f"{launches}; wall (s) {json.dumps(times)}")
    return launches, {"k6": k6_ops[0], "k3": k3_ops[0], "times": times}


# c-blosc 1.x's frames of one ARCO-ERA5 chunk (153.7 MB, typesize 4,
# shuffled, blocksize 0 = its own choice), as c-blosc 1.21 writes them:
# 1 MiB blocks at zlib clevel 5, 512 KiB at LZ4 clevel 5 (ARCO's codec),
# each whole block split into 4 streams, the ragged last one not
BLOSC_ZLIB_BLOCK, BLOSC_LZ4_BLOCK = 1 << 20, 1 << 19
# 16g's LZ4 streams by construction: a 4-byte literal run, then a match
# 4 bytes back of LZ4_MATCH bytes (overlapping: decoded byte by byte)
LZ4_MATCH = 60


def blosc_frame(blocks: list[list[bytes]], flags: int, typesize: int, nbytes: int,
                blocksize: int) -> bytes:
    """A blosc1 frame (blosc.h): the 16-byte header, the int32 block
    starts, then each block's streams, each behind its int32 size."""
    base = 16 + 4 * len(blocks)
    starts, body = [], bytearray()
    for streams in blocks:
        starts.append(base + len(body))
        for stream in streams:
            body += struct.pack("<i", len(stream)) + stream
    header = struct.pack("<BBBBIII", 2, 1, flags, typesize, nbytes, blocksize,
                         base + len(body))
    return header + struct.pack(f"<{len(blocks)}i", *starts) + bytes(body)


def shuffled_planes(block: bytes, typesize: int) -> list[bytes]:
    """A block byte-shuffled on its own, as its typesize streams."""
    planes = np.frombuffer(block, np.uint8).reshape(-1, typesize).T
    return [plane.tobytes() for plane in planes]


def blosc_zlib_rate(raw: bytes) -> dict:
    """Phase 16 (f): one chunk at ARCO-ERA5's size as c-blosc lays it out
    at zlib clevel 5 (``BLOSC_ZLIB_BLOCK`` blocks, each byte-shuffled on
    its own and split into its four byte planes, each plane a zlib stream
    at level 1; the last, ragged block one stream), decoded by the port's
    reader and held against the array that built it: its rate, the
    ingest cost that the memcpy store leaves out."""
    from dmd_era5_tpu_torch.snapmat.zarr_reader import _decode_chunk

    blocks = []
    for b0 in range(0, len(raw), BLOSC_ZLIB_BLOCK):
        block = raw[b0:b0 + BLOSC_ZLIB_BLOCK]
        streams = shuffled_planes(block, 4)
        if len(block) < BLOSC_ZLIB_BLOCK:
            streams = [b"".join(streams)]
        blocks.append([zlib.compress(st, 1) for st in streams])
    check(len(blocks[-1]) == 1 and len(raw) % BLOSC_ZLIB_BLOCK, "16f: no ragged last block")
    frame = blosc_frame(blocks, 0x1 | (3 << 5), 4, len(raw), BLOSC_ZLIB_BLOCK)
    del blocks
    t0 = time.perf_counter()
    out = _decode_chunk(frame, {"id": "blosc", "cname": "zlib", "shuffle": 1})
    secs = time.perf_counter() - t0
    check(out == raw, "the shuffled, split blosc-zlib frame did not decode to its bytes")
    res = {"bytes": len(raw), "compressed": len(frame), "seconds": secs,
           "decode_gb_s": len(raw) / secs / 1e9}
    log(f"[16f] one {len(raw) / 1e6:.1f} MB chunk as c-blosc's zlib frame "
        f"({-(-len(raw) // BLOSC_ZLIB_BLOCK)} blocks of {BLOSC_ZLIB_BLOCK} bytes, shuffled a block at a time, 4 streams a block; "
        f"ratio {len(raw) / len(frame):.3f}): decoded in {secs:.3f} s, "
        f"{res['decode_gb_s']:.3f} GB/s, equal to the chunk")
    return res


def lz4_constructed_chunk(nbytes: int, seed: int, blocksize: int = BLOSC_LZ4_BLOCK
                          ) -> tuple[bytes, bytes]:
    """(frame, chunk): a blosc-LZ4 frame of ``nbytes`` laid out as c-blosc
    writes ARCO-ERA5's chunks (``blocksize``-byte blocks, each shuffled
    on its own and split into four streams, the ragged last one a single
    stream), with every stream built, not searched: a 4-byte pattern as
    literals, then a match of ``LZ4_MATCH`` bytes at offset 4 (which
    repeats it, byte by byte in the decoder), over and over, and 64
    literal bytes to end it.  The chunk is the bytes the frame holds,
    put together from the patterns with numpy alone."""
    rng = np.random.default_rng(seed)
    period = 4 + LZ4_MATCH
    seq_tail = struct.pack("<H", 4) + bytes([LZ4_MATCH - 4 - 15])
    blocks, chunk = [], np.empty(nbytes, np.uint8)
    for b0 in range(0, nbytes, blocksize):
        size = min(blocksize, nbytes - b0)
        nsplits = 4 if size == blocksize else 1
        patterns = rng.integers(0, 256, (nsplits, 4), dtype=np.uint8)
        streams = []
        for pat in patterns:
            n = size // nsplits
            check(n % period == 0, f"16g: a {n}-byte stream is not whole sequences")
            lit = pat.tobytes()
            streams.append((bytes([0x4F]) + lit + seq_tail) * (n // period - 1)
                           + bytes([0xF0, period - 15]) + lit * (period // 4))
        blocks.append(streams)
        planes = np.tile(patterns, (1, size // nsplits // 4))  # each stream's bytes
        chunk[b0:b0 + size] = planes.reshape(4, size // 4).T.ravel()
    frame = blosc_frame(blocks, 0x1 | (1 << 5), 4, nbytes, blocksize)
    return frame, chunk.tobytes()


def lz4_rate(nbytes: int, seed: int) -> dict:
    """Phase 16 (g): the pure-Python LZ4 decoder's rate on one chunk of
    ``nbytes`` built by :func:`lz4_constructed_chunk`, decoded through the
    port's reader (``_decode_chunk``) and held against its chunk (the
    whole chunk: ~18 s on one Xeon core)."""
    from dmd_era5_tpu_torch.snapmat.zarr_reader import _decode_chunk

    frame, chunk = lz4_constructed_chunk(nbytes, seed)
    t0 = time.perf_counter()
    out = _decode_chunk(frame, {"id": "blosc", "cname": "lz4", "shuffle": 1})
    secs = time.perf_counter() - t0
    check(out == chunk, "16g: the constructed blosc-LZ4 frame did not decode to its chunk")
    res = {"bytes": nbytes, "compressed": len(frame), "seconds": secs,
           "decode_gb_s": nbytes / secs / 1e9}
    log(f"[16g] {nbytes / 1e6:.1f} MB of blosc-LZ4 (one chunk; "
        f"{-(-nbytes // BLOSC_LZ4_BLOCK)} blocks of {BLOSC_LZ4_BLOCK} bytes, 4 streams a whole "
        f"block, each {4 + LZ4_MATCH}-byte run a 4-byte literal and a {LZ4_MATCH}-byte "
        f"overlapping match; ratio {nbytes / len(frame):.3f}) through the pure-Python LZ4 "
        f"decoder: {secs:.3f} s, {res['decode_gb_s'] * 1e3:.2f} MB/s, equal to its chunk")
    return res


def centred_hankel_reference(fs, k: int = 10):
    """(b)'s X on the card, centred along time in place as [era5-svd]'s
    mean_center centres it, with the f64 exact singular values and right
    singular vectors (rows) of H_2 of it, from its f64 Gram by the banded
    identity (H^T H)[i, j] = G[i, j] + G[i+1, j+1]."""
    from dmd_era5_tpu_torch.snapmat import build_snapshot_matrix

    x_host, _ = build_snapshot_matrix(fs)
    xc = torch.from_numpy(x_host).cuda()
    del x_host
    xc -= xc.mean(dim=1, keepdim=True)
    g_raw = gram_f64(xc)
    t_out = xc.shape[1] - 1
    evals, evecs = torch.linalg.eigh(g_raw[:t_out, :t_out] + g_raw[1:, 1:])
    return xc, evals.flip(0).clamp_min(0).sqrt()[:k], evecs.flip(1)[:, :k].T.contiguous()


def phase_ingest(seed: int) -> dict:
    """Phase 16: config.ini's real-data source path on an ARCO-ERA5-layout
    store, (a)-(h).  The store (~15.2 GB) and the packed X are written in
    a temporary directory (``TMPDIR``), which must hold them (checked
    first: the phase fails, never skips), and deleted at the end.  After
    the counted parts, K1, K3, K6 and K7 against their plain versions on
    the operands the path gave them (uncounted).  Returns the main path's
    launch counts, those of (c), (d) and (e)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    directory = Path(tempfile.mkdtemp(prefix="dmd_era5_arco_"))
    launches, times = counts(), {}
    try:
        chunk = len(ARCO_LEVELS) * N_LAT * N_LON * 4 + 16
        need = ARCO_HOURS * chunk + 4 * (ARCO_HOURS - 2) * N_LAT * N_LON * 4 + GIB
        free = shutil.disk_usage(directory).free
        log(f"[16a] ARCO-ERA5-layout store in {directory}: {ARCO_HOURS} chunks of "
            f"{chunk / 1e6:.1f} MB; {need / 1e9:.2f} GB to write with the packed X (.npy and "
            f".h5), the slice and its netCDF-4 copy, {free / 1e9:.2f} GB free there")
        check(free >= need, f"no room for the store in {directory} ({free / 1e9:.2f} GB free, "
              f"{need / 1e9:.2f} GB needed); point TMPDIR at a larger disk")
        store = directory / "arco.zarr"
        info = write_arco_store(store, seed)
        times["store_write"] = info["seconds"]
        log(f"    written in {info['seconds']:.2f} s "
            f"({ARCO_HOURS * chunk / info['seconds'] / 1e9:.2f} GB/s), each hour made on the card")
        with stage_root():
            fs, read_info = arco_read(store, info)
            times["read"] = read_info["seconds"]
            xc, s_exact_h, v_exact_h = centred_hankel_reference(fs)
            parts = [arco_stages(fs, store, info, s_exact_h),
                     arco_packed(store, fs, directory, seed),
                     arco_unfused(xc, s_exact_h, v_exact_h, seed)]
            nc4_launches, nc4 = nc4_stage(fs, store, parts[0][1].pop("svd"))
        for key, n in nc4_launches.items():
            launches[key] += n
        times.update({f"16h_{key}": v for key, v in nc4.items()})
        for part_launches, ops in parts:
            times.update(ops.pop("times"))
            for key, n in part_launches.items():
                launches[key] += n
        (_, c_ops), (_, d_ops), (_, e_ops) = parts
        log("[16] K1, K3, K6 and K7 against their plain versions on the operands phase 16 "
            "gave them (uncounted; CUDA-event ms)")
        compare_kernel("ingest_hankel_pass", *c_ops["k1"], torch.float32, centred=True,
                       center=False)
        compare_project("16e hankel_project", *e_ops["k3"])
        compare_matmul("16e hankel_sketch", *e_ops["k6"], f64_gate=True)
        compare_matmul("16d streamed block", *d_ops["k6"], f64_gate=True)
        compare_householder("16d streamed leaf", *d_ops["k7"], gate_q=False)
        del parts, c_ops, d_ops, e_ops, xc
        rate = blosc_zlib_rate(info["last_hour"])
        rate_lz4 = lz4_rate(len(info["last_hour"]), seed)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    times["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    log(f"[16] wall times (s): {json.dumps(times)} (peak_gb: device memory over the phase's "
        f"start); read {read_info['read_over_kept']:.3f} bytes a kept byte at "
        f"{read_info['read_gb_s']:.2f} GB/s; blosc-zlib decode {rate['decode_gb_s']:.3f} GB/s, "
        f"blosc-LZ4 {rate_lz4['decode_gb_s'] * 1e3:.2f} MB/s; "
        f"launches {launches}")
    return launches


# phase 20: each torch_verify oracle check's launches on the card, by its
# name (a check absent here launches none: optDMD, BOP-DMD, the second
# reading of a result), and the demos' launches
VERIFY_LAUNCHES = {
    "exact SVD singular values": {"K5": 2},  # the TSQR leaf: split CholQR2
    "exact SVD Gram route (bf16_split)": {"K1": 1, "K5": 1},
    "randomized SVD vs sklearn": {"K5": 10},  # 5 range bases, CholQR2 each
    "Hankel operator SVD == materialized": {"K3": 5, "K5": 20, "K6": 5},
    "exact Hankel SVD vs materialized numpy": {"K1": 1, "K5": 1},
    "mock-ERA5 pipeline oracle": {"K5": 2},
    "fused fit step loss": {"K1": 1},
    "stats-from-sketch fit step": {"K1": 2},  # the step and the bare K1 call
    "mrDMD identity + residual decay": {"K4": 7},  # once a window, 1 + 2 + 4
    "DMDc forced-trajectory recovery": {"K1": 2, "K4": 2},  # two Gram-route SVDs
}
TOOLS_LAUNCHES = {"20b": counts(K3=8, K4=8, K6=80, K7=7), "20c": counts(K1=5)}


# each kernel's launcher in its module, by the kernel key of its launches
# (``gram``'s by its precision argument: K4 "highest", K5 "bf16_split")
LAUNCHERS = (("matmul", "_sketch_center_gram_project_cuda", "K1"),
             ("matmul", "_sketch_center_gram_cuda", "K2"),
             ("matmul", "_project_cuda", "K3"),
             ("qr_panel", "_gram_cuda", None),
             ("matmul", "_matmul_cuda", "K6"),
             ("qr_panel", "_householder_cuda", "K7"))


@contextlib.contextmanager
def kernel_operands():
    """The operands of every distinct kernel call made inside (distinct by
    kernel, the operands' shapes and dtypes and the call's flags), a copy
    of the first call of each, into the yielded dict (signature -> (key,
    arguments)).  Each launcher is wrapped in its module, where its
    wrapper looks it up at each call, so calls from every caller are
    seen; the launches themselves go on as before."""
    from dmd_era5_tpu_torch.ops import matmul, qr_panel

    modules = {"matmul": matmul, "qr_panel": qr_panel}
    calls: dict = {}
    saved = []

    def recording(launcher, key):
        def call(*args):
            kernel = key or ("K4" if args[1] == "highest" else "K5")
            sig = (kernel,) + tuple((tuple(a.shape), a.dtype) if torch.is_tensor(a) else a
                                    for a in args)
            if sig not in calls:
                calls[sig] = (kernel, tuple(a.clone() if torch.is_tensor(a) else a
                                            for a in args))
            return launcher(*args)
        return call

    for module, name, key in LAUNCHERS:
        launcher = getattr(modules[module], name)
        saved.append((modules[module], name, launcher))
        setattr(modules[module], name, recording(launcher, key))
    try:
        yield calls
    finally:
        for module, name, launcher in saved:
            setattr(module, name, launcher)


def rows_cancel(x: torch.Tensor) -> bool:
    """Whether every row of x sums to within 1e-4 of the sum of its
    magnitudes (centred rows): their sums are then roundoff, and
    ``compare_kernel`` reads them against sum_t |x| (``centred``)."""
    x64 = x.double()
    return bool((x64.sum(dim=1).abs() <= 1e-4 * x64.abs().sum(dim=1)).all())


# the readings of each kernel's comparison that PERF.md keeps: against the
# plain version, against the f64 sums (K7: Q's orthogonality, QR - A)
HELD_FIELDS = {"K1": ("rel_err", "kernel_G_vs_f64", "kernel_C_vs_f64"),
               "K2": ("yc_rel", "G_vs_plain_over_max", "kernel_G_vs_f64_over_max"),
               "K3": ("C_vs_plain_over_max", "kernel_C_vs_f64_over_max"),
               "K4": ("rel_vs_plain", "kernel_rel_vs_f64"),
               "K5": ("rel_vs_plain", "kernel_max_abs_vs_f64_over_max"),
               "K6": ("rel_err", "kernel_vs_f64_over_max", "plain_vs_f64_over_max"),
               "K7": ("r_max_abs_over_max", "kernel_orth", "kernel_recon")}


def hold_call(label: str, key: str, args: tuple, k1_limit: float = 1e-6) -> dict:
    """One recorded call of kernel ``key`` against its plain version and
    the f64 sums by its compare helper (see :func:`hold_operands`)."""
    if key == "K1":
        x, w, out_dtype, center, stats_col, scalar_stats, t_valid, _ = args
        return compare_kernel(label, x, w, out_dtype, centred=rows_cancel(x), f64_limit=k1_limit,
                              center=center, stats_col=stats_col, scalar_stats=scalar_stats,
                              t_valid=t_valid)
    if key == "K2":
        x, w, out_dtype, center, t_valid = args
        check(t_valid is None, f"{label}: K2 held only without t_valid")
        return compare_sketch_center_gram(label, x, w, center, out_dtype)[0]
    if key == "K3":
        return compare_project(label, *args)
    if key in ("K4", "K5"):
        return compare_gram(label, *args)
    if key == "K6":
        x, w, out_dtype = args
        check(out_dtype == torch.float32, f"{label}: K6 held only with an f32 product")
        return compare_matmul(label, x, w, f64_gate=x.dtype == torch.float32)
    return compare_householder(label, *args, gate_q=False)


# each kernel's one-TF32-pass control, as its compare helper reads it (None
# where the operands are exact in TF32)
CONTROLS = {"K3": "one_tf32_pass_C_vs_f64_over_max", "K4": "one_tf32_pass_rel_vs_f64",
            "K6": "one_tf32_pass_vs_f64_over_max"}


def hold_operands(part: str, calls: dict, k1_limit: float = 1e-6) -> list[dict]:
    """Each kernel call recorded by :func:`kernel_operands` against its
    plain version and the f64 sums, on its own operands and flags, by the
    compare helper of its kernel at that helper's limits and controls
    (uncounted).  K1 is held with Yc emitted (the function of X is the
    same without it), its rows read as centred where they cancel
    (:func:`rows_cancel`), G and C within 1e-6 of the f64 sums
    (tests/test_torch_cuda.py's limit: at these few thousand rows one
    TF32 pass comes within 1e-5; ``k1_limit`` where a call's rows are so
    many that one pass comes within 1e-6 too); K7 without Q's limit against the plain
    version, as a panel from a path is not a Gaussian one.  The controls'
    TF32 passes are emulated (``emulated_tf32``); where a call's operands
    are exact in TF32 (bf16 values, a +-1 panel), so that one pass is as
    exact as three, the same call is held again on Gaussian operands of
    its shapes and dtypes, whose control must miss.  Returns one line of
    readings a call."""
    readings = []
    gen = torch.Generator(device="cuda").manual_seed(20)
    with emulated_tf32():
        for key, args in calls.values():
            shape = "x".join(str(n) for n in args[0].shape)
            label = f"{part} {key} {shape}"
            res = hold_call(label, key, args, k1_limit)
            reading = dict(kernel=key, shapes=[list(a.shape) for a in args if torch.is_tensor(a)],
                           dtypes=[str(a.dtype)[6:] for a in args if torch.is_tensor(a)],
                           **{f: res.get(f) for f in HELD_FIELDS[key]}, ms=res.get("ms"),
                           plain_ms=res.get("plain_ms"), bound_ms=res.get("bound_ms"))
            if key in CONTROLS and res.get(CONTROLS[key], 0.0) is None:
                # operands exact in TF32: the same call on Gaussian ones reads the control
                twin = tuple(torch.randn(a.shape, generator=gen, device=a.device).to(a.dtype)
                             if torch.is_tensor(a) else a for a in args)
                res = hold_call(f"{label} Gaussian twin", key, twin)
                reading["gaussian_twin_one_tf32_pass"] = res[CONTROLS[key]]
            readings.append(reading)
    log(f"[{part}] {len(readings)} distinct kernel calls held against their plain versions "
        f"and the f64 sums (uncounted): {json.dumps(readings)}")
    return readings


def load_tool(relative: str):
    """A script of the checkout (``scripts/``, ``examples/``) as a module,
    its ``__main__`` block not run."""
    import importlib.util

    path = ROOT / relative
    spec = importlib.util.spec_from_file_location(f"tool_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def verify_on_card() -> dict:
    """Phase 20 (a): ``scripts/torch_verify.py``'s 22 checks in this
    process.  Each oracle check's launches are held to
    ``VERIFY_LAUNCHES`` and returned; each kernel check launches its
    kernel once (a comparison: not returned)."""
    verify = load_tool("scripts/torch_verify.py")
    device = torch.device("cuda")

    def report(c) -> None:
        log(f"    {'PASS' if c.ok else 'FAIL'}  {c.name}  {c.detail}  launches {c.launches}")

    t0 = time.perf_counter()
    with kernel_operands() as calls:
        oracle = verify.oracle_checks(device, report)
    t_oracle = time.perf_counter() - t0
    kernels = verify.kernel_checks(device, report)
    t_kernels = time.perf_counter() - t0 - t_oracle
    check(len(oracle) == 15 and len(kernels) == verify.N_KERNEL_CHECKS == 7,
          f"torch_verify ran {len(oracle)} oracle and {len(kernels)} kernel checks, not 15 and 7")
    launched = counts()
    for c in oracle:
        check(c.ok, f"[20a] torch_verify: {c.name} failed: {c.detail}")
        want = VERIFY_LAUNCHES.get(c.name, {})
        check(c.launches == want, f"[20a] {c.name} launched {c.launches}, expected {want}")
        for key, n in c.launches.items():
            launched[key] += n
    for key, c in zip(KERNELS, kernels):
        check(c.ok, f"[20a] torch_verify: {c.name} failed: {c.detail}")
        check(c.launches == {key: 1}, f"[20a] {c.name} launched {c.launches}, expected {key} 1")
    log(f"[20a] torch_verify on the card: {len(oracle) + len(kernels)}/22 passed in "
        f"{t_oracle:.2f} s (oracle checks) + {t_kernels:.2f} s (kernel checks); the oracle "
        f"checks launched {launched}")
    hold_operands("20a", calls)
    return launched


def demo_out_of_core() -> dict:
    """Phase 20 (b): the out-of-core demo's ``main`` on the card (its
    packed file under ``TMPDIR``, its own limits against numpy)."""
    demo = load_tool("examples/torch_demo_out_of_core.py")
    before = launch_counts()
    with kernel_operands() as calls:
        out, seconds = synced(demo.main, [])
    launched = {key: n - before[key] for key, n in launch_counts().items()}
    check(launched == TOOLS_LAUNCHES["20b"],
          f"[20b] out-of-core demo launched {launched}, expected {TOOLS_LAUNCHES['20b']}")
    log(f"[20b] out-of-core demo: s rel err streamed {out['streamed']:.3e}, one-pass (head 8) "
        f"{out['onepass']:.3e}, exact Gram {out['exact_gram']:.3e}; wall (s) "
        f"{json.dumps({a: round(b, 3) for a, b in out['seconds'].items()})}, {seconds:.2f} in "
        f"all; launches {launched}")
    hold_operands("20b", calls)
    return launched


def demo_pipeline(seed: int) -> dict:
    """Phase 20 (c): the pipeline demo on the card, its ``main`` with the
    files and the store; s held below the f64 s of the stage's X (the
    same mock slice, drawn again from the seeded global state, through
    ``compute_svd_results`` with X kept)."""
    from dmd_era5_tpu_torch.core import config_parser
    from dmd_era5_tpu_torch.pipeline import era5_download, era5_svd

    demo = load_tool("examples/torch_demo_pipeline.py")
    cfg = demo.CONFIG
    before = launch_counts()
    with stage_root() as directory, kernel_operands() as calls:
        np.random.seed(seed)
        log("[20c] the pipeline demo's main with the files and the store")
        res, t_main = synced(demo.main, [])
        launched = _minus(launch_counts(), before)
        calls = dict(calls)  # the demo's own calls: not the recomputation of X below
        disk = file_sizes(directory)
        (svd, _, _), t_hit = synced(era5_svd.main, dict(cfg), device="cuda")
        np.random.seed(seed)  # the same slice again, for its X
        fs = era5_download.download_era5_data(config_parser(dict(cfg), "era5-download"),
                                              use_mock_data=True)
        with_x = era5_svd.compute_svd_results(
            fs, config_parser(dict(cfg, save_data_matrix=True), "era5-svd"))
        svd = dict(s=svd["s"], X=with_x["X"])
        times = {"main": t_main, "svd_cache_hit": t_hit, "disk_bytes": disk}
    check(launched == TOOLS_LAUNCHES["20c"],
          f"[20c] pipeline demo launched {launched}, expected {TOOLS_LAUNCHES['20c']}")
    x = np.asarray(svd["X"].values, dtype=np.float64)
    s = np.asarray(svd["s"].values, dtype=np.float64)
    ratio = s / np.linalg.svd(x, compute_uv=False)[: len(s)]
    check(float(ratio.max()) <= 1 + 1e-4, f"[20c] s above the f64 s of X, max ratio {ratio.max()}")
    eigs = np.asarray(res["eigenvalues"].values)
    check(eigs.shape == (cfg["dmd_rank"],) and bool(np.isfinite(eigs).all()),
          f"[20c] eigenvalues {eigs}")
    n_space = 2 * 2 * 36 * 72  # two variables at two levels on the 5-degree mock grid
    n_fit = 49 - cfg["forecast_holdout"] - cfg["delay_embedding"] + 1  # 49 hours
    fc = res["forecast"]
    check(tuple(fc.shape) == (n_space, n_fit + cfg["forecast_steps"]) and fc.data.is_cuda
          and bool(torch.isfinite(fc.data).all()), f"[20c] forecast {fc.shape} on {fc.data.device}")
    scores = {key: np.asarray(res.attrs.get(key, [])) for key in
              ("forecast_rmse", "persistence_rmse", "forecast_acc")}
    check(all(v.shape == (cfg["forecast_holdout"],) and np.isfinite(v).all()
              for v in scores.values()), f"[20c] holdout scores {scores}")
    log(f"[20c] pipeline demo: X {x.shape}, s / f64 s of X from {float(ratio.min()):.6f} to "
        f"{float(ratio.max()):.6f}, {len(eigs)} finite eigenvalues, forecast {tuple(fc.shape)} "
        f"on the card, RMSE at lead 1 / {cfg['forecast_holdout']} "
        f"{scores['forecast_rmse'][0]:.3f} / {scores['forecast_rmse'][-1]:.3f}; launches "
        f"{launched}; wall (s) {json.dumps({a: round(b, 3) for a, b in times.items()})}")
    hold_operands("20c", calls)
    return launched


def lstsq_implicit_on_card() -> dict:
    """Phase 20 (d): ``lstsq_implicit``'s forward Jacobian on the card
    against forward mode straight through ``complex_lstsq``, on
    tests/test_13_checkpoint.py:78-115's case, at its rtol 1e-3 and
    atol 1e-4."""
    from dmd_era5_tpu_torch.models.optdmd import _func
    from dmd_era5_tpu_torch.utils.linalg import complex_lstsq, lstsq_implicit

    rng = np.random.default_rng(0)
    tt = torch.arange(20, dtype=torch.float32, device="cuda") * 0.1
    h = torch.from_numpy((rng.standard_normal((20, 4)) + 1j * rng.standard_normal((20, 4)))
                         .astype(np.complex64)).cuda()
    theta = torch.tensor([-0.1, -0.2, -0.05, 1.0, -0.5, 2.0], device="cuda")

    def b_of(solve):
        def f(th):
            a = torch.complex(th[:3], th[3:])
            b = solve(torch.exp(torch.outer(tt.to(a.dtype), a)), h)
            return torch.cat([b.real.reshape(-1), b.imag.reshape(-1)])
        return f

    func = _func()
    j_i, t_i = synced(func.jacfwd(b_of(lstsq_implicit)), theta)
    j_d, t_d = synced(func.jacfwd(b_of(complex_lstsq)), theta)
    err = (j_i - j_d).abs()
    worst = float((err - 1e-3 * j_d.abs()).max())
    check(j_i.is_cuda and worst <= 1e-4, f"[20d] lstsq_implicit's Jacobian off complex_lstsq's "
          f"by {float(err.max()):.3e} (rtol 1e-3, atol 1e-4)")
    log(f"[20d] lstsq_implicit on the card: jacfwd {tuple(j_i.shape)} max|diff| "
        f"{float(err.max()):.3e} of max|J| {float(j_d.abs().max()):.3f} against forward mode "
        f"through complex_lstsq; {t_i * 1e3:.1f} / {t_d * 1e3:.1f} ms")
    return {"max_abs": float(err.max())}


def phase_tools(seed: int) -> dict:
    """Phase 20: the port's verify script and examples on the card, and
    ``lstsq_implicit``.  Returns the launches of its main-path parts
    ((a)'s oracle checks, (b), (c))."""
    t0 = time.perf_counter()
    launched = counts()
    for part in (verify_on_card(), demo_out_of_core(), demo_pipeline(seed)):
        for key, n in part.items():
            launched[key] += n
    lstsq_implicit_on_card()
    log(f"[20] tools and examples: {time.perf_counter() - t0:.1f} s, launches {launched}")
    return launched


def kernel_line(key: str, launches: int, res: dict, kernel: tuple | None = None,
                route_name: str | None = None) -> dict:
    name, source, replaces = kernel or KERNELS[key]
    name = f"{name} ({route_name})" if route_name else name
    max_abs = res["max_abs_err"]
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=max_abs["yc"] if key == "K1" else max_abs,  # K1: y_wide of the SVD
                ms=res["ms"], plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
                bound_by=res["bound_by"], library_ms=res.get("library_ms"),
                **{key: res[key] for key in ("device_ms",) if key in res})


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    t_start = time.perf_counter()
    smi = phase_device()
    sys.path.insert(0, str(ROOT))
    phase_build()

    phase_kernel_vs_plain(args.seed)
    reset_counts()  # the main path's first run starts here
    week = phase_slice(args.seed)
    x = week["x"]
    phase_fit_step(x, args.seed)
    launches = launch_counts()  # ... and ends here
    check(launches == counts(K1=7),
          f"main path launched {launches}, expected K1 5 + 2 and no other kernel")
    torch.cuda.reset_peak_memory_stats()
    hankel_cmp = phase_kernel_at_path_shapes(x, args.seed)
    gram_cmp = phase_gram_vs_plain(x, args.seed)
    for key, n in phase_standard(week).items():
        launches[key] += n
    truncated_launches, ref8 = phase_truncated(x, args.seed)
    for key, n in truncated_launches.items():
        launches[key] += n
    streamed_cmp = phase_streamed_kernels(x, args.seed)
    for key, n in phase_streamed(week, ref8, args.seed).items():
        launches[key] += n
    for key, n in phase_wide_sketch(week, args.seed).items():
        launches[key] += n
    stage_launches, stage_fs, slice_back, week_res = phase_stage(week, args.seed)
    for key, n in stage_launches.items():
        launches[key] += n
    dmd_launches, res_b, svd_c = phase_dmd_stage(week, slice_back, week_res, args.seed)
    for key, n in dmd_launches.items():
        launches[key] += n
    for key, n in phase_incremental(week, slice_back, svd_c, args.seed).items():
        launches[key] += n
    del svd_c, slice_back
    # phase 14 frees the week's X once it is done with the slice: it holds
    # the only references to both
    week["fs"] = stage_fs
    del stage_fs, x
    for key, n in phase_multires(week, week_res, res_b, args.seed).items():
        launches[key] += n
    del week_res, res_b
    # the week's tensors go before the year (34 GB) is built
    del week, ref8
    torch.cuda.empty_cache()
    year_launches, two_pass_cmp = phase_year(args.seed)
    for key, n in year_launches.items():
        launches[key] += n
    torch.cuda.empty_cache()
    for key, n in phase_ingest(args.seed).items():
        launches[key] += n
    for key, n in phase_tools(args.seed).items():
        launches[key] += n
    check(all(n > 0 for n in launches.values()), f"a kernel never ran on the main path: {launches}")
    log(f"smoke wall time {time.perf_counter() - t_start:.1f} s (the build included)")
    for row in K1_STAGES:
        log(f"K1 stages, {row['label']} {row['dtype']} m {row['m']} t {row['t']} n {row['n']}: "
            f"device ms sketch {row['sketch']:.3f}, G {row['G']:.3f}, C {row['C']:.3f}")
    for row in K2_STAGES:
        log(f"K2 stages ({row['route']}), {row['label']} {row['dtype']} (Yc {row['out_dtype']}) "
            f"m {row['m']} t {row['t']} n {row['n']}: device ms sketch {row['sketch']:.3f}, "
            f"G {row['G']:.3f}")
    check(sum(K2_ROUTES.values()) == launches["K2"] and all(K2_ROUTES.values()),
          f"K2's main-path launches by route {K2_ROUTES} against {launches['K2']}")
    print(json.dumps({"kernels": [
        kernel_line("K1", launches["K1"], hankel_cmp),
        kernel_line("K2", K2_ROUTES["clusters"], K2_D3, K2_CLUSTERS, "clusters"),
        kernel_line("K2", K2_ROUTES["stages"], two_pass_cmp["K2"], route_name="K1's stages"),
        kernel_line("K3", launches["K3"], two_pass_cmp["K3"]),
        kernel_line("K4", launches["K4"], gram_cmp[("X", "highest")]),
        kernel_line("K5", launches["K5"], gram_cmp[("X", "bf16_split")]),
        kernel_line("K6", launches["K6"], streamed_cmp["f32"]),
        kernel_line("K7", launches["K7"], streamed_cmp[(T_HOURS, R_SKETCH)]),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
