"""K2's route table on the CPU: ``ops/k2.py::k2_block`` (which of
``sketch_center_gram``'s routes a call takes, the clusters' sizes, rings
and shared memory) and ``gram_plan`` (the assignment of G's upper blocks
to the CTAs of the Gram's clusters).

The cluster kernels (``csrc/sketch_center_gram.cu``) run only on a card;
what they are handed is plain Python, held here: G's upper 128 x 64 blocks
are each assigned exactly once and cover every entry r <= c, each CTA's
shared memory stays within the card's, the clusters within 8 CTAs, and the
route follows shape and dtype, the d = 3 pass on the clusters.
"""

from __future__ import annotations

import itertools

import pytest
import torch

from dmd_era5_tpu_torch.ops import k2
from dmd_era5_tpu_torch.ops.k2 import K2Block, gram_boxes, gram_plan, k2_block

F32, BF16 = torch.float32, torch.bfloat16
WEEK = 721 * 1440 * 15  # the ERA5 week's rows
YEAR = 181 * 360 * 15  # the hourly 1-degree year's
CLUSTER_WIDTHS = list(range(257, 513, 8)) + [264, 384, 392, 448, 512]


@pytest.mark.parametrize("n", sorted(set(CLUSTER_WIDTHS)))
@pytest.mark.parametrize("cluster", range(2, k2.MAX_CLUSTER + 1))
def test_gram_plan_assigns_each_upper_block_once(n, cluster):
    """Every 128 x 64 block holding an entry r <= c of G (N x N) is one
    CTA's, no other block is anyone's, and the plan is whole clusters."""
    plan = gram_plan(n, cluster)
    assert len(plan) % cluster == 0 and len(plan) <= 32
    blocks = [b for b in plan if b != (-1, -1)]
    assert len(blocks) == len(set(blocks))
    assert len(plan) - len(blocks) < cluster  # only the last cluster has idle CTAs
    nbox = -(-n // 64)
    want = {(mi, ni) for mi in range(-(-n // 128)) for ni in range(nbox)
            if 64 * ni + 63 >= 128 * mi}
    assert set(blocks) == want
    covered = set()
    for mi, ni in blocks:
        covered.update((r, c) for r in range(128 * mi, min(n, 128 * mi + 128))
                       for c in range(64 * ni, min(n, 64 * ni + 64)) if r <= c)
    assert len(covered) == n * (n + 1) // 2


@pytest.mark.parametrize("cluster", range(2, k2.MAX_CLUSTER + 1))
@pytest.mark.parametrize("n", [264, 320, 384, 448, 512])
def test_gram_boxes_reach_every_reader(n, cluster):
    """Each CTA of a cluster receives the boxes its block reads (m side
    2 mi and 2 mi + 1 within N, n side ni), each box once a cluster."""
    plan = gram_plan(n, cluster)
    for g in range(0, len(plan), cluster):
        group = plan[g:g + cluster]
        need = gram_boxes(group, n)
        assert all(0 <= k < -(-n // 64) and mask for k, mask in need.items())
        for rank, (mi, ni) in enumerate(group):
            got = {k for k, mask in need.items() if mask >> rank & 1}
            if mi < 0:
                assert not got
            else:
                assert got == {k for k in (2 * mi, 2 * mi + 1, ni) if k < -(-n // 64)}


@pytest.mark.parametrize("t", [8, 40, 168, 512, 1024, 1280])
@pytest.mark.parametrize("n", [264, 384, 512])
def test_cluster_blocks_fit_the_card(t, n):
    """Each CTA's shared memory within 232,448 bytes (the kernel's sums),
    rings of 2-8 slots, clusters within 8 CTAs (64 of Yc's columns a
    sketch CTA, the last one holding some)."""
    b = k2_block(WEEK, t, n, BF16, BF16)
    assert b.route == "clusters"
    assert b.sketch_smem == k2.sketch_smem(t, b.sketch_ring) <= k2.SMEM_CAP
    assert b.gram_smem == k2.gram_smem(n, b.gram_ring) <= k2.SMEM_CAP
    assert 2 <= b.sketch_ring <= k2.MAX_RING and 2 <= b.gram_ring <= k2.MAX_RING
    assert 1 <= b.sketch_cluster <= k2.MAX_CLUSTER and 2 <= b.gram_cluster <= k2.MAX_CLUSTER
    assert (b.sketch_cluster - 1) * k2.BN < n <= b.sketch_cluster * k2.BN
    # one more ring slot would not fit
    if b.sketch_ring < k2.MAX_RING:
        assert k2.sketch_smem(t, b.sketch_ring + 1) > k2.SMEM_CAP


@pytest.mark.parametrize("gram_cluster", range(2, k2.MAX_CLUSTER + 1))
def test_gram_cluster_override_stays_portable(gram_cluster):
    """Another Gram cluster than the table's (timed by
    ``scripts/torch_k2_phases.py``, checked on the card) is the table's block
    with its cluster and plan replaced: the ring and shared memory hang on N
    alone, and the cluster stays within 8 (a portable cluster: the kernels
    set no non-portable attribute, so the launch refuses a larger one)."""
    b = k2_block(WEEK, 168, 384, BF16, BF16)
    v = b._replace(gram_cluster=gram_cluster, gram_plan=gram_plan(384, gram_cluster))
    assert v.gram_cluster == gram_cluster <= k2.MAX_CLUSTER == 8
    assert len(v.gram_plan) % gram_cluster == 0
    assert v.gram_smem == k2.gram_smem(384, v.gram_ring) <= k2.SMEM_CAP


def test_d3_pass_takes_the_clusters():
    """The d = 3 Hankel pass (bf16 X 15,573,600 x 168, N 384, bf16 Yc):
    the sketch on clusters of six 64-column CTAs, eight ring slots; G's 12
    upper blocks in six clusters of two, each box of a slab copied once a
    cluster (18 copies a slab against the 36 reads of K1's G stage)."""
    b = k2_block(WEEK, 168, 384, BF16, BF16)
    assert b == K2Block("clusters", "bf16 at N 257-512", 6, 8, 190_080, 2,
                        ((0, 0), (0, 1), (0, 2), (0, 3), (0, 4), (0, 5),
                         (1, 2), (1, 3), (1, 4), (1, 5), (2, 4), (2, 5)), 4, 197_760)
    groups = [b.gram_plan[i:i + 2] for i in range(0, 12, 2)]
    assert [len(gram_boxes(g, 384)) for g in groups] == [2, 4, 4, 2, 4, 2]


# (label, M, T, N, X dtype, Yc dtype, aligned, route)
ROUTES = [
    ("d3_pass", WEEK, 168, 384, BF16, BF16, True, "clusters"),
    ("d3_width_T40", 129, 40, 512, BF16, BF16, True, "clusters"),
    ("narrowest", 1000, 168, 264, BF16, BF16, True, "clusters"),
    ("year_N256_f32", YEAR, 8760, 256, F32, F32, True, "stages"),
    ("year_N128_f32", YEAR, 8760, 128, F32, F32, True, "stages"),
    ("f32_d3_width", 1000, 168, 384, F32, F32, True, "stages"),
    ("bf16_x_f32_yc", 1000, 168, 384, BF16, F32, True, "stages"),
    ("f32_x_bf16_yc", 1000, 168, 384, F32, BF16, True, "stages"),
    ("n256", 1000, 168, 256, BF16, BF16, True, "stages"),
    ("n_past_512", 300, 168, 2048, BF16, BF16, True, "stages"),
    ("t_odd", 1000, 167, 384, BF16, BF16, True, "stages"),
    ("t_no_multiple_of_8", 300, 50, 384, BF16, BF16, True, "stages"),
    ("n_no_multiple_of_8", 1000, 168, 300, BF16, BF16, True, "stages"),
    ("unaligned_base", 1000, 168, 384, BF16, BF16, False, "stages"),
    ("w_not_held", 1000, 1288, 384, BF16, BF16, True, "stages"),
    ("long_t_held_edge", 1000, 1280, 384, BF16, BF16, True, "clusters"),
    ("m_past_int32", 1 << 31, 8, 384, BF16, BF16, True, "stages"),
]


@pytest.mark.parametrize("label,m,t,n,xdt,odt,aligned,route", ROUTES, ids=[r[0] for r in ROUTES])
def test_route_follows_shape_and_dtype(label, m, t, n, xdt, odt, aligned, route):
    b = k2_block(m, t, n, xdt, odt, base_aligned=aligned)
    assert b.route == route, b.why
    if route == "stages":
        assert b.why and b.sketch_cluster == 0 and b.gram_plan == ()


@pytest.mark.parametrize("n,t", itertools.product([264, 384, 512], [40, 168]))
def test_route_on_the_cpu_is_the_plain_version(n, t):
    """On a CPU tensor ``sketch_center_gram`` takes its plain version on
    either route, and counts no launch."""
    from dmd_era5_tpu_torch.ops import matmul

    gen = torch.Generator().manual_seed(n + t)
    x = torch.randn((300, t), generator=gen).to(BF16)
    w = torch.randn((t, n), generator=gen).to(BF16)
    before = (matmul.sketch_center_gram.launches, dict(matmul.sketch_center_gram.launches_by_route))
    got = matmul.sketch_center_gram(x, w, out_dtype=BF16, center=True)
    ref = matmul._sketch_center_gram_plain(x, w, BF16, True)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    after = (matmul.sketch_center_gram.launches, dict(matmul.sketch_center_gram.launches_by_route))
    assert before == after
