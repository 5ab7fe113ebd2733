"""``gn_swish_quant_int8``'s plan (``ops.gn_kernels.gn_plan``), on the CPU:
at every shape ``chip_smoke.check_gn`` runs (SD's resblock shapes, every
cin256 and CIFAR-10 GroupNorm, two odd shapes) and at shapes too large for
any cluster's shared memory, the route, slices and cluster size are
ones the kernel takes: slices of whole groups, rows of a multiple of
16 bytes (and of 8 channels on the resident route, for its 8-byte code
stores), at most 227 KB of shared memory a block, a portable cluster
size. Every ``check_gn`` shape takes the resident route (x read once);
only the large ones take the stream route. The file imports no JAX.
"""

import pytest

import chip_smoke
from tfmq_dm_tpu_torch.ops import gn_kernels as G

# (b, h, w, c, itemsize) of chip_smoke.check_gn
CHECK_SHAPES = [(b, h, w, c, 2 if "bfloat16" in str(dt) else 4)
                for b, h, w, c, _, dt in chip_smoke.gn_shapes()]
# no slice of whole groups fits in 8 blocks' shared memory (groups last):
# a 384x384 row of SD's 320 channels (its narrowest slice, 10 channels,
# would need 295 KB a block) and a 256x256 row of 256 f32 channels (8:
# 262 KB), and 27 bf16 channels in 3 groups, whose slice rows are never a
# multiple of 4 bytes (the stream route's one-value loads)
STREAM_SHAPES = [(1, 384, 384, 320, 2, 32), (1, 256, 256, 256, 4, 32),
                 (2, 5, 7, 27, 2, 3)]


def _check_plan(b, hw, c, groups, itemsize, plan):
    route, slices, cluster = plan
    assert route in ("resident", "stream")
    assert groups % slices == 0                       # whole groups
    sc = c // slices
    assert cluster in G.CLUSTERS and cluster <= hw
    smem = G.gn_smem(route, hw, c, groups, itemsize, slices, cluster)
    assert smem <= G.SMEM_PER_BLOCK
    if route == "resident":
        cb = G.copy_bytes(sc, itemsize)
        assert sc * itemsize % cb == 0 and cb in (16, 8, 4)
        assert sc * itemsize // cb <= G.GN_LOADERS
        assert -(-hw // cluster) * sc * itemsize < smem
    assert plan in G.gn_plans(b, hw, c, groups, itemsize)


@pytest.mark.parametrize("b,h,w,c,itemsize", CHECK_SHAPES)
def test_gn_plan_check_shapes_are_resident(b, h, w, c, itemsize):
    plan = G.gn_plan(b, h * w, c, 32, itemsize)
    _check_plan(b, h * w, c, 32, itemsize, plan)
    assert plan[0] == "resident"
    for other in G.gn_plans(b, h * w, c, 32, itemsize):
        _check_plan(b, h * w, c, 32, itemsize, other)


@pytest.mark.parametrize("b,h,w,c,itemsize,groups", STREAM_SHAPES)
def test_gn_plan_large_slices_stream(b, h, w, c, itemsize, groups):
    plan = G.gn_plan(b, h * w, c, groups, itemsize)
    _check_plan(b, h * w, c, groups, itemsize, plan)
    assert plan[0] == "stream" and plan[2] == 8
    assert all(p[0] == "stream"
               for p in G.gn_plans(b, h * w, c, groups, itemsize))


def test_gn_plan_sd_64x64_one_wave():
    """SD's 8x64x64x320 in bf16: 64 clusters of 2 blocks, each holding 40
    channels (4 groups) of one batch row, 160 KB of x a block: 128 blocks,
    one an SM, in one wave (the card runs 66 such clusters at once)."""
    route, slices, cluster = G.gn_plan(8, 64 * 64, 320, 32, 2)
    assert (route, slices, cluster) == ("resident", 8, 2)
    assert 8 * slices <= G.CLUSTER_SLOTS[cluster]
    assert 8 * slices * cluster == 128 <= G.GN_SMS
    assert 4096 // cluster * (320 // slices) * 2 == 163840
