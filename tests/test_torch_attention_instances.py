"""The bf16 attention kernels' instance by head dim, on the CPU.

ops.attention.plan(hd) is the one place the choice is made: the fewest
head columns of HD_INSTANCES (64, 80, 96, 128) that hold hd, the tiles
zero-filled past it (csrc/attention.cu).  ViT-H/14's 80 and the old
ViT-S/16's 96 run instances of their own width, never the 128-column one.
The kernels themselves are held to their plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import pytest

from vitcap_tpu_torch.ops import attention as AT


@pytest.mark.parametrize("hd", range(8, 129, 8))
def test_instance_by_head_dim(hd):
    """Every head dim 8-128 that is a multiple of 8: the narrowest
    instance that holds it; 80 and 96 their own; each instance's shared
    memory, both functions, under the H100's 227 KB a block, its q, K and
    V tiles (and the tail panel in each) on 1024-byte boundaries, where
    the swizzle patterns start."""
    hdp = AT.plan(hd)
    assert hdp == min(w for w in AT.HD_INSTANCES if w >= hd)
    assert hdp == (64 if hd <= 64 else 80 if hd <= 80 else 96 if hd <= 96
                   else 128)
    for online, kt in ((False, AT.WG_KT), (True, AT.ONLINE_TK)):
        smem = AT.instance_smem(hdp, online)
        assert smem == AT.WG_Q * hdp * 2 + 4 * kt * hdp * 2 + 1024
        assert smem <= AT.SMEM_LIMIT == 232448
        for rows in (AT.WG_Q, kt):
            assert rows * hdp * 2 % 1024 == 0           # a tile
            assert rows * 128 % 1024 == 0               # its tail panel


def test_head_dims_past_the_instances_raise():
    for hd in (0, 4, 12, 130, 136, 256):
        with pytest.raises(ValueError, match="multiple of 8"):
            AT.plan(hd)
