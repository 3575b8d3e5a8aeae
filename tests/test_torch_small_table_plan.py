"""encode_small's launch plan (kernels/hash_encode.py small_plan) on the CPU:
every level and 512-point tile covered once within the card's shared
memory at T = 2^10 to 2^14, packed and f32, and the plan at the serving
shape (T = 2^15 to 2^19: tests/test_torch_small_table_plan_deep.py).
"""
import pytest
import torch

from nerfpp_tpu_torch.kernels import hash_encode as KS
from tests.torch_small_table_common import (
    small_plan_covers_every_level_and_tile_once)

torch.set_num_threads(1)


def test_small_plan_at_the_serving_shape():
    # 16 levels, T = 2^13: four levels a group (one 32-byte sector of each
    # row), all staged packed, three of four with the f32 table. T = 2^15:
    # four levels a group, one staged packed; the f32 table is gathered
    # from L2 in whole rows
    serving = 8_388_608
    assert KS.small_stage(16, 1 << 13, True) == (4, 4, 163840)
    assert KS.small_stage(16, 1 << 13, False) == (4, 3, 229376)
    assert KS.small_stage(16, 1 << 15, True) == (4, 1, 163840)
    assert KS.small_stage(16, 1 << 15, False) == (16, 0, 131072)
    plan = KS.small_plan(serving, 16, 1 << 13, True, 132)
    assert (plan.n_groups, plan.grid) == (4, 132)
    assert KS.small_plan(1000, 16, 1 << 13, True, 132).grid == 4


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("log2_t", range(10, 15))
def test_small_plan_covers_every_level_and_tile_once(log2_t, packed):
    small_plan_covers_every_level_and_tile_once(log2_t, packed)
