"""encode_small's launch plan (kernels/hash_encode.py small_plan) on the CPU:
every level and 512-point tile covered once within the card's shared
memory at T = 2^15 to 2^19, packed and f32 (T = 2^10 to 2^14:
tests/test_torch_small_table_plan.py).
"""
import pytest
import torch

from tests.torch_small_table_common import (
    small_plan_covers_every_level_and_tile_once)

torch.set_num_threads(1)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("log2_t", range(15, 20))
def test_small_plan_covers_every_level_and_tile_once(log2_t, packed):
    small_plan_covers_every_level_and_tile_once(log2_t, packed)
