"""The large-table bin pass's plan (grad_large_bins_plain, the kernel's
plain version) on the CPU against a construction from its definition: the
cases after the first six (those: tests/test_torch_large_table_bins.py).
"""
import pytest
import torch

from tests.torch_large_table_common import (BIN_PASS_CASES,
                                            bin_pass_plan_is_its_definition)

torch.set_num_threads(1)


@pytest.mark.parametrize("scheme,log2_t,levels,case", BIN_PASS_CASES[6:])
def test_bin_pass_plan_is_its_definition(scheme, log2_t, levels, case):
    bin_pass_plan_is_its_definition(scheme, log2_t, levels, case)
