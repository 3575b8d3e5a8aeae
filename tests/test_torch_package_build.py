"""The port as a package: the config's JSON interchange with the JAX
package, and the small-table schemes built and encoding on the CPU.
"""
import dataclasses
import json

import pytest
import torch

from nerfpp_tpu import config as jax_config
from nerfpp_tpu_torch import config as port_config
from nerfpp_tpu_torch.encoders.hashgrid import HashGridEncoder
from nerfpp_tpu_torch.kernels import launch_counts, reset_launch_counts
from tests.torch_package_common import BBOX

torch.set_num_threads(1)


@pytest.mark.parametrize("preset", ["hashnerf_preset",
                                    "hashnerf_blocked_preset",
                                    "hashnerf_tpu_preset",
                                    "classic_nerf_preset"])
def test_config_json_interchange(preset, tmp_path):
    # same fields, defaults and JSON keys: a file written by one package
    # loads in the other
    jp = getattr(jax_config, preset)(n_importance=0)
    tp = getattr(port_config, preset)(n_importance=0)
    assert tp.to_json() == jp.to_json()
    jp.save(tmp_path / "p.json")
    assert port_config.ExecutorParams.load(tmp_path / "p.json") == tp
    assert (port_config.TrainParams().to_json()
            == jax_config.TrainParams().to_json())
    j = json.loads(json.dumps(port_config.TrainParams(chunk=4096).to_json()))
    assert jax_config.TrainParams.from_json(j).chunk == 4096
    assert ([f.name for f in dataclasses.fields(port_config.ExecutorParams)]
            == [f.name for f in dataclasses.fields(jax_config.ExecutorParams)])


@pytest.mark.parametrize("scheme", ["fixed", "random"])
def test_small_table_schemes_build_and_encode_on_cpu(scheme):
    # the kernel path by default; on CPU tensors its plain versions, which
    # count no launches, forward and backward
    reset_launch_counts()
    enc = HashGridEncoder(BBOX, n_levels=4, log2_hashmap_size=10,
                          scheme=scheme, device="cpu")
    assert enc.use_kernel and enc.level_size == 1024
    x = torch.rand(100, 3, generator=torch.Generator().manual_seed(0)) * 3 - 1
    feats, keep = enc(x)
    assert feats.shape == (100, 8) and bool(torch.isfinite(feats).all())
    assert bool(keep.any()) and not bool(keep.all())
    feats.sum().backward()
    assert enc.table.grad.shape == (4 * 1024, 2)
    assert bool(enc.table.grad.abs().sum() > 0)
    assert set(launch_counts().values()) == {0}
