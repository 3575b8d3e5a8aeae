"""The port as a package: imports, device rule, config interchange, the
small-table schemes and the importance pass on the CPU, and the parts of the
JAX package that are not ported yet failing loudly.

The config interchange and the small-table schemes:
tests/test_torch_package_build.py.
"""
import ast
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from nerfpp_tpu_torch import config as port_config
from nerfpp_tpu_torch import resolve_device
from nerfpp_tpu_torch.core.occupancy import make_occupancy_grid
from nerfpp_tpu_torch.data.dataset import RayBatchSampler
from nerfpp_tpu_torch.data.synthetic import make_synthetic_scene
from nerfpp_tpu_torch.encoders.hashgrid import HashGridEncoder
from nerfpp_tpu_torch.executor import NeRFExecutor
from nerfpp_tpu_torch.models.nerf_small import NeRFSmall
from nerfpp_tpu_torch.nn import MLP
from nerfpp_tpu_torch.render import renderer as TR
from tests.torch_package_common import BBOX, PORT, ROOT, _banned

torch.set_num_threads(1)


def test_import_loads_neither_jax_nor_nerfpp_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import nerfpp_tpu_torch\n"
        "for m in pkgutil.walk_packages(nerfpp_tpu_torch.__path__,\n"
        "                               'nerfpp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print(sorted(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    assert "nerfpp_tpu_torch.executor" in loaded
    for mod in ("parallel.mesh", "core.losses", "utils.profiling"):
        assert f"nerfpp_tpu_torch.{mod}" in loaded
    assert [m for m in loaded if _banned(m)] == []


def test_sources_import_no_jax():
    # every import statement of the port, of chip_smoke.py and of the
    # COLMAP, JPEG-kind and fax writers both it and the tests use, read as
    # code
    files = sorted(PORT.rglob("*.py"))
    for mod in (("parallel", "mesh.py"), ("core", "losses.py"),
                ("utils", "profiling.py")):
        assert PORT.joinpath(*mod) in files
    files += [ROOT / "chip_smoke.py", ROOT / "scripts" / "colmap_export.py",
              ROOT / "scripts" / "jpeg_kinds.py",
              ROOT / "scripts" / "fax_kinds.py",
              ROOT / "tests" / "torch_parallel_workers.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            assert not [n for n in names if _banned(n)], (path, names)


def test_default_device_is_cuda():
    # entry points default to "cuda" and never fall back to the CPU
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    scene = make_synthetic_scene(n_train=1, n_val=0, n_test=0, image_hw=4,
                                 n_samples=4, device="cpu")
    for make in (lambda: resolve_device(),
                 lambda: HashGridEncoder(BBOX, log2_hashmap_size=10),
                 lambda: MLP([4, 8, 1]),
                 lambda: NeRFSmall(input_ch=4, input_ch_views=4),
                 lambda: make_occupancy_grid(8),
                 lambda: NeRFExecutor(port_config.hashnerf_blocked_preset()),
                 lambda: make_synthetic_scene(n_train=1, n_val=0, n_test=0,
                                              image_hw=4),
                 lambda: RayBatchSampler.from_scene(scene, 128)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert resolve_device("cpu").type == "cpu"


def test_render_rays_runs_the_importance_pass():
    # 8 importance depths per ray merged into the 4 coarse ones, sorted;
    # outputs are the fine pass's, coarse keeps the first
    cfg = TR.RenderConfig(n_samples=4, n_importance=8, thin_ray=True,
                          use_viewdirs=False)
    seen = []

    def network_fn(pts, viewdirs):
        seen.append(pts.shape[1])
        sigma = 5.0 * torch.exp(-(pts ** 2).sum(-1, keepdim=True))
        return torch.cat([torch.sigmoid(pts), sigma], dim=-1)

    o = torch.tensor([[0.0, 0.0, -3.0], [0.3, 0.0, -3.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.1, 1.0]])
    res = TR.render_rays(network_fn, TR.make_nerf_integrate_fn(cfg), o, d,
                         torch.full((2, 1), 1.0), torch.full((2, 1), 5.0),
                         None, None, cfg)
    assert seen == [4, 12]
    assert res.z_vals.shape == (2, 12) and res.outputs.weights.shape == (2, 12)
    assert res.coarse.weights.shape == (2, 4)
    assert bool((res.z_vals[:, 1:] >= res.z_vals[:, :-1]).all())
    # the importance depths gather where the coarse weights are, near z = 3
    assert float((res.z_vals - 3.0).abs().median()) < 1.0


def test_executor_builds_flagship_stack_on_cpu():
    p = port_config.hashnerf_blocked_preset(
        n_importance=0, use_occupancy_grid=True, log2_hashmap_size=10,
        n_levels=2, occ_grid_resolution=8)
    ex = NeRFExecutor(p, device="cpu").initialize(BBOX, seed=3)
    again = NeRFExecutor(p, device="cpu").initialize(BBOX, seed=3)
    assert torch.equal(ex.embedder.table, again.embedder.table)
    assert float(ex.embedder.table.detach().abs().max()) <= 1e-4
    assert ex._sample_major() and ex.occupancy.resolution == 8
    # nn.Linear layout [out, in]: 2 levels x 2 features in, net_width out
    assert ex.model.sigma_net.layers[0].weight.shape == (p.net_width, 4)
    assert ex.model.color_net.layers[0].weight.shape == (
        p.hidden_dim_color, ex.embeddirs.output_dims + p.geo_feat_dim)
    cfg = ex.make_render_config(port_config.TrainParams(), train=False)
    assert cfg.tile_order and cfg.n_occ_bins == p.occ_n_bins
    assert ex._auto_frac_eligible(cfg)


def test_chip_smoke_fails_without_cuda_or_package(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the failure without a GPU")
    for cwd in (ROOT, tmp_path):
        if cwd is tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_state_from_jax_layout():
    from nerfpp_tpu_torch.convert import state_from_jax
    rng = np.random.RandomState(0)
    params = {"embed": {"table": rng.standard_normal((256, 2))},
              "model": {"sigma_net": [{"w": rng.standard_normal((4, 16))}],
                        "color_net": [{"w": rng.standard_normal((31, 3))}]}}
    st = state_from_jax(params, np.ones((4, 4, 4)), device="cpu")
    assert st["model.sigma_net.layers.0.weight"].shape == (16, 4)
    np.testing.assert_array_equal(st["model.color_net.layers.0.weight"],
                                  params["model"]["color_net"][0]["w"].T
                                  .astype(np.float32))
    assert st["occupancy"].shape == (4, 4, 4)
    params["model"]["sigma_net"][0]["b"] = np.zeros(16)
    with pytest.raises(ValueError, match="bias"):
        state_from_jax(params, device="cpu")
