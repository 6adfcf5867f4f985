"""The port stands alone: it imports nothing of JAX or of the JAX package,
and its entry points do not fall back to the CPU on their own."""
import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "occformer_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "occformer_tpu")


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_no_source_imports_jax_or_the_jax_package():
    offenders = []
    sources = _port_sources()
    assert len(sources) > 20
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{os.path.relpath(path, REPO)}: {n}" for n in names
                          if _forbidden(n)]
    assert not offenders, offenders


def test_package_and_tiny_model_load_without_jax():
    code = (
        "import sys, numpy as np, torch\n"
        "sys.path.insert(0, 'tests')\n"
        "import tiny_cfg\n"
        "import occformer_tpu_torch.engine.eval, occformer_tpu_torch.engine.convert_weights\n"
        "import occformer_tpu_torch.data.synthetic, occformer_tpu_torch.config\n"
        "import occformer_tpu_torch.engine.train, occformer_tpu_torch.engine.optim\n"
        "import occformer_tpu_torch.losses.mask2former_loss, occformer_tpu_torch.ops.trilerp\n"
        "import occformer_tpu_torch.models.efficientnet, occformer_tpu_torch.data.semantic_kitti\n"
        "import occformer_tpu_torch.data.fixtures, occformer_tpu_torch.engine.pretrained\n"
        "import occformer_tpu_torch.utils.semkitti, occformer_tpu_torch.utils.semkitti_io\n"
        "import occformer_tpu_torch.utils.metrics, occformer_tpu_torch.tools.kitti_preprocess\n"
        "import occformer_tpu_torch.tools.train, occformer_tpu_torch.tools.test\n"
        "import occformer_tpu_torch.models.bevstereo\n"
        "from occformer_tpu_torch.models.lss import shift_feature\n"
        "from occformer_tpu_torch.models.detector import OccupancyFormer4D, build_model\n"
        "cfg4d = dict(tiny_cfg.model_cfg(), type='OccupancyFormer4D')\n"
        "assert isinstance(build_model(cfg4d, device='meta'), OccupancyFormer4D)\n"
        "kitti = occformer_tpu_torch.config.load_config("
        "'occformer_tpu_torch/configs/occformer_kitti.py')\n"
        "assert len(build_model(kitti['model'], device='meta').state_dict()) == 1983\n"
        "torch.set_num_threads(1)\n"
        "m = build_model(tiny_cfg.model_cfg(), device='cpu')\n"
        "b = {k: torch.from_numpy(v) for k, v in tiny_cfg.make_batch(np.random.RandomState(0)).items()}\n"
        "with torch.no_grad():\n"
        "    m(b)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in %r)\n"
        "print('LOADED', bad)\n" % (FORBIDDEN,)
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout[-2000:]


def test_build_model_without_device_needs_a_gpu():
    import tiny_cfg

    from occformer_tpu_torch.models.detector import build_model

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(tiny_cfg.model_cfg())


def test_train_step_without_device_needs_a_gpu():
    import tiny_cfg

    from occformer_tpu_torch.engine.optim import build_optimizer
    from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step
    from occformer_tpu_torch.models.detector import build_model

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cfg = tiny_cfg.model_cfg()
    model = build_model(cfg, device="cpu")
    loss_cfg = build_loss_cfg(cfg["pts_bbox_head"], dict(num_points=64))
    opt = build_optimizer(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_train_step(model, opt, loss_cfg)
    assert callable(build_train_step(model, opt, loss_cfg, device="cpu"))
