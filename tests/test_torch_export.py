"""The kernels as ``torch.library`` ops, and the exported serving forward.

* ``torch.library.opcheck`` of every ``occformer`` op's CPU implementation
  (its plain version) at a small shape: the schema, the fake
  implementation's shapes, dtypes and strides, the autograd registration
  of the forwards that train, and an AOT trace with dynamic shapes
  (``ops/library.py:opcheck``: the ops without a derivative, whose
  floating outputs that trace would differentiate, skip it).
* The tiny model's serving function (``tools/export_model.py:
  ServingForward``) exported on the CPU, in float32 and on the bf16
  autocast route: one ``occformer::*`` node per op call of the eager call
  (counted by a ``TorchDispatchMode``: the launch counts stay at 0 on the
  CPU), no plain version of a kernel outside them, and ``save`` / ``load``
  (through ``load_exported``) gives the eager call's bits.  The float32
  export is also held to JAX's ``forward`` (``tools/export_model.py:88-91``)
  with the JAX model's weights converted, within ``tests/test_torch_model.py``'s
  tolerance (``1e-3 * max|ref| + 1e-4``).
"""
import numpy as np
import pytest
import torch

import jax

import tiny_cfg
from occformer_tpu.models.detector import OccupancyFormer as JaxOccupancyFormer
from occformer_tpu.models.mask2former_head import (format_results as jax_format_results,
                                                   mask_logits_from_embeds as jax_mask_logits)
from occformer_tpu_torch import ops
from occformer_tpu_torch.engine.convert_weights import flax_to_torch_state_dict
from occformer_tpu_torch.models.detector import build_model
from occformer_tpu_torch.ops import library
from occformer_tpu_torch.tools import export_model

COMPONENTS = ("img_backbone", "img_neck", "img_view_transformer",
              "img_bev_encoder_backbone", "img_bev_encoder_neck", "pts_bbox_head")
# aten operators that compute a kernel's function: none may stand in the graph
PLAIN_KERNEL_OPERATORS = ("grid_sampler", "index_add", "index_put")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kernel", sorted(library.OPS))
def test_opcheck_cpu_implementation(kernel):
    result = library.opcheck(library.OPS[kernel])
    assert set(result.values()) == {"SUCCESS"}, result


def test_every_kernel_has_an_op_and_a_launch_count():
    assert set(library.OPS) <= set(ops.launch_counts())
    for name in library.OPS.values():
        assert hasattr(torch.ops.occformer, name), name


def _batch():
    return {k: torch.from_numpy(v) for k, v in
            tiny_cfg.make_batch(np.random.RandomState(0)).items()}


@pytest.fixture(scope="module")
def jax_and_port():
    cfg = tiny_cfg.model_cfg()
    jmodel = JaxOccupancyFormer(**{k: cfg[k] for k in COMPONENTS})
    jbatch = {k: v.numpy() for k, v in _batch().items()}
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch))
    with torch.random.fork_rng():
        model = build_model(cfg, device="cpu")
    model.load_state_dict(flax_to_torch_state_dict(variables, model), strict=True)
    return jmodel, variables, model


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16], ids=["float32", "bf16"])
def test_exported_serving_forward(jax_and_port, tmp_path, compute_dtype):
    jmodel, variables, model = jax_and_port
    batch = _batch()
    ops.reset_launch_counts()
    # a dispatch mode moves the bf16 route's bits (it turns fast paths
    # off), so the calls are counted on an eager call of their own
    with library.OpCalls() as calls:
        export_model.eager_serving(model, batch, compute_dtype)
    assert not any(ops.launch_counts().values())  # no kernel launches on the CPU
    want = calls.counts()
    eager = export_model.eager_serving(model, batch, compute_dtype)
    assert {k: v for k, v in want.items() if v} == {"K1": 2, "K4": 1, "S1": 1}

    ep = export_model.export_serving(model, batch, compute_dtype)
    assert library.graph_op_counts(ep.graph_module) == want
    plain = [str(n.target) for n in ep.graph.nodes
             if any(p in str(n.target) for p in PLAIN_KERNEL_OPERATORS)]
    assert not plain, plain

    path = str(tmp_path / "tiny.pt2")
    assert export_model.save_exported(ep, path, compute_dtype) > 0
    loaded, dtype = export_model.load_exported(path)
    assert dtype == compute_dtype
    out = export_model.run_exported(loaded, dtype, batch)
    assert out.dtype == eager.dtype and torch.equal(out, eager)

    if compute_dtype is None:  # JAX's forward: the model, the final mask, format_results
        jbatch = {k: v.numpy() for k, v in batch.items()}
        jout = jax.jit(jmodel.apply)(variables, jbatch)
        ref = np.asarray(jax_format_results(
            jout["cls_preds"][-1], jax_mask_logits(jout["mask_embeds"][-1],
                                                   jout["mask_feature"])), np.float32)
        got = out.numpy()
        assert got.shape == ref.shape
        tol = 1e-3 * np.abs(ref).max() + 1e-4
        assert np.abs(got - ref).max() <= tol


def test_export_cli_writes_and_verifies_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "model.pt2")
    assert export_model.main(["occformer_tpu_torch/configs/synthetic_tiny.py", "--out", out,
                              "--verify", "--cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"wrote {out} (") and "torch.export archive" in lines[0]
    assert lines[1].startswith("verify: output (1, 16, 16, 8, 5) torch.float32")
    assert float(lines[1].split()[-1]) == 0.0
