"""The port stands alone: no module of ``pytorch_volumetric_tpu_torch`` and
not ``chip_smoke.py`` imports JAX or the JAX package, and entry points never
fall back to the CPU without being asked."""

import ast
import os

import numpy as np
import pytest
import torch

import pytorch_volumetric_tpu_torch as pt
from pytorch_volumetric_tpu_torch.utils.batching import as_float_tensor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "pytorch_volumetric_tpu_torch")


def _port_sources():
    examples = os.path.join(REPO, "examples")
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(examples, n) for n in os.listdir(examples) if n.startswith("torch_")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "pytorch_volumetric_tpu")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_forbidden_names_are_matched_exactly():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("pytorch_volumetric_tpu") and _forbidden("pytorch_volumetric_tpu.sdf")
    assert not _forbidden("pytorch_volumetric_tpu_torch")
    assert not _forbidden("pytorch_volumetric_tpu_torch.sdf")


def test_port_imports_no_jax():
    sources = _port_sources()
    assert os.path.join(REPO, "chip_smoke.py") in sources and len(sources) > 10
    assert len([s for s in sources if os.sep + "examples" + os.sep in s]) == 4
    bad = []
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        bad += [f"{os.path.relpath(path, REPO)}: {m}" for m in _imported_modules(tree)
                if _forbidden(m)]
    assert not bad, bad


def test_entry_points_run_on_cuda_unless_asked():
    """Without ``device="cpu"`` an entry point runs on CUDA; with no GPU it
    raises instead of quietly running on the CPU."""
    urdf = '<robot name="r"><link name="a"/></robot>'
    if torch.cuda.is_available():
        assert pt.build_chain_from_urdf(urdf).device.type == "cuda"
        assert as_float_tensor(np.zeros(3)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.build_chain_from_urdf(urdf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        as_float_tensor(np.zeros(3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.SphereSDF(0.1)
    assert pt.build_chain_from_urdf(urdf, device="cpu").device.type == "cpu"


def test_every_port_module_imports():
    """Each module of the port imports on a machine without a GPU, nvcc or
    triton: kernels are built and loaded only when first launched."""
    import importlib
    names = []
    for path in _port_sources():
        rel = os.path.relpath(path, REPO)
        if rel.startswith("pytorch_volumetric_tpu_torch"):
            mod = rel[:-3].replace(os.sep, ".")
            names.append(mod[:-len(".__init__")] if mod.endswith(".__init__") else mod)
    for extra in ("chamfer", "bench.sweep_roofline", "ops.fma_probe", "utils.profiling",
                  "native", "ops.narrow_band", "ops.narrow_band_cuda", "bench.bigmesh",
                  "utils.serving", "utils.debug", "ops.straight_through"):
        assert f"pytorch_volumetric_tpu_torch.{extra}" in names
    for name in names:
        importlib.import_module(name)


def test_new_entry_points_run_on_cuda_unless_asked(tmp_path):
    """The SDF and MJCF loaders, surface sampling and the roofline probe
    default to CUDA: without a GPU they raise (the probe exits non-zero)."""
    from pytorch_volumetric_tpu_torch.bench import sweep_roofline
    sdf = '<sdf version="1.6"><model name="m"><link name="a"/></model></sdf>'
    mjcf = "<mujoco><worldbody/></mujoco>"
    if torch.cuda.is_available():
        assert pt.build_chain_from_sdf(sdf).device.type == "cuda"
        assert pt.build_chain_from_mjcf(mjcf).device.type == "cuda"
        return
    for build, doc in ((pt.build_chain_from_sdf, sdf), (pt.build_chain_from_mjcf, mjcf)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(doc)
        assert build(doc, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.sample_mesh_points(None, name="m", dbpath=str(tmp_path / "p.npz"))
    assert sweep_roofline.main([]) == 1


def test_narrow_band_entry_points_run_on_cuda_unless_asked(tmp_path):
    """The narrow-band SDF, its link factory, its table builders and the
    bigmesh benchmark default to CUDA: without a GPU they raise (the
    benchmark exits non-zero) unless given ``device="cpu"``."""
    from pytorch_volumetric_tpu_torch.bench import bigmesh
    from pytorch_volumetric_tpu_torch.ops import narrow_band as nb
    m = pt.mesh.icosphere_mesh(0.2, 1)
    path = str(tmp_path / "ball.obj")
    pt.mesh.save_obj(m, path)
    if torch.cuda.is_available():
        fac = pt.MeshObjectFactory(path)
        assert pt.NarrowBandMeshSDF(fac, cell_res=0.05).tables.meta.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.NarrowBandMeshSDF(pt.MeshObjectFactory(path), cell_res=0.05)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nb.build_narrow_band_tables(m, 0.05, 0.1)
    host = nb.build_narrow_band_host(m, 0.05, 0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nb.tables_from_numpy(host)
    assert nb.tables_from_numpy(host, "cpu").cand.device.type == "cpu"
    fac = pt.MeshObjectFactory(path, device="cpu")
    link = pt.narrow_band_link_sdf_factory(cell_res=0.05)(fac)
    assert isinstance(link, pt.NarrowBandMeshSDF) and link.tables.meta.device.type == "cpu"
    assert link.tables.lo.device.type == "cpu" and link.raw_query_aux()[0].device.type == "cpu"
    assert bigmesh.main([]) == 1
