"""The port stands alone: it imports neither JAX nor anything of the JAX
package, and its entry points never carry on quietly on the CPU."""
import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import damvsnet_tpu_torch
from damvsnet_tpu_torch.cli import test as cli_test
from damvsnet_tpu_torch.cli import train as cli_train
from damvsnet_tpu_torch.infer import DepthRunner
from damvsnet_tpu_torch.infer.fusion_device import fuse_reference_view
from damvsnet_tpu_torch.model import CascadeMVSNet
from damvsnet_tpu_torch.train.loop import Trainer, make_train_step
from damvsnet_tpu_torch.train.state import TrainState

torch.set_num_threads(1)

PKG = Path(damvsnet_tpu_torch.__file__).resolve().parent
REPO = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "damvsnet_tpu")
# what drives the port on the card: it stands alone as the package does
SCRIPTS = (REPO / "chip_smoke.py", *sorted((REPO / "scripts").glob("*torch*.py")))
JAX_PKG = REPO / "damvsnet_tpu"
# The JAX package's public names the port does not have, each with its
# reason; every name a JAX ``__init__`` exports resolves in the port or
# stands here.
NOT_TO_PORT = {
    "conv_transpose_torch": "JAX's emulation of torch's transposed convolution: the port's "
                            "blocks use nn.ConvTranspose* itself",
    "create_train_state": "TrainState(model, optimizer, scheduler) builds the port's state",
    "save_checkpoint": "Checkpointer saves the port's checkpoints",
    "wait_for_saves": "Checkpointer.wait; there is no orbax save manager",
    "MeshAxes": "GSPMD's named mesh axes; the port passes its process groups (Mesh)",
    "batch_sharding": "GSPMD: a rank takes its rows of the batch (batch_rows)",
    "replicate_sharding": "GSPMD: parameters are replicated by DDP",
    "shard_batch": "GSPMD: a rank takes its rows of the batch (batch_rows)",
    "active_mesh": "GSPMD's ambient mesh; the port passes its groups explicitly",
    "mesh_axis_size": "GSPMD's ambient mesh; dist.get_world_size(group)",
    "compute_dtype_scope": "nn/precision.py's trace-time scope; the model's compute_dtype",
    "pallas_sampler_supported": "the TPU sampler's test; the CUDA kernels gather every tap",
    "prob_volume_stats_pallas": "the TPU kernel K2's entry; its Hopper kernel is "
                                "ops.kernels.probstats.prob_volume_stats_fused",
}
# a JAX subpackage whose counterpart the port names otherwise
PORT_SUBPACKAGE = {"ops.pallas": "ops.kernels"}


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def test_no_forbidden_import_statement():
    """AST scan of the absolute imports of every module, of chip_smoke.py
    and of scripts/*torch*.py (imports inside functions included)."""
    assert len(SCRIPTS) >= 3  # chip_smoke.py and the profile and sensitivity scripts
    bad = []
    for path in [p for p, _ in _modules()] + list(SCRIPTS):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad


def test_importing_every_module_loads_no_jax():
    """A fresh interpreter imports every module of the port, then finds no
    JAX and nothing of the JAX package in sys.modules."""
    mods = [m for _, m in _modules()]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "print(len(sys.modules)); sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": str(PKG.parent)}
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(PKG.parent),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_every_module_is_covered():
    """The scans above walk the package, so a new module is covered; the
    training slices' modules, the sampler kernel's, the loaders and host IO,
    the library losses, the test CLI's slice (eval loaders, codec, PLY,
    depth writer, fusion, native library, evaluation, CLIs) and the
    distributed and tooling slice (process groups, collectives, FMT's
    sequence parallelism, the event writer, the profiler, the
    visualizations) and the depth-slab axis are among them."""
    mods = {m for _, m in _modules()}
    assert {"damvsnet_tpu_torch.losses.crossview", "damvsnet_tpu_torch.losses.supervised",
            "damvsnet_tpu_torch.train.loop", "damvsnet_tpu_torch.train.state",
            "damvsnet_tpu_torch.train.schedule", "damvsnet_tpu_torch.train.metrics",
            "damvsnet_tpu_torch.data.common", "damvsnet_tpu_torch.cli.train",
            "damvsnet_tpu_torch.ops.kernels.sweep_sampler",
            "damvsnet_tpu_torch.core.pfm", "damvsnet_tpu_torch.core.pairs",
            "damvsnet_tpu_torch.core.cameras", "damvsnet_tpu_torch.data.dtu",
            "damvsnet_tpu_torch.data.blendedmvs", "damvsnet_tpu_torch.data.edges",
            "damvsnet_tpu_torch.losses.entropy", "damvsnet_tpu_torch.losses.unsupervised",
            "damvsnet_tpu_torch.core.imageio", "damvsnet_tpu_torch.core.ply",
            "damvsnet_tpu_torch.data.general_eval", "damvsnet_tpu_torch.data.tnt_eval",
            "damvsnet_tpu_torch.infer.runner", "damvsnet_tpu_torch.infer.tank_config",
            "damvsnet_tpu_torch.infer.fusion_dypcd", "damvsnet_tpu_torch.infer.fusion_pcd",
            "damvsnet_tpu_torch.infer.fusion_device", "damvsnet_tpu_torch.infer.gipuma_bridge",
            "damvsnet_tpu_torch.native_ext", "damvsnet_tpu_torch.eval.dtu_eval",
            "damvsnet_tpu_torch.cli.test", "damvsnet_tpu_torch.cli.eval_dtu",
            "damvsnet_tpu_torch.cli.colmap2mvsnet", "damvsnet_tpu_torch.parallel",
            "damvsnet_tpu_torch.parallel.mesh", "damvsnet_tpu_torch.parallel.collectives",
            "damvsnet_tpu_torch.parallel.fmt_sp", "damvsnet_tpu_torch.train.logging",
            "damvsnet_tpu_torch.train.profiler", "damvsnet_tpu_torch.utils.visualize",
            "damvsnet_tpu_torch.parallel.slab"} <= mods


def test_package_imports_without_cv2_and_pil():
    """A fresh interpreter in which cv2 and PIL cannot be imported (as on
    the card's machine) imports every module of the port, the loaders
    included."""
    mods = [m for _, m in _modules()]
    code = ("import importlib, sys\n"
            "sys.modules['cv2'] = None; sys.modules['PIL'] = None\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from damvsnet_tpu_torch.data import find_dataset_def\n"
            "assert find_dataset_def('dtu_yao').__name__ == 'DTUTrainDataset'\n"
            "assert find_dataset_def('general_eval').__name__ == 'GeneralEvalDataset'\n"
            "assert find_dataset_def('tnt_eval_trans').__name__ == 'TnTEvalDataset'\n")
    env = {**os.environ, "PYTHONPATH": str(PKG.parent)}
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(PKG.parent),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("entry", ["model", "runner", "train_step", "trainer", "cli",
                                   "variance_model", "test_cli", "fusion"])
def test_entry_points_raise_without_cuda(monkeypatch, entry, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "model":
            CascadeMVSNet(ndepths=(8, 8, 8))
        elif entry == "runner":
            DepthRunner(CascadeMVSNet(ndepths=(8, 8, 8), device="cpu"))
        elif entry == "train_step":
            make_train_step()
        elif entry == "trainer":
            model = CascadeMVSNet(ndepths=(8, 8, 8), device="cpu")
            opt = torch.optim.Adam(model.parameters())
            Trainer(TrainState(model, opt), str(tmp_path))
        elif entry == "cli":
            cli_train.main(["--logdir", str(tmp_path), "--epochs", "1"])
        elif entry == "test_cli":
            cli_test.main(["--testpath", str(tmp_path), "--testlist", str(tmp_path / "list")])
        elif entry == "fusion":
            z = np.zeros((1, 4, 4), np.float32)
            fuse_reference_view(z[0], np.eye(3), np.eye(4), z, np.eye(3)[None], np.eye(4)[None])
        else:
            CascadeMVSNet(ndepths=(8, 8, 8), agg_mode="variance")


def _jax_exports():
    """(subpackage, name) of every name a JAX ``__init__`` imports from its
    modules, read from the source (no JAX import)."""
    for init in sorted(JAX_PKG.rglob("__init__.py")):
        sub = ".".join(init.parent.relative_to(JAX_PKG).parts)
        for node in ast.parse(init.read_text()).body:
            if isinstance(node, ast.ImportFrom) and node.level == 1:
                yield from ((sub, a.asname or a.name) for a in node.names)


def _jax_top_level_names():
    names = set()
    for path in JAX_PKG.rglob("*.py"):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                names.update(a.asname or a.name for a in node.names)
            elif isinstance(node, ast.Assign):
                names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return names


def test_every_jax_export_resolves_in_the_port_or_has_its_reason():
    """Each name of a JAX ``__init__`` is an attribute of the port's
    counterpart package, or is on NOT_TO_PORT; each entry of NOT_TO_PORT is
    a top-level name of the JAX package that the port's packages lack."""
    exports = list(_jax_exports())
    assert len(exports) > 80
    missing = []
    for sub, name in exports:
        pkg = importlib.import_module(".".join(
            ["damvsnet_tpu_torch", PORT_SUBPACKAGE.get(sub, sub)]).rstrip("."))
        if not hasattr(pkg, name) and name not in NOT_TO_PORT:
            missing.append(f"{sub}: {name}")
    assert not missing
    jax_names = _jax_top_level_names()
    assert set(NOT_TO_PORT) <= jax_names
    port_names = {n for _, m in _modules() for n in dir(importlib.import_module(m))}
    assert not set(NOT_TO_PORT) & port_names
