"""The port stands alone: it imports neither JAX nor anything of the JAX
package, and its entry points never carry on quietly on the CPU."""
import ast
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
