"""The port across ranks on the CPU: two ``gloo`` processes on 127.0.0.1
(torchrun's environment, set by hand) against one process and the JAX
package.

One spawn of two ranks (this file run as a script) does all the
multi-rank work, and each test reads its part:

  * a ``Conv3dBlock`` and a ``Conv2dBlock`` in training mode, each rank
    on its half of the batch inside ``batch_stats_group``: the output, the
    input's gradient, the parameters' gradients (summed over ranks) and the
    running statistics against one process on the whole batch, fp32, rtol
    1e-5;
  * whole training steps through ``make_train_step`` with a data mesh (DDP,
    synced BN, the losses over the global mask counts, metrics averaged),
    each rank on its ``batch_rows`` of the global batch, under SGD with a
    learning rate of 0 so that the averaged gradients stay readable: the
    non-fused step (the JAX CLI's default) on scenes 2-3 whose two samples
    have different mask counts, against JAX's step on the global batch at
    tests/test_torch_train_step_nonfused.py's tolerances and against the
    port's one-process step; the fused step, and the fused step with
    ``grad_accum=2`` on a global batch of 4 (scenes 2, 3, 3, 2: the two
    microbatches differ in their masks), against the port's one-process
    step: the losses and metrics at rtol 1e-5, the running statistics at
    1e-5, the gradient's relative L2 over all parameters at 1e-3 and each
    gradient within 5e-3 of its tensor's largest entry (a weight net's conv
    + BN block: of the block's, as the JAX comparisons group them);
  * ``sequence_parallel_linear_attention`` over the two ranks, forward and
    gradient, with as many key batches as query batches and with fewer,
    against the port's ``linear_attention`` and JAX's sequence-parallel
    attention on its 8-device CPU mesh;
  * the test CLI, scan-parallel over 3 synthetic scenes at 32x64: disjoint
    and complete ownership, and every depth, confidence and PLY file
    bitwise equal to one process's run.

The spawn starts before the JAX references are computed and runs beside
them.

The whole step's gradient is held no tighter against one process because
it is ill-conditioned at these sizes (BN over maps of 2x2 to 8x8, ReLU
kinks; ROADMAP Queue 3): the synced BN's fp32 arithmetic, exact but not
F.batch_norm's, moves it by up to 2.2e-3 of a tensor's largest entry with
no rank split at all (a one-rank group), the split itself by about 1e-6
more, and a 1e-7 relative change of the images moves it by up to 5.8e-2
on the accumulation batch. The losses, metrics and statistics are well
conditioned and are held at 1e-5.
"""
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from damvsnet_tpu_torch.cli import test as cli_test
from damvsnet_tpu_torch.cli import train as cli_train
from damvsnet_tpu_torch.data import DataLoader, SyntheticDataset, collate, make_synthetic_sample
from damvsnet_tpu_torch.model import CascadeMVSNet
from damvsnet_tpu_torch.nn.blocks import Conv2dBlock, Conv3dBlock, batch_stats_group
from damvsnet_tpu_torch.nn.fmt import linear_attention
from damvsnet_tpu_torch.parallel import (batch_rows, make_mesh, maybe_initialize_distributed,
                                         sequence_parallel_linear_attention, shard_work_items)
from damvsnet_tpu_torch.train.loop import make_train_step
from damvsnet_tpu_torch.train.state import TrainState
from damvsnet_tpu_torch.utils.weights import load_bench_weights

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
WEIGHTS = str(REPO / "weights" / "bench_ckpt.npz")
NDEPTHS = (8, 8, 8)
RANKS = 2
SPAWN_TIMEOUT = 600
BATCH_KEYS = ("imgs", "proj_matrices", "depth_values", "depth", "mask")
STEPS = {  # name: (scenes, config, grad_accum)
    "nonfused": ((2, 3), {"fused_train": False, "clamp_samples": False}, 1),
    "fused": ((2, 3), {"fused_train": True, "clamp_samples": True}, 1),
    "fused_accum2": ((2, 3, 3, 2), {"fused_train": True, "clamp_samples": True}, 2),
}
SCENES, CLI_H, CLI_W = ["scan_a", "scan_b", "scan_c"], 32, 64


# ---- what both sides run: one process on the whole input, or a rank on its part ----


def global_batch(scenes):
    """The port's synthetic scenes, collated (32x32, N=3, D0=16), with the
    first half of the rows of every other sample's masks cleared, so the
    samples have different mask counts."""
    batch = collate([make_synthetic_sample(32, 32, 3, 16, seed=s) for s in scenes])
    batch = {k: batch[k] for k in BATCH_KEYS}
    for stage, m in batch["mask"].items():
        m[1::2, :m.shape[1] // 2] = 0.0
    return batch


def take_rows(batch, rows):
    if isinstance(batch, dict):
        return {k: take_rows(v, rows) for k, v in batch.items()}
    return batch[rows]


def port_step(batch, config, grad_accum, mesh=None, seeded=()):
    """One ``make_train_step`` step from the trained weights (``seeded``
    modules at their seeded init) under SGD with lr 0: (metrics, {name:
    gradient}, state_dict), all numpy."""
    torch.manual_seed(0)
    model = CascadeMVSNet(ndepths=NDEPTHS, device="cpu", **config)
    load_bench_weights(model, WEIGHTS, seeded=seeded)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))
    step = make_train_step(grad_accum=grad_accum, device="cpu", mesh=mesh)
    with torch.backends.mkldnn.flags(enabled=False):
        metrics = step(state, batch)
    metrics.pop("_images")
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.numpy().copy() for n, p in model.named_parameters()},
            {k: v.numpy().copy() for k, v in model.state_dict().items()})


def run_blocks(inputs, rows=slice(None), group=None):
    """Conv3dBlock and Conv2dBlock in training mode on ``rows`` of the
    inputs, their BN's statistics over ``group``; a seeded cotangent."""
    out = {}
    for name, cls, args in (("conv3d", Conv3dBlock, (4, 8, 3, 1, 1)),
                            ("conv2d", Conv2dBlock, (3, 6, 3, 1, 1))):
        torch.manual_seed(0)
        block = cls(*args).train()
        with torch.no_grad():
            block.bn.weight.uniform_(0.5, 1.5)
            block.bn.bias.uniform_(-0.5, 0.5)
        x = torch.from_numpy(inputs[name]["x"][rows]).requires_grad_()
        with batch_stats_group(group):
            y = block(x)
        (y * torch.from_numpy(inputs[name]["cot"][rows])).sum().backward()
        out[name] = {"out": y.detach().numpy(), "dx": x.grad.numpy(),
                     "grads": {n: p.grad.numpy() for n, p in block.named_parameters()},
                     "buffers": {n: b.numpy() for n, b in block.named_buffers()}}
    return out


def run_attention(inputs, group=None):
    """Out and the gradients of sum(out * cot) for each case, through the
    sequence-parallel attention over ``group`` or ``linear_attention``."""
    out = {}
    for case, arrays in inputs.items():
        q, k, v = (torch.from_numpy(arrays[n]).requires_grad_() for n in "qkv")
        o = (linear_attention(q, k, v) if group is None
             else sequence_parallel_linear_attention(q, k, v, group))
        (o * torch.from_numpy(arrays["cot"])).sum().backward()
        out[case] = {"out": o.detach().numpy(), "dq": q.grad.numpy(),
                     "dk": k.grad.numpy(), "dv": v.grad.numpy()}
    return out


def cli_argv(root, outdir):
    return ["--testpath", str(root / "data"), "--testlist", str(root / "list.txt"),
            "--outdir", str(outdir), "--device", "cpu", "--dtype", "f32",
            "--loadckpt", WEIGHTS, "--ndepths", ",".join(map(str, NDEPTHS)),
            "--num_view", "3", "--max_h", str(CLI_H), "--max_w", str(CLI_W),
            "--filter_method", "consistency", "--conf", "0.1,0.15,0.5"]


def run_cli(root, outdir):
    """The test CLI; returns the scenes this process built a loader for."""
    from damvsnet_tpu_torch import data
    owned, inner = [], data.find_dataset_def

    def recording(name):
        cls = inner(name)

        def build(datapath, scenes, *args, **kwargs):
            owned.extend(scenes)
            return cls(datapath, scenes, *args, **kwargs)
        return build
    data.find_dataset_def = recording
    try:
        cli_test.main(cli_argv(root, outdir))
    finally:
        data.find_dataset_def = inner
    return owned


def worker(root):
    """A rank of the spawn: every multi-rank case, its results pickled to
    ``rank{r}.pkl``."""
    root = Path(root)
    rank, world = maybe_initialize_distributed(device="cpu", timeout=SPAWN_TIMEOUT)
    with open(root / "inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    mesh = make_mesh()
    half = slice(rank * 2, rank * 2 + 2)
    res = {"rank": rank, "world": world, "blocks": run_blocks(inputs["blocks"], half,
                                                              mesh.data_group)}
    for name, (scenes, config, accum) in STEPS.items():
        batch = inputs["steps"][name]
        rows = batch_rows(len(scenes), mesh.data_rank, mesh.data, accum)
        res[name] = port_step(take_rows(batch, rows), config, accum, mesh)
    res["attention"] = run_attention(inputs["attention"], make_mesh(data=1, space=world)
                                     .space_group)
    res["cli_scenes"] = run_cli(root, root / "mp_out")
    with open(root / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


# ---- the spawn ----


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _inputs(rng):
    blocks = {"conv3d": {"x": rng.standard_normal((4, 4, 4, 6, 6)),
                         "cot": rng.standard_normal((4, 8, 4, 6, 6))},
              "conv2d": {"x": rng.standard_normal((4, 3, 8, 8)),
                         "cot": rng.standard_normal((4, 6, 8, 8))}}
    attention = {}
    for case, (bq, bk) in {"shared_keys": (4, 2), "same_batch": (2, 2)}.items():
        attention[case] = {"q": rng.standard_normal((bq, 16, 2, 4)),
                           "k": rng.standard_normal((bk, 16, 2, 4)),
                           "v": rng.standard_normal((bk, 16, 2, 4)),
                           "cot": rng.standard_normal((bq, 16, 2, 4))}
    f32 = lambda tree: {k: f32(v) if isinstance(v, dict) else v.astype(np.float32)
                        for k, v in tree.items()}
    return {"blocks": f32(blocks), "attention": f32(attention),
            "steps": {name: global_batch(scenes) for name, (scenes, _, _) in STEPS.items()}}


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    """Writes the inputs and the scenes, starts the two ranks; returns
    (root, inputs, processes, logs)."""
    from damvsnet_tpu_torch.data.synthetic import export_synthetic_scene

    root = tmp_path_factory.mktemp("ranks")
    inputs = _inputs(np.random.default_rng(0))
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    for i, scan in enumerate(SCENES):
        export_synthetic_scene(str(root / "data"), scan, height=CLI_H, width=CLI_W, nviews=3,
                               seed=100 + i)
    (root / "list.txt").write_text("".join(f"{s}\n" for s in SCENES))
    port = _free_port()
    procs, logs = [], []
    for rank in range(RANKS):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(RANKS),
               "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
        log = open(root / f"rank{rank}.log", "w")
        logs.append(root / f"rank{rank}.log")
        procs.append(subprocess.Popen([sys.executable, __file__, str(root)], env=env,
                                      stdout=log, stderr=subprocess.STDOUT, cwd=str(REPO)))
    return root, inputs, procs, logs


@pytest.fixture(scope="module")
def ranks(spawn):
    """Each rank's results, once both ranks have ended."""
    root, _, procs, logs = spawn
    for p in procs:
        p.wait(timeout=SPAWN_TIMEOUT)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.read_text()[-4000:]
    out = []
    for r in range(RANKS):
        with open(root / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# ---- the functions that need no ranks ----


@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [0, 1, 5, 8])
def test_shard_work_items_matches_jax(n, world):
    from damvsnet_tpu.parallel import shard_work_items as jax_shard

    items = [f"scan{i}" for i in range(n)]
    parts = [shard_work_items(items, r, world) for r in range(world)]
    assert parts == [jax_shard(items, r, world) for r in range(world)]
    assert sorted(s for p in parts for s in p) == sorted(items)


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("batch_size,world", [(4, 2), (8, 2), (8, 4), (12, 2)])
def test_batch_rows_union_is_jax_microbatch(batch_size, world, grad_accum):
    """Chunk i of every rank's rows, together, is JAX's microbatch i (a
    reshape to [A, B/A]), and rank r's chunk is its contiguous part of it
    (the batch axis sharded over 'data')."""
    jax_micro = np.arange(batch_size).reshape(grad_accum, -1)
    for r in range(world):
        chunks = np.split(np.asarray(batch_rows(batch_size, r, world, grad_accum)), grad_accum)
        for i, chunk in enumerate(chunks):
            np.testing.assert_array_equal(chunk, np.split(jax_micro[i], world)[r])
    with pytest.raises(ValueError, match="does not split"):
        batch_rows(batch_size + 1, 0, world, grad_accum)


def test_loader_yields_each_rank_its_rows():
    """Per rank: its rows of every global batch, in the global batches'
    shuffled order; the length and the cursor count global batches."""
    ds = SyntheticDataset(height=32, width=32, nviews=3, ndepths=16, length=8)
    whole = DataLoader(ds, batch_size=4, shuffle=True, seed=0, num_workers=0)
    parts = [DataLoader(ds, batch_size=4, shuffle=True, seed=0, num_workers=0, rank=r,
                        world=2, grad_accum=2) for r in range(2)]
    assert len(whole) == len(parts[0]) == 2
    want = [b["filename"] for b in whole.iter_epoch(3)]
    got = [[b["filename"] for b in p.iter_epoch(3)] for p in parts]
    for g, names in enumerate(want):
        rows = [batch_rows(4, r, 2, 2) for r in range(2)]
        assert got[0][g] == [names[i] for i in rows[0]]
        assert got[1][g] == [names[i] for i in rows[1]]
    assert [b["filename"] for b in parts[1].iter_epoch(3, skip=1)] == got[1][1:]


def test_initialize_without_an_environment(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert maybe_initialize_distributed() == (0, 1)
    assert not dist.is_initialized()
    mesh = make_mesh()
    assert (mesh.data, mesh.space, mesh.data_group, mesh.space_group) == (1, 1, None, None)
    with pytest.raises(ValueError, match="mesh 2x1 != 1 ranks"):
        make_mesh(data=2)


def test_mesh_2x2_makes_every_row_then_every_column(monkeypatch):
    """On a 2x2 mesh every rank creates the same groups in the same order,
    the two rows and then the two columns, and keeps its own row as the
    space group and its own column as the data group; the slab
    statistics span every rank (the world of four is only pretended here:
    tests/test_torch_slab.py builds it on four processes)."""
    made = []
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(dist, "new_group", lambda ranks: made.append(tuple(ranks)) or tuple(ranks))
    for rank in range(4):
        monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
        made.clear()
        mesh = make_mesh(data=2, space=2)
        assert made == [(0, 1), (2, 3), (0, 2), (1, 3)]
        d, s = divmod(rank, 2)
        assert (mesh.data_rank, mesh.space_rank) == (d, s)
        assert mesh.space_group == (2 * d, 2 * d + 1) and mesh.data_group == (s, 2 + s)
        assert mesh.slab_stats_group is dist.group.WORLD


def test_failed_rendezvous_raises(monkeypatch):
    """WORLD_SIZE=2 and a master nobody serves: it raises; nothing carries
    on in one process."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    with pytest.raises(dist.DistError):
        maybe_initialize_distributed(device="cpu", timeout=1)
    assert not dist.is_initialized()


def test_cli_mesh_data_must_be_the_world(tmp_path):
    with pytest.raises(ValueError, match="mesh 2x1 != 1 ranks"):
        cli_train.main(["--dataset", "synthetic", "--device", "cpu", "--logdir",
                        str(tmp_path), "--mesh_data", "2"])


# ---- two ranks ----


GRAD_REL_L2, GRAD_OF_MAX = 1e-3, 5e-3


def _block(name):
    """A weight-net tensor's conv + BN block (``DepthNet.weight_net.i.w_net.j``);
    any other tensor is its own group (tests/test_torch_train_step_nonfused.py)."""
    return name.rsplit(".", 2)[0] if name.startswith("DepthNet.") else name


def _close(got, want, name, rtol=1e-5):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(float(np.abs(want).max()),
                                                                     1e-30), err_msg=name)


def test_ranks_met(ranks):
    assert [(r["rank"], r["world"]) for r in ranks] == [(0, 2), (1, 2)]


@pytest.mark.parametrize("name", ["conv3d", "conv2d"])
def test_synced_batch_norm_equals_one_process(spawn, ranks, name):
    _, inputs, _, _ = spawn
    want = run_blocks(inputs["blocks"])[name]
    got = [r["blocks"][name] for r in ranks]
    for key in ("out", "dx"):
        np.testing.assert_allclose(np.concatenate([g[key] for g in got]), want[key],
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    for p, g in want["grads"].items():  # sums over the batch: 1e-5 of the largest too
        _close(sum(r["grads"][p] for r in got), g, p)
    for b, v in want["buffers"].items():
        for r in got:
            np.testing.assert_allclose(r["buffers"][b], v, rtol=1e-5, atol=1e-7, err_msg=b)


@pytest.fixture(scope="module")
def nonfused_jax(spawn):
    from torch_helpers import jax_train_step

    _, inputs, _, _ = spawn
    scenes, config, _ = STEPS["nonfused"]
    return jax_train_step(inputs["steps"]["nonfused"], NDEPTHS, **config)[2]


def _as_model_result(config, grads, state):
    """A model holding a step's gradients and state, as torch_helpers'
    comparisons read it."""
    model = CascadeMVSNet(ndepths=NDEPTHS, device="cpu", **config)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    for n, p in model.named_parameters():
        p.grad = torch.from_numpy(grads[n])
    return {"model": model}


def test_nonfused_step_matches_jax_on_the_global_batch(nonfused_jax, ranks):
    """The two ranks' step is JAX's on the global batch (whose samples have
    different mask counts): losses at rtol 1e-5, gradients and running
    statistics as tests/test_torch_train_step_nonfused.py holds them."""
    from torch_helpers import assert_gradients_match, assert_running_statistics_match

    want = nonfused_jax
    config = STEPS["nonfused"][1]
    for r in ranks:
        metrics, grads, state = r["nonfused"]
        np.testing.assert_allclose([metrics["loss"], metrics["depth_loss"], metrics["cpc_loss"]],
                                   want["losses"], rtol=1e-5, err_msg="total, depth, cpc")
        got = _as_model_result(config, grads, state)
        assert_gradients_match(want, got, group=_block)
        assert_running_statistics_match(want, got)


@pytest.mark.parametrize("name", list(STEPS))
def test_step_equals_one_process(spawn, ranks, name):
    _, inputs, _, _ = spawn
    scenes, config, accum = STEPS[name]
    metrics, grads, state = port_step(inputs["steps"][name], config, accum)
    scale = {}
    for n, v in grads.items():
        scale[_block(n)] = max(scale.get(_block(n), 0.0), float(np.abs(v).max()))
    for r in ranks:
        m, g, s = r[name]
        for k, v in metrics.items():
            np.testing.assert_allclose(m[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
        num = sum(float(((g[n] - v) ** 2).sum()) for n, v in grads.items())
        den = sum(float((v ** 2).sum()) for v in grads.values())
        assert np.sqrt(num / den) <= GRAD_REL_L2
        bad = [n for n, v in grads.items()
               if np.abs(g[n] - v).max() > GRAD_OF_MAX * scale[_block(n)] + 1e-9]
        assert not bad, bad
        for k, v in state.items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(s[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
            elif k.endswith("num_batches_tracked"):
                assert int(s[k]) == int(v), k


@pytest.mark.parametrize("case", ["shared_keys", "same_batch"])
def test_sequence_parallel_attention_equals_local(spawn, ranks, case):
    _, inputs, _, _ = spawn
    want = run_attention(inputs["attention"])[case]
    for r in ranks:
        for key, v in want.items():
            _close(r["attention"][case][key], v, key)


@pytest.mark.parametrize("case", ["shared_keys", "same_batch"])
def test_sequence_parallel_attention_matches_jax(spawn, ranks, case):
    """Against JAX's sequence-parallel attention on the 8-device CPU mesh
    (its key batch repeated per query, where the port shares it)."""
    import jax
    import jax.numpy as jnp
    from damvsnet_tpu.parallel import make_mesh as jax_mesh
    from damvsnet_tpu.parallel import sequence_parallel_linear_attention as jax_sp

    _, inputs, _, _ = spawn
    a = {k: jnp.asarray(v) for k, v in inputs["attention"][case].items()}
    mesh = jax_mesh(data=1, space=len(jax.devices()))
    rep = a["q"].shape[0] // a["k"].shape[0]

    def f(q, k, v):
        return jax_sp(q, jnp.repeat(k, rep, axis=0), jnp.repeat(v, rep, axis=0), mesh)

    with mesh:
        out = f(a["q"], a["k"], a["v"])
        dq, dk, dv = jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) * a["cot"]),
                              argnums=(0, 1, 2))(a["q"], a["k"], a["v"])
    got = ranks[0]["attention"][case]
    for key, v in (("out", out), ("dq", dq), ("dk", dk), ("dv", dv)):
        _close(got[key], np.asarray(v), key)


def _tree_files(folder):
    return sorted(os.path.relpath(os.path.join(d, f), folder)
                  for d, _, files in os.walk(folder) for f in files)


def test_scan_parallel_cli_equals_one_process(spawn, ranks):
    """Ownership disjoint and complete; every file of the shared outdir
    (depth, confidence, cams, images, the fused PLYs) bitwise equal to one
    process's run over the same scenes."""
    root = spawn[0]
    owned = [r["cli_scenes"] for r in ranks]
    assert owned == [SCENES[0::2], SCENES[1::2]]
    run_cli(root, root / "sp_out")
    files = _tree_files(root / "sp_out")
    assert files == _tree_files(root / "mp_out")
    assert sum(f.endswith(".pfm") for f in files) == len(SCENES) * 3 * 6
    for f in files:
        assert (root / "mp_out" / f).read_bytes() == (root / "sp_out" / f).read_bytes(), f


if __name__ == "__main__":
    torch.set_num_threads(1)
    worker(sys.argv[1])
