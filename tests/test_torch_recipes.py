"""The port's recipe scripts, scripts/*_torch.sh, against their JAX twins:
each script runs under bash with a stub ``python`` first on PATH that
prints its arguments (chip_smoke.py's ``recipe_argv``, the route phase 24
takes), so no dataset is needed. The argv parses in the port's CLI and
gives the namespace the twin's argv gives in the JAX CLI on their shared
flags; the checkpoints are the port's ``.pt`` files."""
import os

import pytest

from damvsnet_tpu.cli import test as jax_cli_test
from damvsnet_tpu.cli import train as jax_cli_train
from damvsnet_tpu_torch.cli import test as cli_test
from damvsnet_tpu_torch.cli import train as cli_train

import chip_smoke

RECIPES = {"train_dtu": "train", "test_dtu": "test", "test_tnt": "test",
           "blendedmvs_finetune": "train"}
PARSERS = {"train": (cli_train.build_parser, jax_cli_train.build_parser),
           "test": (cli_test.build_parser, jax_cli_test.build_parser)}
# each script's output directory: where it writes its log
OUTPUT_VARS = ("LOG_DIR", "OUTDIR")


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_recipe_argv_parses_as_its_jax_twin(recipe, tmp_path):
    env = {k: str(tmp_path / k.lower()) for k in OUTPUT_VARS}
    module, argv = chip_smoke.recipe_argv(f"scripts/{recipe}_torch.sh", env)
    jax_module, jax_argv = chip_smoke.recipe_argv(f"scripts/{recipe}.sh", env)
    cli = RECIPES[recipe]
    assert (module, jax_module) == (f"damvsnet_tpu_torch.cli.{cli}", f"damvsnet_tpu.cli.{cli}")
    ours, theirs = (vars(build().parse_args(a))
                    for build, a in zip(PARSERS[cli], (argv, jax_argv)))
    shared = set(ours) & set(theirs)
    assert len(shared) > 20
    for k in sorted(shared - {"loadckpt"}):
        assert ours[k] == theirs[k], k
    if theirs["loadckpt"] is None:  # DTU training starts from no checkpoint
        assert ours["loadckpt"] is None
    else:  # the twin's checkpoint as the port's training CLI names it
        assert ours["loadckpt"] == theirs["loadckpt"] + ".pt"
        assert os.path.basename(ours["loadckpt"]) == "ckpt_000015.pt"
    assert os.path.isdir(env["LOG_DIR" if cli == "train" else "OUTDIR"])


def test_recipe_environment_overrides_reach_the_argv(tmp_path):
    """The scripts' variables name the data and the checkpoint: phase 24
    points them at its synthetic scene and the serving weights."""
    env = {"TNT_TESTPATH": str(tmp_path / "tnt"), "TNT_LIST": str(tmp_path / "list.txt"),
           "CKPT": "weights/bench_ckpt.npz", "OUTDIR": str(tmp_path / "out")}
    _, argv = chip_smoke.recipe_argv("scripts/test_tnt_torch.sh", env)
    args = cli_test.build_parser().parse_args(argv)
    assert (args.testpath, args.testlist, args.loadckpt, args.outdir) == (
        env["TNT_TESTPATH"], env["TNT_LIST"], env["CKPT"], env["OUTDIR"])
    assert (args.dataset, args.num_view, args.max_h, args.max_w, args.interval_scale) == (
        "tnt_eval_trans", 11, 1080, 2048, 1.0)
