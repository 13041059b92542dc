"""What decides ``correct``: the numbers that hold the program's answers
against the plain reference's, each judged against its limit
(``limits/<workload>.json``).

Serving, for each kept answer against the reference's on the same scene,
the worst over the kept answers:
  depth1, depth2, depth3   mean |depth - reference depth| over the
                           stage's pixels, as a share of the scene's sweep
  conf3                    mean |confidence - reference confidence|

Training, the first steps against the reference's from the same weights
on the same batches:
  loss     the first step's |loss - reference loss| / |reference loss|
  depth    the first step's final depth of its first sample (the step's
           own image summary): mean gap as a share of the sweep
  grad     the median leaf's gap between the first gradient's norms, the
           program's (from Adam's first moment) and the reference's
  change   the worst leaf's gap between the norms of the parameters'
           change over the first steps
  stats    the median leaf's gap between the norms of the BatchNorm
           running statistics' change over the first steps
  replicas (across cards) the largest difference of an element of
           the parameters and running statistics between rank 0 and any
           other rank after the first steps: DDP's averaged gradient,
           the synced statistics and Adam are the same on every rank
Each gap of norms is measured against the larger of the reference leaf's
norm and the median leaf's. Leaves whose reference gradient is under a
thousandth of the median leaf's are left out of ``change``: Adam moves
them by rounding alone. ``train_readings`` also gives the readings that
are not compared: every step's loss, and the worst leaf of the gradient
and of the running statistics, which bf16 rounding swings from seed to
seed (PERF.md).
"""
from __future__ import annotations

import numpy as np

ROUNDING_LEAF = 1e-3


def serve_numbers(kept, reference_answers, pool):
    """kept: [(index, scene, answer)]; reference_answers {scene: {stageK:
    {depth, photometric_confidence}}} (numpy); pool: the traffic's
    batches."""
    worst = dict.fromkeys(("depth1", "depth2", "depth3", "conf3"), 0.0)
    for _, scene, out in kept:
        ref = reference_answers[scene]
        dv = pool[scene]["depth_values"]
        sweep = (dv[:, -1] - dv[:, 0]).reshape(-1, 1, 1)
        for s in (1, 2, 3):
            got = out["depth"] if s == 3 else out[f"stage{s}"]["depth"]
            gap = float(np.mean(np.abs(got - ref[f"stage{s}"]["depth"]) / sweep))
            worst[f"depth{s}"] = max(worst[f"depth{s}"], gap)
        conf = float(np.mean(np.abs(out["photometric_confidence"]
                                    - ref["stage3"]["photometric_confidence"])))
        worst["conf3"] = max(worst["conf3"], conf)
    return worst


def leaf_gaps(first, reference):
    """{number: [(gap, leaf)] worst first} of the three norm comparisons."""
    rg, rc, pc = reference["grad_norms"], reference["change_norms"], first["change_norms"]
    med = float(np.median(list(rg.values())))
    moved = [k for k in rg if rg[k] >= ROUNDING_LEAF * med]
    stats = [k for k in rc if k not in rg]

    def gaps(got, ref, keys, scale):
        return sorted(((abs(got[k] - ref[k]) / max(ref[k], scale), k) for k in keys),
                      reverse=True)

    return {"grad": gaps(first["grad_norms"], rg, list(rg), med),
            "change": gaps(pc, rc, moved, float(np.median([rc[k] for k in moved]))),
            "stats": gaps(pc, rc, stats, float(np.median([rc[k] for k in stats])))}


def train_readings(first, reference, batch):
    """Every training reading: the compared numbers and those kept for the
    record. first: the program's ``Train.first``; reference: the same
    keys from ``reference_train``; batch: the first step's."""
    loss = [abs(a - b) / abs(b) for a, b in zip(first["losses"], reference["losses"])]
    dv = batch["depth_values"][0]
    gaps = leaf_gaps(first, reference)
    out = {"loss": float(loss[0]), "loss_steps": float(max(loss)),
           "depth": float(np.mean(np.abs(first["depth"] - reference["depth"]))
                          / (dv[-1] - dv[0]))}
    for k, v in gaps.items():
        out[f"{k}_worst"] = float(v[0][0]) if v else 0.0
        out[f"{k}_median"] = float(np.median([g for g, _ in v])) if v else 0.0
    return out


def train_numbers(first, reference, batch):
    """The compared training numbers (see the module's docstring)."""
    r = train_readings(first, reference, batch)
    out = {"loss": r["loss"], "depth": r["depth"], "grad": r["grad_median"],
           "change": r["change_worst"], "stats": r["stats_median"]}
    if "replicas" in first:
        out["replicas"] = first["replicas"]
    return out


def judge(numbers, limits):
    """(correct, {name: {"value", "limit"}}): correct where every number is
    finite and at most its limit. Every number needs an entry in the
    limits; a limit of null leaves its number out (a number with no upper
    reading in that cell, PERF.md section 6)."""
    checked = {k: {"value": float(v), "limit": float(limits[k])} for k, v in numbers.items()
               if limits[k] is not None}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checked.values())
    return ok, checked


def reference_serve(cfg, pool, scenes, device, precision="fp32"):
    """{scene: the reference's answer (numpy)} for each scene index, from
    the reference module the configuration names."""
    from . import reference
    ref = reference.for_config(cfg)
    rcfg = ref.settings(cfg, "serve")["model"]
    params, buffers = ref.load_weights(cfg["weights"], rcfg, device)
    return {s: {k: {n: t.cpu().numpy() for n, t in v.items()}
                for k, v in ref.serve(params, buffers, rcfg, pool[s], precision).items()}
            for s in sorted(set(scenes))}


def reference_train(cfg, batches, iters_per_epoch, device, precision="fp32"):
    """The first steps of the reference module the configuration names on
    ``batches``, reduced to the norms ``train_numbers`` compares."""
    from . import reference
    ref = reference.for_config(cfg)
    rcfg = ref.settings(cfg, "train")
    params, buffers = ref.load_weights(cfg["weights"], rcfg["model"], device)
    out = ref.train_steps(params, buffers, rcfg, batches, iters_per_epoch, precision)
    change = {k: (v - params[k]).norm().item() for k, v in out["params"].items()}
    change.update({k: (v - buffers[k]).norm().item() for k, v in out["buffers"].items()})
    return {"losses": out["losses"], "change_norms": change,
            "grad_norms": {k: g.norm().item() for k, g in out["grads"].items()},
            "depth": out["depth"].cpu().numpy()}
