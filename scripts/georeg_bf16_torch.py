"""Where GeoReg serving's bf16 gap between the kernels and their plain
versions comes from, stage by stage, on one CUDA card.

    python3 scripts/georeg_bf16_torch.py

chip_smoke.py phase 16's model (``reg_mode="georeg"``, ``refine``,
``arch_mode="unet"``; the trained geo fusion and weight nets, the
FeatureNet, GeoRegNet2d and RefineNet seeded) on phase 5's scene
(1152x864, N=5, ndepths 64/32/8, seed 3), in bf16 and, with TF32 off, in
fp32. Four routes: all plain, all kernels, K1 alone (K2's plain version)
and K2 alone (K1's plain version). Each route against the plain route,
per stage: p999 and max |difference| of the depth, of the probability
volume the stage hands to the next, and of the upsampled volume the next
stage's GeoRegNet2d receives. Then the plain route's own moves in bf16
under one-ulp fp32 changes of the camera matrices and of the handed-over
probability volumes, and the kernels' move under planted faults (stage
1's or both handed-over volumes shifted by one hypothesis or unnormalised,
a source view left out of K1, stage 2's depth regressed from its volume
rolled by one hypothesis or against its hypotheses read one off
(chip_smoke.py's ``depth_off_by_one``), a one-sigma band handed to the next
stage; four of them also in fp32); and, on the plain
route in fp32, how far each stage's regularized cost spreads over its
hypotheses (max - min over D, per pixel) and its largest probability.
Prints one JSON line per route, one for the floors and one for the spread.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROUTES = {"kernels": (True, True), "k1_alone": (True, False), "k2_alone": (False, True)}


@contextlib.contextmanager
def kernel_route(k1: bool, k2: bool):
    """Serving with ``model.plain`` off on K1 and K2 as named; the other
    runs its plain version."""
    from damvsnet_tpu_torch.model import cascade
    from damvsnet_tpu_torch.ops.kernels.fused_costvol import fused_adaptive_cost_volume_plain
    from damvsnet_tpu_torch.ops.regression import prob_volume_stats
    saved = cascade.fused_adaptive_cost_volume, cascade.prob_volume_stats_fused
    if not k1:
        cascade.fused_adaptive_cost_volume = fused_adaptive_cost_volume_plain
    if not k2:
        cascade.prob_volume_stats_fused = prob_volume_stats
    try:
        yield
    finally:
        cascade.fused_adaptive_cost_volume, cascade.prob_volume_stats_fused = saved


def shifted_handoff(out, samples, stage_idx):
    """A planted fault: stage 1's probability volume handed over shifted by
    one hypothesis (rolled along D)."""
    import torch
    if stage_idx:
        return out
    return dict(out, prob_volume=torch.roll(out["prob_volume"], 1, dims=1))


def unnormalised_handoff(out, samples, stage_idx):
    """A planted fault: stage 1's probability volume handed over without its
    softmax's normalisation, exp(cost - max cost) = p / max p."""
    if stage_idx:
        return out
    prob = out["prob_volume"]
    return dict(out, prob_volume=prob / prob.amax(1, keepdim=True))


def unnormalised_handoffs(out, samples, stage_idx):
    """A planted fault: both handed-over probability volumes (stages 1 and
    2) without their softmax's normalisation."""
    if stage_idx == 2:  # stage 3 hands over nothing
        return out
    prob = out["prob_volume"]
    return dict(out, prob_volume=prob / prob.amax(1, keepdim=True))


def rolled_volume_depth(out, samples, stage_idx):
    """A planted fault: stage 2's depth regressed from its probability volume
    rolled by one hypothesis against the hypotheses (a near-uniform volume
    rolled regresses to nearly the same depth)."""
    import torch
    if stage_idx != 1:
        return out
    prob = torch.roll(out["prob_volume"], 1, dims=1)
    return dict(out, depth=(prob * samples).sum(1))


def one_ulp_handoff(out, samples, stage_idx):
    """Every entry of a handed-over probability volume (stages 1 and 2) moved
    by one fp32 ulp, up or down (seeded); the stage's own depth, confidence
    and sigma are left as they were."""
    import torch
    if stage_idx == 2:  # stage 3 hands over nothing
        return out
    prob = out["prob_volume"]
    g = torch.Generator(device=prob.device).manual_seed(stage_idx)
    sign = torch.randint(0, 2, prob.shape, generator=g, device=prob.device).float() * 2 - 1
    return dict(out, prob_volume=prob * (1.0 + 2.0 ** -23 * sign))


def one_sigma_band(out, samples, stage_idx):
    """A planted fault: the stats of stages 1 and 2 hand the next stage's
    hypotheses a band one sigma wide, not three."""
    if stage_idx == 2:
        return out
    return dict(out, variance=out["variance"] / 3.0)


def dropped_view(fn, args, stage_idx):
    """A planted fault: the last source view left out of the volume."""
    ref, srcs, ref_proj, src_projs, *rest = args
    return fn(ref, srcs[:-1], ref_proj, src_projs[:-1], *rest)


def main():
    import numpy as np
    import torch

    import chip_smoke as c
    from damvsnet_tpu_torch.data.synthetic import make_synthetic_sample
    from damvsnet_tpu_torch.ops.kernels import build

    build.build()
    dev = torch.device("cuda")
    smi = c.nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sample = make_synthetic_sample(height=c.HEIGHT, width=c.WIDTH, nviews=c.NVIEWS,
                                   ndepths=c.D0, with_gt=True, seed=c.SEED)
    model = c.seeded_model(dev, ("feature", "cost_regularization", "refine_network"),
                           reg_mode="georeg", refine=True, arch_mode="unet")
    batch = c.serving_batch(sample)
    args = [torch.as_tensor(batch["imgs"], device=dev),
            {k: torch.as_tensor(v, device=dev) for k, v in batch["proj_matrices"].items()},
            torch.as_tensor(batch["depth_values"], device=dev)]
    rng = float(sample["depth_values"][-1] - sample["depth_values"][0])
    received = {}  # stage index -> the upsampled volume GeoRegNet2d receives
    costs = {}  # stage index -> the regularized cost [B, D, H, W]
    for i in (1, 2):
        model.cost_regularization[i].register_forward_pre_hook(
            lambda mod, a, i=i: received.__setitem__(i, a[2].float().cpu().numpy()))
    for i in range(3):
        model.cost_regularization[i].register_forward_hook(
            lambda mod, a, o, i=i: costs.__setitem__(i, o.float()))

    def run(plain, dtype, projs=None, change=None, dvals=None, views=None, volume=None):
        model.plain, model.compute_dtype = plain, dtype
        imgs, pm = args[0], projs or args[1]
        if views is not None:  # the same request with its views in another order
            imgs, pm = imgs[:, views], {k: v[:, views] for k, v in pm.items()}
        with torch.inference_mode(), (c.stats_changed(change) if change
                                      else contextlib.nullcontext()), (
                c.volume_changed(volume) if volume else contextlib.nullcontext()):
            out = model(imgs, pm, args[2] if dvals is None else dvals)
        res = {}
        for s in range(3):
            o = out[f"stage{s + 1}"]
            res[s] = {"depth": o["depth"].float().cpu().numpy(),
                      "prob_volume": o["prob_volume"].float().cpu().numpy()}
            if s:
                res[s]["received"] = received[s]
        res["refined_depth"] = out["refined_depth"].float().cpu().numpy()
        return res

    def diff(a, b):
        row = {}
        for s in range(3):
            row[f"stage{s + 1}"] = {}
            for key in a[s]:
                if key == "prob_volume" and s == 2:
                    continue  # stage 3's volume is handed to no stage
                d = np.abs(a[s][key] - b[s][key])
                row[f"stage{s + 1}"][key] = {"p999_abs": float(np.quantile(d, 0.999)),
                                              "max_abs": float(d.max())}
        d = np.abs(a["refined_depth"] - b["refined_depth"])
        row["refined_depth"] = {"p999_abs": float(np.quantile(d, 0.999)),
                                "max_abs": float(d.max())}
        return row

    for tag, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        plain = run(True, dtype)
        for route, (k1, k2) in ROUTES.items():
            with kernel_route(k1, k2):
                got = run(False, dtype)
            print("GeoReg route", json.dumps({"dtype": tag, "route": route, "vs": "plain",
                                              "depth_range": rng, "card": smi,
                                              **diff(got, plain)}), flush=True)
        if tag == "bf16":
            plain_bf16 = plain
    plain_fp32 = run(True, torch.float32)
    spread = {}
    for i, cost in costs.items():
        d_range = (cost.amax(1) - cost.amin(1)).flatten().cpu().numpy()
        spread[f"stage{i + 1}"] = {
            "cost_d_range_quantiles_50_99_max": [float(np.quantile(d_range, q))
                                                 for q in (0.5, 0.99, 1.0)],
            "cost_abs_mean": float(cost.abs().mean()),
            "prob_max": float(plain_fp32[i]["prob_volume"].max()),
            "depth_std": float(plain_fp32[i]["depth"].std())}
    print("GeoReg cost spread (fp32, plain route)", json.dumps(
        {"card": smi, "scene_depth_std": float(sample["depth"]["stage3"].std()), **spread}),
        flush=True)
    def cams(ulps):
        rs = np.random.default_rng(0)
        return {k: v * torch.as_tensor(1.0 + ulps * 2.0 ** -23
                                       * rs.choice([-1.0, 1.0], v.shape[1:]),
                                       dtype=torch.float32, device=dev)
                for k, v in args[1].items()}
    reversed_sources = [0] + list(range(c.NVIEWS - 1, 0, -1))
    floors = {"plain_again": diff(run(True, torch.bfloat16), plain_bf16),
              "cameras_1ulp": diff(run(True, torch.bfloat16, projs=cams(1)), plain_bf16),
              "cameras_4ulp": diff(run(True, torch.bfloat16, projs=cams(4)), plain_bf16),
              "cameras_16ulp": diff(run(True, torch.bfloat16, projs=cams(16)), plain_bf16),
              "depth_values_1ulp": diff(run(True, torch.bfloat16,
                                            dvals=args[2] * (1.0 + 2.0 ** -23)), plain_bf16),
              "sources_reversed": diff(run(True, torch.bfloat16, views=reversed_sources),
                                       plain_bf16),
              "volume_1ulp": diff(run(True, torch.bfloat16, volume=c.one_ulp_volume),
                                  plain_bf16),
              "fault_dropped_view_kernels": diff(run(False, torch.bfloat16,
                                                     volume=dropped_view), plain_bf16),
              "handoff_1ulp": diff(run(True, torch.bfloat16, change=one_ulp_handoff),
                                   plain_bf16),
              "fault_shifted_handoff_kernels": diff(
                  run(False, torch.bfloat16, change=shifted_handoff), plain_bf16),
              "fault_unnormalised_handoff_kernels": diff(
                  run(False, torch.bfloat16, change=unnormalised_handoff), plain_bf16),
              "fault_unnormalised_handoffs_kernels": diff(
                  run(False, torch.bfloat16, change=unnormalised_handoffs), plain_bf16),
              "fault_depth_rolled_volume_kernels": diff(
                  run(False, torch.bfloat16, change=rolled_volume_depth), plain_bf16),
              "fault_depth_off_by_one_kernels": diff(
                  run(False, torch.bfloat16, change=c.depth_off_by_one), plain_bf16),
              "fault_one_sigma_band_kernels": diff(
                  run(False, torch.bfloat16, change=one_sigma_band), plain_bf16),
              "fp32_fault_unnormalised_handoff_kernels": diff(
                  run(False, torch.float32, change=unnormalised_handoff), plain_fp32),
              "fp32_fault_dropped_view_kernels": diff(
                  run(False, torch.float32, volume=dropped_view), plain_fp32),
              "fp32_fault_depth_rolled_volume_kernels": diff(
                  run(False, torch.float32, change=rolled_volume_depth), plain_fp32),
              "fp32_fault_depth_off_by_one_kernels": diff(
                  run(False, torch.float32, change=c.depth_off_by_one), plain_fp32)}
    print("GeoReg floors (bf16, plain route moved; the fault on the kernels)",
          json.dumps({"depth_range": rng, "card": smi, **floors}), flush=True)


if __name__ == "__main__":
    main()
