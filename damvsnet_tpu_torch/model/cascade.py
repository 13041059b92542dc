"""CascadeMVSNet forward, serving and training (counterpart of
damvsnet_tpu/model/cascade.py: its serving configuration, its variance
aggregation, its training configurations, the default one and
``fused_train``, and its variants: ``use_fmt``, ``grad_method``,
``reg_mode="georeg"``, ``refine``, ``arch_mode="unet"``).

  views:     FeatureNet (fpn, or unet); at inference all N views as one
             batch, in training one call per view (batch-statistics BN
             must not see the views folded into the batch;
             cascade.py:309-311); then, with ``use_fmt``, the FMT pathway
             over all views (no BN: the views run as one batch)
  per stage: GeoFeatureFusion replaces the ref feature at stages 2/3
             (``use_geo_fusion``), conditioned on the previous stage's
             depth (not detached: in training stages 2 and 3 send gradient
             back into stage 1)
             -> ADIA depth sampling at full resolution from the previous
                depth and sigma, detached unless ``grad_method="undetach"``
                (the samples then carry gradient into the previous stage
                through this stage's statistics and ADIA's softmax, never
                through the warp), optionally clamped into the input
                sweep range (``clamp_samples``) -> trilinear snap to stage
                resolution (stage 1: the uniform sweep is built at stage
                resolution directly, and never materialized)
             -> cost volume, by route:
                  serving, adaptive: the fused CUDA kernel K1 with the
                    folded weight net;
                  serving, variance: K4's variance entry, one launch for
                    all views;
                  training, adaptive, ``fused_train``: K1 as a
                    torch.autograd.Function whose backward is kernel K3,
                    with the folded weight net (its BNs on their running
                    statistics);
                  training, adaptive, default: ``build_cost_volume`` over
                    the plain warp under autograd (the JAX package's XLA
                    gather, cascade.py:208-211), the stage's weight net as
                    a module with batch-statistics BN (cascade.py:192-194);
                  training, variance: ``variance_cost_volume`` over the
                    plain warp under autograd (K4 is inference-only, as on
                    the TPU)
             -> CostRegNet 3-D U-Net (base widths ``cr_base_chs``), or
                with ``reg_mode="georeg"`` GeoRegNet2d fed the previous
                stage's probability volume upsampled x2 (not detached, as
                in JAX), encodings std / z / z
             -> fp32 stats tail: softmax, soft-argmin depth, confidence,
                3-sigma band (CUDA kernel K2 at inference, reading the
                regularized cost in the compute dtype; in training the
                plain version under autograd, as the JAX package trains
                through its XLA stats: K2 has no backward)
  handoff:   depth and sigma bilinearly upsampled to input resolution.
  refine:    RefineNet on the reference image and the final depth ->
             ``refined_depth``.

Dtypes follow the JAX package's promotion: the FMT pathway and the U-Net
FeatureNet's stage-2/3 heads return fp32 under a bf16 compute dtype, so
the views' features reach the cost volume in fp32; a reference feature of
another dtype (geo fusion's, in the compute dtype) is upcast to theirs, an
exact step. The volume enters the regularizer in the compute dtype, as the
first JAX convolution casts it.

``share_cr`` raises: one CostRegNet cannot take the three stages' cost
volumes, 32, 16 and 8 channels wide, and the JAX package's shared
regularizer fails at init (flax's ScopeParamShapeError at stage 2).

``slab_group`` (JAX's ``slab_axis``, ``parallel/slab.py``): each rank of
the group holds one slab of every stage's depth hypotheses. Once a stage's
hypotheses are final (after ADIA, the clamp and the trilinear snap) the
rank keeps its D/S of them; the cost volume is built on them by the
stage's route (K1, K4's variance entry or the plain warp; the non-fused
weight nets' batch statistics over ``slab_stats_group``), from the views'
features marked so that their gradient sums the ranks' shares; CostRegNet
runs on the slab, and its one-channel cost is gathered over D, so the
stats tail (K2 in serving) and the stage handoff run whole, and equal, on
every rank. With ``reg_mode="georeg"`` the volume is gathered and
GeoRegNet2d runs whole, the function GSPMD runs under JAX's constraint.

``model.train()`` selects training: BatchNorm uses batch statistics
(nn/blocks.py); with ``fused_train`` the folded weight net keeps its
running statistics (nn/aggweight.py). Inputs keep the JAX layout: images
[B, N, H, W, 3], proj_matrices {stage: [B, N, 2, 4, 4]} (extrinsics in
slot 0, stage K in slot 1), depth_values [B, D0]. The per-stage output
dicts carry the JAX keys (depth, photometric_confidence, variance,
prob_volume, depth_values); the top level repeats stage 3. There is no
``sampler_overflow``: the kernels gather every tap.
"""
from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..nn.aggweight import AggWeightNetVolume, fold_aggweight
from ..nn.blocks import batch_stats_group
from ..nn.costreg import CostRegNet
from ..nn.feature import FeatureNet
from ..nn.fmt import FMTWithPathway
from ..nn.geofusion import GeoFeatureFusion
from ..nn.georeg import GeoRegNet2d
from ..nn.refine import RefineNet
from ..ops.costvol import build_cost_volume, variance_cost_volume
from ..ops.kernels._common import SUPPORTED_CHANNELS
from ..ops.kernels.fused_costvol import (fused_adaptive_cost_volume,
                                         fused_adaptive_cost_volume_plain)
from ..ops.kernels.probstats import prob_volume_stats_fused
from ..ops.kernels.sweep_sampler import plane_sweep_variance
from ..ops.regression import prob_volume_stats
from ..ops.resize import resize_bilinear, resize_trilinear_depth
from ..ops.sampling import uncertainty_aware_samples
from ..ops.warp import matmul_fp32, plane_sweep_warp
from ..parallel import slab
from ..parallel.collectives import gather_tokens, sum_backward
from ..train.profiler import span
from ..utils.device import resolve_device

STAGE_CHANNELS = (32, 16, 8)  # FPN output channels, stages 1..3


def fuse_projection_matrices(proj: torch.Tensor) -> torch.Tensor:
    """[..., 2, 4, 4] (extrinsics, K-padded) -> fused [..., 4, 4] with
    rows 0..2 = K @ E[:3, :4], in true fp32."""
    ext = proj[..., 0, :, :].float()
    top = matmul_fp32(proj[..., 1, :3, :3], ext[..., :3, :4])
    return torch.cat([top, ext[..., 3:4, :]], dim=-2)


class DepthNet(nn.Module):
    """Holds the per-stage AggWeightNets under the reference's names
    (``DepthNet.weight_net.{i}``)."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        self.weight_net = nn.ModuleList(AggWeightNetVolume(c) for c in channels)


class CascadeMVSNet(nn.Module):
    """The 3-stage cascade; ``.eval()`` (the default) serves, ``.train()``
    trains.

    ndepths: hypotheses per stage. compute_dtype: the convolutions' dtype
    (bf16 to serve and train, fp32 for parity); the stats tail is always
    fp32. agg_mode: "adaptive" (the weight net, K1) or "variance" (K4,
    inference only). use_geo_fusion: GeoFeatureFusion at stages 2/3.
    cr_base_chs: each stage's U-Net base width. clamp_samples: clip the
    stage-2/3 hypotheses into the input sweep range. align_corners: the
    sampler's grid un-normalization on every cost-volume route (K1, K3,
    K4's variance entry and the plain warp), as JAX's ``sampler_opts=
    {"align_corners": True}``; nothing else reads it. fused_train: train
    the adaptive cost volume through K1/K3 with the folded weight net,
    read only in ``.train()``; off (the JAX
    package's default), training takes the plain warp and the weight net's
    batch statistics. use_fmt: the FMT pathway on the views' features.
    grad_method: "detach" (the default) or "undetach" (the stage handoff
    keeps its gradient). reg_mode: "costreg" (the 3-D U-Net) or "georeg"
    (GeoRegNet2d; ndepths must halve, then quarter: 64/32/8). refine: the
    RefineNet head. arch_mode: FeatureNet's "fpn" or "unet". share_cr
    raises (see the module's docstring). base_channels: FeatureNet's base
    width; 8, the only one the kernels' channel widths take, and anything
    else raises. depth_intervals_ratio: stored as the JAX package stores it
    (from ``--depth_inter_r``); neither forward reads it. fmt_sp_group: a process group
    over which the FMT's attention runs sequence-parallel where its size
    (more than 1) divides the tokens (JAX's ``fmt_sp_axis``); every rank of
    it runs the same request. slab_group: a process group over whose ranks
    the depth hypotheses are cut into slabs (JAX's ``slab_axis``; every
    stage's D must divide into its size, or it raises), each rank of it on
    the same samples; slab_stats_group: the group a slab region's
    training BatchNorms reduce over (``Mesh.slab_stats_group``, every rank
    of the mesh; it may be left out only where the slab group is every
    rank, and raises otherwise).
    plain: run the kernels' plain
    PyTorch versions instead of the CUDA kernels (under autograd in training) — a reference
    for checking the kernels on the card; nothing selects it on its own.
    device: where the parameters live, CUDA unless the caller names
    another; raises if CUDA is absent. The defaults are the shipped
    configuration.

    Under a profiler the forward opens ``cascade.features``, with
    ``use_fmt`` ``cascade.fmt`` (and inside it ``cascade.fmt.ref``,
    ``.src`` and ``.pathway``, nn/fmt.py), and, at each stage k,
    ``cascade.stage{k}.geo_fusion`` (stages 2-3 with geo fusion),
    ``.samples``, ``.cost_volume``, ``.cost_reg`` and ``.stats``.
    """

    def __init__(self, ndepths: Sequence[int] = (64, 32, 8),
                 compute_dtype: torch.dtype = torch.float32,
                 plain: bool = False, device=None, agg_mode: str = "adaptive",
                 use_geo_fusion: bool = True,
                 cr_base_chs: Sequence[int] = (8, 8, 8),
                 clamp_samples: bool = True, align_corners: bool = False,
                 fused_train: bool = False, use_fmt: bool = False,
                 share_cr: bool = False, grad_method: str = "detach",
                 reg_mode: str = "costreg", refine: bool = False,
                 arch_mode: str = "fpn", fmt_sp_group=None, slab_group=None,
                 slab_stats_group=None, base_channels: int = 8,
                 depth_intervals_ratio: Sequence[float] = (4, 2, 1)):
        super().__init__()
        if base_channels != 8:
            raise ValueError(
                f"base_channels={base_channels}: the stages' features are 4x, 2x and 1x "
                "base_channels wide and the CUDA kernels take C in "
                f"{SUPPORTED_CHANNELS}, so only 8 builds; the JAX package's model fails "
                "with any other under geo fusion too (a broadcast shape error)")
        if len(ndepths) != 3 or len(cr_base_chs) != 3:
            raise ValueError(f"the cascade has 3 stages, got ndepths={ndepths}, "
                             f"cr_base_chs={cr_base_chs}")
        if agg_mode not in ("adaptive", "variance"):
            raise ValueError(f"agg_mode {agg_mode!r} is neither 'adaptive' nor 'variance'")
        if share_cr:
            raise ValueError(
                "share_cr: one CostRegNet cannot take the cost volumes of all three "
                f"stages, {STAGE_CHANNELS} channels wide; the JAX package's shared "
                "regularizer fails at init the same way (flax ScopeParamShapeError)")
        if grad_method not in ("detach", "undetach"):
            raise ValueError(f"grad_method {grad_method!r} is neither 'detach' nor 'undetach'")
        if reg_mode not in ("costreg", "georeg"):
            raise ValueError(f"reg_mode {reg_mode!r} is neither 'costreg' nor 'georeg'")
        if reg_mode == "georeg" and (ndepths[0] != 2 * ndepths[1] or ndepths[1] != 4 * ndepths[2]):
            raise ValueError("georeg max-pools the previous probability volume along D "
                             "once at stage 2 and twice at stage 3: ndepths must be "
                             f"(4k, 2k, k/2), got {tuple(ndepths)}")
        if slab_group is not None and dist.get_world_size(slab_group) == 1:
            slab_group = slab_stats_group = None
        if slab_group is not None:
            size = dist.get_world_size(slab_group)
            bad = [d for d in ndepths if not slab.slabbed(d, size)]
            if bad:
                raise ValueError(f"slab_group of {size} ranks: ndepths {tuple(ndepths)} has "
                                 f"D={bad} that does not cut into {size} slabs of equal depth")
        self.depth_intervals_ratio = tuple(depth_intervals_ratio)  # stored, never read
        self.slab_group = slab_group
        self.slab_stats_group = slab.stats_group(slab_group, slab_stats_group)
        self.ndepths = tuple(ndepths)
        self.compute_dtype = compute_dtype
        self.plain = plain
        self.agg_mode = agg_mode
        self.use_geo_fusion = use_geo_fusion
        self.clamp_samples = clamp_samples
        self.align_corners = align_corners
        self.fused_train = fused_train
        self.use_fmt = use_fmt
        self.grad_method = grad_method
        self.reg_mode = reg_mode
        self.refine = refine
        self.arch_mode = arch_mode
        self.feature = FeatureNet(base_channels=8, arch_mode=arch_mode)
        if use_fmt:
            self.FMT_with_pathway = FMTWithPathway(base_channels=8, sp_group=fmt_sp_group)
        if use_geo_fusion:
            self.GeoFeatureFusionNet = GeoFeatureFusion()
        if reg_mode == "georeg":
            self.cost_regularization = nn.ModuleList(
                GeoRegNet2d(c, enc) for c, enc in zip(STAGE_CHANNELS, ("std", "z", "z")))
        else:
            self.cost_regularization = nn.ModuleList(
                CostRegNet(c, base_channels=base, slab_group=self.slab_group,
                           slab_stats_group=self.slab_stats_group)
                for c, base in zip(STAGE_CHANNELS, cr_base_chs))
        if agg_mode == "adaptive":
            self.DepthNet = DepthNet(STAGE_CHANNELS)
        if refine:
            self.refine_network = RefineNet()
        self.to(resolve_device(device))
        self.eval()

    def forward(self, imgs: torch.Tensor, proj_matrices: dict,
                depth_values: torch.Tensor) -> dict:
        stats = (prob_volume_stats if self.plain or self.training
                 else prob_volume_stats_fused)
        b, n, height, width, _ = imgs.shape
        depth_values = depth_values.float()
        dmin = depth_values.min(dim=1).values[:, None, None, None]
        dmax = depth_values.max(dim=1).values[:, None, None, None]
        with span("cascade.features"):
            feats = self._view_features(imgs)
        if self.use_fmt:
            with span("cascade.fmt"):
                feats = self.FMT_with_pathway(feats, self.compute_dtype, self.plain)

        outputs = {}
        depth = sigma = prob_volume = None
        for stage_idx, ndepth in enumerate(self.ndepths):
            name = f"stage{stage_idx + 1}"
            stage_h, stage_w = height >> (2 - stage_idx), width >> (2 - stage_idx)
            ref_fea, *src_feas = feats[name].unbind(1)
            part = f"cascade.{name}."

            if stage_idx >= 1 and self.use_geo_fusion:
                with span(part + "geo_fusion"):
                    ref_img = resize_bilinear(imgs[:, 0].float(), (stage_h, stage_w))
                    depth_in = resize_bilinear(depth[..., None],
                                               (depth.shape[1] * 2, depth.shape[2] * 2))
                    # the fused feature comes back NCHW from the transposed
                    # convs, so this NHWC contiguous() is a copy (8 MB at
                    # stage 2, 16 MB at stage 3 in bf16 at 1152x864)
                    ref_fea = self.GeoFeatureFusionNet(
                        ref_img.permute(0, 3, 1, 2), depth_in.permute(0, 3, 1, 2),
                        depth_values, stage_idx, ref_fea.permute(0, 3, 1, 2),
                        self.compute_dtype,
                    ).permute(0, 2, 3, 1).contiguous()
            with span(part + "samples"):
                if stage_idx >= 1:
                    if self.grad_method == "detach":
                        depth, sigma = depth.detach(), sigma.detach()
                    cur_depth = resize_bilinear(depth[..., None], (height, width))[..., 0][:, None]
                    cur_var = resize_bilinear(sigma[..., None], (height, width))[..., 0][:, None]
                    samples = uncertainty_aware_samples(cur_depth, cur_var, ndepth,
                                                        height, width)
                    if self.clamp_samples:
                        # minimum(maximum()), not clamp: at a tie it passes half
                        # the gradient, as jnp.clip does
                        samples = torch.minimum(torch.maximum(samples, dmin), dmax)
                    samples = resize_trilinear_depth(samples, (ndepth, stage_h, stage_w))
                else:
                    samples = uncertainty_aware_samples(depth_values, None, ndepth,
                                                        stage_h, stage_w)
                fused = fuse_projection_matrices(proj_matrices[name])

            with span(part + "cost_volume"):
                # the views' features share one dtype; geo fusion's reference,
                # in the compute dtype, is upcast to theirs where they are fp32
                ref_fea = ref_fea.to(src_feas[0].dtype)
                group, local, bn_scope = self.slab_group, samples, contextlib.nullcontext()
                if group is not None:  # this rank's slab of the hypotheses
                    # a view: a [B, D, h, w] sweep expanded from [B, D] stays
                    # stride 0; detached, as every volume route detaches them
                    local = samples.detach().chunk(dist.get_world_size(group), 1)[
                        dist.get_rank(group)]
                    ref_fea = sum_backward(ref_fea, group)
                    src_feas = [sum_backward(f, group) for f in src_feas]
                    bn_scope = batch_stats_group(self.slab_stats_group)
                with bn_scope:
                    volume = self._cost_volume(stage_idx, ref_fea, src_feas, fused[:, 0],
                                               [fused[:, v] for v in range(1, n)], local)
                volume = volume.permute(0, 4, 1, 2, 3).to(self.compute_dtype)
            with span(part + "cost_reg"):
                if self.reg_mode == "georeg" and group is not None:
                    volume = gather_tokens(volume, 2, group)
                if self.reg_mode == "georeg":
                    prob_last = None
                    if stage_idx >= 1:  # the previous probability volume, upsampled x2
                        prob_last = F.interpolate(prob_volume, size=(stage_h, stage_w),
                                                  mode="bilinear", align_corners=False)
                    cost = self.cost_regularization[stage_idx](volume, stage_idx, prob_last)
                else:
                    cost = self.cost_regularization[stage_idx](volume, self.plain)[:, 0]
                    if group is not None:
                        cost = gather_tokens(cost, 1, group)
            with span(part + "stats"):
                out = stats(cost, samples)
                out["depth_values"] = samples
                depth, sigma, prob_volume = out["depth"], out["variance"], out["prob_volume"]
                outputs[name] = out
        outputs.update(outputs["stage3"])
        if self.refine:
            outputs["refined_depth"] = self.refine_network(imgs[:, 0].float(), depth,
                                                           self.compute_dtype)
        return outputs

    def slab_share_parameters(self) -> list:
        """The parameters whose gradient each rank of the slab group holds
        one slab's share of, to be summed over the group: the slab blocks
        of every CostRegNet and the weight nets. Empty without a group."""
        if self.slab_group is None:
            return []
        size = dist.get_world_size(self.slab_group)
        params = []
        for stage_idx, ndepth in enumerate(self.ndepths):
            if self.reg_mode == "costreg":
                params += slab.slab_parameters(self.cost_regularization[stage_idx], ndepth, size)
            if self.agg_mode == "adaptive":
                params += list(self.DepthNet.weight_net[stage_idx].parameters())
        return params

    def _cost_volume(self, stage_idx, ref_fea, src_feas, ref_proj, src_projs, samples):
        """[B, D, h, w, C] in the feature dtype, contiguous: its
        ``permute(0, 4, 1, 2, 3)`` is a channels_last_3d view."""
        plain_train = self.training and not (self.fused_train
                                             and self.agg_mode == "adaptive")
        if self.agg_mode == "variance":
            if self.plain or plain_train:
                return variance_cost_volume(ref_fea, src_feas, ref_proj, src_projs,
                                            samples, warp=plane_sweep_warp,
                                            align_corners=self.align_corners)
            return plane_sweep_variance(ref_fea, src_feas, ref_proj, src_projs, samples,
                                        self.align_corners)
        net = self.DepthNet.weight_net[stage_idx]
        if plain_train:
            # the fp32 squared difference reaches the net rounded to the
            # compute dtype, as the JAX package's convolutions take it; the
            # net's weights come back in that dtype and the view sum stays fp32
            return build_cost_volume(ref_fea, src_feas, ref_proj, src_projs, samples,
                                     lambda diff_sq: net(diff_sq.to(self.compute_dtype)),
                                     self.align_corners)
        costvol = (fused_adaptive_cost_volume_plain if self.plain
                   else fused_adaptive_cost_volume)
        return costvol(ref_fea, src_feas, ref_proj, src_projs, samples,
                       *fold_aggweight(net), self.align_corners)

    def _view_features(self, imgs: torch.Tensor) -> dict:
        """{stage: [B, N, h, w, C]}, each view's feature map NHWC. At
        inference the N views run as one batch; the NCHW permutation of the
        NHWC images is a channels_last view, so every map stays
        channels_last and its NHWC permutation is free. In training one
        FeatureNet call per view, in view order (each updates the running
        statistics), the maps stacked."""
        b, n, height, width, _ = imgs.shape
        if self.training:
            per_view = []
            for v in range(n):
                x = imgs[:, v].permute(0, 3, 1, 2).to(self.compute_dtype)
                per_view.append(self.feature(x.contiguous(memory_format=torch.channels_last)))
            return {k: torch.stack([f[k].permute(0, 2, 3, 1) for f in per_view], dim=1)
                    for k in per_view[0]}
        x = imgs.reshape(b * n, height, width, 3).permute(0, 3, 1, 2)
        feats = self.feature(x.to(self.compute_dtype))
        # contiguous() is a no-op on the card; a copy only where a conv
        # returns another layout
        return {k: f.permute(0, 2, 3, 1).contiguous().view(
            b, n, f.shape[2], f.shape[3], f.shape[1]) for k, f in feats.items()}
