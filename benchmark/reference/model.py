"""The DA-MVSNet cascade as plain functions of named parameters, in fp32.

``Cascade(params, buffers, cfg, training)`` runs the three stages as the
reference's CascadeMVSNet does in the configurations the benchmark runs:
the fpn FeatureNet (in training one call a view, so its batch statistics
are a view's), GeoFeatureFusion ("z" encoding) on the reference feature at
stages 2 and 3, ADIA hypotheses (clamped into the input sweep where
``clamp_samples``), the adaptive cost volume with the weight nets or the
variance cost volume, one CostRegNet a stage, and the statistics tail.
Each part is a method (``features``, ``geo_fusion``, ``cost_volume``,
``costreg``, ...), so that a reference of another architecture subclasses
``Cascade`` and replaces the part it changes.

In training, BatchNorm normalizes with the batch statistics (biased
variance) and records them in call order; ``running_stats()`` applies them
to the running statistics with momentum 0.1 afterwards. Calls made while
``recording`` is off (a checkpointed region run again in the backward)
record nothing.

``precision="fp8"`` is the control: every convolution takes its input and
its weight rounded to float8 e4m3 with a per-tensor scale and accumulates
in fp32; in training its output's gradient is rounded to float8 e5m2 the
same way.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import ops

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
STAGE_CHANNELS = (32, 16, 8)
_F8 = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}


def round_fp8(x, kind="e4m3"):
    """x rounded to float8 with a per-tensor scale that maps its largest
    magnitude to the format's largest value."""
    dtype, top = _F8[kind]
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8Forward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_fp8(x, "e4m3")

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Backward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g, "e5m2")


class Cascade:
    def __init__(self, params, buffers, cfg, training=False, precision="fp32",
                 checkpoint_volumes=False):
        self.p, self.buf, self.cfg = params, buffers, cfg
        self.training = training
        self.fp8 = precision == "fp8"
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.checkpoint_volumes = checkpoint_volumes
        self.recording = True
        self.bn_calls = []

    # -- layers ---------------------------------------------------------
    def conv(self, x, name, stride=1, padding=0, transposed=False, output_padding=0,
             bias=False):
        w = self.p[f"{name}.weight"]
        b = self.p[f"{name}.bias"] if bias else None
        if self.fp8:
            x, w = _Fp8Forward.apply(x), _Fp8Forward.apply(w)
        nd = x.dim() - 2
        if transposed:
            fn = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
            y = fn(x, w, b, stride, padding, output_padding)
        else:
            y = (F.conv2d if nd == 2 else F.conv3d)(x, w, b, stride, padding)
        return _Fp8Backward.apply(y) if self.fp8 and self.training else y

    def bn(self, y, name, relu):
        shape = (1, -1) + (1,) * (y.dim() - 2)
        g, b = self.p[f"{name}.weight"].view(shape), self.p[f"{name}.bias"].view(shape)
        if self.training:
            dims = [0] + list(range(2, y.dim()))
            var, mean = torch.var_mean(y, dim=dims, correction=0)
            if self.recording:
                self.bn_calls.append((name, mean.detach(), var.detach()))
        else:
            mean, var = self.buf[f"{name}.running_mean"], self.buf[f"{name}.running_var"]
        out = (y - mean.view(shape)) * torch.rsqrt(var.view(shape) + BN_EPS) * g + b
        return torch.relu(out) if relu else out

    def block(self, x, name, stride=1, padding=0, relu=True, transposed=False,
              output_padding=0):
        y = self.conv(x, f"{name}.conv", stride, padding, transposed, output_padding)
        return self.bn(y, f"{name}.bn", relu)

    def seq(self, x, name, stride, padding, transposed=False, output_padding=0):
        """The reference's convbnrelu / deconvbnrelu: ``.0`` conv, ``.1`` BN."""
        y = self.conv(x, f"{name}.0", stride, padding, transposed, output_padding)
        return self.bn(y, f"{name}.1", True)

    def running_stats(self):
        """The running statistics after the recorded batch statistics."""
        out = {k: v.clone() for k, v in self.buf.items()}
        for name, mean, var in self.bn_calls:
            for key, val in (("running_mean", mean), ("running_var", var)):
                out[f"{name}.{key}"] += BN_MOMENTUM * (val - out[f"{name}.{key}"])
        return out

    # -- modules --------------------------------------------------------
    def feature(self, x):
        t = "feature"
        for j, (s, pd) in enumerate(((1, 1), (1, 1))):
            x = self.block(x, f"{t}.conv0.{j}", s, pd)
        conv0 = x
        for j, (s, pd) in enumerate(((2, 2), (1, 1), (1, 1))):
            x = self.block(x, f"{t}.conv1.{j}", s, pd)
        conv1 = x
        for j, (s, pd) in enumerate(((2, 2), (1, 1), (1, 1))):
            x = self.block(x, f"{t}.conv2.{j}", s, pd)
        out = {"stage1": self.conv(x, f"{t}.out1")}
        x = (F.interpolate(x, size=conv1.shape[2:], mode="nearest")
             + self.conv(conv1, f"{t}.inner1", bias=True))
        out["stage2"] = self.conv(x, f"{t}.out2", padding=1)
        x = (F.interpolate(x, size=conv0.shape[2:], mode="nearest")
             + self.conv(conv0, f"{t}.inner2", bias=True))
        out["stage3"] = self.conv(x, f"{t}.out3", padding=1)
        return out

    def basic_geo(self, x, g1, g2, name, stride):
        x = torch.cat([x, g1], 1)
        out = self.bn(self.conv(x, f"{name}.conv1", stride, 1), f"{name}.bn1", True)
        out = torch.cat([g2, out], 1)
        out = self.bn(self.conv(out, f"{name}.conv2", 1, 1), f"{name}.bn2", False)
        ident = self.bn(self.conv(x, f"{name}.downsample.0", stride, 0),
                        f"{name}.downsample.1", False)
        return torch.relu(out + ident)

    def geo_fusion(self, rgb, depth, depth_values, stage_idx, origin):
        t = "GeoFeatureFusionNet"
        dmin = depth_values[:, 0].view(-1, 1, 1, 1)
        dmax = depth_values[:, -1].view(-1, 1, 1, 1)
        d = (depth - dmin) / (dmax - dmin)
        mask = (d > 0).float()
        gs = [d]
        for _ in range(3):  # sparse max-pool of the nearest valid depth
            enc = -(1.0 - mask) * 600.0 - gs[-1]
            pooled, mask = -F.max_pool2d(enc, 2, 2), F.max_pool2d(mask, 2, 2)
            gs.append(pooled - (1.0 - mask) * 600.0)
        g1, g2, g3, g4 = gs
        dec = lambda x, n, k: self.seq(x, f"{t}.{n}", 2 if k == 5 else 1, 2 if k == 5 else 1,  # noqa: E731
                                       True, 1 if k == 5 else 0)
        rf = self.seq(torch.cat([rgb, g1], 1), f"{t}.rgb_conv_init", 1, 2)
        rf1 = self.basic_geo(rf, g1, g2, f"{t}.rgb_encoder_layer1", 2)
        rf2 = self.basic_geo(rf1, g2, g2, f"{t}.rgb_encoder_layer2", 1)
        rf3 = self.basic_geo(rf2, g2, g3, f"{t}.rgb_encoder_layer3", 2)
        rf4 = self.basic_geo(rf3, g3, g3, f"{t}.rgb_encoder_layer4", 1)
        rf5 = self.basic_geo(rf4, g3, g4, f"{t}.rgb_encoder_layer5", 2)
        rf4p = dec(rf5, "rgb_decoder_layer4", 5) + rf4
        rf2p = dec(rf4p, "rgb_decoder_layer2", 5) + rf2
        rf0p = dec(rf2p, "rgb_decoder_layer0", 3) + rf1
        rfp = dec(rf0p, "rgb_decoder_layer", 5) + rf
        rgb_depth = dec(rfp, "rgb_decoder_output", 3)[:, 0:1]
        sf = self.seq(torch.cat([g1, rgb_depth], 1), f"{t}.depth_conv_init", 1, 2)
        sf1 = self.basic_geo(sf, g1, g2, f"{t}.depth_layer1", 2)
        sf2 = self.basic_geo(sf1, g2, g2, f"{t}.depth_layer2", 1)
        sf3 = self.basic_geo(torch.cat([rf2p, sf2], 1), g2, g3, f"{t}.depth_layer3", 2)
        sf4 = self.basic_geo(sf3, g3, g3, f"{t}.depth_layer4", 1)
        sf5 = self.basic_geo(torch.cat([rf4p, sf4], 1), g3, g4, f"{t}.depth_layer5", 2)
        df3 = dec(rf5 + sf5, "decoder_layer3", 5)
        df4 = dec(sf4 + df3, "decoder_layer4", 3)
        df6 = dec(dec(df4, "decoder_layer5", 5), "decoder_layer6", 3)
        if stage_idx == 1:
            x = dec(sf1 + df6, "rgbdepth_decoder_stage2", 5)
            return dec(x + origin, "final_decoder_stage2", 3)
        x = dec(sf + dec(df6, "decoder_layer7", 5), "rgbdepth_decoder_stage3", 3)
        return dec(x + origin, "final_decoder_stage3", 3)

    def costreg(self, x, i):
        t = f"cost_regularization.{i}"
        c0 = self.block(x, f"{t}.conv0", 1, 1)
        c2 = self.block(self.block(c0, f"{t}.conv1", 2, 1), f"{t}.conv2", 1, 1)
        c4 = self.block(self.block(c2, f"{t}.conv3", 2, 1), f"{t}.conv4", 1, 1)
        x = self.block(self.block(c4, f"{t}.conv5", 2, 1), f"{t}.conv6", 1, 1)
        x = c4 + self.block(x, f"{t}.conv7", 2, 1, transposed=True, output_padding=1)
        x = c2 + self.block(x, f"{t}.conv9", 2, 1, transposed=True, output_padding=1)
        x = c0 + self.block(x, f"{t}.conv11", 2, 1, transposed=True, output_padding=1)
        return self.conv(x, f"{t}.prob", 1, 1)[:, 0]

    def weight_net(self, diff_sq, i):
        t = f"DepthNet.weight_net.{i}.w_net"
        return self.block(self.block(diff_sq, f"{t}.0"), f"{t}.1")

    def cost_volume(self, i, ref, srcs, ref_proj, src_projs, samples):
        """[B, C, D, h, w]: adaptive (the weight nets) or variance."""
        h, w = ref.shape[2:]
        ref_vol = ref[:, :, None]
        if self.cfg["agg_mode"] == "variance":
            vol, sq = ref_vol, ref_vol ** 2
            for src, proj in zip(srcs, src_projs):
                warped = ops.sample_zeros(src, *ops.homography_coords(proj, ref_proj,
                                                                      samples, h, w))
                vol, sq = vol + warped, sq + warped ** 2
            n = len(srcs) + 1
            return sq / n - (vol / n) ** 2

        def view(src, proj):
            warped = ops.sample_zeros(src, *ops.homography_coords(proj, ref_proj,
                                                                  samples, h, w))
            diff_sq = (ref_vol - warped) ** 2
            return (self.weight_net(diff_sq, i) + 1.0) * diff_sq

        total = 0.0
        for src, proj in zip(srcs, src_projs):
            if self.checkpoint_volumes and self.training:
                total = total + checkpoint(view, src, proj, use_reentrant=False)
            else:
                total = total + view(src, proj)
        return total / len(srcs)

    def features(self, nchw):
        """{stage: [each view's feature map]} of the views ``nchw`` [B, N, 3,
        H, W]: in training one FeatureNet call a view (its batch statistics
        are a view's), in serving one call over every view. A reference of
        another architecture overrides it (FMT transforms the views'
        features jointly)."""
        b, n, _, height, width = nchw.shape
        if self.training:
            per_view = [self.feature(nchw[:, v]) for v in range(n)]
            return {k: [f[k] for f in per_view] for k in per_view[0]}
        both = self.feature(nchw.reshape(b * n, 3, height, width))
        return {k: list(f.reshape(b, n, *f.shape[1:]).unbind(1)) for k, f in both.items()}

    # -- the cascade ----------------------------------------------------
    def __call__(self, imgs, proj_matrices, depth_values):
        """imgs [B, N, H, W, 3]; proj_matrices {stage: [B, N, 2, 4, 4]};
        depth_values [B, D0]. Returns {stageK: stats} with stage 3's at
        the top level too."""
        cfg = self.cfg
        b, n, height, width, _ = imgs.shape
        dmin = depth_values.min(1).values.view(-1, 1, 1, 1)
        dmax = depth_values.max(1).values.view(-1, 1, 1, 1)
        nchw = imgs.permute(0, 1, 4, 2, 3)
        feats = self.features(nchw)
        outputs, depth, sigma = {}, None, None
        for i, ndepth in enumerate(cfg["ndepths"]):
            name = f"stage{i + 1}"
            h, w = height >> (2 - i), width >> (2 - i)
            ref, *srcs = feats[name]
            if i == 0:
                samples = ops.uniform_samples(depth_values, ndepth, h, w)
            else:
                if cfg["use_geo_fusion"]:
                    rgb = F.interpolate(nchw[:, 0], size=(h, w), mode="bilinear",
                                        align_corners=False)
                    d_in = F.interpolate(depth[:, None], size=(2 * depth.shape[1],
                                                               2 * depth.shape[2]),
                                         mode="bilinear", align_corners=False)
                    ref = self.geo_fusion(rgb, d_in, depth_values, i, ref)
                depth, sigma = depth.detach(), sigma.detach()
                up = lambda t: F.interpolate(t[:, None], size=(height, width),  # noqa: E731
                                             mode="bilinear", align_corners=False)
                samples = ops.adia_samples(up(depth), up(sigma), ndepth)
                if cfg["clamp_samples"]:
                    samples = torch.minimum(torch.maximum(samples, dmin), dmax)
                if (h, w) != (height, width):
                    samples = F.interpolate(samples[:, None], size=(ndepth, h, w),
                                            mode="trilinear", align_corners=False)[:, 0]
            projs = ops.fuse_proj(proj_matrices[name].reshape(b * n, 2, 4, 4)).view(b, n, 4, 4)
            volume = self.cost_volume(i, ref, srcs, projs[:, 0],
                                      list(projs[:, 1:].unbind(1)), samples)
            out = ops.prob_stats(self.costreg(volume, i), samples)
            out["depth_values"] = samples
            depth, sigma = out["depth"], out["variance"]
            outputs[name] = out
        outputs.update(outputs["stage3"])
        return outputs
