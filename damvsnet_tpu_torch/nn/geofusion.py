"""Geometry-aware reference-feature fusion (counterpart of
damvsnet_tpu/nn/geofusion.py, "z" encoding, "basic" mask, origin feature
added).

At cascade stages 2/3 the reference view's FPN feature is replaced by the
output of a two-branch RGB+depth encoder-decoder conditioned on the
previous stage's depth. The "z" encoding concatenates sparse-max-pooled
normalized depth as an extra input plane at each encoder level. Layer names
follow the reference state_dict (``GeoFeatureFusionNet.<layer>``); the
reference's stage-1 heads (``rgbdepth_decoder_stage1``,
``final_decoder_stage1``) never run and are omitted, as in the JAX package.

Layout: NCHW. ``stage_idx`` 1 produces the stage-2 feature, 2 the stage-3.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import SeqConvBnReLU, batch_norm, norm_act, conv

_LARGE = 600.0


def sparse_downsample_close(d: torch.Tensor, mask: torch.Tensor):
    """Nearest-valid-depth 2x downsampling; d, mask [B, 1, H, W]. Valid
    pixels win via max-pool of -(d + penalty)."""
    encode_d = -(1.0 - mask) * _LARGE - d
    d_pooled = -F.max_pool2d(encode_d, 2, 2)
    mask_pooled = F.max_pool2d(mask, 2, 2)
    return d_pooled - (1.0 - mask_pooled) * _LARGE, mask_pooled


def convbnrelu(cin, cout, k, s, p):
    """The reference's convbnrelu Sequential: .0 Conv2d, .1 BatchNorm2d."""
    return SeqConvBnReLU(nn.Conv2d(cin, cout, k, s, p, bias=False),
                         batch_norm(2, cout))


def deconvbnrelu(cin, cout, k, s, p, op):
    """The reference's deconvbnrelu Sequential: .0 ConvTranspose2d, .1 BN."""
    return SeqConvBnReLU(nn.ConvTranspose2d(cin, cout, k, s, p, op, bias=False),
                         batch_norm(2, cout))


class BasicBlockGeo(nn.Module):
    """ResNet basic block with geo-plane concat; every block of the shipped
    configuration changes width, so each has a 1x1 downsample."""

    def __init__(self, inplanes, planes, stride, geo_channels=1):
        super().__init__()
        cin = inplanes + geo_channels
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = batch_norm(2, planes)
        self.conv2 = nn.Conv2d(planes + geo_channels, planes, 3, 1, 1, bias=False)
        self.bn2 = batch_norm(2, planes)
        self.downsample = nn.Sequential(
            nn.Conv2d(cin, planes, 1, stride, 0, bias=False), batch_norm(2, planes))

    def forward(self, x, g1, g2):
        x = torch.cat([x, g1], dim=1)
        out = norm_act(conv(x, self.conv1), self.bn1, relu=True)
        out = torch.cat([g2, out], dim=1)
        out = norm_act(conv(out, self.conv2), self.bn2, relu=False)
        identity = norm_act(conv(x, self.downsample[0]), self.downsample[1],
                           relu=False)
        return torch.relu(out + identity)


class GeoFeatureFusion(nn.Module):
    def __init__(self):
        super().__init__()
        # rgb encoder
        self.rgb_conv_init = convbnrelu(4, 8, 5, 1, 2)
        self.rgb_encoder_layer1 = BasicBlockGeo(8, 16, 2)
        self.rgb_encoder_layer2 = BasicBlockGeo(16, 32, 1)
        self.rgb_encoder_layer3 = BasicBlockGeo(32, 64, 2)
        self.rgb_encoder_layer4 = BasicBlockGeo(64, 128, 1)
        self.rgb_encoder_layer5 = BasicBlockGeo(128, 256, 2)
        # rgb decoder -> coarse 2-channel (depth, confidence)
        self.rgb_decoder_layer4 = deconvbnrelu(256, 128, 5, 2, 2, 1)
        self.rgb_decoder_layer2 = deconvbnrelu(128, 32, 5, 2, 2, 1)
        self.rgb_decoder_layer0 = deconvbnrelu(32, 16, 3, 1, 1, 0)
        self.rgb_decoder_layer = deconvbnrelu(16, 8, 5, 2, 2, 1)
        self.rgb_decoder_output = deconvbnrelu(8, 2, 3, 1, 1, 0)
        # depth encoder
        self.depth_conv_init = convbnrelu(2, 8, 5, 1, 2)
        self.depth_layer1 = BasicBlockGeo(8, 16, 2)
        self.depth_layer2 = BasicBlockGeo(16, 32, 1)
        self.depth_layer3 = BasicBlockGeo(64, 64, 2)
        self.depth_layer4 = BasicBlockGeo(64, 128, 1)
        self.depth_layer5 = BasicBlockGeo(256, 256, 2)
        # fused decoder
        self.decoder_layer3 = deconvbnrelu(256, 128, 5, 2, 2, 1)
        self.decoder_layer4 = deconvbnrelu(128, 64, 3, 1, 1, 0)
        self.decoder_layer5 = deconvbnrelu(64, 32, 5, 2, 2, 1)
        self.decoder_layer6 = deconvbnrelu(32, 16, 3, 1, 1, 0)
        self.decoder_layer7 = deconvbnrelu(16, 8, 5, 2, 2, 1)
        # per-stage output heads
        self.rgbdepth_decoder_stage2 = deconvbnrelu(16, 16, 5, 2, 2, 1)
        self.rgbdepth_decoder_stage3 = deconvbnrelu(8, 8, 3, 1, 1, 0)
        self.final_decoder_stage2 = deconvbnrelu(16, 16, 3, 1, 1, 0)
        self.final_decoder_stage3 = deconvbnrelu(8, 8, 3, 1, 1, 0)

    def forward(self, rgb, depth, depth_values, stage_idx, origin_feat, dtype=None):
        """rgb [B,3,H,W] and depth [B,1,H,W] (previous stage, upsampled x2),
        fp32; depth_values [B,D0]; origin_feat [B,C,H,W]. Returns the fused
        replacement for the reference view's stage feature, computed in
        ``dtype`` (the compute dtype; default origin_feat's). An fp32
        origin feature under a bf16 compute dtype (the FMT's, the U-Net
        FeatureNet's) is added in fp32 and the sum cast back, as JAX's
        promotion and its next convolution's cast do."""
        if stage_idx not in (1, 2):
            raise ValueError(f"geo fusion runs at stage index 1 or 2, got {stage_idx}")
        dt = origin_feat.dtype if dtype is None else dtype
        dmin = depth_values[:, 0][:, None, None, None]
        dmax = depth_values[:, -1][:, None, None, None]
        d = (depth - dmin) / (dmax - dmin)
        valid_mask = (d > 0).to(d.dtype)
        # "z" encoding: the depth plane at each encoder level, built in fp32
        # and cast once (concatenation with the compute-dtype maps)
        d_s2, vm_s2 = sparse_downsample_close(d, valid_mask)
        d_s3, vm_s3 = sparse_downsample_close(d_s2, vm_s2)
        d_s4, _ = sparse_downsample_close(d_s3, vm_s3)
        g1, g2, g3, g4 = (t.to(dt) for t in (d, d_s2, d_s3, d_s4))

        # rgb branch
        rgb_feature = self.rgb_conv_init(torch.cat([rgb.to(dt), g1], dim=1))
        rgb_feature1 = self.rgb_encoder_layer1(rgb_feature, g1, g2)
        rgb_feature2 = self.rgb_encoder_layer2(rgb_feature1, g2, g2)
        rgb_feature3 = self.rgb_encoder_layer3(rgb_feature2, g2, g3)
        rgb_feature4 = self.rgb_encoder_layer4(rgb_feature3, g3, g3)
        rgb_feature5 = self.rgb_encoder_layer5(rgb_feature4, g3, g4)

        rgb_feature4_plus = self.rgb_decoder_layer4(rgb_feature5) + rgb_feature4
        rgb_feature2_plus = self.rgb_decoder_layer2(rgb_feature4_plus) + rgb_feature2
        rgb_feature0_plus = self.rgb_decoder_layer0(rgb_feature2_plus) + rgb_feature1
        rgb_feature_plus = self.rgb_decoder_layer(rgb_feature0_plus) + rgb_feature
        rgb_depth = self.rgb_decoder_output(rgb_feature_plus)[:, 0:1]

        # depth branch
        sparsed_feature = self.depth_conv_init(torch.cat([g1, rgb_depth], dim=1))
        sparsed_feature1 = self.depth_layer1(sparsed_feature, g1, g2)
        sparsed_feature2 = self.depth_layer2(sparsed_feature1, g2, g2)
        sparsed_feature3 = self.depth_layer3(
            torch.cat([rgb_feature2_plus, sparsed_feature2], dim=1), g2, g3)
        sparsed_feature4 = self.depth_layer4(sparsed_feature3, g3, g3)
        sparsed_feature5 = self.depth_layer5(
            torch.cat([rgb_feature4_plus, sparsed_feature4], dim=1), g3, g4)

        # fused decoder
        decoder_feature3 = self.decoder_layer3(rgb_feature5 + sparsed_feature5)
        decoder_feature4 = self.decoder_layer4(sparsed_feature4 + decoder_feature3)
        decoder_feature6 = self.decoder_layer6(self.decoder_layer5(decoder_feature4))
        if stage_idx == 1:
            rgbdepth = self.rgbdepth_decoder_stage2(sparsed_feature1 + decoder_feature6)
            return self.final_decoder_stage2((rgbdepth + origin_feat).to(dt))
        decoder_feature7 = self.decoder_layer7(decoder_feature6)
        rgbdepth = self.rgbdepth_decoder_stage3(sparsed_feature + decoder_feature7)
        return self.final_decoder_stage3((rgbdepth + origin_feat).to(dt))
