"""GeoRegNet2d, the probability-volume-embedding cost regularizer
(counterpart of damvsnet_tpu/nn/georeg.py; GeoMVSNet style): (1,3,3)- and
(1,5,5)-kernel 3-D convolutions that stride H and W only, whose geo planes
are the previous stage's probability volume, max-pooled along D to this
stage's depth count ("z" encoding), then spatially per encoder level.
The cascade's ``reg_mode="georeg"`` runs one per stage, encodings
std / z / z.

Names follow the JAX package's modules (``conv_init``,
``encoder_layer1..5`` with ``conv1`` / ``conv2`` / ``downsample``,
``decoder_layer4..1``, ``decoder_layer``, ``prob``), each a block with
``.conv`` / ``.bn``. The ``prob`` head is a transposed conv with BN and
ReLU, as in JAX.

Layout: [B, C, D, H, W]; the cost volume arrives as a channels_last_3d
view. H and W divisible by 8.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import Conv3dBlock, Deconv3dBlock

_K = (1, 3, 3)
_P = (0, 1, 1)
_S = (1, 2, 2)
_K5, _P5, _OP = (1, 5, 5), (0, 2, 2), (0, 1, 1)


class RegBasicBlockGeo(nn.Module):
    """Geo-concat residual block (geometry.py:549-593): conv1 on [x, g1],
    conv2 (no ReLU) on [g2, out], a downsample (no ReLU) of [x, g1] when
    the stride or width changes, ReLU of the sum."""

    def __init__(self, inplanes: int, planes: int, stride=1, geo_channels: int = 0):
        super().__init__()
        cin = inplanes + geo_channels
        self.conv1 = Conv3dBlock(cin, planes, _K, 1, _P)
        self.conv2 = Conv3dBlock(planes + geo_channels, planes, _K, stride, _P, relu=False)
        if stride != 1 or inplanes != planes:
            self.downsample = Conv3dBlock(cin, planes, _K, stride, _P, relu=False)
        else:
            self.downsample = None

    def forward(self, x, g1=None, g2=None):
        identity = x
        if g1 is not None:
            x = torch.cat([x, g1], dim=1)
        out = self.conv1(x)
        if g2 is not None:
            out = torch.cat([g2, out], dim=1)
        out = self.conv2(out)
        if self.downsample is not None:
            identity = self.downsample(x)
        return torch.relu(out + identity)


def _depth_pool(x):
    """Max-pool D by 2, VALID."""
    return F.max_pool3d(x, (2, 1, 1), (2, 1, 1))


def _spatial_pool(x):
    return F.max_pool3d(x, (1, 2, 2), (1, 2, 2))


class GeoRegNet2d(nn.Module):
    """in_channels: the cost volume's width. encoding: "std" (no geo
    planes) or "z" (the previous probability volume's planes; needs
    stage_idx 1 or 2)."""

    def __init__(self, in_channels: int, encoding: str = "z"):
        super().__init__()
        if encoding not in ("std", "z"):
            raise ValueError(f"GeoRegNet2d encoding {encoding!r} is neither 'std' nor 'z'")
        self.encoding = encoding
        g = 1 if encoding == "z" else 0
        self.conv_init = Conv3dBlock(in_channels, 8, _K, 1, _P)
        self.encoder_layer1 = RegBasicBlockGeo(8, 16, _S, g)
        self.encoder_layer2 = RegBasicBlockGeo(16, 32, 1, g)
        self.encoder_layer3 = RegBasicBlockGeo(32, 64, _S, g)
        self.encoder_layer4 = RegBasicBlockGeo(64, 128, 1, g)
        self.encoder_layer5 = RegBasicBlockGeo(128, 256, _S, g)
        self.decoder_layer4 = Deconv3dBlock(256, 128, _K5, _S, _P5, output_padding=_OP)
        self.decoder_layer3 = Deconv3dBlock(128, 64, _K, 1, _P)
        self.decoder_layer2 = Deconv3dBlock(64, 32, _K5, _S, _P5, output_padding=_OP)
        self.decoder_layer1 = Deconv3dBlock(32, 16, _K, 1, _P)
        self.decoder_layer = Deconv3dBlock(16, 8, _K5, _S, _P5, output_padding=_OP)
        self.prob = Deconv3dBlock(8, 1, _K, 1, _P)

    def forward(self, x, stage_idx: int, prob_volume_last=None):
        """x [B, C, D, H, W] cost volume; prob_volume_last [B, D_prev, H, W],
        the previous stage's probability volume at this stage's H and W
        ("z": D_prev = 2 D at stage 1, 4 D at stage 2). -> [B, D, H, W]."""
        if self.encoding == "z":
            if stage_idx not in (1, 2) or prob_volume_last is None:
                raise ValueError("the 'z' encoding needs stage_idx 1 or 2 and the "
                                 "previous stage's probability volume")
            geo_s1 = _depth_pool(prob_volume_last[:, None].to(x.dtype))
            if stage_idx == 2:
                geo_s1 = _depth_pool(geo_s1)
            geo_s2 = _spatial_pool(geo_s1)
            geo_s3 = _spatial_pool(geo_s2)
        else:
            geo_s1 = geo_s2 = geo_s3 = None

        feature = self.conv_init(x)
        feature1 = self.encoder_layer1(feature, geo_s1, geo_s1)
        feature2 = self.encoder_layer2(feature1, geo_s2, geo_s2)
        feature3 = self.encoder_layer3(feature2, geo_s2, geo_s2)
        feature4 = self.encoder_layer4(feature3, geo_s3, geo_s3)
        feature5 = self.encoder_layer5(feature4, geo_s3, geo_s3)
        x = self.decoder_layer4(feature5) + feature4
        x = self.decoder_layer3(x) + feature3
        x = self.decoder_layer2(x) + feature2
        x = self.decoder_layer1(x) + feature1
        x = self.decoder_layer(x) + feature
        return self.prob(x)[:, 0]
