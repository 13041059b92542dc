"""The network's modules (counterpart of damvsnet_tpu/nn). JAX's
``conv_transpose_torch`` emulates torch's transposed convolution, which
the blocks here use as it is."""
from .aggweight import AggWeightNetVolume
from .blocks import Conv2dBlock, Conv3dBlock, Deconv2dBlock, Deconv3dBlock
from .costreg import CostRegNet, Reg2d
from .feature import FeatureNet
from .fmt import FMT, FMTWithPathway
from .geofusion import GeoFeatureFusion
from .georeg import GeoRegNet2d
from .posenc import sine_position_encoding
from .refine import RefineNet
