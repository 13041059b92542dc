"""Training losses (counterpart of damvsnet_tpu/losses): the staged
smooth-L1 depth loss and the cross-view photometric-consistency loss."""
from .crossview import cross_view_loss, inverse_warping
from .supervised import cas_mvsnet_loss, masked_smooth_l1, smooth_l1
