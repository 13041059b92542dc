"""Losses (counterpart of damvsnet_tpu/losses): the staged smooth-L1 depth
loss and the cross-view photometric-consistency loss that the train step
uses, and the library losses nothing in the train loop calls, as in the JAX
package: the entropy family and the unsupervised losses."""
from .crossview import cross_view_loss, inverse_warping
from .entropy import entropy_loss, focal_loss_bld, info_entropy_loss
from .supervised import cas_mvsnet_loss, masked_smooth_l1, smooth_l1
from .unsupervised import depth_smoothness, ssim, unsup_loss, unsup_reconstruction_loss
