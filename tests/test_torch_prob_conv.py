"""CostRegNet's ``prob`` conv (kernel K5, ``ops/kernels/prob_conv.py``) on
the CPU: the wrapper's plain version, CostRegNet's output on the kernel's
route, and the route itself (the kernel where no gradient is needed at the width it is
built for, the library convolution under autograd, at other widths or
with ``plain``). The kernel is held
against ``F.conv3d`` on the card in ``test_torch_kernels_cuda.py``."""
import pytest
import torch

from damvsnet_tpu_torch.nn import costreg
from damvsnet_tpu_torch.nn.blocks import conv
from damvsnet_tpu_torch.nn.costreg import CostRegNet
from damvsnet_tpu_torch.ops.kernels import prob_conv

torch.set_num_threads(1)


def _volume(c, dtype=torch.float32, b=2, d=8, h=8, w=16, seed=0):
    """[B, C, D, H, W] as the cascade hands it over: a channels_last_3d
    view of [B, D, H, W, C] (the U-Net halves D, H and W three times)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, d, h, w, c, generator=g).to(dtype).permute(0, 4, 1, 2, 3)


def _net(c=8, seed=0, base=8):
    torch.manual_seed(seed)
    net = CostRegNet(c, base)
    g = torch.Generator().manual_seed(seed + 1)
    for m in net.modules():  # running statistics away from the identity
        if isinstance(m, torch.nn.BatchNorm3d):
            m.running_mean.copy_(0.1 * torch.randn(m.num_features, generator=g))
            m.running_var.copy_(0.5 + torch.rand(m.num_features, generator=g))
    return net.eval()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
def test_wrapper_on_cpu_is_conv(dtype, layout):
    m = _net().prob
    x = _volume(8, dtype, d=3, h=17, w=23)
    if layout == "contiguous":
        x = x.contiguous()
    n0 = prob_conv.prob_conv3d.launches
    with torch.inference_mode():
        got = prob_conv.prob_conv3d(x, m.weight)
        want = conv(x, m)
    assert prob_conv.prob_conv3d.launches == n0
    assert got.dtype == dtype and got.shape == (2, 1, 3, 17, 23)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_costregnet_inference_output_unchanged(dtype):
    """Under inference_mode the kernel's route gives what the library
    convolution gave (the plain route) and what the autograd route gives."""
    net = _net()
    x = _volume(8, dtype)
    with torch.inference_mode():
        got = net(x)
        plain = net(x, plain=True)
    x_grad = x.detach().clone().requires_grad_()
    autograd = net(x_grad)
    assert got.shape == (2, 1, 8, 8, 16) and got.dtype == dtype
    assert torch.equal(got, plain)
    assert torch.equal(got, autograd.detach())


@pytest.mark.parametrize("grad, x_grad, w_grad, plain, route", [
    (False, False, True, False, "kernel"),   # inference_mode / no_grad
    (True, False, False, False, "kernel"),   # a frozen model on a plain input
    (True, True, False, False, "library"),   # the input needs a gradient
    (True, False, True, False, "library"),   # the weights need a gradient
    (True, True, True, False, "library"),    # training
    (False, False, True, True, "library"),   # the cascade's plain reference
])
def test_prob_route(monkeypatch, grad, x_grad, w_grad, plain, route):
    """The route ``prob`` takes; w_grad: every parameter's flag (the input
    that reaches ``prob`` needs a gradient wherever an earlier block's
    weight does)."""
    calls = []
    # on the CPU the kernel's wrapper runs its plain version
    kernel = prob_conv.prob_conv3d
    monkeypatch.setattr(prob_conv, "prob_conv3d",
                        lambda x, w: calls.append("kernel") or kernel(x, w))
    monkeypatch.setattr(costreg, "conv", lambda x, m: calls.append("library") or conv(x, m))
    net = _net()
    net.requires_grad_(w_grad)
    x = _volume(8).requires_grad_(x_grad)
    with torch.set_grad_enabled(grad):
        net(x, plain=plain)
    assert calls == [route]


@pytest.mark.parametrize("base", [4, 16])
@pytest.mark.parametrize("grad", [False, True])
def test_prob_route_other_widths(monkeypatch, base, grad):
    """A U-Net of another width (``cr_base_chs`` (8, 4, 16) or (4, 8, 4))
    keeps the library convolution for ``prob`` on every route, serving
    included: the kernel is built for 8 channels."""
    calls = []
    kernel = prob_conv.prob_conv3d
    monkeypatch.setattr(prob_conv, "prob_conv3d",
                        lambda x, w: calls.append("kernel") or kernel(x, w))
    monkeypatch.setattr(costreg, "conv", lambda x, m: calls.append("library") or conv(x, m))
    net = _net(8, base=base)
    assert net.prob.in_channels == base
    x = _volume(8)
    with torch.set_grad_enabled(grad):
        got = net(x)
        plain = net(x, plain=True)
    assert calls == ["library", "library"]
    assert got.shape == (2, 1, 8, 8, 16) and torch.equal(got, plain)
