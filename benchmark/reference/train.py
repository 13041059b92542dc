"""The training step's plain fp32 pieces: the staged smooth-L1 depth loss
with 12x the cross-view photometric-consistency (CPC) loss, Adam, and the
warm-up multistep learning rate (reference models/module.py:618-719,
utils.py:208-252, train.py:93-96, 439)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

CPC_WEIGHT = 12.0
BETAS, ADAM_EPS = (0.9, 0.999), 1e-8
WARMUP_FACTOR = 1.0 / 3


def _smooth_l1(diff):
    ad = diff.abs()
    return torch.where(ad < 1.0, 0.5 * diff * diff, ad - 0.5)


def _inverse_warp(img, ref_cam, src_cam, depth):
    """img [B, h, w, C] (the source view), cameras [B, 2, 4, 4], depth
    [B, h, w] -> (warped [B, h, w, C], mask [B, h, w, 1]). Taps clamp to
    the border; the mask is the reference's, which tests y0 twice and
    never y1."""
    b, h, w, c = img.shape
    r_l, r_r = ref_cam[:, 0, :3, :3], src_cam[:, 0, :3, :3]
    t_l, t_r = ref_cam[:, 0, :3, 3:4], src_cam[:, 0, :3, 3:4]
    k = ref_cam[:, 1, :3, :3]
    r_rel = r_r @ r_l.transpose(1, 2)
    t_rel = t_r - r_rel @ t_l
    ys, xs = torch.meshgrid(torch.arange(h, dtype=img.dtype, device=img.device),
                            torch.arange(w, dtype=img.dtype, device=img.device),
                            indexing="ij")
    grid = torch.stack([xs.reshape(-1), ys.reshape(-1), torch.ones_like(xs).reshape(-1)])
    cam = (torch.linalg.inv(k) @ grid) * depth.reshape(b, 1, -1)
    p = k @ (r_rel @ cam + t_rel)
    z = p[:, 2] + 1e-10
    px, py = (p[:, 0] / z).reshape(b, h, w), (p[:, 1] / z).reshape(b, h, w)
    x0, y0 = torch.floor(px), torch.floor(py)
    x1, y1 = x0 + 1, y0 + 1
    mask = ((x0 >= 0) & (x1 <= w - 1) & (y0 >= 0) & (y0 <= h - 1)).to(img.dtype)[..., None]
    flat = img.reshape(b, h * w, c)

    def tap(yy, xx):
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long().reshape(b, -1, 1)
        return torch.gather(flat, 1, idx.expand(-1, -1, c)).reshape(b, h, w, c)

    ax, ay = (x1 - px)[..., None], (y1 - py)[..., None]
    out = (ax * ay * tap(y0, x0) + ax * (1 - ay) * tap(y1, x0)
           + (1 - ax) * ay * tap(y0, x1) + (1 - ax) * (1 - ay) * tap(y1, x1))
    return out, mask


def _cpc(outputs, imgs, cams, depth_gt, dlossw):
    n = imgs.shape[1]
    total = 0.0
    for i, key in enumerate(sorted(k for k in outputs if k.startswith("stage"))):
        est, gt = outputs[key]["depth"], depth_gt[key]
        hh, ww = est.shape[1:]
        per_view = []
        for v in range(1, n):
            src = F.interpolate(imgs[:, v].permute(0, 3, 1, 2), size=(hh, ww),
                                mode="bilinear", align_corners=True).permute(0, 2, 3, 1)
            w_est, m_est = _inverse_warp(src, cams[key][:, 0], cams[key][:, v], est)
            w_gt, m_gt = _inverse_warp(src, cams[key][:, 0], cams[key][:, v], gt)
            m = m_est * m_gt
            r = _smooth_l1(w_est * m - w_gt * m).mean()
            per_view.append(r + 1e4 * (1.0 - m))
        vol = torch.stack(per_view, -1)
        top = torch.topk(vol, min(2, vol.shape[-1]), dim=-1, largest=False).values
        top = top * (top < 1e4).to(top.dtype)
        total = total + top.sum(-1).mean() * dlossw[i]
    return total


def loss(outputs, batch, dlossw=(0.5, 1.0, 2.0)):
    """The step's total loss: sum over stages of dlossw x the masked mean
    smooth-L1 of the depth, plus 12 x CPC."""
    total = 0.0
    for i, key in enumerate(sorted(k for k in outputs if k.startswith("stage"))):
        m = (batch["mask"][key] > 0.5).float()
        l1 = (_smooth_l1(outputs[key]["depth"] - batch["depth"][key]) * m).sum()
        total = total + dlossw[i] * l1 / m.sum().clamp(min=1.0)
    return total + CPC_WEIGHT * _cpc(outputs, batch["imgs"], batch["proj_matrices"],
                                     batch["depth"], dlossw)


def learning_rate(step, iters_per_epoch, base_lr, lrepochs, warmup_iters):
    """The lr of update ``step`` (0-based): a linear warm-up from a third
    of ``base_lr`` over ``warmup_iters`` updates, divided by the gamma of
    ``lrepochs`` ("10,12,14:2") at each milestone epoch passed."""
    epochs, gamma = lrepochs.split(":")
    passed = sum(step >= int(e) * iters_per_epoch for e in epochs.split(",") if e)
    alpha = min(step / warmup_iters, 1.0)
    return base_lr * (WARMUP_FACTOR * (1.0 - alpha) + alpha) / float(gamma) ** passed


class Adam:
    """Adam (betas 0.9 / 0.999, eps 1e-8) over a dict of fp32 tensors."""

    def __init__(self, params):
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params, grads, lr):
        self.t += 1
        b1, b2 = BETAS
        for k, g in grads.items():
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k] / (1 - b2 ** self.t)).sqrt_().add_(ADAM_EPS)
            params[k].addcdiv_(self.m[k], denom, value=-lr / (1 - b1 ** self.t))
