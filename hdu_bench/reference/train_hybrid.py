"""Plain reference of a training step of H-DenseUNet's end-to-end stage
(the reference repository's train_hybrid.py -arch end2end: hybridnet.py's
x250 fusion and HFF head, loss.py's weighted cross-entropy without the
boundary slices, Keras's SGD with Nesterov momentum), in float32 PyTorch
autograd over ``models.py``'s layers.

* 2D branch (``models.forward_2d`` under ``net2d.``): every BatchNorm uses
  its moving statistics and is not trained; its convolutions, their
  biases and the Scales train; no dropout. Each of the window's z slices
  goes in as its stack [z-1, z, z+1], replicated at the ends
  (``models.window_stacks``).
* Fusion: the 2D logits times ``logit_amplification`` beside the volume.
* 3D branch (``net3d.``): the encoder and the decoder with live BatchNorm
  statistics; its own classifier feeds nothing and is not run, so its
  leaves get no gradient and do not move.
* HFF head (``head.``): the sum of the two feature maps, the 3x3x3
  convolution, dropout at ``head_dropout``, BatchNorm with live statistics,
  ReLU and the 1x1x1 classifier. The dropout mask is the program's rule as
  ``models.dropout_keep`` states it, over the memory order (N, H, W, D, C)
  of the program's channels-last 3D tensors; the head runs in the step's
  own context, so the seed is the step's.
* Loss: ``train.weighted_ce`` over z 1..D-2 (loss.py:6-7).
* Update: for every trained leaf ``buf = m buf + g``, ``p -= lr (g + m
  buf)``, the buffers starting at zero; every live BatchNorm's moving
  statistics ``0.99 moving + 0.01 batch``.

Departures: none in the mathematics. Under autograd the 2D branch runs
one volume's slices at a time, each under ``torch.utils.checkpoint``, so
that batch 8 of 224x224x8 fits the card in float32; the chunks are exact
because its BatchNorms are frozen (no statistic couples two slices). The
3D branch and the head run whole, because their live statistics couple
the batch.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import models as R
from .train import weighted_ce


def trains(key: str) -> bool:
    """Whether the end-to-end stage trains leaf ``key`` (hybridnet.py:210-212:
    the 2D branch's BatchNorms are frozen, every other leaf trains)."""
    layer, leaf = key.rsplit(".", 1)
    if leaf in ("moving_mean", "moving_variance"):
        return False
    if layer.startswith("net2d."):
        name = layer[len("net2d."):]
        return not (name.endswith("_bn") or name.startswith("bn_up"))
    return True


def _strip(P: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in P.items() if k.startswith(prefix)}


def branch_2d(ops, vol, P, cfg):
    """vol (B, 1, H, W, D) -> (logits (B, C, H, W, D), features (B, F, H,
    W, D)) of the frozen 2D branch, slice stacks z-major per volume."""
    b, _, h, w, d = vol.shape
    idx = torch.tensor(R.window_stacks(d), device=vol.device).reshape(-1)
    x = vol[:, 0][..., idx].reshape(b, h, w, d, 3).permute(0, 3, 4, 1, 2).reshape(b * d, 3, h, w)

    def run(xs):
        return R.forward_2d(ops, xs, P, cfg, prefix="net2d.")

    if not torch.is_grad_enabled():
        feat, logits = run(x)
    else:
        parts = [checkpoint(run, xs, use_reentrant=False) for xs in x.split(d)]
        feat, logits = torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    vol_of = lambda t: t.reshape(b, d, *t.shape[1:]).permute(0, 2, 3, 4, 1)
    return vol_of(logits), vol_of(feat)


def branch_3d(ops, x, P, cfg, train):
    """The 3D DenseUNet with live statistics: x (B, 1 + C, H, W, D) -> its
    last decoder map (B, F, H, W, D)."""
    spec, Q = cfg["net3d"], _strip(P, "net3d.")
    x = R.encoder(ops, x, Q, spec, spec["eps_encoder"], "3d", train)
    for i, f in enumerate(spec["upsample"]):
        x = R.conv(ops, R.upsample(x, f), Q, f"3dconv_up{i}", pad=1)
        x = ops.act(torch.relu(R.batch_norm(x, Q, f"3dbn_up{i}", spec["eps_decoder"], train)))
    return x


def head_keep(seed: int, shape, rate: float, device) -> torch.Tensor:
    """The head's dropout mask, (N, C, H, W, D) 0/1, for a tensor of
    ``shape`` held channels-last."""
    n, c, h, w, d = shape
    keep = R.dropout_keep(seed, n * c * h * w * d, rate, device)
    return keep.view(n, h, w, d, c).permute(0, 4, 1, 2, 3)


def hff_head(ops, feat3d, fea2d, P, cfg, train):
    """HFF in training: conv -> dropout -> live BN -> ReLU -> classifier."""
    Q = _strip(P, "head.")
    f = R.conv(ops, feat3d + fea2d, Q, "fianl_conv", pad=1)
    f = f / (1.0 - train.rate) * head_keep(train.seed, f.shape, train.rate, f.device)
    f = ops.act(torch.relu(R.batch_norm(f, Q, "final_bn", cfg["net3d"]["eps_decoder"], train)))
    return R.conv(ops, f, Q, "2d3dclassifer")


def forward(ops, vol, P, cfg, seed: int):
    """vol (B, 1, H, W, D) -> (logits (B, C, H, W, D), {prefix: TrainStep}),
    the steps holding the live statistics of the 3D branch and the head."""
    live = {"net3d.": R.TrainStep(seed, 0.0), "head.": R.TrainStep(seed, cfg["train"]["head_dropout"])}
    res2d, fea2d = branch_2d(ops, vol, P, cfg)
    x = torch.cat([vol, res2d * cfg["logit_amplification"]], dim=1)
    feat3d = branch_3d(ops, x, P, cfg, live["net3d."])
    return hff_head(ops, feat3d, fea2d, P, cfg, live["head."]), live


def masked_loss(logits, label, weights):
    """logits (B, C, H, W, D), label (B, H, W, D): the weighted loss over z
    1..D-2."""
    d = logits.shape[-1]
    return weighted_ce(logits[..., 1 : d - 1], label[..., 1 : d - 1], weights)


class Trainer:
    """The reference's optimizer state over a parameter dict ``P`` (copied),
    as ``train.Trainer`` keeps it: ``params``, and ``buf`` for every leaf the
    stage trains."""

    def __init__(self, P: dict, cfg, ops):
        self.cfg, self.ops = cfg, ops
        tr = cfg["train"]
        self.lr, self.m = tr["lr"], tr["momentum"]
        self.weights = torch.tensor(tr["loss_weights"], dtype=torch.float32,
                                    device=next(iter(P.values())).device)
        self.params = {k: v.detach().clone().requires_grad_(trains(k)) for k, v in P.items()}
        self.buf = {k: torch.zeros_like(v) for k, v in self.params.items() if v.requires_grad}

    def step(self, image, label, seed: int):
        """One step on image (B, H, W, D, 1) and label (B, H, W, D); returns
        (loss, {key: the gradient the optimizer got}), zeros for the leaves
        the loss does not reach."""
        P = self.params
        for v in P.values():
            v.grad = None
        vol = image.float().permute(0, 4, 1, 2, 3).contiguous()
        logits, live = forward(self.ops, vol, P, self.cfg, seed)
        loss = masked_loss(logits, label, self.weights)
        loss.backward()
        grads = {}
        with torch.no_grad():
            for k, buf in self.buf.items():
                g = P[k].grad if P[k].grad is not None else torch.zeros_like(P[k])
                grads[k] = g
                buf.mul_(self.m).add_(g)
                P[k].sub_(self.lr * (g + self.m * buf))
            for prefix, train in live.items():
                for name, (mean, var) in train.stats.items():
                    P[f"{prefix}{name}.moving_mean"].mul_(0.99).add_(0.01 * mean)
                    P[f"{prefix}{name}.moving_variance"].mul_(0.99).add_(0.01 * var)
        return float(loss.detach()), grads
