"""ResNet50 with GroupNorm (counterpart of ``repro.models.resnet``), with
the K worker replicas run as one grouped convolution.

Layout.  The reference is NHWC with HWIO weights.  Here activations are
``[B, K·C, H, W]``: worker k owns channels ``[k·C, (k+1)·C)``, and each
convolution is one ``conv2d`` with ``groups=K`` over weights stored
``[K, O, I, kh, kw]`` (OIHW per worker).  GroupNorm with ``K·g`` groups
normalises each worker's ``g`` groups on their own, since groups are
contiguous channel ranges.  ``params.py`` converts weights from and to the
reference's HWIO.

Padding.  XLA's ``"SAME"`` pads ``total = max((out−1)·s + k − n, 0)`` with
``total // 2`` before and the rest after, so a stride-2 3×3 convolution on
an even input pads 0 rows before and 1 after.  ``padding=1`` in torch is
symmetric and gives other numbers; ``_conv`` pads explicitly instead.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.resnet50 import RESNET50_STAGES, RESNET_TINY_STAGES


def _same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride: int = 1):
    """x: [B, K·Cin, H, W]; w: [K, Cout, Cin, kh, kw] → [B, K·Cout, H', W']
    with XLA "SAME" padding."""
    K, cout, cin, kh, kw = w.shape
    top, bottom = _same_pad(x.shape[2], kh, stride)
    left, right = _same_pad(x.shape[3], kw, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w.reshape(K * cout, cin, kh, kw), stride=stride,
                    groups=K)


def _gn(p, x, K: int, groups: int = 32):
    """GroupNorm(min(32, C)) per worker, eps 1e-5, biased variance, fp32."""
    c = x.shape[1] // K
    g = min(groups, c)
    y = F.group_norm(x.to(torch.float32), K * g, p["scale"].reshape(-1),
                     p["bias"].reshape(-1), eps=1e-5)
    return y.to(x.dtype)


def _stages(cfg: ModelConfig):
    return RESNET_TINY_STAGES if cfg.name == "resnet-tiny" else RESNET50_STAGES


def _conv_init(gen, kh, kw, cin, cout, dtype, device):
    fan_in = kh * kw * cin
    w = torch.randn((cout, cin, kh, kw), generator=gen, dtype=torch.float32)
    return (w * (2.0 / fan_in) ** 0.5).to(dtype=dtype, device=device)


def _gn_init(c, device):
    return {"scale": torch.ones((c,), dtype=torch.float32, device=device),
            "bias": torch.zeros((c,), dtype=torch.float32, device=device)}


def init_resnet(cfg: ModelConfig, *, generator: torch.Generator,
                dtype=torch.float32, device="cpu"):
    """One replica's parameters (OIHW convolution weights, no K axis), in
    the reference's tree layout."""
    stages = _stages(cfg)
    width0 = stages[0][1] // 4
    conv = lambda kh, kw, ci, co: _conv_init(generator, kh, kw, ci, co, dtype,
                                             device)
    p = {"stem": {"w": conv(3, 3, 3, width0), "gn": _gn_init(width0, device)},
         "stages": []}
    cin = width0
    for n_blocks, cout in stages:
        mid = cout // 4
        blocks = []
        for b in range(n_blocks):
            blk = {
                "w1": conv(1, 1, cin, mid), "gn1": _gn_init(mid, device),
                "w2": conv(3, 3, mid, mid), "gn2": _gn_init(mid, device),
                "w3": conv(1, 1, mid, cout), "gn3": _gn_init(cout, device),
            }
            if b == 0 and cin != cout:
                blk["wproj"] = conv(1, 1, cin, cout)
            blocks.append(blk)
            cin = cout
        p["stages"].append(blocks)
    return p


def apply_resnet(cfg: ModelConfig, p, images):
    """images: [K, B, H, W, 3] (NHWC per worker) -> pooled features
    [K, B, d].  ``p`` carries the leading K axis on every leaf."""
    K, B, H, W, C = images.shape
    x = images.permute(1, 0, 4, 2, 3).reshape(B, K * C, H, W)
    x = F.relu(_gn(p["stem"]["gn"], _conv(x, p["stem"]["w"]), K))
    for si, blocks in enumerate(p["stages"]):
        for bi, blk in enumerate(blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            h = F.relu(_gn(blk["gn1"], _conv(x, blk["w1"]), K))
            h = F.relu(_gn(blk["gn2"], _conv(h, blk["w2"], stride), K))
            h = _gn(blk["gn3"], _conv(h, blk["w3"]), K)
            sc = x
            if "wproj" in blk:
                sc = _conv(x, blk["wproj"], stride)
            elif stride != 1:
                # the reference's 1×1 identity convolution at stride 2
                sc = x[:, :, ::stride, ::stride]
            x = F.relu(h + sc)
    pooled = torch.mean(x, dim=(2, 3))  # global average pool: [B, K·d]
    return pooled.reshape(B, K, -1).transpose(0, 1)
