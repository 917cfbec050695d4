"""The CNNs of the AdaptCL reproduction, VGG and ResNet, on PyTorch.

Port of ``repro/models/cnn.py``.  Parameters are flat ``{path: tensor}``
dicts in the JAX package's layout — conv weights HWIO ``[kh, kw, cin,
cout]``, BN ``[cout]``, head ``[cin, classes]`` — so every ``unit_map`` axis
stays valid; the port converts to NCHW/OIHW only at the op boundary.  Every
function also takes worker stacks: params with a leading worker dimension
``[B, ...]`` and images ``[B, n, H, W, 3]``, which is how the resident fleet
trains W workers in one call (the JAX package vmaps).

Pruning protocol (paper Appendix B): VGG — every conv prunes, the head does
not; ResNet — the stem, the last conv of each residual block and the
shortcuts are kept whole, the interior convs prune.

**Compute paths** (``cnn_apply(compute=...)``):

* ``"dense"`` runs the convs as one grouped ``F.conv2d`` over the worker
  stack (``groups=B``); an unbatched call is a plain ``F.conv2d``.
* ``"block_skip"`` lowers every conv to im2col patches (``F.unfold``, whose
  K order is channel-major like ``conv_general_dilated_patches``, so a
  pruned channel prefix stays a K prefix; a 1x1 conv is a strided view)
  times ``w`` reshaped to ``[cin*kh*kw, cout]``, through
  ``kernels.pruned_matmul`` with per-worker unit masks wired along
  ``conv_mask_wiring``.  The head rides the same kernel.  Device FLOPs then
  track retention; ``cnn_block_compute`` is the host-side count of what that
  dispatch executes.

Convolutions pad like JAX's ``"SAME"``: stride s gives ``ceil(H/s)``
outputs and ``max((ceil(H/s) - 1) * s + k - H, 0)`` padding, the smaller
half before, so a 3x3 stride-2 conv on an even input pads (0, 1), not
torch's (1, 1).  Uneven padding is an explicit ``F.pad``.

BatchNorm always uses the batch statistics of each worker row (biased
variance, eps 1e-5), evaluation included, as the reference's ``_bn`` does.
Max-pool is 2x2 VALID, a ResNet shortcut without its own conv subsamples
``x[::s, ::s]``, and the head is a global mean.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.masks import UnitLayer, UnitSpace
from repro_torch.kernels.pruned_matmul import pruned_matmul

__all__ = [
    "CNNConfig",
    "vgg_config",
    "resnet_config",
    "VGG16_CIFAR",
    "VGG11_SMALL",
    "RESNET50_TINY",
    "RESNET20_SMALL",
    "init_cnn",
    "cnn_apply",
    "conv_mask_wiring",
    "prunable_layer_names",
    "build_unit_space",
    "extract_bn_scales",
    "cnn_flops",
    "cnn_flops_from_shapes",
    "cnn_block_compute",
]


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    kind: str                      # "vgg" | "resnet"
    num_classes: int
    image_size: int
    plan: Tuple = ()               # vgg: ints (conv width) or "M" (maxpool)
    # resnet: stem width + (block_count, width) per stage
    stem: int = 64
    stages: Tuple[Tuple[int, int], ...] = ()
    bottleneck: bool = True


def vgg_config(name, plan, num_classes=10, image_size=32) -> CNNConfig:
    return CNNConfig(name=name, kind="vgg", plan=tuple(plan), num_classes=num_classes, image_size=image_size)


def resnet_config(name, stem, stages, num_classes=200, image_size=64, bottleneck=True) -> CNNConfig:
    return CNNConfig(
        name=name, kind="resnet", stem=stem, stages=tuple(tuple(s) for s in stages),
        num_classes=num_classes, image_size=image_size, bottleneck=bottleneck,
    )


VGG16_CIFAR = vgg_config(
    "vgg16_cifar",
    [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"],
)
# reduced same-family net for fast CPU simulation
VGG11_SMALL = vgg_config("vgg11_small", [16, "M", 32, "M", 64, 64, "M", 64, 64, "M"])
RESNET50_TINY = resnet_config("resnet50_tiny", 64, [(3, 64), (4, 128), (6, 256), (3, 512)])
RESNET20_SMALL = resnet_config(
    "resnet20_small", 16, [(2, 16), (2, 32), (2, 64)], num_classes=10, image_size=32, bottleneck=False
)


def _blocks(cfg: CNNConfig) -> List[Tuple[str, int, int, int, int]]:
    """[(prefix, cin, width, out_width, stride)] of every residual block; a
    stage after the first opens with stride 2."""
    out = []
    cin = cfg.stem
    for si, (nblocks, width) in enumerate(cfg.stages):
        out_w = width * (4 if cfg.bottleneck else 1)
        for bi in range(nblocks):
            out.append((f"s{si}b{bi}", cin, width, out_w, 2 if (bi == 0 and si > 0) else 1))
            cin = out_w
    return out


def _block_convs(cfg: CNNConfig, cin: int, width: int, out_w: int) -> List[Tuple[str, int, int, int]]:
    """[(suffix, ksize, cin, cout)] of one block's convs, the shortcut conv
    ``sc`` only where the block changes width."""
    if cfg.bottleneck:
        convs = [("c1", 1, cin, width), ("c2", 3, width, width), ("c3", 1, width, out_w)]
    else:
        convs = [("c1", 3, cin, width), ("c2", 3, width, out_w)]
    if cin != out_w:
        convs.append(("sc", 1, cin, out_w))
    return convs


# ---------------------------------------------------------------------------
# init / apply
# ---------------------------------------------------------------------------

def _trunc_normal(shape, generator: torch.Generator) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)


def init_cnn(
    cfg: CNNConfig, generator: torch.Generator, device="cpu"
) -> Dict[str, torch.Tensor]:
    """Truncated normal (±2 std) conv/head weights scaled by sqrt(2/fan_in)
    (sqrt(1/cin) for the head), BN gamma 1 and beta 0, with the reference's
    keys in its order.  Drawn on the CPU from ``generator``, so a seed gives
    the same init on any device."""
    params: Dict[str, torch.Tensor] = {}

    def add_conv(name, k, cin, cout):
        params[f"{name}/w"] = _trunc_normal((k, k, cin, cout), generator) * np.sqrt(2.0 / (k * k * cin))
        params[f"{name}/bn_g"] = torch.ones(cout)
        params[f"{name}/bn_b"] = torch.zeros(cout)
        return cout

    if cfg.kind == "vgg":
        cin = 3
        for i, width in enumerate(e for e in cfg.plan if e != "M"):
            cin = add_conv(f"conv{i}", 3, cin, int(width))
    else:
        cin = add_conv("stem", 3, 3, cfg.stem)
        for pre, bcin, width, out_w, _ in _blocks(cfg):
            for c, k, ci, co in _block_convs(cfg, bcin, width, out_w):
                add_conv(f"{pre}/{c}", k, ci, co)
            cin = out_w
    params["fc/w"] = _trunc_normal((cin, cfg.num_classes), generator) * np.sqrt(1.0 / cin)
    params["fc/b"] = torch.zeros(cfg.num_classes)
    return {k: v.to(device) for k, v in params.items()}


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of JAX's "SAME" along one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kh: int, kw: int, stride: int):
    """``x [N, C, H, W]`` and the symmetric ``padding`` to hand the conv or
    unfold; uneven SAME padding is applied here with ``F.pad``."""
    (top, bottom), (left, right) = (_same_pads(x.shape[-2], kh, stride),
                                    _same_pads(x.shape[-1], kw, stride))
    if top == bottom and left == right:
        return x, (top, left)
    return F.pad(x, (left, right, top, bottom)), (0, 0)


def _conv_dense(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME conv of every worker row as one grouped conv.
    x [B, n, C, H, W], w [B, kh, kw, cin, cout] -> [B, n, cout, Ho, Wo]."""
    B, n, C, H, Wd = x.shape
    kh, kw, cin, cout = w.shape[1:]
    xi, pad = _pad_same(x.transpose(0, 1).reshape(n, B * C, H, Wd), kh, kw, stride)
    wt = w.permute(0, 4, 3, 1, 2).reshape(B * cout, cin, kh, kw)
    y = F.conv2d(xi, wt, stride=stride, padding=pad, groups=B)
    return y.reshape(n, B, cout, *y.shape[-2:]).transpose(0, 1)


def _conv_block_skip(x, w, in_vec, out_vec, stride, blocks):
    """SAME conv as im2col patches times a block-skip masked matmul.

    ``F.unfold`` emits K channel-major (cin * kh * kw, taps minor), so the
    per-channel ``in_vec`` repeats over the kh*kw taps and a pruned channel
    prefix is a contiguous K prefix.  A 1x1 conv pads nothing under SAME, so
    its patches are the strided input itself, channels last."""
    B, n, C, H, Wd = x.shape
    kh, kw, cin, cout = w.shape[1:]
    if kh == kw == 1:
        xs = x[..., ::stride, ::stride]
        Ho, Wo = xs.shape[-2:]
        p = xs.permute(0, 1, 3, 4, 2).reshape(B, n * Ho * Wo, C)
    else:
        x4, pad = _pad_same(x.reshape(B * n, C, H, Wd), kh, kw, stride)
        Ho, Wo = -(-H // stride), -(-Wd // stride)
        p = F.unfold(x4, (kh, kw), padding=pad, stride=stride)
        p = p.transpose(1, 2).reshape(B, n * Ho * Wo, C * kh * kw)
    wmat = w.permute(0, 3, 1, 2, 4).reshape(B, cin * kh * kw, cout)
    ones = lambda m: torch.ones((B, m), device=x.device, dtype=torch.float32)
    in_mask = ones(cin * kh * kw) if in_vec is None else torch.repeat_interleave(
        in_vec.float(), kh * kw, dim=-1
    )
    out_mask = ones(cout) if out_vec is None else out_vec.float()
    y = pruned_matmul(
        p, wmat, in_mask, out_mask,
        block_m=blocks[0], block_n=blocks[1], block_k=blocks[2],
    )
    return y.reshape(B, n, Ho, Wo, cout).permute(0, 1, 4, 2, 3)


def _bn(x, g, b, eps=1e-5):
    """Batch-statistics BN per worker row: x [B, n, C, H, W], g/b [B, C]."""
    mu = x.mean(dim=(1, 3, 4), keepdim=True)
    var = x.var(dim=(1, 3, 4), correction=0, keepdim=True)
    shp = (g.shape[0], 1, g.shape[1], 1, 1)
    return (x - mu) * torch.rsqrt(var + eps) * g.reshape(shp) + b.reshape(shp)


def conv_mask_wiring(cfg: CNNConfig) -> Dict[str, Tuple[Optional[str], Optional[str]]]:
    """conv/head name -> (input unit layer, output unit layer), ``None`` for
    an unpruned side: a conv's out-mask is its own unit layer, its in-mask
    its producer's.  (Every ResNet block lists an ``sc`` entry, as the
    reference's does, whether or not the block has that conv.)"""
    wiring: Dict[str, Tuple[Optional[str], Optional[str]]] = {}
    if cfg.kind == "vgg":
        convs = [e for e in cfg.plan if e != "M"]
        for i in range(len(convs)):
            wiring[f"conv{i}"] = (f"conv{i-1}" if i > 0 else None, f"conv{i}")
        wiring["fc"] = (f"conv{len(convs)-1}" if convs else None, None)
        return wiring
    wiring["stem"] = (None, None)
    for pre, *_ in _blocks(cfg):
        wiring[f"{pre}/c1"] = (None, f"{pre}/c1")
        if cfg.bottleneck:
            wiring[f"{pre}/c2"] = (f"{pre}/c1", f"{pre}/c2")
            wiring[f"{pre}/c3"] = (f"{pre}/c2", None)
        else:
            wiring[f"{pre}/c2"] = (f"{pre}/c1", None)
        wiring[f"{pre}/sc"] = (None, None)
    wiring["fc"] = (None, None)
    return wiring


def prunable_layer_names(cfg: CNNConfig) -> Tuple[str, ...]:
    """Unit-layer names of the prunable convs, in network order."""
    return tuple(name for name, _, _ in _prunable_convs(cfg))


def cnn_apply(
    params: Mapping[str, torch.Tensor],
    cfg: CNNConfig,
    x: torch.Tensor,
    stats: Optional[Dict[str, torch.Tensor]] = None,
    compute: str = "dense",
    unit_masks: Optional[Mapping[str, torch.Tensor]] = None,
    blocks: Tuple[int, int, int] = (128, 128, 128),
) -> torch.Tensor:
    """x ``[n, H, W, 3]`` -> logits ``[n, classes]``; or, for worker stacks,
    params ``[B, ...]`` and x ``[B, n, H, W, 3]`` -> ``[B, n, classes]``.

    If ``stats`` (a dict) is given, each prunable conv's mean |activation|
    per filter after its ReLU (``[C]``, or ``[B, C]`` for stacks) is
    recorded into it: the HRank-style importance signal.

    ``compute="block_skip"`` dispatches every conv and the head through the
    block-skip kernel with ``unit_masks`` ({prunable layer: [width] or
    [B, width] 0/1}) wired along ``conv_mask_wiring`` — the same function as
    the dense path on masked params, with fully pruned blocks skipped."""
    if compute not in ("dense", "block_skip"):
        raise ValueError(f"unknown compute path {compute!r}")
    batched = x.dim() == 5
    if not batched:
        params = {k: v.unsqueeze(0) for k, v in params.items()}
        x = x.unsqueeze(0)
        unit_masks = {k: v.reshape(1, -1) for k, v in (unit_masks or {}).items()}
    bs = compute == "block_skip"
    wiring = conv_mask_wiring(cfg) if bs else {}
    um = unit_masks or {}
    recorded: Dict[str, torch.Tensor] = {}

    def mask_vec(lname):
        return None if lname is None else um.get(lname)

    def cbr(name, h, stride=1, relu=True):
        w = params[f"{name}/w"]
        if bs:
            in_l, out_l = wiring[name]
            h = _conv_block_skip(h, w, mask_vec(in_l), mask_vec(out_l), stride, blocks)
        else:
            h = _conv_dense(h, w, stride)
        h = _bn(h, params[f"{name}/bn_g"], params[f"{name}/bn_b"])
        return torch.relu(h) if relu else h

    def rec(name, h):
        if stats is not None:
            recorded[name] = h.abs().mean(dim=(1, 3, 4))
        return h

    h = x.permute(0, 1, 4, 2, 3)          # NHWC -> NCHW per worker row
    if cfg.kind == "vgg":
        i = 0
        for entry in cfg.plan:
            if entry == "M":
                B, n, C, H, Wd = h.shape
                h = F.max_pool2d(h.reshape(B * n, C, H, Wd), 2, 2).reshape(B, n, C, H // 2, Wd // 2)
                continue
            h = rec(f"conv{i}", cbr(f"conv{i}", h))
            i += 1
    else:
        h = cbr("stem", h)
        for pre, _, _, _, stride in _blocks(cfg):
            r = rec(f"{pre}/c1", cbr(f"{pre}/c1", h, stride))
            if cfg.bottleneck:
                r = rec(f"{pre}/c2", cbr(f"{pre}/c2", r))
                r = cbr(f"{pre}/c3", r, relu=False)
            else:
                r = cbr(f"{pre}/c2", r, relu=False)
            if f"{pre}/sc/w" in params:
                h = cbr(f"{pre}/sc", h, stride, relu=False)
            elif stride != 1:
                h = h[:, :, :, ::stride, ::stride]
            h = torch.relu(h + r)
    if stats is not None:
        stats.update(recorded if batched else {k: v[0] for k, v in recorded.items()})
    feat = h.mean(dim=(3, 4))             # [B, n, C]
    if bs:
        in_l, _ = wiring["fc"]
        fc_in = mask_vec(in_l)
        B, _, C = feat.shape
        ncls = params["fc/w"].shape[-1]
        logits = pruned_matmul(
            feat, params["fc/w"],
            torch.ones((B, C), device=feat.device) if fc_in is None else fc_in.float(),
            torch.ones((B, ncls), device=feat.device),
            block_m=blocks[0], block_n=blocks[1], block_k=blocks[2],
        ) + params["fc/b"].unsqueeze(1)
    else:
        logits = feat @ params["fc/w"] + params["fc/b"].unsqueeze(1)
    return logits if batched else logits[0]


# ---------------------------------------------------------------------------
# FLOPs and the block-skip ledger (host)
# ---------------------------------------------------------------------------

def cnn_flops(params: Mapping, cfg: CNNConfig) -> float:
    """Per-image forward FLOPs of the (possibly reconfigured) model."""
    return cnn_flops_from_shapes({k: tuple(v.shape) for k, v in params.items()}, cfg)


def cnn_flops_from_shapes(shapes: Mapping[str, tuple], cfg: CNNConfig) -> float:
    """``cnn_flops`` from shape tuples alone: each conv at its base output
    size with its (reconfigured) weight shape, plus the head."""
    total = 0.0
    for name, _, _, _, hw in _base_conv_geoms(cfg)[:-1]:
        total += 2.0 * hw * hw * int(np.prod(shapes[f"{name}/w"]))
    total += 2.0 * int(np.prod(shapes["fc/w"]))
    return total


def _base_conv_geoms(cfg: CNNConfig) -> List[Tuple[str, int, int, int, int]]:
    """[(name, ksize, cin, cout, hw)] per conv at base shapes (hw the output
    side), plus the ("fc", 1, cin, classes, 1) head: the per-image matmul
    geometry."""
    out: List[Tuple[str, int, int, int, int]] = []
    hw = cfg.image_size
    if cfg.kind == "vgg":
        cin, i = 3, 0
        for entry in cfg.plan:
            if entry == "M":
                hw //= 2
            else:
                out.append((f"conv{i}", 3, cin, int(entry), hw))
                cin, i = int(entry), i + 1
    else:
        out.append(("stem", 3, 3, cfg.stem, hw))
        cin = cfg.stem
        for pre, bcin, width, out_w, stride in _blocks(cfg):
            hw //= stride
            for c, k, ci, co in _block_convs(cfg, bcin, width, out_w):
                out.append((f"{pre}/{c}", k, ci, co, hw))
            cin = out_w
    out.append(("fc", 1, cin, cfg.num_classes, 1))
    return out


def cnn_block_compute(
    cfg: CNNConfig,
    unit_masks: Mapping[str, np.ndarray],
    blocks: Tuple[int, int, int] = (128, 128, 128),
) -> Dict[str, float]:
    """Host-side count of what the ``block_skip`` dispatch executes per
    image: ``{"flops", "blocks", "blocks_total"}`` — forward multiply-adds
    over the kept K/N blocks, the executed block cells, and the cells a
    never-skipping dispatch would run."""
    from repro_torch.kernels.pruned_matmul import (
        matmul_executed_blocks,
        matmul_executed_flops,
    )

    bm, bn, bk = blocks
    wiring = conv_mask_wiring(cfg)
    flops = 0.0
    cells = 0
    cells_total = 0
    for name, ks, cin, cout, hw in _base_conv_geoms(cfg):
        in_l, out_l = wiring[name]
        in_vec = unit_masks.get(in_l) if in_l is not None else None
        out_vec = unit_masks.get(out_l) if out_l is not None else None
        in_mask = (
            np.ones(cin * ks * ks, np.float32) if in_vec is None
            else np.repeat(np.asarray(in_vec, np.float32), ks * ks)
        )
        out_mask = np.ones(cout, np.float32) if out_vec is None else np.asarray(out_vec, np.float32)
        M = hw * hw
        flops += matmul_executed_flops(M, in_mask, out_mask, block_m=bm, block_n=bn, block_k=bk)
        cells += matmul_executed_blocks(M, in_mask, out_mask, block_m=bm, block_n=bn, block_k=bk)
        cells_total += matmul_executed_blocks(
            M, np.ones_like(in_mask), np.ones_like(out_mask),
            block_m=bm, block_n=bn, block_k=bk,
        )
    return {"flops": flops, "blocks": float(cells), "blocks_total": float(cells_total)}


# ---------------------------------------------------------------------------
# prunable unit metadata
# ---------------------------------------------------------------------------

def _prunable_convs(cfg: CNNConfig) -> List[Tuple[str, int, str]]:
    """[(conv_name, width, next_consumer)] of the convs whose output filters
    prune: every VGG conv; a ResNet block's interior convs only."""
    if cfg.kind == "vgg":
        convs = [e for e in cfg.plan if e != "M"]
        return [
            (f"conv{i}", int(w), f"conv{i+1}" if i + 1 < len(convs) else "fc")
            for i, w in enumerate(convs)
        ]
    out = []
    for pre, _, width, _, _ in _blocks(cfg):
        out.append((f"{pre}/c1", width, f"{pre}/c2"))
        if cfg.bottleneck:
            out.append((f"{pre}/c2", width, f"{pre}/c3"))
    return out


def build_unit_space(cfg: CNNConfig, params: Mapping) -> Tuple[UnitSpace, Dict[str, list]]:
    """Returns (UnitSpace, unit_map path -> [(unit_layer, axis)]); only the
    params' shapes are read (numpy arrays or tensors)."""
    unit_map: Dict[str, list] = {}
    layers = []
    for name, width, nxt in _prunable_convs(cfg):
        kh, kw, cin, cout = params[f"{name}/w"].shape
        # per-filter cost: own kernel column + bn(2) + consumer input slice
        cost = kh * kw * cin + 2
        if nxt == "fc":
            cost += params["fc/w"].shape[1]
        else:
            nw = params[f"{nxt}/w"].shape
            cost += nw[0] * nw[1] * nw[3]
        layers.append(UnitLayer(name=name, num_units=cout, unit_param_cost=int(cost), min_units=2))
        unit_map.setdefault(f"{name}/w", []).append((name, 3))
        unit_map.setdefault(f"{name}/bn_g", []).append((name, 0))
        unit_map.setdefault(f"{name}/bn_b", []).append((name, 0))
        if nxt == "fc":
            unit_map.setdefault("fc/w", []).append((name, 0))
        else:
            unit_map.setdefault(f"{nxt}/w", []).append((name, 2))
    total = sum(int(np.prod(tuple(v.shape))) for v in params.values())
    prunable_mass = sum(l.num_units * l.unit_param_cost for l in layers)
    return UnitSpace(layers=tuple(layers), fixed_params=total - prunable_mass), unit_map


def extract_bn_scales(params: Mapping[str, torch.Tensor], cfg: CNNConfig) -> Dict[str, np.ndarray]:
    """|BN gamma| per prunable filter, float64 — the CIG-BNscalor signal."""
    return {
        name: np.abs(params[f"{name}/bn_g"].detach().cpu().numpy().astype(np.float64))
        for name, _, _ in _prunable_convs(cfg)
    }
