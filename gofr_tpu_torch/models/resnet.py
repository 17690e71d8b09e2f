"""ResNet-50 (v1.5) for the ``/classify`` serving path (counterpart of
``gofr_tpu/models/resnet.py``).

- Input (B, H, W, 3), as JAX's NHWC. The model permutes it to an NCHW
  view, which is ``channels_last`` in memory, so no copy is made; conv
  weights are OIHW in ``channels_last`` (the converter turns JAX's HWIO
  kernels around), so cuDNN runs every conv NHWC on the tensor cores.
- Symmetric ``k // 2`` padding on every conv (JAX's deliberate torch
  semantics, not "SAME"), the stride on the 3x3 of a bottleneck (v1.5),
  inference BatchNorm folded to ``y * scale + shift`` in the weights'
  dtype, the 3x3 / 2 max-pool padded with -inf by 1, the global mean
  over H and W in float32 then cast back, logits in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Union

import torch
import torch.nn.functional as F

from gofr_tpu_torch.device import resolve_device

__all__ = ["PRESETS", "ResNetConfig", "apply", "config", "init"]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple = (3, 4, 6, 3)           # ResNet-50
    num_classes: int = 1000
    width: int = 64
    image_size: int = 224
    dtype: Any = torch.bfloat16


PRESETS = {
    "tiny": ResNetConfig(stage_sizes=(1, 1, 1, 1), width=8, image_size=32,
                         num_classes=10),
    "50": ResNetConfig(),
}


def config(preset: str = "50", **overrides) -> ResNetConfig:
    return dataclasses.replace(PRESETS[preset], **overrides)


def _conv(x: torch.Tensor, p: Dict[str, torch.Tensor],
          stride: int = 1) -> torch.Tensor:
    kh, kw = p["w"].shape[2:]
    y = F.conv2d(x, p["w"], stride=stride, padding=(kh // 2, kw // 2))
    return y * p["scale"][:, None, None] + p["shift"][:, None, None]


def init(cfg: ResNetConfig, seed: int = 0,
         device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Random params drawn on ``device`` from a seeded generator (He
    normal convs, folded BatchNorm at identity, a 1/sqrt(fan_in) head),
    in JAX's tree: ``stem``, ``stages`` (a list of blocks a stage, each
    ``conv1..3`` and a ``proj`` where the shape changes), ``head``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    dt = cfg.dtype

    def conv(kh, kw, c_in, c_out):
        w = torch.randn((c_out, c_in, kh, kw), generator=gen, device=dev)
        w = (w * math.sqrt(2.0 / (kh * kw * c_in))).to(dt)
        return {"w": w.contiguous(memory_format=torch.channels_last),
                "scale": torch.ones((c_out,), dtype=dt, device=dev),
                "shift": torch.zeros((c_out,), dtype=dt, device=dev)}

    params: Dict[str, Any] = {"stem": conv(7, 7, 3, cfg.width)}
    c_in = cfg.width
    stages: List[Any] = []
    for stage_idx, n_blocks in enumerate(cfg.stage_sizes):
        c_mid = cfg.width * (2 ** stage_idx)
        c_out = c_mid * 4
        blocks = []
        for block_idx in range(n_blocks):
            stride = 2 if (stage_idx > 0 and block_idx == 0) else 1
            block = {"conv1": conv(1, 1, c_in, c_mid),
                     "conv2": conv(3, 3, c_mid, c_mid),
                     "conv3": conv(1, 1, c_mid, c_out)}
            if stride != 1 or c_in != c_out:
                block["proj"] = conv(1, 1, c_in, c_out)
            blocks.append(block)
            c_in = c_out
        stages.append(blocks)
    params["stages"] = stages
    head = torch.randn((c_in, cfg.num_classes), generator=gen, device=dev)
    params["head"] = {"w": (head / math.sqrt(c_in)).to(dt),
                      "b": torch.zeros((cfg.num_classes,), dtype=dt,
                                       device=dev)}
    return params


def _bottleneck(x: torch.Tensor, block: Dict[str, Any],
                stride: int) -> torch.Tensor:
    residual = x
    y = F.relu(_conv(x, block["conv1"], 1))
    y = F.relu(_conv(y, block["conv2"], stride))
    y = _conv(y, block["conv3"], 1)
    if "proj" in block:
        residual = _conv(x, block["proj"], stride)
    return F.relu(y + residual)


def apply(params: Dict[str, Any], cfg: ResNetConfig,
          images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, 3) -> logits (B, num_classes) float32."""
    x = images.to(cfg.dtype).permute(0, 3, 1, 2)    # NCHW, channels_last
    x = F.relu(_conv(x, params["stem"], stride=2))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for stage_idx, blocks in enumerate(params["stages"]):
        for block_idx, block in enumerate(blocks):
            stride = 2 if (stage_idx > 0 and block_idx == 0) else 1
            x = _bottleneck(x, block, stride)
    x = x.float().mean(dim=(2, 3)).to(cfg.dtype)     # global average pool
    logits = x @ params["head"]["w"] + params["head"]["b"]
    return logits.float()
