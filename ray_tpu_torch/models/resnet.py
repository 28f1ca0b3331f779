"""ResNet family (bottleneck blocks) in PyTorch.

Port of `ray_tpu/models/resnet.py`, with the Flax layers' arithmetic:

- images come NHWC, as the JAX signature takes them; inside, the
  activations are NCHW views in torch's `channels_last` memory format (the
  same bytes as NHWC) and convolutions are `F.conv2d` with OIHW kernels
  (`convert` transposes the Flax HWIO kernels), no bias, in `cfg.dtype`;
- padding is Flax's "SAME": (lo, hi) = (floor(p / 2), ceil(p / 2)) of the
  total p, which differs from torch's symmetric padding at stride 2 (the
  7x7/2 stem pads (2, 3) at an even size, a 3x3/2 conv (0, 1)), so every
  convolution and the 3x3/2 max-pool (padded with -inf) pad explicitly;
- BatchNorm is `flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5,
  dtype=float32)`: statistics in f32 over (N, H, W) with the fast
  variance E[x^2] - E[x]^2 clipped at 0, the output in f32, and in train
  mode the running statistics updated as `0.9 * ra + 0.1 * batch` with
  the biased variance (`F.batch_norm` would take the unbiased one and the
  other momentum), written here by hand.

The running statistics are buffers (`{name}.mean`, `{name}.var`, the
Flax `batch_stats`), updated in place by a train-mode forward (also inside
a captured CUDA graph); `forward(images, train=True)` is the JAX
`apply(..., train=True, mutable=["batch_stats"])`. Parameter names follow
the Flax tree (`stem.weight`, `stem_bn.scale`,
`stage{s}_block{b}.conv1.weight`, `head.weight`).

Sharded (`sharded_loss`) over the data axes and fsdp, with tp on the
head, as GSPMD shards the annotated Flax model (`param_logical_axes`):
each conv kernel's output channels ("embed") gathered at use, BatchNorm
normalising by the global batch's statistics (its sums all-reduced over
the axes that split the batch), the class head vocab-parallel over tp.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import gpt
from ray_tpu_torch.models.gpt import Dense
from ray_tpu_torch.parallel import collectives

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Sequence[int] = (3, 4, 6, 3)  # ResNet-50
    num_classes: int = 1000
    width: int = 64
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    small_images: bool = False  # CIFAR stem (3x3, no max-pool)

    @classmethod
    def resnet18(cls, **kw):
        return cls(stage_sizes=(2, 2, 2, 2), **kw)

    @classmethod
    def resnet50(cls, **kw):
        return cls(stage_sizes=(3, 4, 6, 3), **kw)


def same_padding(size: int, kernel: int, stride: int):
    """Flax/XLA "SAME" padding of one spatial dimension: (lo, hi)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kernel: int, stride: int, value: float = 0.0):
    (t, b), (l, r) = (same_padding(n, kernel, stride)
                      for n in x.shape[2:])
    if t == b == l == r == 0:
        return x
    return F.pad(x, (l, r, t, b), value=value)


class Conv(nn.Module):
    """`nn.Conv(features, (k, k), stride, padding="SAME", use_bias=False,
    dtype=dtype)`: the kernel [out, in, k, k] cast to `dtype` at use."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, dtype):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.weight = nn.Parameter(
            torch.empty(cout, cin, kernel, kernel, dtype=dtype))

    def forward(self, x):
        x = _pad_same(x.to(self.dtype), self.kernel, self.stride)
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride)


class BatchNorm(nn.Module):
    """`flax.linen.BatchNorm` as the JAX model configures it (module
    docstring): f32 out; `train` normalises with the batch's statistics
    and updates the running ones."""

    def __init__(self, features: int, param_dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(features, dtype=param_dtype))
        self.register_buffer("mean", torch.zeros(features,
                                                 dtype=torch.float32))
        self.register_buffer("var", torch.ones(features,
                                               dtype=torch.float32))

    def forward(self, x, train: bool, spmd=None):
        x = x.float()
        if train:
            mean, var = _batch_stats(x, spmd)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean
                                + (1 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var
                               + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + BN_EPS) * self.scale.float()
        return (x - mean.view(shape)) * mul.view(shape) \
            + self.bias.float().view(shape)


def _batch_stats(x, spmd=None):
    """The batch's mean and fast variance over (N, H, W), in f32. Given a
    sharded forward's `spmd`, those of the global batch: the sums are
    all-reduced over the axes that split the batch, forward and backward
    (each rank's loss is its share, and every share reads the global
    statistics)."""
    if spmd is None or spmd.mesh.axis_size(spmd.batch_axes) == 1:
        mean = x.mean(dim=(0, 2, 3))
        return mean, torch.clamp(torch.square(x).mean(dim=(0, 2, 3))
                                 - torch.square(mean), min=0.0)
    axes, mesh = spmd.batch_axes, spmd.mesh
    n = x.shape[0] * x.shape[2] * x.shape[3] * mesh.axis_size(axes)
    sums = torch.stack([x.sum(dim=(0, 2, 3)),
                        torch.square(x).sum(dim=(0, 2, 3))])
    sums = collectives.allreduce(
        collectives.replicated_input(sums, axes, mesh=mesh), axes,
        mesh=mesh) / n
    return sums[0], torch.clamp(sums[1] - torch.square(sums[0]), min=0.0)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (the stride) -> 1x1 (4x features), with a projected
    shortcut where the shape changes."""

    def __init__(self, cfg: ResNetConfig, cin: int, features: int,
                 strides: int = 1):
        super().__init__()
        dt, pdt = cfg.dtype, cfg.param_dtype
        self.conv1 = Conv(cin, features, 1, 1, dt)
        self.bn1 = BatchNorm(features, pdt)
        self.conv2 = Conv(features, features, 3, strides, dt)
        self.bn2 = BatchNorm(features, pdt)
        self.conv3 = Conv(features, 4 * features, 1, 1, dt)
        self.bn3 = BatchNorm(4 * features, pdt)
        # the JAX block projects when the residual's shape differs from
        # the output's: another channel count or a stride
        self.project = cin != 4 * features or strides != 1
        if self.project:
            self.conv_proj = Conv(cin, 4 * features, 1, strides, dt)
            self.bn_proj = BatchNorm(4 * features, pdt)

    def forward(self, x, train: bool, spmd=None, prefix: str = ""):
        """With a sharded forward's `spmd` the kernels are gathered at use
        (their names under `prefix`) and BatchNorm reads the global
        batch's statistics."""
        conv = partial(_conv, self, spmd, prefix)
        y = F.relu(self.bn1(conv("conv1", x), train, spmd))
        y = F.relu(self.bn2(conv("conv2", y), train, spmd))
        y = self.bn3(conv("conv3", y), train, spmd)
        residual = x
        if self.project:
            residual = self.bn_proj(conv("conv_proj", x), train, spmd)
        return F.relu(residual + y)


def _conv(parent, spmd, prefix: str, name: str, x):
    """`parent`'s Conv `name` on x; under a sharded forward its kernel
    gathered over the axes that split it."""
    mod = getattr(parent, name)
    if spmd is None:
        return mod(x)
    w = spmd.param(prefix + name + ".weight", mod.weight, mod.dtype)
    x = _pad_same(x.to(mod.dtype), mod.kernel, mod.stride)
    return F.conv2d(x, w, stride=mod.stride)


class ResNet(nn.Module):
    """images [B, H, W, C] (NHWC) -> class logits [B, num_classes] (f32).
    `train=True` uses and updates the batch statistics."""

    def __init__(self, config: ResNetConfig, channels: int = 3):
        super().__init__()
        cfg = self.config = config
        dt = cfg.dtype
        if cfg.small_images:
            self.stem = Conv(channels, cfg.width, 3, 1, dt)
        else:
            self.stem = Conv(channels, cfg.width, 7, 2, dt)
        self.stem_bn = BatchNorm(cfg.width, cfg.param_dtype)
        cin = cfg.width
        for stage, n_blocks in enumerate(cfg.stage_sizes):
            for block in range(n_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                features = cfg.width * 2 ** stage
                self.add_module(f"stage{stage}_block{block}",
                                Bottleneck(cfg, cin, features, strides))
                cin = 4 * features
        self.head = Dense(cin, cfg.num_classes, dt)

    @classmethod
    def from_params(cls, config: ResNetConfig,
                    variables: Dict[str, torch.Tensor],
                    trainable: bool = False):
        """A model over `variables` (parameters and running statistics,
        `init_variables` or `convert.resnet_variables_from_jax`), sharing
        their storage."""
        with torch.device("meta"):
            net = cls(config, channels=variables["stem.weight"].shape[1])
        return gpt.load_params(net, variables, trainable)

    def blocks(self):
        return [getattr(self, f"stage{s}_block{b}")
                for s, n in enumerate(self.config.stage_sizes)
                for b in range(n)]

    def forward(self, images, train: bool = True):
        return self.head(self.features(images, train)).float()

    def features(self, images, train: bool = True, spmd=None):
        """The pooled features [B, channels] in `cfg.dtype` (under a
        sharded forward's `spmd`: its kernels gathered at use, BatchNorm on
        the global batch's statistics)."""
        cfg = self.config
        x = images.to(cfg.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = F.relu(self.stem_bn(_conv(self, spmd, "", "stem", x), train,
                                spmd))
        if not cfg.small_images:
            x = F.max_pool2d(_pad_same(x, 3, 2, -math.inf), 3, stride=2)
        for name, blk in self.named_children():
            if name.startswith("stage"):
                x = blk(x, train, spmd, name + ".")
        return x.mean(dim=(2, 3)).to(cfg.dtype)


def init_variables(cfg: ResNetConfig, generator: torch.Generator,
                   device=None, dtype: Optional[torch.dtype] = None,
                   channels: int = 3) -> Dict[str, torch.Tensor]:
    """Fresh parameters and running statistics with the Flax model's init
    distributions: conv kernels normal(sqrt(2 / fan_out)) (fan_out = out
    channels x k x k), BatchNorm scale one, bias zero, mean zero, var one,
    the head's kernel normal(0.01) and bias zero. Convs and the head are
    in `dtype` (default `cfg.dtype`), the BatchNorm in `cfg.param_dtype`,
    its statistics in f32."""
    device = resolve_device(device)
    dt = dtype or cfg.dtype
    with torch.device("meta"):
        shapes = ResNet(cfg, channels).state_dict()
    out = {}
    for name, meta in shapes.items():
        shape = tuple(meta.shape)
        if name.endswith(".weight") and len(shape) == 4:
            std = math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
            out[name] = gpt._normal(shape, std, generator, device, dt)
        elif name == "head.weight":
            out[name] = gpt._normal(shape, 0.01, generator, device, dt)
        elif name == "head.bias":
            out[name] = torch.zeros(shape, dtype=dt, device=device)
        elif name.endswith((".scale", ".var")):
            out[name] = torch.ones(shape, dtype=meta.dtype, device=device)
        else:  # BatchNorm bias and mean
            out[name] = torch.zeros(shape, dtype=meta.dtype, device=device)
    return out


def param_logical_axes(cfg: ResNetConfig, channels: int = 3
                       ) -> Dict[str, tuple]:
    """Each parameter's (and running statistic's) logical axes in the torch
    tensor's dimension order: the conv kernels' output channels "embed"
    (the Flax HWIO kernel's last axis), BatchNorm's scale and bias
    ("norm",), its running statistics unannotated, the head ("embed",
    "vocab") reversed."""
    with torch.device("meta"):
        shapes = ResNet(cfg, channels).state_dict()
    axes = {}
    for name, meta in shapes.items():
        if name == "head.weight":
            axes[name] = ("vocab", "embed")
        elif name == "head.bias":
            axes[name] = ("vocab",)
        elif meta.dim() == 4:
            axes[name] = ("embed", None, None, None)
        elif name.endswith((".scale", ".bias")):
            axes[name] = ("norm",)
        else:  # the running mean and var (the Flax batch_stats)
            axes[name] = (None,)
    return axes


def sharded_loss(model: ResNet, images, labels, mesh, shardings,
                 train: bool = True):
    """This rank's share of the global batch's mean softmax cross-entropy
    on its images [B / data ranks, H, W, C] (`gpt.global_loss` sums the
    shares, `gpt.reduce_gradients` completes the gradients): the conv
    kernels' `embed` shards gathered at use, BatchNorm on the global
    batch's statistics (so the running statistics are the same on every
    rank), the head vocab-parallel over tp (`gpt.sharded_class_loss`)."""
    cfg = model.config
    spmd = gpt._Spmd(mesh, shardings)
    x = spmd.tp_input(model.features(images, train, spmd))
    logits = F.linear(x, spmd.param("head.weight", model.head.weight,
                                    cfg.dtype),
                      spmd.param("head.bias", model.head.bias, cfg.dtype))
    return gpt.sharded_class_loss(logits.float(), labels, spmd)

