"""ResNet (BASELINE.json configuration 1: ResNet-50 on ImageNet).

Mirrors ``paddle_tpu/vision/models/resnet.py``: ``BasicBlock``,
``BottleneckBlock``, ``ResNet`` and ``resnet18`` ... ``resnet152``, with
the same topology, module and parameter names (``layer1.0.conv1.weight``,
``layer2.0.downsample.0.weight``, ...) and BatchNorm buffers (``bn1._mean``,
``bn1._variance``), so a state carried across from the JAX model
(``models.load_numpy_state``, buffers included) fills this one name for
name.

BatchNorm trains as the JAX package's eager loop does: the batch's
statistics normalise, and the running statistics are updated in place
(``F.batch_norm``), so a captured training step updates them at every
replay. The JAX package's ``SpmdTrainer`` drops that update (its
``batch_norm`` assigns the buffers while the step is traced; ROADMAP F11);
the port does not follow it there. On the card the convolutions are
cuDNN's and the pools PyTorch ops; every BatchNorm runs the Triton kernels
of ``kernels/batch_norm.py`` with what follows it fused, as XLA fuses it
in the JAX package's step: the stem's and each block's inner BatchNorms
with their ReLU (``bn(conv(x), then="relu")``), each block's last with
the residual add and the ReLU (``bn(conv(out), residual=identity,
then="relu")``). The results are the separate ops' bits, and the
parameter and buffer names those of the JAX model (its ``relu`` modules
hold neither, and the port has none). The JAX package has no Pallas
kernel in this model.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from ... import resolve_device
from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear, MaxPool2D,
                   Sequential)
from ...nn.layer.layers import Layer


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        at = dict(device=device, dtype=dtype, generator=generator)
        if norm_layer is None:
            norm_layer = functools.partial(BatchNorm2D, device=device,
                                           dtype=dtype)
        if dilation > 1:
            raise NotImplementedError("dilation > 1 in BasicBlock")
        self.conv1 = Conv2D(inplanes, planes, 3, padding=1, stride=stride,
                            bias_attr=False, **at)
        self.bn1 = norm_layer(planes)
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            **at)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        out = self.conv2(self.bn1(self.conv1(x), then="relu"))
        identity = x if self.downsample is None else self.downsample(x)
        return self.bn2(out, residual=identity, then="relu")


class BottleneckBlock(Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        at = dict(device=device, dtype=dtype, generator=generator)
        if norm_layer is None:
            norm_layer = functools.partial(BatchNorm2D, device=device,
                                           dtype=dtype)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False, **at)
        self.bn1 = norm_layer(width)
        self.conv2 = Conv2D(width, width, 3, padding=dilation, stride=stride,
                            groups=groups, dilation=dilation, bias_attr=False,
                            **at)
        self.bn2 = norm_layer(width)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, **at)
        self.bn3 = norm_layer(planes * self.expansion)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        out = self.bn2(self.conv2(self.bn1(self.conv1(x), then="relu")),
                       then="relu")
        out = self.conv3(out)
        identity = x if self.downsample is None else self.downsample(x)
        return self.bn3(out, residual=identity, then="relu")


class ResNet(Layer):
    """ResNet of ``block`` at ``depth`` on an explicit ``device`` (None =
    the GPU) in ``dtype`` (float32), its weights drawn from
    ``generator``."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self._at = dict(device=device, dtype=dtype, generator=generator)
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = functools.partial(BatchNorm2D, device=device,
                                             dtype=dtype)
        self.inplanes = 64
        self.dilation = 1

        self.conv1 = Conv2D(3, self.inplanes, kernel_size=7, stride=2,
                            padding=3, bias_attr=False, **self._at)
        self.bn1 = self._norm_layer(self.inplanes)
        self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes, **self._at)

    def _make_layer(self, block, planes, blocks, stride=1, dilate=False):
        norm_layer = self._norm_layer
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, **self._at),
                norm_layer(planes * block.expansion),
            )
        layers = [block(self.inplanes, planes, stride, downsample, self.groups,
                        self.base_width, self.dilation, norm_layer,
                        **self._at)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer, **self._at))
        return Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.bn1(self.conv1(x), then="relu"))
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = torch.flatten(x, 1)
            x = self.fc(x)
        return x


def _resnet(arch, block, depth, pretrained, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not in the repository; load a state "
            "with models.load_numpy_state")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet("resnet18", BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet("resnet34", BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet("resnet50", BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet("resnet101", BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet("resnet152", BottleneckBlock, 152, pretrained, **kwargs)


__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152"]
