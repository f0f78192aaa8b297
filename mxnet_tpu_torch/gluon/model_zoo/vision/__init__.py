"""Vision model zoo (``mxnet_tpu/gluon/model_zoo/vision``).

The ResNets (v1 and v2, depths 18-152) are ported.  The other nets of
the JAX zoo -- AlexNet, DenseNet, Inception v3, MobileNet v1/v2,
SqueezeNet and VGG -- wait for ROADMAP queue 2: :func:`get_model`
raises ``NotImplementedError`` for them.  No weights are downloaded
(``pretrained=True`` raises); construct, ``initialize`` or load.
"""
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1,  # noqa: F401
                     BottleneckV2, ResNetV1, ResNetV2, get_resnet,
                     resnet18_v1, resnet18_v2, resnet34_v1, resnet34_v2,
                     resnet50_v1, resnet50_v2, resnet101_v1, resnet101_v2,
                     resnet152_v1, resnet152_v2)

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
}

_NOT_PORTED = (
    "alexnet", "densenet121", "densenet161", "densenet169", "densenet201",
    "inceptionv3", "mobilenet0.25", "mobilenet0.5", "mobilenet0.75",
    "mobilenet1.0", "mobilenetv2_0.25", "mobilenetv2_0.5",
    "mobilenetv2_0.75", "mobilenetv2_1.0", "squeezenet1.0",
    "squeezenet1.1", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn",
    "vgg13_bn", "vgg16_bn", "vgg19_bn")


def get_model(name, **kwargs):
    """A zoo model by name (``model_zoo/vision/__init__.py`` get_model)."""
    name = name.lower()
    if name in _NOT_PORTED:
        raise NotImplementedError("mxnet_tpu_torch: model %s is not ported "
                                  "yet (ROADMAP queue 2, the vision zoo)"
                                  % name)
    if name not in _models:
        raise ValueError("Model %s not supported. Available: %s"
                         % (name, sorted(_models)))
    return _models[name](**kwargs)
