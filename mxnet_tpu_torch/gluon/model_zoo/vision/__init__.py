"""Vision model zoo (``mxnet_tpu/gluon/model_zoo/vision``): all 34 nets of
the JAX zoo -- AlexNet, DenseNet 121-201, Inception v3, MobileNet v1 / v2
at four widths, ResNet v1 / v2 at depths 18-152, SqueezeNet 1.0 / 1.1
and VGG 11-19 with and without BatchNorm -- with the JAX package's
module trees, so parameter names and shapes are its own and weights
cross by name (``load_parameters``, ``convert.load_params``).  No
weights are downloaded (``pretrained=True`` raises); construct, then
``initialize`` or load.
"""
from .alexnet import AlexNet, alexnet  # noqa: F401
from .densenet import (DenseNet, densenet121, densenet161,  # noqa: F401
                       densenet169, densenet201)
from .inception import Inception3, inception_v3  # noqa: F401
from .mobilenet import (MobileNet, MobileNetV2, mobilenet0_5,  # noqa: F401
                        mobilenet0_25, mobilenet0_75, mobilenet1_0,
                        mobilenet_v2_0_5, mobilenet_v2_0_25,
                        mobilenet_v2_0_75, mobilenet_v2_1_0)
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1,  # noqa: F401
                     BottleneckV2, ResNetV1, ResNetV2, get_resnet,
                     resnet18_v1, resnet18_v2, resnet34_v1, resnet34_v2,
                     resnet50_v1, resnet50_v2, resnet101_v1, resnet101_v2,
                     resnet152_v1, resnet152_v2)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1  # noqa: F401
from .vgg import (VGG, vgg11, vgg11_bn, vgg13, vgg13_bn, vgg16,  # noqa: F401
                  vgg16_bn, vgg19, vgg19_bn)

_models = {
    "alexnet": alexnet,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "inceptionv3": inception_v3,
    "mobilenet0.25": mobilenet0_25, "mobilenet0.5": mobilenet0_5,
    "mobilenet0.75": mobilenet0_75, "mobilenet1.0": mobilenet1_0,
    "mobilenetv2_0.25": mobilenet_v2_0_25, "mobilenetv2_0.5": mobilenet_v2_0_5,
    "mobilenetv2_0.75": mobilenet_v2_0_75, "mobilenetv2_1.0": mobilenet_v2_1_0,
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
}


def get_model(name, **kwargs):
    """A zoo model by name (``model_zoo/vision/__init__.py`` get_model);
    ``kwargs`` go to its factory."""
    name = name.lower()
    if name not in _models:
        raise ValueError("Model %s not supported. Available: %s"
                         % (name, sorted(_models)))
    return _models[name](**kwargs)
