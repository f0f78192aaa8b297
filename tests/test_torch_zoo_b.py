"""The port's vision zoo against the JAX package's, part B: SqueezeNet
1.0 / 1.1 (fire modules on ``HybridConcatenate``) and MobileNet v1 / v2
(depthwise convolutions, v2's ReLU6 a ``HybridLambda`` over
``F.clip``), logits on the same weights (``_zoo_parity``), at their
smallest widths and inputs."""
import pytest

from mxnet_tpu.gluon.model_zoo import vision as jv
from mxnet_tpu_torch.gluon.model_zoo import vision as tv

from _zoo_parity import check_family


@pytest.mark.parametrize("version", ["1.0", "1.1"])
def test_squeezenet_logits_match_jax(tmp_path, version):
    # 1.0 at 63: every pool's windows fit (the JAX package's pools ignore
    # ceil_mode, and these use none)
    check_family(jv.SqueezeNet(version, classes=10),
                 lambda: tv.SqueezeNet(version, classes=10),
                 63 if version == "1.0" else 64, tmp_path, seed=5)


def test_mobilenet_v1_logits_match_jax(tmp_path):
    check_family(jv.MobileNet(0.25, classes=10),
                 lambda: tv.MobileNet(0.25, classes=10), 32, tmp_path,
                 seed=7, batch=2)


def test_mobilenet_v2_logits_match_jax(tmp_path):
    check_family(jv.MobileNetV2(0.25, classes=10),
                 lambda: tv.MobileNetV2(0.25, classes=10), 32, tmp_path,
                 seed=9, batch=2)
