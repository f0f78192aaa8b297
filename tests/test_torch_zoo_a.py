"""The port's vision zoo against the JAX package's, part A: AlexNet and
VGG (with BatchNorm) logits on the same weights (``_zoo_parity``), and
the whole zoo's names: ``get_model`` builds all 34 nets, each with the
JAX package's parameter names and declared shapes (no forward), and
``pretrained=True`` raises as there."""
import pytest

from mxnet_tpu.gluon.model_zoo import vision as jv
from mxnet_tpu_torch.gluon import parameter as tparam
from mxnet_tpu_torch.gluon.model_zoo import vision as tv

from _zoo_parity import check_family


def test_alexnet_logits_match_jax(tmp_path):
    check_family(jv.AlexNet(classes=10), lambda: tv.AlexNet(classes=10), 64,
                 tmp_path)


@pytest.mark.parametrize("bn", [False, True])
def test_vgg_logits_match_jax(tmp_path, bn):
    spec = ([1, 1, 1, 1, 1], [8, 8, 16, 16, 16])
    check_family(jv.VGG(*spec, classes=10, batch_norm=bn),
                 lambda: tv.VGG(*spec, classes=10, batch_norm=bn), 32,
                 tmp_path, seed=3, batch=2)


@pytest.mark.parametrize("name", sorted(jv._models))
def test_get_model_names_and_shapes_match_jax(name):
    j, t = jv.get_model(name), tv.get_model(name)
    want = {k: tuple(p.shape) for k, p in j.collect_params().items()}
    got = {k: tuple(tparam._spec(p).shape)
           for k, p in t.named_parameters(remove_duplicate=False)}
    assert got == want


def test_zoo_holds_every_name():
    assert sorted(tv._models) == sorted(jv._models)
    assert len(tv._models) == 34
    with pytest.raises(ValueError, match="not supported"):
        tv.get_model("resnet9_v1")


@pytest.mark.parametrize("name", ["alexnet", "vgg11_bn", "squeezenet1.1",
                                  "mobilenetv2_0.25", "densenet121",
                                  "inceptionv3", "resnet18_v1"])
def test_pretrained_raises_as_in_jax(name):
    with pytest.raises(RuntimeError):
        jv.get_model(name, pretrained=True)
    with pytest.raises(RuntimeError, match="network"):
        tv.get_model(name, pretrained=True)
