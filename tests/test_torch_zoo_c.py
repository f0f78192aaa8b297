"""The port's vision zoo against the JAX package's, part C: DenseNet
(dense layers concatenating their growth onto the input, transitions
with average pools) at its smallest configuration, logits on the same
weights (``_zoo_parity``)."""
from mxnet_tpu.gluon.model_zoo import vision as jv
from mxnet_tpu_torch.gluon.model_zoo import vision as tv

from _zoo_parity import check_family


def test_densenet_logits_match_jax(tmp_path):
    check_family(jv.DenseNet(8, 4, (2, 2, 2, 2), classes=10),
                 lambda: tv.DenseNet(8, 4, (2, 2, 2, 2), classes=10), 32,
                 tmp_path, seed=11, batch=2)


def test_densenet_with_dropout_logits_match_jax(tmp_path):
    """Dropout is the identity in inference: the same logits."""
    check_family(jv.DenseNet(8, 4, (1, 2), dropout=0.5, classes=10),
                 lambda: tv.DenseNet(8, 4, (1, 2), dropout=0.5, classes=10),
                 32, tmp_path, seed=13)
