"""The port's Inception v3 against the JAX package's: logits on the
same weights (``_zoo_parity``), one image at the 299 x 299 the net takes
(its last average pool is 8 x 8; a smaller image leaves it no window)."""
from mxnet_tpu.gluon.model_zoo import vision as jv
from mxnet_tpu_torch.gluon.model_zoo import vision as tv

from _zoo_parity import check_family


def test_inception_v3_logits_match_jax(tmp_path):
    check_family(jv.Inception3(classes=10), lambda: tv.Inception3(classes=10),
                 299, tmp_path, seed=17)
