"""ResNet-50 v1 of the port against the JAX package's, NCHW and NHWC at
1 x 64 x 64: float32 logits, then one SGD-momentum training step in
float64 against the JAX net in float64 -- the comparison and its
tolerances are ``test_torch_resnet.py``'s (see its docstring).  Both
layouts compare with one JAX NCHW run on the same weights (NHWC with
its input and conv weights transposed); the NHWC logits are also held
against the JAX package's NHWC net."""
import pytest
import torch

from test_torch_resnet import _check_step


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_resnet50_v1_matches_jax(layout):
    _check_step(1, 50, (1, 3, 64, 64), torch.float64, layout=layout,
                classes=1000)
