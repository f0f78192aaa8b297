"""The driver's ``entry()`` (``__graft_entry__.py:16-43``) in its MXNet
spelling on the port, under ``with mx.cpu():``, against the JAX
package.

Both packages run the same lines -- ``mx.np.random.seed(0)``,
``resnet50_v1()``, ``net.initialize()``, a forward of
``mx.np.ones((1, 3, 32, 32))`` to materialise the deferred shapes,
``p.data()`` over ``collect_params()`` -- and the port's net then takes
the JAX package's weights through ``p.set_data`` (or
``convert.load_params``), since random draws cannot match across
packages.  ``net.forward(NDArray(x))`` at
(1, 3, 32, 32) float32 must give the JAX package's logits within 1e-4
of their largest value (the float32 tolerance of the ResNet parity
tests, ``tests/test_torch_resnet.py``), and the torch-tensor path's bit
for bit.  The card runs the same spelling at (32, 3, 224, 224) bf16 in
``chip_smoke.py``'s ``entry_phase``.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import vision as j_vision
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.convert import load_params
from mxnet_tpu_torch.gluon.model_zoo import vision as t_vision
from mxnet_tpu_torch.ndarray.ndarray import NDArray


@pytest.fixture(scope="module")
def jax_entry():
    """The JAX package's entry() net after its materialising forward:
    (params as numpy, its float32 logits at ones((1, 3, 32, 32)))."""
    jmx.np.random.seed(0)
    net = j_vision.resnet50_v1()
    net.initialize()
    logits = net(jmx.np.ones((1, 3, 32, 32))).asnumpy()
    params = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    return params, logits


def _port_entry(params, set_data=True):
    tmx.np.random.seed(0)
    net = t_vision.resnet50_v1()
    net.initialize()
    net(tmx.np.ones((1, 3, 32, 32)))          # materialize deferred shapes
    own = {k: p.data() for k, p in net.collect_params().items()}
    assert sorted(own) == sorted(params)
    assert all(isinstance(d, NDArray) for d in own.values())
    if set_data:
        for k, p in net.collect_params().items():
            p.set_data(params[k])
    return net


def test_entry_mxnet_spelling_matches_jax_logits(jax_entry):
    params, want = jax_entry
    x = onp.ones((1, 3, 32, 32), onp.float32)
    with tmx.cpu():
        net = _port_entry(params)
        got = net.forward(NDArray(x))
        ref = net(torch.from_numpy(x))
        loaded = load_params(_port_entry(params, set_data=False), params)
        again = loaded.forward(NDArray(x))
    assert isinstance(got, NDArray) and got.shape == (1, 1000)
    assert torch.equal(got._data, ref) and torch.equal(again._data, ref)
    err = onp.abs(got.asnumpy() - want).max()
    assert err <= 1e-4 * onp.abs(want).max(), err


def test_entry_bf16_cast_through_data_runs_hybridized(jax_entry):
    """The cast of ``entry()``: every float32 parameter to bf16 through
    ``p.data()``; the bf16 net runs ``forward(NDArray)`` and the
    hybridized call (eager on the CPU) with the same logits."""
    params, want = jax_entry
    with tmx.cpu():
        net = _port_entry(params)
        for p in net.collect_params().values():
            d = p.data()
            if d.dtype == tmx.np.float32:
                bf = d.astype("bfloat16")
                p.cast("bfloat16")
                p.set_data(bf)
        assert {p.dtype for p in net.parameters()} == {torch.bfloat16}
        x = NDArray(torch.ones((1, 3, 32, 32), dtype=torch.bfloat16))
        with tmx.autograd.pause():
            eager = net.forward(x)
            net.hybridize()
            hyb = net(x)
    assert eager.dtype == torch.bfloat16 and torch.equal(eager._data,
                                                         hyb._data)
    got = eager.asnumpy()
    assert onp.isfinite(got).all()
    # bf16 weights and activations through 53 layers: a coarse check
    assert onp.abs(got - want).max() <= 0.1 * onp.abs(want).max()
