"""Shared by the ``test_torch_zoo_*`` files: one zoo net of the port
against the JAX package's on the same weights.

The port's net takes its shapes from one forward; the JAX net, never
initialized, gets random weights of those shapes (numpy, from a seed:
He-scaled weights, BatchNorm statistics and gains near their defaults,
small biases) by ``set_data`` (initializing it first would compile an
initializer per shape, ~40 s for Inception v3 here; ``grad_req="null"``
spares it a gradient buffer per shape, ~4 s), and runs one
forward, hybridized (one XLA program).  Its ``save_parameters`` file
goes into a fresh port net through ``load_parameters``, so the file
format is held too.  The logits must agree to 1e-4 of their largest
value (float32); the port's hybridized forward (eager on the CPU) must
equal its eager one.
"""
import math

import numpy as onp
import torch

import mxnet_tpu as mx
from mxnet_tpu_torch import autograd

REL = 1e-4


def _weights(shapes, seed):
    rs = onp.random.RandomState(seed)
    out = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_var":
            a = rs.uniform(0.5, 1.5, shape)
        elif leaf == "gamma":
            a = rs.uniform(0.8, 1.2, shape)
        elif leaf in ("running_mean", "beta", "bias"):
            a = rs.normal(0, 0.1, shape)
        else:
            a = rs.normal(0, math.sqrt(2.0 / math.prod(shape[1:])), shape)
        out[name] = a.astype("float32")
    return out


def check_family(j_net, t_make, size, tmp_path, seed=0, batch=1):
    """``j_net`` (a JAX zoo net, not initialized) against ``t_make()``
    (the port's) at (batch, 3, size, size); returns the logits' error."""
    x = onp.random.RandomState(seed + 1).normal(
        0, 1, (batch, 3, size, size)).astype("float32")
    shaper = t_make().initialize(device="cpu")
    with autograd.pause():
        shaper(torch.from_numpy(x))
    shapes = {k: tuple(p.shape) for k, p in shaper.collect_params().items()}
    jp = j_net.collect_params()
    assert sorted(jp) == sorted(shapes)
    j_net.setattr("grad_req", "null")      # no gradient buffer to make
    for k, w in _weights(shapes, seed).items():
        jp[k].set_data(mx.np.array(w))
    j_net.hybridize()
    want = j_net(mx.np.array(x)).asnumpy()
    path = str(tmp_path / "zoo.params")
    j_net.save_parameters(path)

    net = t_make()
    net.load_parameters(path, device="cpu")
    with autograd.pause():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    err = float(onp.abs(got - want).max()) / float(onp.abs(want).max())
    assert err <= REL, err
    net.hybridize()
    with autograd.pause():
        again = net(torch.from_numpy(x)).numpy()
    assert onp.array_equal(again, got)
    return err
