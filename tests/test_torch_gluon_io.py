"""Parameter files, shape inference and export of the port's blocks
against the JAX package.

``save_parameters`` / ``load_parameters`` both ways between the
packages (bf16 members included, bit for bit), ``deduplicate``,
``allow_missing`` / ``ignore_extra`` (the reference's AssertionError
messages), ``cast_dtype`` / ``dtype_source``, manifests (a torn file and
a stale manifest raise ``CorruptCheckpointError`` before any parameter
is touched; ``save_parameters`` refreshes the manifest), ``load_dict``,
``device=`` and deferred shapes; ``infer_shape`` and ``optimize_for``
against the reference's; ``export`` -> ``SymbolBlock.imports`` on the
CPU for ``resnet18_v1(thumbnail=True)`` and a quantized CNN (whose
program holds the ``mxnet_tpu_torch::`` int8 ops and no plain int8
arithmetic), outputs equal to the net's; and ``export`` refusing a
forward that reaches the flash forward.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import fault as jfault
from mxnet_tpu.gluon import nn as jnn
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd, fault
from mxnet_tpu_torch.gluon import SymbolBlock
from mxnet_tpu_torch.gluon import nn as tnn


def _build(nn, n_dense=2, deferred=False):
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, padding=1, in_channels=0 if deferred else 3),
            nn.BatchNorm(in_channels=0 if deferred else 4),
            nn.Activation("relu"), nn.Flatten())
    units = [0 if deferred else 4 * 5 * 5, 6, 3, 2][:n_dense + 1]
    for i in range(n_dense):
        net.add(nn.Dense(units[i + 1], in_units=units[i]))
    return net


def _values(shapes, seed):
    """Random values of ``shapes``; called with one name at a time, each
    parameter's values depend only on the seed and its shape."""
    rs = onp.random.RandomState(seed)
    return {k: (rs.uniform(0.5, 1.5, s) if k.endswith("running_var")
                else rs.normal(0, 0.5, s)).astype("float32")
            for k, s in shapes.items()}


def _jax_net(n_dense=2, seed=0, bf16_last=False):
    net = _build(jnn, n_dense)
    net.initialize()
    for k, p in net.collect_params().items():
        p.set_data(mx.np.array(_values({k: p.shape}, seed)[k]))
    if bf16_last:
        net[4 + n_dense - 1].cast("bfloat16")
    return net


def _port_net(n_dense=2, seed=0, bf16_last=False):
    net = _build(tnn, n_dense).initialize(device="cpu")
    net.load_dict({k: _values({k: tuple(p.shape)}, seed)[k]
                   for k, p in net.collect_params().items()})
    if bf16_last:
        net[4 + n_dense - 1].cast("bfloat16")
    return net


def _jax_arrays(net):
    return {k: onp.asarray(p.data()._data.astype("float32"))
            for k, p in net.collect_params().items()}


def _port_arrays(net):
    return {k: p.detach().float().numpy()
            for k, p in net.collect_params().items()}


def _x(seed=1, n=2):
    return onp.random.RandomState(seed).normal(0, 1, (n, 3, 5, 5)).astype(
        "float32")


@pytest.mark.parametrize("bf16", [False, True])
def test_port_file_loads_into_jax_bit_for_bit(tmp_path, bf16):
    src = _port_net(seed=2, bf16_last=bf16)
    path = str(tmp_path / "p.params")
    src.save_parameters(path)
    dst = _jax_net(seed=3, bf16_last=bf16)
    dst.load_parameters(path)
    want = _port_arrays(src)
    got = _jax_arrays(dst)
    assert sorted(got) == sorted(want)
    for k in want:
        assert onp.array_equal(got[k], want[k]), k
    if bf16:
        assert str(dst[5].weight.data().dtype) == "bfloat16"
        return
    with autograd.pause():
        out = src(torch.from_numpy(_x()))
    onp.testing.assert_allclose(dst(mx.np.array(_x())).asnumpy(),
                                out.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_jax_file_loads_into_the_port_bit_for_bit(tmp_path, bf16):
    src = _jax_net(seed=4, bf16_last=bf16)
    path = str(tmp_path / "j.params")
    src.save_parameters(path)
    dst = _port_net(seed=5, bf16_last=bf16)
    dst.load_parameters(path)
    want, got = _jax_arrays(src), _port_arrays(dst)
    for k in want:
        assert onp.array_equal(got[k], want[k]), k
    assert dst[5].weight.dtype == (torch.bfloat16 if bf16 else torch.float32)


def _shared(nn, port):
    net = _build(nn, 3)
    if port:
        net.initialize(device="cpu")
    else:
        net.initialize()
    # the third Dense shares the second's bias: (3,) -> (2,) would not
    # fit, so share the first Dense's weight with a same-shaped layer
    extra = nn.Dense(6, in_units=100)
    net.add(extra)
    if port:
        net.initialize(device="cpu")
    else:
        extra.initialize()
    extra.share_parameters({"weight": net[4].weight})
    return net


@pytest.mark.parametrize("dedup", [False, True])
def test_deduplicate_writes_a_shared_parameter_once(tmp_path, dedup):
    keys = []
    for port in (False, True):
        net = _shared(tnn if port else jnn, port)
        path = str(tmp_path / ("%d.params" % port))
        net.save_parameters(path, deduplicate=dedup)
        keys.append(sorted(onp.load(path).files))
    assert keys[0] == keys[1]
    assert ("7.weight" in keys[1]) is not dedup
    # the port loads a deduplicated file: the shared name finds its value
    net = _shared(tnn, True)
    net.load_parameters(str(tmp_path / "1.params"))


def test_missing_and_extra_raise_the_reference_messages(tmp_path):
    small, big = str(tmp_path / "small.params"), str(tmp_path / "big.params")
    _jax_net(2).save_parameters(small)
    _jax_net(3).save_parameters(big)
    cases = [(small, 3, {}), (big, 2, {})]
    for path, n, kw in cases:
        with pytest.raises(AssertionError) as want:
            _jax_net(n).load_parameters(path, **kw)
        net = _port_net(n, seed=9)
        before = _port_arrays(net)
        with pytest.raises(AssertionError) as got:
            net.load_parameters(path, **kw)
        assert str(got.value) == str(want.value)
        after = _port_arrays(net)
        assert all(onp.array_equal(before[k], after[k]) for k in before)
    # allowed: the present ones load, the rest stay
    net = _port_net(3, seed=9)
    net.load_parameters(small, allow_missing=True)
    j = _jax_net(3, seed=9)
    j.load_parameters(small, allow_missing=True)
    got, want = _port_arrays(net), _jax_arrays(j)
    assert all(onp.array_equal(got[k], want[k]) for k in want)
    net = _port_net(2, seed=9)
    net.load_parameters(big, ignore_extra=True)
    assert onp.array_equal(_port_arrays(net)["4.weight"],
                           onp.load(big)["4.weight"])


def test_a_shape_that_does_not_fit_raises_before_any_write(tmp_path):
    path = str(tmp_path / "p.params")
    _port_net(seed=1).save_parameters(path)
    net = _build(tnn)
    other = tnn.HybridSequential()
    other.add(*list(net)[:4], tnn.Dense(6, in_units=100),
              tnn.Dense(3, in_units=7))
    other.initialize(device="cpu")
    before = _port_arrays(other)
    with pytest.raises(ValueError, match="5.weight"):
        other.load_parameters(path)
    after = _port_arrays(other)
    assert all(onp.array_equal(before[k], after[k]) for k in before)


@pytest.mark.parametrize("source", ["current", "saved"])
def test_cast_dtype_follows_the_reference(tmp_path, source):
    src = _port_net(seed=6)
    src.cast("float16")
    path = str(tmp_path / "h.params")
    src.save_parameters(path)
    j = _jax_net(seed=7)
    j.load_parameters(path, cast_dtype=True, dtype_source=source)
    net = _port_net(seed=7)
    net.load_parameters(path, cast_dtype=True, dtype_source=source)
    # the parameter's dtype: the reference records the saved one as the
    # parameter's dtype with "saved" (and, a quirk, keeps its data in
    # the old one); the port holds its data in it, as MXNet does
    for k, p in net.collect_params().items():
        assert str(p.dtype).replace("torch.", "") == \
            str(j.collect_params()[k].dtype), k
    assert onp.array_equal(_port_arrays(net)["4.weight"],
                           _jax_arrays(j)["4.weight"])
    plain = _port_net(seed=7)
    plain.load_parameters(path)
    assert plain[4].weight.dtype == torch.float32


def test_torn_file_and_stale_manifest_leave_the_net_untouched(tmp_path):
    path = str(tmp_path / "ck.params")
    manifest = str(tmp_path / "ck.manifest.json")
    _port_net(seed=1).save_parameters(path)
    fault.write_manifest(manifest, [path])
    net = _port_net(seed=2)
    net.load_parameters(path)                   # verified, loads
    # the reference verifies the port's manifest too
    _jax_net().load_parameters(path)
    # stale: another writer replaced the file, the manifest was not told
    mt.utils.serialization.savez(path, **{"4.weight": torch.ones(6, 100)})
    for make in (lambda: _port_net(seed=3), lambda: _jax_net(seed=3)):
        blk = make()
        before = (_port_arrays if isinstance(blk, tnn.HybridSequential)
                  else _jax_arrays)(blk)
        with pytest.raises((fault.CorruptCheckpointError,
                            jfault.CorruptCheckpointError)):
            blk.load_parameters(path)
        after = (_port_arrays if isinstance(blk, tnn.HybridSequential)
                 else _jax_arrays)(blk)
        assert all(onp.array_equal(before[k], after[k]) for k in before)
    # save_parameters refreshes the manifest: the new file loads
    _port_net(seed=4).save_parameters(path)
    net.load_parameters(path)
    assert onp.array_equal(_port_arrays(net)["4.weight"],
                           _port_arrays(_port_net(seed=4))["4.weight"])
    # torn: half the file
    with open(path, "r+b") as f:
        f.truncate(f.seek(0, 2) // 2)
    with pytest.raises(fault.CorruptCheckpointError, match="ck.params"):
        net.load_parameters(path)


def test_deferred_parameters_take_their_shapes_from_the_file(tmp_path):
    path = str(tmp_path / "p.params")
    src = _port_net(seed=8)
    src.save_parameters(path)
    net = _build(tnn, deferred=True)     # never initialized, no forward
    net.load_parameters(path, device="cpu")
    x = torch.from_numpy(_x())
    with autograd.pause():
        assert torch.equal(net(x), src(x))
    # a load drops the block's captured graphs
    net._graphs["stale"] = None
    net.load_dict(_port_arrays(src))
    assert not net._graphs
    # values of other dtypes are cast to the parameter's
    net.load_dict({k: v.astype("float64") for k, v in
                   _port_arrays(src).items()})
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_infer_shape_gives_the_reference_shapes():
    x = _x()
    j = _build(jnn, deferred=True)
    j.initialize()
    j.infer_shape(mx.np.array(x))
    net = _build(tnn, deferred=True).initialize(device="cpu")
    net.infer_shape(torch.from_numpy(x))
    assert {k: tuple(p.shape) for k, p in net.collect_params().items()} == \
        {k: tuple(p.shape) for k, p in j.collect_params().items()}
    assert not net._graphs


def test_optimize_for_is_hybridize_and_one_call():
    x = _x()
    j = _jax_net(seed=10)
    net = _port_net(seed=10)
    out = net.optimize_for(torch.from_numpy(x))
    assert net._active
    onp.testing.assert_allclose(out.detach().numpy(), j.optimize_for(
        mx.np.array(x)).asnumpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="backend"):
        net.optimize_for(torch.from_numpy(x), backend="MKLDNN")


def _node_targets(sym_file):
    program = torch.export.load(sym_file)
    return {str(n.target) for n in program.graph.nodes
            if n.op == "call_function"}


def test_export_and_imports_resnet18(tmp_path):
    from mxnet_tpu.gluon.model_zoo import vision as jv
    from mxnet_tpu_torch.gluon.model_zoo import vision as tv
    net = tv.resnet18_v1(thumbnail=True, classes=10)
    net.initialize(device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(2, 2).repeat(7, 2).repeat(7, 3)[:, :, :32, :32]
                         .copy())
    with autograd.pause():
        want = net(x)
    sym, par = net.export(str(tmp_path / "r18"), example_inputs=(x,))
    assert sym.endswith("-symbol.pt2") and par.endswith("-0000.params")
    blk = SymbolBlock.imports(sym, ["data"], par, device="cpu")
    assert torch.equal(blk(x), want)
    assert list(blk.collect_params()) == list(
        jv.resnet18_v1(thumbnail=True, classes=10).collect_params())
    # the parameter file is the reference's format
    fresh = tv.resnet18_v1(thumbnail=True, classes=10)
    fresh.load_parameters(par, device="cpu")
    with autograd.pause():
        assert torch.equal(fresh(x), want)
    # the program takes the parameters as inputs: other weights, other
    # outputs
    blk.load_dict({k: v * 0.5 for k, v in _port_arrays(net).items()})
    assert not torch.equal(blk(x), want)


def _quantized_cnn():
    from mxnet_tpu_torch.contrib import quantization as q
    net = tnn.HybridSequential()
    net.add(tnn.Conv2D(8, 3, padding=1), tnn.BatchNorm(),
            tnn.Activation("relu"),
            tnn.Conv2D(32, 3, strides=2, padding=1, activation="relu"),
            tnn.Conv2D(32, 3, padding=1, groups=32),
            tnn.Conv2D(32, 1, activation="relu"),
            tnn.GlobalAvgPool2D(), tnn.Flatten(), tnn.Dense(10))
    net.initialize(device="cpu", generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(onp.random.RandomState(3).uniform(
        0, 1, (2, 3, 12, 12)).astype("float32"))
    with autograd.pause():
        net(x)
    q.quantize_net(net, calib_data=[x])
    return net, x


def test_export_of_a_quantized_net_holds_the_int8_ops(tmp_path):
    net, x = _quantized_cnn()
    with autograd.pause():
        want = net(x)
    sym, par = net.export(str(tmp_path / "q"), example_inputs=x)
    targets = _node_targets(sym)
    assert {"mxnet_tpu_torch.int8_quantize.default",
            "mxnet_tpu_torch.int8_quantize_im2col.default",
            "mxnet_tpu_torch.int8_conv.default"} <= targets
    plain = [t for t in targets if any(w in t for w in (
        "round", "clamp", "conv2d", "convolution", "unfold", "_to_copy"))]
    assert not plain, plain
    blk = SymbolBlock.imports(sym, None, par, device="cpu")
    assert torch.equal(blk(x), want)


def test_export_refuses_a_forward_through_the_flash_forward(tmp_path):
    from mxnet_tpu_torch.models.bert import BERTModel, bert_tiny_config
    net = BERTModel(bert_tiny_config())
    net.initialize(device="cpu")
    toks = torch.zeros(1, 8, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="queue 2"):
        net.export(str(tmp_path / "bert"), example_inputs=(toks,))


def test_export_needs_example_inputs(tmp_path):
    with pytest.raises(ValueError, match="example_inputs"):
        _port_net().export(str(tmp_path / "n"))
