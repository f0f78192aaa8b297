"""AMP allow / deny op lists: the port's copy of
``mxnet_tpu/amp/lists.py`` (the reference's ``python/mxnet/amp/lists/
symbol_fp16.py``).  They document the policy the port's ops implement:
products and convolutions run in the low-precision dtype on the tensor
cores; the FP32 list's ops compute their statistics in float32."""

# ops that benefit from low precision (the tensor cores)
FP16_FUNCS = [
    "fully_connected", "convolution", "deconvolution", "dense", "matmul",
    "dot", "einsum", "tensordot", "dot_product_attention", "rnn",
]

# ops that must keep fp32 math (implemented with fp32 accumulation)
FP32_FUNCS = [
    "batch_norm", "layer_norm", "group_norm", "instance_norm", "rms_norm",
    "softmax", "log_softmax", "masked_softmax", "norm", "mean", "sum",
    "exp", "log", "erfinv", "gammaln", "cumsum", "var", "std",
]

# widest-type-cast ops (run in the widest input dtype)
FP16_FP32_FUNCS = [
    "add", "subtract", "multiply", "divide", "maximum", "minimum", "where",
    "concatenate", "stack", "clip", "relu", "sigmoid", "tanh",
]
