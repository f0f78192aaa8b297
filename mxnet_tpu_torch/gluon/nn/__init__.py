"""Gluon layers of the port (``mxnet_tpu/gluon/nn``): basic layers,
activations, convolutions and pooling."""
from .activations import (ELU, GELU, SELU, Activation, LeakyReLU,  # noqa: F401
                          Mish, PReLU, SiLU, Swish)
from .basic_layers import (BatchNorm, Concatenate, Dense,  # noqa: F401
                           Dropout, Embedding, Flatten, GroupNorm,
                           HybridConcatenate, HybridLambda, HybridSequential,
                           Identity, InstanceNorm, Lambda, LayerNorm, RMSNorm,
                           Sequential, SyncBatchNorm)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D,  # noqa: F401
                          Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose,
                          Conv3D, Conv3DTranspose, GlobalAvgPool1D,
                          GlobalAvgPool2D, GlobalAvgPool3D, GlobalMaxPool1D,
                          GlobalMaxPool2D, GlobalMaxPool3D, MaxPool1D,
                          MaxPool2D, MaxPool3D, ReflectionPad2D)
