"""``mx.image``: the legacy image API (counterpart of
``mxnet_tpu/image/``), cv2 on the host."""
from .image import *  # noqa: F401,F403
from .image import __all__  # noqa: F401
