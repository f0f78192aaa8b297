"""Training steps of the port: ``TrainStep`` on one device.  Meshes,
sharding and the ring/pipeline/expert layers are not ported yet."""
from .train_step import TrainStep  # noqa: F401
