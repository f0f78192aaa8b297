"""``mxnet_tpu_torch.parallel``: training steps and scaling over
``torch.distributed`` ranks.

Counterpart of ``mxnet_tpu/parallel``: meshes of ranks with named axes
(:mod:`.mesh`, with ``shrink_mesh`` / ``grow_mesh``), their explicit
collectives and ``shard_map`` (:mod:`._compat`), parameter sharding
(:mod:`.sharding`: each rank holds its block, the layers compute with
it), ``TrainStep`` (one device or a mesh: data and tensor parallelism,
ZeRO-1, remat, resharding checkpoints and ``resize``), the pipeline
schedules (:mod:`.pipeline`), context parallelism by ring attention
(:mod:`.ring`) with sequence-sharded input (:mod:`.seq_data`), and the
switch MoE with its experts over an ``ep`` axis (:mod:`.moe`).
"""
from .mesh import (create_mesh, current_mesh, local_mesh,  # noqa: F401
                   mesh_scope, shrink_mesh, grow_mesh)
from .sharding import (P, PartitionSpec, NamedSharding,  # noqa: F401
                       apply_sharding_rules, param_sharding, shard_params,
                       replicate)
from .train_step import TrainStep  # noqa: F401
from .ring import (ring_attention_sharded, ring_attention_local,  # noqa
                   causal_balance, stripe_sequence, unstripe_sequence)
from . import pipeline  # noqa: F401
from . import seq_data  # noqa: F401
from .seq_data import SeqShardLoader, make_sequence_array, EpochPlan  # noqa
from .pipeline import pipeline_apply, pipeline_vjp  # noqa: F401
from .moe import switch_moe, moe_param_specs  # noqa: F401
