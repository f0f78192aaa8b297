"""``mxnet_tpu_torch.parallel``: training steps and scaling over
``torch.distributed`` ranks.

Counterpart of ``mxnet_tpu/parallel``: ``TrainStep`` (one device, with
remat and checkpoints), meshes of ranks with named axes
(:mod:`.mesh`), their collectives and ``shard_map`` (:mod:`._compat`),
context parallelism by ring attention (:mod:`.ring`) with
sequence-sharded input (:mod:`.seq_data`), and the switch MoE with its
experts over an ``ep`` axis (:mod:`.moe`).  Not ported yet (ROADMAP
queue 3): parameter sharding (``sharding``), ``TrainStep(mesh=,
zero1=)`` / ``resize``, ``shrink_mesh`` / ``grow_mesh`` and the
pipeline.
"""
from .mesh import create_mesh, current_mesh, local_mesh, mesh_scope  # noqa
from .train_step import TrainStep  # noqa: F401
from .ring import (ring_attention_sharded, ring_attention_local,  # noqa
                   causal_balance, stripe_sequence, unstripe_sequence)
from . import seq_data  # noqa: F401
from .seq_data import SeqShardLoader, make_sequence_array, EpochPlan  # noqa
from .moe import switch_moe, moe_param_specs  # noqa: F401
