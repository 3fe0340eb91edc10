"""Data- and tensor-parallel training and serving over
``torch.distributed`` (counterpart of ``t5gemma_tts_tpu/parallel``)."""

from .mesh import (  # noqa: F401
    DATA_AXIS, MODEL_AXIS, Layout, Mesh, Spec, gather_params,
    init_distributed, make_mesh, opt_state_specs, param_specs, serving_dims,
    serving_shard, shard_batch, shard_opt_state, shard_params,
    shard_slot_state, zero_spec,
)
