"""Multi-device training and serving over torch.distributed (twin of
textreact_tpu/parallel/): the (dp, tp) process mesh, Megatron-style tensor
parallelism and ZeRO-1, and the multi-process helpers. The corpus-sharded
index lives in retrieval/engine.py (`FlatIndex(devices=...)`)."""

from .mesh import DP_AXIS, TP_AXIS, Mesh, local_batch_size, make_mesh
from .multihost import (gather_prediction_dict, gather_score_dict,
                        initialize_distributed, is_primary)
from .sharding import (full_state_dict, load_full_state_dict, param_spec,
                       shard_params, zero_axis)

__all__ = ["DP_AXIS", "TP_AXIS", "Mesh", "local_batch_size", "make_mesh",
           "gather_prediction_dict", "gather_score_dict",
           "initialize_distributed", "is_primary", "full_state_dict",
           "load_full_state_dict", "param_spec", "shard_params", "zero_axis"]
