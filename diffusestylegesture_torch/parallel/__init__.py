"""Parallelism of the port: meshes, data / fully-sharded / tensor / sequence /
pipeline parallel training over `torch.distributed`, and the serving mesh.

Port of `diffusestylegesture_tpu/parallel/`; the JAX names."""
from .fsdp import count_sharded, fsdp_param_specs  # noqa: F401
from .mesh import (  # noqa: F401
    LocalMesh,
    data_sharded,
    make_mesh,
    replicate,
    replicated,
    shard_batch,
)
from .pipeline import (  # noqa: F401
    pipeline_apply,
    stack_layer_params,
    unstack_layer_params,
)
from .tp import (  # noqa: F401
    mdm_param_specs,
    merge_qkv_params,
    shard_params,
    shard_train_state,
    split_qkv_params,
    wavlm_param_specs,
)
