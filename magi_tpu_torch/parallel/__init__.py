from magi_tpu_torch.parallel.mesh import (
    build_mesh,
    destroy_mesh,
    get_mesh,
    initialize_mesh,
    set_mesh,
    shard_dit_params,
    shard_kv_cache,
)
from magi_tpu_torch.parallel.tile import pmap_tile_batch, replicate_vae_params

__all__ = [
    "build_mesh",
    "initialize_mesh",
    "destroy_mesh",
    "get_mesh",
    "set_mesh",
    "shard_dit_params",
    "shard_kv_cache",
    "pmap_tile_batch",
    "replicate_vae_params",
]
