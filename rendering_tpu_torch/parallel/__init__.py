"""Scale-out layer on torch.distributed: ray sharding (`shard`), the
gradient all-reduce schedules (`overlap`), by-primitive geometry sharding
(`geoshard`), process-group init (`multihost`) and the collectives they
share (`collectives`).

Exports are lazy (PEP 562), as in the JAX package, so that importing the
package imports none of the renderer.
"""

__all__ = ["make_ray_mesh", "render_scene_sharded", "render_sharded"]


def __getattr__(name):
    if name in __all__:
        from rendering_tpu_torch.parallel import shard

        return getattr(shard, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
