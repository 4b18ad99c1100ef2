from .mesh import make_mesh, render_sharded, replicate_scene  # noqa: F401
