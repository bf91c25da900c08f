from .mesh import MeshRenderer, make_mesh

__all__ = ["MeshRenderer", "make_mesh"]
