"""Export of the port: mesh extraction (the native C++ core) and PLY files."""

from .mesh import extract_mesh, extract_mesh_from_engine, extract_mesh_ref, load_ply, save_ply

__all__ = ["extract_mesh", "extract_mesh_ref", "extract_mesh_from_engine", "save_ply",
           "load_ply"]
