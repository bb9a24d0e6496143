"""Mesh extraction (port of `gsjax/mesh/`): the marching-tetrahedra route on
the alpha field of the point integrate (kernel B4) and the TSDF route on
rendered median depth (kernel B1)."""
