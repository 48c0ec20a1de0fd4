"""Sharding of the port: the users-axis mesh of the population relaxation."""
from .population import MeshRelaxer, PopulationMesh, population_mesh

__all__ = ["MeshRelaxer", "PopulationMesh", "population_mesh"]
