"""Sharding of the port: partition-spec policies for the production mesh
(as per-dimension specs and DTensor placements), what the model code
needs to run over DTensors (``dtensor``), and the users-axis mesh of the
population relaxation."""
from .population import MeshRelaxer, PopulationMesh, population_mesh
from .specs import (batch_shardings, cache_spec, caches_shardings,
                    distribute_tree, dp_axes, param_spec, params_shardings,
                    scalar_sharding, to_placements)

__all__ = ["batch_shardings", "cache_spec", "caches_shardings", "dp_axes",
           "param_spec", "params_shardings", "scalar_sharding",
           "to_placements", "distribute_tree", "MeshRelaxer",
           "PopulationMesh", "population_mesh"]
