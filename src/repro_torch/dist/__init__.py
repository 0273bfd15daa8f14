"""Sharding conventions of the production meshes and the ``DTensor``
helpers of the sharded paths (:mod:`.sharding`); host reads of a traced
step (:mod:`.meta`)."""

from .sharding import (axis_size, batch_axes, din_batch_specs,
                       din_param_specs, gnn_batch_specs, gnn_param_specs,
                       lm_batch_specs, lm_param_specs, partial_sums, pick,
                       placements, placements_tree, reduced_lookup, summed)

__all__ = ["axis_size", "batch_axes", "placements", "placements_tree",
           "reduced_lookup", "summed", "pick", "partial_sums",
           "lm_param_specs", "lm_batch_specs", "gnn_param_specs",
           "gnn_batch_specs", "din_param_specs", "din_batch_specs"]
