# Entry points of the port: ``python -m repro_torch.launch.serve`` (the
# pattern-query server over one resident data graph), and the mesh builders
# of the sharded simulation, ``mesh.make_production_mesh`` and
# ``mesh.make_local_mesh`` (``torch.distributed`` device meshes).
