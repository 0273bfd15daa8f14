# Entry points of the port: ``python -m repro_torch.launch.serve`` (the
# pattern-query server over one resident data graph).
