# The port's model substrate: ``transformer`` is the decoder-only LM (dense
# and MoE), ``gnn`` the four GNNs and ``recsys`` DIN, which the configs and
# ``launch.train`` build.
