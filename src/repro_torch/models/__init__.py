# The port's model substrate: ``transformer`` is the decoder-only LM
# (dense and MoE) that the LM configs and ``launch.train`` build.
