"""The reference's three examples on the port (``python -m
repro_torch.examples.<name>``): ``quickstart`` (the paper's pipeline),
``serve_routing`` (the routed fleet in each serving mode) and
``train_expert`` (an expert LM trained and checkpointed). Each runs on
the card unless ``--device cpu`` and returns what it prints from
``main(argv)``."""
