"""Plain float32 PyTorch of the benchmark's models, their serving
forward pass and their training steps.  Nothing here imports the port:
the weights are drawn again from the seed (``portbench.weights``)."""
