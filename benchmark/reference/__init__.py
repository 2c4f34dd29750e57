"""The plain reference: trajectories, the tilt, body SDFs, the swept
volume, the cost and occupancy, from their definitions in plain PyTorch and
numpy.  It imports nothing of the program (isdf_torch), of the JAX package
or of JAX."""
