"""Plain references of the benchmark's architectures, in float32 PyTorch.

Each module is an architecture family: its weights' names, shapes and
draws (``weight_spec``), its plain forward (and, for training, its loss,
gradients and optimizer), and ``count``, the operations and bytes of one
step's work, useful FLOPs and each kernel launch, from the configuration
and the shapes.  Nothing here imports JAX, the JAX package or the port.
"""
