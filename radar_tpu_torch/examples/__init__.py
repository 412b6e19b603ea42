"""Port of ``examples/``: the tutorials, one module each under the JAX
tutorial's name, run as ``python -m radar_tpu_torch.examples.<name>`` on
the card (``--cpu`` for the host). Each has a ``main(argv)``."""
